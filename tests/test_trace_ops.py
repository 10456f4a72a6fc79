"""tools/trace_ops.py: device busy time is the union of event intervals."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

from trace_ops import busy_ns  # noqa: E402


def _ev(start, dur):
    return ("m", "n", "op", float(start), float(dur))


@pytest.mark.parametrize("events,want", [
    ([_ev(0, 10), _ev(20, 5)], 15),            # disjoint
    ([_ev(0, 10), _ev(5, 10)], 15),            # overlapping
    ([_ev(5, 2), _ev(0, 10), _ev(9, 1)], 10),  # nested, unsorted
])
def test_busy_ns_is_interval_union(events, want):
    assert busy_ns(events) == want
