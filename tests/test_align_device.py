"""Bit-parity of the DeviceAlignService against the scalar host aligner.

Every request kind the wave extension engine emits (pipeline/extend.py
docstring) is fuzzed over random sequence pairs spanning the banded and
fallback regimes; the batched device answer must equal the inline host
answer exactly (which is itself pinned to the reference semantics of
src/align.cpp:219-252, 556-723 by tests/test_align.py)."""

import numpy as np
import pytest

from circminer_jax.config import Config
from circminer_jax.ops import align as al
from circminer_jax.ops.align_device import DeviceAlignService
from circminer_jax.pipeline.extend import InlineAlignService


@pytest.fixture(scope="module")
def cfg():
    return Config(kmer=20, max_read_len=120)


def _rand_pair(rng, max_len=123):
    n = int(rng.integers(0, max_len + 1))
    m = int(rng.integers(0, max_len + 1))
    s = rng.integers(0, 5, size=n).astype(np.int8)
    # bias t toward a mutated copy of s so low-ed candidates exist
    if m <= n and rng.random() < 0.7:
        t = s[:m].copy()
        for _ in range(int(rng.integers(0, 4))):
            if m:
                t[rng.integers(0, m)] = rng.integers(0, 4)
    else:
        t = rng.integers(0, 5, size=m).astype(np.int8)
    return s, t


@pytest.mark.parametrize("kind", ["edit_sc_r", "edit_sc_l", "drop_sc_r",
                                  "drop_sc_l", "end_r", "end_l"])
def test_kind_parity(cfg, kind):
    rng = np.random.default_rng(hash(kind) % (2 ** 31))
    svc = DeviceAlignService(cfg)
    inline = InlineAlignService(cfg, svc.sm)
    reqs = []
    for _ in range(300):
        s, t = _rand_pair(rng)
        reqs.append((kind, s, t))
    got = svc.solve_batch(reqs)
    want = [inline.solve(r) for r in reqs]
    for g, wv, r in zip(got, want, reqs):
        assert g == wv, (kind, len(r[1]), len(r[2]), g, wv)
    assert svc.n_device > 0  # the device regime was actually exercised


def test_one_side_parity(cfg):
    rng = np.random.default_rng(7)
    svc = DeviceAlignService(cfg)
    inline = InlineAlignService(cfg, svc.sm)
    reqs = []
    for _ in range(300):
        w = int(rng.integers(0, cfg.band_width + 1))
        n = int(rng.integers(0, 40))
        m = max(n + int(rng.integers(-w - 1, w + 2)), 0)
        s = rng.integers(0, 5, size=n).astype(np.int8)
        t = s[:m].copy() if m <= n else np.concatenate(
            [s, rng.integers(0, 5, size=m - n).astype(np.int8)])
        for _ in range(int(rng.integers(0, 3))):
            if m:
                t[rng.integers(0, m)] = rng.integers(0, 4)
        reqs.append(("one_side", s, t, w))
    got = svc.solve_batch(reqs)
    want = [inline.solve(r) for r in reqs]
    for g, wv, r in zip(got, want, reqs):
        assert g == wv, (len(r[1]), len(r[2]), r[3], g, wv)
    assert svc.n_device > 0


def test_mixed_wave(cfg):
    """A wave mixing all kinds resolves in request order."""
    rng = np.random.default_rng(11)
    svc = DeviceAlignService(cfg)
    inline = InlineAlignService(cfg, svc.sm)
    kinds = ["edit_sc_r", "edit_sc_l", "drop_sc_r", "drop_sc_l",
             "end_r", "end_l"]
    reqs = []
    for i in range(200):
        s, t = _rand_pair(rng)
        k = kinds[i % len(kinds)]
        reqs.append((k, s, t))
        if i % 7 == 0:
            reqs.append(("one_side", s[:20], t[:23],
                         int(rng.integers(0, 4))))
    got = svc.solve_batch(reqs)
    for g, r in zip(got, reqs):
        assert g == inline.solve(r)
