"""Multi-host runtime: jax.distributed initialization + host-striped input.

The reference has no distributed story (pthreads only, SURVEY §2); the
scale-out here (SURVEY §5, BASELINE.md) is:

  - every process runs the same program, connected through
    ``jax.distributed.initialize`` (coordinator address from flags or the
    CIRCMINER_COORDINATOR / CIRCMINER_NUM_HOSTS / CIRCMINER_HOST_ID env);
    each process opens one local accelerator (``local_device``), so four
    processes on one four-card machine take a card each,
  - FASTQ input is data-parallel striped by host: host h maps read pairs
    h, h+N, h+2N, ... of the stream (the distributed analog of the
    reference's buffer_lock round-robin, circminer.cpp:373-379),
  - each host writes its own shard outputs (out.h<k>.mapping.pam etc.);
    the BSJ candidates ride the merge_bsj_candidates all-gather so host 0
    can emit the single deterministic circ_report (candidates are ordered
    by (genome_spos, global read index), which reproduces the single-host
    GNU-sort order).

Single-process use is untouched: ``maybe_initialize`` is a no-op unless a
coordinator is configured.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, Optional, Tuple


def maybe_initialize(coordinator: Optional[str] = None,
                     num_hosts: Optional[int] = None,
                     host_id: Optional[int] = None,
                     local_device: Optional[int] = None) -> Tuple[int, int]:
    """Initialize jax.distributed when configured; returns
    (host_id, num_hosts) — (0, 1) in single-process mode.

    local_device is the one local accelerator this process opens (default
    host_id: one process per card of one machine).  A JAX process reserves
    most of every card it can see, so without it coordinated processes on
    one machine would each claim all of its cards."""
    coordinator = coordinator or os.environ.get("CIRCMINER_COORDINATOR")
    num_hosts = int(num_hosts or os.environ.get("CIRCMINER_NUM_HOSTS", "1"))
    host_id = int(host_id if host_id is not None
                  else os.environ.get("CIRCMINER_HOST_ID", "0"))
    if local_device is None:
        local_device = host_id
    if coordinator:
        # full jax.distributed runtime (device collectives across hosts)
        import jax
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_hosts,
                                   process_id=host_id,
                                   local_device_ids=[local_device])
    # without a coordinator, multi-host still works in shared-filesystem
    # mode: striped input + per-host outputs + file-merged circ stage
    return host_id, num_hosts


def stripe_pairs(pairs: Iterable, host_id: int, num_hosts: int,
                 with_index: bool = False) -> Iterator:
    """Host h takes pairs h, h+N, h+2N, ... of the input stream.

    Every host streams the same FASTQ files (shared filesystem, like the
    reference's multi-round rewinds) but only materializes its own stripe;
    with_index additionally yields the global pair index (the deterministic
    tiebreak key for the merged candidate order)."""
    for i, pr in enumerate(pairs):
        if i % num_hosts == host_id:
            yield (i, pr) if with_index else pr


def shard_output_prefix(prefix: str, host_id: int, num_hosts: int) -> str:
    """Per-host output prefix: unchanged when single-host."""
    if num_hosts <= 1:
        return prefix
    return f"{prefix}.h{host_id}"
