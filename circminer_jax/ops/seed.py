"""Batched seed lookup against the dense genome index.

Reference behavior (src/match_read.cpp:54-286): a read is cut into
non-overlapping k-mers (stride = k); each k-mer's 14-bp window hash selects a
bucket and a binary search over the 6-bp checksum selects the exact-match
position range; k-mers with more than ``seed_lim`` occurrences are dropped
(count=0) but remembered as "high hits".

Device form: everything is a fixed-shape batched computation —
``[B, NL]`` hash gathers + a vectorized binary search over the flat sorted
entry table, followed by a bounded gather of at most S positions per k-mer.
Seed slots are laid out exactly like the reference's ``GIMatchedKmer`` array:
non-overlapping k-mers occupy even slots (ll_step=2, match_read.cpp:270-286),
odd slots stay empty; the chain DP consumes all slots.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..index.build import ContigIndex


class SeedHits(NamedTuple):
    """Per (read, kmer-slot) lookup result; shapes [B, n_slots]."""
    qpos: np.ndarray      # int32 query start of the k-mer (0-based), -1 unused
    start: np.ndarray     # int64 offset into entry_pos of first hit
    count: np.ndarray     # int32 number of hits (0 if none or > seed_lim)
    high_hit: np.ndarray  # bool: had hits but above seed_lim


# --- host (numpy) oracle -----------------------------------------------------

def lookup_read_host(codes: np.ndarray, ci: ContigIndex, cfg: Config):
    """split_match_hash for one read on host. Returns SeedHits-like arrays of
    length cfg.max_seg_cnt (even slots populated)."""
    from .encode import hash_at

    k = cfg.kmer
    w = cfg.window_size
    cs_len = cfg.checksum_len
    n_slots = cfg.max_seg_cnt
    L = codes.shape[0]

    qpos = np.full(n_slots, -1, dtype=np.int32)
    start = np.zeros(n_slots, dtype=np.int64)
    count = np.zeros(n_slots, dtype=np.int32)
    high = np.zeros(n_slots, dtype=bool)

    from ..utils import logging as ulog
    slot = 0
    n_valid = 0
    for i in range(0, L, k):
        if L - i < k:
            break
        qpos[slot] = i
        fh = hash_at(codes, i, k)
        occ = 0
        if fh >= 0:
            hv = fh >> (2 * cs_len)
            cv = fh & ((1 << (2 * cs_len)) - 1) if cs_len else 0
            lo, hi = ci.bucket_range(hv)
            sub = ci.entry_checksum[lo:hi]
            l = np.searchsorted(sub, cv, side="left")
            r = np.searchsorted(sub, cv, side="right")
            c = int(r - l)
            occ = c
            if c > cfg.seed_lim:
                high[slot] = True
                c = 0
            else:
                n_valid += 1 if occ > 0 else 0
            count[slot] = c
            start[slot] = lo + l
        if ulog.TRACE_LEVEL >= 2:  # match_read.cpp:227
            ulog.vaf(2, "Occ: %d\tind: %d\tmatch len: %d", occ, i, k)
        slot += 2
    if ulog.TRACE_LEVEL >= 1:  # match_read.cpp:281
        ulog.vaf(1, "Non-OV valids: %d", n_valid)
        ulog.vaf(1, "OV valids: %d", 0)
    return SeedHits(qpos, start, count, high)


# --- device (jax) version ----------------------------------------------------

def _bisect(keys: jnp.ndarray, target: jnp.ndarray, lo: jnp.ndarray,
            hi: jnp.ndarray, side_right: bool, iters: int) -> jnp.ndarray:
    """Vectorized binary search of ``target`` within keys[lo:hi].

    All of target/lo/hi share a shape; returns insertion offsets (absolute).
    Fixed ``iters`` iterations so it stays jit-friendly.
    """
    def body(_, state):
        lo_, hi_ = state
        mid = (lo_ + hi_) >> 1
        kv = keys[jnp.clip(mid, 0, keys.shape[0] - 1)]
        if side_right:
            go_right = kv <= target
        else:
            go_right = kv < target
        active = lo_ < hi_
        lo2 = jnp.where(active & go_right, mid + 1, lo_)
        hi2 = jnp.where(active & ~go_right, mid, hi_)
        return lo2, hi2

    lo_f, _ = jax.lax.fori_loop(0, iters, body, (lo, hi))
    return lo_f


def _bisect_hv_cv(entry_hv: jnp.ndarray, entry_cv: jnp.ndarray,
                  hv: jnp.ndarray, cv: jnp.ndarray,
                  side_right: bool, iters: int,
                  lo0: jnp.ndarray = None,
                  hi0: jnp.ndarray = None) -> jnp.ndarray:
    """Composite binary search for (hv, cv) over the full sorted entry
    table.  Entries are sorted by (hv, checksum); the composite key does not
    fit int32 (2*kmer bits > 31), so each probe compares the pair.  Replaces
    the dense bucket_start gather (which cost 1 GiB of host RAM per contig
    to build — see index/build.py docstring).

    side_right may be a bool OR a broadcastable bool array (per-row side
    flags let one loop serve the left and right searches together).
    lo0/hi0 optionally restrict each probe's search range (radix-prefix
    bucket bounds)."""
    n = entry_hv.shape[0]
    if lo0 is not None:
        lo = jnp.broadcast_to(lo0, hv.shape)
        hi = jnp.broadcast_to(hi0, hv.shape)
    else:
        lo = jnp.zeros_like(hv)
        hi = jnp.full_like(hv, n)
    if not isinstance(side_right, (bool, np.bool_)):
        side_right = jnp.broadcast_to(side_right, hv.shape)

    def body(_, state):
        lo_, hi_ = state
        mid = (lo_ + hi_) >> 1
        midc = jnp.clip(mid, 0, n - 1)
        hv_e = entry_hv[midc]
        cv_e = entry_cv[midc].astype(jnp.int32)
        if isinstance(side_right, (bool, np.bool_)):
            if side_right:
                go_right = (hv_e < hv) | ((hv_e == hv) & (cv_e <= cv))
            else:
                go_right = (hv_e < hv) | ((hv_e == hv) & (cv_e < cv))
        else:
            tie = jnp.where(side_right, cv_e <= cv, cv_e < cv)
            go_right = (hv_e < hv) | ((hv_e == hv) & tie)
        active = lo_ < hi_
        lo2 = jnp.where(active & go_right, mid + 1, lo_)
        hi2 = jnp.where(active & ~go_right, mid, hi_)
        return lo2, hi2

    lo_f, _ = jax.lax.fori_loop(0, iters, body, (lo, hi))
    return lo_f


def _kmer_hash_parts(read_codes: jnp.ndarray, read_lens: jnp.ndarray,
                     *, k: int, cs_len: int, n_slots: int):
    """Shared hash math for all device lookups.

    Returns (hv, cv, ok, qpos, starts) over the n_nonov = (n_slots+1)//2
    non-overlapping k-mer lists: int32 window hash [B, NL], int32 checksum
    [B, NL], validity mask [B, NL], and per-list query offsets.
    """
    B, L = read_codes.shape
    n_nonov = (n_slots + 1) // 2

    w = k - cs_len  # window size; hash fits int32 (2w <= 28 bits)
    x = read_codes.astype(jnp.int32)
    valid_base = x < 4
    xc = jnp.where(valid_base, x, 0)

    # k-mer start offsets per non-overlapping slot
    starts = jnp.arange(n_nonov, dtype=jnp.int32) * k          # [NL]
    in_read = (starts + k) <= read_lens[:, None]               # [B, NL]

    # slot l covers columns [l*k, (l+1)*k) — a pad + reshape, NOT a gather
    # (the [B, NL, k] row-gather cost ~0.2 s/batch on chip; slicing is free)
    W = n_nonov * k
    if W > L:
        xc = jnp.pad(xc, ((0, 0), (0, W - L)))
        valid_base = jnp.pad(valid_base, ((0, 0), (0, W - L)))
    bases = xc[:, :W].reshape(B, n_nonov, k)                   # [B, NL, k]
    ok = jnp.all(valid_base[:, :W].reshape(B, n_nonov, k),
                 axis=-1) & in_read

    # NOTE: int32 only — JAX runs with x64 disabled, so the window hash
    # (<=28 bits) and checksum (<=16 bits) are computed separately rather
    # than as one 2k-bit value.
    wbasis = (4 ** jnp.arange(w - 1, -1, -1, dtype=jnp.int32))
    hv = jnp.sum(bases[..., :w] * wbasis, axis=-1)             # [B, NL]
    if cs_len:
        cbasis = (4 ** jnp.arange(cs_len - 1, -1, -1, dtype=jnp.int32))
        cv = jnp.sum(bases[..., w:] * cbasis, axis=-1)
    else:
        cv = jnp.zeros_like(hv)

    qpos = jnp.where(in_read, starts[None, :], -1).astype(jnp.int32)
    return hv, cv, ok, qpos, starts


def build_device_prefix(entry_hv, window_size: int):
    """Host-side construction of the device radix-prefix table: a
    4^p + 1 offset array over the top 2p bits of the window hash (the
    device twin of NativeSeeder's radix table; p capped at 12 -> <=67 MB
    of device memory).  Returns (prefix int32[4^p + 1], shift, iters) where iters is
    the static bisect depth covering the largest bucket."""
    n = int(entry_hv.shape[0])
    if n == 0:
        return None, 0, 1
    # p must not exceed window_size, or shift below goes negative
    # (undefined device shift) for window_size <= 11 + large tables
    p = min(12, window_size, max(1, int(np.ceil(np.log2(max(2, n)) / 2))))
    shift = 2 * window_size - 2 * p
    q = (np.asarray(entry_hv) >> shift).astype(np.int64)
    counts = np.bincount(q, minlength=1 << (2 * p))
    prefix = np.zeros(counts.shape[0] + 1, np.int32)
    np.cumsum(counts, out=prefix[1:])
    iters = int(np.ceil(np.log2(int(counts.max()) + 1))) + 1
    return prefix, shift, iters


@partial(jax.jit, static_argnames=("k", "cs_len", "n_slots", "seed_lim",
                                   "prefix_shift", "prefix_iters"))
def lookup_batch_device(read_codes: jnp.ndarray, read_lens: jnp.ndarray,
                        entry_hv: jnp.ndarray, entry_checksum: jnp.ndarray,
                        entry_prefix: jnp.ndarray = None,
                        *, k: int, cs_len: int, n_slots: int, seed_lim: int,
                        prefix_shift: int = 0, prefix_iters: int = 0):
    """Batched seed lookup: [B, L] int8 reads -> per-slot (start, count, hh).

    Only even slots are populated (odd slots are the reference's reserved
    overlapping-kmer slots and stay empty).

    entry_prefix (optional, from ``build_device_prefix``) is an hv-prefix
    offset table that narrows each composite bisect to its ~1-entry prefix
    bucket — the device twin of the host radix lookup: 2 gathers replace
    ~14 of the ~18 full-table bisect steps.
    """
    B, L = read_codes.shape
    n_nonov = (n_slots + 1) // 2
    hv, cv, ok, qpos, starts = _kmer_hash_parts(
        read_codes, read_lens, k=k, cs_len=cs_len, n_slots=n_slots)

    hv_safe = jnp.where(ok, hv, -1)

    n_entries = entry_hv.shape[0]
    # lane-major [2*NL, B] probe layout (B in the minor axis), and the
    # left/right searches share ONE bisect loop via a per-row side flag —
    # halving the serial step count
    NLn = hv_safe.shape[1]
    hv2 = jnp.concatenate([hv_safe.T, hv_safe.T], axis=0)   # [2NL, B]
    cv2 = jnp.concatenate([cv.T, cv.T], axis=0)
    right_f = (jnp.arange(2 * NLn, dtype=jnp.int32) >= NLn)[:, None]
    if entry_prefix is not None:
        iters = max(1, prefix_iters)
        np_ = entry_prefix.shape[0] - 1
        q = jnp.clip(jnp.where(hv2 >= 0, hv2 >> prefix_shift, 0), 0,
                     np_ - 1)
        lo0 = entry_prefix[q]
        hi0 = entry_prefix[q + 1]
        both = _bisect_hv_cv(entry_hv, entry_checksum, hv2, cv2,
                             side_right=right_f, iters=iters,
                             lo0=lo0, hi0=hi0)
    else:
        iters = max(1, int(np.ceil(np.log2(max(2, n_entries + 1)))) + 1)
        both = _bisect_hv_cv(entry_hv, entry_checksum, hv2, cv2,
                             side_right=right_f, iters=iters)
    left = both[:NLn].T
    right = both[NLn:].T

    cnt = (right - left).astype(jnp.int32)
    cnt = jnp.where(ok, cnt, 0)
    high = cnt > seed_lim
    cnt = jnp.where(high, 0, cnt)

    # scatter into the strided slot layout [B, n_slots]
    def strided(v, fill):
        out = jnp.full((B, n_slots), fill, v.dtype)
        return out.at[:, ::2].set(v)

    return (
        strided(qpos, jnp.int32(-1)),
        strided(left.astype(jnp.int32), jnp.int32(0)),
        strided(cnt, jnp.int32(0)),
        strided(high, False),
    )


def lookup_gather_sharded_local(read_codes: jnp.ndarray,
                                read_lens: jnp.ndarray,
                                local_hv: jnp.ndarray,
                                local_checksum: jnp.ndarray,
                                local_pos: jnp.ndarray,
                                bucket_lo: jnp.ndarray,
                                bucket_hi: jnp.ndarray,
                                *, k: int, cs_len: int, n_slots: int,
                                seed_lim: int, cap: int):
    """One shard's contribution to a bucket-sharded seed lookup (the TP
    analog of the mrsFAST index, SURVEY §5: when the index exceeds one
    device's memory, hash buckets are sharded across devices and every one
    answers only the queries whose hash it owns).

    reads are the FULL (replicated / all-gathered) query batch; the index
    arrays are this shard's contiguous bucket slice (see
    parallel.mesh.shard_index_arrays).  Results are zero for queries owned
    by other shards, so the caller combines contributions with
    ``lax.psum`` over the mesh axis.

    Returns (qpos [B, NL] — identical on every shard, pos [B, NL, cap],
    cnt [B, NL], high [B, NL] int32) over non-overlapping k-mer lists.
    """
    hv, cv, ok, qpos, _ = _kmer_hash_parts(
        read_codes, read_lens, k=k, cs_len=cs_len, n_slots=n_slots)

    mine = ok & (hv >= bucket_lo) & (hv < bucket_hi)
    hv_safe = jnp.where(mine, hv, -1)

    n_local = local_hv.shape[0]
    iters = max(1, int(np.ceil(np.log2(max(2, n_local + 1)))) + 1)
    left = _bisect_hv_cv(local_hv, local_checksum, hv_safe, cv,
                         side_right=False, iters=iters)
    right = _bisect_hv_cv(local_hv, local_checksum, hv_safe, cv,
                          side_right=True, iters=iters)

    cnt = (right - left).astype(jnp.int32)
    high = (cnt > seed_lim) & mine
    cnt = jnp.where(mine & ~high, cnt, 0)

    offs = jnp.arange(cap, dtype=jnp.int32)
    idx = jnp.clip(left[..., None] + offs, 0, n_local - 1)
    pos = local_pos[idx].astype(jnp.int32)
    mask = offs < jnp.minimum(cnt, cap)[..., None]
    return qpos, jnp.where(mask, pos, 0), cnt, high.astype(jnp.int32)


@partial(jax.jit, static_argnames=("cap",))
def gather_seeds_device(entry_pos: jnp.ndarray, start: jnp.ndarray,
                        count: jnp.ndarray, *, cap: int):
    """Gather up to ``cap`` sorted positions per (read, slot).

    Returns int32 [B, n_slots, cap] positions (0 where masked) and the same
    count array clipped to cap.  Entries within a (hash, checksum) range are
    position-sorted by construction, matching the reference's introSortGI
    ordering (Sort.c).
    """
    offs = jnp.arange(cap, dtype=jnp.int32)
    idx = start[..., None] + offs                         # [B, S, cap]
    idx = jnp.clip(idx, 0, entry_pos.shape[0] - 1)
    pos = entry_pos[idx].astype(jnp.int32)
    mask = offs < count[..., None]
    return jnp.where(mask, pos, 0), mask
