"""Multi-chip scaling: data-parallel read sharding over a device mesh.

The reference scales with pthreads over shared memory (circminer.cpp:285-297)
and has no distributed story.  The design here (SURVEY §5): reads are
sharded data-parallel across devices ("dp" axis), the genome index and
annotation arrays are replicated into each device's memory (index sharding
with all-to-all seed exchange serves an index too big for one device), and
the small per-shard BSJ candidate lists are
merged with an all-gather at the end so host 0 can write one deterministic
circ_report.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding


from ..config import Config


def make_mesh(n_devices: int = None, axis: str = "dp") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def shard_reads(mesh: Mesh, arr: jnp.ndarray) -> jnp.ndarray:
    """Shard a [B, ...] read-batch array along dp."""
    spec = P("dp", *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def replicate(mesh: Mesh, arr: jnp.ndarray) -> jnp.ndarray:
    return jax.device_put(arr, NamedSharding(mesh, P()))


def make_sharded_map_step(mesh: Mesh, cfg: Config, *, k: int, cs_len: int,
                          n_slots: int, seed_lim: int, seg_pad: int,
                          seed_cap: int):
    """Jitted full mapping device step over the mesh:

    reads [B, L] (sharded dp) x index/annotation (replicated) ->
      (dp10, back, seed positions, high-hit counts) all sharded dp,
      plus an all-reduced total-seed-count scalar (exercises the collective
      path that the BSJ merge uses).
    """
    from ..ops.seed import lookup_batch_device, gather_seeds_device
    from ..ops.chain import chain_batch_device

    NL = (cfg.max_read_len + k - 1) // k

    def step(reads, lens, entry_hv, entry_checksum, entry_pos,
             nb_bits, iv_spos, iv_epos, iv_max_end, iv_min_end,
             iv_max_next, iv_nseg, seg_end, seg_next):
        qpos_d, start_d, cnt_d, hh_d = lookup_batch_device(
            reads, lens, entry_hv, entry_checksum,
            k=k, cs_len=cs_len, n_slots=n_slots, seed_lim=seed_lim)
        sl = slice(0, 2 * NL, 2)
        cnt_c = cnt_d[:, sl]
        qpos_c = jnp.maximum(qpos_d[:, sl], 0)
        start_c = start_d[:, sl]
        pos_b, _ = gather_seeds_device(entry_pos, start_c, cnt_c,
                                       cap=seed_cap)
        dp10, back = chain_batch_device(
            pos_b, cnt_c, qpos_c, lens,
            nb_bits, iv_spos, iv_epos, iv_max_end, iv_min_end,
            iv_max_next, iv_nseg, seg_end, seg_next,
            k=k, max_ed=cfg.max_ed, max_intron=cfg.max_intron,
            seg_pad=seg_pad)
        total_seeds = jnp.sum(cnt_c)
        return dp10, back, pos_b, hh_d.sum(axis=1), total_seeds

    in_spec = (P("dp", None), P("dp"),
               P(), P(), P(), P(), P(), P(), P(), P(), P(), P(),
               P(None, None), P(None, None))
    out_spec = (P("dp", None, None), P("dp", None, None),
                P("dp", None, None), P("dp"), P())

    def wrapped(*args):
        def inner(*a):
            dp10, back, pos_b, hh, tot = step(*a)
            tot = jax.lax.psum(tot, "dp")
            return dp10, back, pos_b, hh, tot
        return jax.shard_map(inner, mesh=mesh, in_specs=in_spec,
                             out_specs=out_spec, check_vma=False)(*args)

    return jax.jit(wrapped)


def make_sharded_full_step(mesh: Mesh, statics: dict, *, contig_num: int = 0,
                           prefix_shift: int = 0, prefix_iters: int = 0):
    """The COMPLETE fused device-full map step sharded over the mesh:
    reads + incoming MatchedRead state data-parallel along dp; index,
    genome, and both annotation pytrees replicated onto every device.

    This is the multi-chip form of the whole per-read mapping pipeline —
    lookup -> chain DP -> k-best -> pairing -> extension pools -> category
    lattice — not just its lookup/chain front (the analog of the reference
    parallelizing process_read itself across workers,
    circminer.cpp:285-345).  Per-shard outputs are bit-identical to the
    single-device program on the same rows: every stage is row-local, and
    the compaction pools scatter back exactly, so only the pool-overflow
    DEFER bits could differ (a shard sees 1/D of the load, so overflow is
    never MORE likely than on one chip).

    Returns a jitted fn(seqs, lens, mr_in, entry_hv, entry_checksum,
    entry_pos, genome, ad, fa, entry_prefix) -> int32 [B, MRF+1] blob.
    """
    from ..ops.device_full import device_full_step

    impl = device_full_step.__wrapped__  # the un-jitted implementation

    def inner(seqs, lens, mr_in, entry_hv, entry_checksum, entry_pos,
              genome, ad, fa, entry_prefix):
        return impl(seqs, lens, mr_in, entry_hv, entry_checksum,
                    entry_pos, genome, ad, fa, entry_prefix,
                    contig_num=contig_num, prefix_shift=prefix_shift,
                    prefix_iters=prefix_iters, **statics)

    in_spec = (P("dp", None), P("dp"), P("dp", None),
               P(), P(), P(), P(), P(), P(), P())
    out_spec = P("dp", None)
    return jax.jit(jax.shard_map(inner, mesh=mesh, in_specs=in_spec,
                                 out_specs=out_spec, check_vma=False))


def make_index_sharded_full_step(mesh: Mesh, statics: dict, *,
                                 shard_batch: int, contig_num: int = 0):
    """The COMPLETE fused device-full map step with the ENTRY TABLE
    bucket-range sharded over the mesh — for an entry table larger than
    one device's memory (GRCh38's is ~30.6 GB at 10 B/entry; SURVEY §5
    long-context analog).

    Composition: reads and incoming MatchedRead state are dp-sharded;
    each device all-gathers the full query batch, answers the
    k-mers whose window hash falls in its bucket range (owner-computes,
    ops/seed.lookup_gather_sharded_local), contributions combine with
    psum — then each chip slices back its own read rows and runs the
    ENTIRE fused finish (chain DP -> k-best -> pairing -> extension walks
    -> category lattice, ops/device_full.full_from_seeds) against the
    replicated genome/annotation.  Per-row outputs are bit-identical to
    the replicated-index step: the exchanged (pos, cnt, high) tensors are
    exactly what the local lookup produces, and everything downstream is
    row-local.

    ``shard_batch`` = per-shard PAIR count (global B = D * shard_batch).
    Returns a jitted fn(seqs, lens, mr_in, hv_sh, cs_sh, pos_sh, blo,
    bhi, genome, ad, fa) -> int32 [B, MRF+1] blob sharded dp.
    """
    from ..ops.device_full import full_from_seeds
    from ..ops.seed import lookup_gather_sharded_local

    st = dict(statics)
    for key in ("cs_len", "n_slots", "seed_lim", "prefix_shift",
                "prefix_iters"):
        st.pop(key, None)
    cs_len = statics["cs_len"]
    n_slots = statics["n_slots"]
    seed_lim = statics["seed_lim"]

    def inner(seqs, lens, mr_in, lhv, lcs, lpos, blo, bhi, genome, ad,
              fa):
        # full query batch on every device
        seqs_g = jax.lax.all_gather(seqs, "dp", axis=0, tiled=True)
        lens_g = jax.lax.all_gather(lens, "dp", axis=0, tiled=True)
        _, pos, cnt, high = lookup_gather_sharded_local(
            seqs_g, lens_g, lhv[0], lcs[0], lpos[0], blo[0], bhi[0],
            k=st["k"], cs_len=cs_len, n_slots=n_slots, seed_lim=seed_lim,
            cap=st["cap"])
        pos = jax.lax.psum(pos, "dp")
        cnt = jax.lax.psum(cnt, "dp")
        high = jax.lax.psum(high, "dp")
        i = jax.lax.axis_index("dp")
        rows = 4 * shard_batch

        def sl(a):
            return jax.lax.dynamic_slice_in_dim(a, i * rows, rows, axis=0)

        hh_row = sl(high).sum(axis=1)
        return full_from_seeds(
            sl(seqs_g), sl(lens_g), mr_in, sl(pos), sl(cnt), hh_row,
            genome, ad, fa, contig_num=contig_num, **st)

    in_spec = (P("dp", None), P("dp"), P("dp", None),
               P("dp", None), P("dp", None), P("dp", None), P("dp"),
               P("dp"), P(), P(), P())
    out_spec = P("dp", None)
    return jax.jit(jax.shard_map(inner, mesh=mesh, in_specs=in_spec,
                                 out_specs=out_spec, check_vma=False))


def shard_index_arrays(ci, n_shards: int, window_size: int = 14):
    """Split a ContigIndex's bucket space into ``n_shards`` contiguous
    ranges (SURVEY §5: an index payload larger than one device's memory
    shards its hash buckets across devices).

    Returns numpy arrays stackable on a leading shard axis:
      hv_sh       int32 [D, E_max]  (window hash per local entry; padding
                                     slots hold an out-of-range sentinel)
      checksum_sh int16 [D, E_max]
      pos_sh      int32 [D, E_max]
      bucket_lo   int32 [D]         (first global bucket owned)
      bucket_hi   int32 [D]         (one past the last bucket owned)
    """
    nb = 1 << (2 * window_size)
    nbd = -(-nb // n_shards)  # ceil
    HV_SENTINEL = np.int32(2 ** 30)  # > any real 28-bit window hash
    slices = []
    e_max = 1
    for d in range(n_shards):
        lo_b = min(d * nbd, nb)
        hi_b = min(lo_b + nbd, nb)
        e_lo = int(np.searchsorted(ci.entry_hv, lo_b, side="left"))
        e_hi = int(np.searchsorted(ci.entry_hv, hi_b, side="left"))
        slices.append((ci.entry_hv[e_lo:e_hi], ci.entry_checksum[e_lo:e_hi],
                       ci.entry_pos[e_lo:e_hi], lo_b, hi_b))
        e_max = max(e_max, e_hi - e_lo)

    D = n_shards
    hv_sh = np.full((D, e_max), HV_SENTINEL, np.int32)
    checksum_sh = np.zeros((D, e_max), np.int16)
    pos_sh = np.zeros((D, e_max), np.int32)
    for d, (hv, cs, ps, _, _) in enumerate(slices):
        hv_sh[d, :hv.shape[0]] = hv
        checksum_sh[d, :cs.shape[0]] = cs
        pos_sh[d, :ps.shape[0]] = ps
    bucket_lo = np.array([s[3] for s in slices], np.int32)
    bucket_hi = np.array([s[4] for s in slices], np.int32)
    return hv_sh, checksum_sh, pos_sh, bucket_lo, bucket_hi


def make_index_sharded_map_step(mesh: Mesh, cfg: Config, *, k: int,
                                cs_len: int, n_slots: int, seed_lim: int,
                                seg_pad: int, seed_cap: int,
                                shard_batch: int):
    """Jitted mapping step with BOTH reads and the k-mer index sharded over
    the mesh (reads dp + index "tensor parallel" on the same axis):

      - every chip holds 1/D of the reads and 1/D of the hash buckets,
      - queries are all-gathered so each chip answers the k-mers whose
        window hash falls in its bucket range (the seed-query exchange of
        SURVEY §5), contributions combined with psum,
      - each chip then chains only its own read rows against the
        replicated annotation arrays.

    ``shard_batch`` is the per-shard read count (global B = D*shard_batch).
    """
    from ..ops.seed import lookup_gather_sharded_local
    from ..ops.chain import chain_batch_device

    def inner(reads, lens, lhv, lcs, lpos, blo, bhi,
              nb_bits, iv_spos, iv_epos, iv_max_end, iv_min_end,
              iv_max_next, iv_nseg, seg_end, seg_next):
        # [Bd, L] shard -> full query batch on every device
        reads_g = jax.lax.all_gather(reads, "dp", axis=0, tiled=True)
        lens_g = jax.lax.all_gather(lens, "dp", axis=0, tiled=True)
        qpos, pos, cnt, high = lookup_gather_sharded_local(
            reads_g, lens_g, lhv[0], lcs[0], lpos[0], blo[0], bhi[0],
            k=k, cs_len=cs_len, n_slots=n_slots, seed_lim=seed_lim,
            cap=seed_cap)
        # owner-computes + psum = the all-to-all result exchange
        pos = jax.lax.psum(pos, "dp")
        cnt = jax.lax.psum(cnt, "dp")
        high = jax.lax.psum(high, "dp")
        # back to my read rows
        i = jax.lax.axis_index("dp")
        sl = lambda a: jax.lax.dynamic_slice_in_dim(
            a, i * shard_batch, shard_batch, axis=0)
        pos_m, cnt_m, qpos_m, lens_m = sl(pos), sl(cnt), sl(qpos), sl(lens_g)
        dp10, back = chain_batch_device(
            pos_m, cnt_m, jnp.maximum(qpos_m, 0), lens_m,
            nb_bits, iv_spos, iv_epos, iv_max_end, iv_min_end,
            iv_max_next, iv_nseg, seg_end, seg_next,
            k=k, max_ed=cfg.max_ed, max_intron=cfg.max_intron,
            seg_pad=seg_pad)
        return dp10, back, pos_m, cnt_m, sl(high).sum(axis=1)

    in_spec = (P("dp", None), P("dp"),
               P("dp", None), P("dp", None), P("dp", None), P("dp"), P("dp"),
               P(), P(), P(), P(), P(), P(), P(),
               P(None, None), P(None, None))
    out_spec = (P("dp", None, None), P("dp", None, None),
                P("dp", None, None), P("dp", None), P("dp"))
    return jax.jit(jax.shard_map(inner, mesh=mesh, in_specs=in_spec,
                                 out_specs=out_spec, check_vma=False))


def shard_index(mesh: Mesh, ci, axis: str = "dp", window_size: int = 14):
    """Device-put a ContigIndex's shard arrays along the mesh axis."""
    n = mesh.devices.size
    lhv, lcs, lpos, blo, bhi = shard_index_arrays(ci, n, window_size)
    put = lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec))
    return (put(lhv, P(axis, None)), put(lcs, P(axis, None)),
            put(lpos, P(axis, None)), put(blo, P(axis)), put(bhi, P(axis)))


def merge_bsj_candidates(mesh: Mesh, cand: jnp.ndarray,
                         count: jnp.ndarray) -> Tuple[jnp.ndarray,
                                                      jnp.ndarray]:
    """All-gather per-shard (spos, epos) candidate arrays so every host sees
    the full set; the final grouping/sort happens on host 0
    (replaces the reference's single-process GNU sort,
    process_circ.cpp:179-193)."""
    def inner(c, n):
        cg = jax.lax.all_gather(c, "dp", axis=0, tiled=False)
        ng = jax.lax.all_gather(n, "dp", axis=0, tiled=False)
        return cg, ng

    return jax.jit(jax.shard_map(
        inner, mesh=mesh,
        in_specs=(P("dp", None), P("dp")),
        out_specs=(P(None, None, None), P(None, None)),
        check_vma=False))(cand, count)
