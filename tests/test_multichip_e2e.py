"""Multi-chip end-to-end parity: sharded map -> BSJ candidate all-gather ->
circ report must be byte-identical to the single-device run.

Runs on the virtual 8-device CPU mesh (conftest).  The BSJ merge collective
(parallel.mesh.merge_bsj_candidates) carries the real candidate keys — the
direct analog of the reference's single-process sort+group over the remain
FASTQ (process_circ.cpp:179-193, 1570-1631)."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from circminer_jax.config import Config, CHIBSJ, CHI2BSJ
from circminer_jax.sim import make_genome, simulate_reads
from circminer_jax.io.fasta import GenomePacker
from circminer_jax.index.build import build_genome_index
from circminer_jax.annotation.annotation import AnnotationDB
from circminer_jax.pipeline.device_pipeline import DeviceMappingPipeline
from circminer_jax.pipeline.mapping import ReadRecord
from circminer_jax.pipeline.types import MatchedRead
from circminer_jax.pipeline.circ import ProcessCirc
from circminer_jax.parallel.mesh import make_mesh, merge_bsj_candidates, \
    shard_reads
from circminer_jax.ops.encode import encode_seq, revcomp


def _world(tmp_path, n_pairs=96):
    rng = np.random.default_rng(29)
    g = make_genome(rng, length=60_000, n_genes=4)
    ref = str(tmp_path / "ref.fa")
    gtf = str(tmp_path / "ref.gtf")
    g.write_fasta(ref)
    g.write_gtf(gtf)
    cfg = Config(kmer=20, max_read_len=100)
    contigs, info = GenomePacker(ref).pack_genome()
    gi = build_genome_index(contigs, cfg)
    db = AnnotationDB.from_gtf(gtf, info, 1, cfg,
                               contig_lengths=[len(c) for c in contigs])
    n_circ = n_pairs // 2
    reads, _ = simulate_reads(rng, g, n_pairs - n_circ, n_circ)
    return cfg, gi, db, reads


def _mk(r, cfg):
    s1, s2 = encode_seq(r.r1), encode_seq(r.r2)
    return (ReadRecord(r.name, s1, revcomp(s1), "I" * len(r.r1),
                       len(r.r1), MatchedRead.default(cfg.max_ed)),
            ReadRecord(r.name, s2, revcomp(s2), "I" * len(r.r2),
                       len(r.r2), None))


def _report(db, gi, cfg, ordered_pairs, path):
    pc = ProcessCirc(db, gi, cfg, path)
    pc.run(ordered_pairs)
    pc.report_events(path + ".circ_report")
    with open(path + ".circ_report", "rb") as f:
        return f.read()


def test_sharded_run_report_matches_single(tmp_path):
    n_dev = len(jax.devices())
    assert n_dev >= 2, "virtual mesh missing"
    cfg, gi, db, reads = _world(tmp_path)

    # ---- single-device run ----
    single = [_mk(r, cfg) for r in reads]
    pipe = DeviceMappingPipeline(db, gi, cfg, batch_size=32,
                                 chain_exec="native")
    pipe.map_stream(iter(single))
    bsj1 = [(i, pr) for i, pr in enumerate(single)
            if pr[0].mr.type in (CHIBSJ, CHI2BSJ)]
    assert bsj1, "test world produced no BSJ candidates"
    for _, (r1, _) in bsj1:
        r1.mr.genome_spos = r1.mr.spos_r1
    order1 = sorted(bsj1, key=lambda t: (t[1][0].mr.genome_spos, t[0]))
    want = _report(db, gi, cfg, [pr for _, pr in order1],
                   str(tmp_path / "single"))

    # ---- sharded run: each 'host' maps its slice independently ----
    shard_pairs = [_mk(r, cfg) for r in reads]
    per = -(-len(shard_pairs) // n_dev)
    shards = [shard_pairs[d * per:(d + 1) * per] for d in range(n_dev)]
    for sh in shards:
        if sh:
            p = DeviceMappingPipeline(db, gi, cfg, batch_size=32,
                                      chain_exec="native")
            p.map_stream(iter(sh))

    # per-shard fixed-width candidate arrays: (genome_spos, global_idx),
    # padded with sentinel rows; counts say how many are real
    CAP = per
    cand = np.full((n_dev, CAP, 2), 2 ** 30, np.int32)
    cnt = np.zeros((n_dev,), np.int32)
    recs_by_gidx = {}
    for d, sh in enumerate(shards):
        j = 0
        for i, pr in enumerate(sh):
            gidx = d * per + i
            recs_by_gidx[gidx] = pr
            if pr[0].mr.type in (CHIBSJ, CHI2BSJ):
                pr[0].mr.genome_spos = pr[0].mr.spos_r1
                cand[d, j] = (pr[0].mr.genome_spos, gidx)
                j += 1
        cnt[d] = j
    assert cnt.sum() == len(bsj1)

    # the real collective on the virtual mesh, carrying non-zero data
    mesh = make_mesh(n_dev)
    cand_sh = shard_reads(mesh, jnp.asarray(cand.reshape(n_dev * CAP, 2)))
    cnt_sh = shard_reads(mesh, jnp.asarray(np.repeat(cnt, 1)))
    cg, ng = merge_bsj_candidates(mesh, cand_sh, cnt_sh)
    # out_spec replicates: [n_dev, CAP, 2] — each shard's block, identical
    # on every device by construction of the all-gather
    gathered = np.asarray(cg).reshape(-1, 2)
    assert np.asarray(ng).sum() >= 0
    real = gathered[gathered[:, 0] != 2 ** 30]
    assert len(real) == len(bsj1)

    # host 0: deterministic global order = (genome_spos, global input idx)
    order = real[np.lexsort((real[:, 1], real[:, 0]))]
    ordered_pairs = [recs_by_gidx[int(gidx)] for _, gidx in order]
    got = _report(db, gi, cfg, ordered_pairs, str(tmp_path / "sharded"))

    assert got == want and len(want) > 0


def test_sharded_full_step_matches_single_device(tmp_path):
    """The COMPLETE fused device-full map step sharded over the mesh must
    produce the same final MatchedRead blob as the single-device program
    on the same rows (multi-chip correctness must cover the whole mapping
    pipeline, not just lookup+chain)."""
    n_dev = len(jax.devices())
    assert n_dev >= 2, "virtual mesh missing"
    cfg, gi, db, reads = _world(tmp_path, n_pairs=32)
    cfg = Config(**{**cfg.__dict__, "max_read_len": 100, "threads": 1})

    pipe = DeviceMappingPipeline(db, gi, cfg, batch_size=len(reads),
                                 chain_exec="device-full")
    st = pipe.states[0]
    statics = pipe._full_statics()
    nf = pipe.filters[0]
    from circminer_jax.pipeline.types import MatchedRead as MR
    from circminer_jax.ops.filter_native import NativeFilter
    from circminer_jax.ops.device_full import device_full_step

    B = len(reads)
    L = cfg.max_read_len
    seqs = np.zeros((4 * B, L), np.int8)
    lens = np.zeros(4 * B, np.int32)
    for i, r in enumerate(reads):
        s1, s2 = encode_seq(r.r1), encode_seq(r.r2)
        for o, s in enumerate((s1, revcomp(s1), s2, revcomp(s2))):
            seqs[4 * i + o, :len(s)] = s
            lens[4 * i + o] = len(s)
    default_row = NativeFilter.mr_to_state(MR.default(cfg.max_ed),
                                           nf.chr_names)
    mr_in = np.ascontiguousarray(
        np.tile(default_row, (B, 1)).astype(np.int32))

    common = (st.entry_hv, st.entry_checksum, st.entry_pos,
              pipe.full_genome[0], st.anno, pipe.full_anno[0],
              st.entry_prefix)
    want = np.asarray(device_full_step(
        jnp.asarray(seqs), jnp.asarray(lens), jnp.asarray(mr_in), *common,
        contig_num=0, prefix_shift=st.prefix_shift,
        prefix_iters=st.prefix_iters, **statics))

    from circminer_jax.parallel.mesh import (make_mesh, shard_reads,
                                             replicate,
                                             make_sharded_full_step)
    mesh = make_mesh(n_dev)
    step = make_sharded_full_step(mesh, statics, contig_num=0,
                                  prefix_shift=st.prefix_shift,
                                  prefix_iters=st.prefix_iters)
    args = [shard_reads(mesh, jnp.asarray(seqs)),
            shard_reads(mesh, jnp.asarray(lens)),
            shard_reads(mesh, jnp.asarray(mr_in))]
    for a in common:
        args.append(jax.tree_util.tree_map(
            lambda x: replicate(mesh, x), a))
    got = np.asarray(step(*args))

    assert got.shape == want.shape
    # final MatchedRead state must match bit-for-bit; the defer column may
    # only differ via pool-overflow bits (a shard sees 1/D of the load) —
    # none fire at this scale, so require full equality
    np.testing.assert_array_equal(got, want)
    # and the run must have produced real (non-default) state somewhere
    assert (got[:, 0] != mr_in[:, 0]).any()


def test_index_sharded_full_step_matches_single_device(tmp_path):
    """The complete fused step with the ENTRY TABLE bucket-sharded over
    the mesh (owner-computes lookup + psum exchange feeding the full
    finish) == the replicated single-device program, bit-for-bit — the
    configuration for an index larger than one device (SURVEY §5)."""
    n_dev = len(jax.devices())
    assert n_dev >= 2, "virtual mesh missing"
    cfg, gi, db, reads = _world(tmp_path, n_pairs=32)
    cfg = Config(**{**cfg.__dict__, "max_read_len": 100, "threads": 1})

    pipe = DeviceMappingPipeline(db, gi, cfg, batch_size=len(reads),
                                 chain_exec="device-full")
    st = pipe.states[0]
    statics = pipe._full_statics()
    nf = pipe.filters[0]
    from circminer_jax.pipeline.types import MatchedRead as MR
    from circminer_jax.ops.filter_native import NativeFilter
    from circminer_jax.ops.device_full import device_full_step

    B = len(reads)
    L = cfg.max_read_len
    seqs = np.zeros((4 * B, L), np.int8)
    lens = np.zeros(4 * B, np.int32)
    for i, r in enumerate(reads):
        s1, s2 = encode_seq(r.r1), encode_seq(r.r2)
        for o, s in enumerate((s1, revcomp(s1), s2, revcomp(s2))):
            seqs[4 * i + o, :len(s)] = s
            lens[4 * i + o] = len(s)
    default_row = NativeFilter.mr_to_state(MR.default(cfg.max_ed),
                                           nf.chr_names)
    mr_in = np.ascontiguousarray(
        np.tile(default_row, (B, 1)).astype(np.int32))

    want = np.asarray(device_full_step(
        jnp.asarray(seqs), jnp.asarray(lens), jnp.asarray(mr_in),
        st.entry_hv, st.entry_checksum, st.entry_pos,
        pipe.full_genome[0], st.anno, pipe.full_anno[0],
        st.entry_prefix, contig_num=0, prefix_shift=st.prefix_shift,
        prefix_iters=st.prefix_iters, **statics))

    from circminer_jax.parallel.mesh import (make_mesh, shard_reads,
                                             replicate, shard_index,
                                             make_index_sharded_full_step)
    mesh = make_mesh(n_dev)
    step = make_index_sharded_full_step(mesh, statics,
                                        shard_batch=B // n_dev,
                                        contig_num=0)
    args = [shard_reads(mesh, jnp.asarray(seqs)),
            shard_reads(mesh, jnp.asarray(lens)),
            shard_reads(mesh, jnp.asarray(mr_in))]
    args.extend(shard_index(mesh, gi.contigs[0],
                            window_size=cfg.window_size))
    args.append(replicate(mesh, pipe.full_genome[0]))
    for a in (st.anno, pipe.full_anno[0]):
        args.append(jax.tree_util.tree_map(
            lambda x: replicate(mesh, x), a))
    got = np.asarray(step(*args))

    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] != mr_in[:, 0]).any()
