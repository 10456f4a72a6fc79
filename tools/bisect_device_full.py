#!/usr/bin/env python
"""Stage bisection of the fused device-full dispatch.

Times cumulative prefixes of the fused program on the device: each prefix
is its own jitted program returning the stage's outputs, and the wall clock
covers dispatch -> ``jax.block_until_ready`` (best of --reps after one
compile run).  A per-op device split comes from a profiler trace instead
(tools/profile_device_full.py).

Usage: python tools/bisect_device_full.py [--batch 16384] [--stages all]
"""

import argparse
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--genome-len", type=int, default=100_000)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--stages", default="all",
                    help="comma list: lookup,gather,chain,extract,full")
    ap.add_argument("--ew", type=int, default=None)
    ap.add_argument("--kscan", type=int, default=None)
    ap.add_argument("--midp", type=int, default=None)
    ap.add_argument("--endp", type=int, default=None)
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import circminer_jax
    circminer_jax.enable_compilation_cache()

    from circminer_jax.config import Config
    from circminer_jax.sim import make_genome, simulate_reads
    from circminer_jax.io.fasta import GenomePacker
    from circminer_jax.index.build import build_genome_index
    from circminer_jax.annotation.annotation import AnnotationDB
    from circminer_jax.pipeline.device_pipeline import DeviceMappingPipeline
    from circminer_jax.pipeline.mapping import ReadRecord
    from circminer_jax.pipeline.types import MatchedRead
    from circminer_jax.ops.encode import encode_seq, revcomp
    from circminer_jax.ops.filter_native import NativeFilter
    import tempfile

    rng = np.random.default_rng(7)
    cfg = Config(kmer=20, max_read_len=120, threads=0)
    g = make_genome(rng, length=args.genome_len,
                    n_genes=max(3, args.genome_len // 20_000))
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "ref.fa")
        gtf = os.path.join(tmp, "ref.gtf")
        g.write_fasta(ref)
        g.write_gtf(gtf)
        gp = GenomePacker(ref)
        contigs, info = gp.pack_genome()
        gi = build_genome_index(contigs, cfg)
        db = AnnotationDB.from_gtf(gtf, info, len(contigs), cfg,
                                   contig_lengths=[len(c) for c in contigs])

    B = args.batch
    n_circ = B // 5
    reads, _ = simulate_reads(rng, g, B - n_circ, n_circ,
                              read_len=100, err_rate=0.005)
    pipe = DeviceMappingPipeline(db, gi, cfg, batch_size=B,
                                 chain_exec="device-full")
    st = pipe.states[0]
    statics = pipe._full_statics()
    for knob in ("ew", "kscan", "midp", "endp"):
        v = getattr(args, knob)
        if v is not None:
            statics[knob.upper()] = v
    nf = pipe.filters[0]
    ad = st.anno
    fa = pipe.full_anno[0]
    genome = pipe.full_genome[0]

    L = cfg.max_read_len
    seqs = np.zeros((4 * B, L), np.int8)
    lens = np.zeros(4 * B, np.int32)
    for i, r in enumerate(reads[:B]):
        for o, s in enumerate((encode_seq(r.r1), revcomp(encode_seq(r.r1)),
                               encode_seq(r.r2), revcomp(encode_seq(r.r2)))):
            seqs[4 * i + o, :len(s)] = s
            lens[4 * i + o] = len(s)
    default_row = NativeFilter.mr_to_state(
        MatchedRead.default(cfg.max_ed), nf.chr_names)
    mr_in = np.ascontiguousarray(
        np.tile(default_row, (B, 1)).astype(np.int32))

    seqs_d = jnp.asarray(seqs)
    lens_d = jnp.asarray(lens)
    mr_d = jnp.asarray(mr_in)

    from circminer_jax.ops.seed import (lookup_batch_device,
                                        gather_seeds_device)
    from circminer_jax.ops.chain import chain_batch_device
    from circminer_jax.ops.device_finish import extract_kbest_device
    from circminer_jax.ops.device_full import (device_full_finish,
                                               device_full_step)

    k = statics["k"]
    NL = cfg.n_kmer_lists
    cap = statics["cap"]

    def front(seqs, lens, upto):
        qpos_all, start, cnt, high = lookup_batch_device(
            seqs, lens, st.entry_hv, st.entry_checksum, st.entry_prefix,
            k=k, cs_len=statics["cs_len"], n_slots=statics["n_slots"],
            seed_lim=statics["seed_lim"], prefix_shift=st.prefix_shift,
            prefix_iters=st.prefix_iters)
        start_e = start[:, ::2]
        cnt_e = cnt[:, ::2]
        hh_row = jnp.sum(high[:, ::2].astype(jnp.int32), axis=1)
        ql = (jnp.arange(NL, dtype=jnp.int32) * k)[None, :]
        qpos_e = jnp.where(ql + k <= lens[:, None], ql, 0).astype(jnp.int32)
        cnt_c = jnp.minimum(cnt_e, cap)
        if upto == "lookup":
            return start_e, cnt_c, hh_row
        pos, _ = gather_seeds_device(st.entry_pos, start_e, cnt_c, cap=cap)
        if upto == "gather":
            return pos
        dp10, back = chain_batch_device(
            pos, cnt_c, qpos_e, lens,
            ad.nb_bits, ad.iv_spos, ad.iv_epos, ad.iv_max_end,
            ad.iv_min_end, ad.iv_max_next, ad.iv_nseg, ad.seg_end,
            ad.seg_next, k=k, max_ed=statics["max_ed"],
            max_intron=statics["max_intron"], seg_pad=statics["seg_pad"])
        if upto == "chain":
            return dp10, back
        return extract_kbest_device(
            dp10, back, pos, qpos_e, cnt_c, k=k, C=statics["KB"] + 1,
            iters=statics["EX_ITERS"])

    stage_fns = {
        "lookup": jax.jit(partial(front, upto="lookup")),
        "gather": jax.jit(partial(front, upto="gather")),
        "chain": jax.jit(partial(front, upto="chain")),
        "extract": jax.jit(partial(front, upto="extract")),
    }

    full_kwargs = dict(statics)

    def full(seqs, lens, mr):
        return device_full_step(
            seqs, lens, mr, st.entry_hv, st.entry_checksum, st.entry_pos,
            genome, ad, fa, st.entry_prefix, contig_num=0,
            prefix_shift=st.prefix_shift, prefix_iters=st.prefix_iters,
            **full_kwargs)

    stage_fns["full"] = jax.jit(full)

    # cumulative finish-stage programs: front -> finish(upto=...)
    fin_statics = {kk: v for kk, v in statics.items()
                   if kk not in ("cs_len", "n_slots", "seed_lim", "cap",
                                 "max_intron", "seg_pad", "seg_compact")}

    def fin(seqs, lens, mr, upto):
        qpos_all, start, cnt, high = lookup_batch_device(
            seqs, lens, st.entry_hv, st.entry_checksum, st.entry_prefix,
            k=k, cs_len=statics["cs_len"], n_slots=statics["n_slots"],
            seed_lim=statics["seed_lim"], prefix_shift=st.prefix_shift,
            prefix_iters=st.prefix_iters)
        start_e = start[:, ::2]
        cnt_e = cnt[:, ::2]
        hh_row = jnp.sum(high[:, ::2].astype(jnp.int32), axis=1)
        ql = (jnp.arange(NL, dtype=jnp.int32) * k)[None, :]
        qpos_e = jnp.where(ql + k <= lens[:, None], ql, 0).astype(jnp.int32)
        cnt_c = jnp.minimum(cnt_e, cap)
        pos, _ = gather_seeds_device(st.entry_pos, start_e, cnt_c, cap=cap)
        dp10, back = chain_batch_device(
            pos, cnt_c, qpos_e, lens,
            ad.nb_bits, ad.iv_spos, ad.iv_epos, ad.iv_max_end,
            ad.iv_min_end, ad.iv_max_next, ad.iv_nseg, ad.seg_end,
            ad.seg_next, k=k, max_ed=statics["max_ed"],
            max_intron=statics["max_intron"], seg_pad=statics["seg_pad"])
        rp, qp, cl, sc10, cn, inc = extract_kbest_device(
            dp10, back, pos, qpos_e, cnt_c, k=k, C=statics["KB"] + 1,
            iters=statics["EX_ITERS"])
        ei = {kk: v for kk, v in fin_statics.items() if kk != "EX_ITERS"}
        return device_full_finish(
            seqs, lens, hh_row, rp, qp, cl, sc10, cn, inc, mr, genome,
            ad, fa, contig_num=0, upto=upto, **ei)

    for nm in ("phase1", "lo", "p2_grid", "p2_gath", "p2_walk", "p2_ext",
               "phase2", "pre"):
        stage_fns[f"f_{nm}"] = jax.jit(partial(fin, upto=nm))

    want = (list(stage_fns) if args.stages == "all"
            else args.stages.split(","))
    results = {}
    for name in want:
        fn = stage_fns[name]
        a = ((seqs_d, lens_d, mr_d)
             if name == "full" or name.startswith("f_")
             else (seqs_d, lens_d))
        t0 = time.time()
        jax.block_until_ready(fn(*a))          # compile + first run
        t_compile = time.time() - t0
        ts = []
        for _ in range(args.reps):
            t0 = time.time()
            jax.block_until_ready(fn(*a))
            ts.append(time.time() - t0)
        results[name] = min(ts)
        print(f"[bisect] {name:8s} {min(ts):7.3f}s  "
              f"(first={t_compile:.1f}s, reps={[f'{x:.3f}' for x in ts]})",
              flush=True)
    d = jax.devices()[0]
    print(f"[bisect] device={d.platform}/{d.device_kind} B={B} "
          f"per-pair={results.get('full', 0) / B * 1e6:.1f}us")


if __name__ == "__main__":
    sys.exit(0 if main() is None else 0)
