#!/usr/bin/env python
"""Benchmark: paired-end reads/sec/chip for the full map+call pipeline.

Generates (and caches) a synthetic genome + annotation + PE read set, runs
the complete pipeline — batched device seed lookup + chain DP, host
extension/categories, circRNA stage — and reports throughput.

Prints exactly one JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N}

vs_baseline normalizes against a nominal 10,000 PE reads/sec/chip target
(the reference repo publishes no benchmark numbers — SURVEY.md §6; the
CircMiner paper reports order-minutes for ~40M reads on a multicore CPU,
i.e. ~10-100k reads/s/machine).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from circminer_jax.cli import EXECUTORS

BASELINE_READS_PER_SEC = 10_000.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="small quick run")
    ap.add_argument("--toy", action="store_true",
                    help="the old 5 Mbp / 20K-pair toy configuration")
    ap.add_argument("--chr21", action="store_true",
                    help="chr21-scale run: 47 Mbp genome, ~780 genes, 5%% "
                         "segmental duplications, 1M read pairs (the "
                         "DEFAULT when no size flag is given)")
    ap.add_argument("--n-reads", type=int, default=None)
    ap.add_argument("--genome-len", type=int, default=None)
    ap.add_argument("--err-rate", type=float, default=0.005)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host CPU backend; without it a "
                         "backend other than the GPU is refused")
    ap.add_argument("--profile-circ", default=None, metavar="PATH",
                    help="cProfile the circRNA stage and dump stats there")
    ap.add_argument("--dump-events", default=None, metavar="PATH",
                    help="write called + true event coordinates (JSON) for "
                         "offline FP/FN analysis")
    ap.add_argument("--circ-device", action="store_true",
                    help="dispatch stage-2 extension DPs to the device "
                         "(speculate-and-select waves; bit-equal outputs)")
    ap.add_argument("--sweep-ed", default=None, metavar="LO..HI",
                    help="run the whole map+call once per max edit distance "
                         "e in LO..HI (BASELINE config 3, the reference's "
                         "-e knob, commandline_parser.cpp:7-26); prints one "
                         "JSON line per e plus the standard line for the "
                         "default e=4")
    ap.add_argument("--repeat", type=int, default=None,
                    help="run the timed map+call region N times on fresh "
                         "read-state and report the best (default 3 for "
                         "the chr21 headline config, 1 for --smoke/--toy; "
                         "run-to-run spread goes in the JSON)")
    ap.add_argument("--exec", dest="chain_exec", default="auto",
                    choices=list(EXECUTORS),
                    help="seed-lookup + chain-DP executor (auto probes "
                         "device and host lookup at warmup and picks the "
                         "faster); wave = device lookup/chain auto + "
                         "wave-batched device extension; device-full = "
                         "the fused on-device finish (lookup->chain->"
                         "extend->categories in one dispatch, only final "
                         "MatchedRead state crosses d2h)")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        sys.exit(f"bench: no GPU found (JAX platform "
                 f"{jax.devices()[0].platform!r}); pass --cpu to run on "
                 f"the host CPU")

    import circminer_jax
    circminer_jax.enable_compilation_cache()

    if args.smoke:
        n_reads = args.n_reads or 500
        genome_len = args.genome_len or 100_000
        dup_frac = 0.0
    elif args.toy:
        n_reads = args.n_reads or 20_000
        genome_len = args.genome_len or 5_000_000
        dup_frac = 0.0
    else:
        # chr21 scale is the default bench (BASELINE.md config 1)
        n_reads = args.n_reads or 1_000_000
        genome_len = args.genome_len or 47_000_000
        dup_frac = 0.05

    from circminer_jax.config import Config, CHIBSJ, CHI2BSJ, CONCRD
    from circminer_jax.sim import make_genome, simulate_reads
    from circminer_jax.io.fasta import GenomePacker, ContigLen
    from circminer_jax.index.build import build_genome_index
    from circminer_jax.annotation.annotation import AnnotationDB
    from circminer_jax.pipeline.device_pipeline import DeviceMappingPipeline
    from circminer_jax.pipeline.mapping import ReadRecord
    from circminer_jax.pipeline.types import MatchedRead
    from circminer_jax.pipeline.circ import ProcessCirc
    from circminer_jax.ops.encode import encode_seq, revcomp

    rng = np.random.default_rng(20260817)
    n_genes = max(3, genome_len // 60_000)
    t0 = time.time()
    # threads=0 -> every core (the reference's `-t <big>` clamp semantics)
    cfg = Config(kmer=20, max_read_len=120, threads=0)

    import pickle
    import hashlib
    cache_dir = circminer_jax.CACHE_DIR
    os.makedirs(cache_dir, exist_ok=True)
    # key the setup cache on the sources that produce it, so simulator /
    # index-builder / annotation changes invalidate stale (g, gi, db)
    # pickles instead of silently masking regressions in the accuracy gate
    pkg = os.path.dirname(os.path.abspath(circminer_jax.__file__))
    h = hashlib.sha256()
    for src in ("sim.py", "index/build.py", "annotation/annotation.py",
                "io/fasta.py"):
        with open(os.path.join(pkg, src), "rb") as f:
            h.update(f.read())
    code_ver = h.hexdigest()[:10]
    cache = os.path.join(
        cache_dir,
        f"benchsetup_g{genome_len}_n{n_genes}_d{dup_frac}_k{cfg.kmer}"
        f"_{code_ver}.pkl")
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            g, gi, db = pickle.load(f)
    else:
        g = make_genome(rng, length=genome_len, n_genes=n_genes,
                        dup_frac=dup_frac)
        import tempfile
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
        try:
            with open(cache, "wb") as f:
                pickle.dump((g, gi, db), f, protocol=4)
        except Exception:
            pass
    setup_s = time.time() - t0

    n_circ = n_reads // 5
    # reads use their own rng stream so the cached-setup path is
    # deterministic regardless of how much of `rng` make_genome consumed
    rng_reads = np.random.default_rng(20260818)
    reads, truth = simulate_reads(rng_reads, g, n_reads - n_circ, n_circ,
                                  read_len=100, err_rate=args.err_rate)

    def make_pair(r, med):
        s1, s2 = encode_seq(r.r1), encode_seq(r.r2)
        return (ReadRecord(r.name, s1, revcomp(s1), "I" * len(r.r1),
                           len(r.r1), MatchedRead.default(med)),
                ReadRecord(r.name, s2, revcomp(s2), "I" * len(r.r2),
                           len(r.r2), None))

    # the 1M-pair read set keeps ~3.5M numpy objects alive; CPython's
    # cyclic GC full-collects over them at arbitrary points (seconds of
    # run-to-run noise straddling the map/circ boundary).  Everything here
    # is refcount-managed, so the collector is pure overhead.
    import gc
    gc.disable()

    if args.sweep_ed:
        # BASELINE config 3: the same dataset through every operating
        # point e=LO..HI; one JSON line per e
        lo, hi = (int(x) for x in args.sweep_ed.split(".."))
        for e in range(lo, hi + 1):
            cfg_e = Config(**{**cfg.__dict__, "max_ed": e}).validate()
            pairs_e = [make_pair(r, e) for r in reads]
            pipe = DeviceMappingPipeline(db, gi, cfg_e,
                                         batch_size=args.batch,
                                         chain_exec=EXECUTORS[
                                             args.chain_exec][0])
            pipe.warmup()
            t0 = time.time()
            n = pipe.map_stream(iter(pairs_e))
            map_s = time.time() - t0
            t0 = time.time()
            bsj = [(r1, r2) for r1, r2 in pairs_e
                   if r1.mr.type in (CHIBSJ, CHI2BSJ)]
            for r1, _ in bsj:
                r1.mr.genome_spos = r1.mr.spos_r1
            bsj.sort(key=lambda pr: pr[0].mr.genome_spos)
            pc = ProcessCirc(db, gi, cfg_e,
                             os.path.join(cache_dir, f"bench_ed{e}"))
            pc.run(bsj)
            circ_s = time.time() - t0
            called = sorted({(c.spos, c.epos) for c in pc.circ_res})
            truth_set = set(truth)
            rps = n / (map_s + circ_s)
            rec = {
                "metric": "pe_reads_per_sec_chip_map_call",
                "max_ed": e,
                "value": round(rps, 2),
                "unit": "reads/s",
                "n_pairs": n,
                "conc": sum(1 for r1, _ in pairs_e
                            if r1.mr.type == CONCRD),
                "bsj_reads": len(bsj),
                "events": len(called),
                "true_events": len(truth),
                "events_matched": sum(1 for ev in called
                                      if ev in truth_set),
                "phases": {"map_s": round(map_s, 2),
                           "circ_s": round(circ_s, 2)},
            }
            # BASELINE_READS_PER_SEC is calibrated for the default
            # max_ed=4 config; the ratio is mislabeled at other e values
            if e == cfg.max_ed:
                rec["vs_baseline"] = round(rps / BASELINE_READS_PER_SEC, 4)
            print(json.dumps(rec))
            del pairs_e, pipe, pc
        return

    pairs = [make_pair(r, cfg.max_ed) for r in reads]

    chain_exec, extend_exec = EXECUTORS[args.chain_exec]
    pipe = DeviceMappingPipeline(db, gi, cfg, batch_size=args.batch,
                                 chain_exec=chain_exec,
                                 extend_exec=extend_exec)
    t0 = time.time()
    pipe.warmup()
    warm_s = time.time() - t0

    repeat = args.repeat
    if repeat is None:
        repeat = 1 if (args.smoke or args.toy or args.profile_circ
                       or args.dump_events) else 3
    runs = []
    from circminer_jax.utils.timing import GLOBAL_TIMER as _T
    for rep in range(repeat):
        if rep > 0:
            # fresh per-read state: the mapping mutates mr in place
            pairs = [make_pair(r, cfg.max_ed) for r in reads]
        t0 = time.time()
        n = pipe.map_stream(iter(pairs))
        map_s = time.time() - t0

        t0 = time.time()
        with _T.phase("circ_select"):
            bsj = [(r1, r2) for r1, r2 in pairs
                   if r1.mr.type in (CHIBSJ, CHI2BSJ)]
            for r1, _ in bsj:
                r1.mr.genome_spos = r1.mr.spos_r1
            bsj.sort(key=lambda pr: pr[0].mr.genome_spos)
        pc = ProcessCirc(db, gi, cfg, os.path.join(cache_dir, "bench_out"))
        if args.circ_device:
            pc.run(bsj, device_ext=True)
            circ_s = time.time() - t0
            args.profile_circ = None
        elif args.profile_circ:
            import cProfile
            prof = cProfile.Profile()
            prof.enable()
            pc.run(bsj)
            prof.disable()
            prof.dump_stats(args.profile_circ)
        else:
            pc.run(bsj)
        circ_s = time.time() - t0
        runs.append(dict(rps=n / (map_s + circ_s) if map_s + circ_s > 0
                         else 0.0, map_s=map_s, circ_s=circ_s))

    best_run = max(runs, key=lambda r: r["rps"])
    map_s, circ_s = best_run["map_s"], best_run["circ_s"]
    total_s = map_s + circ_s
    rps = best_run["rps"]

    n_conc = sum(1 for r1, _ in pairs if r1.mr.type == CONCRD)
    n_bsj_reads = len(bsj)
    called = sorted({(c.spos, c.epos) for c in pc.circ_res})
    n_events = len(called)
    truth_set = set(truth)
    n_matched = sum(1 for e in called if e in truth_set)
    if args.dump_events:
        with open(args.dump_events, "w") as f:
            json.dump({"called": [list(e) for e in called],
                       "truth": [list(e) for e in truth],
                       "support": {f"{c.spos},{c.epos}":
                                   getattr(c, "nreads", 1)
                                   for c in pc.circ_res}}, f)
    backend = jax.devices()[0].platform

    if pipe.full_stats["reads"]:
        fs = pipe.full_stats
        sys.stderr.write(
            f"[bench] device-full: {fs['reads']} reads, {fs['deferred']} "
            f"deferred to host ({100.0 * fs['deferred'] / fs['reads']:.1f}%),"
            f" d2h payload 84 B/pair\n")
        if fs.get("causes"):
            hist = ", ".join(f"{k}={v}" for k, v in sorted(
                fs["causes"].items(), key=lambda kv: -kv[1]))
            sys.stderr.write(f"[bench] defer causes: {hist}\n")
    sys.stderr.write(
        f"[bench] backend={backend} executor={pipe.chain_exec} reads={n} "
        f"genome={genome_len} "
        f"setup={setup_s:.1f}s warm={warm_s:.1f}s map={map_s:.1f}s circ={circ_s:.1f}s "
        f"CONCRD={n_conc} BSJ={n_bsj_reads} events={n_events} "
        f"(true events={len(truth)}, matched={n_matched})\n")
    from circminer_jax.utils.timing import GLOBAL_TIMER
    sys.stderr.write(GLOBAL_TIMER.report() + "\n")
    if pipe.wave_stats["batches"]:
        ws = pipe.wave_stats
        sv = pipe.align_svc
        sys.stderr.write(
            f"[bench] wave engine: {ws['waves']} waves / {ws['batches']} "
            f"batches ({ws['waves'] / ws['batches']:.1f}/batch), "
            f"{sv.n_dispatch} dispatches, {sv.n_device} device / "
            f"{sv.n_host} host requests\n")

    rec = {
        "metric": "pe_reads_per_sec_chip_map_call",
        "value": round(rps, 2),
        "unit": "reads/s",
        "vs_baseline": round(rps / BASELINE_READS_PER_SEC, 4),
        "executor": pipe.chain_exec,
        "backend": backend,
        "n_pairs": n,
        "genome_len": genome_len,
        "events": n_events,
        "true_events": len(truth),
        "events_matched": n_matched,
        "phases": {"setup_s": round(setup_s, 2), "warm_s": round(warm_s, 2),
                   "map_s": round(map_s, 2), "circ_s": round(circ_s, 2)},
    }
    if len(runs) > 1:
        rvals = [round(r["rps"], 2) for r in runs]
        rec["runs"] = rvals
        rec["spread_pct"] = round(
            100.0 * (max(rvals) - min(rvals)) / max(rvals), 1)
    if pipe.full_stats["reads"]:
        fs = pipe.full_stats
        rec["deferred_pct"] = round(100.0 * fs["deferred"] / fs["reads"], 1)
        rec["defer_causes"] = fs.get("causes", {})
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
