#!/usr/bin/env python
"""GRCh38-scale end-to-end run (BASELINE config 4).

Exercises the multi-contig round machinery at the reference's design scale
(the reference's src/circminer.cpp:229-308, genome.cpp:96-145): a ~3.1 Gbp
24-chromosome synthetic genome packs into 3 contigs of <= 1.1 Gbp
(DEF_CONTIG_SIZE), the index is built per contig, and mapping runs one
round per contig with unresolved reads carried through on-disk remain
files — then stage 2 calls circRNAs and the accuracy gate checks every
true back-splice event was recovered.

Phases are resumable via .done sentinels in --workdir:
  sim    -> ref.fa ref.gtf R1.fq R2.fq truth.json
  index  -> ref.fa.packed.fa.index.npz   (~31 GB, uncompressed auto)
  search -> out.circ_report (+ timing/RSS in search_stats.json)
  eval   -> grch38_result.json

Run `--mini` first: a 3-chromosome / 6 Mbp / 20K-pair configuration with a
2 Mbp contig budget that exercises the same multi-contig code path in ~a
minute.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

# GRCh38 primary-assembly chromosome lengths (Mbp, rounded): the shape the
# reference's contig packer was built for.
GRCH38_MBP = [
    ("chr1", 249), ("chr2", 242), ("chr3", 198), ("chr4", 190),
    ("chr5", 182), ("chr6", 171), ("chr7", 159), ("chr8", 145),
    ("chr9", 138), ("chr10", 134), ("chr11", 135), ("chr12", 133),
    ("chr13", 114), ("chr14", 107), ("chr15", 102), ("chr16", 90),
    ("chr17", 83), ("chr18", 80), ("chr19", 59), ("chr20", 64),
    ("chr21", 47), ("chr22", 51), ("chrX", 156), ("chrY", 57),
]

MINI_MBP = [("chr1", 3), ("chr2", 2), ("chr3", 1)]


def log(msg):
    sys.stderr.write(f"[grch38 {time.strftime('%H:%M:%S')}] {msg}\n")
    sys.stderr.flush()


def run_timed(cmd, env=None, log_path=None):
    """Run a subprocess, polling /proc/<pid>/status VmHWM for its peak RSS
    (no /usr/bin/time in this image); return (secs, peak_rss_gb)."""
    t0 = time.time()
    logf = open(log_path, "w") if log_path else subprocess.DEVNULL
    p = subprocess.Popen(cmd, env=env, stdout=logf, stderr=logf)
    peak_kb = 0
    status = f"/proc/{p.pid}/status"
    while p.poll() is None:
        try:
            with open(status) as f:
                for line in f:
                    if line.startswith("VmHWM:"):
                        peak_kb = max(peak_kb, int(line.split()[1]))
                        break
        except OSError:
            pass
        time.sleep(0.5)
    dt = time.time() - t0
    if log_path:
        logf.close()
    if p.returncode != 0:
        if log_path:
            with open(log_path) as f:
                sys.stderr.write(f.read()[-4000:] + "\n")
        raise RuntimeError(f"{cmd[0]} rc={p.returncode} (log: {log_path})")
    return dt, peak_kb / 1e6


def phase_sim(wd, chroms, n_reads, circ_frac, dup_frac, seed):
    ref = os.path.join(wd, "ref.fa")
    gtf = os.path.join(wd, "ref.gtf")
    r1p = os.path.join(wd, "R1.fq")
    r2p = os.path.join(wd, "R2.fq")
    for p in (ref, gtf, r1p, r2p):
        if os.path.exists(p):
            os.remove(p)
    from circminer_jax.sim import make_genome, simulate_reads
    total_bp = sum(bp for _, bp in chroms)
    truth_all = []
    t0 = time.time()
    n_done = 0
    for ci, (chrom, bp) in enumerate(chroms):
        rng = np.random.default_rng(seed + ci)
        n_genes = max(3, bp // 60_000)
        g = make_genome(rng, length=bp, n_genes=n_genes, dup_frac=dup_frac,
                        chrom=chrom, gene_prefix=f"{chrom}.G")
        g.write_fasta(ref, width=0, append=True)
        g.write_gtf(gtf, append=True)
        # reads proportional to chromosome length; the tail chrom absorbs
        # the rounding remainder so the total is exact
        if ci == len(chroms) - 1:
            n_i = n_reads - n_done
        else:
            n_i = int(round(n_reads * bp / total_bp))
        n_done += n_i
        n_circ = n_i // int(1 / circ_frac)
        rng_r = np.random.default_rng(seed + 1000 + ci)
        reads, truth = simulate_reads(rng_r, g, n_i - n_circ, n_circ,
                                      read_len=100, err_rate=0.005,
                                      name_prefix=f"{chrom}.")
        with open(r1p, "a") as f1, open(r2p, "a") as f2:
            for r in reads:
                f1.write(f"@{r.name}\n{r.r1}\n+\n{'I' * len(r.r1)}\n")
                f2.write(f"@{r.name}\n{r.r2}\n+\n{'I' * len(r.r2)}\n")
        truth_all.extend([chrom, s, e] for s, e in truth)
        log(f"sim {chrom}: {bp / 1e6:.0f} Mbp, {n_genes} genes, {n_i} pairs,"
            f" {len(truth)} true events ({time.time() - t0:.0f}s elapsed)")
        del g, reads
    with open(os.path.join(wd, "truth.json"), "w") as f:
        json.dump({"events": truth_all, "n_reads": n_reads}, f)
    log(f"sim done: {n_done} pairs, {len(truth_all)} true events, "
        f"{time.time() - t0:.0f}s")


def phase_eval(wd, out_prefix):
    with open(os.path.join(wd, "truth.json")) as f:
        truth = json.load(f)
    truth_set = {(c, int(s), int(e)) for c, s, e in truth["events"]}
    called = set()
    support = {}
    rep = out_prefix + ".circ_report"
    with open(rep) as f:
        for line in f:
            p = line.split("\t")
            ev = (p[0], int(p[1]), int(p[2]))
            called.add(ev)
            support[ev] = int(p[3])
    matched = len(called & truth_set)
    return {
        "true_events": len(truth_set),
        "called_events": len(called),
        "events_matched": matched,
        "accuracy_gate": matched == len(truth_set),
        "missed": sorted([list(e) for e in (truth_set - called)])[:20],
        "extra_support_gt1": sum(1 for e in called - truth_set
                                 if support[e] > 1),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir",
                    default=os.path.join(REPO, ".cache", "grch38_work"))
    ap.add_argument("--mini", action="store_true",
                    help="3-chrom 6 Mbp / 20K-pair dry run of the same "
                         "multi-contig code path (2 Mbp contig budget)")
    ap.add_argument("--n-reads", type=int, default=None)
    ap.add_argument("--device", default="native",
                    choices=["auto", "native", "device", "device-full"])
    ap.add_argument("--force-phase", default=None,
                    choices=["sim", "index", "search", "eval"],
                    help="re-run this phase (and everything after it)")
    args = ap.parse_args()

    wd = args.workdir
    os.makedirs(wd, exist_ok=True)
    if args.mini:
        chroms = [(c, bp * 1_000_000) for c, bp in MINI_MBP]
        n_reads = args.n_reads or 20_000
        contig_size = 2_000_000
    else:
        chroms = [(c, bp * 1_000_000) for c, bp in GRCH38_MBP]
        n_reads = args.n_reads or 10_000_000
        contig_size = None  # DEF_CONTIG_SIZE (1.1 Gbp -> 3 contigs)

    order = ["sim", "index", "search", "eval"]
    force_from = order.index(args.force_phase) if args.force_phase else None

    def need(ph):
        sent = os.path.join(wd, f"{ph}.done")
        if force_from is not None and order.index(ph) >= force_from:
            if os.path.exists(sent):
                os.remove(sent)
        return not os.path.exists(sent)

    def done(ph):
        with open(os.path.join(wd, f"{ph}.done"), "w") as f:
            f.write(time.strftime("%F %T"))

    stats = {}
    stats_path = os.path.join(wd, "search_stats.json")
    if os.path.exists(stats_path):
        with open(stats_path) as f:
            stats = json.load(f)

    ref = os.path.join(wd, "ref.fa")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO

    if need("sim"):
        log("phase sim...")
        t0 = time.time()
        phase_sim(wd, chroms, n_reads, circ_frac=0.2, dup_frac=0.05,
                  seed=20260821)
        stats["sim_s"] = round(time.time() - t0, 1)
        done("sim")

    cli = [sys.executable, "-m", "circminer_jax.cli"]
    if need("index"):
        log("phase index...")
        cmd = cli + ["--index", "-r", ref, "-k", "20"]
        if contig_size:
            env["CIRCMINER_CONTIG_SIZE"] = str(contig_size)
        dt, rss = run_timed(cmd, env=env,
                            log_path=os.path.join(wd, "index.log"))
        stats["index_s"] = round(dt, 1)
        stats["index_peak_rss_gb"] = round(rss, 1)
        log(f"index built in {dt:.0f}s, peak RSS {rss:.1f} GB")
        done("index")

    out_prefix = os.path.join(wd, "out")
    if need("search"):
        log("phase search (map rounds + circ)...")
        if contig_size:
            env["CIRCMINER_CONTIG_SIZE"] = str(contig_size)
        cmd = cli + ["-r", ref, "-g", os.path.join(wd, "ref.gtf"),
                     "-1", os.path.join(wd, "R1.fq"),
                     "-2", os.path.join(wd, "R2.fq"),
                     "-o", out_prefix, "--device", args.device]
        dt, rss = run_timed(cmd, env=env,
                            log_path=os.path.join(wd, "search.log"))
        stats["search_s"] = round(dt, 1)
        stats["search_peak_rss_gb"] = round(rss, 1)
        log(f"search done in {dt:.0f}s, peak RSS {rss:.1f} GB")
        done("search")

    log("phase eval...")
    res = phase_eval(wd, out_prefix)
    res.update(stats)
    res["n_reads"] = n_reads
    res["genome_bp"] = sum(bp for _, bp in chroms)
    res["n_chroms"] = len(chroms)
    if "search_s" in stats and stats["search_s"]:
        res["pairs_per_sec_search"] = round(n_reads / stats["search_s"], 1)
    with open(os.path.join(wd, "grch38_result.json"), "w") as f:
        json.dump(res, f, indent=1)
    done("eval")
    print(json.dumps(res))
    return 0 if res["accuracy_gate"] else 1


if __name__ == "__main__":
    sys.exit(main())
