"""Run the fused device-full executor on ONE GRCh38-scale contig.

Either loads contig 0 (~1.03 Gbp, ~1.0 G index entries, 10 B/entry on the
device) from a GRCh38 workdir made by tools/grch38_run.py, or, with
--synthetic-bp, makes a contig of that size in memory: random genome codes,
a random sorted entry table with one entry per base, and a GTF with one
two-isoform gene per 60 kbp.  Either way the device holds the contig's
state at full size, the fused program (lookup -> chain -> k-best ->
pairing -> extension walks -> lattice) compiles for the default batch and
maps --n-pairs read pairs.  Records pairs/s, the deferral histogram, the
seg_compact choice and device memory stats.

This is a fit probe, not an accuracy gate: on the synthetic contig the
reads do not match the random index, and with a workdir the reads of other
contigs stay unresolved (the 3-round accuracy gate is tools/grch38_run.py).
"""
import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np


def log(m):
    sys.stderr.write(f"[g38full {time.strftime('%H:%M:%S')}] {m}\n")
    sys.stderr.flush()


def load_workdir(wd):
    """(gi, db, cfg, pairs iterator factory) from a grch38_run workdir."""
    from circminer_jax.config import Config
    from circminer_jax.io.fasta import GenomePacker
    from circminer_jax.index.build import GenomeIndex, ContigIndex
    from circminer_jax.annotation.annotation import AnnotationDB
    from circminer_jax.io.fastq import read_pairs

    gp = GenomePacker(os.path.join(wd, "ref.fa"))
    info = gp.load_index_info()
    t0 = time.time()
    log("loading contig 0 of the GRCh38 index (npz, lazy per-key)...")
    z = np.load(gp.index_fname + ".npz", allow_pickle=False)
    w = int(z["window_size"])
    cs_len = int(z["checksum_len"])
    codes0 = z["c0_codes"]
    ci0 = ContigIndex(
        name=str(z["c0_name"]), length=codes0.shape[0], codes=codes0,
        entry_hv=z["c0_hv"], entry_checksum=z["c0_checksum"],
        entry_pos=z["c0_pos"])
    gi = GenomeIndex(w, cs_len, [ci0])
    log(f"contig 0 loaded ({time.time() - t0:.0f}s)")
    cfg = Config(kmer=w + cs_len, window_size=w)
    n_contigs = GenomePacker.packed_contig_cnt(info)
    # contig lengths without loading the other contigs' codes: each
    # contig's extent is the max chromosome end in the packed map
    lengths = [0] * n_contigs
    base = min(x.contig_id for x in info)
    for cl in info:
        ci_id = cl.contig_id - base
        lengths[ci_id] = max(lengths[ci_id], cl.end_pos)
    lengths[0] = ci0.codes.shape[0]
    db = AnnotationDB.from_gtf(
        os.path.join(wd, "ref.gtf"), info, n_contigs, cfg,
        contig_lengths=lengths)
    return gi, db, cfg, lambda: read_pairs(os.path.join(wd, "R1.fq"),
                                           os.path.join(wd, "R2.fq"), cfg)


def make_synthetic(n_bp, seed, tmpdir):
    """(gi, db, cfg, pairs iterator factory) for an in-memory contig of
    n_bp bases with a random index of n_bp entries."""
    from circminer_jax.config import Config
    from circminer_jax.io.fasta import ContigLen
    from circminer_jax.index.build import GenomeIndex, ContigIndex
    from circminer_jax.annotation.annotation import AnnotationDB
    from circminer_jax.pipeline.mapping import ReadRecord
    from circminer_jax.pipeline.types import MatchedRead
    from circminer_jax.ops.encode import revcomp

    cfg = Config(kmer=20, max_read_len=120, threads=0)
    w = cfg.window_size
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n_bp, dtype=np.int8)
    # sorted window hashes without a sort: a random walk over [0, 4^w)
    steps = (rng.random(n_bp, dtype=np.float32) < 0.25).astype(np.int32)
    hv = np.cumsum(steps, dtype=np.int64)
    np.minimum(hv, 4 ** w - 1, out=hv)
    ci0 = ContigIndex(
        name="1", length=n_bp, codes=codes, entry_hv=hv.astype(np.int32),
        entry_checksum=rng.integers(0, 1 << 12, size=n_bp, dtype=np.int16),
        entry_pos=rng.integers(1, n_bp - 200, size=n_bp, dtype=np.int32))
    del hv, steps
    gi = GenomeIndex(w, cfg.checksum_len, [ci0])
    gtf = os.path.join(tmpdir, "synthetic.gtf")
    with open(gtf, "w") as f:
        for g, gs in enumerate(range(10_000, n_bp - 60_000, 60_000)):
            gid = f'gene_id "G{g}";'
            ex = [(gs, gs + 300), (gs + 10_000, gs + 10_400),
                  (gs + 30_000, gs + 30_500)]
            f.write(f"chr1\tsyn\tgene\t{gs}\t{gs + 30_500}\t.\t+\t.\t{gid}\n")
            for t, exons in enumerate((ex, ex[::2])):
                tid = f'{gid} transcript_id "G{g}.{t}";'
                f.write(f"chr1\tsyn\ttranscript\t{exons[0][0]}\t"
                        f"{exons[-1][1]}\t.\t+\t.\t{tid}\n")
                for e, (a, b) in enumerate(exons):
                    f.write(f"chr1\tsyn\texon\t{a}\t{b}\t.\t+\t.\t"
                            f'{tid} exon_number "{e + 1}";\n')
    db = AnnotationDB.from_gtf(gtf, [ContigLen("chr1", 1, 0, n_bp)], 1, cfg,
                               contig_lengths=[n_bp])

    def pairs():
        prng = np.random.default_rng(seed + 1)
        for i in range(1 << 62):
            s = int(prng.integers(0, n_bp - 400))
            r1 = codes[s:s + 100].copy()
            r2 = revcomp(codes[s + 200:s + 300].copy())
            yield (ReadRecord(f"s{i}", r1, revcomp(r1), "I" * 100, 100,
                              MatchedRead.default(cfg.max_ed)),
                   ReadRecord(f"s{i}", r2, revcomp(r2), "I" * 100, 100,
                              None))
    return gi, db, cfg, pairs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir",
                    default=os.path.join(REPO, ".cache", "grch38_work"))
    ap.add_argument("--synthetic-bp", type=int, default=None,
                    help="make the contig in memory instead of loading it "
                         "(1_060_000_000 = the largest GRCh38 contig)")
    ap.add_argument("--n-pairs", type=int, default=131072)
    ap.add_argument("--batch", type=int, default=None,
                    help="pairs per fused step (default: the pipeline's)")
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "grch38_devicefull.json"))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host CPU backend (small rehearsals)")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        sys.exit("grch38_devicefull: no GPU found; pass --cpu to run on "
                 "the host CPU")
    from circminer_jax.pipeline.device_pipeline import DeviceMappingPipeline
    from circminer_jax import enable_compilation_cache
    enable_compilation_cache()

    import tempfile
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        if args.synthetic_bp:
            gi, db, cfg, pair_src = make_synthetic(args.synthetic_bp, 38, tmp)
        else:
            gi, db, cfg, pair_src = load_workdir(args.workdir)
    ci0 = gi.contigs[0]
    log(f"contig 0: {ci0.codes.shape[0] / 1e9:.3f} Gbp, "
        f"{ci0.entry_hv.shape[0] / 1e9:.3f} G entries, annotation "
        f"{len(db.contigs[0].gene_start)} genes ({time.time() - t0:.0f}s)")

    t0 = time.time()
    kw = {} if args.batch is None else dict(batch_size=args.batch)
    pipe = DeviceMappingPipeline(db, gi, cfg, chain_exec="device-full", **kw)
    log(f"pipeline up (device upload enqueued) ({time.time() - t0:.0f}s)")

    ms = jax.devices()[0].memory_stats() or {}
    log(f"device memory after upload: "
        f"{ms.get('bytes_in_use', 0) / 2**30:.2f} GiB in use / "
        f"{ms.get('bytes_limit', 0) / 2**30:.2f} GiB limit; "
        f"seg_compact={pipe.seg_compact}")

    pairs = []
    for pr in pair_src():
        pairs.append(pr)
        if len(pairs) >= args.n_pairs:
            break
    log(f"{len(pairs)} pairs loaded")

    t0 = time.time()
    pipe.warmup()
    warm_s = time.time() - t0
    log(f"warmup (compile) {warm_s:.0f}s")

    t0 = time.time()
    n = pipe.map_stream(iter(pairs), contig=0)
    map_s = time.time() - t0
    fs = pipe.full_stats
    from circminer_jax.config import CONCRD
    n_conc = sum(1 for r1, _ in pairs if r1.mr.type == CONCRD)
    ms2 = jax.devices()[0].memory_stats() or {}
    d = jax.devices()[0]
    rec = {
        "metric": "grch38_contig0_devicefull_pairs_per_sec",
        "value": round(n / map_s, 1),
        "unit": "pairs/s",
        "n_pairs": n,
        "map_s": round(map_s, 1),
        "warm_s": round(warm_s, 1),
        "conc": n_conc,
        "deferred_pct": round(100.0 * fs["deferred"] / max(1, fs["reads"]),
                              2),
        "defer_causes": fs.get("causes", {}),
        "entries": int(ci0.entry_hv.shape[0]),
        "genome_bp": int(ci0.codes.shape[0]),
        "synthetic": bool(args.synthetic_bp),
        "batch": pipe.batch,
        "seg_compact": pipe.seg_compact,
        "device": f"{d.platform}/{d.device_kind}",
        "mem_gib_in_use": round(ms2.get("bytes_in_use", 0) / 2 ** 30, 2),
        "mem_gib_peak": round(ms2.get("peak_bytes_in_use", 0) / 2 ** 30, 2),
        "mem_gib_limit": round(ms2.get("bytes_limit", 0) / 2 ** 30, 2),
    }
    print(json.dumps(rec))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    log("done")


if __name__ == "__main__":
    main()
