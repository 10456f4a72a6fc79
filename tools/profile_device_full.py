#!/usr/bin/env python
"""Profile the fused device-full executor on the device.

Builds the smoke-scale dataset, compiles + runs the fused dispatch once,
then traces a second pass with jax.profiler so the per-op device time of
lookup -> chain -> k-best -> pairing -> extension -> categories can be
read out of the xplane.

Usage: python tools/profile_device_full.py [--trace chiprun_out/dfprof]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=os.path.join("chiprun_out", "dfprof"))
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--n-reads", type=int, default=16384)
    ap.add_argument("--genome-len", type=int, default=100_000)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
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

    n_circ = args.n_reads // 5
    reads, _ = simulate_reads(rng, g, args.n_reads - n_circ, n_circ,
                              read_len=100, err_rate=0.005)

    def mk(rs):
        out = []
        for r in rs:
            s1, s2 = encode_seq(r.r1), encode_seq(r.r2)
            out.append(
                (ReadRecord(r.name, s1, revcomp(s1), "I" * len(r.r1),
                            len(r.r1), MatchedRead.default(cfg.max_ed)),
                 ReadRecord(r.name, s2, revcomp(s2), "I" * len(r.r2),
                            len(r.r2), None)))
        return out

    pipe = DeviceMappingPipeline(db, gi, cfg, batch_size=args.batch,
                                 chain_exec="device-full")
    t0 = time.time()
    pipe.map_stream(iter(mk(reads)))
    t_first = time.time() - t0
    print(f"[profile] first pass (incl. compile): {t_first:.1f}s",
          flush=True)

    from circminer_jax.utils.timing import GLOBAL_TIMER
    GLOBAL_TIMER.reset()
    pairs2 = mk(reads)
    t0 = time.time()
    with jax.profiler.trace(args.trace):
        pipe.map_stream(iter(pairs2))
    t_second = time.time() - t0
    print(f"[profile] traced pass: {t_second:.1f}s", flush=True)
    sys.stderr.write(GLOBAL_TIMER.report() + "\n")
    fs = pipe.full_stats
    print(f"[profile] reads={fs['reads']} deferred={fs['deferred']} "
          f"backend={jax.devices()[0].platform} trace={args.trace}")


if __name__ == "__main__":
    main()
