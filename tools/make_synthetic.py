#!/usr/bin/env python
"""Generate a synthetic genome + GTF + PE FASTQ dataset with circRNA truth."""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from circminer_jax.sim import make_genome, simulate_reads, write_fastq


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=".")
    p.add_argument("--genome-len", type=int, default=100_000)
    p.add_argument("--n-genes", type=int, default=4)
    p.add_argument("--n-reads", type=int, default=1000)
    p.add_argument("--circ-frac", type=float, default=0.2)
    p.add_argument("--read-len", type=int, default=100)
    p.add_argument("--err-rate", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args()

    rng = np.random.default_rng(args.seed)
    g = make_genome(rng, length=args.genome_len, n_genes=args.n_genes)
    os.makedirs(args.out, exist_ok=True)
    g.write_fasta(os.path.join(args.out, "ref.fa"))
    g.write_gtf(os.path.join(args.out, "ref.gtf"))
    n_circ = int(args.n_reads * args.circ_frac)
    reads, truth = simulate_reads(rng, g, args.n_reads - n_circ, n_circ,
                                  read_len=args.read_len,
                                  err_rate=args.err_rate)
    write_fastq(reads, os.path.join(args.out, "R1.fq"),
                os.path.join(args.out, "R2.fq"))
    with open(os.path.join(args.out, "truth.json"), "w") as f:
        json.dump({
            "circ_bp": truth,
            "n_reads": len(reads),
            "n_circ_reads": sum(1 for r in reads if r.truth == "circ"),
        }, f, indent=1)
    print(f"wrote ref.fa ref.gtf R1.fq R2.fq truth.json to {args.out}")


if __name__ == "__main__":
    main()
