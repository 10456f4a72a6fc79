"""Command-line interface.

Mirrors the reference's flag set (src/commandline_parser.cpp) on top of the
batched JAX engine:

    circminer-jax --index -r ref.fa -k 20
    circminer-jax -r ref.fa -g ref.gtf -1 R1.fq -2 R2.fq -o out [--pam|--sam]

Unlike the reference's per-contig rounds, the whole index is resident at
once; the per-round "remain" FASTQ round-trip collapses to a single mapping
pass that still writes the stage-2 remain files (bit-compatible 23-token
headers) so --stage 1 resume works identically.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np

from .config import (Config, CONCRD, CHIBSJ, CHI2BSJ, DISCARDMAPREPORT,
                     PAMFORMAT, SAMFORMAT)

# --device name -> (DeviceMappingPipeline chain_exec, extend_exec); "host"
# is not here: it runs the per-read python oracle, no pipeline.
EXECUTORS = {
    "auto": ("auto", "native"),
    "device": ("device", "native"),
    "device-chain": ("device-chain", "native"),
    "wave": ("auto", "device"),
    "device-full": ("device-full", "native"),
    "native": ("native", "native"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="circminer-jax",
        description="circRNA detection on an accelerator "
                    "(CircMiner-compatible)")
    p.add_argument("-i", "--index", action="store_true")
    p.add_argument("-m", "--compact-index", action="store_true")
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("-g", "--gtf")
    p.add_argument("-s", "--seq")
    p.add_argument("-1", "--seq1", dest="seq1")
    p.add_argument("-2", "--seq2", dest="seq2")
    p.add_argument("-k", "--kmer", type=int, default=20)
    p.add_argument("-l", "--rlen", type=int, default=300)
    p.add_argument("-o", "--output", default="output")
    p.add_argument("-t", "--thread", type=int, default=1)
    p.add_argument("-d", "--verbosity", type=int, default=0)
    p.add_argument("-a", "--scan-lev", type=int, default=0)
    p.add_argument("-e", "--max-ed", type=int, default=4)
    p.add_argument("-c", "--max-sc", type=int, default=7)
    p.add_argument("-w", "--band", type=int, default=3)
    p.add_argument("-S", "--seed-lim", type=int, default=500)
    p.add_argument("-T", "--max-tlen", type=int, default=500)
    p.add_argument("-I", "--max-intron", type=int, default=2_000_000)
    p.add_argument("-C", "--max-chain-list", type=int, default=30)
    p.add_argument("-q", "--stage", type=int, default=2)
    p.add_argument("-z", "--keep-intermediate", action="store_true")
    p.add_argument("-Z", "--internal-sort", action="store_true")
    p.add_argument("-A", "--sam", action="store_true")
    p.add_argument("-P", "--pam", action="store_true")
    p.add_argument("--device", choices=[*EXECUTORS, "host"],
                   default="auto",
                   help="mapping executor: auto = device or native, picked "
                        "by a probe at warmup (default); device = device "
                        "seed lookup + native chain/filter; device-chain = "
                        "dense device chain DP; wave = wave-batched device "
                        "extension (one fused DP dispatch per wave); "
                        "device-full = fused on-device finish (only final "
                        "state crosses d2h); native = batched host C++; "
                        "host = per-read python oracle")
    p.add_argument("--mrsfast-format", action="store_true",
                   help="with --index: also write the reference's mrsFAST "
                        "binary index format for interop/parity checks")
    p.add_argument("--coordinator",
                   help="jax.distributed coordinator address (host:port) "
                        "for multi-host runs; also via CIRCMINER_COORDINATOR")
    p.add_argument("--num-hosts", type=int, default=None)
    p.add_argument("--host-id", type=int, default=None)
    p.add_argument("--local-device", type=int, default=None,
                   help="with --coordinator: the one local accelerator this "
                        "process opens (default: --host-id, i.e. one "
                        "process per card on one machine)")
    p.add_argument("--trace-dir",
                   help="write a jax.profiler (xprof) trace of the search "
                        "stages here (the reference's 'make profile' analog)")
    return p


def config_from_args(args) -> Config:
    report = SAMFORMAT if args.sam else (PAMFORMAT if args.pam
                                         else DISCARDMAPREPORT)
    return Config(
        kmer=args.kmer, max_read_len=args.rlen, max_ed=args.max_ed,
        max_sc=args.max_sc, band_width=args.band, seed_lim=args.seed_lim,
        max_tlen=args.max_tlen, max_intron=args.max_intron,
        max_chain_len=args.max_chain_list, scan_level=args.scan_lev,
        stage=args.stage, report_mapping=report,
        paired_end=args.seq2 is not None,
        compact_index=args.compact_index,
        final_cleaning=not args.keep_intermediate,
        internal_sort=args.internal_sort, threads=args.thread,
    ).validate()


def run_index(args, cfg: Config) -> int:
    from .io.fasta import GenomePacker
    from .index.build import build_genome_index, save_genome_index
    gp = GenomePacker(args.reference)
    print("[INFO] packing reference genome...", file=sys.stderr)
    contigs, info = gp.pack_genome()
    print(f"[INFO] building index over {len(contigs)} contig(s)...",
          file=sys.stderr)
    gi = build_genome_index(contigs, cfg)
    save_genome_index(gi, gp.index_fname, compact=cfg.compact_index)
    print(f"[INFO] index written to {gp.index_fname}.npz", file=sys.stderr)
    if args.mrsfast_format:
        from .index.mrsfast_format import write_mrsfast_index
        write_mrsfast_index(gi, gp.index_fname,
                            full=not cfg.compact_index)
        print(f"[INFO] mrsFAST-format index written to {gp.index_fname}",
              file=sys.stderr)
    return 0


def make_pipeline(db, gi, cfg: Config, device: str):
    """The batched mapping pipeline for a ``--device`` executor name."""
    from .pipeline.device_pipeline import DeviceMappingPipeline
    chain_exec, extend_exec = EXECUTORS[device]
    return DeviceMappingPipeline(db, gi, cfg, chain_exec=chain_exec,
                                 extend_exec=extend_exec)


def run_search(args, cfg: Config, stats: Optional[dict] = None) -> int:
    import contextlib
    from .utils.logging import set_trace_level
    from .utils.timing import device_trace
    set_trace_level(args.verbosity)

    trace = (device_trace(args.trace_dir) if args.trace_dir
             else contextlib.nullcontext())
    with trace:
        return _run_search_stages(args, cfg, {} if stats is None else stats)


def _run_search_stages(args, cfg: Config, stats: dict) -> int:
    from .io.fasta import GenomePacker, chrloc2conloc
    from .io.fastq import read_pairs, RemainWriter
    from .index.build import load_genome_index
    from .annotation.annotation import AnnotationDB
    from .pipeline.mapping import Mapper, make_host_seeder
    from .pipeline.output import SamOutput
    from .pipeline.circ import ProcessCirc
    from .parallel.distributed import (maybe_initialize, stripe_pairs,
                                       shard_output_prefix)

    import os
    host_id, n_hosts = maybe_initialize(args.coordinator, args.num_hosts,
                                        args.host_id, args.local_device)
    out_prefix = shard_output_prefix(args.output, host_id, n_hosts)
    gp = GenomePacker(args.reference)
    info = gp.load_index_info()
    if os.path.exists(gp.index_fname + ".npz"):
        gi = load_genome_index(gp.index_fname)
    else:
        # fall back to a reference-binary-built mrsFAST index
        from .index.mrsfast_format import read_mrsfast_index
        gi = read_mrsfast_index(gp.index_fname)
    cfg = Config(**{**cfg.__dict__, "kmer": gi.kmer})
    n_contigs = GenomePacker.packed_contig_cnt(info)
    print(f"[INFO] loaded index: {n_contigs} contig(s), kmer={gi.kmer}",
          file=sys.stderr)

    db = AnnotationDB.from_gtf(
        args.gtf, info, n_contigs, cfg,
        contig_lengths=[c.length for c in gi.contigs])
    print("[INFO] GTF loaded", file=sys.stderr)

    fmt = {SAMFORMAT: "sam", PAMFORMAT: "pam"}.get(cfg.report_mapping)
    last_round = n_contigs

    if not cfg.paired_end:
        # single-end (filter.cpp:86-121; circminer.cpp:399-402). No circ
        # stage: back-splice evidence requires a paired full mate.
        from .io.fastq import FastqReader
        out = SamOutput(args.output, fmt, info)
        if args.device in EXECUTORS:
            pipe = make_pipeline(db, gi, cfg, args.device)
            pipe.warmup()
            n = pipe.map_stream_se(FastqReader(args.seq, cfg), out, fmt)
        else:
            mappers = [
                Mapper(db, c, gi.contigs[c].codes, cfg,
                       make_host_seeder(gi.contigs[c], cfg))
                for c in range(n_contigs)
            ]
            n = 0
            for rec in FastqReader(args.seq, cfg):
                for c, mapper in enumerate(mappers):
                    state = mapper.process_read_se(rec)
                    if cfg.scan_level == 0 and state == CONCRD:
                        break
                if fmt == "sam":
                    out.write_sam_se(rec)
                elif fmt == "pam":
                    out.write_pam_se(rec)
                n += 1
        out.close()
        print(f"[INFO] SE mapping done: {n} reads", file=sys.stderr)
        return 0

    if cfg.stage != 1:
        out = SamOutput(out_prefix, fmt, info)
        remain = RemainWriter(out_prefix, last_round)

        def conloc(chrname, s, e):
            return chrloc2conloc(db.chr2con, chrname, s, e)

        pair_src = read_pairs(args.seq1, args.seq2, cfg)

        # attach the global pair ordinal: the circ-stage sort tie-breaks on
        # it so a multi-host merge reproduces the single-host stream order
        if n_hosts > 1:
            # dp striping: host h maps pairs h, h+N, ... of the stream
            def _with_ord(ps=pair_src):
                for gi, (r1, r2) in stripe_pairs(ps, host_id, n_hosts,
                                                 with_index=True):
                    r1.ordinal = gi
                    yield r1, r2
        else:
            def _with_ord(ps=pair_src):
                for gi, (r1, r2) in enumerate(ps):
                    r1.ordinal = gi
                    yield r1, r2
        pair_src = _with_ord()
        if args.device in EXECUTORS:
            pipe = make_pipeline(db, gi, cfg, args.device)
            t0 = time.perf_counter()
            pipe.warmup()
            stats["warmup_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            n = pipe.map_stream_all_contigs(pair_src, out, remain, conloc)
            stats["map_s"] = time.perf_counter() - t0
            fs = pipe.full_stats
            stats["full_stats"] = {**fs, "causes": dict(fs.get("causes", {}))}
            if fs["reads"]:
                hist = ", ".join(f"{k}={v}" for k, v in sorted(
                    fs.get("causes", {}).items(), key=lambda kv: -kv[1]))
                print(f"[INFO] device-full: {fs['deferred']} of "
                      f"{fs['reads']} pairs deferred to host replay"
                      f"{' (' + hist + ')' if hist else ''}",
                      file=sys.stderr)
            if pipe.wave_stats["batches"]:
                ws = pipe.wave_stats
                sv = pipe.align_svc
                print(f"[INFO] wave engine: {ws['waves']} waves over "
                      f"{ws['batches']} batch(es) "
                      f"({ws['waves'] / ws['batches']:.1f}/batch), "
                      f"{sv.n_dispatch} dispatches, {sv.n_device} device / "
                      f"{sv.n_host} host requests", file=sys.stderr)
        else:
            mappers = [
                Mapper(db, c, gi.contigs[c].codes, cfg,
                       make_host_seeder(gi.contigs[c], cfg))
                for c in range(n_contigs)
            ]
            from .pipeline.types import round_skip
            t0 = time.perf_counter()
            n = 0
            for rec1, rec2 in pair_src:
                # single-pass over the whole resident index: process the
                # read against every contig (replaces per-contig rounds);
                # the per-round skip honors scanLevel 0 AND 1 semantics
                # (circminer.cpp:386-394)
                for c, mapper in enumerate(mappers):
                    mapper.process_read_pe(rec1, rec2)
                    if round_skip(rec1.mr, rec1.seq_len, rec2.seq_len,
                                  cfg.scan_level):
                        break
                if fmt:
                    out.write_pam_pe(rec1, rec2) if fmt == "pam" else \
                        out.write_sam_pe(rec1, rec2)
                if rec1.mr.type in (CHIBSJ, CHI2BSJ):
                    remain.write(rec1, rec2, rec1.mr, conloc)
                n += 1
            stats["map_s"] = time.perf_counter() - t0
        out.close()
        remain.close()
        if n_hosts > 1:  # completion sentinel for host 0's shard wait
            with open(f"{out_prefix}_{last_round}_remain.done", "w"):
                pass
        print(f"[INFO] mapping done: {n} pairs", file=sys.stderr)

    if cfg.stage != 0:
        if n_hosts > 1:
            # circ stage runs on host 0 over every host's remain shard
            # (shared filesystem); other hosts are done after mapping
            if host_id != 0:
                return 0
            r1p = [f"{shard_output_prefix(args.output, h, n_hosts)}"
                   f"_{last_round}_remain_R1.fastq" for h in range(n_hosts)]
            r2p = [p.replace("_R1.fastq", "_R2.fastq") for p in r1p]
            import time as _t
            for h in range(n_hosts):  # wait for stragglers on shared FS
                done = (f"{shard_output_prefix(args.output, h, n_hosts)}"
                        f"_{last_round}_remain.done")
                while not os.path.exists(done):
                    _t.sleep(1.0)
        else:
            r1p = f"{args.output}_{last_round}_remain_R1.fastq"
            r2p = f"{args.output}_{last_round}_remain_R2.fastq"
        from .io.fastq import iter_sorted_remain
        t0 = time.perf_counter()
        # external chunk-sort + k-way merge by default (the reference's GNU
        # sort subprocess, process_circ.cpp:179-193); -Z sorts in memory
        recs = iter_sorted_remain(r1p, r2p, cfg,
                                  internal=cfg.internal_sort)
        pc = ProcessCirc(db, gi, cfg, args.output)
        # --device device-full also dispatches the stage-2 extension DPs
        # to the accelerator (speculate-and-select waves; chaining +
        # lattice stay host — see ProcessCirc._run_device)
        pc.run(recs, device_ext=args.device == "device-full")
        pc.report_events(args.output + ".circ_report")
        pc.write_candidates(args.output + ".candidates.pam")
        stats["call_s"] = time.perf_counter() - t0
        print(f"[INFO] circRNA detection done: "
              f"{len(pc.circ_res)} candidate reads, report at "
              f"{args.output}.circ_report", file=sys.stderr)
    return 0


def main(argv: List[str] = None, stats: Optional[dict] = None) -> int:
    """Run the CLI.  ``stats``, when given, receives the search's phase
    seconds (warmup_s, map_s, call_s) and the pipeline's full_stats."""
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if args.index:
        return run_index(args, cfg)
    from . import enable_compilation_cache
    enable_compilation_cache()
    if not args.gtf or (not args.seq and not args.seq1):
        print("error: search mode needs -g and -1/-2 (or -s)",
              file=sys.stderr)
        return 1
    return run_search(args, cfg, stats)


if __name__ == "__main__":
    sys.exit(main())
