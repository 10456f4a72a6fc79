"""Bounded-memory streaming: external remain-sort and multi-contig rounds."""

import os

import numpy as np
import pytest

from circminer_jax.config import Config, CHIBSJ, CONCRD
from circminer_jax.io.fastq import (FastqReader, RemainWriter,
                                    iter_sorted_remain, read_pairs)
from circminer_jax.pipeline.mapping import ReadRecord
from circminer_jax.pipeline.types import MatchedRead
from circminer_jax.ops.encode import encode_seq, revcomp


def _mk_pair(name, seq, mr):
    codes = encode_seq(seq)
    return (ReadRecord(name, codes, revcomp(codes), "I" * len(seq),
                       len(seq), mr),
            ReadRecord(name, codes, revcomp(codes), "I" * len(seq),
                       len(seq), None))


def _write_remain(tmp_path, n, cfg, rng):
    w = RemainWriter(str(tmp_path / "t"), 9)
    names = []
    for i in range(n):
        mr = MatchedRead.default(cfg.max_ed)
        mr.type = CHIBSJ
        mr.chr_r1 = mr.chr_r2 = "chr1"
        mr.spos_r1 = int(rng.integers(1, 10 ** 6))
        mr.epos_r1 = mr.spos_r1 + 50
        mr.genome_spos = mr.spos_r1
        mr.contig_num = 0
        mr.touched = True
        seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 40))
        r1, r2 = _mk_pair(f"q{i}", seq, mr)
        w.write(r1, r2, mr)
        names.append((f"q{i}", mr.genome_spos))
    w.close()
    return w.p1, w.p2, names


@pytest.mark.parametrize("internal", [True, False])
def test_iter_sorted_remain_orders_by_genome_spos(tmp_path, internal):
    cfg = Config(kmer=20, max_read_len=100)
    rng = np.random.default_rng(3)
    p1, p2, names = _write_remain(tmp_path, 500, cfg, rng)
    # tiny chunks force multi-chunk spill + k-way merge on the external path
    got = list(iter_sorted_remain(p1, p2, cfg, internal=internal,
                                  chunk_pairs=64))
    keys = [r1.mr.genome_spos for r1, _ in got]
    assert keys == sorted(keys)
    assert len(got) == 500
    # same multiset of reads either way
    assert sorted(r1.rname for r1, _ in got) == \
        sorted(n for n, _ in names)


def test_external_equals_internal(tmp_path):
    cfg = Config(kmer=20, max_read_len=100)
    rng = np.random.default_rng(4)
    p1, p2, _ = _write_remain(tmp_path, 300, cfg, rng)
    int_recs = [(r1.rname, r1.mr.genome_spos, r1.mr.spos_r1)
                for r1, _ in iter_sorted_remain(p1, p2, cfg, internal=True)]
    ext_recs = [(r1.rname, r1.mr.genome_spos, r1.mr.spos_r1)
                for r1, _ in iter_sorted_remain(p1, p2, cfg, internal=False,
                                                chunk_pairs=37)]
    # genome_spos keys identical and sorted; spos preserved through re-spill
    assert [k[1] for k in int_recs] == [k[1] for k in ext_recs]
    assert sorted(int_recs) == sorted(ext_recs)


def test_multi_contig_streaming_matches_materialized(tmp_path):
    """Streamed round-carry over 2 contigs == the per-contig passes over an
    in-memory pair list."""
    from circminer_jax.sim import make_genome, simulate_reads
    from circminer_jax.io.fasta import GenomePacker
    from circminer_jax.index.build import build_genome_index
    from circminer_jax.annotation.annotation import AnnotationDB
    from circminer_jax.pipeline.device_pipeline import DeviceMappingPipeline

    rng = np.random.default_rng(11)
    g = make_genome(rng, length=30_000, n_genes=2, chrom="chr1")
    g2 = make_genome(rng, length=30_000, n_genes=2, chrom="chr2")
    ref = str(tmp_path / "ref.fa")
    gtf = str(tmp_path / "ref.gtf")
    g.write_fasta(ref)
    g.write_gtf(gtf)
    with open(ref, "a") as f, open(str(tmp_path / "c2.fa"), "w") as _:
        g2.write_fasta(str(tmp_path / "c2.fa"))
        f.write(open(str(tmp_path / "c2.fa")).read())
    with open(gtf, "a") as f:
        g2.write_gtf(str(tmp_path / "c2.gtf"))
        f.write(open(str(tmp_path / "c2.gtf")).read())
    cfg = Config(kmer=20, max_read_len=100)
    # force a 2-contig packing by shrinking the contig budget so each
    # chromosome lands in its own contig
    gp = GenomePacker(ref, contig_size=35_000)
    contigs, info = gp.pack_genome()
    assert len(contigs) >= 2
    gi = build_genome_index(contigs, cfg)
    db = AnnotationDB.from_gtf(gtf, info, len(contigs), cfg,
                               contig_lengths=[len(c) for c in contigs])

    reads1, _ = simulate_reads(rng, g, 20, 6)
    reads2, _ = simulate_reads(rng, g2, 20, 6)
    for i, r in enumerate(reads2):  # unique names across chromosomes
        r.name = r.name + "b"
    reads = reads1 + reads2

    def mk(r):
        s1, s2 = encode_seq(r.r1), encode_seq(r.r2)
        return (ReadRecord(r.name, s1, revcomp(s1), "I" * len(r.r1),
                           len(r.r1), MatchedRead.default(cfg.max_ed)),
                ReadRecord(r.name, s2, revcomp(s2), "I" * len(r.r2),
                           len(r.r2), None))

    # materialized: one pass per contig over an in-RAM list
    mat_pairs = [mk(r) for r in reads]
    pipe = DeviceMappingPipeline(db, gi, cfg, batch_size=16)
    for c in range(len(contigs)):
        todo = [pr for pr in mat_pairs if pr[0].mr.type != CONCRD] \
            if c > 0 else mat_pairs
        if todo:
            pipe.map_stream(iter(todo), contig=c)
    want = {pr[0].rname: (pr[0].mr.type, pr[0].mr.chr_r1, pr[0].mr.spos_r1,
                          pr[0].mr.epos_r1) for pr in mat_pairs}

    # streamed: disk-carried rounds
    str_pairs = [mk(r) for r in reads]
    emitted = {}
    pipe2 = DeviceMappingPipeline(db, gi, cfg, batch_size=16)

    class _Sink:
        fmt = "pam"

        def write_pam_pe(self, r1, r2):
            emitted[r1.rname] = (r1.mr.type, r1.mr.chr_r1, r1.mr.spos_r1,
                                 r1.mr.epos_r1)

        def write_sam_pe(self, r1, r2):
            self.write_pam_pe(r1, r2)

    n = pipe2.map_stream_all_contigs(
        iter(str_pairs), out=_Sink(), remain=None, conloc=None,
        workdir=str(tmp_path / "rounds"))
    assert n == len(reads)
    assert emitted == want
