"""Flag-honoring semantics: -t thread resolution, scanLevel round-skip,
and the -d per-read vaf trace channel.

Reference: src/commandline_parser.cpp:148-151 (thread clamp),
src/circminer.cpp:386-394 (round skip), src/common.h:520-541 +
src/filter.cpp:140-177 (vafprintf traces).
"""

import io
import os
import sys

import numpy as np
import pytest

from circminer_jax.config import Config, CONCRD, DISCRD
from circminer_jax.pipeline.types import MatchedRead, round_skip


def test_resolved_threads_clamp():
    ncpu = os.cpu_count() or 1
    assert Config(threads=1).resolved_threads == 1
    assert Config(threads=0).resolved_threads == ncpu
    assert Config(threads=ncpu + 7).resolved_threads == ncpu
    if ncpu >= 2:
        assert Config(threads=2).resolved_threads == 2


def _mr(type_=CONCRD, gm=True, ed1=0, ed2=0, ml1=100, ml2=100):
    mr = MatchedRead.default(4)
    mr.type = type_
    mr.gm_compatible = gm
    mr.ed_r1, mr.ed_r2 = ed1, ed2
    mr.mlen_r1, mr.mlen_r2 = ml1, ml2
    return mr


def test_round_skip_level0():
    assert round_skip(_mr(), 100, 100, 0)
    assert round_skip(_mr(ed1=3, ml1=90), 100, 100, 0)
    assert not round_skip(_mr(type_=DISCRD), 100, 100, 0)


def test_round_skip_level1_requires_perfect():
    # perfect full-length gm-compatible CONCRD -> skip
    assert round_skip(_mr(), 100, 100, 1)
    # any imperfection -> keep scanning later rounds
    assert not round_skip(_mr(ed1=1), 100, 100, 1)
    assert not round_skip(_mr(ml1=99), 100, 100, 1)
    assert not round_skip(_mr(gm=False), 100, 100, 1)
    assert not round_skip(_mr(type_=DISCRD), 100, 100, 1)


def test_round_skip_level2_never():
    assert not round_skip(_mr(), 100, 100, 2)


def test_vaf_trace_channel(monkeypatch, tiny_world=None):
    """-d 1 produces per-read chain + extension + decision traces."""
    from circminer_jax.utils import logging as ulog
    from circminer_jax.sim import make_genome, simulate_reads
    from circminer_jax.io.fasta import GenomePacker
    from circminer_jax.index.build import build_genome_index
    from circminer_jax.annotation.annotation import AnnotationDB
    from circminer_jax.pipeline.mapping import Mapper, ReadRecord, \
        make_host_seeder
    from circminer_jax.ops.encode import encode_seq, revcomp
    import tempfile

    rng = np.random.default_rng(7)
    g = make_genome(rng, length=60_000, n_genes=3)
    cfg = Config(kmer=20, max_read_len=120)
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "r.fa")
        gtf = os.path.join(tmp, "r.gtf")
        g.write_fasta(ref)
        g.write_gtf(gtf)
        gp = GenomePacker(ref)
        contigs, info = gp.pack_genome()
        gi = build_genome_index(contigs, cfg)
        db = AnnotationDB.from_gtf(gtf, info, len(contigs), cfg,
                                   contig_lengths=[len(c) for c in contigs])
    reads, _ = simulate_reads(rng, g, 5, 0, read_len=100, err_rate=0.0)
    mapper = Mapper(db, 0, gi.contigs[0].codes, cfg,
                    make_host_seeder(gi.contigs[0], cfg))

    buf = io.StringIO()
    monkeypatch.setattr(sys, "stderr", buf)
    ulog.set_trace_level(2)
    try:
        for r in reads:
            s1, s2 = encode_seq(r.r1), encode_seq(r.r2)
            rec1 = ReadRecord(r.name, s1, revcomp(s1), "I" * 100, 100,
                              MatchedRead.default(cfg.max_ed))
            rec2 = ReadRecord(r.name, s2, revcomp(s2), "I" * 100, 100, None)
            mapper.process_read_pe(rec1, rec2)
    finally:
        ulog.set_trace_level(0)
    out = buf.getvalue()
    assert "R1 Forward score:" in out
    assert "R2 Reverse score:" in out
    assert "frag[" in out            # level-2 fragment dump
    assert "MatePair type" in out    # pairing trace
    assert ": type " in out          # final decision trace
