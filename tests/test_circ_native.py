"""Parity: the batched native stage-2 engine (native/circ_kernels.cpp via
ops/circ_native.py) must be bit-identical to the per-read Python oracle
(pipeline/circ.py) — CircRes records AND candidate lines."""

import os
import tempfile

import numpy as np
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
from circminer_jax.ops.encode import encode_seq, revcomp
from circminer_jax.ops import circ_native


@pytest.fixture(scope="module")
def bsj_stream():
    rng = np.random.default_rng(42)
    g = make_genome(rng, length=300_000, n_genes=8, dup_frac=0.05)
    cfg = Config(kmer=20, max_read_len=120, threads=0)
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
    reads, _ = simulate_reads(rng, g, 1200, 800, read_len=100,
                              err_rate=0.01)
    # short fragments place the junction inside BOTH mates -> CHI2BSJ
    # reads, covering the double-split / overlap-BSJ / rescue C++ paths
    extra, _ = simulate_reads(rng, g, 0, 600, read_len=100,
                              frag_len=(115, 165), err_rate=0.01)
    reads = reads + extra
    pairs = []
    for r in reads:
        s1, s2 = encode_seq(r.r1), encode_seq(r.r2)
        pairs.append(
            (ReadRecord(r.name, s1, revcomp(s1), "I" * len(r.r1),
                        len(r.r1), MatchedRead.default(cfg.max_ed)),
             ReadRecord(r.name, s2, revcomp(s2), "I" * len(r.r2),
                        len(r.r2), None)))
    pipe = DeviceMappingPipeline(db, gi, cfg, batch_size=2048,
                                 chain_exec="native")
    pipe.warmup()
    pipe.map_stream(iter(pairs))
    bsj = [(r1, r2) for r1, r2 in pairs
           if r1.mr.type in (CHIBSJ, CHI2BSJ)]
    for r1, _ in bsj:
        r1.mr.genome_spos = r1.mr.spos_r1
    bsj.sort(key=lambda pr: pr[0].mr.genome_spos)
    return db, gi, cfg, bsj


def _key(c):
    return (c.chr, c.rname, c.spos, c.epos, c.type, c.start_signal,
            c.end_signal, c.start_bp_ref, c.end_bp_ref)


def test_native_circ_matches_oracle(bsj_stream):
    db, gi, cfg, bsj = bsj_stream
    assert len(bsj) > 50, "stream too small to be a meaningful pin"
    n_double = sum(1 for r1, _ in bsj if r1.mr.type == CHI2BSJ)
    assert n_double > 5, "no double-split reads — CHI2BSJ paths unpinned"

    pc_py = ProcessCirc(db, gi, cfg, "/tmp/circ_py")
    pc_py.run(bsj, native=False)
    pc_nt = ProcessCirc(db, gi, cfg, "/tmp/circ_nt")
    pc_nt.run(bsj, native=True)

    assert [_key(c) for c in pc_nt.circ_res] == \
        [_key(c) for c in pc_py.circ_res]
    assert pc_nt.candid_lines == pc_py.candid_lines
    assert len(pc_nt.circ_res) > 10


def test_native_circ_single_thread_order(bsj_stream):
    """Record order must be read-stream order regardless of thread count."""
    db, gi, cfg, bsj = bsj_stream
    import dataclasses
    cfg1 = dataclasses.replace(cfg, threads=1)
    pc1 = ProcessCirc(db, gi, cfg1, "/tmp/circ_t1")
    pc1.run(bsj, native=True)
    pc2 = ProcessCirc(db, gi, cfg, "/tmp/circ_tN")
    pc2.run(bsj, native=True)
    assert [_key(c) for c in pc1.circ_res] == [_key(c) for c in pc2.circ_res]
    assert pc1.candid_lines == pc2.candid_lines
