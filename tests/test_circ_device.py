"""Parity: the stage-2 DEVICE extension path (ProcessCirc._run_device —
speculate-and-select waves over find_exact_coord, alignment DPs solved as
batched device dispatches) must be bit-identical to the per-read Python
oracle: CircRes records AND candidate lines.

Runs on the CPU backend (conftest); the align kernels themselves are
pinned bit-equal to the host aligners on the real chip by
tests/test_align_device.py."""

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


@pytest.fixture(scope="module")
def bsj_stream():
    rng = np.random.default_rng(17)
    g = make_genome(rng, length=150_000, n_genes=6, dup_frac=0.05)
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
    reads, _ = simulate_reads(rng, g, 400, 500, read_len=100, err_rate=0.01)
    extra, _ = simulate_reads(rng, g, 0, 200, read_len=100,
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


def test_device_stage2_matches_oracle(bsj_stream, tmp_path):
    db, gi, cfg, bsj = bsj_stream
    assert len(bsj) > 50, "world produced too few BSJ candidates"

    pc_h = ProcessCirc(db, gi, cfg, str(tmp_path / "host"))
    pc_h.run(list(bsj), native=False)

    pc_d = ProcessCirc(db, gi, cfg, str(tmp_path / "dev"))
    pc_d.run(list(bsj), device_ext=True)

    assert [_key(c) for c in pc_d.circ_res] == \
        [_key(c) for c in pc_h.circ_res]
    assert pc_d.candid_lines == pc_h.candid_lines
    assert len(pc_h.circ_res) > 0
    # the wave phase must actually have dispatched device alignments
    assert pc_d.dev_align_stats["n_dispatch"] > 0
