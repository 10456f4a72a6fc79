"""Native filter engine vs. Python orchestration: field-exact parity.

The C++ batch_filter_pe (native/filter_kernels.cpp) must reproduce
Mapper.process_read_pe (pipeline/mapping.py) bit-for-bit on every
MatchedRead field, for linear, circular, erroneous and junk reads.
"""
import numpy as np
import pytest

from circminer_jax.config import Config, CATEGORY_NAMES
from circminer_jax.sim import make_genome, simulate_reads
from circminer_jax.io.fasta import GenomePacker
from circminer_jax.index.build import build_genome_index
from circminer_jax.annotation.annotation import AnnotationDB
from circminer_jax.pipeline.mapping import Mapper, ReadRecord
from circminer_jax.pipeline.types import MatchedRead
from circminer_jax.ops.encode import encode_seq, revcomp
from circminer_jax.ops.chain_native import NativeChainer
from circminer_jax.ops.seed_native import NativeSeeder
from circminer_jax.ops.filter_native import NativeFilter, MR_FIELDS

MR_ATTRS = ["type", "spos_r1", "epos_r1", "qspos_r1", "qepos_r1", "mlen_r1",
            "ed_r1", "r1_forward", "spos_r2", "epos_r2", "qspos_r2",
            "qepos_r2", "mlen_r2", "ed_r2", "r2_forward", "tlen", "junc_num",
            "gm_compatible", "chr_r1", "contig_num"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("nf")
    rng = np.random.default_rng(99)
    g = make_genome(rng, length=120_000, n_genes=5, exons_per_gene=5)
    ref = str(tmp / "ref.fa")
    gtf = str(tmp / "ref.gtf")
    g.write_fasta(ref)
    g.write_gtf(gtf)
    cfg = Config(kmer=20, max_read_len=120)
    gp = GenomePacker(ref)
    contigs, info = gp.pack_genome()
    gi = build_genome_index(contigs, cfg)
    db = AnnotationDB.from_gtf(gtf, info, len(contigs), cfg,
                               contig_lengths=[len(c) for c in contigs])
    return rng, g, cfg, gi, db


def run_both(setup, reads):
    """Map the read set through the Python path and the native engine;
    return (py_mrs, nat_mrs)."""
    rng, g, cfg, gi, db = setup
    ci = gi.contigs[0]
    seeder = NativeSeeder(ci, cfg)
    chainer = NativeChainer(db.contigs[0], cfg)
    nf = NativeFilter(db, 0, ci.codes, cfg)

    n = len(reads)
    L = cfg.max_read_len
    seqs = np.zeros((4 * n, L), dtype=np.int8)
    lens = np.zeros(4 * n, dtype=np.int32)
    recs = []
    for i, r in enumerate(reads):
        s1 = encode_seq(r.r1)
        s2 = encode_seq(r.r2)
        rec1 = ReadRecord(r.name, s1, revcomp(s1), "I" * len(r.r1),
                          len(r.r1), MatchedRead.default(cfg.max_ed))
        rec2 = ReadRecord(r.name, s2, revcomp(s2), "I" * len(r.r2),
                          len(r.r2), None)
        recs.append((rec1, rec2))
        for o, s in enumerate((s1, rec1.rcseq, s2, rec2.rcseq)):
            seqs[4 * i + o, :len(s)] = s
            lens[4 * i + o] = len(s)

    qpos, start, cnt, high = seeder.lookup(seqs, lens)
    cap = int(min(cnt.max() if cnt.size else 1, cfg.seed_lim)) or 1
    pos = seeder.gather(start, np.minimum(cnt, cap), cap)
    rp, qp, cl, sc, cn = chainer.chain_batch(
        pos, cnt, np.maximum(qpos, 0), lens)

    # --- Python path ---
    from circminer_jax.pipeline.mapping import make_host_seeder
    mapper = Mapper(db, 0, ci.codes, cfg, None)
    py_mrs = []
    for i, (rec1, rec2) in enumerate(recs):
        quad = []
        for o in range(4):
            r = 4 * i + o
            chains = NativeChainer.to_chains(rp[r], qp[r], cl[r], sc[r],
                                             cn[r], cfg.kmer)
            quad.append((chains, int(high[r])))
        mr = MatchedRead.default(cfg.max_ed)
        rec1.mr = mr
        mapper.process_read_pe(rec1, rec2, tuple(quad))
        py_mrs.append(mr)

    # --- native path ---
    mr_state = np.stack([
        NativeFilter.mr_to_state(MatchedRead.default(cfg.max_ed),
                                 nf.chr_names)
        for _ in range(n)
    ]).astype(np.int64)
    mr_state = np.ascontiguousarray(mr_state)
    nf.filter_pe(seqs, lens, rp, qp, cl, sc, cn, high, mr_state)
    nat_mrs = []
    for i in range(n):
        mr = MatchedRead.default(cfg.max_ed)
        NativeFilter.state_to_mr(mr_state[i], mr, nf.chr_names)
        nat_mrs.append(mr)
    return recs, py_mrs, nat_mrs


def assert_mr_equal(py, nat, name):
    for a in MR_ATTRS:
        pv, nv = getattr(py, a), getattr(nat, a)
        if a == "chr_r1" and py.type > 7:
            continue  # chr undefined for unmapped categories
        assert pv == nv, (f"{name}: field {a}: python={pv} native={nv} "
                          f"(py cat {CATEGORY_NAMES[py.type]}, "
                          f"nat cat {CATEGORY_NAMES[nat.type]})")


def test_parity_linear(setup):
    rng, g, cfg, gi, db = setup
    reads, _ = simulate_reads(rng, g, n_linear=60, n_circ=0)
    recs, py, nat = run_both(setup, reads)
    for r, p, n in zip(recs, py, nat):
        assert_mr_equal(p, n, r[0].rname)


def test_parity_circ(setup):
    rng, g, cfg, gi, db = setup
    reads, _ = simulate_reads(rng, g, n_linear=0, n_circ=60)
    recs, py, nat = run_both(setup, reads)
    for r, p, n in zip(recs, py, nat):
        assert_mr_equal(p, n, r[0].rname)


def test_parity_errors_and_junk(setup):
    rng, g, cfg, gi, db = setup
    reads, _ = simulate_reads(rng, g, n_linear=40, n_circ=20,
                              err_rate=0.02)
    # junk pairs
    import dataclasses
    for i in range(10):
        r1 = "".join(rng.choice(list("ACGT"), 100))
        r2 = "".join(rng.choice(list("ACGT"), 100))
        reads.append(dataclasses.replace(reads[0], name=f"J{i}",
                                         r1=r1, r2=r2))
    recs, py, nat = run_both(setup, reads)
    for r, p, n in zip(recs, py, nat):
        assert_mr_equal(p, n, r[0].rname)


def test_se_parity(setup):
    """Native SE vs Python process_read_se categories + positions."""
    rng, g, cfg, gi, db = setup
    ci = gi.contigs[0]
    seeder = NativeSeeder(ci, cfg)
    chainer = NativeChainer(db.contigs[0], cfg)
    nf = NativeFilter(db, 0, ci.codes, cfg)
    from circminer_jax.pipeline.mapping import make_host_seeder
    mapper = Mapper(db, 0, ci.codes, cfg, make_host_seeder(ci, cfg))

    reads, _ = simulate_reads(rng, g, n_linear=30, n_circ=0)
    n = len(reads)
    L = cfg.max_read_len
    seqs = np.zeros((2 * n, L), dtype=np.int8)
    lens = np.zeros(2 * n, dtype=np.int32)
    recs = []
    for i, r in enumerate(reads):
        s = encode_seq(r.r1)
        rec = ReadRecord(r.name, s, revcomp(s), "I" * len(r.r1), len(r.r1),
                         MatchedRead.default(cfg.max_ed))
        recs.append(rec)
        seqs[2 * i, :len(s)] = s
        seqs[2 * i + 1, :len(s)] = rec.rcseq
        lens[2 * i] = lens[2 * i + 1] = len(s)
    qpos, start, cnt, high = seeder.lookup(seqs, lens)
    cap = int(min(cnt.max() if cnt.size else 1, cfg.seed_lim)) or 1
    pos = seeder.gather(start, np.minimum(cnt, cap), cap)
    rp, qp, cl, sc, cn = chainer.chain_batch(
        pos, cnt, np.maximum(qpos, 0), lens)
    mr_state = np.stack([
        NativeFilter.mr_to_state(MatchedRead.default(cfg.max_ed),
                                 nf.chr_names) for _ in range(n)
    ]).astype(np.int64)
    mr_state = np.ascontiguousarray(mr_state)
    states = nf.filter_se(seqs, lens, rp, qp, cl, sc, cn, mr_state)
    for i, rec in enumerate(recs):
        py_state = mapper.process_read_se(rec)
        assert py_state == states[i], rec.rname
        if py_state == 0:  # CONCRD: position parity
            assert rec.mr.spos_r1 == int(mr_state[i][1]), rec.rname
