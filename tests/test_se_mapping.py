"""Single-end mapping (filter.cpp:86-121) + SE SAM/PAM output."""
import numpy as np
import pytest

from circminer_jax.config import Config, CONCRD, ORPHAN
from circminer_jax.sim import make_genome, simulate_reads
from circminer_jax.io.fasta import GenomePacker
from circminer_jax.index.build import build_genome_index
from circminer_jax.annotation.annotation import AnnotationDB
from circminer_jax.pipeline.mapping import Mapper, ReadRecord, make_host_seeder
from circminer_jax.pipeline.types import MatchedRead
from circminer_jax.ops.encode import encode_seq, revcomp, decode_seq


@pytest.fixture(scope="module")
def se_pipeline(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("se")
    rng = np.random.default_rng(7)
    g = make_genome(rng, length=50_000, n_genes=3, exons_per_gene=4)
    ref = str(tmp / "ref.fa")
    gtf = str(tmp / "ref.gtf")
    g.write_fasta(ref)
    g.write_gtf(gtf)
    cfg = Config(kmer=20, max_read_len=300)
    gp = GenomePacker(ref)
    contigs, info = gp.pack_genome()
    gi = build_genome_index(contigs, cfg)
    db = AnnotationDB.from_gtf(gtf, info, len(contigs), cfg,
                               contig_lengths=[len(c) for c in contigs])
    mapper = Mapper(db, 0, gi.contigs[0].codes, cfg,
                    make_host_seeder(gi.contigs[0], cfg))
    return rng, g, cfg, mapper


def make_rec(cfg, seq: str) -> ReadRecord:
    s = encode_seq(seq)
    return ReadRecord("q", s, revcomp(s), "I" * len(seq), len(seq),
                      MatchedRead.default(cfg.max_ed))


def test_se_forward_exact(se_pipeline):
    rng, g, cfg, mapper = se_pipeline
    t = g.genes[0].transcripts[0]
    s, e = t.exons[0]
    read = g.seq[s - 1:s - 1 + 100]
    rec = make_rec(cfg, read)
    state = mapper.process_read_se(rec)
    assert state == CONCRD
    assert rec.mr.type == CONCRD
    assert rec.mr.spos_r1 == s
    assert rec.mr.r1_forward


def test_se_reverse_complement(se_pipeline):
    rng, g, cfg, mapper = se_pipeline
    t = g.genes[0].transcripts[0]
    s, e = t.exons[0]
    read = decode_seq(revcomp(encode_seq(g.seq[s - 1:s - 1 + 100])))
    rec = make_rec(cfg, read)
    state = mapper.process_read_se(rec)
    assert state == CONCRD
    assert not rec.mr.r1_forward


def test_se_junk_orphan(se_pipeline):
    rng, g, cfg, mapper = se_pipeline
    read = "".join(rng.choice(list("ACGT"), 100))
    rec = make_rec(cfg, read)
    state = mapper.process_read_se(rec)
    assert state >= CONCRD  # random read: anything but a guaranteed map
    if state != CONCRD:
        assert rec.mr.type != CONCRD


def test_se_batch_accuracy(se_pipeline):
    rng, g, cfg, mapper = se_pipeline
    reads, _ = simulate_reads(rng, g, n_linear=20, n_circ=0)
    n_ok = 0
    for r in reads:
        rec = make_rec(cfg, r.r1)
        if mapper.process_read_se(rec) == CONCRD:
            n_ok += 1
    assert n_ok >= 18


def test_se_cli(tmp_path):
    """SE mode through the CLI surface: -s only, SAM output."""
    rng = np.random.default_rng(11)
    g = make_genome(rng, length=30_000, n_genes=2)
    ref = str(tmp_path / "ref.fa")
    gtf = str(tmp_path / "ref.gtf")
    g.write_fasta(ref)
    g.write_gtf(gtf)
    reads, _ = simulate_reads(rng, g, n_linear=10, n_circ=0)
    fq = str(tmp_path / "R.fq")
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r.r1}\n+\n{'I' * len(r.r1)}\n")
    from circminer_jax.cli import main
    assert main(["--index", "-r", ref, "-k", "20"]) == 0
    out = str(tmp_path / "out")
    assert main(["-r", ref, "-g", gtf, "-s", fq, "-o", out, "--sam"]) == 0
    lines = [l for l in open(out + ".mapping.sam")
             if not l.startswith("@")]
    assert len(lines) == 10
    mapped = [l for l in lines if l.split("\t")[2] != "*"]
    assert len(mapped) >= 8
    # SAM columns sane: flag int, pos int
    for l in mapped:
        f = l.split("\t")
        int(f[1]); int(f[3])


def test_se_batched_pipeline_parity(se_pipeline, tmp_path):
    """The batched SE pipeline (device_pipeline.map_stream_se, native C++
    finish) produces the same per-read state as the per-read oracle."""
    rng, g, cfg, _ = se_pipeline
    ref = None
    # rebuild the same world (module fixture keeps only mapper)
    gp_tmp = tmp_path
    refp = str(gp_tmp / "ref.fa")
    gtfp = str(gp_tmp / "ref.gtf")
    g.write_fasta(refp)
    g.write_gtf(gtfp)
    gp = GenomePacker(refp)
    contigs, info = gp.pack_genome()
    gi = build_genome_index(contigs, cfg)
    db = AnnotationDB.from_gtf(gtfp, info, len(contigs), cfg,
                               contig_lengths=[len(c) for c in contigs])

    reads, _ = simulate_reads(rng, g, n_linear=30, n_circ=0)
    seqs = [r.r1 for r in reads]
    seqs.append("".join(rng.choice(list("ACGT"), 100)))  # a junk read
    t = g.genes[0].transcripts[0]
    s, e = t.exons[0]
    seqs.append(decode_seq(revcomp(encode_seq(g.seq[s - 1:s - 1 + 100]))))

    recs_a = [make_rec(cfg, s_) for s_ in seqs]
    recs_b = [make_rec(cfg, s_) for s_ in seqs]

    mapper = Mapper(db, 0, gi.contigs[0].codes, cfg,
                    make_host_seeder(gi.contigs[0], cfg))
    for rec in recs_a:
        mapper.process_read_se(rec)

    from circminer_jax.pipeline.device_pipeline import DeviceMappingPipeline
    pipe = DeviceMappingPipeline(db, gi, cfg, batch_size=16,
                                 chain_exec="native")
    n = pipe.map_stream_se(iter(recs_b))
    assert n == len(seqs)

    for ra, rb in zip(recs_a, recs_b):
        assert rb.mr.type == ra.mr.type
        if ra.mr.type == CONCRD:
            assert (rb.mr.spos_r1, rb.mr.epos_r1, rb.mr.ed_r1,
                    rb.mr.r1_forward) == \
                   (ra.mr.spos_r1, ra.mr.epos_r1, ra.mr.ed_r1,
                    ra.mr.r1_forward)
