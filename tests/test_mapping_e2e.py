"""End-to-end mapping: synthetic genome -> index -> PE mapping categories."""
import numpy as np
import pytest

from circminer_jax.config import (Config, CONCRD, CHIBSJ, CHI2BSJ,
                                  CATEGORY_NAMES)
from circminer_jax.sim import make_genome, simulate_reads
from circminer_jax.io.fasta import GenomePacker
from circminer_jax.index.build import build_genome_index
from circminer_jax.annotation.annotation import AnnotationDB
from circminer_jax.pipeline.mapping import Mapper, ReadRecord, make_host_seeder
from circminer_jax.pipeline.types import MatchedRead
from circminer_jax.ops.encode import encode_seq, revcomp


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("e2e")
    rng = np.random.default_rng(123)
    g = make_genome(rng, length=60_000, n_genes=3, exons_per_gene=5)
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
    seeder = make_host_seeder(gi.contigs[0], cfg)
    mapper = Mapper(db, 0, gi.contigs[0].codes, cfg, seeder)
    return rng, g, cfg, mapper


def run_pair(mapper, cfg, r1: str, r2: str) -> MatchedRead:
    s1 = encode_seq(r1)
    s2 = encode_seq(r2)
    rec1 = ReadRecord("q", s1, revcomp(s1), "I" * len(r1), len(r1),
                      MatchedRead.default(cfg.max_ed))
    rec2 = ReadRecord("q", s2, revcomp(s2), "I" * len(r2), len(r2), None)
    mapper.process_read_pe(rec1, rec2)
    return rec1.mr


def test_linear_reads_concordant(pipeline):
    rng, g, cfg, mapper = pipeline
    reads, _ = simulate_reads(rng, g, n_linear=30, n_circ=0)
    cats = [run_pair(mapper, cfg, r.r1, r.r2).type for r in reads]
    n_conc = sum(1 for c in cats if c == CONCRD)
    # error-free transcriptomic fragments must map concordantly
    assert n_conc >= 28, [CATEGORY_NAMES[c] for c in cats]


def test_circ_reads_flagged_bsj(pipeline):
    rng, g, cfg, mapper = pipeline
    reads, truth = simulate_reads(rng, g, n_linear=0, n_circ=40)
    crossing = [r for r in reads if r.truth == "circ"]
    assert len(crossing) >= 5
    cats = [run_pair(mapper, cfg, r.r1, r.r2).type for r in crossing]
    n_bsj = sum(1 for c in cats if c in (CHIBSJ, CHI2BSJ))
    assert n_bsj >= int(0.7 * len(crossing)), \
        [CATEGORY_NAMES[c] for c in cats]


def test_mapping_positions_linear(pipeline):
    """Concordant mappings land on true transcript coordinates."""
    rng, g, cfg, mapper = pipeline
    t = g.genes[0].transcripts[0]
    # exact read fully inside exon 2
    s, e = t.exons[1]
    frag = g.seq[s - 1:s - 1 + 200]
    r1 = frag[:100]
    from circminer_jax.ops.encode import decode_seq
    r2 = decode_seq(revcomp(encode_seq(frag[-100:])))
    mr = run_pair(mapper, cfg, r1, r2)
    assert mr.type == CONCRD
    assert mr.spos_r1 == s
    assert mr.epos_r1 == s + 99
    assert mr.chr_r1 == "chr1"


def test_junction_read_concordant(pipeline):
    """A read spanning two exons of a transcript maps CONCRD with the
    spliced tlen."""
    rng, g, cfg, mapper = pipeline
    t = g.genes[0].transcripts[0]
    from circminer_jax.sim import transcript_seq
    ts = transcript_seq(g, t)
    # fragment centered on the junction between exon 1 and 2
    e1_len = t.exons[0][1] - t.exons[0][0] + 1
    start = max(0, e1_len - 60)
    frag = ts[start:start + 200]
    from circminer_jax.ops.encode import decode_seq
    r1 = frag[:100]
    r2 = decode_seq(revcomp(encode_seq(frag[-100:])))
    mr = run_pair(mapper, cfg, r1, r2)
    assert mr.type == CONCRD
    assert mr.gm_compatible
