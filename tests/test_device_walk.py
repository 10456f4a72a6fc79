"""Device multi-exon extension walk engine (ops/device_walk.py).

Pins the walk engine against the host native pipeline bit-for-bit on an
Ensembl-density annotation (many isoforms, jittered exon boundaries ->
fragmented disjoint intervals, small exons -> multi-flush walks), and
verifies the budget-starved engine defers (host replay) instead of
diverging.
"""
import numpy as np
import pytest

from circminer_jax.config import Config
from circminer_jax.sim import make_genome, simulate_reads
from circminer_jax.io.fasta import GenomePacker
from circminer_jax.index.build import build_genome_index
from circminer_jax.annotation.annotation import AnnotationDB
from circminer_jax.pipeline.device_pipeline import DeviceMappingPipeline

from test_device_full import make_pairs, FIELDS


@pytest.fixture(scope="module")
def dense_lib():
    rng = np.random.default_rng(11)
    # small exons force >= 2 middle flushes inside a 100 bp remain
    # window; 6 isoforms with 25 bp boundary jitter fragment intervals
    g = make_genome(rng, length=150_000, n_genes=8, exons_per_gene=7,
                    exon_len=(45, 130), intron_len=(120, 500),
                    n_isoforms=6, bnd_jitter=25)
    import tempfile, os
    d = tempfile.mkdtemp()
    ref, gtf = os.path.join(d, "ref.fa"), os.path.join(d, "ref.gtf")
    g.write_fasta(ref)
    g.write_gtf(gtf)
    cfg = Config(kmer=20, max_read_len=100)
    gp = GenomePacker(ref)
    contigs, info = gp.pack_genome()
    gi = build_genome_index(contigs, cfg)
    db = AnnotationDB.from_gtf(gtf, info, 1, cfg,
                               contig_lengths=[len(c) for c in contigs])
    reads, _ = simulate_reads(rng, g, 220, 110, read_len=100,
                              err_rate=0.01)
    return g, cfg, gi, db, reads


def _run(db, gi, cfg, reads, exec_, statics_patch=None):
    pairs = make_pairs(reads, cfg)
    pipe = DeviceMappingPipeline(db, gi, cfg, batch_size=128,
                                 chain_exec=exec_)
    if statics_patch:
        orig = pipe._full_statics

        def patched():
            d = orig()
            d.update(statics_patch)
            return d

        pipe._full_statics = patched
    if exec_ == "device-full":
        pipe.warmup()
    pipe.map_stream(iter(pairs))
    return pairs, pipe


def _assert_parity(pairs_a, pairs_b):
    bad = []
    for (a1, _), (b1, _) in zip(pairs_a, pairs_b):
        for f in FIELDS:
            if getattr(a1.mr, f) != getattr(b1.mr, f):
                bad.append((a1.rname, f, getattr(a1.mr, f),
                            getattr(b1.mr, f)))
    assert not bad, bad[:10]


def test_walk_dense_annotation(dense_lib):
    """Fragmented-interval walks finish on device, bit-equal to native;
    the extwalk cause must be (near-)erased by the engine."""
    g, cfg, gi, db, reads = dense_lib
    pairs_n, _ = _run(db, gi, cfg, reads, "native")
    pairs_f, pf = _run(db, gi, cfg, reads, "device-full")
    _assert_parity(pairs_n, pairs_f)
    n = pf.full_stats["reads"]
    causes = pf.full_stats.get("causes", {})
    # the engine must clear the regime it was built for: residual walk
    # defers (budget overflows) stay under 5% of reads on this mix
    assert causes.get("extwalk", 0) <= 0.05 * n, causes


def test_walk_budget_starved_defers(dense_lib):
    """A starved engine (1 wave, 2-interval scans) must DEFER the walks
    it cannot finish — outputs stay bit-equal through host replay."""
    g, cfg, gi, db, reads = dense_lib
    pairs_n, _ = _run(db, gi, cfg, reads, "native")
    pairs_f, pf = _run(db, gi, cfg, reads, "device-full",
                       statics_patch=dict(EW=1, KSCAN=2))
    _assert_parity(pairs_n, pairs_f)
    causes = pf.full_stats.get("causes", {})
    assert causes.get("extwalk", 0) > 0, \
        "starved engine should defer multi-exon walks"


def test_walk_many_isoforms_tid_overflow_exact():
    """More common transcripts than the packed STW=8 tid lanes: affected
    pairs must defer (host replay), never silently truncate — outputs
    stay bit-equal to native."""
    rng = np.random.default_rng(23)
    g = make_genome(rng, length=60_000, n_genes=3, exons_per_gene=6,
                    exon_len=(60, 150), intron_len=(150, 400),
                    n_isoforms=12, bnd_jitter=10)
    import tempfile, os
    d = tempfile.mkdtemp()
    ref, gtf = os.path.join(d, "ref.fa"), os.path.join(d, "ref.gtf")
    g.write_fasta(ref)
    g.write_gtf(gtf)
    cfg = Config(kmer=20, max_read_len=100)
    gp = GenomePacker(ref)
    contigs, info = gp.pack_genome()
    gi = build_genome_index(contigs, cfg)
    db = AnnotationDB.from_gtf(gtf, info, 1, cfg,
                               contig_lengths=[len(c) for c in contigs])
    reads, _ = simulate_reads(rng, g, 120, 60, read_len=100,
                              err_rate=0.005)
    pairs_n, _ = _run(db, gi, cfg, reads, "native")
    pairs_f, _ = _run(db, gi, cfg, reads, "device-full")
    _assert_parity(pairs_n, pairs_f)
