"""Device (batched) mapping pipeline vs host pipeline equivalence."""
import numpy as np
import pytest

from circminer_jax.config import Config, CATEGORY_NAMES
from circminer_jax.sim import make_genome, simulate_reads
from circminer_jax.io.fasta import GenomePacker
from circminer_jax.index.build import build_genome_index
from circminer_jax.annotation.annotation import AnnotationDB
from circminer_jax.pipeline.mapping import Mapper, ReadRecord, make_host_seeder
from circminer_jax.pipeline.device_pipeline import DeviceMappingPipeline
from circminer_jax.pipeline.types import MatchedRead
from circminer_jax.ops.encode import encode_seq, revcomp


def make_rec(r1, r2, cfg):
    s1, s2 = encode_seq(r1), encode_seq(r2)
    return (ReadRecord("q", s1, revcomp(s1), "I" * len(r1), len(r1),
                       MatchedRead.default(cfg.max_ed)),
            ReadRecord("q", s2, revcomp(s2), "I" * len(r2), len(r2), None))


def test_device_pipeline_matches_host(tmp_path):
    rng = np.random.default_rng(7)
    g = make_genome(rng, length=50_000, n_genes=3)
    ref = str(tmp_path / "ref.fa")
    gtf = str(tmp_path / "ref.gtf")
    g.write_fasta(ref)
    g.write_gtf(gtf)
    cfg = Config(kmer=20, max_read_len=100)
    gp = GenomePacker(ref)
    contigs, info = gp.pack_genome()
    gi = build_genome_index(contigs, cfg)
    db = AnnotationDB.from_gtf(gtf, info, 1, cfg,
                               contig_lengths=[len(c) for c in contigs])

    reads, _ = simulate_reads(rng, g, 25, 25)

    host_mapper = Mapper(db, 0, gi.contigs[0].codes, cfg,
                         make_host_seeder(gi.contigs[0], cfg))
    pipe = DeviceMappingPipeline(db, gi, cfg, batch_size=64)

    host_res = []
    for r in reads:
        rec1, rec2 = make_rec(r.r1, r.r2, cfg)
        host_mapper.process_read_pe(rec1, rec2)
        host_res.append(rec1.mr)

    dev_pairs = [make_rec(r.r1, r.r2, cfg) for r in reads]
    pipe.map_stream(iter(dev_pairs))
    dev_res = [p[0].mr for p in dev_pairs]

    mismatches = []
    for i, (h, d) in enumerate(zip(host_res, dev_res)):
        if (h.type, h.spos_r1, h.epos_r1, h.spos_r2, h.epos_r2,
                h.ed_r1, h.ed_r2, h.tlen) != \
                (d.type, d.spos_r1, d.epos_r1, d.spos_r2, d.epos_r2,
                 d.ed_r1, d.ed_r2, d.tlen):
            mismatches.append(
                (i, CATEGORY_NAMES[h.type], CATEGORY_NAMES[d.type],
                 (h.spos_r1, d.spos_r1)))
    assert not mismatches, mismatches


def test_device_chain_exec_matches_native(tmp_path):
    """The jax chain-DP executor and the native C++ executor agree on final
    read states (same genome/read set, both against the host oracle rules)."""
    rng = np.random.default_rng(13)
    g = make_genome(rng, length=50_000, n_genes=3)
    ref = str(tmp_path / "ref.fa")
    gtf = str(tmp_path / "ref.gtf")
    g.write_fasta(ref)
    g.write_gtf(gtf)
    cfg = Config(kmer=20, max_read_len=100)
    gp = GenomePacker(ref)
    contigs, info = gp.pack_genome()
    gi = build_genome_index(contigs, cfg)
    db = AnnotationDB.from_gtf(gtf, info, 1, cfg,
                               contig_lengths=[len(c) for c in contigs])
    reads, _ = simulate_reads(rng, g, 20, 20)

    res = {}
    for exec_ in ("native", "device"):
        pipe = DeviceMappingPipeline(db, gi, cfg, batch_size=64,
                                     chain_exec=exec_)
        pairs = [make_rec(r.r1, r.r2, cfg) for r in reads]
        pipe.map_stream(iter(pairs))
        res[exec_] = [p[0].mr for p in pairs]

    mismatches = []
    for i, (h, d) in enumerate(zip(res["native"], res["device"])):
        if (h.type, h.spos_r1, h.epos_r1, h.ed_r1, h.tlen) != \
                (d.type, d.spos_r1, d.epos_r1, d.ed_r1, d.tlen):
            mismatches.append((i, CATEGORY_NAMES[h.type],
                               CATEGORY_NAMES[d.type]))
    assert not mismatches, mismatches
