"""Wave-batched extension (extend_exec="device") vs the sequential paths.

The lockstep wave scheduler must produce byte-identical MatchedRead state
to both the per-read inline python path and the native C++ finish engine —
only the interleaving of alignments across reads differs."""

import numpy as np

from circminer_jax.config import Config, CATEGORY_NAMES
from circminer_jax.sim import make_genome, simulate_reads
from circminer_jax.io.fasta import GenomePacker
from circminer_jax.index.build import build_genome_index
from circminer_jax.annotation.annotation import AnnotationDB
from circminer_jax.pipeline.device_pipeline import DeviceMappingPipeline
from circminer_jax.pipeline.mapping import ReadRecord
from circminer_jax.pipeline.types import MatchedRead
from circminer_jax.ops.encode import encode_seq, revcomp


def make_rec(r1, r2, cfg):
    s1, s2 = encode_seq(r1), encode_seq(r2)
    return (ReadRecord("q", s1, revcomp(s1), "I" * len(r1), len(r1),
                       MatchedRead.default(cfg.max_ed)),
            ReadRecord("q", s2, revcomp(s2), "I" * len(r2), len(r2), None))


def _key(mr):
    return (mr.type, mr.chr_r1, mr.spos_r1, mr.epos_r1, mr.qspos_r1,
            mr.qepos_r1, mr.mlen_r1, mr.ed_r1, mr.chr_r2, mr.spos_r2,
            mr.epos_r2, mr.qspos_r2, mr.qepos_r2, mr.mlen_r2, mr.ed_r2,
            mr.tlen, mr.junc_num, mr.gm_compatible, mr.r1_forward)


def test_wave_extension_matches_native(tmp_path):
    rng = np.random.default_rng(23)
    g = make_genome(rng, length=60_000, n_genes=4)
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
    reads, _ = simulate_reads(rng, g, 40, 40, err_rate=0.01)

    res = {}
    waves = {}
    for ext_exec in ("native", "device"):
        pipe = DeviceMappingPipeline(db, gi, cfg, batch_size=64,
                                     chain_exec="native",
                                     extend_exec=ext_exec)
        pairs = [make_rec(r.r1, r.r2, cfg) for r in reads]
        pipe.map_stream(iter(pairs))
        res[ext_exec] = [p[0].mr for p in pairs]
        if pipe.align_svc is not None:
            waves[ext_exec] = (pipe.align_svc.n_device,
                               pipe.align_svc.n_host,
                               pipe.align_svc.n_dispatch)

    mismatches = []
    for i, (h, d) in enumerate(zip(res["native"], res["device"])):
        if _key(h) != _key(d):
            mismatches.append((i, CATEGORY_NAMES[h.type],
                               CATEGORY_NAMES[d.type], _key(h), _key(d)))
    assert not mismatches, mismatches[:5]
    # the device path must have actually batched alignments onto the device
    n_dev, n_host, n_disp = waves["device"]
    assert n_dev > 0
    assert n_disp > 0
    # batching efficiency: far fewer dispatches than device-solved requests
    assert n_disp < max(2, n_dev // 4 + 8)
