"""device-full fused executor == host native pipeline, bit-exact.

Every read is either finished on device (defer bit 0) or replayed through
the host path; both must leave identical MatchedRead state.  The test
compares the device-full pipeline against the pure native pipeline on the
same simulated library (linear + circular + junk reads).
"""
import numpy as np
import pytest

from circminer_jax.config import Config, CATEGORY_NAMES
from circminer_jax.sim import make_genome, simulate_reads
from circminer_jax.io.fasta import GenomePacker
from circminer_jax.index.build import build_genome_index
from circminer_jax.annotation.annotation import AnnotationDB
from circminer_jax.pipeline.device_pipeline import DeviceMappingPipeline
from circminer_jax.pipeline.mapping import ReadRecord
from circminer_jax.pipeline.types import MatchedRead
from circminer_jax.ops.encode import encode_seq, revcomp

FIELDS = ("type", "spos_r1", "epos_r1", "qspos_r1", "qepos_r1", "mlen_r1",
          "ed_r1", "r1_forward", "spos_r2", "epos_r2", "qspos_r2",
          "qepos_r2", "mlen_r2", "ed_r2", "r2_forward", "tlen", "junc_num",
          "gm_compatible", "chr_r1", "contig_num")


def make_pairs(reads, cfg):
    out = []
    for r in reads:
        s1, s2 = encode_seq(r.r1), encode_seq(r.r2)
        out.append((ReadRecord(r.name, s1, revcomp(s1), "I" * len(r.r1),
                               len(r.r1), MatchedRead.default(cfg.max_ed)),
                    ReadRecord(r.name, s2, revcomp(s2), "I" * len(r.r2),
                               len(r.r2), None)))
    return out


@pytest.mark.parametrize("err", [0.0, 0.01])
def test_device_full_matches_native(tmp_path, err):
    rng = np.random.default_rng(int(err * 1000) + 3)
    g = make_genome(rng, length=80_000, n_genes=4)
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
    reads, _ = simulate_reads(rng, g, 60, 30, read_len=100, err_rate=err)
    # junk reads exercise the NOPROC/OEA paths
    junk = []
    for i in range(8):
        s = "".join(rng.choice(list("ACGT"), 100))
        junk.append(type(reads[0])(f"junk{i}", s,
                                   reads[0].r2 if i % 2 else
                                   "".join(rng.choice(list("ACGT"), 100)),
                                   None, None))

    pairs_a = make_pairs(reads, cfg) + make_pairs(junk, cfg)
    pairs_b = make_pairs(reads, cfg) + make_pairs(junk, cfg)

    pn = DeviceMappingPipeline(db, gi, cfg, batch_size=64,
                               chain_exec="native")
    pn.map_stream(iter(pairs_a))

    pf = DeviceMappingPipeline(db, gi, cfg, batch_size=64,
                               chain_exec="device-full")
    pf.warmup()
    pf.map_stream(iter(pairs_b))

    n_def = pf.full_stats["deferred"]
    n_tot = pf.full_stats["reads"]
    bad = 0
    for (a1, _), (b1, _) in zip(pairs_a, pairs_b):
        for f in FIELDS:
            va, vb = getattr(a1.mr, f), getattr(b1.mr, f)
            if va != vb:
                bad += 1
                print(f"{a1.rname}: {f} native={va} full={vb} "
                      f"(type {CATEGORY_NAMES[a1.mr.type]} vs "
                      f"{CATEGORY_NAMES[b1.mr.type]})")
                break
    assert bad == 0, f"{bad} mismatching reads (deferred {n_def}/{n_tot})"
    # the device must genuinely handle most of the batch
    assert n_def < 0.5 * n_tot, f"deferred {n_def}/{n_tot}"


@pytest.mark.parametrize("seg_compact", [False, True])
def test_seg_compact_reaches_chain_prelude(monkeypatch, seg_compact):
    """device_full_step forwards its seg_compact static down to the chain
    DP's prelude, where the wide/slim seg-table choice is made."""
    import jax
    import jax.numpy as jnp
    from __graft_entry__ import _tiny_problem
    from circminer_jax.ops import chain as chain_mod
    from circminer_jax.ops.align import ScoreMat
    from circminer_jax.ops.device_full import device_full_step
    from circminer_jax.ops.filter_native import NativeFilter
    from circminer_jax.annotation.device import FinishAnnoDevice

    seen = []
    real = chain_mod._chain_prelude

    def spy(*a, **kw):
        seen.append(kw["seg_compact"])
        return real(*a, **kw)

    monkeypatch.setattr(chain_mod, "_chain_prelude", spy)
    jax.clear_caches()      # retrace: the jitted callers cache the prelude
    cfg, ci, ad, reads, lens, db = _tiny_problem(1)
    fa = FinishAnnoDevice.from_contig(db.contigs[0], db.con2chr[0],
                                      seg_pad=4)
    sm = ScoreMat()
    B = reads.shape[0] // 4
    mr_in = np.tile(NativeFilter.mr_to_state(MatchedRead.default(cfg.max_ed),
                                             ["chr1"]), (B, 1))
    out = jax.eval_shape(
        lambda s, l, m: device_full_step(
            s, l, m, jnp.asarray(ci.entry_hv),
            jnp.asarray(ci.entry_checksum), jnp.asarray(ci.entry_pos),
            jnp.asarray(ci.codes), ad, fa, None, contig_num=0,
            k=cfg.kmer, cs_len=cfg.checksum_len, n_slots=cfg.max_seg_cnt,
            seed_lim=cfg.seed_lim, cap=16, max_ed=cfg.max_ed,
            max_sc=cfg.max_sc, band=cfg.band_width, max_tlen=cfg.max_tlen,
            max_intron=cfg.max_intron, seg_pad=4, scan_level=0, KB=6,
            P_MAX=8, W_MAX=16, OS_POOL=64, XD_POOL=64, EX_ITERS=8,
            mat=sm.mat, mis=sm.mis, ind=sm.ind, xd=sm.xd,
            seg_compact=seg_compact),
        reads, lens, jnp.asarray(mr_in.astype(np.int32)))
    assert out.shape == (B, 21)
    assert seen == [seg_compact]


@pytest.mark.parametrize("resident,wide,limit,want", [
    (10 << 30, 1 << 30, None, False),     # host CPU: no limit reported
    (10 << 30, 1 << 30, 60 << 30, False),  # fits in half the card
    (28 << 30, 4 << 30, 60 << 30, True),   # would take more than half
])
def test_choose_seg_compact(resident, wide, limit, want):
    from circminer_jax.pipeline.device_pipeline import choose_seg_compact
    assert choose_seg_compact(resident, wide, limit) is want
