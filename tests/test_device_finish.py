"""Device k-best chain extraction == host extraction, bit-exact."""
import numpy as np
import pytest

from circminer_jax.config import Config
from circminer_jax.sim import make_genome, simulate_reads
from circminer_jax.io.fasta import GenomePacker
from circminer_jax.index.build import build_genome_index
from circminer_jax.annotation.annotation import AnnotationDB
from circminer_jax.annotation.device import AnnoDevice
from circminer_jax.ops.encode import encode_seq, revcomp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dfin")
    rng = np.random.default_rng(11)
    g = make_genome(rng, length=80_000, n_genes=4, dup_frac=0.1)
    ref = str(tmp / "ref.fa")
    gtf = str(tmp / "ref.gtf")
    g.write_fasta(ref)
    g.write_gtf(gtf)
    cfg = Config(kmer=20, max_read_len=100)
    gp = GenomePacker(ref)
    contigs, info = gp.pack_genome()
    gi = build_genome_index(contigs, cfg)
    db = AnnotationDB.from_gtf(gtf, info, 1, cfg,
                               contig_lengths=[len(c) for c in contigs])
    reads, _ = simulate_reads(rng, g, 60, 40, read_len=100, err_rate=0.01)
    return rng, g, cfg, gi, db, reads


def _chain_dp(world, cap=16):
    """Run lookup + device chain DP over all 4 rows of every pair."""
    import jax.numpy as jnp
    from circminer_jax.ops.seed import lookup_batch_device
    from circminer_jax.ops.chain import chain_batch_device
    rng, g, cfg, gi, db, reads = world
    ci = gi.contigs[0]
    ad = AnnoDevice.from_contig(db.contigs[0], seg_pad=16)
    L = cfg.max_read_len
    rows = []
    for r in reads:
        s1, s2 = encode_seq(r.r1), encode_seq(r.r2)
        rows += [s1, revcomp(s1), s2, revcomp(s2)]
    R = len(rows)
    seqs = np.zeros((R, L), np.int8)
    lens = np.zeros(R, np.int32)
    for i, s in enumerate(rows):
        seqs[i, :len(s)] = s
        lens[i] = len(s)
    qpos, start, cnt, high = lookup_batch_device(
        jnp.asarray(seqs), jnp.asarray(lens),
        jnp.asarray(ci.entry_hv), jnp.asarray(ci.entry_checksum.astype(
            np.int32)),
        k=cfg.kmer, cs_len=cfg.checksum_len, n_slots=cfg.max_seg_cnt,
        seed_lim=cfg.seed_lim)
    start = np.asarray(start)[:, ::2]
    cnt_h = np.minimum(np.asarray(cnt)[:, ::2], cap)
    NL = cfg.n_kmer_lists
    qpos_h = np.asarray(qpos)[:, ::2]
    qpos_h = np.maximum(qpos_h, 0)
    pos = np.zeros((R, NL, cap), np.int32)
    ep = ci.entry_pos
    for r in range(R):
        for s in range(NL):
            c = int(cnt_h[r, s])
            if c > 0:
                st = int(start[r, s])
                pos[r, s, :c] = ep[st:st + c]
    dp10, back = chain_batch_device(
        jnp.asarray(pos), jnp.asarray(cnt_h), jnp.asarray(qpos_h),
        jnp.asarray(lens),
        ad.nb_bits, ad.iv_spos, ad.iv_epos, ad.iv_max_end, ad.iv_min_end,
        ad.iv_max_next, ad.iv_nseg, ad.seg_end, ad.seg_next,
        k=cfg.kmer, max_ed=cfg.max_ed, max_intron=cfg.max_intron,
        seg_pad=ad.seg_pad)
    return (np.asarray(dp10), np.asarray(back), pos, qpos_h, cnt_h, lens)


def test_extract_kbest_device_parity(world):
    import jax.numpy as jnp
    from circminer_jax.ops.chain import extract_kbest
    from circminer_jax.ops.device_finish import extract_kbest_device
    rng, g, cfg, gi, db, reads = world
    dp10, back, pos, qpos, cnt, lens = _chain_dp(world)
    C = cfg.max_chain_len
    rp, qp, cl, sc10, cn, inc = extract_kbest_device(
        jnp.asarray(dp10), jnp.asarray(back), jnp.asarray(pos),
        jnp.asarray(qpos), jnp.asarray(cnt), k=cfg.kmer, C=C, iters=64)
    rp, qp, cl, sc10 = map(np.asarray, (rp, qp, cl, sc10))
    cn, inc = np.asarray(cn), np.asarray(inc)

    R = dp10.shape[0]
    n_checked = 0
    for r in range(R):
        chains = extract_kbest(dp10[r], back[r], pos[r], qpos[r], cnt[r],
                               cfg)
        if inc[r]:
            continue  # deferred rows go to the host pipeline
        assert cn[r] == len(chains), f"row {r}: {cn[r]} != {len(chains)}"
        for c, ch in enumerate(chains):
            assert cl[r, c] == ch.chain_len
            np.testing.assert_array_equal(rp[r, c, :ch.chain_len], ch.rpos)
            np.testing.assert_array_equal(qp[r, c, :ch.chain_len], ch.qpos)
            assert abs(sc10[r, c] / 10.0 - ch.score) < 1e-6
        n_checked += 1
    # the fixed iteration budget must cover the vast majority of rows
    assert n_checked >= 0.95 * R
    assert inc.sum() < 0.05 * R
