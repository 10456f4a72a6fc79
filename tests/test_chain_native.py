"""Native C++ chain DP vs. the Python oracle (chain_seeds_host)."""

import numpy as np
import pytest

from circminer_jax.config import Config
from circminer_jax.ops.chain import chain_seeds_host
from circminer_jax.ops import chain_native


def _random_case(rng, cfg, db, contig, genome_len, k, n_lists, cap):
    """Random seed lists with a planted colinear chain."""
    lens = rng.integers(k, n_lists * k + 1)
    n_use = int(lens) // k
    qpos = np.array([i * k for i in range(n_lists)], dtype=np.int32)
    cnt = np.zeros(n_lists, dtype=np.int32)
    pos = np.zeros((n_lists, cap), dtype=np.int32)
    anchor = int(rng.integers(1, genome_len - n_lists * k - 10))
    for l in range(n_use):
        n = int(rng.integers(0, cap))
        ps = rng.integers(1, genome_len - k, size=n).tolist()
        if rng.random() < 0.8:
            ps.append(anchor + l * k + int(rng.integers(-2, 3)))
            n += 1
        ps = sorted(set(max(1, p) for p in ps))[:cap]
        cnt[l] = len(ps)
        pos[l, :len(ps)] = ps
    return pos, cnt, qpos, np.int32(lens)


def _oracle(pos, cnt, qpos, seq_len, cfg, db, contig):
    seed_pos = [pos[l, :cnt[l]].astype(np.int64) for l in range(pos.shape[0])]
    return chain_seeds_host(int(seq_len), qpos.astype(np.int64), seed_pos,
                            cfg, db, contig)


def _assert_equal_chains(a, b, row):
    assert len(a) == len(b), f"row {row}: {len(a)} vs {len(b)} chains"
    for i, (x, y) in enumerate(zip(a, b)):
        assert np.array_equal(x.rpos, y.rpos), (row, i, x.rpos, y.rpos)
        assert np.array_equal(x.qpos, y.qpos), (row, i)
        assert x.score == pytest.approx(y.score, abs=1e-9), (row, i)


def test_native_chain_matches_oracle_no_annotation():
    cfg = Config(kmer=20, max_read_len=120)
    rng = np.random.default_rng(7)
    nc = chain_native.NativeChainer(None, cfg)
    NL = cfg.n_kmer_lists
    cap = 16
    R = 200
    pos = np.zeros((R, NL, cap), dtype=np.int32)
    cnt = np.zeros((R, NL), dtype=np.int32)
    qpos = np.zeros((R, NL), dtype=np.int32)
    lens = np.zeros(R, dtype=np.int32)
    for r in range(R):
        p, c, q, L = _random_case(rng, cfg, None, 0, 100_000, cfg.kmer,
                                  NL, cap)
        pos[r], cnt[r], qpos[r], lens[r] = p, c, q, L
    rp, qp, cl, sc, n = nc.chain_batch(pos, cnt, qpos, lens)
    for r in range(R):
        want = _oracle(pos[r], cnt[r], qpos[r], lens[r], cfg, None, 0)
        got = chain_native.NativeChainer.to_chains(
            rp[r], qp[r], cl[r], sc[r], n[r], cfg.kmer)
        _assert_equal_chains(got, want, r)


def test_native_chain_matches_oracle_with_annotation(tmp_path):
    """Junction-gated chaining across a two-exon gene."""
    from circminer_jax.annotation.annotation import AnnotationDB
    from circminer_jax.io.fasta import ContigLen

    cfg = Config(kmer=20, max_read_len=120)
    glen = 200_000
    gtf = tmp_path / "t.gtf"
    lines = []
    for g, base in enumerate((10_000, 60_000, 120_000)):
        gid, tid = f"G{g}", f"T{g}"
        e1 = (base, base + 400)
        e2 = (base + 2_000, base + 2_500)
        lines.append(f"chr1\tx\tgene\t{e1[0]}\t{e2[1]}\t.\t+\t.\t"
                     f'gene_id "{gid}";')
        lines.append(f"chr1\tx\ttranscript\t{e1[0]}\t{e2[1]}\t.\t+\t.\t"
                     f'gene_id "{gid}"; transcript_id "{tid}";')
        for i, (a, b) in enumerate((e1, e2)):
            lines.append(
                f"chr1\tx\texon\t{a}\t{b}\t.\t+\t.\t"
                f'gene_id "{gid}"; transcript_id "{tid}"; '
                f'exon_number "{i + 1}";')
    gtf.write_text("\n".join(lines) + "\n")
    db = AnnotationDB.from_gtf(
        str(gtf), [ContigLen("chr1", 1, 0, glen)], 1, cfg,
        contig_lengths=[glen])

    rng = np.random.default_rng(11)
    nc = chain_native.NativeChainer(db.contigs[0], cfg)
    NL = cfg.n_kmer_lists
    cap = 16
    R = 300
    pos = np.zeros((R, NL, cap), dtype=np.int32)
    cnt = np.zeros((R, NL), dtype=np.int32)
    qpos = np.zeros((R, NL), dtype=np.int32)
    lens = np.zeros(R, dtype=np.int32)
    for r in range(R):
        if r % 3 == 0:
            # seeds straddling an exon junction (exon1 end -> exon2 begin)
            base = (10_000, 60_000, 120_000)[r % 3]
            lens[r] = 100
            qpos[r] = np.arange(NL, dtype=np.int32) * cfg.kmer
            a = base + 400 - 39  # last 40bp of exon1
            b = base + 2_000    # start of exon2
            seeds = [a, a + 20, b + 1, b + 21, b + 41]
            for l in range(5):
                cnt[r, l] = 1
                pos[r, l, 0] = seeds[l]
        else:
            p, c, q, L = _random_case(rng, cfg, db, 0, glen, cfg.kmer,
                                      NL, cap)
            pos[r], cnt[r], qpos[r], lens[r] = p, c, q, L
    rp, qp, cl, sc, n = nc.chain_batch(pos, cnt, qpos, lens)
    for r in range(R):
        want = _oracle(pos[r], cnt[r], qpos[r], lens[r], cfg, db, 0)
        got = chain_native.NativeChainer.to_chains(
            rp[r], qp[r], cl[r], sc[r], n[r], cfg.kmer)
        _assert_equal_chains(got, want, r)


def test_native_chain_shift_and_small_k():
    """Circ-stage variant: k=8 with a genome shift."""
    cfg = Config(kmer=8, window_size=8, max_read_len=80)
    rng = np.random.default_rng(3)
    nc = chain_native.NativeChainer(None, cfg)
    NL = cfg.n_kmer_lists
    cap = 8
    R = 100
    pos = np.zeros((R, NL, cap), dtype=np.int32)
    cnt = np.zeros((R, NL), dtype=np.int32)
    qpos = np.zeros((R, NL), dtype=np.int32)
    lens = np.zeros(R, dtype=np.int32)
    for r in range(R):
        p, c, q, L = _random_case(rng, cfg, None, 0, 5_000, cfg.kmer, NL, cap)
        pos[r], cnt[r], qpos[r], lens[r] = p, c, q, L
    shift = 777
    rp, qp, cl, sc, n = nc.chain_batch(pos, cnt, qpos, lens, shift=shift)
    for r in range(R):
        seed_pos = [pos[r, l, :cnt[r, l]].astype(np.int64)
                    for l in range(NL)]
        want = chain_seeds_host(int(lens[r]), qpos[r].astype(np.int64),
                                seed_pos, cfg, None, 0, kmer=cfg.kmer,
                                shift=shift)
        got = chain_native.NativeChainer.to_chains(
            rp[r], qp[r], cl[r], sc[r], n[r], cfg.kmer)
        _assert_equal_chains(got, want, r)


def test_native_extract_matches_python_extract():
    """batch_extract_kbest (C++) vs extract_kbest (python) on device chain
    DP outputs — the device executor's extraction path."""
    import jax.numpy as jnp
    from circminer_jax.ops.chain import chain_batch_device, extract_kbest

    cfg = Config(kmer=20, max_read_len=120)
    rng = np.random.default_rng(23)
    NL = cfg.n_kmer_lists
    cap = 16
    R = 150
    pos = np.zeros((R, NL, cap), dtype=np.int32)
    cnt = np.zeros((R, NL), dtype=np.int32)
    qpos = np.zeros((R, NL), dtype=np.int32)
    lens = np.zeros(R, dtype=np.int32)
    for r in range(R):
        p, c, q, sl = _random_case(rng, cfg, None, 0, 200_000, cfg.kmer,
                                   NL, cap)
        pos[r], cnt[r], qpos[r], lens[r] = p, c, q, sl
    # sort each list ascending (device gather produces sorted positions)
    for r in range(R):
        for l in range(NL):
            pos[r, l, :cnt[r, l]] = np.sort(pos[r, l, :cnt[r, l]])

    z1 = jnp.zeros(1, jnp.uint8)
    zi = jnp.zeros(1, jnp.int32)
    zs = jnp.zeros((1, 4), jnp.int32)
    dp10, back = chain_batch_device(
        jnp.asarray(pos), jnp.asarray(cnt), jnp.asarray(qpos),
        jnp.asarray(lens), z1, zi, zi, zi, zi, zi, zi, zs, zs,
        k=cfg.kmer, max_ed=cfg.max_ed, max_intron=cfg.max_intron, seg_pad=4)
    dp10 = np.asarray(dp10)
    back = np.asarray(back)

    rp, qp, cl, sc, n = chain_native.NativeChainer.extract_batch(
        dp10, back, pos, qpos, cnt, cfg.kmer, cfg.max_chain_len)
    for r in range(R):
        want = extract_kbest(dp10[r], back[r], pos[r], qpos[r], cnt[r], cfg)
        got = chain_native.NativeChainer.to_chains(
            rp[r], qp[r], cl[r], sc[r], n[r], cfg.kmer)
        _assert_equal_chains(got, want, r)
