import numpy as np
import pytest

from circminer_jax.config import Config
from circminer_jax.ops.encode import (
    encode_seq, decode_seq, revcomp, kmer_hashes, hash_at)
from circminer_jax.index.build import (
    build_contig_index, build_genome_index, save_genome_index,
    load_genome_index)
from circminer_jax.ops.seed import (
    lookup_read_host, lookup_batch_device, gather_seeds_device)


def random_genome(rng, n, n_frac=0.01):
    codes = rng.integers(0, 4, size=n).astype(np.int8)
    mask = rng.random(n) < n_frac
    codes[mask] = 4
    return codes


def test_encode_roundtrip():
    s = "ACGTNacgtnX"
    c = encode_seq(s)
    assert list(c) == [0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 4]
    assert decode_seq(c) == "ACGTNACGTNN"


def test_revcomp():
    c = encode_seq("AACGT")
    assert decode_seq(revcomp(c)) == "ACGTT"
    # revcomp is an involution
    assert np.array_equal(revcomp(revcomp(c)), c)


def test_kmer_hashes_match_scalar(rng):
    codes = random_genome(rng, 200, n_frac=0.05)
    k = 6
    h = kmer_hashes(codes, k)
    for i in range(len(codes) - k + 1):
        assert h[i] == hash_at(codes, i, k)


def test_index_entries_exact(rng):
    """Every indexed entry is a real exact k-mer occurrence, and lookup finds
    exactly the brute-force occurrence set."""
    cfg = Config(kmer=8, window_size=6, max_read_len=40)  # small k for a dense tiny test
    codes = random_genome(rng, 3000, n_frac=0.02)
    ci = build_contig_index(codes, "1", cfg)

    # all entries decode correctly
    k = cfg.kmer
    hashes = kmer_hashes(codes, k)
    for hv in rng.integers(0, 4 ** cfg.window_size, size=50):
        lo, hi = ci.bucket_range(hv)
        for e in range(lo, hi):
            pos0 = ci.entry_pos[e] - 1
            full = (hv << (2 * cfg.checksum_len)) | int(ci.entry_checksum[e])
            assert hashes[pos0] == full

    # brute-force occurrence check for a handful of k-mers present in genome
    valid_pos = np.nonzero(hashes >= 0)[0]
    for pos0 in rng.choice(valid_pos, size=20, replace=False):
        target = hashes[pos0]
        expect = np.nonzero(hashes == target)[0] + 1
        hv = target >> (2 * cfg.checksum_len)
        cv = target & ((1 << (2 * cfg.checksum_len)) - 1)
        lo, hi = ci.bucket_range(hv)
        sub = ci.entry_checksum[lo:hi]
        l = lo + np.searchsorted(sub, cv, "left")
        r = lo + np.searchsorted(sub, cv, "right")
        got = np.sort(ci.entry_pos[l:r])
        assert np.array_equal(got, expect)


def test_index_save_load_roundtrip(tmp_path, rng):
    cfg = Config(kmer=8, window_size=6)
    codes = random_genome(rng, 2000)
    gi = build_genome_index([codes], cfg)
    for compact in (False, True):
        p = str(tmp_path / f"idx_{compact}.npz")
        save_genome_index(gi, p, compact=compact)
        gi2 = load_genome_index(p)
        a, b = gi.contigs[0], gi2.contigs[0]
        assert np.array_equal(a.codes, b.codes)
        assert np.array_equal(a.entry_hv, b.entry_hv)
        assert np.array_equal(a.entry_checksum, b.entry_checksum)
        assert np.array_equal(a.entry_pos, b.entry_pos)


def test_device_lookup_matches_host(rng):
    import jax.numpy as jnp
    cfg = Config(kmer=8, window_size=6, max_read_len=40, seed_lim=50)
    codes = random_genome(rng, 5000, n_frac=0.01)
    ci = build_contig_index(codes, "1", cfg)

    B, L = 16, 40
    reads = np.zeros((B, L), dtype=np.int8)
    lens = np.zeros(B, dtype=np.int32)
    for b in range(B):
        ln = int(rng.integers(20, L + 1))
        start = int(rng.integers(0, len(codes) - ln))
        reads[b, :ln] = codes[start:start + ln]
        # random N injection
        if rng.random() < 0.3:
            reads[b, rng.integers(0, ln)] = 4
        lens[b] = ln

    qpos_d, start_d, cnt_d, hh_d = lookup_batch_device(
        jnp.asarray(reads), jnp.asarray(lens),
        jnp.asarray(ci.entry_hv), jnp.asarray(ci.entry_checksum),
        k=cfg.kmer, cs_len=cfg.checksum_len, n_slots=cfg.max_seg_cnt,
        seed_lim=cfg.seed_lim)
    qpos_d, start_d = np.asarray(qpos_d), np.asarray(start_d)
    cnt_d, hh_d = np.asarray(cnt_d), np.asarray(hh_d)

    for b in range(B):
        hh = lookup_read_host(reads[b, :lens[b]], ci, cfg)
        assert np.array_equal(hh.qpos, qpos_d[b])
        assert np.array_equal(hh.count, cnt_d[b])
        assert np.array_equal(hh.high_hit, hh_d[b])
        nz = hh.count > 0
        assert np.array_equal(hh.start[nz], start_d[b][nz])

    # gather positions and verify they're real occurrences
    pos, mask = gather_seeds_device(
        jnp.asarray(ci.entry_pos), jnp.asarray(start_d), jnp.asarray(cnt_d),
        cap=16)
    pos, mask = np.asarray(pos), np.asarray(mask)
    k = cfg.kmer
    for b in range(B):
        for s in range(cfg.max_seg_cnt):
            for j in range(16):
                if mask[b, s, j]:
                    p0 = pos[b, s, j] - 1
                    q0 = qpos_d[b, s]
                    assert np.array_equal(
                        codes[p0:p0 + k], reads[b, q0:q0 + k])
