import numpy as np
import pytest

from circminer_jax.ops.encode import encode_seq
from circminer_jax.ops import align as al


def ed_brute(a, b):
    n, m = len(a), len(b)
    dp = np.zeros((n + 1, m + 1), dtype=int)
    dp[:, 0] = np.arange(n + 1)
    dp[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            dp[i, j] = min(dp[i - 1, j - 1] + (a[i - 1] != b[j - 1] or a[i-1] >= 4),
                           dp[i - 1, j] + 1, dp[i, j - 1] + 1)
    return dp[n, m]


def rand_seq(rng, n):
    return rng.integers(0, 4, size=n).astype(np.int8)


def test_global_alignment_matches_brute(rng):
    for _ in range(20):
        a = rand_seq(rng, int(rng.integers(1, 30)))
        b = rand_seq(rng, int(rng.integers(1, 30)))
        assert al.global_alignment(a, b)[len(a), len(b)] == ed_brute(a, b)


def test_banded_equals_full_when_close(rng):
    w = 3
    for _ in range(20):
        n = int(rng.integers(10, 60))
        a = rand_seq(rng, n)
        b = a.copy()
        # up to w edits
        for _ in range(int(rng.integers(0, w + 1))):
            p = int(rng.integers(0, len(b)))
            b[p] = (b[p] + 1) % 4
        dp = al.global_banded_alignment(a, b, w)
        assert dp[len(a), len(b)] == ed_brute(a, b)


def test_one_side_banded(rng):
    w = 3
    a = encode_seq("ACGTACGTAC")
    b = encode_seq("ACGTACGTACGTA")  # m = n + 3
    assert al.global_one_side_banded_alignment(a, b, w) == 3
    assert al.global_one_side_banded_alignment(a, a, w) == 0


def test_drop_perfect_match():
    s = encode_seq("ACGTACGTACGTACGTACGT" * 2)
    score, on_s, on_t = al.global_banded_alignment_drop(s, s, 3, al.ScoreMat())
    assert (score, on_s, on_t) == (len(s), len(s), len(s))
    ed, sclen, indel, sc = al.drop_local_alignment_right_sc(
        s, s, 3, 4, 7)
    assert (ed, sclen, indel) == (0, 0, 0)


def test_drop_mismatch_tail():
    # 30bp ref; read matches first 24bp then diverges completely
    ref = encode_seq("ACGTACGTACGTACGTACGTACGTAAAAAA")
    t = encode_seq("ACGTACGTACGTACGTACGTACGTCCCCCC")
    ed, sclen, indel, sc = al.drop_local_alignment_right_sc(ref, t, 3, 4, 7)
    # x-drop stops in the divergent tail; clip covers the unmatched suffix
    assert ed <= 4
    assert sclen >= 4
    assert indel == 0


def test_edit_local_sc_exact():
    s = encode_seq("ACGTACGTACGTACG")   # ref window (n = m + w)
    t = encode_seq("ACGTACGTACGT")      # read part m=12
    ed, sclen, indel, sc = al.edit_local_alignment_right_sc(s, t, 3, 4, 7)
    assert (ed, sclen, indel) == (0, 0, 0)
    assert sc == 12


def test_edit_local_sc_clip():
    # last 3 bases mismatch -> soft clip beats edit
    s = encode_seq("ACGTACGTACGTACG")
    t = encode_seq("ACGTACGTAGGG")
    ed, sclen, indel, sc = al.edit_local_alignment_right_sc(s, t, 3, 4, 7)
    # clipping 3 (score -3) beats 3 mismatches (score -6)
    assert sclen == 3
    assert ed == 0


def test_edit_local_left_mirror():
    s = encode_seq("GGGATGCATGCA")[::-1]
    # left variants work on reversed strings internally; a clean prefix
    s2 = encode_seq("TACGTACGTACGTAC")
    t2 = encode_seq("TACGTACGTAC")  # == s2[-11:]
    # t2 is a suffix of s2 -> left alignment exact
    ed, sclen, indel, sc = al.edit_local_alignment_left_sc(s2, t2, 3, 4, 7)
    assert ed == 0 and sclen == 0


def test_hamming(rng):
    a = encode_seq("ACGTACGTAC")
    b = encode_seq("ACGAACGAAC")
    assert al.hamming_distance(a, b, 4) == 2
    assert al.hamming_distance(a, a, 4) == 0
