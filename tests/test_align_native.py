"""Native C++ alignment kernels must match the numpy oracle exactly."""
import numpy as np
import pytest

from circminer_jax.ops import align as al

from circminer_jax.ops import align_native as na_mod


@pytest.fixture(scope="module")
def na():
    return na_mod.NativeAligner()


def rand_pair(rng, edits=True):
    n_t = int(rng.integers(5, 120))
    t = rng.integers(0, 4, size=n_t).astype(np.int8)
    s = t.copy()
    if edits:
        for _ in range(int(rng.integers(0, 5))):
            op = rng.integers(0, 3)
            p = int(rng.integers(0, len(s)))
            if op == 0:
                s[p] = (s[p] + 1) % 4
            elif op == 1 and len(s) > 6:
                s = np.delete(s, p)
            else:
                s = np.insert(s, p, rng.integers(0, 4))
    # ref window typically longer than read part
    extra = rng.integers(0, 4, size=int(rng.integers(0, 8))).astype(np.int8)
    s = np.concatenate([s, extra])
    if rng.random() < 0.1:
        s[rng.integers(0, len(s))] = 4  # N
    return s.astype(np.int8), t


@pytest.mark.parametrize("trial", range(40))
def test_edit_sc_matches(rng, na, trial):
    s, t = rand_pair(rng)
    for fn_o, fn_n in ((al.edit_local_alignment_right_sc,
                        na.edit_local_alignment_right_sc),
                       (al.edit_local_alignment_left_sc,
                        na.edit_local_alignment_left_sc)):
        o = fn_o(s, t, 3, 4, 7)
        n = fn_n(s, t, 3, 4, 7)
        assert o == n, (trial, fn_o.__name__, o, n)


@pytest.mark.parametrize("trial", range(40))
def test_drop_sc_matches(rng, na, trial):
    s, t = rand_pair(rng)
    sm = al.ScoreMat()
    for fn_o, fn_n in ((al.drop_local_alignment_right_sc,
                        na.drop_local_alignment_right_sc),
                       (al.drop_local_alignment_left_sc,
                        na.drop_local_alignment_left_sc)):
        o = fn_o(s, t, 3, 4, 7, sm)
        n = fn_n(s, t, 3, 4, 7, sm)
        assert o == n, (trial, fn_o.__name__, o, n)


@pytest.mark.parametrize("trial", range(30))
def test_local_and_one_side_match(rng, na, trial):
    s, t = rand_pair(rng)
    assert al.local_alignment_right(s, t, 3, 4, 7) == \
        na.local_alignment_right(s, t, 3, 4, 7)
    assert al.local_alignment_left(s, t, 3, 4, 7) == \
        na.local_alignment_left(s, t, 3, 4, 7)
    # one-sided: m = n + w
    w = 3
    n_len = int(rng.integers(3, 60))
    a = rng.integers(0, 4, size=n_len).astype(np.int8)
    b = np.concatenate([a, rng.integers(0, 4, size=w).astype(np.int8)])
    assert al.global_one_side_banded_alignment(a, b, w) == \
        na.global_one_side_banded_alignment(a, b, w)
