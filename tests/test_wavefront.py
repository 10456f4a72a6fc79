"""Batched wavefront DPs (ops/wavefront.py) vs. the host oracle
(ops/align.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from circminer_jax.ops import align as al
from circminer_jax.ops.wavefront import (
    edit_sc_batch_ref, xdrop_batch_ref, drop_local_sc_batch)

W, MAX_ED, MAX_SC = 3, 4, 7
SM = al.ScoreMat()


def _random_pairs(rng, B, min_n=8, max_n=110):
    """Random (s, t) in the banded regime (n > 2w, m > w), ~2% mismatches
    plus indels plus some unrelated pairs."""
    I = 128
    s = np.zeros((B, I - 1), np.int8)
    t = np.zeros((B, I - 1), np.int8)
    ns = np.zeros(B, np.int32)
    ms = np.zeros(B, np.int32)
    for b in range(B):
        m = int(rng.integers(W + 1, max_n))
        base = rng.integers(0, 4, size=m + 2 * W).astype(np.int8)
        kind = b % 4
        if kind == 0:          # near-identical
            sv = base[:m].copy()
            nmut = int(rng.integers(0, 3))
            for _ in range(nmut):
                sv[rng.integers(0, m)] = rng.integers(0, 4)
            n = m
        elif kind == 1:        # insertion in s
            n = min(m + int(rng.integers(1, W + 1)), max_n)
            sv = np.concatenate([base[:m], rng.integers(0, 4, size=n - m)
                                 .astype(np.int8)])[:n]
        elif kind == 2:        # s shorter (deletion)
            n = max(2 * W + 1, m - int(rng.integers(1, W + 1)))
            sv = base[:n].copy()
        else:                  # unrelated
            n = int(rng.integers(2 * W + 1, max_n))
            sv = rng.integers(0, 4, size=n).astype(np.int8)
        if n <= 2 * W:
            n = 2 * W + 1
            sv = np.concatenate([sv, rng.integers(0, 4, size=n - len(sv))
                                 .astype(np.int8)])[:n]
        if rng.random() < 0.1:  # sprinkle N
            sv[rng.integers(0, n)] = 4
        s[b, :n] = sv[:n]
        t[b, :m] = base[:m]
        ns[b], ms[b] = n, m
    return s, t, ns, ms


def test_edit_sc_ref_matches_oracle():
    rng = np.random.default_rng(5)
    B = 256
    s, t, ns, ms = _random_pairs(rng, B)
    ed, sc, ind, score = jax.device_get(edit_sc_batch_ref(
        jnp.asarray(s), jnp.asarray(t), jnp.asarray(ns), jnp.asarray(ms),
        w=W, max_ed=MAX_ED, max_sc=MAX_SC))
    for b in range(B):
        want = al.edit_local_alignment_right_sc(
            s[b, :ns[b]], t[b, :ms[b]], W, MAX_ED, MAX_SC)
        got = (int(ed[b]), int(sc[b]), int(ind[b]), int(score[b]))
        assert got == want, (b, got, want, ns[b], ms[b])


def test_edit_sc_ref_left_via_reversal():
    rng = np.random.default_rng(6)
    B = 64
    s, t, ns, ms = _random_pairs(rng, B)
    rs = np.zeros_like(s)
    rt = np.zeros_like(t)
    for b in range(B):
        rs[b, :ns[b]] = s[b, :ns[b]][::-1]
        rt[b, :ms[b]] = t[b, :ms[b]][::-1]
    ed, sc, ind, score = jax.device_get(edit_sc_batch_ref(
        jnp.asarray(rs), jnp.asarray(rt), jnp.asarray(ns), jnp.asarray(ms),
        w=W, max_ed=MAX_ED, max_sc=MAX_SC))
    for b in range(B):
        want = al.edit_local_alignment_left_sc(
            s[b, :ns[b]], t[b, :ms[b]], W, MAX_ED, MAX_SC)
        got = (int(ed[b]), int(sc[b]), int(ind[b]), int(score[b]))
        assert got == want, (b, got, want)


def test_xdrop_ref_matches_oracle():
    rng = np.random.default_rng(7)
    B = 256
    s, t, ns, ms = _random_pairs(rng, B)
    sc, oi, oj = jax.device_get(xdrop_batch_ref(
        jnp.asarray(s), jnp.asarray(t), jnp.asarray(ns), jnp.asarray(ms),
        w=W, mat=SM.mat, mis=SM.mis, ind=SM.ind, xd=SM.xd))
    for b in range(B):
        want = al.global_banded_alignment_drop(
            s[b, :ns[b]], t[b, :ms[b]], W, SM)
        got = (int(sc[b]), int(oi[b]), int(oj[b]))
        assert got == want, (b, got, want, ns[b], ms[b])


def test_drop_local_sc_wrapper_matches_oracle():
    rng = np.random.default_rng(9)
    B = 256
    s, t, ns, ms = _random_pairs(rng, B)
    sc, oi, oj = jax.device_get(xdrop_batch_ref(
        jnp.asarray(s), jnp.asarray(t), jnp.asarray(ns), jnp.asarray(ms),
        w=W, mat=SM.mat, mis=SM.mis, ind=SM.ind, xd=SM.xd))
    ed, sclen, ind_, score = drop_local_sc_batch(
        sc, oi, oj, ms, mat=SM.mat, mis=SM.mis, w=W, max_ed=MAX_ED,
        max_sc=MAX_SC, left=False)
    for b in range(B):
        want = al.drop_local_alignment_right_sc(
            s[b, :ns[b]], t[b, :ms[b]], W, MAX_ED, MAX_SC, SM)
        got = (int(ed[b]), int(sclen[b]), int(ind_[b]), int(score[b]))
        assert got == want, (b, got, want)

    # left: reversed inputs + unconditional-set semantics
    rs = np.zeros_like(s)
    rt = np.zeros_like(t)
    for b in range(B):
        rs[b, :ns[b]] = s[b, :ns[b]][::-1]
        rt[b, :ms[b]] = t[b, :ms[b]][::-1]
    sc, oi, oj = jax.device_get(xdrop_batch_ref(
        jnp.asarray(rs), jnp.asarray(rt), jnp.asarray(ns), jnp.asarray(ms),
        w=W, mat=SM.mat, mis=SM.mis, ind=SM.ind, xd=SM.xd))
    ed, sclen, ind_, score = drop_local_sc_batch(
        sc, oi, oj, ms, mat=SM.mat, mis=SM.mis, w=W, max_ed=MAX_ED,
        max_sc=MAX_SC, left=True)
    for b in range(B):
        want = al.drop_local_alignment_left_sc(
            s[b, :ns[b]], t[b, :ms[b]], W, MAX_ED, MAX_SC, SM)
        got = (int(ed[b]), int(sclen[b]), int(ind_[b]), int(score[b]))
        assert got == want, (b, got, want)

