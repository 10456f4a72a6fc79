"""Batched anti-diagonal wavefront alignment DPs in plain JAX.

The reference computes per-read banded DPs one at a time on static 600x600
arrays (src/align.cpp:395-509 banded edit distance, :254-390 X-drop score
DP, :219-252 one-sided band).  Here one ``lax.scan`` step solves one
anti-diagonal for a whole batch of (s, t) pairs at once:

  * diagonal k holds cells (i, j=k-i); the cell vector is indexed by i, so
    consecutive diagonals align via one uniform shift — no per-lane gathers,
  * the mismatch profile for diagonal k is s[i-1] vs. reversed-t shifted by
    k, again a uniform roll,
  * the band (|i-j| <= w, or the X-drop lb/ub trajectory) is a per-item
    mask over the same fixed-width vector,
  * soft-clip candidate selection (align.cpp:602-667) runs online during
    the sweep as a packed-int argmax that reproduces the oracle's exact
    (score, ed, |indel|, j desc, i asc) preference order.

The forms match ops/align.py (the host oracle) bit-exactly on inputs where
the banded path applies (n > 2w and m > w for the edit DPs; the host routes
tiny/degenerate cases to the oracle).  Production callers are
ops/device_full.py, ops/device_walk.py and ops/align_device.py.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

NEG = -(10 ** 7)   # mirrors align.cpp DPTINF magnitude
POS = 10 ** 7


def _diff_diag(s_pad, t_rev, k, I):
    """Mismatch vector for diagonal k: cell i compares s[i-1] with t[j-1],
    j = k - i.  t_rev is t reversed into a [B, I] buffer aligned so that
    t_rev[:, I - 1 - x] = t[x]; the roll amount is uniform over the batch.

    Returns bool [B, I] (True = mismatch), valid only where 1<=i and
    1<=j<=m (masked by caller)."""
    # s element for cell i: s_pad[:, i-1]  -> shift s right by 1
    s_elem = jnp.roll(s_pad, 1, axis=1)
    # t element for cell i: t[k-i-1] = t_rev[:, I-1-(k-i-1)] = roll by k-I
    t_elem = jnp.roll(t_rev, k - I, axis=1)
    return (s_elem != t_elem) | (s_elem >= 4) | (t_elem >= 4)


# --------------------------------------------------------------------------
# banded edit distance + online soft-clip candidate scan
# --------------------------------------------------------------------------

def _edit_candidate_key(dp, i_vec, k, n, m, w, max_ed, max_sclen):
    """Packed int32 preference key for AlignCandid ordering at cells of
    diagonal k (j = k - i): higher is better; 0 = no candidate.

    Order (align.h:123-152 better_than + the align.cpp:602-633 scan order):
    score desc, ed asc, |indel| asc, then j desc, i asc for exact ties."""
    j_vec = k - i_vec
    ed = dp
    sclen = m[:, None] - j_vec
    indel = j_vec - i_vec
    score = m[:, None] - sclen - 2 * ed
    ok = ((ed <= max_ed) & (sclen >= 0) & (sclen <= max_sclen[:, None])
          & (j_vec >= m[:, None] - max_sclen[:, None]) & (j_vec >= 0)
          & (j_vec <= m[:, None]) & (i_vec >= 0) & (i_vec <= n[:, None])
          & (jnp.abs(i_vec - j_vec) <= w))
    key = (((score + 512) << 21)
           | ((31 - ed) << 16)
           | ((15 - jnp.abs(indel)) << 12)
           | (j_vec << 5)
           | (31 - jnp.minimum(i_vec, 31)))
    # i asc tie-break only matters within one j (<= 2w+1 wide window), so a
    # 5-bit reversed i is sufficient (i within a j differs by < 2w+1 <= 31)
    return jnp.where(ok, key, 0)


def _decode_candidate(key, best_i, best_j, n, m, w, max_ed, max_sc):
    """Back out (ed, sclen, indel, score) from the winning cell."""
    has = key > 0
    sclen = jnp.where(has, m - best_j, max_sc + 1)
    indel = jnp.where(has, best_j - best_i, w + 1)
    score_part = (key >> 21) - 512
    ed = jnp.where(has, (m - sclen - score_part) // 2, max_ed + 1)
    return has, ed, sclen, indel


def edit_sc_scan_ref(s: jnp.ndarray, t: jnp.ndarray, n: jnp.ndarray,
                     m: jnp.ndarray, *, w: int, max_ed: int, max_sc: int,
                     I: int) -> Tuple[jnp.ndarray, ...]:
    """jnp reference: banded edit DP + soft-clip scan, batched.

    s [B, I-1] int8 (row padded), t [B, I-1] int8, n/m int32 [B].
    Returns (ed, sclen, indel, score) int32 [B] with the oracle's
    edit_local_alignment_right_sc semantics (callers pre-reverse for left).
    Valid where n > 2w and m > w (the banded regime)."""
    B = s.shape[0]
    s_pad = jnp.pad(s, ((0, 0), (0, I - s.shape[1]))).astype(jnp.int8)
    t_pad = jnp.pad(t, ((0, 0), (0, I - t.shape[1]))).astype(jnp.int8)
    t_rev = t_pad[:, ::-1]
    i_vec = jax.lax.broadcasted_iota(jnp.int32, (B, I), 1)
    max_sclen = jnp.minimum(max_sc, m)

    # diag 0: cell (0,0)=0; diag 1: (0,1)=1, (1,0)=1
    d2 = jnp.where(i_vec == 0, 0, POS)                      # k = 0
    d1 = jnp.where(i_vec <= 1, 1, POS)                      # k = 1
    d1 = jnp.where((i_vec <= 1) & (i_vec <= n[:, None])
                   & ((1 - i_vec) <= m[:, None]), d1, POS)
    best_key = jnp.zeros((B,), jnp.int32)
    best_i = jnp.zeros((B,), jnp.int32)
    best_j = jnp.zeros((B,), jnp.int32)

    # cells on the seed diagonals (k=0: (0,0); k=1: (0,1),(1,0)) can be
    # soft-clip candidates when m <= max_sclen(+1)
    for k0, d0 in ((0, d2), (1, d1)):
        key0 = _edit_candidate_key(d0, i_vec, k0, n, m, w, max_ed, max_sclen)
        kmax0 = jnp.max(key0, axis=1)
        karg0 = jnp.argmax(key0, axis=1).astype(jnp.int32)
        better0 = kmax0 > best_key
        best_key = jnp.where(better0, kmax0, best_key)
        best_i = jnp.where(better0, karg0, best_i)
        best_j = jnp.where(better0, k0 - karg0, best_j)

    def step(carry, k):
        d2, d1, best_key, best_i, best_j = carry
        mis = _diff_diag(s_pad, t_rev, k, I).astype(jnp.int32)
        diag = jnp.roll(d2, 1, axis=1) + mis                    # (i-1, j-1)
        up = jnp.roll(d1, 1, axis=1) + 1                        # (i-1, j)
        left = d1 + 1                                           # (i, j-1)
        dp = jnp.minimum(diag, jnp.minimum(up, left))
        j_vec = k - i_vec
        # boundary: dp[i][0] = i (i <= w), dp[0][j] = j (j <= w)
        dp = jnp.where((j_vec == 0) & (i_vec <= w), i_vec, dp)
        dp = jnp.where((i_vec == 0) & (j_vec <= w) & (j_vec >= 0), j_vec, dp)
        valid = ((i_vec >= 0) & (i_vec <= n[:, None]) & (j_vec >= 0)
                 & (j_vec <= m[:, None]) & (jnp.abs(i_vec - j_vec) <= w))
        dp = jnp.where(valid, dp, POS)
        key = _edit_candidate_key(dp, i_vec, k, n, m, w, max_ed, max_sclen)
        kmax = jnp.max(key, axis=1)
        karg = jnp.argmax(key, axis=1).astype(jnp.int32)
        better = kmax > best_key
        best_key = jnp.where(better, kmax, best_key)
        best_i = jnp.where(better, karg, best_i)
        best_j = jnp.where(better, k - karg, best_j)
        return (d1, dp, best_key, best_i, best_j), None

    ks = jnp.arange(2, 2 * I, dtype=jnp.int32)
    (d2, d1, best_key, best_i, best_j), _ = jax.lax.scan(
        step, (d2, d1, best_key, best_i, best_j), ks)

    has, ed, sclen, indel = _decode_candidate(
        best_key, best_i, best_j, n, m, w, max_ed, max_sc)
    # oracle tail: if m <= max_ed, candidate (m, 0, 0) competes
    tail_key = (((m - 2 * m + 512) << 21) | ((31 - m) << 16) | (15 << 12)
                | (m << 5) | 31)
    tail_better = (m <= max_ed) & (tail_key > best_key)
    ed = jnp.where(tail_better, m, ed)
    sclen = jnp.where(tail_better, 0, sclen)
    indel = jnp.where(tail_better, 0, indel)
    score = m - sclen - 2 * ed
    return ed, sclen, indel, score


# --------------------------------------------------------------------------
# X-drop anti-diagonal score DP (align.cpp:254-390)
# --------------------------------------------------------------------------

def xdrop_scan_ref(s: jnp.ndarray, t: jnp.ndarray, n: jnp.ndarray,
                   m: jnp.ndarray, *, w: int, mat: int, mis: int, ind: int,
                   xd: int, I: int) -> Tuple[jnp.ndarray, ...]:
    """jnp reference of global_banded_alignment_drop, batched.

    Returns (best_score, on_s, on_t) int32 [B].  Reproduces the reference's
    anti-diagonal band trajectory (lb/ub update rules), the `val >=
    cur_optimum` last-wins best update, the X-drop prune against the
    previous diagonal's optimum, and the dead-band early stop."""
    B = s.shape[0]
    s_pad = jnp.pad(s, ((0, 0), (0, I - s.shape[1]))).astype(jnp.int8)
    t_pad = jnp.pad(t, ((0, 0), (0, I - t.shape[1]))).astype(jnp.int8)
    t_rev = t_pad[:, ::-1]
    i_vec = jax.lax.broadcasted_iota(jnp.int32, (B, I), 1)

    # boundary rows: dpx[i][0] = i*ind (i <= min(w, n)); dpx[0][j] = j*ind
    d2 = jnp.where((i_vec == 0), 0, NEG)                    # k = 0: (0,0)
    bnd1 = (i_vec <= 1) & (i_vec <= jnp.minimum(w, n)[:, None])
    d1 = jnp.where(bnd1 & ((1 - i_vec) <= jnp.minimum(w, m)[:, None]),
                   ind * 1, NEG)                            # k = 1 cells
    # (dpx[1][0] = ind iff 1<=min(w,n);  dpx[0][1] = ind iff 1<=min(w,m))

    lb = jnp.ones((B,), jnp.int32)
    ub = jnp.ones((B,), jnp.int32)
    pre_ub = jnp.zeros((B,), jnp.int32)
    pre_opt = jnp.zeros((B,), jnp.int32)
    cur_opt = jnp.zeros((B,), jnp.int32)
    best_i = jnp.zeros((B,), jnp.int32)
    best_j = jnp.zeros((B,), jnp.int32)
    best_v = jnp.zeros((B,), jnp.int32)
    alive = (n > 0) & (m > 0)

    def step(carry, k):
        (d2, d1, lb, ub, pre_ub, pre_opt, cur_opt,
         best_i, best_j, best_v, alive) = carry
        mismatch = _diff_diag(s_pad, t_rev, k, I)
        sub = jnp.where(mismatch, mis, mat)
        diag = jnp.roll(d2, 1, axis=1) + sub
        up = jnp.roll(d1, 1, axis=1) + ind
        left = d1 + ind
        val = jnp.maximum(diag, jnp.maximum(up, left))
        j_vec = k - i_vec
        in_band = ((i_vec >= lb[:, None]) & (i_vec <= ub[:, None])
                   & (j_vec >= 1) & (j_vec <= m[:, None])
                   & (i_vec <= n[:, None]) & alive[:, None])
        val = jnp.where(in_band, val, NEG)
        # boundary columns for later diagonals (j=0 / i=0 live outside the
        # loop band in the reference and only feed cells with i,j <= w)
        bnd = ((j_vec == 0) & (i_vec <= jnp.minimum(w, n)[:, None]))
        new_d = jnp.where(bnd, ind * i_vec, val)
        bnd0 = ((i_vec == 0) & (j_vec >= 0)
                & (j_vec <= jnp.minimum(w, m)[:, None]))
        new_d = jnp.where(bnd0, ind * j_vec, new_d)

        # best update: last-wins over cells with val >= cur_opt, i ascending
        vmax = jnp.max(val, axis=1)
        upd = vmax >= cur_opt
        # largest i among cells attaining vmax
        att = (val == vmax[:, None]) & in_band
        i_att = jnp.max(jnp.where(att, i_vec, -1), axis=1)
        cur_opt = jnp.where(upd & alive, vmax, cur_opt)
        best_i = jnp.where(upd & alive, i_att, best_i)
        best_j = jnp.where(upd & alive, k - i_att, best_j)
        best_v = jnp.where(upd & alive, vmax, best_v)

        # X-drop prune vs. previous diagonal's optimum
        pruned = jnp.where(val + xd < pre_opt[:, None], NEG, val)
        new_d = jnp.where(in_band, pruned, new_d)
        # new_ub: largest in-band i with surviving value
        surv = in_band & (pruned > NEG)
        new_ub = jnp.max(jnp.where(surv, i_vec, -1), axis=1)

        # band trajectory (align.cpp:358-372)
        lb_t = k - lb
        lb2 = jnp.where((lb_t == m) | ((k > w) & ((k - w) % 2 == 0)),
                        lb + 1, lb)
        ub2 = jnp.where((ub < n) & ((k <= w) | ((k > w) & ((k - w) % 2 == 1))),
                        ub + 1, ub)
        dead = ((pre_ub == -1) & (new_ub == -1)) | (lb2 > ub2)
        alive2 = alive & ~dead
        pre_ub2 = jnp.where(alive, new_ub, pre_ub)
        pre_opt2 = jnp.where(alive, jnp.maximum(pre_opt, cur_opt), pre_opt)
        lb2 = jnp.where(alive, lb2, lb)
        ub2 = jnp.where(alive, ub2, ub)
        return (d1, new_d, lb2, ub2, pre_ub2, pre_opt2, cur_opt,
                best_i, best_j, best_v, alive2), None

    ks = jnp.arange(2, 2 * I, dtype=jnp.int32)
    carry = (d2, d1, lb, ub, pre_ub, pre_opt, cur_opt,
             best_i, best_j, best_v, alive)
    carry, _ = jax.lax.scan(step, carry, ks)
    (_, _, _, _, _, _, _, best_i, best_j, best_v, _) = carry
    empty = (n <= 0) | (m <= 0)
    return (jnp.where(empty, 0, best_v), jnp.where(empty, 0, best_i),
            jnp.where(empty, 0, best_j))


@partial(jax.jit, static_argnames=("w", "mat", "mis", "ind", "xd", "I"))
def xdrop_batch_ref(s, t, n, m, *, w, mat, mis, ind, xd, I: int = 128):
    return xdrop_scan_ref(s, t, n, m, w=w, mat=mat, mis=mis, ind=ind,
                          xd=xd, I=I)


@partial(jax.jit, static_argnames=("w", "max_ed", "max_sc", "I"))
def edit_sc_batch_ref(s, t, n, m, *, w, max_ed, max_sc, I: int = 128):
    return edit_sc_scan_ref(s, t, n, m, w=w, max_ed=max_ed, max_sc=max_sc,
                            I=I)


# host-facing wrapper: drop_local_*_sc arithmetic (align.cpp:669-723)
def drop_local_sc_batch(score, on_s, on_t, m, *, mat, mis, w, max_ed,
                        max_sc, left: bool):
    """Vectorized AlignCandid wrap-up for a batch of X-drop results."""
    score = np.asarray(score).astype(np.int64)
    on_s = np.asarray(on_s).astype(np.int64)
    on_t = np.asarray(on_t).astype(np.int64)
    m = np.asarray(m).astype(np.int64)
    mx = np.maximum(on_s, on_t)
    ed = (mat * mx - score) // (mat - mis)
    indel = on_t - on_s
    clip = m - on_t
    ok = ed <= max_ed
    if not left:
        # the right side goes through AlignCandid::update against a
        # score-0 sentinel (align.cpp:683-688): negative-score candidates
        # are rejected; the left side sets unconditionally (align.cpp:713)
        ok = ok & (score >= 0)
    out_ed = np.where(ok, ed, max_ed + 1)
    out_sclen = np.where(ok, clip, np.maximum(max_sc, m) + 1)
    out_indel = np.where(ok, indel, w + 1)
    return out_ed, out_sclen, out_indel, score
