"""Batched device alignment service for the wave extension engine.

Solves whole *waves* of alignment requests (the tuples yielded by
pipeline/extend.py generators) as a handful of batched device dispatches —
one per request kind — instead of one scalar kernel call per candidate
(the reference's per-read recursion, src/extend.cpp:491-875 +
src/align.cpp:556-723).

Kind -> kernel mapping:
  edit_sc_r / edit_sc_l   -> edit_sc_scan (banded edit DP + soft-clip scan,
                             wavefront.py; left = reversed inputs, the
                             oracle's global_banded_alignment_reverse)
  drop_sc_r / drop_sc_l   -> xdrop_scan + drop_local_sc_batch wrap-up
  end_r / end_l           -> edit_end_scan (banded edit DP, candidates on
                             the j == m column only; align.cpp:556-576)
  one_side                -> one_side_scan (one-sided band, per-item width;
                             align.cpp:219-252)

Requests whose shapes fall outside a kernel's banded regime (the oracle
falls back to full DP there, align.cpp:397-399) are answered by the scalar
host aligner — they are tiny by construction.  Everything else is padded
into fixed [B, I] int8 buffers (I = 128 covers reads <= 120 + band), and
the result crosses to the host as one 2-D int32 tensor per wave.

All outputs are bit-identical to ops/align.py (pinned by
tests/test_align_device.py and end-to-end by tests/test_extend_batch.py).
"""

from __future__ import annotations

from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import align as al
from .wavefront import (POS, _diff_diag, edit_sc_batch_ref,
                           xdrop_batch_ref, drop_local_sc_batch)


# --------------------------------------------------------------------------
# banded edit DP, candidates on the j == m column (local_alignment_right)
# --------------------------------------------------------------------------

def edit_end_scan_ref(s: jnp.ndarray, t: jnp.ndarray, n: jnp.ndarray,
                      m: jnp.ndarray, *, w: int, max_ed: int,
                      I: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched local_alignment_right (align.cpp:556-576): banded edit DP,
    then the best AlignCandid over column j == m, i in [m-w, m+w] & i <= n —
    order ed asc, |indel| asc, first-encountered (smallest i) on ties.

    Returns (ed, indel) int32 [B]; no candidate -> (max_ed+1, w+1).
    Valid in the banded regime (n > 2w, m > w); callers route the rest to
    the host oracle."""
    B = s.shape[0]
    s_pad = jnp.pad(s, ((0, 0), (0, I - s.shape[1]))).astype(jnp.int8)
    t_pad = jnp.pad(t, ((0, 0), (0, I - t.shape[1]))).astype(jnp.int8)
    t_rev = t_pad[:, ::-1]
    i_vec = jax.lax.broadcasted_iota(jnp.int32, (B, I), 1)

    d2 = jnp.where(i_vec == 0, 0, POS)
    d1 = jnp.where(i_vec <= 1, 1, POS)
    d1 = jnp.where((i_vec <= 1) & (i_vec <= n[:, None])
                   & ((1 - i_vec) <= m[:, None]), d1, POS)
    # banded regime => m > w >= 0, so column-m candidates first appear at
    # diagonal k = m > 1: the two seed diagonals never hold one
    best_key = jnp.zeros((B,), jnp.int32)
    best_ed = jnp.full((B,), max_ed + 1, jnp.int32)
    best_indel = jnp.full((B,), w + 1, jnp.int32)

    def step(carry, k):
        d2, d1, best_key, best_ed, best_indel = carry
        mis = _diff_diag(s_pad, t_rev, k, I).astype(jnp.int32)
        diag = jnp.roll(d2, 1, axis=1) + mis
        up = jnp.roll(d1, 1, axis=1) + 1
        left = d1 + 1
        dp = jnp.minimum(diag, jnp.minimum(up, left))
        j_vec = k - i_vec
        dp = jnp.where((j_vec == 0) & (i_vec <= w), i_vec, dp)
        dp = jnp.where((i_vec == 0) & (j_vec <= w) & (j_vec >= 0), j_vec, dp)
        valid = ((i_vec >= 0) & (i_vec <= n[:, None]) & (j_vec >= 0)
                 & (j_vec <= m[:, None]) & (jnp.abs(i_vec - j_vec) <= w))
        dp = jnp.where(valid, dp, POS)
        # exactly one cell per diagonal sits on column m: i = k - m
        on_m = valid & (j_vec == m[:, None]) & (dp <= max_ed)
        cell_ed = jnp.max(jnp.where(on_m, max_ed - dp, -1), axis=1)
        has = cell_ed >= 0
        ed = max_ed - cell_ed
        i_here = k - m
        indel = m - i_here  # AlignCandid(dp[i][m], 0, m - i)
        # preference: ed asc, |indel| asc; strict > keeps the earlier
        # (smaller i) on exact ties — candidates arrive in ascending i.
        # Key radix is sized from the static (max_ed, w) so no config can
        # saturate it: ed <= max_ed, |indel| clamped to w + 1.
        key = ((max_ed - ed) * (w + 2)
               + (w + 1 - jnp.minimum(jnp.abs(indel), w + 1)))
        better = has & (key > best_key)
        best_key = jnp.where(better, key, best_key)
        best_ed = jnp.where(better, ed, best_ed)
        best_indel = jnp.where(better, indel, best_indel)
        return (d1, dp, best_key, best_ed, best_indel), None

    ks = jnp.arange(2, 2 * I, dtype=jnp.int32)
    carry = (d2, d1, best_key, best_ed, best_indel)
    (d2, d1, best_key, best_ed, best_indel), _ = jax.lax.scan(
        step, carry, ks)
    return best_ed, best_indel


@partial(jax.jit, static_argnames=("w", "max_ed", "I"))
def edit_end_batch_ref(s, t, n, m, *, w, max_ed, I: int = 128):
    return edit_end_scan_ref(s, t, n, m, w=w, max_ed=max_ed, I=I)


# --------------------------------------------------------------------------
# one-sided banded edit DP, per-item band width (align.cpp:219-252)
# --------------------------------------------------------------------------

def one_side_scan_ref(s: jnp.ndarray, t: jnp.ndarray, n: jnp.ndarray,
                      m: jnp.ndarray, wv: jnp.ndarray, *,
                      I: int) -> jnp.ndarray:
    """Batched global_one_side_banded_alignment: band j - i in [0, w],
    boundary dp[0][j] = j (j <= w), returns dp[n][m] (POS = DPTINF when the
    band never reaches (n, m)).  w is per-item (the middle-gap |diff|).
    Valid when n > w and m > w; callers route the rest to the oracle."""
    B = s.shape[0]
    s_pad = jnp.pad(s, ((0, 0), (0, I - s.shape[1]))).astype(jnp.int8)
    t_pad = jnp.pad(t, ((0, 0), (0, I - t.shape[1]))).astype(jnp.int8)
    t_rev = t_pad[:, ::-1]
    i_vec = jax.lax.broadcasted_iota(jnp.int32, (B, I), 1)

    d2 = jnp.where(i_vec == 0, 0, POS)                       # (0, 0)
    d1 = jnp.where((i_vec == 0) & (wv[:, None] >= 1)
                   & (m[:, None] >= 1), 1, POS)              # (0, 1) only
    out = jnp.full((B,), POS, jnp.int32)
    out = jnp.where((n == 0) & (m == 0), 0, out)
    out = jnp.where((n + m == 1) & (n == 0) & (wv >= 1) & (m == 1), 1, out)

    def step(carry, k):
        d2, d1, out = carry
        mis = _diff_diag(s_pad, t_rev, k, I).astype(jnp.int32)
        diag = jnp.roll(d2, 1, axis=1) + mis
        up = jnp.roll(d1, 1, axis=1) + 1
        left = d1 + 1
        dp = jnp.minimum(diag, jnp.minimum(up, left))
        j_vec = k - i_vec
        dp = jnp.where((i_vec == 0) & (j_vec >= 0)
                       & (j_vec <= jnp.minimum(wv, m)[:, None]), j_vec, dp)
        valid = ((i_vec >= 0) & (i_vec <= n[:, None]) & (j_vec >= i_vec)
                 & (j_vec <= jnp.minimum(i_vec + wv[:, None], m[:, None])))
        dp = jnp.where(valid, dp, POS)
        hit = (k == n + m)
        val = jnp.max(jnp.where(i_vec == n[:, None], dp, -1), axis=1)
        out = jnp.where(hit, val, out)
        return (d1, dp, out), None

    ks = jnp.arange(2, 2 * I, dtype=jnp.int32)
    (d2, d1, out), _ = jax.lax.scan(step, (d2, d1, out), ks)
    return out


@partial(jax.jit, static_argnames=("I",))
def one_side_batch_ref(s, t, n, m, wv, *, I: int = 128):
    return one_side_scan_ref(s, t, n, m, wv, I=I)


# --------------------------------------------------------------------------
# fused whole-wave dispatch: every kernel family over one packed buffer
# --------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("w", "max_ed", "max_sc", "mat", "mis",
                                   "ind", "xd", "I"))
def wave_all_batch_ref(s, t, n, m, wv, *, w, max_ed, max_sc, mat, mis, ind,
                       xd, I: int = 128):
    """One dispatch for a whole mixed-kind wave: runs all four DP families
    (edit+soft-clip, X-drop, edit-to-end, one-sided) over the packed
    [B, I-1] buffers and returns ONE int32 [B, 10] tensor

        [e_ed, e_sclen, e_indel, e_score, x_score, x_on_s, x_on_t,
         n_ed, n_indel, o_ed]

    so the whole wave costs a single d2h fetch.  Each row's caller
    reads only its own kind's columns; the other columns are don't-care."""
    e_ed, e_sc, e_in, e_scr = edit_sc_batch_ref(
        s, t, n, m, w=w, max_ed=max_ed, max_sc=max_sc, I=I)
    x_scr, x_on_s, x_on_t = xdrop_batch_ref(
        s, t, n, m, w=w, mat=mat, mis=mis, ind=ind, xd=xd, I=I)
    n_ed, n_in = edit_end_scan_ref(s, t, n, m, w=w, max_ed=max_ed, I=I)
    o_ed = one_side_scan_ref(s, t, n, m, wv, I=I)
    return jnp.stack([e_ed, e_sc, e_in, e_scr, x_scr, x_on_s, x_on_t,
                      n_ed, n_in, o_ed], axis=1)


# --------------------------------------------------------------------------
# the wave service
# --------------------------------------------------------------------------

class DeviceAlignService:
    """Answers alignment-request waves with batched device dispatches.

    ``solve`` (scalar) delegates to the inline host service — used for the
    rare host-fallback shapes and by sequential drivers.  ``solve_batch``
    groups a wave by kind and runs one device dispatch per kind (chunked at
    a single fixed row count B so each kernel compiles exactly once)."""

    I = 128   # padded DP extent; covers reads <= 120 + band
    B = 1024  # fixed dispatch rows (shorter waves pad, longer ones chunk)

    def __init__(self, cfg, sm: al.ScoreMat = None):
        from ..pipeline.extend import InlineAlignService
        self.cfg = cfg
        self.sm = sm if sm is not None else al.ScoreMat()
        self.inline = InlineAlignService(cfg, self.sm)
        self.n_dispatch = 0
        self.n_device = 0
        self.n_host = 0

    def solve(self, req):
        return self.inline.solve(req)

    def solve_batch(self, reqs: List[tuple]) -> List[tuple]:
        """Answer one mixed-kind wave with ONE fused device dispatch per
        B-row chunk (wave_all_batch_ref) and ONE [B, 10] int32 fetch —
        out-of-regime shapes go to the scalar host aligner as before."""
        out = [None] * len(reqs)
        dev = []
        for idx, r in enumerate(reqs):
            if self._in_regime(r):
                dev.append(idx)
            else:
                out[idx] = self.inline.solve(r)
        self.n_host += len(reqs) - len(dev)
        self.n_device += len(dev)
        c, sm = self.cfg, self.sm
        for chunk in self._chunks(dev):
            B = self.B
            s_buf = np.zeros((B, self.I - 1), np.int8)
            t_buf = np.zeros((B, self.I - 1), np.int8)
            n = np.zeros(B, np.int32)
            m = np.zeros(B, np.int32)
            wv = np.zeros(B, np.int32)
            kinds: List[str] = []
            for r_i, idx in enumerate(chunk):
                req = reqs[idx]
                kind = req[0]
                s, t = req[1], req[2]
                if kind in ("edit_sc_l", "drop_sc_l", "end_l"):
                    s, t = s[::-1], t[::-1]
                if kind == "one_side":
                    wv[r_i] = req[3]
                n[r_i], m[r_i] = len(s), len(t)
                s_buf[r_i, :len(s)] = s
                t_buf[r_i, :len(t)] = t
                kinds.append(kind)
            blob = np.asarray(wave_all_batch_ref(
                jnp.asarray(s_buf), jnp.asarray(t_buf), jnp.asarray(n),
                jnp.asarray(m), jnp.asarray(wv), w=c.band_width,
                max_ed=c.max_ed, max_sc=c.max_sc, mat=sm.mat, mis=sm.mis,
                ind=sm.ind, xd=sm.xd, I=self.I))
            self.n_dispatch += 1
            # X-drop wrap-up arithmetic, vectorized per side
            drop_res = {}
            for side, left in (("drop_sc_r", False), ("drop_sc_l", True)):
                rows = [r_i for r_i, k in enumerate(kinds) if k == side]
                if not rows:
                    continue
                rr = np.array(rows)
                ed, sclen, indel, scr = drop_local_sc_batch(
                    blob[rr, 4], blob[rr, 5], blob[rr, 6], m[rr],
                    mat=sm.mat, mis=sm.mis, w=c.band_width, max_ed=c.max_ed,
                    max_sc=c.max_sc, left=left)
                for j, r_i in enumerate(rows):
                    drop_res[r_i] = (int(ed[j]), int(sclen[j]),
                                     int(indel[j]), int(scr[j]))
            for r_i, idx in enumerate(chunk):
                k = kinds[r_i]
                row = blob[r_i]
                if k in ("edit_sc_r", "edit_sc_l"):
                    out[idx] = (int(row[0]), int(row[1]), int(row[2]),
                                int(row[3]))
                elif k in ("drop_sc_r", "drop_sc_l"):
                    out[idx] = drop_res[r_i]
                elif k in ("end_r", "end_l"):
                    out[idx] = (int(row[7]), int(row[8]), -int(row[7]))
                else:  # one_side
                    out[idx] = int(row[9])
        return out

    def _in_regime(self, req) -> bool:
        """True when the request's shapes fall inside the fused kernels'
        banded regime; outside it the oracle falls back to full DP
        (align.cpp:397-399) and the scalar host aligner answers."""
        kind, s, t = req[0], req[1], req[2]
        if len(s) >= self.I or len(t) >= self.I:
            return False
        w = self.cfg.band_width
        if kind in ("edit_sc_r", "edit_sc_l", "end_r", "end_l"):
            return len(s) > 2 * w and len(t) > w
        if kind in ("drop_sc_r", "drop_sc_l"):
            return True
        if kind == "one_side":
            ws = req[3]
            return ws >= 0 and len(s) > ws and len(t) > ws
        raise ValueError(f"unknown align request kind {kind!r}")

    # ---- helpers ----
    def _chunks(self, idxs):
        for c0 in range(0, len(idxs), self.B):
            yield idxs[c0:c0 + self.B]

    def warm(self):
        """Compile every kernel at the fixed dispatch shape (one compile
        each) so no compile lands inside the streamed region.  Warm
        sequences are length I-1 so every kind stays in the device regime
        (len > 2*band_width) for any valid band width."""
        o = np.ones(self.I - 1, np.int8)
        reqs = [(k, o, o) for k in ("edit_sc_r", "edit_sc_l", "drop_sc_r",
                                    "drop_sc_l", "end_r", "end_l")]
        reqs.append(("one_side", o, o, 1))
        self.solve_batch(reqs)
