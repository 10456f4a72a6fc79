"""Fused on-device mapping finish (the ``device-full`` executor).

One jitted program runs seed lookup -> gather -> chain DP -> k-best
extraction -> chain pairing -> extension -> the category decision lattice,
and the ONLY d2h payload is the final MatchedRead state ([B, 21] int32,
84 B/pair) — the batched inversion of src/filter.cpp:124-395 +
src/extend.cpp:37-432 + src/utils.cpp:22-320 where the reference walks one
read at a time through pointer-linked state.

Scope and exactness: rows whose work fits the fixed structural budget are
finished on-device with results bit-identical to the host pipeline (pinned
by tests/test_device_full.py); everything else raises a per-read DEFER bit
and is replayed through the host C++ path, so the overall output is always
bit-exact.  Multi-exon extension walks (extend.cpp:491-650/708-875) run on
device through the speculative walk engine (ops/device_walk.py).  Deferred
shapes: seed occupancy > cap, > KB chains, > P_MAX candidate mate-pairs,
walks exceeding the engine's wave/scan/pool budgets, calc_tlen walks
longer than W_MAX intervals, padded annotation overflows, leftover-
extension reads whose pair sets were mis-predicted, and DP pool overflows.

Extension DPs are *compacted*: every potential DP site (middle-gap
one-sided DPs, per-chain end/genomic X-drop DPs) is a fixed slot; active
slots are packed into one pool per kernel family and solved in a single
batched dispatch (ops/wavefront.py scan DPs), then scattered back.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (CONCRD, DISCRD, CHIORF, CHIBSJ, CHI2BSJ, CONGEN,
                      CHIFUS, CONGNM, OEA2, CANDID, OEANCH, ORPHAN,
                      NOPROC_MANYHIT, NOPROC_NOMATCH, INF, MAXDISCRDTLEN,
                      LARIAT2BEGTH)
from .wavefront import POS, xdrop_batch_ref
from .align_device import one_side_scan_ref

NEG_SCORE = -INF


# --------------------------------------------------------------------------
# small device helpers
# --------------------------------------------------------------------------

def _bisect_le(sorted_arr, x):
    """index of last element <= x (or -1); sorted_arr int32 [N], x [...].
    Runs on the FLATTENED probe vector."""
    shp = x.shape
    x = x.reshape(-1)
    n = sorted_arr.shape[0]
    lo = jnp.zeros_like(x)
    hi = jnp.full_like(x, n)
    steps = int(np.ceil(np.log2(max(2, n + 1)))) + 1
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        go_right = sorted_arr[jnp.clip(mid, 0, n - 1)] <= x
        lo = jnp.where(active & go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
    return (lo - 1).reshape(shp)


def _overlap_ind(ad, fa, pos):
    """get_location_overlap_ind (annotation.py:273-291): returns
    (iv or -1, raw ind).  iv == -1 also when the seg list is empty."""
    n_iv = ad.iv_spos.shape[0]
    raw = _bisect_le(ad.iv_spos, pos)
    c = jnp.clip(raw, 0, n_iv - 1)
    ok = (raw >= 0) & (ad.iv_epos[c] >= pos) & (fa.iv_nseg_true[c] > 0)
    return jnp.where(ok, raw, -1), raw


def _bit(bits, pos):
    p = jnp.clip(pos, 0, bits.shape[0] * 8 - 1)
    return ((bits[p >> 3] >> (p & 7).astype(jnp.uint8)) & 1).astype(
        jnp.bool_)


def _gather_window(codes, start0, length, width, reverse=False):
    """codes int8 [G]; start0 int32 [...](0-based), length [...].
    Returns int8 [..., width] (0 beyond length; 127 pad out of bounds so
    padding never equals a real base).  reverse=True yields the window
    reversed (for *_l request kinds)."""
    G = codes.shape[0]
    io = jnp.arange(width, dtype=jnp.int32)
    if reverse:
        idx = start0[..., None] + (length[..., None] - 1 - io)
    else:
        idx = start0[..., None] + io
    inside = (io < length[..., None]) & (idx >= 0) & (idx < G)
    return jnp.where(inside, codes[jnp.clip(idx, 0, G - 1)],
                     jnp.int8(127)).astype(jnp.int8)


def _tiny_global(s, t, n, m, NMAX, MMAX):
    """Full (unbanded) edit DP for tiny shapes (the oracle's n <= w
    fallback, ops/align.py:112-114).  s [B, NMAX], t [B, MMAX]."""
    B = s.shape[0]
    j_io = jnp.arange(MMAX + 1, dtype=jnp.int32)[None, :]
    row = jnp.where(j_io <= m[:, None],
                    jnp.broadcast_to(j_io, (B, MMAX + 1)), POS)  # dp[0][j]
    for i in range(1, NMAX + 1):
        si = s[:, i - 1]
        prev = row
        cols = [jnp.where(i <= n, jnp.int32(i), POS)]            # dp[i][0]
        for j in range(1, MMAX + 1):
            tj = t[:, j - 1]
            mis = ((si != tj) | (si >= 4) | (tj >= 4)).astype(jnp.int32)
            v = jnp.minimum(prev[:, j - 1] + mis,
                            jnp.minimum(prev[:, j] + 1, cols[j - 1] + 1))
            v = jnp.where((i <= n) & (j <= m), v, POS)
            cols.append(v)
        new = jnp.stack(cols, axis=1)
        row = jnp.where((i <= n)[:, None], new, row)
    out = jnp.take_along_axis(row, jnp.clip(m, 0, MMAX)[:, None],
                              axis=1)[:, 0]
    return out


def _one_side_pool(s, t, n, m, wv, I):
    """Exact global_one_side_banded_alignment over a packed pool,
    covering every shape the oracle covers (align.py:108-125):
      n > w  -> one-sided banded scan kernel,
      n <= w -> full tiny DP (w <= 3, m = n + w <= n + 3)."""
    banded = one_side_scan_ref(s, t, n, m, wv, I=I)
    TN, TM = 4, 8
    tiny = _tiny_global(s[:, :TN], t[:, :TM], jnp.minimum(n, TN),
                        jnp.minimum(m, TM), TN, TM)
    use_tiny = n <= wv
    return jnp.where(use_tiny, tiny, banded)


def _drop_wrap(score, on_s, on_t, m, *, mat, mis, w, max_ed, max_sc, left):
    """jnp port of wavefront.drop_local_sc_batch (align.cpp:669-723)."""
    mx = jnp.maximum(on_s, on_t)
    ed = (mat * mx - score) // (mat - mis)
    indel = on_t - on_s
    clip = m - on_t
    ok = ed <= max_ed
    if not left:
        ok = ok & (score >= 0)
    out_ed = jnp.where(ok, ed, max_ed + 1)
    out_sclen = jnp.where(ok, clip, jnp.maximum(max_sc, m) + 1)
    out_indel = jnp.where(ok, indel, w + 1)
    return out_ed, out_sclen, out_indel, score


def _compact(active_flat, limit):
    """active [S] bool -> (pool->flat gather index [limit], n_active,
    overflow flat mask [S]).  Pool rows >= n_active gather an arbitrary
    valid slot (garbage rows) — callers must scatter results back through
    `_scatter_pool` which dumps them.

    Built WITHOUT an S-sized scatter (a [S]-index scatter per pool per
    wave would sit inside every walk-engine wave) — pool slot j is the
    first flat
    position where the active-rank cumsum reaches j+1, a searchsorted
    probe over the sorted cumsum."""
    S = active_flat.shape[0]
    rank1 = jnp.cumsum(active_flat.astype(jnp.int32))   # 1-based at active
    n_active = jnp.minimum(rank1[-1], limit)
    inv = jnp.searchsorted(
        rank1, jnp.arange(1, limit + 1, dtype=jnp.int32),
        side="left").astype(jnp.int32)
    inv = jnp.minimum(inv, S - 1)
    over = active_flat & (rank1 > limit)
    return inv, n_active, over


def _scatter_pool(vals, inv, n_active, flat_size):
    """Scatter pool results back to flat slots; rows >= n_active dumped."""
    limit = inv.shape[0]
    safe = jnp.where(jnp.arange(limit) < n_active, inv, flat_size)
    out = jnp.zeros((flat_size + 1,), vals.dtype).at[safe].set(vals)
    return out[:flat_size]


# --------------------------------------------------------------------------
# AlignRes algebra (extend.py:123-187) in struct-of-arrays form
# --------------------------------------------------------------------------

def _ares(pos, ed, sclen, indel, qcov, score):
    return dict(pos=pos, ed=ed, sclen=sclen, indel=indel, qcov=qcov,
                score=score)


def _ares_where(c, a, b):
    return {k: jnp.where(c, a[k], b[k]) for k in a}


def _upd_by_score(best, cand, left: bool):
    """update_by_score_right/left (extend.py:152-160): returns
    (updated_best, did_update)."""
    if left:
        better = (best["score"] < cand["score"]) | (
            (best["score"] == cand["score"]) & (cand["pos"] > best["pos"]))
    else:
        better = (best["score"] < cand["score"]) | (
            (best["score"] == cand["score"]) & (cand["pos"] < best["pos"]))
    return _ares_where(better, cand, best), better


# --------------------------------------------------------------------------
# one-sided extension core (extend.py extend_left_g/extend_right_g, simple
# scope: zero-or-one interval walk + genomic fallback; multi-exon -> defer)
# --------------------------------------------------------------------------

def _extend_core(pos, length, ed_th, bound, has_tids, iv_ok, exon_len,
                 walk_dp, walk_ok, gen_dp, gen_ok, *, left: bool,
                 max_sc: int, band: int, eng=None):
    """All inputs [N] vectors; *_dp dicts with ed/sclen/indel/score.
    walk_ok/gen_ok: the DP ran (window in genome bounds).
    Returns (ok, new_pos, best, defer).

    Mirrors extend.cpp:285-432.  The covered-first-interval regime (the
    anchor exon covers the whole remain window: every common tid's walk
    breaks immediately into the same end DP, so one pooled DP serves all
    tids) is handled inline; genuine multi-exon walks arrive through
    ``eng`` — the device walk engine's folded result (ops/device_walk.py)
    with ``active``/``best``/``consec``/``defer`` fields.  With eng=None
    (the leftover chain-level extends, which pass no transcripts) those
    lanes defer.  `bound` is lb (left) / ub (right)."""
    orig = pos
    best = _ares(pos, ed_th + 1, length + 1,
                 jnp.full_like(pos, band + 1), jnp.zeros_like(pos),
                 jnp.zeros_like(pos))
    covered = iv_ok & (exon_len >= length)
    walk_active = has_tids & iv_ok & (length > 0)
    if eng is None:
        defer = walk_active & ~covered
    else:
        defer = eng["active"] & eng["defer"]
    # gate (extend.cpp:403/510): bound check decides walk DP vs fallback
    if left:
        gate_ok = pos >= bound + length
    else:
        gate_ok = pos + length <= bound
    do_walk = walk_active & covered & gate_ok
    consecutive = do_walk
    # walk end-DP acceptance (_extend_*_end_g, curr.ed = 0)
    w_gate = do_walk & walk_ok & (walk_dp["ed"] <= ed_th) \
        & (walk_dp["sclen"] <= max_sc) \
        & ((length - walk_dp["sclen"]) >= walk_dp["sclen"])
    if left:
        new_p = pos - length + walk_dp["indel"]
    else:
        new_p = pos + length - walk_dp["indel"]
    curr = _ares(new_p, walk_dp["ed"], walk_dp["sclen"], walk_dp["indel"],
                 jnp.where(w_gate, length, 0), walk_dp["score"])
    upd, _ = _upd_by_score(best, curr, left)
    best = _ares_where(w_gate, upd, best)
    if eng is not None:
        ea = eng["active"]
        best = _ares_where(ea, eng["best"], best)
        consecutive = consecutive | (ea & eng["consec"])

    done = jnp.zeros_like(pos, dtype=jnp.bool_)
    ok_out = jnp.zeros_like(done)
    pos_out = orig

    # wrap-up stage 1 (extend.cpp:316-324)
    st1 = best["ed"] <= ed_th
    if left:
        p1 = best["pos"] + best["sclen"]
    else:
        p1 = best["pos"] - best["sclen"]
    pos_out = jnp.where(st1, p1, pos_out)
    ret1 = st1 & (best["qcov"] >= length) & (best["sclen"] <= max_sc)
    ok_out = jnp.where(ret1, True, ok_out)
    done = done | ret1

    # intron retention / plain genomic (extend.cpp:326-341)
    g_try = ~done & ~consecutive & gen_ok & (length > 0)
    g_gate = g_try & (gen_dp["ed"] <= ed_th) & (gen_dp["sclen"] <= max_sc)
    if left:
        gp = orig - length + gen_dp["indel"]
    else:
        gp = orig + length - gen_dp["indel"]
    cur2 = _ares(gp, gen_dp["ed"], gen_dp["sclen"], gen_dp["indel"],
                 jnp.where(g_gate, length, 0), gen_dp["score"])
    upd2, took2 = _upd_by_score(best, cur2, left)
    g_hit = g_gate & took2
    best = _ares_where(g_hit, upd2, best)
    if left:
        gpos = orig - length + gen_dp["indel"] + gen_dp["sclen"]
    else:
        gpos = orig + length - gen_dp["indel"] - gen_dp["sclen"]
    pos_out = jnp.where(g_hit, gpos, pos_out)
    ok_out = jnp.where(g_hit, True, ok_out)
    done = done | g_hit

    # tail wrap-up (extend.cpp:343-356)
    z = ~done & (best["qcov"] <= 0)
    pos_out = jnp.where(z, orig, pos_out)
    best = _ares_where(z, _ares(pos_out, jnp.zeros_like(pos),
                                jnp.zeros_like(pos), jnp.zeros_like(pos),
                                jnp.zeros_like(pos),
                                jnp.full_like(pos, NEG_SCORE)), best)
    qrem = length - best["qcov"]
    sc_fit = ~done & (qrem + best["sclen"] <= max_sc)
    best = _ares_where(
        sc_fit, _ares(pos_out, best["ed"], best["sclen"] + qrem,
                      best["indel"], length + 0 * pos, best["score"]), best)
    ok_out = jnp.where(sc_fit, True, ok_out)
    done = done | sc_fit
    last = ~done
    ok_out = jnp.where(last, (best["qcov"] >= length)
                       & (best["ed"] <= ed_th), ok_out)
    # remain == 0: untouched best, ok (extend.py:637,666)
    triv = length <= 0
    ok_out = jnp.where(triv, True, ok_out)
    pos_out = jnp.where(triv, orig, pos_out)
    best = _ares_where(triv, _ares(orig * 0 + bound, jnp.zeros_like(pos),
                                   jnp.zeros_like(pos), jnp.zeros_like(pos),
                                   jnp.zeros_like(pos),
                                   jnp.full_like(pos, NEG_SCORE)), best)
    defer = defer & (length > 0)
    return ok_out, pos_out, best, defer


def _extend_core_flat(pos, length, ed_th, bound, has_tids, iv_ok, exon_len,
                      walk_dp, walk_ok, gen_dp, gen_ok, eng=None, **kw):
    """_extend_core on FLATTENED operands: the core is pure elementwise,
    so it runs on 1-D operands instead of [B, 4, 7] / [B, 2, 8] shapes
    with small minor dims."""
    shp = pos.shape

    def f(x):
        return x.reshape(-1)

    def fd(d):
        return {kk: v.reshape(-1) for kk, v in d.items()}

    if eng is not None:
        eng = dict(active=f(eng["active"]), best=fd(eng["best"]),
                   consec=f(eng["consec"]), defer=f(eng["defer"]))
    ok, p, best, df = _extend_core(f(pos), f(length), f(ed_th), f(bound),
                                   f(has_tids), f(iv_ok), f(exon_len),
                                   fd(walk_dp), f(walk_ok), fd(gen_dp),
                                   f(gen_ok), eng=eng, **kw)
    return (ok.reshape(shp), p.reshape(shp),
            {kk: v.reshape(shp) for kk, v in best.items()},
            df.reshape(shp))


# --------------------------------------------------------------------------
# mr-state algebra (types.py MatchedRead.update / go_for_update)
# --------------------------------------------------------------------------

MRF = 20  # field count, layout = ops/filter_native.py MR_FIELDS

# defer-cause bits: the fused step returns an int32 bitmask per read
# (0 = finished on device); the pipeline histograms them so budget
# widening targets the causes that actually fire
DEF_OCC = 1 << 0        # seed occupancy > cap
DEF_EXTRACT = 1 << 1    # k-best extraction incomplete (> EX_ITERS events)
DEF_NCHAIN = 1 << 2     # more chains than KB budget
DEF_OSPOOL = 1 << 3     # one-sided DP pool overflow
DEF_XDPOOL = 1 << 4     # x-drop DP pool overflow
DEF_PANNO = 1 << 5      # annotation padding overflow on pair intervals
DEF_UNION = 1 << 6      # candidate pair count > P_MAX
DEF_EXTWALK = 1 << 7    # multi-exon extension walk
DEF_MMANNO = 1 << 8     # annotation padding overflow on final coords
DEF_SCTIE = 1 << 9      # orientation score tie (f64 hazard)
DEF_TLENWALK = 1 << 10  # calc_tlen walk > W_MAX intervals
DEF_CTPOOL = 1 << 11    # calc_tlen pool overflow

DEFER_CAUSES = ["occ", "extract", "nchain", "ospool", "xdpool", "panno",
                "union", "extwalk", "mmanno", "sctie", "tlenwalk",
                "ctpool"]


def _mm_ed(mm):
    return mm["led"] + mm["med"] + mm["red"]


def _go_for_update(mr, sm, lm, tlen, gm, type_, *, bsj_order):
    """common.cpp:362-411; mr dict of [B] vectors."""
    ed = _mm_ed(sm) + _mm_ed(lm)
    mlen = sm["mlen"] + lm["mlen"]
    mr_ed = mr["ed_r1"] + mr["ed_r2"]
    mr_ml = mr["mlen_r1"] + mr["mlen_r2"]
    lt = type_ < mr["type"]
    gt = type_ > mr["type"]
    eq = ~lt & ~gt
    gm_win = gm & ~mr["gm"]
    gm_lose = ~gm & mr["gm"]
    if bsj_order:   # type_ >= CHIBSJ: mlen first, then ed
        k1_win = mr_ml < mlen
        k1_lose = mr_ml > mlen
        k2_win = mr_ed > ed
        rest = k1_win | (~k1_lose & k2_win)
    else:
        k1_win = mr_ed > ed
        k1_lose = mr_ed < ed
        k2_win = mr["tlen"] > tlen
        k2_lose = mr["tlen"] < tlen
        k3_win = mr_ml < mlen
        rest = k1_win | (~k1_lose & (k2_win | (~k2_lose & k3_win)))
    return lt | (eq & (gm_win | (~gm_win & ~gm_lose & rest)))


def _mr_update(mr, sm, lm, chr_idx, shift, tlen, jun, gm, type_, r1_sm,
               contig_num, apply_mask):
    """common.cpp:286-351: conditional best-mapping update."""
    bsj = _go_for_update(mr, sm, lm, tlen, gm, type_, bsj_order=True)
    lin = _go_for_update(mr, sm, lm, tlen, gm, type_, bsj_order=False)
    go = jnp.where(type_ >= CHIBSJ, bsj, lin) & apply_mask
    a = {k: jnp.where(r1_sm, sm[k], lm[k]) for k in sm}
    b = {k: jnp.where(r1_sm, lm[k], sm[k]) for k in sm}
    new = dict(mr)
    new["type"] = type_
    new["chr"] = chr_idx
    new["spos_r1"] = a["spos"] - shift
    new["epos_r1"] = a["epos"] - shift
    new["qspos_r1"] = a["qspos"]
    new["qepos_r1"] = a["qepos"]
    new["mlen_r1"] = a["mlen"]
    new["ed_r1"] = _mm_ed(a)
    new["spos_r2"] = b["spos"] - shift
    new["epos_r2"] = b["epos"] - shift
    new["qspos_r2"] = b["qspos"]
    new["qepos_r2"] = b["qepos"]
    new["mlen_r2"] = b["mlen"]
    new["ed_r2"] = _mm_ed(b)
    new["r1_fwd"] = (a["dir"] > 0).astype(jnp.int32)
    new["r2_fwd"] = (b["dir"] > 0).astype(jnp.int32)
    new["tlen"] = tlen
    new["junc"] = jun
    new["gm"] = gm.astype(jnp.int32)
    new["contig"] = jnp.full_like(mr["contig"], contig_num)
    return {k: jnp.where(go, new[k], mr[k]) for k in mr}, go


def _mr_update_type(mr, type_, apply_mask):
    go = (type_ < mr["type"]) & apply_mask
    out = dict(mr)
    out["type"] = jnp.where(go, type_, mr["type"])
    return out


# --------------------------------------------------------------------------
# annotation relations on padded device arrays (utils.cpp:322-664)
# --------------------------------------------------------------------------

# annotation relations: row-major trailing [SP/ST] broadcast form.
# A lane-major rewrite ([SP, SP, N] with flat N minor) measured
# 4x SLOWER on chip (bisect r4e/r4f: phase2 +0.33 s -> +1.33 s)
# despite dense lanes - the per-call [N, 16] -> [16, N] transposes
# and reshapes outweigh the tile padding they avoid at these
# trailing-dim sizes, so the original form stands.

def _tids_intersect(fa, iv_a, iv_b):
    """same_transcript2 non-emptiness: any shared tid (order-free)."""
    ok = (iv_a >= 0) & (iv_b >= 0)
    ta = fa.iv_tids[jnp.clip(iv_a, 0, fa.iv_tids.shape[0] - 1)]
    tb = fa.iv_tids[jnp.clip(iv_b, 0, fa.iv_tids.shape[0] - 1)]
    eq = (ta[..., :, None] == tb[..., None, :]) & (ta[..., :, None] >= 0)
    return ok & jnp.any(eq, axis=(-2, -1))


def _same_gene_span(ad, fa, iv, s, e):
    """utils.cpp:617-627: [s, e] inside any gene of iv's seg list."""
    ok = iv >= 0
    ivc = jnp.clip(iv, 0, fa.seg_gene_p.shape[0] - 1)
    g = fa.seg_gene_p[ivc]                               # [..., SP]
    nseg = ad.iv_nseg[ivc]
    pv = (jnp.arange(g.shape[-1])[None, :] * jnp.ones_like(g)
          < nseg[..., None]) & (g >= 0)
    gs = fa.gene_start[jnp.clip(g, 0, fa.gene_start.shape[0] - 1)]
    ge = fa.gene_end[jnp.clip(g, 0, fa.gene_end.shape[0] - 1)]
    hit = pv & (gs <= s[..., None]) & (e[..., None] <= ge)
    return ok & jnp.any(hit, axis=-1)


def _same_gene_iv(ad, fa, iv_a, iv_b):
    """utils.cpp:605-615: shared gene id between two interval seg lists."""
    ok = (iv_a >= 0) & (iv_b >= 0)
    ca = jnp.clip(iv_a, 0, fa.seg_gene_p.shape[0] - 1)
    cb = jnp.clip(iv_b, 0, fa.seg_gene_p.shape[0] - 1)
    ga = fa.seg_gene_p[ca]
    gb = fa.seg_gene_p[cb]
    pa = (jnp.arange(ga.shape[-1])[None, :] * jnp.ones_like(ga)
          < ad.iv_nseg[ca][..., None]) & (ga >= 0)
    pb = (jnp.arange(gb.shape[-1])[None, :] * jnp.ones_like(gb)
          < ad.iv_nseg[cb][..., None]) & (gb >= 0)
    eq = (ga[..., :, None] == gb[..., None, :]) & pa[..., :, None] \
        & pb[..., None, :]
    return ok & jnp.any(eq, axis=(-2, -1))


def _same_exon(ad, fa, iv_a, iv_b):
    """Identical (start, end) seg across the two lists (common.cpp:128)."""
    ok = (iv_a >= 0) & (iv_b >= 0)
    ca = jnp.clip(iv_a, 0, fa.seg_start_p.shape[0] - 1)
    cb = jnp.clip(iv_b, 0, fa.seg_start_p.shape[0] - 1)
    sa, ea = fa.seg_start_p[ca], ad.seg_end[ca]
    sb, eb = fa.seg_start_p[cb], ad.seg_end[cb]
    pa = (jnp.arange(sa.shape[-1])[None, :] * jnp.ones_like(sa)
          < ad.iv_nseg[ca][..., None])
    pb = (jnp.arange(sb.shape[-1])[None, :] * jnp.ones_like(sb)
          < ad.iv_nseg[cb][..., None])
    eq = ((sa[..., :, None] == sb[..., None, :])
          & (ea[..., :, None] == eb[..., None, :])
          & pa[..., :, None] & pb[..., None, :])
    return ok & jnp.any(eq, axis=(-2, -1))


def _calc_tlen(ad, fa, sm_iv_e, sm_ind_e, sm_epos, sm_mlen,
               lm_iv_s, lm_ind_s, lm_spos, lm_mlen, *, W_MAX: int):
    """utils.cpp:53-113 over [B] vectors.  Returns (tlen, intron_num,
    defer) — defer when a walk exceeds W_MAX intervals.

    Fully vectorized lane-major: all ST candidate transcripts and all
    W_MAX walk steps evaluate in one [ST, W_MAX, B] pass (the fori x fori
    formulation ran ST*W_MAX = 256 serial gather steps per call).  The
    first-transcript-wins minimum is reproduced with a first-occurrence
    argmin (strict < in the sequential fold keeps the earliest tt)."""
    NIV = ad.iv_spos.shape[0]
    ST = fa.iv_tids.shape[1]
    NT = fa.trans_start.shape[0]
    NS = fa.t2s_state.shape[0]
    ivc = jnp.clip(sm_iv_e, 0, NIV - 1)
    tids_T = fa.iv_tids[ivc].T                            # [ST, B]
    defer0 = (sm_iv_e >= 0) & (fa.iv_ntid[ivc] > ST)

    tc = jnp.clip(tids_T, 0, NT - 1)
    act = (sm_iv_e[None, :] >= 0) & (tids_T >= 0)
    start_ind = fa.trans_start[tc]                        # [ST, B]
    start_ti = sm_ind_e[None, :] - start_ind
    off = fa.t2s_off[tc]
    t2s_len = fa.t2s_off[tc + 1] - off
    end_ti = lm_ind_s[None, :] - start_ind
    st_end = jnp.where((end_ti >= 0) & (end_ti < t2s_len),
                       fa.t2s_state[jnp.clip(off + end_ti, 0, NS - 1)], 0)
    act = act & (start_ti >= 0) & (lm_ind_s[None, :] >= start_ind) \
        & (end_ti < t2s_len) & (st_end != 0)
    same_iv = start_ti == end_ti
    tl_same = (lm_spos - sm_epos + 1)[None, :]
    nsteps = end_ti - start_ti - 1
    defer = defer0 | jnp.any(act & ~same_iv & (nsteps > W_MAX), axis=0)

    # the walk start_ti+1 .. end_ti-1 over [ST, W_MAX, B]; the visited
    # interval (and its length) depends only on kk, not on the transcript
    kk3 = jnp.arange(W_MAX, dtype=jnp.int32)[None, :, None]
    this_iv = jnp.clip(sm_ind_e[None, :] + 1
                       + kk3[0], 0, NIV - 1)              # [W, B]
    ivlen = ad.iv_epos[this_iv] - ad.iv_spos[this_iv] + 1
    on = act[:, None, :] & ~same_iv[:, None, :] & (kk3 < nsteps[:, None, :])
    row = start_ti[:, None, :] + 1 + kk3
    ok_row = on & (row >= 0) & (row < t2s_len[:, None, :])
    stt = jnp.where(ok_row,
                    fa.t2s_state[jnp.clip(off[:, None, :] + row, 0,
                                          NS - 1)], 0)    # [ST, W, B]
    has = on & (stt != 0)
    tl_walk = jnp.sum(jnp.where(has, ivlen[None, :, :], 0), axis=1)
    # intron count = number of zero-state runs in the active prefix
    z = on & (stt == 0)
    zprev = jnp.concatenate([jnp.zeros_like(z[:, :1, :]), z[:, :-1, :]],
                            axis=1)
    inn = jnp.sum((z & ~zprev).astype(jnp.int32), axis=1)  # [ST, B]

    tl0 = (ad.iv_epos[ivc] - sm_epos + 1)[None, :]
    lmc = jnp.clip(lm_iv_s, 0, NIV - 1)
    tl = tl0 + tl_walk + (lm_spos - ad.iv_spos[lmc] + 1)[None, :]
    tlen_t = jnp.where(same_iv, tl_same, tl)
    inn_t = jnp.where(same_iv, 0, inn)

    big = jnp.where(act, tlen_t, INF)
    min_tlen = jnp.min(big, axis=0)                       # [B]
    hit = act & (tlen_t == min_tlen[None, :]) & (min_tlen[None, :] < INF)
    iota_t = jnp.arange(ST, dtype=jnp.int32)[:, None]
    first = jnp.min(jnp.where(hit, iota_t, ST), axis=0)   # [B]
    best_in = jnp.sum(jnp.where(iota_t == first[None, :], inn_t, 0),
                      axis=0)
    found = min_tlen < INF
    tlen = jnp.where(found, min_tlen + sm_mlen - 1 + lm_mlen - 1, -1)
    return tlen, best_in, defer


# --------------------------------------------------------------------------
# the fused finish
# --------------------------------------------------------------------------

I32MAX = 2 ** 31 - 1  # device stand-in for MAXUB (positions < 2^31)


def _phase1(seqs, lens, hh, rp, qp, cl, sc10, cn, inc, mr_in,
            genome, ad, fa, *, k, max_ed, max_sc, band,
            KB, OS_POOL, XD_POOL, mat, mis, ind, xd, I=128):
    """Chain-level geometry + the two compacted DP pools.  Returns the
    staging dict consumed by the extension/fold phases."""
    R4, L = seqs.shape
    B = R4 // 4
    NL = rp.shape[2]
    NLm1 = NL - 1
    G = genome.shape[0]
    KB1 = cl.shape[1]          # KB + 1
    rp4 = rp.reshape(B, 4, KB1, NL)
    qp4 = qp.reshape(B, 4, KB1, NL)
    cl4 = cl.reshape(B, 4, KB1)
    sc4 = sc10.reshape(B, 4, KB1)
    cn4 = cn.reshape(B, 4)
    hh4 = hh.reshape(B, 4)
    lens4 = lens.reshape(B, 4)
    seqsf = seqs.reshape(-1)    # [4B * L]

    # defer is an int32 CAUSE BITMASK (see DEFER_CAUSES); nonzero ->
    # the read replays on the host path
    defer = (DEF_EXTRACT * inc.reshape(B, 4).any(axis=1)
             | DEF_NCHAIN * (cn4 > KB).any(axis=1)).astype(jnp.int32)

    # ---- chain-level geometry ----------------------------------------
    ci = jnp.arange(KB1)[None, None, :]
    valid = ci < cn4[:, :, None]                                # [B,4,KB1]
    clen = cl4
    q0 = qp4[..., 0]
    r0 = rp4[..., 0]
    last_i = jnp.clip(clen - 1, 0, NL - 1)
    lastq = jnp.take_along_axis(qp4, last_i[..., None], axis=-1)[..., 0]
    lastr = jnp.take_along_axis(rp4, last_i[..., None], axis=-1)[..., 0]
    remain_beg = q0
    remain_end = lens4[:, :, None] - (lastq + k)
    pos_l = r0
    pos_r = lastr + k - 1
    iv_l, _ = _overlap_ind(ad, fa, pos_l)
    iv_r, _ = _overlap_ind(ad, fa, pos_r)
    NIV = ad.iv_spos.shape[0]
    exon_len_l = jnp.where(iv_l >= 0,
                           pos_l - ad.iv_spos[jnp.clip(iv_l, 0, NIV - 1)], 0)
    exon_len_r = jnp.where(iv_r >= 0,
                           ad.iv_epos[jnp.clip(iv_r, 0, NIV - 1)] - pos_r, 0)
    genL_len = remain_beg + band
    genR_len = remain_end + band
    # genome.get bounds (1-based; extend.py:197-200)
    genL_inb = (pos_l - genL_len >= 1) & (pos_l - 1 <= G)
    genR_inb = (pos_r + 1 >= 1) & (pos_r + genR_len <= G)
    walkL_len = jnp.minimum(genL_len, exon_len_l)
    walkR_len = jnp.minimum(genR_len, exon_len_r)
    covered_l = (iv_l >= 0) & (exon_len_l >= remain_beg)
    covered_r = (iv_r >= 0) & (exon_len_r >= remain_end)
    wxL = covered_l & (walkL_len < genL_len) & (remain_beg > 0)
    wxR = covered_r & (walkR_len < genR_len) & (remain_end > 0)
    walkL_inb = (pos_l - walkL_len >= 1) & (pos_l - 1 <= G)
    walkR_inb = (pos_r + 1 >= 1) & (pos_r + walkR_len <= G)

    # ---- middle gaps: one-sided DPs (calc_middle_ed, extend.py:228-256)
    qn = qp4[..., 1:]
    rn = rp4[..., 1:]
    qprev = qp4[..., :NLm1]
    rprev = rp4[..., :NLm1]
    frag_ok = valid[..., None] & (jnp.arange(NLm1)[None, None, None, :]
                                  < (clen - 1)[..., None])
    gqlen = qn - (qprev + k)
    gdiff = (rn - rprev) - (qn - qprev)
    g_need = frag_ok & (gqlen > 0) & (jnp.abs(gdiff) <= band)
    grlen = jnp.maximum(gqlen + gdiff, 0)
    grs0 = rprev + k - 1                   # 0-based ref window start
    g_inb = (rprev + k >= 1) & (grs0 + grlen <= G)
    grlen_eff = jnp.where(g_inb, grlen, 0)
    gswap = gdiff < 0
    gw = jnp.abs(gdiff)
    gqs = qprev + k                        # in-row query offset
    # estimate_middle_error (utils.cpp:35-49)
    est_c = jnp.where(
        (gqlen > 0) & frag_ok,
        jnp.where(gdiff == 0, 1,
                  jnp.where((gdiff > 0) & (gdiff <= band), gdiff,
                            jnp.where((gdiff < 0) & (-gdiff <= band),
                                      -gdiff, 0))), 0)
    est_mid = est_c.sum(axis=-1)                                # [B,4,KB1]

    # one_side pool
    os_active = g_need.reshape(-1)
    os_inv, os_n, os_over = _compact(os_active, OS_POOL)
    defer = defer | DEF_OSPOOL * os_over.reshape(B, -1).any(axis=1)

    def flat_g(x):
        return x.reshape(-1)[os_inv]

    p_row = os_inv // (KB1 * NLm1)                 # row in [0, 4B)
    p_qs = flat_g(gqs)
    p_qlen = flat_g(gqlen)
    p_rs0 = flat_g(grs0)
    p_rlen = flat_g(grlen_eff)
    p_w = flat_g(gw)
    p_swap = flat_g(gswap)
    io = jnp.arange(I - 1, dtype=jnp.int32)
    qidx = p_row[:, None] * L + p_qs[:, None] + io[None, :]
    q_win = jnp.where(io[None, :] < p_qlen[:, None],
                      seqsf[jnp.clip(qidx, 0, R4 * L - 1)], jnp.int8(127))
    r_win = _gather_window(genome, p_rs0, p_rlen, I - 1)
    s_buf = jnp.where(p_swap[:, None], r_win, q_win)
    t_buf = jnp.where(p_swap[:, None], q_win, r_win)
    n_os = jnp.where(p_swap, p_rlen, p_qlen)
    m_os = jnp.where(p_swap, p_qlen, p_rlen)
    os_res_pool = _one_side_pool(s_buf, t_buf, n_os, m_os, p_w, I)
    gap_res = _scatter_pool(os_res_pool, os_inv, os_n,
                            B * 4 * KB1 * NLm1).reshape(B, 4, KB1, NLm1)
    contrib = jnp.where(g_need, gap_res, 0)
    csum = jnp.cumsum(contrib, axis=-1)
    exceeded = (csum > max_ed).any(axis=-1)
    mid_dp = jnp.where(exceeded, max_ed + 1,
                       jnp.minimum(csum[..., -1], max_ed + 1))
    mid_dp = jnp.where(clen > 0, mid_dp, 0)        # chain_len==0 -> 0

    # ---- end/genomic X-drop pool (extend.py:556-623 + wrappers) ------
    # slots [B,4,KB1,2(side: 0=left 1=right),2(var: 0=genomic 1=walk)]
    act_gl = valid & (remain_beg > 0) & genL_inb
    act_gr = valid & (remain_end > 0) & genR_inb
    act_wl = valid & wxL & walkL_inb
    act_wr = valid & wxR & walkR_inb
    xa = jnp.stack([jnp.stack([act_gl, act_wl], axis=-1),
                    jnp.stack([act_gr, act_wr], axis=-1)], axis=-2)
    # per-slot ref window (0-based start, len) and q window (row offset/len)
    rs0_l = jnp.stack([pos_l - genL_len - 1, pos_l - walkL_len - 1],
                      axis=-1)
    rlen_l = jnp.stack([genL_len, walkL_len], axis=-1)
    rs0_r = jnp.stack([pos_r, pos_r], axis=-1)
    rlen_r = jnp.stack([genR_len, walkR_len], axis=-1)
    x_rs0 = jnp.stack([rs0_l, rs0_r], axis=-2)
    x_rlen = jnp.stack([rlen_l, rlen_r], axis=-2)
    x_qs = jnp.stack([jnp.zeros_like(remain_beg),
                      lens4[:, :, None] - remain_end], axis=-1)
    x_qlen = jnp.stack([remain_beg, remain_end], axis=-1)
    x_left = jnp.zeros((B, 4, KB1, 2, 2), jnp.bool_).at[..., 0, :].set(True)

    xd_active = xa.reshape(-1)
    xd_inv, xd_n, xd_over = _compact(xd_active, XD_POOL)
    defer = defer | DEF_XDPOOL * xd_over.reshape(B, -1).any(axis=1)

    def flat_x(x):
        return x.reshape(-1)[xd_inv]

    xrow = xd_inv // (KB1 * 4)
    xqs = flat_x(jnp.broadcast_to(x_qs[..., None],
                                  (B, 4, KB1, 2, 2)))
    xqlen = flat_x(jnp.broadcast_to(x_qlen[..., None], (B, 4, KB1, 2, 2)))
    xrs0 = flat_x(x_rs0)
    xrlen = flat_x(x_rlen)
    xleft = flat_x(x_left)
    # s = ref window, t = q window; left kinds reversed (align_device)
    r_fwd = _gather_window(genome, xrs0, xrlen, I - 1)
    r_rev = _gather_window(genome, xrs0, xrlen, I - 1, reverse=True)
    s_x = jnp.where(xleft[:, None], r_rev, r_fwd)
    qi_f = xrow[:, None] * L + xqs[:, None] + io[None, :]
    qi_r = xrow[:, None] * L + xqs[:, None] + (xqlen[:, None] - 1
                                               - io[None, :])
    q_f = jnp.where(io[None, :] < xqlen[:, None],
                    seqsf[jnp.clip(qi_f, 0, R4 * L - 1)], jnp.int8(127))
    q_r = jnp.where(io[None, :] < xqlen[:, None],
                    seqsf[jnp.clip(qi_r, 0, R4 * L - 1)], jnp.int8(127))
    t_x = jnp.where(xleft[:, None], q_r, q_f)
    xsc, xon_s, xon_t = xdrop_batch_ref(s_x, t_x, xrlen, xqlen, w=band,
                                        mat=mat, mis=mis, ind=ind, xd=xd,
                                        I=I)
    edL, sclL, indL, scrL = _drop_wrap(xsc, xon_s, xon_t, xqlen, mat=mat,
                                       mis=mis, w=band, max_ed=max_ed,
                                       max_sc=max_sc, left=True)
    edR, sclR, indR, scrR = _drop_wrap(xsc, xon_s, xon_t, xqlen, mat=mat,
                                       mis=mis, w=band, max_ed=max_ed,
                                       max_sc=max_sc, left=False)
    x_ed = jnp.where(xleft, edL, edR)
    x_scl = jnp.where(xleft, sclL, sclR)
    x_ind = jnp.where(xleft, indL, indR)
    x_scr = jnp.where(xleft, scrL, scrR)

    def scat(v):
        return _scatter_pool(v, xd_inv, xd_n,
                             B * 4 * KB1 * 4).reshape(B, 4, KB1, 2, 2)

    dp_ed = scat(x_ed)
    dp_scl = scat(x_scl)
    dp_ind = scat(x_ind)
    dp_scr = scat(x_scr)

    def side_dp(side, var):
        return dict(ed=dp_ed[..., side, var], sclen=dp_scl[..., side, var],
                    indel=dp_ind[..., side, var], score=dp_scr[..., side,
                                                               var])
    return dict(
        B=B, NL=NL, KB1=KB1, valid=valid, clen=clen, q0=q0, r0=r0,
        lastq=lastq, lastr=lastr, remain_beg=remain_beg,
        remain_end=remain_end, pos_l=pos_l, pos_r=pos_r, iv_l=iv_l,
        iv_r=iv_r, exon_len_l=exon_len_l, exon_len_r=exon_len_r,
        covered_l=covered_l, covered_r=covered_r, wxL=wxL, wxR=wxR,
        walkL_inb=walkL_inb, walkR_inb=walkR_inb, genL_inb=genL_inb,
        genR_inb=genR_inb, est_mid=est_mid, mid_dp=mid_dp,
        side_dp=side_dp, defer=defer, cn4=cn4, hh4=hh4, lens4=lens4,
        rp4=rp4, qp4=qp4, sc4=sc4, mr_in=mr_in,
    )


def _is_left_chain(a_rp, a_qp, a_len, b_rp, b_qp, b_len, read_len, NL, k):
    """utils.cpp:827-887 merge walk, vectorized over [...]. Fragment
    arrays [..., NL]; flen == k."""
    a_beg = a_rp[..., 0]
    b_beg = b_rp[..., 0]
    a_end = jnp.take_along_axis(a_rp, jnp.clip(a_len - 1, 0, NL - 1)[...,
                                None], axis=-1)[..., 0] + k - 1
    b_end = jnp.take_along_axis(b_rp, jnp.clip(b_len - 1, 0, NL - 1)[...,
                                None], axis=-1)[..., 0] + k - 1
    separated = (b_beg > a_end) | (a_beg > b_end)

    shp = a_beg.shape
    i = jnp.zeros(shp, jnp.int32)
    j = jnp.zeros(shp, jnp.int32)
    bd = jnp.full(shp, INF, jnp.int32)
    bi = jnp.full(shp, -1, jnp.int32)
    bj = jnp.full(shp, -1, jnp.int32)
    done = jnp.zeros(shp, jnp.bool_)

    def body(_, c):
        i, j, bd, bi, bj, done = c
        on = ~done & (i < a_len) & (j < b_len)
        ic = jnp.clip(i, 0, NL - 1)
        jc = jnp.clip(j, 0, NL - 1)
        ai_beg = jnp.take_along_axis(a_rp, ic[..., None], -1)[..., 0]
        ai_end = ai_beg + k - 1
        bj_beg = jnp.take_along_axis(b_rp, jc[..., None], -1)[..., 0]
        bj_end = bj_beg + k - 1
        c1 = on & (ai_end < bj_beg)
        d1 = bj_beg - ai_end
        imp1 = c1 & (d1 < bd)
        c2 = on & ~c1 & (bj_end < ai_beg)
        d2 = ai_beg - bj_end
        imp2 = c2 & (d2 < bd)
        ov = on & ~c1 & ~c2
        bd = jnp.where(imp1, d1, jnp.where(imp2, d2, bd))
        bi = jnp.where(imp1 | imp2 | ov, i, bi)
        bj = jnp.where(imp1 | imp2 | ov, j, bj)
        i = jnp.where(c1, i + 1, i)
        j = jnp.where(c2, j + 1, j)
        done = done | ov | (~on & ~done & True)
        done = done | ov
        return i, j, bd, bi, bj, done

    i, j, bd, bi, bj, done = jax.lax.fori_loop(
        0, 2 * NL, body, (i, j, bd, bi, bj, done))
    bic = jnp.clip(bi, 0, NL - 1)
    bjc = jnp.clip(bj, 0, NL - 1)
    a_bp = jnp.take_along_axis(a_rp, bic[..., None], -1)[..., 0]
    b_bp = jnp.take_along_axis(b_rp, bjc[..., None], -1)[..., 0]
    common_bp = jnp.maximum(a_bp, b_bp)
    a_ov = jnp.take_along_axis(a_qp, bic[..., None], -1)[..., 0] \
        + (common_bp - a_bp)
    b_ov = jnp.take_along_axis(b_qp, bjc[..., None], -1)[..., 0] \
        + (common_bp - b_bp)
    both_in = (a_ov < read_len) & (b_ov < read_len) & (bi >= 0)
    return jnp.where(separated, a_beg < b_beg,
                     jnp.where(both_in, a_ov >= b_ov, a_beg < b_beg))


def _phase2(st, ad, fa, seqs, genome, *, k, max_ed, max_sc, band, P_MAX,
            KB, mat, mis, ind, xd, EW, KSCAN, WPP, MIDP, ENDP,
            upto="full"):
    """Pair-union table + pair-level paired extension (filter.cpp:485-551
    + extend.cpp:37-125), vectorized over [B, 2, P_MAX].  Multi-exon
    extension walks run through the device walk engine
    (ops/device_walk.py): speculative waves here, per-family gate folds
    inside run_side."""
    B, KB1, NL = st["B"], st["KB1"], st["NL"]
    rp4, qp4 = st["rp4"], st["qp4"]
    lens4, cn4 = st["lens4"], st["cn4"]
    defer = st["defer"]
    NIV = ad.iv_spos.shape[0]

    frows = jnp.array([0, 2], jnp.int32)
    vrows = jnp.array([3, 1], jnp.int32)
    # grid tensors [B, 2, KB1, KB1] (i = fwd chain, j = rev chain)
    fvalid = (jnp.arange(KB1)[None, None, :, None]
              < cn4[:, frows][..., None, None])
    rvalid = (jnp.arange(KB1)[None, None, None, :]
              < cn4[:, vrows][..., None, None])
    fs = jnp.broadcast_to(st["r0"][:, frows][..., :, None],
                          (B, 2, KB1, KB1))
    rs = jnp.broadcast_to(st["r0"][:, vrows][..., None, :],
                          (B, 2, KB1, KB1))
    fe = jnp.broadcast_to((st["lastr"] + k)[:, frows][..., :, None],
                          (B, 2, KB1, KB1))
    re_ = jnp.broadcast_to((st["lastr"] + k)[:, vrows][..., None, :],
                           (B, 2, KB1, KB1))
    tlen_g = jnp.where(fs < rs, re_ - fs, fe - rs)
    f_iv = jnp.broadcast_to(st["iv_l"][:, frows][..., :, None],
                            (B, 2, KB1, KB1))
    r_iv = jnp.broadcast_to(st["iv_l"][:, vrows][..., None, :],
                            (B, 2, KB1, KB1))
    gv = fvalid & rvalid
    same_tr = gv & _tids_intersect(fa, f_iv, r_iv)
    sgf = gv & _same_gene_span(ad, fa, f_iv, rs, re_)
    sgr = gv & _same_gene_span(ad, fa, r_iv, fs, fe)
    union = gv & (same_tr | sgf | sgr | (tlen_g <= MAXDISCRDTLEN))
    # annotation padding overflows on pair-relevant intervals -> defer
    fc_ = jnp.clip(f_iv, 0, NIV - 1)
    rc_ = jnp.clip(r_iv, 0, NIV - 1)
    over_anno = union & (
        ((f_iv >= 0) & ((fa.iv_ntid[fc_] > fa.iv_tids.shape[1])
                        | (fa.iv_nseg_true[fc_] > ad.seg_end.shape[1])))
        | ((r_iv >= 0) & ((fa.iv_ntid[rc_] > fa.iv_tids.shape[1])
                          | (fa.iv_nseg_true[rc_] > ad.seg_end.shape[1]))))
    defer = defer | DEF_PANNO * over_anno.reshape(B, -1).any(axis=1)

    # rank union pairs in (i, j) row-major order -> P_MAX slots
    uflat = union.reshape(B, 2, KB1 * KB1)
    rank = jnp.cumsum(uflat.astype(jnp.int32), axis=-1) - 1
    n_union = uflat.sum(axis=-1)                              # [B, 2]
    defer = defer | DEF_UNION * (n_union > P_MAX).any(axis=1)
    slot_of = jnp.where(uflat & (rank < P_MAX), rank, P_MAX)
    # inverse: pair slot -> grid cell
    cell_ids = jnp.broadcast_to(
        jnp.arange(KB1 * KB1, dtype=jnp.int32)[None, None, :],
        (B, 2, KB1 * KB1))
    inv = jnp.zeros((B, 2, P_MAX + 1), jnp.int32)
    inv = inv.at[jnp.arange(B)[:, None, None],
                 jnp.arange(2)[None, :, None], slot_of].set(cell_ids)
    pcell = inv[:, :, :P_MAX]                                 # [B,2,P]
    pvalid = jnp.arange(P_MAX)[None, None, :] < n_union[..., None]
    pi = pcell // KB1
    pj = pcell % KB1

    def grid_at(g):
        return jnp.take_along_axis(g.reshape(B, 2, KB1 * KB1), pcell,
                                   axis=-1)

    p_same_tr = grid_at(same_tr) & pvalid
    p_sgf = grid_at(sgf) & pvalid
    p_sgr = grid_at(sgr) & pvalid
    p_tlen = grid_at(tlen_g)
    p_fiv = grid_at(f_iv)
    p_riv = grid_at(r_iv)

    # per-pair chain data gather: mate 0 = fwd (row frows[o]), 1 = rev
    def chain_at(arr, rows, idx):
        # arr [B, 4, KB1(,X)] -> [B, 2, P(,X)]
        sub = arr[:, rows]                                   # [B,2,KB1(,X)]
        ix = idx.reshape(B, 2, P_MAX, *([1] * (arr.ndim - 3)))
        return jnp.take_along_axis(sub, ix, axis=2)

    SF_NAMES = ("r0", "q0", "lastq", "lastr", "remain_beg",
                "remain_end", "pos_l", "pos_r", "iv_l", "iv_r",
                "exon_len_l", "exon_len_r", "covered_l", "covered_r",
                "wxL", "wxR", "walkL_inb", "walkR_inb", "genL_inb",
                "genR_inb", "mid_dp", "clen")
    SF_BOOL = {"covered_l", "covered_r", "wxL", "wxR", "walkL_inb",
               "walkR_inb", "genL_inb", "genR_inb"}
    SF_DP = [(side, var, f) for side in (0, 1) for var in (0, 1)
             for f in ("ed", "sclen", "indel", "score")]
    # stack all 38 per-chain fields once: the per-pair selection becomes
    # ONE take_along_axis moving a contiguous 38-int row per index instead
    # of 38 separate row gathers per mate
    sf_stack = jnp.stack(
        [st[name].astype(jnp.int32) for name in SF_NAMES]
        + [st["side_dp"](side, var)[f] for side, var, f in SF_DP],
        axis=-1)                                          # [B, 4, KB1, F]

    def side_fields(idx, rows):
        sub = sf_stack[:, rows]                           # [B, 2, KB1, F]
        g = jnp.take_along_axis(sub, idx.reshape(B, 2, P_MAX, 1), axis=2)
        out = {}
        for fi, name in enumerate(SF_NAMES):
            v = g[..., fi]
            out[name] = (v != 0) if name in SF_BOOL else v
        for fi, (side, var, f) in enumerate(SF_DP):
            out[f"dp{side}{var}_{f}"] = g[..., len(SF_NAMES) + fi]
        out["seq_len"] = jnp.broadcast_to(
            st["lens4"][:, rows][..., None], (B, 2, P_MAX))
        # absolute seqs row of this mate (for walk-engine query windows)
        out["arow"] = jnp.broadcast_to(
            jnp.arange(B, dtype=jnp.int32)[:, None, None] * 4
            + rows[None, :, None], (B, 2, P_MAX))
        return out

    if upto == "p2_grid":
        return dict(union=union, same_tr=same_tr, sgf=sgf, sgr=sgr,
                    tlen_g=tlen_g, pvalid=pvalid, pcell=pcell,
                    defer=defer)
    fm = side_fields(pi, frows)   # fwd mate  [B,2,P]
    vm = side_fields(pj, vrows)   # rev mate

    # is_left_chain on the pair's chains (fwd vs rev), fwd read length
    fa_rp = chain_at(rp4, frows, pi)    # [B,2,P,NL]
    fa_qp = chain_at(qp4, frows, pi)
    vb_rp = chain_at(rp4, vrows, pj)
    vb_qp = chain_at(qp4, vrows, pj)
    fwd_left = _is_left_chain(fa_rp, fa_qp, fm["clen"], vb_rp, vb_qp,
                              vm["clen"], fm["seq_len"], NL, k)

    def sel(c, a, b):
        return {kk: jnp.where(c, a[kk], b[kk]) for kk in a}

    lm_c = sel(fwd_left, fm, vm)   # l-mate chain bundle
    rm_c = sel(fwd_left, vm, fm)

    # extend_both_mates (extend.cpp:37-125)
    l_mid = lm_c["mid_dp"]
    r_mid = rm_c["mid_dp"]
    success = (l_mid <= max_ed) & (r_mid <= max_ed)
    has_tids = p_same_tr

    def dp_of(mc, side, var):
        return dict(ed=mc[f"dp{side}{var}_ed"],
                    sclen=mc[f"dp{side}{var}_sclen"],
                    indel=mc[f"dp{side}{var}_indel"],
                    score=mc[f"dp{side}{var}_score"])

    if upto == "p2_gath":
        out = dict(defer=defer, fwd_left=fwd_left)
        for kk in ("r0", "q0", "mid_dp", "clen", "dp00_ed", "dp11_score"):
            out["f_" + kk] = fm.get(kk, fwd_left)
            out["v_" + kk] = vm.get(kk, fwd_left)
        return out

    # ---- device walk engine: speculative multi-exon walks ------------
    # (ops/device_walk.py; extend families 0=l-left 1=r-left 2=r-right
    # 3=l-right, matching the host extend order extend.cpp:87-95)
    from .device_walk import walk_waves, walk_fold
    eng_base = pvalid & success & p_same_tr

    def eng_mask(mc, left_side):
        if left_side:
            return eng_base & (mc["iv_l"] >= 0) \
                & (mc["remain_beg"] > 0) & ~mc["covered_l"]
        return eng_base & (mc["iv_r"] >= 0) \
            & (mc["remain_end"] > 0) & ~mc["covered_r"]

    zero3 = jnp.zeros((B, 2, P_MAX), jnp.int32)
    act4 = jnp.stack([eng_mask(lm_c, True), eng_mask(rm_c, True),
                      eng_mask(rm_c, False), eng_mask(lm_c, False)])
    pos4 = jnp.stack([lm_c["pos_l"], rm_c["pos_l"],
                      rm_c["pos_r"], lm_c["pos_r"]])
    len4 = jnp.stack([lm_c["remain_beg"], rm_c["remain_beg"],
                      rm_c["remain_end"], lm_c["remain_end"]])
    aiv4 = jnp.stack([lm_c["iv_l"], rm_c["iv_l"],
                      rm_c["iv_r"], lm_c["iv_r"]])
    row4 = jnp.stack([lm_c["arow"], rm_c["arow"],
                      rm_c["arow"], lm_c["arow"]])
    qs04 = jnp.stack([zero3, zero3,
                      rm_c["seq_len"] - rm_c["remain_end"],
                      lm_c["seq_len"] - lm_c["remain_end"]])
    wk = walk_waves(act4.reshape(4, -1), pos4.reshape(4, -1),
                    len4.reshape(4, -1), aiv4.reshape(4, -1),
                    row4.reshape(4, -1), qs04.reshape(4, -1),
                    [1, 1, 0, 0], p_fiv, p_riv, seqs.reshape(-1),
                    seqs.shape[1], genome, ad, fa, band=band,
                    max_ed=max_ed, max_sc=max_sc, mat=mat, mis=mis,
                    ind=ind, xd=xd, EW=EW, KSCAN=KSCAN, WPP=WPP,
                    MIDP=MIDP, ENDP=ENDP)
    if upto == "p2_walk":
        return dict(defer=defer, ev=wk["events"],
                    ldef=wk["lane_defer"])

    def run_side(mc, side_left, bound, ed_th, fam):
        eb, ec, edf = walk_fold(wk, fam, ed_th, bound, max_ed=max_ed,
                                max_sc=max_sc, band=band, left=side_left)
        eng = dict(active=act4[fam].reshape(B, 2, P_MAX), best=eb,
                   consec=ec, defer=edf)
        if side_left:
            gen = dp_of(mc, 0, 0)
            walk_extra = mc["wxL"]
            walk = _ares_where(walk_extra, dp_of(mc, 0, 1), gen)
            walk_ok = mc["covered_l"] & jnp.where(walk_extra,
                                                  mc["walkL_inb"],
                                                  mc["genL_inb"])
            return _extend_core_flat(
                mc["pos_l"], mc["remain_beg"], ed_th, bound,
                has_tids, mc["iv_l"] >= 0, mc["exon_len_l"],
                walk, walk_ok, gen, mc["genL_inb"], eng=eng,
                left=True, max_sc=max_sc, band=band)
        gen = dp_of(mc, 1, 0)
        walk_extra = mc["wxR"]
        walk = _ares_where(walk_extra, dp_of(mc, 1, 1), gen)
        walk_ok = mc["covered_r"] & jnp.where(walk_extra, mc["walkR_inb"],
                                              mc["genR_inb"])
        return _extend_core_flat(
            mc["pos_r"], mc["remain_end"], ed_th, bound,
            has_tids, mc["iv_r"] >= 0, mc["exon_len_r"],
            walk, walk_ok, gen, mc["genR_inb"], eng=eng,
            left=False, max_sc=max_sc, band=band)

    MINLB = jnp.zeros((B, 2, P_MAX), jnp.int32)
    MAXUBv = jnp.full((B, 2, P_MAX), I32MAX, jnp.int32)

    llok, l_spos, l_bl, dfa = run_side(lm_c, True, MINLB,
                                       max_ed - l_mid, 0)
    lerr1 = l_mid + l_bl["ed"]
    rlok, r_spos, r_bl, dfb = run_side(rm_c, True, l_spos,
                                       max_ed - r_mid, 1)
    rerr1 = r_mid + r_bl["ed"]
    rrok, r_epos, r_br, dfc = run_side(rm_c, False, MAXUBv,
                                       max_ed - rerr1, 2)
    rerr = rerr1 + r_br["ed"]
    lrok, l_epos, l_br, dfd = run_side(lm_c, False, r_epos,
                                       max_ed - lerr1, 3)
    lerr = lerr1 + l_br["ed"]
    if upto == "p2_ext":
        return dict(defer=defer, l_spos=l_spos, r_spos=r_spos,
                    l_epos=l_epos, r_epos=r_epos, llok=llok, rrok=rrok,
                    success=success)
    pair_live = pvalid & success
    defer_p = pair_live & (dfa | dfb | dfc | dfd)
    defer = defer | DEF_EXTWALK * defer_p.reshape(B, -1).any(axis=1)

    def mk_mm(mc, mid, bl, br, lok, rok, err, dirv):
        seq_len = mc["seq_len"]
        rb_after = mc["remain_beg"] - bl["qcov"]
        re_after = mc["remain_end"] - br["qcov"]
        mlen = seq_len \
            - jnp.where(lok, bl["sclen"], rb_after) \
            - jnp.where(rok, br["sclen"], re_after)
        qspos = 1 + jnp.where(lok, bl["sclen"], rb_after)
        qepos = seq_len - jnp.where(rok, br["sclen"], re_after)
        # update_match_mate_info (utils.cpp:22-32)
        l_ok_f = lok & (bl["sclen"] <= max_sc)
        r_ok_f = rok & (br["sclen"] <= max_sc)
        conc = lok & rok & (err <= max_ed) & (br["sclen"] <= max_sc) \
            & (bl["sclen"] <= max_sc)
        typ = jnp.where(conc, CONCRD,
                        jnp.where(lok | rok, CANDID, ORPHAN))
        # is_concord2 outcome when the OTHER mate's middle fails
        fullcov = (mc["clen"] >= 2) \
            & ((mc["lastq"] + k - mc["q0"]) >= seq_len)
        edge = (mc["q0"] == 0) | ((mc["lastq"] + k) == seq_len)
        ic2_type = jnp.where(fullcov, CONCRD,
                             jnp.where(edge, CANDID, ORPHAN))
        return dict(spos=mc["_spos"],
                    epos=mc["_epos"], qspos=qspos, qepos=qepos, mlen=mlen,
                    scl_l=bl["sclen"], scl_r=br["sclen"], led=bl["ed"],
                    med=mid, red=br["ed"], l_ok=l_ok_f, r_ok=r_ok_f,
                    type=typ, ic2_type=ic2_type, dir=dirv)

    lm_c["_spos"] = l_spos
    lm_c["_epos"] = l_epos
    rm_c["_spos"] = r_spos
    rm_c["_epos"] = r_epos
    one = jnp.ones((B, 2, P_MAX), jnp.int32)
    # dir: fwd mate dir=+1, rev mate dir=-1 (mapping.py:130-132); the
    # l/r-mate bundles carry it via the fwd_left selection
    lmm = mk_mm(lm_c, l_mid, l_bl, l_br, llok, lrok, lerr,
                jnp.where(fwd_left, one, -one))
    rmm = mk_mm(rm_c, r_mid, r_bl, r_br, rlok, rrok, rerr,
                jnp.where(fwd_left, -one, one))

    # overlap lookups on final mm coordinates (lazy in host, done when
    # success — utils.cpp:667-695)
    for mm in (lmm, rmm):
        iv_s, ind_s = _overlap_ind(ad, fa, mm["spos"])
        iv_e, ind_e = _overlap_ind(ad, fa, mm["epos"])
        mm["iv_s"], mm["ind_s"] = iv_s, ind_s
        mm["iv_e"], mm["ind_e"] = iv_e, ind_e
        NIVc = jnp.clip(iv_s, 0, NIV - 1)
        over = success & (
            ((iv_s >= 0) & (fa.iv_nseg_true[NIVc] > ad.seg_end.shape[1]))
            | ((iv_e >= 0) & (fa.iv_nseg_true[jnp.clip(iv_e, 0, NIV - 1)]
                              > ad.seg_end.shape[1])))
        defer = defer | DEF_MMANNO * ((over & pvalid)
                                      .reshape(B, -1).any(axis=1))

    st2 = dict(pvalid=pvalid, same_tr=p_same_tr, sgf=p_sgf, sgr=p_sgr,
               tlen_g=p_tlen, fiv=p_fiv, riv=p_riv, fwd_left=fwd_left,
               success=success, lmm=lmm, rmm=rmm, defer=defer,
               grid_same_tr=same_tr, grid_sgf=sgf, grid_sgr=sgr,
               grid_tlen=tlen_g, grid_fvalid=fvalid, grid_rvalid=rvalid,
               n_union=n_union)
    return st2


# --------------------------------------------------------------------------
# decision rules (utils.cpp:157-320), vectorized over [B]
# --------------------------------------------------------------------------

def _update_rule(mr, sm, lm, chr_idx, shift, tlen, jun, gm, type_, r1_sm,
                 contig_num, mask):
    mr2, _ = _mr_update(mr, sm, lm, chr_idx, shift, tlen, jun, gm,
                        jnp.full_like(tlen, type_) if np.isscalar(type_)
                        else type_, r1_sm, contig_num, mask)
    return mr2


def _conc_expl(mr, sm, lm, pre, chr_idx, shift, r1_sm, mp_type, mask,
               *, max_tlen, contig_num):
    """concordant_explanation (utils.cpp:157-213).  The pair-pure pieces
    (same-exon test, the calc_tlen transcript walk) are precomputed over
    ALL pairs at once (`_pair_precompute`) and arrive as columns in `pre`
    — the sequential fold only applies mr-dependent selects."""
    ok0 = mask & (sm["spos"] <= lm["spos"])
    on_cdna = ((sm["iv_s"] >= 0) & (sm["iv_e"] >= 0) & (lm["iv_s"] >= 0)
               & (lm["iv_e"] >= 0))
    tlen_a = lm["spos"] - sm["epos"] - 1 + lm["mlen"] + sm["mlen"]
    zero = jnp.zeros_like(tlen_a)
    fb = jnp.zeros_like(ok0)

    b1_no = (sm["iv_s"] < 0) | (lm["iv_s"] < 0)
    u1a = ok0 & b1_no & ((tlen_a <= max_tlen) | (tlen_a <= MAXDISCRDTLEN))
    mr = _update_rule(mr, sm, lm, chr_idx, shift, tlen_a, zero, fb, CONGNM,
                      r1_sm, contig_num, u1a)
    se = pre["se"]
    tlen_b = lm["spos"] + lm["mlen"] - sm["spos"]
    typ_b = jnp.where(mp_type == 0, CONCRD, CONGEN)
    u1b = ok0 & ~b1_no & se
    mr = _update_rule(mr, sm, lm, chr_idx, shift, tlen_b, zero, on_cdna,
                      jnp.where(tlen_b <= max_tlen, typ_b, DISCRD),
                      r1_sm, contig_num, u1b)

    b2_no = (sm["iv_e"] < 0) | (lm["iv_s"] < 0)
    u2a = ok0 & b2_no & ((tlen_a <= max_tlen) | (tlen_a <= MAXDISCRDTLEN))
    mr = _update_rule(mr, sm, lm, chr_idx, shift, tlen_a, zero, fb, CONGNM,
                      r1_sm, contig_num, u2a)
    tl, inn, df = pre["ct_tl"], pre["ct_inn"], pre["ct_df"]
    u2b = ok0 & ~b2_no
    defer = u2b & df
    good = (tl >= 0) & (tl <= max_tlen)
    mr = _update_rule(mr, sm, lm, chr_idx, shift, tl, inn, on_cdna, typ_b,
                      r1_sm, contig_num, u2b & good)
    tl_f = jnp.where(tl < 0, tlen_a, tl)
    inn_f = jnp.where(tl < 0, zero, inn)
    mr = _update_rule(mr, sm, lm, chr_idx, shift, tl_f, inn_f, on_cdna,
                      DISCRD, r1_sm, contig_num, u2b & ~good)
    return mr, defer


def _same_gene_mm(ad, fa, a, b):
    return (a["iv_s"] >= 0) & _same_gene_span(ad, fa, a["iv_s"], b["spos"],
                                              b["epos"])


def _lariat(ad, fa, sm, lm):
    """_lariat_ciRNA (utils.cpp:250-252, categories.py:324-335)."""
    NIV = ad.iv_epos.shape[0]
    ok = _bit(fa.intr_bits, sm["spos"]) & _bit(fa.intr_bits, lm["spos"]) \
        & (sm["ind_s"] >= 0) & (lm["ind_e"] >= 0) \
        & (sm["ind_s"] == lm["ind_e"])
    gap = sm["spos"] - ad.iv_epos[jnp.clip(sm["ind_s"], 0, NIV - 1)]
    return ok & (gap <= LARIAT2BEGTH)


def _check_chimeric(mr, sm, lm, pre, chr_idx, shift, r1_sm, mask,
                    *, contig_num):
    ok = mask & (mr["type"] != CONCRD) & (sm["iv_s"] >= 0) \
        & (lm["iv_s"] >= 0) & pre["sg_iv"] & (sm["spos"] < lm["spos"])
    tl = lm["epos"] - sm["spos"] + 1
    z = jnp.zeros_like(tl)
    return _update_rule(mr, sm, lm, chr_idx, shift, tl, z,
                        jnp.zeros_like(ok), CHIORF, r1_sm, contig_num, ok)


def _check_bsj(mr, sm, lm, pre, chr_idx, shift, r1_sm, mask,
               *, contig_num):
    ok = mask & (mr["type"] != CONCRD) & (mr["type"] != DISCRD) \
        & sm["r_ok"] & lm["l_ok"]
    tl = lm["epos"] - sm["spos"] + 1
    z = jnp.zeros_like(tl)
    return _update_rule(mr, sm, lm, chr_idx, shift, tl, z,
                        jnp.zeros_like(ok), CHIBSJ, r1_sm, contig_num,
                        ok & pre["bsj_hit"])


def _check_2bsj(mr, sm, lm, pre, chr_idx, shift, r1_sm, mask,
                *, contig_num):
    ok = mask & (mr["type"] >= CHI2BSJ) & (sm["spos"] <= lm["spos"])
    ok = ok & ~(sm["r_ok"] & lm["r_ok"] & (sm["spos"] != lm["spos"]))
    ok = ok & ~(sm["l_ok"] & lm["l_ok"] & (sm["epos"] != lm["epos"]))
    ok = ok & ~(sm["l_ok"] & lm["r_ok"])
    tl = lm["epos"] - sm["spos"] + 1
    z = jnp.zeros_like(tl)
    return _update_rule(mr, sm, lm, chr_idx, shift, tl, z,
                        jnp.zeros_like(ok), CHI2BSJ, r1_sm, contig_num,
                        ok & pre["bsj_hit"])


def _pair_precompute(ad, fa, lmm, rmm, need, *, W_MAX, CT_POOL):
    """Everything the decision rules need that is PAIR-PURE (independent of
    the running mr state), computed over all [B, 2, P_MAX] pairs in one
    vectorized pass.  Hoisting this out of the sequential pair fold removes
    the fold's gathers and — critically — the calc_tlen transcript walk
    (fori ST x fori W_MAX), which used to run serially once per pair per
    orientation (~2 x P_MAX x ST x W_MAX tiny device steps)."""
    sm, lm = lmm, rmm
    pre = {}
    pre["se"] = _same_exon(ad, fa, sm["iv_s"], lm["iv_s"])
    sg_iv = _same_gene_iv(ad, fa, sm["iv_s"], lm["iv_s"])
    pre["sg_iv"] = sg_iv
    ivnull = (sm["iv_s"] < 0) | (lm["iv_s"] < 0)
    gm_hit = _same_gene_mm(ad, fa, sm, lm) | _same_gene_mm(ad, fa, lm, sm)
    pre["bsj_hit"] = jnp.where(ivnull, gm_hit | _lariat(ad, fa, sm, lm),
                               sg_iv)
    shp = sm["iv_s"].shape

    def fl(x):
        return x.reshape(-1)

    # calc_tlen only matters for successful on-annotation pairs (the
    # fold reads it under u2b&cc, a subset of `need`), and most of the
    # [B, 2, P] slots are empty — compact into a pool first instead of
    # enumerating every slot
    nflat = need.reshape(-1)
    inv, n_act, over = _compact(nflat, CT_POOL)

    def gp(x):
        return fl(x)[inv]

    tl_p, inn_p, df_p = _calc_tlen(ad, fa, gp(sm["iv_e"]), gp(sm["ind_e"]),
                                   gp(sm["epos"]), gp(sm["mlen"]),
                                   gp(lm["iv_s"]), gp(lm["ind_s"]),
                                   gp(lm["spos"]), gp(lm["mlen"]),
                                   W_MAX=W_MAX)
    NFLT = nflat.shape[0]
    pre["ct_tl"] = _scatter_pool(tl_p, inv, n_act, NFLT).reshape(shp)
    pre["ct_inn"] = _scatter_pool(inn_p, inv, n_act, NFLT).reshape(shp)
    pre["ct_df"] = _scatter_pool(df_p.astype(jnp.int32), inv, n_act,
                                 NFLT).reshape(shp) != 0
    pre["ct_over"] = over.reshape(shp)
    return pre


# --------------------------------------------------------------------------
# public entry
# --------------------------------------------------------------------------

def device_full_finish(seqs, lens, hh, rp, qp, cl, sc10, cn, inc, mr_in,
                       genome, ad, fa, *, k, max_ed, max_sc, band,
                       max_tlen, scan_level, contig_num, KB, P_MAX, W_MAX,
                       OS_POOL, XD_POOL, mat, mis, ind, xd, I=128,
                       CT_POOL=None, EW=4, KSCAN=16, WPP=None, MIDP=None,
                       ENDP=None, upto="full"):
    """See module docstring.  Returns (mr_out int32 [B, MRF], defer [B]).
    upto in ("phase1", "lo", "phase2", "pre", "full") cuts the program for
    the on-chip micro-bisection (tools/bisect_device_full.py)."""
    if CT_POOL is None:
        CT_POOL = 4 * (seqs.shape[0] // 4)
    if WPP is None:
        WPP = max(512, 2 * (seqs.shape[0] // 4))
    if MIDP is None:
        MIDP = max(256, seqs.shape[0] // 8)
    if ENDP is None:
        ENDP = max(256, seqs.shape[0] // 4)
    st = _phase1(seqs, lens, hh, rp, qp, cl, sc10, cn, inc, mr_in, genome,
                 ad, fa, k=k, max_ed=max_ed, max_sc=max_sc, band=band,
                 KB=KB, OS_POOL=OS_POOL, XD_POOL=XD_POOL, mat=mat, mis=mis,
                 ind=ind, xd=xd, I=I)
    B, KB1, NL = st["B"], st["KB1"], st["NL"]
    if upto == "phase1":
        return {kk: v for kk, v in st.items()
                if isinstance(v, jnp.ndarray)}, st["defer"]

    # ---- leftover chain-level extends (extend.cpp:131-213) -----------
    def chain_dp(side, var):
        return st["side_dp"](side, var)

    no_tids = jnp.zeros((B, 4, KB1), jnp.bool_)
    ed_th_l = max_ed - st["est_mid"]
    lo_lok, lo_spos, lo_bl, _ = _extend_core_flat(
        st["pos_l"], st["remain_beg"], ed_th_l,
        jnp.zeros((B, 4, KB1), jnp.int32), no_tids,
        st["iv_l"] >= 0, st["exon_len_l"], chain_dp(0, 0),
        jnp.zeros((B, 4, KB1), jnp.bool_), chain_dp(0, 0), st["genL_inb"],
        left=True, max_sc=max_sc, band=band)
    ed_th_r = max_ed - st["est_mid"] - lo_bl["ed"]
    lo_rok, lo_epos, lo_br, _ = _extend_core_flat(
        st["pos_r"], st["remain_end"], ed_th_r,
        jnp.full((B, 4, KB1), I32MAX, jnp.int32), no_tids,
        st["iv_r"] >= 0, st["exon_len_r"], chain_dp(1, 0),
        jnp.zeros((B, 4, KB1), jnp.bool_), chain_dp(1, 0), st["genR_inb"],
        left=False, max_sc=max_sc, band=band)
    # is_concord short-circuit (utils.cpp:116-132)
    fullcov = (st["clen"] >= 2) & ((st["lastq"] + k - st["q0"])
                                   >= st["lens4"][:, :, None])
    conc_lo = lo_lok & lo_rok & (lo_bl["ed"] + lo_br["ed"] <= max_ed) \
        & (lo_bl["sclen"] <= max_sc) & (lo_br["sclen"] <= max_sc)
    lo_ret = jnp.where(fullcov, CONCRD,
                       jnp.where(conc_lo, CONCRD,
                                 jnp.where(lo_lok | lo_rok, CANDID,
                                           ORPHAN)))
    lo_sp = jnp.where(fullcov, st["r0"], lo_spos)
    lo_ep = jnp.where(fullcov, st["lastr"] + k - 1, lo_epos)
    lo_ivs, _ = _overlap_ind(ad, fa, lo_sp)
    lo_ive, _ = _overlap_ind(ad, fa, lo_ep)
    lo_genic = (lo_ivs >= 0) | (lo_ive >= 0)

    if upto == "lo":
        return dict(lo_ret=lo_ret, lo_sp=lo_sp, lo_ep=lo_ep,
                    lo_genic=lo_genic), st["defer"]
    st2 = _phase2(st, ad, fa, seqs, genome, k=k, max_ed=max_ed,
                  max_sc=max_sc, band=band, P_MAX=P_MAX, KB=KB, mat=mat,
                  mis=mis, ind=ind, xd=xd, EW=EW, KSCAN=KSCAN, WPP=WPP,
                  MIDP=MIDP, ENDP=ENDP,
                  upto=upto if upto.startswith("p2_") else "full")
    defer = st2["defer"]
    if upto.startswith("p2_"):
        return {kk: v for kk, v in st2.items()
                if isinstance(v, jnp.ndarray)}, defer
    if upto == "phase2":
        return {kk: v for kk, v in st2.items()
                if isinstance(v, jnp.ndarray)}, defer
    lmm, rmm = st2["lmm"], st2["rmm"]
    success = st2["success"]
    fwd_left = st2["fwd_left"]
    pvalid = st2["pvalid"]

    # final mm type incl. mid-failure fallback (extend.py:759-777)
    for mm in (lmm, rmm):
        mm["tfinal"] = jnp.where(
            success, mm["type"],
            jnp.where(mm["med"] <= max_ed, mm["ic2_type"], ORPHAN))

    # ---- mr fold ------------------------------------------------------
    keys = ["type", "spos_r1", "epos_r1", "qspos_r1", "qepos_r1",
            "mlen_r1", "ed_r1", "r1_fwd", "spos_r2", "epos_r2", "qspos_r2",
            "qepos_r2", "mlen_r2", "ed_r2", "r2_fwd", "tlen", "junc", "gm",
            "chr", "contig"]
    mr = {kk: mr_in[:, i] for i, kk in enumerate(keys)}
    mr["gm"] = mr["gm"].astype(jnp.int32)

    cn4, hh4 = st["cn4"], st["hh4"]
    cn_r1 = cn4[:, 0] + cn4[:, 1]
    cn_r2 = cn4[:, 2] + cn4[:, 3]
    no_any = (cn_r1 + cn_r2) == 0
    manyhit = no_any & (hh4[:, 0] + hh4[:, 1] > 0) \
        & (hh4[:, 2] + hh4[:, 3] > 0)
    mr = _mr_update_type(mr, jnp.full((B,), NOPROC_MANYHIT, jnp.int32),
                         manyhit)
    mr = _mr_update_type(mr, jnp.full((B,), NOPROC_NOMATCH, jnp.int32),
                         no_any & ~manyhit)
    oeanch = ~no_any & ((cn_r1 == 0) | (cn_r2 == 0))
    mr = _mr_update_type(mr, jnp.full((B,), OEANCH, jnp.int32), oeanch)
    done_read = no_any | oeanch

    # orientation order by best-chain score sums (filter.cpp:206-240)
    sc_best = jnp.where(cn4 > 0, st["sc4"][..., 0], 0)     # [B, 4]
    sA = sc_best[:, 0] + sc_best[:, 3]
    sB = sc_best[:, 2] + sc_best[:, 1]
    defer = defer | DEF_SCTIE * (~done_read & (sA == sB)
                                 & ((cn_r1 > 0) & (cn_r2 > 0)))  # f64 tie
    first_A = sA >= sB

    def at_o(arr, o_idx):
        """arr [B, 2, ...] gather orientation per read -> [B, ...]."""
        ix = o_idx.reshape(B, 1, *([1] * (arr.ndim - 2)))
        return jnp.take_along_axis(arr, ix, axis=1)[:, 0]

    stopped = jnp.zeros((B,), jnp.bool_)
    # pair-pure relations + pooled calc_tlen over the [B, 2, P] pairs
    ct_need = pvalid & success & (lmm["iv_e"] >= 0) & (rmm["iv_s"] >= 0)
    pre_all = _pair_precompute(ad, fa, lmm, rmm, ct_need, W_MAX=W_MAX,
                               CT_POOL=CT_POOL)
    defer = defer | DEF_CTPOOL * pre_all["ct_over"].reshape(
        pre_all["ct_over"].shape[0], -1).any(axis=1)
    if upto == "pre":
        return pre_all, defer
    # fields of the mate bundles the fold actually consumes
    MM_USED = ("spos", "epos", "qspos", "qepos", "mlen", "led", "med",
               "red", "dir", "tfinal", "iv_s", "iv_e", "l_ok", "r_ok")
    for t in (0, 1):
        o_t = jnp.where(first_A, t, 1 - t).astype(jnp.int32)
        r1_fwd_flag = o_t == 0
        saved = mr["type"]
        live = ~done_read & ~stopped

        pv = at_o(pvalid, o_t)
        same_tr = at_o(st2["same_tr"], o_t)
        sgf = at_o(st2["sgf"], o_t)
        sgr = at_o(st2["sgr"], o_t)
        tlg = at_o(st2["tlen_g"], o_t)
        fiv = at_o(st2["fiv"], o_t)
        riv = at_o(st2["riv"], o_t)
        fl = at_o(fwd_left, o_t)
        succ_o = at_o(success, o_t)

        # exact pair gate (filter.cpp:485-551) with this saved_type
        if scan_level == 0:
            c1 = (saved > CONGEN)[:, None]
        else:
            c1 = (saved >= CONGEN)[:, None]
        sg1 = ~same_tr & (fiv >= 0) & c1 & sgf
        sg2 = ~sg1 & (riv >= 0) & (saved >= CONGEN)[:, None] & sgr
        same_gen = sg1 | sg2
        gate = same_tr | same_gen | (
            (tlg <= MAXDISCRDTLEN) & (saved >= CONGNM)[:, None])
        mp_type = jnp.where(same_tr, 0, jnp.where(same_gen, 1, 2))

        lmm_o = at_o(lmm["spos"], o_t)
        chr_idx = _bisect_le(fa.shift_bounds, lmm_o)
        chr_idx = jnp.clip(chr_idx, 0, fa.shift_vals.shape[0] - 1)
        shift = fa.shift_vals[chr_idx]
        r1_sm = jnp.where(fl, r1_fwd_flag[:, None],
                          ~r1_fwd_flag[:, None])

        # transpose every per-pair tensor to [P, B] so the fold reads pair
        # p with ONE dynamic slice per tensor (lane-major, no gathers)
        lmm_T = {kk: at_o(lmm[kk], o_t).T for kk in MM_USED}
        rmm_T = {kk: at_o(rmm[kk], o_t).T for kk in MM_USED}
        pre_T = {kk: at_o(v, o_t).T for kk, v in pre_all.items()}
        fl_T = fl.T
        pv_T = pv.T
        gate_T = gate.T
        mp_T = mp_type.T
        succ_T = succ_o.T
        chr_T = chr_idx.T
        sh_T = shift.T
        rs_T = r1_sm.T
        mr_keys = keys

        def pair_body(p, carry):
            (mr_t, stopped, min1, min2, r1g, r2g, defer_o) = carry
            mr = dict(zip(mr_keys, mr_t))

            def col(v):
                return jax.lax.dynamic_index_in_dim(v, p, axis=0,
                                                    keepdims=False)

            lm_p = {kk: col(lmm_T[kk]) for kk in MM_USED}
            rm_p = {kk: col(rmm_T[kk]) for kk in MM_USED}
            pre_p = {kk: col(v) for kk, v in pre_T.items()}
            flp = col(fl_T)
            pact = col(pv_T) & col(gate_T) & live & ~stopped
            succ = pact & col(succ_T)
            r1t = jnp.where(flp, lm_p["tfinal"], rm_p["tfinal"])
            r2t = jnp.where(flp, rm_p["tfinal"], lm_p["tfinal"])
            cc = succ & flp & (r1t == CONCRD) & (r2t == CONCRD)
            bsj_m = succ & (((r1t == CANDID) & (r2t == CONCRD))
                            | ((r1t == CONCRD) & (r2t == CANDID)))
            b2_m = succ & (r1t == CANDID) & (r2t == CANDID)
            chim = succ & ~flp & (r1t == CONCRD) & (r2t == CONCRD)
            ch_p, sh_p = col(chr_T), col(sh_T)
            rs_p = col(rs_T)
            mr, df_ce = _conc_expl(
                mr, lm_p, rm_p, pre_p, ch_p, sh_p, rs_p, col(mp_T),
                cc, max_tlen=max_tlen, contig_num=contig_num)
            defer_o = defer_o | (cc & df_ce)
            stopped = stopped | (cc & (mr["type"] == CONCRD)
                                 & (scan_level == 0))
            mr = _check_chimeric(mr, lm_p, rm_p, pre_p, ch_p, sh_p, rs_p,
                                 chim, contig_num=contig_num)
            mr = _check_bsj(mr, lm_p, rm_p, pre_p, ch_p, sh_p, rs_p,
                            bsj_m, contig_num=contig_num)
            mr = _check_2bsj(mr, lm_p, rm_p, pre_p, ch_p, sh_p, rs_p,
                             b2_m, contig_num=contig_num)
            min1 = jnp.where(pact, jnp.minimum(min1, r1t), min1)
            min2 = jnp.where(pact, jnp.minimum(min2, r2t), min2)
            g1 = (succ & (jnp.where(flp, lm_p["iv_s"], rm_p["iv_s"]) >= 0)) \
                | (succ & (jnp.where(flp, lm_p["iv_e"], rm_p["iv_e"]) >= 0))
            g2 = (succ & (jnp.where(flp, rm_p["iv_s"], lm_p["iv_s"]) >= 0)) \
                | (succ & (jnp.where(flp, rm_p["iv_e"], lm_p["iv_e"]) >= 0))
            r1g = jnp.where(pact, g1, r1g)
            r2g = jnp.where(pact, g2, r2g)
            return (tuple(mr[kk] for kk in mr_keys), stopped, min1, min2,
                    r1g, r2g, defer_o)

        carry0 = (tuple(mr[kk] for kk in mr_keys),
                  stopped,
                  jnp.full((B,), ORPHAN, jnp.int32),
                  jnp.full((B,), ORPHAN, jnp.int32),
                  jnp.zeros((B,), jnp.bool_),
                  jnp.zeros((B,), jnp.bool_),
                  jnp.zeros((B,), jnp.bool_))
        (mr_t, stopped, min1, min2, r1g, r2g, defer_o) = jax.lax.fori_loop(
            0, P_MAX, pair_body, carry0)
        mr = dict(zip(mr_keys, mr_t))
        defer = defer | DEF_TLENWALK * defer_o

        # ---- leftover single-chain extension (filter.cpp:356-394) ----
        top5 = mr["type"] <= CHI2BSJ
        do_lo = live & ~stopped & ~top5
        frows = jnp.array([0, 2], jnp.int32)
        vrows = jnp.array([3, 1], jnp.int32)
        frow = frows[o_t]
        vrow = vrows[o_t]
        # exact paired flags over the full grid with this saved_type
        g_tr = at_o(st2["grid_same_tr"], o_t)
        g_sgf = at_o(st2["grid_sgf"], o_t)
        g_sgr = at_o(st2["grid_sgr"], o_t)
        g_tl = at_o(st2["grid_tlen"], o_t)
        g_fv = at_o(st2["grid_fvalid"], o_t)
        g_rv = at_o(st2["grid_rvalid"], o_t)
        gg_sg1 = ~g_tr & c1[..., None] & g_sgf
        # grid f_iv validity folded into sgf already; replicate gate
        gg_sg2 = ~gg_sg1 & (saved >= CONGEN)[:, None, None] & g_sgr
        gg = (g_fv & g_rv) & (g_tr | gg_sg1 | gg_sg2 | (
            (g_tl <= MAXDISCRDTLEN) & (saved >= CONGNM)[:, None, None]))
        f_paired = gg.any(axis=2)                              # [B, KB1]
        r_paired = gg.any(axis=1)

        def row_g(arr, rowv):
            return jnp.take_along_axis(
                arr, rowv.reshape(B, 1, *([1] * (arr.ndim - 2))),
                axis=1)[:, 0]

        lo_ret_f = row_g(lo_ret, frow)
        lo_gen_f = row_g(lo_genic, frow)
        lo_ret_v = row_g(lo_ret, vrow)
        lo_gen_v = row_g(lo_genic, vrow)
        cnt_f = jnp.take_along_axis(cn4, frow[:, None], axis=1)[:, 0]
        cnt_v = jnp.take_along_axis(cn4, vrow[:, None], axis=1)[:, 0]
        ci = jnp.arange(KB1)[None, :]
        un_f = do_lo[:, None] & (min1 != CONCRD)[:, None] \
            & (ci < cnt_f[:, None]) & ~f_paired
        un_v = do_lo[:, None] & (min2 != CONCRD)[:, None] \
            & (ci < cnt_v[:, None]) & ~r_paired
        min1 = jnp.minimum(min1, jnp.min(
            jnp.where(un_f, lo_ret_f, ORPHAN), axis=1))
        min2 = jnp.minimum(min2, jnp.min(
            jnp.where(un_v, lo_ret_v, ORPHAN), axis=1))
        # r*_genic: last unpaired chain's lookup wins (mapping.py:204-218)
        last_f = jnp.max(jnp.where(un_f, ci, -1), axis=1)
        last_v = jnp.max(jnp.where(un_v, ci, -1), axis=1)
        r1g = jnp.where(last_f >= 0,
                        jnp.take_along_axis(
                            lo_gen_f, jnp.clip(last_f, 0, KB1 - 1)[:, None],
                            axis=1)[:, 0], r1g)
        r2g = jnp.where(last_v >= 0,
                        jnp.take_along_axis(
                            lo_gen_v, jnp.clip(last_v, 0, KB1 - 1)[:, None],
                            axis=1)[:, 0], r2g)
        both_c = (min1 == CONCRD) & (min2 == CONCRD)
        new_type = jnp.where(
            ((min1 == ORPHAN) & (min2 == CONCRD))
            | ((min1 == CONCRD) & (min2 == ORPHAN)), OEANCH,
            jnp.where((min1 == ORPHAN) | (min2 == ORPHAN), ORPHAN,
                      jnp.where(both_c & r1g & r2g, CHIFUS,
                                jnp.where(both_c, OEA2, CANDID))))
        mr = _mr_update_type(mr, new_type, do_lo)

    mr_out = jnp.stack([mr[kk].astype(jnp.int32) for kk in keys], axis=1)
    return mr_out, defer


@partial(jax.jit,
         static_argnames=("k", "cs_len", "n_slots", "seed_lim", "cap",
                          "max_ed", "max_sc", "band", "max_tlen",
                          "max_intron", "seg_pad", "scan_level",
                          "contig_num", "KB", "P_MAX", "W_MAX", "OS_POOL",
                          "XD_POOL", "EX_ITERS", "mat", "mis", "ind", "xd",
                          "prefix_shift", "prefix_iters", "EW", "KSCAN",
                          "WPP", "MIDP", "ENDP", "seg_compact"))
def device_full_step(seqs, lens, mr_in, entry_hv, entry_checksum,
                     entry_pos, genome, ad, fa, entry_prefix=None, *,
                     k, cs_len, n_slots, seed_lim, cap, max_ed, max_sc,
                     band, max_tlen, max_intron, seg_pad, scan_level,
                     contig_num, KB, P_MAX, W_MAX, OS_POOL, XD_POOL,
                     EX_ITERS, mat, mis, ind, xd,
                     prefix_shift=0, prefix_iters=0, EW=4, KSCAN=16,
                     WPP=None, MIDP=None, ENDP=None, seg_compact=False):
    """THE fused dispatch: lookup -> gather -> chain DP -> k-best ->
    pairing -> extension -> category lattice.  One d2h payload:
    int32 [B, MRF + 1] = final MatchedRead state | defer bit."""
    from .seed import lookup_batch_device, gather_seeds_device
    from .chain import chain_batch_device
    from .device_finish import extract_kbest_device

    R4, L = seqs.shape
    B = R4 // 4
    NL = (L + k - 1) // k
    qpos_all, start, cnt, high = lookup_batch_device(
        seqs, lens, entry_hv, entry_checksum, entry_prefix, k=k,
        cs_len=cs_len, n_slots=n_slots, seed_lim=seed_lim,
        prefix_shift=prefix_shift, prefix_iters=prefix_iters)
    start_e = start[:, ::2]
    cnt_e = cnt[:, ::2]
    hh_row = jnp.sum(high[:, ::2].astype(jnp.int32), axis=1)
    cnt_c = jnp.minimum(cnt_e, cap)
    pos, _ = gather_seeds_device(entry_pos, start_e, cnt_c, cap=cap)
    return full_from_seeds(
        seqs, lens, mr_in, pos, cnt_e, hh_row, genome, ad, fa,
        k=k, cap=cap, max_ed=max_ed, max_sc=max_sc, band=band,
        max_tlen=max_tlen, max_intron=max_intron, seg_pad=seg_pad,
        scan_level=scan_level, contig_num=contig_num, KB=KB, P_MAX=P_MAX,
        W_MAX=W_MAX, OS_POOL=OS_POOL, XD_POOL=XD_POOL, EX_ITERS=EX_ITERS,
        mat=mat, mis=mis, ind=ind, xd=xd, EW=EW, KSCAN=KSCAN, WPP=WPP,
        MIDP=MIDP, ENDP=ENDP, seg_compact=seg_compact)


def full_from_seeds(seqs, lens, mr_in, pos, cnt_e, hh_row, genome, ad, fa,
                    *, k, cap, max_ed, max_sc, band, max_tlen, max_intron,
                    seg_pad, scan_level, contig_num, KB, P_MAX, W_MAX,
                    OS_POOL, XD_POOL, EX_ITERS, mat, mis, ind, xd, EW=4,
                    KSCAN=16, WPP=None, MIDP=None, ENDP=None,
                    seg_compact=False):
    """The fused step from gathered seeds on: chain DP -> k-best ->
    finish.  Split out so the index-sharded multi-chip step
    (parallel/mesh.make_index_sharded_full_step) can feed it seeds from
    the owner-computes bucket exchange instead of a local lookup —
    everything downstream is row-local and identical."""
    from .chain import chain_batch_device
    from .device_finish import extract_kbest_device

    R4, L = seqs.shape
    B = R4 // 4
    NL = (L + k - 1) // k
    ql = (jnp.arange(NL, dtype=jnp.int32) * k)[None, :]
    qpos_e = jnp.where(ql + k <= lens[:, None], ql, 0).astype(jnp.int32)
    occ_defer = (cnt_e > cap).any(axis=1).reshape(B, 4).any(axis=1)
    cnt_c = jnp.minimum(cnt_e, cap)
    dp10, back = chain_batch_device(
        pos, cnt_c, qpos_e, lens,
        ad.nb_bits, ad.iv_spos, ad.iv_epos, ad.iv_max_end, ad.iv_min_end,
        ad.iv_max_next, ad.iv_nseg, ad.seg_end, ad.seg_next,
        k=k, max_ed=max_ed, max_intron=max_intron, seg_pad=seg_pad,
        seg_compact=seg_compact)
    rp, qp, cl, sc10, cn, inc = extract_kbest_device(
        dp10, back, pos, qpos_e, cnt_c, k=k, C=KB + 1, iters=EX_ITERS)

    mr_out, defer = device_full_finish(
        seqs, lens, hh_row, rp, qp, cl, sc10, cn, inc, mr_in, genome,
        ad, fa, k=k, max_ed=max_ed, max_sc=max_sc, band=band,
        max_tlen=max_tlen, scan_level=scan_level, contig_num=contig_num,
        KB=KB, P_MAX=P_MAX, W_MAX=W_MAX, OS_POOL=OS_POOL, XD_POOL=XD_POOL,
        mat=mat, mis=mis, ind=ind, xd=xd, EW=EW, KSCAN=KSCAN, WPP=WPP,
        MIDP=MIDP, ENDP=ENDP)
    defer = defer | DEF_OCC * occ_defer
    return jnp.concatenate([mr_out, defer[:, None].astype(jnp.int32)],
                           axis=1)
