"""On-device multi-exon transcript extension walks.

The host TransExtension walk (pipeline/extend.py ``_extend_right_trans_g`` /
``_extend_left_trans_g``, mirroring src/extend.cpp:491-650 and :708-875)
visits a transcript's exons one disjoint interval at a time, alternating
annotation scanning with banded middle DPs (``local_alignment_right/left``,
src/align.cpp:556-600) and one terminal X-drop end DP per transcript.  The
fused device executor would otherwise defer every such read to host
replay — on chr21 the single largest deferral cause.

Device formulation (all inside the one fused jit program):

* **lanes** — every (extend-family, pair-slot, common-transcript) triple
  that needs a walk is a lane, compacted into a ``[ST, WPP]`` pool
  (families: l-mate-left, r-mate-left, r-mate-right, l-mate-right; lanes
  are WPP-minor, the lane-major layout of ops/device_finish.py).
* **speculation** — walk *geometry* (which intervals are visited, where the
  flush DPs land, the committed ``covered`` offsets) depends only on the
  annotation and earlier DP indels, never on the per-extend bound (lb/ub)
  or error budget (ed_th); those only ABORT a walk.  So all four families'
  walks run concurrently through EW sequential waves (scan <= KSCAN
  intervals -> pooled middle DPs -> pooled end DPs -> commit), and the
  bound/ed_th gates replay afterwards in a cheap elementwise fold, once
  each extend's bound is actually known (r-left's lb is l-left's result,
  extend.cpp:87-95).
* **events** — each lane emits at most one best-update event per wave
  (a middle/trailing ``update_right/left`` or the terminal
  ``update_by_score``); the fold replays events in (tid, event) order —
  exactly the host's sequential best fold, which is valid because a tid's
  control flow depends only on its own running ``curr``, never on the
  shared ``best`` (extend.py:366-597: every gate reads curr/geometry only).
  The host's per-key memoization (align_res dict) is result-transparent —
  identical keys produce identical DP results and idempotent best updates —
  so the device simply recomputes.

Budget overflows (more than EW DPs per lane, scans past EW*KSCAN
intervals, exhausted pool slots) raise DEF_EXTWALK and the read replays on
the host path — device results are bit-exact or absent, never approximate.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .wavefront import POS, xdrop_batch_ref
from .align_device import edit_end_scan_ref

# lane status codes
WK_SCAN, WK_PMID, WK_PTRAIL, WK_PEND, WK_PENDND, WK_DONE = 0, 1, 2, 3, 4, 5
# event kinds
EVK_NONE, EVK_MID, EVK_TRAIL, EVK_END, EVK_ENDND = 0, 1, 2, 3, 4
# event record fields: [kind, xpos, aux(exlen|covered), ed, indel, sclen,
#                       score]
EV_NF = 7

NEG_SCORE = -(10 ** 9)


# --------------------------------------------------------------------------
# middle-DP pool kernel: local_alignment_right semantics for every shape
# --------------------------------------------------------------------------

def _tiny_end(s, t, n, m, *, w, max_ed, NM, MM):
    """Full (unbanded) edit DP + the column-m candidate scan for the tiny
    shapes where the oracle's banded DP falls back to full DP
    (align.py:88-90: n <= 2w or m <= w; both dims are then <= 2w).
    Candidate order: ed asc, |indel| asc, smallest i first (align.py:
    184-188, AlignCandid.update with strict better_than)."""
    B = s.shape[0]
    j_io = jnp.arange(MM + 1, dtype=jnp.int32)[None, :]
    row = jnp.where(j_io <= m[:, None], jnp.broadcast_to(j_io, (B, MM + 1)),
                    POS)
    best_key = jnp.zeros((B,), jnp.int32)
    best_ed = jnp.full((B,), max_ed + 1, jnp.int32)
    best_indel = jnp.full((B,), w + 1, jnp.int32)

    def upd_cand(i, rowv, bk, be, bi):
        dmv = jnp.take_along_axis(rowv, jnp.clip(m, 0, MM)[:, None],
                                  axis=1)[:, 0]
        indel = m - i
        ok = (i <= n) & (jnp.abs(indel) <= w) & (dmv <= max_ed)
        key = ((max_ed - dmv) * (w + 2)
               + (w + 1 - jnp.minimum(jnp.abs(indel), w + 1)))
        better = ok & (key > bk)
        return (jnp.where(better, key, bk), jnp.where(better, dmv, be),
                jnp.where(better, indel, bi))

    best_key, best_ed, best_indel = upd_cand(jnp.int32(0), row, best_key,
                                             best_ed, best_indel)

    def body(carry, i):
        row, bk, be, bi = carry
        si = jnp.take_along_axis(s, jnp.clip(i - 1, 0, NM - 1)
                                 [None, None].repeat(B, 0), axis=1)[:, 0]
        prev = row
        cols = [jnp.where(i <= n, i, POS)]
        for j in range(1, MM + 1):
            tj = t[:, j - 1]
            mis = ((si != tj) | (si >= 4) | (tj >= 4)).astype(jnp.int32)
            v = jnp.minimum(prev[:, j - 1] + mis,
                            jnp.minimum(prev[:, j] + 1, cols[j - 1] + 1))
            v = jnp.where((i <= n) & (j <= m), v, POS)
            cols.append(v)
        new = jnp.stack(cols, axis=1)
        row = jnp.where((i <= n)[:, None], new, prev)
        bk, be, bi = upd_cand(i, row, bk, be, bi)
        return (row, bk, be, bi), None

    # scan over rows (traces the MM-wide body once, not NM times, which
    # keeps the fused program's compile time down)
    (row, best_key, best_ed, best_indel), _ = jax.lax.scan(
        body, (row, best_key, best_ed, best_indel),
        jnp.arange(1, NM + 1, dtype=jnp.int32))
    return best_ed, best_indel


def _end_dp_pool(s, t, n, m, *, w, max_ed, I):
    """Pooled local_alignment_right (the ``end_r/end_l`` request kind):
    banded kernel for the banded regime, tiny full-DP twin for the
    fallback shapes (n <= 2w or m <= w, which bounds both dims by 2w —
    align.py:88-90 with n = min(m + w, need)).  Returns (ed, indel);
    the request's score is -ed by construction (align.py:188)."""
    b_ed, b_in = edit_end_scan_ref(s, t, n, m, w=w, max_ed=max_ed, I=I)
    TN = TM = max(8, 2 * w + 2)
    t_ed, t_in = _tiny_end(s[:, :TN], t[:, :TM], jnp.minimum(n, TN),
                           jnp.minimum(m, TM), w=w, max_ed=max_ed,
                           NM=TN, MM=TM)
    tiny = (n <= 2 * w) | (m <= w)
    return (jnp.where(tiny, t_ed, b_ed), jnp.where(tiny, t_in, b_in))


# --------------------------------------------------------------------------
# the speculative walk waves
# --------------------------------------------------------------------------

def walk_waves(act4, pos4, len4, aiv4, row4, qs04, left4, fiv, riv,
               seqsf, L, genome, ad, fa, *, band, max_ed, max_sc,
               mat, mis, ind, xd, EW, KSCAN, WPP, MIDP, ENDP, I=128):
    """Run the walks for all four extend families concurrently.

    act4/pos4/len4/aiv4/row4/qs04: [4, N] lane tables (N = flattened
    B*2*P pair slots; row4 = absolute seqs row, qs04 = query-window base
    offset within the row); left4: per-family left/right flags (static);
    fiv/riv: [N] pair anchor intervals defining the common-transcript set
    (pair_chains order, utils.cpp:322-352 — f_iv's tid list filtered by
    membership in r_iv's, duplicates preserved).

    Returns the pooled event tensor + metadata for ``walk_fold``."""
    from .device_full import _compact, _scatter_pool, _gather_window, \
        _drop_wrap

    N = fiv.reshape(-1).shape[0]
    ST = fa.iv_tids.shape[1]
    NIV = ad.iv_spos.shape[0]
    NT = fa.trans_start.shape[0]
    NS = fa.t2s_state.shape[0]
    G = genome.shape[0]
    RL = seqsf.shape[0]

    flat_act = act4.reshape(-1)                       # [4N]
    inv, n_act, over = _compact(flat_act, WPP)        # pool -> flat4 idx

    def gp(x4):
        return x4.reshape(-1)[inv]                    # [WPP]

    p_pos = gp(pos4)
    p_len = gp(len4)
    p_aiv = gp(aiv4)
    p_row = gp(row4)
    p_qs0 = gp(qs04)
    p_left = gp(jnp.broadcast_to(
        jnp.asarray(left4, jnp.int32)[:, None], (4, N))) != 0
    p_live = jnp.arange(WPP, dtype=jnp.int32) < n_act
    lane_n = inv % N                                  # pair slot of lane
    p_fiv = fiv.reshape(-1)[lane_n]
    p_riv = riv.reshape(-1)[lane_n]

    # ---- per-tid init ([ST, WPP], lane-minor) ------------------------
    fivc = jnp.clip(p_fiv, 0, NIV - 1)
    rivc = jnp.clip(p_riv, 0, NIV - 1)
    tids = fa.iv_tids[fivc].T                          # [ST, WPP]
    tr = fa.iv_tids[rivc].T                            # [ST, WPP]
    memb = jnp.any(tids[:, None, :] == tr[None, :, :], axis=1)
    act = p_live[None, :] & (tids >= 0) & memb         # [ST, WPP]

    # ---- pack active tids to STW slots (order-preserving) ------------
    # most pairs share only a handful of transcripts; every per-step
    # annotation gather in the wave scan is linear in the tid-lane
    # count, which the bisect measured as the walk's dominant term.
    # Lanes whose common-tid count exceeds STW defer (rare: needs > STW
    # shared isoforms at BOTH pair anchors).
    STW = min(ST, 8)
    rank1_t = jnp.cumsum(act.astype(jnp.int32), axis=0)    # [ST, WPP]
    n_tid = rank1_t[-1]                                    # [WPP]
    over_tid = p_live & (n_tid > STW)
    t_io_f = jnp.arange(ST, dtype=jnp.int32)[:, None]
    pack = jnp.stack(
        [jnp.min(jnp.where(act & (rank1_t == j + 1), t_io_f, ST), axis=0)
         for j in range(STW)], axis=0)                     # [STW, WPP]
    safe_p = jnp.clip(pack, 0, ST - 1)
    tids = jnp.take_along_axis(tids, safe_p, axis=0)
    act = (pack < ST) & ~over_tid[None, :]                 # [STW, WPP]
    ST = STW

    tc = jnp.clip(tids, 0, NT - 1)
    tstart = fa.trans_start[tc]
    toff = fa.t2s_off[tc]
    tlen = fa.t2s_off[tc + 1] - toff

    aivc = jnp.clip(p_aiv, 0, NIV - 1)
    anchor_rem = ad.iv_epos[aivc] - p_pos              # right-walk exon_len

    is_left = jnp.broadcast_to(p_left[None, :], act.shape)
    i_abs = jnp.where(is_left, p_aiv[None, :], p_aiv[None, :] + 1)
    i_abs = jnp.broadcast_to(i_abs, act.shape)
    iend = tstart + tlen - 1                           # right scan end
    istop = tstart                                     # left scan floor
    xpos = jnp.broadcast_to(p_pos[None, :], act.shape)
    exlen = jnp.where(is_left, 0, anchor_rem[None, :])
    covered = jnp.zeros(act.shape, jnp.int32)
    remref = jnp.broadcast_to((p_len + band)[None, :], act.shape)
    first = is_left                                    # left first_seg
    stat = jnp.where(act, WK_SCAN, WK_DONE)
    zero = jnp.zeros(act.shape, jnp.int32)
    pend_iv = zero
    pend_xpos = zero
    pend_exlen = zero
    pend_cov = zero
    pend_rr = zero
    nev = zero
    # events laid out [ST, EW, EV_NF, WPP]; slot e = the lane's e-th
    # emission (tid-major replay order in the fold)
    events = jnp.zeros((ST, EW, EV_NF, WPP), jnp.int32)

    qlen_b = jnp.broadcast_to(p_len[None, :], act.shape)
    pos_b = jnp.broadcast_to(p_pos[None, :], act.shape)

    def t2s_at(iv_abs):
        row = iv_abs - tstart
        ok = (row >= 0) & (row < tlen)
        return jnp.where(
            ok, fa.t2s_state[jnp.clip(toff + row, 0, NS - 1)].astype(
                jnp.int32), 0)

    def scan_step(_, c):
        (i_abs, xpos, exlen, covered, first, stat, pend_iv,
         pend_xpos, pend_exlen, pend_cov, pend_rr, remref) = c
        on = stat == WK_SCAN
        need = qlen_b - covered
        ivc = jnp.clip(i_abs, 0, NIV - 1)
        ivs = ad.iv_spos[ivc]
        ive = ad.iv_epos[ivc]
        ivl = ive - ivs + 1
        stt = t2s_at(i_abs)

        # ---- LEFT accumulate (host order: accumulate, break, flush;
        # extend.py:497-510) -------------------------------------------
        l_on = on & is_left
        ended_l = l_on & (i_abs < istop)
        l_go = l_on & ~ended_l
        nz = l_go & (stt != 0)
        new_exlen = jnp.where(nz & first, pos_b - ivs,
                              jnp.where(nz & ~first, exlen + ivl, exlen))
        xpos = jnp.where(nz & ~first & (exlen == 0), ive + 1, xpos)
        first = jnp.where(nz, False, first)
        # ---- RIGHT: break check precedes the state read (:384-386) ---
        r_on = on & ~is_left
        ended_r = r_on & (i_abs > iend)
        r_go = r_on & ~ended_r
        brk_r = r_go & (exlen >= need)
        exlen = jnp.where(l_go, new_exlen, exlen)
        brk_l = l_go & (exlen >= need)

        ended = ended_l | ended_r
        brk = brk_l | brk_r

        # ---- terminal transitions (trailing / end / done) ------------
        trail_geo = ended & (exlen > 0) & (exlen < need)
        t_inb = jnp.where(is_left,
                          (xpos - exlen >= 1) & (xpos - 1 <= G),
                          (xpos + 1 >= 1) & (xpos + exlen <= G))
        to_trail = trail_geo & t_inb
        # ref-OOB trailing: host middle fails -> walk returns, no event
        end_geo = (ended | brk) & ~trail_geo & (covered < qlen_b) \
            & (exlen >= need)
        rr2 = jnp.minimum(remref, exlen)
        # rr2 can go negative after several indel-bearing flushes
        # (remain_ref_len -= exon_len, extend.py:421/545): the host's
        # genome.get(_, len < 0) returns None -> no DP but consec set
        e_inb = (rr2 >= 0) & jnp.where(
            is_left,
            (xpos - rr2 >= 1) & (xpos - 1 <= G),
            (xpos + 1 >= 1) & (xpos + rr2 <= G))
        to_end = end_geo & e_inb
        to_endnd = end_geo & ~e_inb   # consec candidate, no DP
        to_done = (ended | brk) & ~to_trail & ~to_end & ~to_endnd

        # ---- in-loop state-1 flush -----------------------------------
        go = (l_go | r_go) & ~brk
        flush = go & (stt == 1) & (exlen > 0)
        m_inb = jnp.where(is_left,
                          (xpos - exlen >= 1) & (xpos - 1 <= G),
                          (xpos + 1 >= 1) & (xpos + exlen <= G))
        to_mid = flush & m_inb
        mid_oob = flush & ~m_inb                       # host: walk fails

        stat = jnp.where(to_trail, WK_PTRAIL,
                         jnp.where(to_end, WK_PEND,
                                   jnp.where(to_endnd, WK_PENDND,
                                             jnp.where(to_mid, WK_PMID,
                                                       jnp.where(
                                                           to_done
                                                           | mid_oob,
                                                           WK_DONE,
                                                           stat)))))
        moved = to_mid | to_trail | to_end | to_endnd
        pend_iv = jnp.where(to_mid, i_abs, pend_iv)
        pend_xpos = jnp.where(moved, xpos, pend_xpos)
        pend_exlen = jnp.where(to_mid | to_trail, exlen, pend_exlen)
        pend_cov = jnp.where(moved, covered, pend_cov)
        pend_rr = jnp.where(to_end, rr2, pend_rr)

        # ---- plain scan advance --------------------------------------
        adv = go & (stt != 1)
        # right empty flush: rspos = iv_spos - 1, then the state-1
        # interval itself accumulates (extend.py:420-428)
        r_empty = go & ~is_left & (stt == 1) & (exlen == 0)
        l_empty = go & is_left & (stt == 1) & (exlen == 0)
        acc_r = (adv | r_empty) & ~is_left & (stt != 0)
        exlen = jnp.where(acc_r, exlen + ivl, exlen)
        xpos = jnp.where(r_empty, ivs - 1, xpos)
        step_f = (adv | r_empty) & ~is_left
        step_b = (adv | l_empty) & is_left
        i_abs = jnp.where(step_f, i_abs + 1,
                          jnp.where(step_b, i_abs - 1, i_abs))
        return (i_abs, xpos, exlen, covered, first, stat, pend_iv,
                pend_xpos, pend_exlen, pend_cov, pend_rr, remref)

    io = jnp.arange(I - 1, dtype=jnp.int32)
    ew_io = jnp.arange(EW, dtype=jnp.int32)

    def emit(events, nev, mask, kind, xp, aux, ed, indel, sclen, scr):
        """Append one event per masked lane at its next slot."""
        kind_a = jnp.broadcast_to(jnp.asarray(kind, jnp.int32), xp.shape)
        upd = jnp.stack([kind_a, xp, aux, ed, indel,
                         sclen, scr], axis=1)          # [ST, NF, WPP]
        sel = (ew_io[None, :, None] == jnp.clip(nev, 0, EW - 1)[:, None, :]
               ) & mask[:, None, :]                    # [ST, EW, WPP]
        events = jnp.where(sel[:, :, None, :], upd[:, None, :, :], events)
        nev = jnp.where(mask, nev + 1, nev)
        return events, nev

    # uniform per-wave pool sizes so the whole wave runs as ONE traced
    # lax.scan body (a Python-unrolled EW-wave loop compiles about EW
    # times longer); tuple schedules collapse to max
    mp = max(MIDP) if isinstance(MIDP, (tuple, list)) else MIDP
    ep = max(ENDP) if isinstance(ENDP, (tuple, list)) else ENDP

    def wave_body(wcarry, _):
        (i_abs, xpos, exlen, covered, first, stat, pend_iv, pend_xpos,
         pend_exlen, pend_cov, pend_rr, remref, nev, events) = wcarry
        carry = (i_abs, xpos, exlen, covered, first, stat, pend_iv,
                 pend_xpos, pend_exlen, pend_cov, pend_rr, remref)
        carry = jax.lax.fori_loop(0, KSCAN, scan_step, carry)
        (i_abs, xpos, exlen, covered, first, stat, pend_iv, pend_xpos,
         pend_exlen, pend_cov, pend_rr, remref) = carry

        # ---- tid dedup: transcripts of the same pair-side usually walk
        # the SAME intervals (the host memoizes exactly these repeats,
        # extend.py align_res) — only geometry-unique lanes enter the
        # pools; duplicates read their leader's result ----------------
        def dedup(mask, fields):
            eq = mask[:, None, :] & mask[None, :, :]
            for f in fields:
                eq = eq & (f[:, None, :] == f[None, :, :])
            t_io = jnp.arange(ST, dtype=jnp.int32)
            lead = jnp.min(jnp.where(eq, t_io[None, :, None], ST),
                           axis=1)                     # [ST, WPP]
            lead = jnp.where(mask, lead, t_io[:, None])
            return lead, mask & (lead == t_io[:, None])

        def by_lead(res, lead):
            return jnp.take_along_axis(res, lead, axis=0)

        # ---- middle/trailing DP pool ---------------------------------
        m_act = (stat == WK_PMID) | (stat == WK_PTRAIL)
        m_lead, m_uniq = dedup(m_act, (pend_xpos, pend_exlen, pend_cov))
        m_inv, m_n, m_over = _compact(m_uniq.reshape(-1), mp)

        def mg(x, m_inv=m_inv):
            return x.reshape(-1)[m_inv]

        lane_m = m_inv % WPP
        ml = p_left[lane_m]
        m_xpos = mg(pend_xpos)
        m_exlen = mg(pend_exlen)
        m_cov = mg(pend_cov)
        m_qlen = p_len[lane_m]
        m_need = m_qlen - m_cov
        m_remq = jnp.minimum(m_exlen + band, m_need)
        m_row = p_row[lane_m]
        m_qs0 = p_qs0[lane_m]
        # q window: right [qs0+cov, qs0+cov+remq) forward; left
        # [qs0+qlen-cov-remq, qs0+qlen-cov) reversed (extend.py:534-535)
        qi_f = m_row[:, None] * L + (m_qs0 + m_cov)[:, None] + io[None, :]
        qi_r = m_row[:, None] * L \
            + (m_qs0 + m_qlen - m_cov - m_remq)[:, None] \
            + (m_remq[:, None] - 1 - io[None, :])
        qi = jnp.where(ml[:, None], qi_r, qi_f)
        q_win = jnp.where(io[None, :] < m_remq[:, None],
                          seqsf[jnp.clip(qi, 0, RL - 1)], jnp.int8(127))
        r_f = _gather_window(genome, m_xpos, m_exlen, I - 1)
        r_r = _gather_window(genome, m_xpos - m_exlen - 1, m_exlen, I - 1,
                             reverse=True)
        r_win = jnp.where(ml[:, None], r_r, r_f)
        md_ed, md_in = _end_dp_pool(q_win, r_win, m_remq, m_exlen,
                                    w=band, max_ed=max_ed, I=I)
        md_ed_f = by_lead(_scatter_pool(md_ed, m_inv, m_n,
                                        ST * WPP).reshape(ST, WPP), m_lead)
        md_in_f = by_lead(_scatter_pool(md_in, m_inv, m_n,
                                        ST * WPP).reshape(ST, WPP), m_lead)

        # ---- end DP pool (X-drop) ------------------------------------
        e_act = stat == WK_PEND
        e_lead, e_uniq = dedup(e_act, (pend_xpos, pend_cov, pend_rr))
        e_inv, e_n, e_over = _compact(e_uniq.reshape(-1), ep)

        def eg(x, e_inv=e_inv):
            return x.reshape(-1)[e_inv]

        lane_e = e_inv % WPP
        el = p_left[lane_e]
        e_xpos = eg(pend_xpos)
        e_cov = eg(pend_cov)
        e_rr = eg(pend_rr)
        e_need = p_len[lane_e] - e_cov
        e_row = p_row[lane_e]
        e_qs0 = p_qs0[lane_e]
        # q: right [qs0+cov, qs0+cov+need) fwd; left [qs0, qs0+need)
        # reversed (host end uses qseq[:qseq_len - covered])
        eq_f = e_row[:, None] * L + (e_qs0 + e_cov)[:, None] + io[None, :]
        eq_r = e_row[:, None] * L + e_qs0[:, None] \
            + (e_need[:, None] - 1 - io[None, :])
        eqi = jnp.where(el[:, None], eq_r, eq_f)
        t_q = jnp.where(io[None, :] < e_need[:, None],
                        seqsf[jnp.clip(eqi, 0, RL - 1)], jnp.int8(127))
        er_f = _gather_window(genome, e_xpos, e_rr, I - 1)
        er_r = _gather_window(genome, e_xpos - e_rr - 1, e_rr, I - 1,
                              reverse=True)
        s_e = jnp.where(el[:, None], er_r, er_f)
        xsc, xon_s, xon_t = xdrop_batch_ref(s_e, t_q, e_rr, e_need,
                                            w=band, mat=mat, mis=mis,
                                            ind=ind, xd=xd, I=I)
        edL, sclL, indL, scrL = _drop_wrap(xsc, xon_s, xon_t, e_need,
                                           mat=mat, mis=mis, w=band,
                                           max_ed=max_ed, max_sc=max_sc,
                                           left=True)
        edR, sclR, indR, scrR = _drop_wrap(xsc, xon_s, xon_t, e_need,
                                           mat=mat, mis=mis, w=band,
                                           max_ed=max_ed, max_sc=max_sc,
                                           left=False)
        e_ed = jnp.where(el, edL, edR)
        e_scl = jnp.where(el, sclL, sclR)
        e_ind = jnp.where(el, indL, indR)
        e_scr = jnp.where(el, scrL, scrR)
        e_ed_f = by_lead(_scatter_pool(e_ed, e_inv, e_n,
                                       ST * WPP).reshape(ST, WPP), e_lead)
        e_scl_f = by_lead(_scatter_pool(e_scl, e_inv, e_n,
                                        ST * WPP).reshape(ST, WPP), e_lead)
        e_ind_f = by_lead(_scatter_pool(e_ind, e_inv, e_n,
                                        ST * WPP).reshape(ST, WPP), e_lead)
        e_scr_f = by_lead(_scatter_pool(e_scr, e_inv, e_n,
                                        ST * WPP).reshape(ST, WPP), e_lead)

        # pool-overflow lanes keep their pending status: they retry in
        # the next wave's pool and defer if still unresolved at the end
        # (duplicates inherit their leader's overflow)
        m_over2 = by_lead(m_over.reshape(ST, WPP), m_lead)
        e_over2 = by_lead(e_over.reshape(ST, WPP), e_lead)

        # ---- commit: ONE fused emit per wave (kinds are mutually
        # exclusive per lane, and each [ST, EW, NF, WPP] event write
        # streams ~60 MB — four separate emits measurably cost) --------
        mid_c = (stat == WK_PMID) & ~m_over2
        tr_c = (stat == WK_PTRAIL) & ~m_over2
        end_c = (stat == WK_PEND) & ~e_over2
        endnd_c = stat == WK_PENDND
        any_c = mid_c | tr_c | end_c | endnd_c
        is_end_ev = end_c | endnd_c
        kind_v = jnp.where(mid_c, EVK_MID,
                           jnp.where(tr_c, EVK_TRAIL,
                                     jnp.where(end_c, EVK_END,
                                               EVK_ENDND)))
        aux_v = jnp.where(is_end_ev, pend_cov, pend_exlen)
        ed_v = jnp.where(end_c, e_ed_f, jnp.where(endnd_c, zero, md_ed_f))
        in_v = jnp.where(end_c, e_ind_f, jnp.where(endnd_c, zero,
                                                   md_in_f))
        scl_v = jnp.where(end_c, e_scl_f, zero)
        scr_v = jnp.where(end_c, e_scr_f,
                          jnp.where(endnd_c, zero, -md_ed_f))
        events, nev = emit(events, nev, any_c, kind_v, pend_xpos, aux_v,
                           ed_v, in_v, scl_v, scr_v)

        # middle commit: covered/remref advance + rescan positioning
        covered = jnp.where(mid_c, covered + pend_exlen - md_in_f,
                            covered)
        remref = jnp.where(mid_c, remref - pend_exlen, remref)
        pivc = jnp.clip(pend_iv, 0, NIV - 1)
        piv_len = ad.iv_epos[pivc] - ad.iv_spos[pivc] + 1
        # right: rspos = iv_spos[pend]-1, exlen = len(pend), i = pend+1
        # (extend.py:421-428); left: exlen = 0, i = pend-1 (:545-547)
        xpos = jnp.where(mid_c & ~is_left, ad.iv_spos[pivc] - 1, xpos)
        exlen = jnp.where(mid_c & ~is_left, piv_len,
                          jnp.where(mid_c & is_left, 0, exlen))
        i_abs = jnp.where(mid_c & ~is_left, pend_iv + 1,
                          jnp.where(mid_c & is_left, pend_iv - 1, i_abs))
        stat = jnp.where(mid_c, WK_SCAN,
                         jnp.where(tr_c | end_c | endnd_c, WK_DONE, stat))
        return (i_abs, xpos, exlen, covered, first, stat, pend_iv,
                pend_xpos, pend_exlen, pend_cov, pend_rr, remref, nev,
                events), None

    wcarry = (i_abs, xpos, exlen, covered, first, stat, pend_iv,
              pend_xpos, pend_exlen, pend_cov, pend_rr, remref, nev,
              events)
    wcarry, _ = jax.lax.scan(wave_body, wcarry, None, length=EW)
    (i_abs, xpos, exlen, covered, first, stat, pend_iv, pend_xpos,
     pend_exlen, pend_cov, pend_rr, remref, nev, events) = wcarry

    lane_defer = jnp.any((stat != WK_DONE) & act, axis=0) \
        | over_tid                                             # [WPP]
    return dict(events=events.reshape(ST * EW, EV_NF, WPP), act=act,
                inv=inv, n_act=n_act, over=over, lane_defer=lane_defer,
                p_pos=p_pos, p_len=p_len, p_live=p_live, N=N, ST=ST,
                EW=EW, WPP=WPP)


# --------------------------------------------------------------------------
# the per-family fold: replay events against (ed_th, bound)
# --------------------------------------------------------------------------

def walk_fold(wk, fam: int, ed_th, bound, *, max_ed, max_sc, band,
              left: bool):
    """Replay one extend family's events in (tid, event) order against
    that extend's actual ed_th/bound (both [B, 2, P]).  Returns
    (best dict, consec, defer) each [B, 2, P]; callers mask with their
    own active-lane set."""
    from .device_full import _scatter_pool

    N, ST, EW, WPP = wk["N"], wk["ST"], wk["EW"], wk["WPP"]
    shp3 = ed_th.shape
    inv = wk["inv"]
    fam_of = inv // N
    lane_n = inv % N
    mine = (fam_of == fam) & wk["p_live"]
    eth = ed_th.reshape(-1)[lane_n]
    bnd = bound.reshape(-1)[lane_n]
    pos = wk["p_pos"]
    qlen = wk["p_len"]
    events = wk["events"]                               # [ST*EW, NF, WPP]
    act_T = wk["act"]                                   # [ST, WPP]
    zero = jnp.zeros_like(pos)

    # initial best: extend.py:609/663 best.set(pos, edth+1, len+1, w+1,0,0)
    best0 = (pos, eth + 1, qlen + 1, jnp.full_like(pos, band + 1), zero,
             zero)
    curr0 = (bnd, zero, zero, zero, zero,
             jnp.full_like(pos, NEG_SCORE))
    KEYS = ("pos", "ed", "sclen", "indel", "qcov", "score")

    def body(s, carry):
        best_t, consec, curr_t, alive = carry
        best = dict(zip(KEYS, best_t))
        curr = dict(zip(KEYS, curr_t))
        t = s // EW
        is_first = (s % EW) == 0
        ev = jax.lax.dynamic_index_in_dim(events, s, axis=0,
                                          keepdims=False)  # [NF, WPP]
        kind, xp, aux, ed, indel, sclen, scr = [ev[i] for i in range(7)]
        tid_act = jax.lax.dynamic_index_in_dim(act_T, t, axis=0,
                                               keepdims=False)
        curr = {k: jnp.where(is_first, curr0[i], curr[k])
                for i, k in enumerate(KEYS)}
        alive = jnp.where(is_first, tid_act & mine, alive)

        is_mid = (kind == EVK_MID) | (kind == EVK_TRAIL)
        if left:
            bound_bad = xp < bnd + aux                 # aux = exon_len
        else:
            bound_bad = xp + aux > bnd
        m_act = alive & is_mid & ~bound_bad
        alive = alive & ~(is_mid & bound_bad)
        succ = m_act & (curr["ed"] + ed <= eth)
        alive = alive & ~(is_mid & ~succ)
        npos = jnp.where(left, xp - aux, xp + aux)
        c_mid = dict(pos=npos, ed=curr["ed"] + ed, sclen=zero,
                     indel=curr["indel"] - indel,
                     qcov=curr["qcov"] + aux - indel, score=scr)
        curr = {k: jnp.where(succ, c_mid[k], curr[k]) for k in curr}
        best = _fold_update_dir(best, curr, succ, max_ed, max_sc, left)
        alive = alive & ~(kind == EVK_TRAIL)

        is_end = (kind == EVK_END) | (kind == EVK_ENDND)
        need = qlen - aux                              # aux = covered
        if left:
            e_bad = xp < bnd + need
        else:
            e_bad = xp + need > bnd
        ok_geo = alive & is_end & ~e_bad
        consec = consec | (ok_geo & (xp == pos))
        dp_ok = ok_geo & (kind == EVK_END) \
            & (curr["ed"] + ed <= eth) & (sclen <= max_sc) \
            & (need - sclen >= sclen)
        epos = jnp.where(left, xp - need + indel, xp + need - indel)
        c_end = dict(pos=epos, ed=curr["ed"] + ed, sclen=sclen,
                     indel=curr["indel"] + indel,
                     qcov=curr["qcov"] + need, score=scr)
        curr = {k: jnp.where(dp_ok, c_end[k], curr[k]) for k in curr}
        best = _fold_update_score(best, curr, dp_ok, left)
        alive = alive & ~is_end
        return (tuple(best[k] for k in KEYS), consec,
                tuple(curr[k] for k in KEYS), alive)

    carry0 = (best0, jnp.zeros((WPP,), jnp.bool_), curr0,
              jnp.zeros((WPP,), jnp.bool_))
    best_t, consec, _, _ = jax.lax.fori_loop(0, ST * EW, body, carry0)
    best = dict(zip(KEYS, best_t))

    def sc(v):
        out = _scatter_pool(jnp.where(mine, v.astype(jnp.int32), 0), inv,
                            wk["n_act"], 4 * N)
        return out[fam * N:(fam + 1) * N].reshape(shp3)

    out_best = {k: sc(v) for k, v in best.items()}
    out_consec = sc(consec) != 0
    out_defer = sc(wk["lane_defer"] & mine) != 0
    over4 = wk["over"].reshape(4, -1)[fam].reshape(shp3)
    return out_best, out_consec, out_defer | over4


def _fold_update_dir(best, cand, mask, max_ed, max_sc, left):
    """AlignRes.update_right/left (_update_dir, extend.py:165-187)."""
    gt = cand["qcov"] > best["qcov"]
    lt = cand["qcov"] < best["qcov"]
    ok_lim = (cand["ed"] <= max_ed) & (cand["sclen"] <= max_sc)
    take_gt = gt & ok_lim & (2 * (cand["ed"] - best["ed"])
                             < (cand["qcov"] - best["qcov"]))
    take_lt = lt & ok_lim & (2 * (best["ed"] - cand["ed"])
                             >= (best["qcov"] - cand["qcov"]))
    if left:
        pos_better = cand["pos"] > best["pos"]
    else:
        pos_better = cand["pos"] < best["pos"]
    eq = ~gt & ~lt
    take_eq = eq & ((cand["ed"] < best["ed"])
                    | ((cand["ed"] == best["ed"])
                       & (cand["sclen"] < best["sclen"]))
                    | ((cand["ed"] == best["ed"])
                       & (cand["sclen"] == best["sclen"]) & pos_better))
    take = mask & (take_gt | take_lt | take_eq)
    return {k: jnp.where(take, cand[k], best[k]) for k in best}


def _fold_update_score(best, cand, mask, left):
    """AlignRes.update_by_score_right/left (extend.py:153-162)."""
    if left:
        better = (best["score"] < cand["score"]) | (
            (best["score"] == cand["score"]) & (cand["pos"] > best["pos"]))
    else:
        better = (best["score"] < cand["score"]) | (
            (best["score"] == cand["score"]) & (cand["pos"] < best["pos"]))
    take = mask & better
    return {k: jnp.where(take, cand[k], best[k]) for k in best}
