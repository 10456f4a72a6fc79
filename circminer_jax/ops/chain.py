"""Seed chaining: k-best sparse DP over per-k-mer seed lists.

Reference: chain_seeds_sorted_kbest / _kbest2 (src/chain.cpp:73-539).
Score of linking fragment (ii,i) before (jj,j):
    alpha = 2e4 * kmer;  beta = 0.1 * |genome_or_trans_dist - read_dist|
A link is legal when the genome gap matches the read gap within max_ed, or
when the annotation explains the gap as an exon junction (check_junction,
chain.cpp:28-64).  The per-(ii,i) search window is capped by the
annotation-aware upper bound (gene_annotation.h:123-133).

Two implementations:
- ``chain_seeds_host``: faithful host oracle, including the reference's
  event-based k-best bookkeeping (score map capped at 30 entries per score,
  stale improvement events and all) and backtrack repeat suppression.
- ``chain_batch_device``: batched jax DP producing final dp scores and
  backpointers for whole read batches; k-best extraction happens on host.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..config import Config, MAXUB, INF

REWARD_COEF = 2e4   # chain.cpp:10
PENALTY_COEF = 0.1  # chain.cpp:11


@dataclasses.dataclass
class Chain:
    """One chain: fragments as (rpos, qpos, len) triples, plus score."""
    rpos: np.ndarray
    qpos: np.ndarray
    flen: np.ndarray
    score: float

    @property
    def chain_len(self) -> int:
        return int(self.rpos.shape[0])


def check_junction_host(s1: int, s2: int, db, contig: int, iv: Optional[int],
                        kmer: int, read_dist: int, max_ed: int):
    """Port of check_junction (chain.cpp:28-64). Returns (ok, trans_dist)."""
    if iv is None:
        return False, INF
    e1 = s1 + kmer - 1
    if s2 <= e1:
        return False, INF
    ca = db.contigs[contig]
    trans_dist2intron = -1
    trans_dist = INF
    for e in db.interval_segs(contig, iv):
        e12end = int(ca.seg_end[e]) - e1
        beg2s2 = s2 - int(ca.seg_next[e])
        # 2nd kmer entirely inside the immediate intron
        if 0 <= e12end < read_dist and beg2s2 + kmer < 0:
            trans_dist2intron = s2 - e1 - 1
        if e12end < 0 or beg2s2 < 0:
            continue
        trans_dist = e12end + beg2s2
        if abs(trans_dist - read_dist) <= max_ed:
            return True, trans_dist
    if trans_dist2intron != -1:
        return True, trans_dist2intron
    return False, INF


def chain_seeds_host(seq_len: int, qpos: np.ndarray, seed_pos: List[np.ndarray],
                     cfg: Config, db=None, contig: int = 0,
                     kmer: Optional[int] = None, shift: int = 0) -> List[Chain]:
    """Host oracle for both kbest variants.

    qpos: int array per k-mer list (slot) — query start positions.
    seed_pos: per slot, ascending reference positions (may be empty).
    db/contig: annotation for junction gating (None disables lookups, as if
    never near a border).
    kmer/shift: overrides for the circ-stage variant (chain.cpp:310-539).
    """
    k = kmer if kmer is not None else cfg.kmer
    kmer_cnt = len(seed_pos)
    # drop empty lists at the back (chain.cpp:112-116)
    while kmer_cnt >= 1 and len(seed_pos[kmer_cnt - 1]) <= 0:
        kmer_cnt -= 1
    if kmer_cnt <= 0:
        return []

    dp_score = [np.full(len(seed_pos[ii]), float(k)) for ii in range(kmer_cnt)]
    dp_prev = [np.full((len(seed_pos[ii]), 2), -1, dtype=np.int64)
               for ii in range(kmer_cnt)]

    # score -> list of (score, ii, i) events, insertion-ordered, capped
    score2chain: dict = {}

    max_best = cfg.max_chain_len

    for ii in range(kmer_cnt - 2, -1, -1):
        cur_pos = seed_pos[ii]
        if len(cur_pos) == 0:
            continue
        read_remain = seq_len - int(qpos[ii]) - k
        lb_ind = [0] * kmer_cnt
        for i in range(len(cur_pos)):
            seg_start = int(cur_pos[i])
            seg_end = seg_start + k - 1
            max_lpos_lim = None  # lazily computed (chain.cpp:141,162-166)
            max_exon_end = 0
            ol_iv = None
            for jj in range(ii + 1, kmer_cnt):
                nxt = seed_pos[jj]
                if len(nxt) == 0 or lb_ind[jj] >= len(nxt):
                    continue
                if seg_start + cfg.max_intron < int(nxt[lb_ind[jj]]):
                    continue
                while lb_ind[jj] < len(nxt) and int(nxt[lb_ind[jj]]) <= seg_start:
                    lb_ind[jj] += 1
                if lb_ind[jj] >= len(nxt):
                    continue
                if max_lpos_lim is None:
                    if db is not None:
                        max_lpos_lim, max_exon_end, ol_iv = db.get_upper_bound(
                            contig, seg_start, k, read_remain, cfg.max_ed)
                    else:
                        max_lpos_lim = seg_start + read_remain + cfg.max_ed
                        max_exon_end, ol_iv = 0, None

                distr = int(qpos[jj]) - int(qpos[ii]) - k
                read_dist = distr

                j = lb_ind[jj]
                while j < len(nxt) and int(nxt[j]) <= max_lpos_lim:
                    pj = int(nxt[j])
                    if max_exon_end == 0 or (pj + k - 1) <= max_exon_end:
                        genome_dist = pj - seg_end - 1
                    else:
                        genome_dist = INF
                    if abs(genome_dist - read_dist) <= cfg.max_ed:
                        distt = genome_dist
                    else:
                        ok, td = check_junction_host(
                            seg_start, pj, db, contig, ol_iv, k, read_dist,
                            cfg.max_ed)
                        if ok:
                            distt = td
                        else:
                            j += 1
                            continue
                    beta = PENALTY_COEF * (max(distr, distt) - min(distr, distt))
                    temp_score = dp_score[jj][j] + REWARD_COEF * k - beta
                    if temp_score > dp_score[ii][i]:
                        dp_score[ii][i] = temp_score
                        dp_prev[ii][i] = (jj, j)
                        lst = score2chain.setdefault(temp_score, [])
                        if len(lst) < max_best:
                            lst.append((temp_score, ii, i))
                    j += 1

    # backtrack (chain.cpp:234-281)
    chains: List[Chain] = []
    repeats = set()
    scores_desc = sorted(score2chain.keys(), reverse=True)
    best_score = scores_desc[0] if scores_desc else float(k)

    for sc in scores_desc:
        for (ev_score, ii0, i0) in score2chain[sc]:
            if len(chains) >= max_best:
                break
            spos = int(seed_pos[ii0][i0])
            if ev_score < best_score and spos in repeats:
                continue
            rp, qp = [], []
            ii, i = ii0, i0
            first = True
            while ii != -1:
                rp.append(shift + int(seed_pos[ii][i]))
                qp.append(int(qpos[ii]))
                if not first:
                    repeats.add(rp[-1])
                first = False
                ii, i = int(dp_prev[ii][i][0]), int(dp_prev[ii][i][1])
            chains.append(Chain(
                rpos=np.array(rp, dtype=np.int64),
                qpos=np.array(qp, dtype=np.int64),
                flen=np.full(len(rp), k, dtype=np.int64),
                score=float(ev_score),
            ))

    # single-fragment fallback (chain.cpp:283-298)
    if not chains:
        for ii in range(kmer_cnt - 1, -1, -1):
            for i in range(len(seed_pos[ii])):
                if len(chains) >= max_best:
                    break
                chains.append(Chain(
                    rpos=np.array([shift + int(seed_pos[ii][i])], dtype=np.int64),
                    qpos=np.array([int(qpos[ii])], dtype=np.int64),
                    flen=np.array([k], dtype=np.int64),
                    score=float(dp_score[ii][i]),
                ))
    return chains


# --- device (jax) batched chain DP ------------------------------------------
#
# Scores are kept as int32 in 0.1-units (score10 = 10 * score): alpha10 =
# 2e5 * k per link, beta10 = |dist_t - dist_r|.  Exact integer arithmetic —
# the reference accumulates doubles, identical for all realistic magnitudes.

import jax
import jax.numpy as jnp
from functools import partial

_NEG = -(2 ** 29)


@partial(jax.jit, static_argnames=("k", "max_ed", "max_intron", "seg_pad",
                                   "max_ub_fallback", "seg_compact"))
def chain_batch_device(pos, cnt, qpos, seq_len,
                       nb_bits, iv_spos, iv_epos, iv_max_end, iv_min_end,
                       iv_max_next, iv_nseg, seg_end, seg_next,
                       *, k: int, max_ed: int, max_intron: int, seg_pad: int,
                       max_ub_fallback: int = 0, seg_compact: bool = False):
    """Batched chain DP.

    pos:  int32 [B, NL, S] seed positions (ascending per list, 0 pad)
    cnt:  int32 [B, NL]    per-list seed counts
    qpos: int32 [B, NL]    per-list query offsets (0-based)
    seq_len: int32 [B]

    Annotation arrays come from AnnoDevice. Returns (dp10, back) with
    dp10 int32 [B, NL, S] final scores and back int32 [B, NL, S] flat
    backpointer into NL*S (or -1).
    """
    B, NL, S = pos.shape
    pre = _chain_prelude(pos, cnt, qpos, seq_len, nb_bits, iv_spos, iv_epos,
                         iv_max_end, iv_min_end, iv_max_next, iv_nseg,
                         seg_end, seg_next, k=k, max_ed=max_ed,
                         seg_pad=seg_pad, seg_compact=seg_compact)
    posf, qposf, validf, ub, mee, e1, sep_c, snp_c, pv_c = pre
    dpl, bkl = _chain_dp_core_lanes(posf, qposf, validf, ub, mee, e1,
                                    sep_c, snp_c, pv_c, NL=NL, S=S, k=k,
                                    max_ed=max_ed, max_intron=max_intron)
    dp = jnp.stack(dpl, axis=0).transpose(2, 0, 1)               # [B, NL, S]
    back = jnp.stack(bkl, axis=0).transpose(2, 0, 1)
    return dp, back


def _chain_dp_core_lanes(posf, qposf, validf, ub, mee, e1, sep_c, snp_c,
                         pv_c, *, NL: int, S: int, k: int, max_ed: int,
                         max_intron: int):
    """Lane-major formulation of _chain_dp_core: every tensor carries the
    batch dimension b in the minor axis — [S, b], [S, S, b], [S, P, b] —
    so the [b, S, S] transition blocks do not have a 16-wide minor dim.
    Whether this layout pays on the GPU is open (ROADMAP 1.5).
    Bit-identical transition semantics; pinned by the same oracle tests as
    chain_batch_device.

    Returns (dpl, bkl): per-list [S, b] score / flat-backpointer pieces.
    """
    b = posf.shape[0]
    P = sep_c.shape[1]
    alpha10 = jnp.int32(200000) * k

    pos_T = posf.T                                   # [M, b]
    v_T = validf.T
    ub_T = ub.T
    mee_T = mee.T
    e1_T = e1.T
    # sep/snp/pv arrive lane-major [M, P, b] from the prelude
    sep_T = sep_c
    snp_T = snp_c
    pv_T = pv_c

    def seg(a, l):
        return a[l * S:(l + 1) * S]

    dpl = [jnp.where(seg(v_T, l), jnp.int32(10 * k), _NEG)
           for l in range(NL)]
    bkl = [jnp.full((S, b), -1, dtype=jnp.int32) for l in range(NL)]

    for l in range(NL - 2, -1, -1):
        pi = seg(pos_T, l)[:, None, :]               # [S, 1, b]
        ub_l = seg(ub_T, l)[:, None, :]
        mee_l = seg(mee_T, l)[:, None, :]
        e1_l = seg(e1_T, l)[:, None, :]
        v_l = seg(v_T, l)[:, None, :]
        sep_l = seg(sep_T, l)                        # [S, P, b]
        snp_l = seg(snp_T, l)
        pv_l = seg(pv_T, l)
        # qpos is per-list constant across its S cells
        qp_l = qposf[:, l * S][None, None, :]        # [1, 1, b]

        best_v = jnp.full((S, b), _NEG, dtype=jnp.int32)
        best_i = jnp.full((S, b), -1, dtype=jnp.int32)
        for j in range(l + 1, NL):
            pjv = seg(pos_T, j)[None, :, :]          # [1, St, b]
            v_j = seg(v_T, j)[None, :, :]
            qp_j = qposf[:, j * S][None, None, :]
            rd = qp_j - qp_l - k                     # [1, 1, b]
            # maxIntron rule (chain.cpp:148-150)
            minpos = jnp.min(jnp.where(pjv > pi, pjv,
                                       jnp.int32(2**31 - 1)),
                             axis=1, keepdims=True)  # [S, 1, b]
            base = (v_l & (minpos <= pi + max_intron) & v_j
                    & (pjv > pi) & (pjv <= ub_l))    # [S, St, b]
            ge_allowed = (mee_l == 0) | ((pjv + k - 1) <= mee_l)
            gd = pjv - pi - k
            g_ok = ge_allowed & (jnp.abs(gd - rd) <= max_ed)

            # junction gate (chain.cpp:28-64) over the pre-gathered segs
            jn_ok = jnp.zeros((S, S, b), dtype=jnp.bool_)
            jn_dist = jnp.zeros((S, S, b), jnp.int32)
            intron_any = jn_ok
            for p in range(P):
                sep3 = sep_l[:, p:p + 1, :]          # [S, 1, b]
                snp3 = snp_l[:, p:p + 1, :]
                pv3 = pv_l[:, p:p + 1, :]
                e12end3 = sep3 - e1_l
                beg2s2 = pjv - snp3                  # [S, St, b]
                td = e12end3 + beg2s2
                acc = (pv3 & (e12end3 >= 0)) & (beg2s2 >= 0) & \
                      (jnp.abs(td - rd) <= max_ed)
                jn_dist = jnp.where(~jn_ok & acc, td, jn_dist)
                jn_ok = jn_ok | acc
                intron_any = intron_any | (
                    (pv3 & (e12end3 >= 0))
                    & (e12end3 < rd) & ((beg2s2 + k) < 0))
            j_ok = (pjv > e1_l) & (jn_ok | intron_any)
            j_dist = jnp.where(jn_ok, jn_dist, pjv - e1_l - 1)
            ok = base & (g_ok | j_ok)
            distt = jnp.where(g_ok, gd, j_dist)
            sc = jnp.where(ok, alpha10 - jnp.abs(distt - rd), _NEG)

            cand = sc + dpl[j][None, :, :]           # [S, St, b]
            cv = jnp.max(cand, axis=1)               # [S, b]
            # first-max index among equal maxima (earliest flat index)
            tio = jax.lax.broadcasted_iota(jnp.int32, (1, S, 1), 1)
            ci = jnp.min(jnp.where(cand == cv[:, None, :], tio, S),
                         axis=1) + j * S
            upd = cv > best_v
            best_i = jnp.where(upd, ci, best_i)
            best_v = jnp.where(upd, cv, best_v)

        improve = best_v > dpl[l]
        dpl[l] = jnp.where(improve, best_v, dpl[l])
        bkl[l] = jnp.where(improve, best_i, bkl[l])

    return dpl, bkl


def _chain_prelude(pos, cnt, qpos, seq_len,
                   nb_bits, iv_spos, iv_epos, iv_max_end, iv_min_end,
                   iv_max_next, iv_nseg, seg_end, seg_next,
                   *, k: int, max_ed: int, seg_pad: int,
                   seg_compact: bool = False):
    """Per-cell upper bounds + pre-gathered junction tables (the
    annotation-dependent half of the chain DP; cheap, gather-heavy XLA)."""
    B, NL, S = pos.shape
    M = NL * S
    n_iv = iv_spos.shape[0]

    posf = pos.reshape(B, M)
    slot_of = jnp.repeat(jnp.arange(NL, dtype=jnp.int32), S)      # [M]
    idx_in_slot = jnp.tile(jnp.arange(S, dtype=jnp.int32), NL)
    validf = idx_in_slot[None, :] < cnt[:, slot_of]
    qposf = qpos[:, slot_of]                                      # [B, M]
    read_remain = seq_len[:, None] - qposf - k                    # [B, M]

    # ---- per-cell upper bound (gene_annotation.h:123-133, .cpp:464-533) ----
    from ..annotation.device import near_border_bit
    nb = near_border_bit(nb_bits, posf)

    # interval bisect: iv_raw = (# intervals with spos <= pos) - 1
    lo = jnp.zeros_like(posf)
    hi = jnp.full_like(posf, n_iv)
    for _ in range(max(1, int(np.ceil(np.log2(max(2, n_iv + 1)))) + 1)):
        active = lo < hi
        mid = (lo + hi) >> 1
        go_right = iv_spos[jnp.clip(mid, 0, n_iv - 1)] <= posf
        lo = jnp.where(active & go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
    iv_raw = lo - 1
    iv_c = jnp.clip(iv_raw, 0, n_iv - 1)
    found = (iv_raw >= 0) & (iv_epos[iv_c] >= posf) & (iv_nseg[iv_c] > 0)

    epos = posf + k - 1
    # intronic: bound by next interval start
    nxt = jnp.clip(iv_raw + 1, 0, n_iv - 1)
    has_nxt = (iv_raw + 1) < n_iv
    max_end_intr = jnp.where(has_nxt, iv_spos[nxt] - 1, jnp.int32(2**31 - 1))
    ub_intr = jnp.where(
        max_end_intr < epos, 0,
        jnp.minimum(posf + read_remain + max_ed, max_end_intr - k + 1))

    # exonic: aggregates, recomputed over segs ending >= epos when the kmer
    # crosses the interval end.  TWO forms: the wide [rows, M, seg_pad]
    # row-gather (one 64 B row move per index, but a wide temporary) and
    # the per-column fold (no wide temporary, seg_pad separate gathers).
    # The pipeline picks the slim form only when device memory is tight
    # (pipeline/device_pipeline.py choose_seg_compact).
    if seg_compact:
        nseg_iv = iv_nseg[iv_c]
        seg_end_T = seg_end.T
        seg_next_T = seg_next.T
        max_end_rc = jnp.zeros_like(epos)
        min_end_rc = jnp.full_like(epos, jnp.int32(10**9))
        max_next_rc = jnp.zeros_like(epos)
        for p in range(seg_pad):
            se_p = seg_end_T[p][iv_c]
            sn_p = seg_next_T[p][iv_c]
            ok = (p < nseg_iv) & (se_p >= epos)
            max_end_rc = jnp.maximum(max_end_rc, jnp.where(ok, se_p, 0))
            min_end_rc = jnp.minimum(
                min_end_rc, jnp.where(ok, se_p, jnp.int32(10**9)))
            max_next_rc = jnp.maximum(max_next_rc,
                                      jnp.where(ok, sn_p, 0))
    else:
        se_iv = seg_end[iv_c]            # [B, M, P]
        sn_iv = seg_next[iv_c]
        pvalid = (jnp.arange(seg_pad)[None, None, :]
                  < iv_nseg[iv_c][..., None])
        sel = pvalid & (se_iv >= epos[..., None])
        max_end_rc = jnp.max(jnp.where(sel, se_iv, 0), axis=-1)
        min_end_rc = jnp.min(jnp.where(sel, se_iv, jnp.int32(10**9)),
                             axis=-1)
        max_next_rc = jnp.max(jnp.where(sel, sn_iv, 0), axis=-1)
    need_rc = epos > iv_epos[iv_c]
    max_end = jnp.where(need_rc, max_end_rc, iv_max_end[iv_c])
    min_end = jnp.where(need_rc, min_end_rc, iv_min_end[iv_c])
    max_next = jnp.where(need_rc, max_next_rc, iv_max_next[iv_c])

    exonic = (max_end > 0) & (max_end >= epos)
    ub_exon = jnp.where((min_end < read_remain + epos) & (max_next != 0),
                        max_next + k - 1, max_end - k + 1)
    ub_found = jnp.where(exonic, ub_exon, 0)
    mee_found = jnp.where(exonic, max_end, 0)

    ub = jnp.where(nb, jnp.where(found, ub_found, ub_intr),
                   posf + read_remain + max_ed)
    mee = jnp.where(nb, jnp.where(found, mee_found, max_end_intr), 0)
    # reference: intronic max_end is the bound but also reported; crossing
    # boundary -> ub 0 kills transitions anyway
    mee = jnp.where(nb & ~found, max_end_intr, mee)
    ol_iv = jnp.where(nb & found & exonic, iv_c, -1)

    # ---- per-cell constants + pre-gathered junction tables ----
    # lane-major [M, P, b]; same seg_compact tradeoff as above
    e1 = posf + k - 1                                            # [B, M]
    has_iv = ol_iv >= 0
    iv_cc = jnp.clip(ol_iv, 0, n_iv - 1)
    nseg_cc = iv_nseg[iv_cc]                                     # [B, M]
    if seg_compact:
        seg_end_T2 = seg_end.T
        seg_next_T2 = seg_next.T
        sep_T = jnp.stack([seg_end_T2[p][iv_cc].T
                           for p in range(seg_pad)], axis=1)  # [M, P, b]
        snp_T = jnp.stack([seg_next_T2[p][iv_cc].T
                           for p in range(seg_pad)], axis=1)
    else:
        sep_T = jnp.moveaxis(seg_end[iv_cc], 0, -1)           # [M, P, b]
        snp_T = jnp.moveaxis(seg_next[iv_cc], 0, -1)
    pv_T = (has_iv.T[:, None, :]
            & (jnp.arange(seg_pad, dtype=jnp.int32)[None, :, None]
               < nseg_cc.T[:, None, :]))                         # [M, P, b]

    return posf, qposf, validf, ub, mee, e1, sep_T, snp_T, pv_T


def extract_kbest(dp10: np.ndarray, back: np.ndarray, pos: np.ndarray,
                  qpos: np.ndarray, cnt: np.ndarray, cfg: Config,
                  k: Optional[int] = None, shift: int = 0) -> List[Chain]:
    """Host k-best extraction from device DP results (one read).

    Near-faithful: uses final cell scores in the reference's event order
    (score desc, then list desc, then index asc) with backtrack repeat
    suppression; stale improvement events are not replayed.
    """
    k = k if k is not None else cfg.kmer
    NL, S = pos.shape
    valid = (np.arange(S)[None, :] < np.asarray(cnt)[:, None]) & (back >= 0)
    ls, ss = np.nonzero(valid)
    order = np.lexsort((ss, -ls, -dp10[ls, ss]))
    cells = [(-int(dp10[ls[i], ss[i]]), -int(ls[i]), int(ss[i]))
             for i in order]
    chains: List[Chain] = []
    repeats = set()
    best10 = -cells[0][0] if cells else 10 * k
    for negsc, negl, s0 in cells:
        if len(chains) >= cfg.max_chain_len:
            break
        l0 = -negl
        spos = int(pos[l0, s0])
        if -negsc < best10 and spos in repeats:
            continue
        rp, qp = [], []
        l, s = l0, s0
        first = True
        while l != -1:
            rp.append(shift + int(pos[l, s]))
            qp.append(int(qpos[l]))
            if not first:
                repeats.add(rp[-1])
            first = False
            b = int(back[l, s])
            if b < 0:
                break
            l, s = b // S, b % S
        chains.append(Chain(
            rpos=np.array(rp, dtype=np.int64),
            qpos=np.array(qp, dtype=np.int64),
            flen=np.full(len(rp), k, dtype=np.int64),
            score=(-negsc) / 10.0,
        ))
    if not chains:
        # single-fragment fallback, lists descending (chain.cpp:283-298)
        last = NL - 1
        while last >= 0 and cnt[last] <= 0:
            last -= 1
        for l in range(last, -1, -1):
            for s in range(int(cnt[l])):
                if len(chains) >= cfg.max_chain_len:
                    break
                chains.append(Chain(
                    rpos=np.array([shift + int(pos[l, s])], dtype=np.int64),
                    qpos=np.array([int(qpos[l])], dtype=np.int64),
                    flen=np.array([k], dtype=np.int64),
                    score=float(dp10[l, s]) / 10.0,
                ))
    return chains


@partial(jax.jit, static_argnames=("cap", "k", "max_ed", "max_intron",
                                  "seg_pad"))
def gather_and_chain_device(entry_pos, start, cnt, qpos, seq_len,
                            nb_bits, iv_spos, iv_epos, iv_max_end,
                            iv_min_end, iv_max_next, iv_nseg, seg_end,
                            seg_next, *, cap: int, k: int, max_ed: int,
                            max_intron: int, seg_pad: int):
    """Fused seed gather + chain DP: one device dispatch per bucket.

    The pipeline keeps device round-trips to one lookup + one fused call
    per occupancy bucket.  Returns (pos, dp10, back)."""
    from .seed import gather_seeds_device
    pos, _ = gather_seeds_device(entry_pos, start, cnt, cap=cap)
    dp10, back = chain_batch_device(
        pos, cnt, qpos, seq_len,
        nb_bits, iv_spos, iv_epos, iv_max_end, iv_min_end,
        iv_max_next, iv_nseg, seg_end, seg_next,
        k=k, max_ed=max_ed, max_intron=max_intron, seg_pad=seg_pad)
    return pos, dp10, back
