"""Chain extension to full-read alignments (TransExtension).

Reference: src/extend.cpp.  A chain anchors the middle of the read; the
remaining prefix/suffix is aligned either directly on the genome (intron
retention / plain genomic path) or by walking the exons of each candidate
transcript (trans2seg rows), aligning within exons and soft-clip-aware at the
ends, memoizing per-(rspos, rlen, qspos, qlen) alignment results.

Execution model: every inner alignment is expressed as a
*request* — the walk methods are generators that ``yield`` request tuples
and receive results via ``send``.  Two drivers consume them:

  - the inline driver (``run_gen``) answers each request immediately with
    the scalar native-C++ aligner — exact sequential semantics, used
    by the public method wrappers (and thus by the circ stage),
  - the wave scheduler (``pipeline/extend_batch.py``) runs thousands of
    per-read generators in lockstep and solves each wave of requests as ONE
    batched device dispatch (ops/align_device.py) — the device extension
    path.

Both produce bit-identical results; parity is pinned per request kind
(tests/test_align_device.py) and end-to-end (tests/test_extend_batch.py).

Request tuples (kinds mirror align.cpp:556-723 / :219-252):
  ("edit_sc_r", s, t)   -> (ed, sclen, indel, score)
  ("edit_sc_l", s, t)   -> (ed, sclen, indel, score)
  ("drop_sc_r", s, t)   -> (ed, sclen, indel, score)
  ("drop_sc_l", s, t)   -> (ed, sclen, indel, score)
  ("end_r",     s, t)   -> (ed, indel, score)        [local_alignment_right]
  ("end_l",     s, t)   -> (ed, indel, score)
  ("one_side",  s, t, w)-> ed                        [one-sided banded]
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import Config, CONCRD, CANDID, ORPHAN, MINLB, MAXUB, INF
from ..ops import align as al
from ..utils import logging as ulog
from .types import MatchedMate

EDIT_ALIGNMENT = 1
DROP_ALIGNMENT = 0


def run_gen(gen, svc):
    """Drive a request-yielding generator to completion, answering each
    request immediately through ``svc.solve`` (the sequential path)."""
    try:
        req = next(gen)
        while True:
            req = gen.send(svc.solve(req))
    except StopIteration as e:
        return e.value


class InlineAlignService:
    """Answers alignment requests one at a time with the native scalar
    kernels (ops/align_native.py, pinned to the ops/align.py oracle by
    tests/test_align_native.py) — identical semantics to calling the
    aligner directly."""

    def __init__(self, cfg: Config, sm: al.ScoreMat):
        from ..ops.align_native import NativeAligner
        self.cfg = cfg
        self.sm = sm
        self.native = NativeAligner()

    def solve(self, req):
        kind = req[0]
        s, t = req[1], req[2]
        c = self.cfg
        na = self.native
        if kind == "edit_sc_r":
            return na.edit_local_alignment_right_sc(
                s, t, c.band_width, c.max_ed, c.max_sc)
        if kind == "edit_sc_l":
            return na.edit_local_alignment_left_sc(
                s, t, c.band_width, c.max_ed, c.max_sc)
        if kind == "drop_sc_r":
            return na.drop_local_alignment_right_sc(
                s, t, c.band_width, c.max_ed, c.max_sc, self.sm)
        if kind == "drop_sc_l":
            return na.drop_local_alignment_left_sc(
                s, t, c.band_width, c.max_ed, c.max_sc, self.sm)
        if kind == "end_r":
            return na.local_alignment_right(s, t, c.band_width, c.max_ed,
                                            c.max_sc)
        if kind == "end_l":
            return na.local_alignment_left(s, t, c.band_width, c.max_ed,
                                           c.max_sc)
        if kind == "one_side":
            return na.global_one_side_banded_alignment(s, t, req[3])
        raise ValueError(f"unknown align request kind {kind!r}")


@dataclasses.dataclass
class AlignRes:
    """align.h:12-121."""
    pos: int
    ed: int = 0
    sclen: int = 0
    indel: int = 0
    qcovlen: int = 0
    rcovlen: int = 0
    score: int = -INF

    def set(self, p, e, s, i, qc, scr):
        self.pos, self.ed, self.sclen, self.indel = p, e, s, i
        self.qcovlen = qc
        self.rcovlen = qc - i
        self.score = scr

    def update(self, edit_dist, sclength, newpos, indel, qcovlen, scr):
        self.pos = newpos
        self.ed += edit_dist
        self.sclen = sclength
        self.indel += indel
        self.qcovlen += qcovlen
        self.rcovlen += qcovlen - indel
        self.score = scr

    def copy(self) -> "AlignRes":
        return dataclasses.replace(self)

    def update_by_score_right(self, r: "AlignRes") -> bool:
        if self.score < r.score or (self.score == r.score and r.pos < self.pos):
            self.set(r.pos, r.ed, r.sclen, r.indel, r.qcovlen, r.score)
            return True
        return False

    def update_by_score_left(self, r: "AlignRes") -> bool:
        if self.score < r.score or (self.score == r.score and r.pos > self.pos):
            self.set(r.pos, r.ed, r.sclen, r.indel, r.qcovlen, r.score)
            return True
        return False

    def _update_dir(self, r: "AlignRes", max_ed: int, max_sc: int,
                    right: bool):
        if r.qcovlen > self.qcovlen:
            pre_ed = self.ed
            if (r.ed <= max_ed and r.sclen <= max_sc and
                    2 * (r.ed - pre_ed) < (r.qcovlen - self.qcovlen)):
                self.set(r.pos, r.ed, r.sclen, r.indel, r.qcovlen, r.score)
        elif r.qcovlen < self.qcovlen:
            if (r.ed <= max_ed and r.sclen <= max_sc and
                    2 * (self.ed - r.ed) >= (self.qcovlen - r.qcovlen)):
                self.set(r.pos, r.ed, r.sclen, r.indel, r.qcovlen, r.score)
        else:
            pos_better = (r.pos < self.pos) if right else (r.pos > self.pos)
            if (r.ed < self.ed or (r.ed == self.ed and r.sclen < self.sclen)
                    or (r.ed == self.ed and r.sclen == self.sclen
                        and pos_better)):
                self.set(r.pos, r.ed, r.sclen, r.indel, r.qcovlen, r.score)

    def update_right(self, r, max_ed, max_sc):
        self._update_dir(r, max_ed, max_sc, right=True)

    def update_left(self, r, max_ed, max_sc):
        self._update_dir(r, max_ed, max_sc, right=False)


class GenomeView:
    """1-based genome sequence access for one packed contig
    (pac2char, match_read.cpp:288-336)."""

    def __init__(self, codes: np.ndarray):
        self.codes = codes
        self.length = codes.shape[0]

    def get(self, start: int, length: int) -> Optional[np.ndarray]:
        if start < 1 or length < 0 or start + length - 1 > self.length:
            return None
        return self.codes[start - 1: start - 1 + length]


class TransExtension:
    """Reference: TransExtension (extend.h / extend.cpp)."""

    def __init__(self, db, contig: int, genome: GenomeView, cfg: Config,
                 align_type: int = DROP_ALIGNMENT):
        self.db = db
        self.contig = contig
        self.genome = genome
        self.cfg = cfg
        self.align_type = align_type
        self.sm = al.ScoreMat()
        self.svc = InlineAlignService(cfg, self.sm)
        # query context (used by the disabled intron-entry path; kept for
        # parity of the public interface)
        self.query_seq = None
        self.query_seq_len = 0
        self.query_spos = 0

    # --- pluggable aligner (EditDist vs Drop; circminer.cpp:74-75) ---
    def _sc_kind(self, right: bool) -> str:
        if self.align_type == EDIT_ALIGNMENT:
            return "edit_sc_r" if right else "edit_sc_l"
        return "drop_sc_r" if right else "drop_sc_l"

    # --- middle edit distance along a chain (extend.cpp:878-920) ---
    def calc_middle_ed_g(self, chain, edth: int, qseq: np.ndarray,
                         qseq_len: int):
        if chain.chain_len == 0:
            return 0
        c = self.cfg
        mid_err = 0
        for i in range(chain.chain_len - 1):
            if chain.qpos[i + 1] > chain.qpos[i] + chain.flen[i]:
                diff = int((chain.rpos[i + 1] - chain.rpos[i]) -
                           (chain.qpos[i + 1] - chain.qpos[i]))
                qspos = int(chain.qpos[i] + chain.flen[i])
                qlen = int(chain.qpos[i + 1]) - qspos
                rspos = int(chain.rpos[i] + chain.flen[i])
                rlen = max(qlen + diff, 0)
                if 0 <= diff <= c.band_width:
                    rseq = self.genome.get(rspos, rlen)
                    if rseq is None:
                        rseq = np.zeros(0, dtype=np.int8)
                    mid_err += yield ("one_side",
                                      qseq[qspos:qspos + qlen], rseq, diff)
                elif -c.band_width <= diff < 0:
                    rseq = self.genome.get(rspos, rlen)
                    if rseq is None:
                        rseq = np.zeros(0, dtype=np.int8)
                    mid_err += yield ("one_side", rseq,
                                      qseq[qspos:qspos + qlen], -diff)
                if mid_err > edth:
                    return edth + 1
        return mid_err

    def calc_middle_ed(self, chain, edth, qseq, qseq_len) -> int:
        return run_gen(self.calc_middle_ed_g(chain, edth, qseq, qseq_len),
                       self.svc)

    # --- per-exon middle/end alignments (extend.cpp:435-487, 653-705) ---
    def _extend_right_middle_g(self, pos, exon_len, qseq, qseq_len, ed_th,
                               best, curr, max_ed, max_sc):
        if ulog.TRACE_LEVEL >= 2:  # extend.cpp:438
            ulog.vaf(2, "Middle Right Ext Going for %d - %d",
                     pos + 1, pos + exon_len)
        ref_seq = self.genome.get(pos + 1, exon_len)
        if ref_seq is None:
            return False, None
        seq_remain = min(exon_len + self.cfg.band_width, qseq_len)
        ed, indel, score = yield ("end_r", qseq[:seq_remain], ref_seq)
        new_rmpos = pos + exon_len
        if ulog.TRACE_LEVEL >= 2:  # extend.cpp:451-453
            from ..ops.encode import decode_seq
            ulog.vaf(2, "rmpos: %d\textend len: %d\tindel: %d\t"
                     "edit dist: %d", new_rmpos, exon_len, -indel, ed)
            ulog.vaf(2, "str beg str:  %s\nread beg str: %s",
                     decode_seq(ref_seq), decode_seq(qseq[:seq_remain]))
        exon_res = AlignRes(new_rmpos)
        exon_res.set(new_rmpos, ed, 0, -indel, exon_len - indel, score)
        if curr.ed + ed <= ed_th:
            curr.update(ed, 0, new_rmpos, -indel, exon_len - indel, score)
            best.update_right(curr, max_ed, max_sc)
            return True, exon_res
        return False, exon_res

    def _extend_right_end_g(self, pos, ref_len, qseq, qseq_len, ed_th,
                            best, curr, max_ed, max_sc):
        if ulog.TRACE_LEVEL >= 2:  # extend.cpp:466
            ulog.vaf(2, "Final Right Ext Going for %d - %d",
                     pos + 1, pos + ref_len)
        ref_seq = self.genome.get(pos + 1, ref_len)
        if ref_seq is None:
            return None
        ed, sclen, indel, score = yield (self._sc_kind(True), ref_seq,
                                         qseq[:qseq_len])
        new_rmpos = pos + qseq_len - indel
        if ulog.TRACE_LEVEL >= 2:  # extend.cpp:477-479
            from ..ops.encode import decode_seq
            ulog.vaf(2, "rmpos: %d\textend len: %d\tindel: %d\t"
                     "edit dist: %d\tsclen: %d", new_rmpos, qseq_len,
                     indel, ed, sclen)
            ulog.vaf(2, "str beg str:  %s\nread beg str: %s",
                     decode_seq(ref_seq), decode_seq(qseq[:qseq_len]))
        exon_res = AlignRes(new_rmpos)
        exon_res.set(new_rmpos, ed, sclen, indel, qseq_len, score)
        actual_mapped = qseq_len - sclen
        if curr.ed + ed <= ed_th and sclen <= max_sc and actual_mapped >= sclen:
            curr.update(ed, sclen, new_rmpos, indel, qseq_len, score)
            best.update_by_score_right(curr)
        return exon_res

    def _extend_left_middle_g(self, pos, exon_len, qseq_part, ed_th,
                              best, curr, max_ed, max_sc):
        if ulog.TRACE_LEVEL >= 2:  # extend.cpp:656 analog
            ulog.vaf(2, "Middle Left Ext Going for %d - %d",
                     pos - exon_len, pos - 1)
        ref_seq = self.genome.get(pos - exon_len, exon_len)
        if ref_seq is None:
            return False, None
        ed, indel, score = yield ("end_l", qseq_part, ref_seq)
        new_lmpos = pos - exon_len
        if ulog.TRACE_LEVEL >= 2:  # extend.cpp:669-671
            from ..ops.encode import decode_seq
            ulog.vaf(2, "lmpos: %d\textend len: %d\tindel: %d\t"
                     "edit dist: %d", new_lmpos, exon_len, -indel, ed)
            ulog.vaf(2, "str beg str:  %s\nread beg str: %s",
                     decode_seq(ref_seq), decode_seq(qseq_part))
        exon_res = AlignRes(new_lmpos)
        exon_res.set(new_lmpos, ed, 0, -indel, exon_len - indel, score)
        if curr.ed + ed <= ed_th:
            curr.update(ed, 0, new_lmpos, -indel, exon_len - indel, score)
            best.update_left(curr, max_ed, max_sc)
            return True, exon_res
        return False, exon_res

    def _extend_left_end_g(self, pos, ref_len, qseq, qseq_len, ed_th,
                           best, curr, max_ed, max_sc):
        if ulog.TRACE_LEVEL >= 2:  # extend.cpp:684
            ulog.vaf(2, "Final Left Ext Going for %d - %d",
                     pos - ref_len, pos - 1)
        ref_seq = self.genome.get(pos - ref_len, ref_len)
        if ref_seq is None:
            return None
        ed, sclen, indel, score = yield (self._sc_kind(False), ref_seq,
                                         qseq[:qseq_len])
        new_lmpos = pos - qseq_len + indel
        if ulog.TRACE_LEVEL >= 2:  # extend.cpp:695-697
            from ..ops.encode import decode_seq
            ulog.vaf(2, "lmpos: %d\textend len: %d\tindel: %d\t"
                     "edit dist: %d\tsclen: %d", new_lmpos, qseq_len,
                     indel, ed, sclen)
            ulog.vaf(2, "str beg str:  %s\nread beg str: %s",
                     decode_seq(ref_seq), decode_seq(qseq[:qseq_len]))
        exon_res = AlignRes(new_lmpos)
        exon_res.set(new_lmpos, ed, sclen, indel, qseq_len, score)
        actual_mapped = qseq_len - sclen
        if curr.ed + ed <= ed_th and sclen <= max_sc and actual_mapped >= sclen:
            curr.update(ed, sclen, new_lmpos, indel, qseq_len, score)
            best.update_by_score_left(curr)
        return exon_res

    # --- transcript walks (extend.cpp:491-650, 708-875) ---
    def _extend_right_trans_g(self, tid, pos, ref_len, qseq, qseq_len, ed_th,
                              ub, best, align_res: Dict):
        db, c = self.db, self.contig
        cfg = self.cfg
        consecutive = False
        curr = AlignRes(ub)
        iv, it_ind = db.get_location_overlap_ind(c, pos)
        if iv is None:
            return consecutive
        it_ind_start = db.get_trans_start_ind(c, tid)
        rel_ind = it_ind - it_ind_start
        ca = db.contigs[c]

        rspos = pos
        exon_len = int(ca.iv_epos[iv]) - pos
        remain_ref_len = ref_len
        covered = 0
        t2s_len = db.trans2seg_len(c, tid)
        for i in range(rel_ind + 1, t2s_len):
            if exon_len >= qseq_len - covered:
                break
            state = db.trans2seg_state(c, tid, i)
            if state == 1:
                indel = 0
                if exon_len > 0:
                    if rspos + exon_len > ub:
                        return consecutive
                    remain_q = min(exon_len + cfg.band_width,
                                   qseq_len - covered)
                    key = (rspos, exon_len, covered, remain_q)
                    hit = align_res.get(key)
                    if hit is not None:
                        if ulog.TRACE_LEVEL >= 2:  # extend.cpp:548-549
                            ulog.vaf(2, "[Found] Middle Right Ext Going "
                                     "for %d - %d", rspos + 1,
                                     rspos + exon_len)
                            ulog.vaf(2, "rmpos: %d\textend len: %d\t"
                                     "indel: %d\tedit dist: %d", hit.pos,
                                     exon_len, hit.indel, hit.ed)
                        if curr.ed + hit.ed > ed_th:
                            return consecutive
                        curr.update(hit.ed, hit.sclen, hit.pos, hit.indel,
                                    hit.qcovlen, hit.score)
                        best.update_right(curr, cfg.max_ed, cfg.max_sc)
                        indel = hit.indel
                    else:
                        success, exon_res = yield from \
                            self._extend_right_middle_g(
                                rspos, exon_len, qseq[covered:], remain_q,
                                ed_th, best, curr, cfg.max_ed, cfg.max_sc)
                        if exon_res is not None:
                            align_res[key] = exon_res
                        if not success:
                            return consecutive
                        indel = exon_res.indel
                remain_ref_len -= exon_len
                covered += exon_len + indel
                exon_len = 0
                niv = i + it_ind_start
                rspos = int(ca.iv_spos[niv]) - 1
            if state != 0:
                niv = i + it_ind_start
                exon_len += int(ca.iv_epos[niv]) - int(ca.iv_spos[niv]) + 1

        # end of transcript with read remaining (extend.cpp:591-619)
        if 0 < exon_len < qseq_len - covered and rspos + exon_len <= ub:
            remain_q = min(exon_len + cfg.band_width, qseq_len - covered)
            key = (rspos, exon_len, covered, remain_q)
            hit = align_res.get(key)
            if hit is not None:
                if curr.ed + hit.ed > ed_th:
                    return consecutive
                curr.update(hit.ed, hit.sclen, hit.pos, hit.indel,
                            hit.qcovlen, hit.score)
                best.update_right(curr, cfg.max_ed, cfg.max_sc)
            else:
                success, exon_res = yield from self._extend_right_middle_g(
                    rspos, exon_len, qseq[covered:], remain_q, ed_th,
                    best, curr, cfg.max_ed, cfg.max_sc)
                if exon_res is not None:
                    align_res[key] = exon_res
            return consecutive

        if (covered >= qseq_len or rspos + qseq_len - covered > ub
                or exon_len < qseq_len - covered):
            return consecutive

        consecutive = rspos == pos
        remain_ref_len = min(remain_ref_len, exon_len)
        key = (rspos, remain_ref_len, covered, qseq_len - covered)
        hit = align_res.get(key)
        if hit is not None:
            if ulog.TRACE_LEVEL >= 2:  # extend.cpp:632-633
                ulog.vaf(2, "[Found] Final Right Ext Going for %d - %d",
                         rspos + 1, rspos + remain_ref_len)
                ulog.vaf(2, "rmpos: %d\textend len: %d\tindel: %d\t"
                         "edit dist: %d\tsclen: %d", hit.pos,
                         hit.qcovlen, hit.indel, hit.ed, hit.sclen)
            actual_mapped = hit.qcovlen - hit.sclen
            if (curr.ed + hit.ed > ed_th or hit.sclen > cfg.max_sc
                    or actual_mapped < hit.sclen):
                return consecutive
            curr.update(hit.ed, hit.sclen, hit.pos, hit.indel, hit.qcovlen,
                        hit.score)
            best.update_by_score_right(curr)
        else:
            exon_res = yield from self._extend_right_end_g(
                rspos, remain_ref_len, qseq[covered:], qseq_len - covered,
                ed_th, best, curr, cfg.max_ed, cfg.max_sc)
            if exon_res is not None:
                align_res[key] = exon_res
        return consecutive

    def _extend_left_trans_g(self, tid, pos, ref_len, qseq, qseq_len, ed_th,
                             lb, best, align_res: Dict):
        db, c = self.db, self.contig
        cfg = self.cfg
        consecutive = False
        curr = AlignRes(lb)
        iv, it_ind = db.get_location_overlap_ind(c, pos)
        if iv is None:
            return consecutive
        it_ind_start = db.get_trans_start_ind(c, tid)
        rel_ind = it_ind - it_ind_start
        ca = db.contigs[c]

        lepos = pos
        exon_len = 0
        remain_ref_len = ref_len
        covered = 0
        first_seg = True
        for i in range(rel_ind, -1, -1):
            state = db.trans2seg_state(c, tid, i)
            if state != 0:
                niv = i + it_ind_start
                if first_seg:
                    exon_len = pos - int(ca.iv_spos[niv])
                    first_seg = False
                else:
                    if exon_len == 0:
                        lepos = int(ca.iv_epos[niv]) + 1
                    exon_len += int(ca.iv_epos[niv]) - int(ca.iv_spos[niv]) + 1
            if exon_len >= qseq_len - covered:
                break
            if state == 1:
                indel = 0
                if exon_len > 0:
                    if lepos < lb + exon_len:
                        return consecutive
                    remain_q = min(exon_len + cfg.band_width,
                                   qseq_len - covered)
                    key = (lepos, exon_len, covered, remain_q)
                    hit = align_res.get(key)
                    if hit is not None:
                        if ulog.TRACE_LEVEL >= 2:  # extend.cpp:782-783
                            ulog.vaf(2, "[Found] Middle Left Ext Going "
                                     "for %d - %d", lepos - exon_len,
                                     lepos - 1)
                            ulog.vaf(2, "lmpos: %d\textend len: %d\t"
                                     "indel: %d\tedit dist: %d", hit.pos,
                                     exon_len, hit.indel, hit.ed)
                        if curr.ed + hit.ed > ed_th:
                            return consecutive
                        curr.update(hit.ed, hit.sclen, hit.pos, hit.indel,
                                    hit.qcovlen, hit.score)
                        best.update_left(curr, cfg.max_ed, cfg.max_sc)
                        indel = hit.indel
                    else:
                        qpart = qseq[qseq_len - covered - remain_q:
                                     qseq_len - covered]
                        success, exon_res = yield from \
                            self._extend_left_middle_g(
                                lepos, exon_len, qpart, ed_th, best, curr,
                                cfg.max_ed, cfg.max_sc)
                        if exon_res is not None:
                            align_res[key] = exon_res
                        if not success:
                            return consecutive
                        indel = exon_res.indel
                remain_ref_len -= exon_len
                covered += exon_len + indel
                exon_len = 0

        # reached transcript start with read remaining (extend.cpp:816-845)
        if 0 < exon_len < qseq_len - covered and lepos >= lb + exon_len:
            remain_q = min(exon_len + cfg.band_width, qseq_len - covered)
            key = (lepos, exon_len, covered, remain_q)
            hit = align_res.get(key)
            if hit is not None:
                if curr.ed + hit.ed > ed_th:
                    return consecutive
                curr.update(hit.ed, hit.sclen, hit.pos, hit.indel,
                            hit.qcovlen, hit.score)
                best.update_left(curr, cfg.max_ed, cfg.max_sc)
            else:
                qpart = qseq[qseq_len - covered - remain_q: qseq_len - covered]
                success, exon_res = yield from self._extend_left_middle_g(
                    lepos, exon_len, qpart, ed_th, best, curr,
                    cfg.max_ed, cfg.max_sc)
                if exon_res is not None:
                    align_res[key] = exon_res
            return consecutive

        if (covered >= qseq_len or lepos < lb + qseq_len - covered
                or exon_len < qseq_len - covered):
            return consecutive

        consecutive = lepos == pos
        remain_ref_len = min(remain_ref_len, exon_len)
        key = (lepos, remain_ref_len, covered, qseq_len - covered)
        hit = align_res.get(key)
        if hit is not None:
            if ulog.TRACE_LEVEL >= 2:  # extend.cpp:858-859
                ulog.vaf(2, "[Found] Final Left Ext Going for %d - %d",
                         lepos - remain_ref_len, lepos - 1)
                ulog.vaf(2, "lmpos: %d\textend len: %d\tindel: %d\t"
                         "edit dist: %d\tsclen: %d", hit.pos,
                         hit.qcovlen, hit.indel, hit.ed, hit.sclen)
            actual_mapped = hit.qcovlen - hit.sclen
            if (curr.ed + hit.ed > ed_th or hit.sclen > cfg.max_sc
                    or actual_mapped < hit.sclen):
                return consecutive
            curr.update(hit.ed, hit.sclen, hit.pos, hit.indel, hit.qcovlen,
                        hit.score)
            best.update_by_score_left(curr)
        else:
            exon_res = yield from self._extend_left_end_g(
                lepos, remain_ref_len, qseq, qseq_len - covered, ed_th,
                best, curr, cfg.max_ed, cfg.max_sc)
            if exon_res is not None:
                align_res[key] = exon_res
        return consecutive

    # --- public extension entry points (extend.cpp:285-432) ---
    def extend_right_g(self, common_tid, qseq, pos, length, ed_th, ub,
                       best: AlignRes):
        """Extend [pos+1, pos+length]. Returns (ok, new_pos)."""
        cfg = self.cfg
        seq_len = length
        ref_len = length + cfg.band_width
        orig_pos = pos
        consecutive = False
        curr = AlignRes(ub)
        best.set(pos, ed_th + 1, length + 1, cfg.band_width + 1, 0, 0)
        align_res: Dict = {}
        for tid in common_tid:
            consecutive = (yield from self._extend_right_trans_g(
                int(tid), pos, ref_len, qseq, seq_len, ed_th, ub, best,
                align_res)) or consecutive

        if best.ed <= ed_th:
            pos = best.pos - best.sclen
            if ulog.TRACE_LEVEL >= 2:  # extend.cpp:320
                ulog.vaf(2, "Min Edit Dist: %d\tNew RM POS: %d\tcovlen: %d",
                         best.ed, pos, best.qcovlen)
            if best.qcovlen >= seq_len and best.sclen <= cfg.max_sc:
                return True, pos

        # intron retention: contiguous genomic alignment (extend.cpp:326-341)
        ref_seq = self.genome.get(orig_pos + 1, ref_len)
        if not consecutive and ref_seq is not None:
            if ulog.TRACE_LEVEL >= 2:  # extend.cpp:330
                ulog.vaf(2, "Intron Retention:\nrmpos: %d\textend len: %d",
                         orig_pos, seq_len)
            ed, sclen, indel, score = yield (self._sc_kind(True), ref_seq,
                                             qseq[:seq_len])
            if ed <= ed_th and sclen <= cfg.max_sc:
                curr.set(orig_pos + seq_len - indel, ed, sclen, indel,
                         seq_len, score)
                if best.update_by_score_right(curr):
                    pos = orig_pos + seq_len - indel - sclen
                    return True, pos

        if best.qcovlen <= 0:
            pos = orig_pos
            best.set(pos, 0, 0, 0, 0, -INF)
        qremain = seq_len - best.qcovlen
        if qremain + best.sclen <= cfg.max_sc:
            best.set(pos, best.ed, best.sclen + qremain, best.indel, seq_len,
                     best.score)
            return True, pos
        return (best.qcovlen >= seq_len and best.ed <= ed_th), pos

    def extend_right(self, common_tid, qseq, pos, length, ed_th, ub,
                     best: AlignRes) -> Tuple[bool, int]:
        return run_gen(self.extend_right_g(common_tid, qseq, pos, length,
                                           ed_th, ub, best), self.svc)

    def extend_left_g(self, common_tid, qseq, pos, length, ed_th, lb,
                      best: AlignRes):
        """Extend [pos-length, pos-1]. Returns (ok, new_pos)."""
        cfg = self.cfg
        seq_len = length
        ref_len = length + cfg.band_width
        orig_pos = pos
        consecutive = False
        curr = AlignRes(lb)
        best.set(pos, ed_th + 1, length + 1, cfg.band_width + 1, 0, 0)
        align_res: Dict = {}
        for tid in common_tid:
            consecutive = (yield from self._extend_left_trans_g(
                int(tid), pos, ref_len, qseq, seq_len, ed_th, lb, best,
                align_res)) or consecutive

        if best.ed <= ed_th:
            pos = best.pos + best.sclen
            if ulog.TRACE_LEVEL >= 2:  # extend.cpp:396
                ulog.vaf(2, "Min Edit Dist: %d\tNew LM POS: %d\tcovlen: %d",
                         best.ed, pos, best.qcovlen)
            if best.qcovlen >= seq_len and best.sclen <= cfg.max_sc:
                return True, pos

        ref_seq = self.genome.get(orig_pos - ref_len, ref_len)
        if not consecutive and ref_seq is not None:
            if ulog.TRACE_LEVEL >= 2:  # extend.cpp:406
                ulog.vaf(2, "Intron Retention:\nlmpos: %d\textend len: %d",
                         orig_pos, seq_len)
            ed, sclen, indel, score = yield (self._sc_kind(False), ref_seq,
                                             qseq[:seq_len])
            if ed <= ed_th and sclen <= cfg.max_sc:
                curr.set(orig_pos - seq_len + indel, ed, sclen, indel,
                         seq_len, score)
                if best.update_by_score_left(curr):
                    pos = orig_pos - seq_len + indel + sclen
                    return True, pos

        if best.qcovlen <= 0:
            pos = orig_pos
            best.set(pos, 0, 0, 0, 0, -INF)
        qremain = seq_len - best.qcovlen
        if qremain + best.sclen <= cfg.max_sc:
            best.set(pos, best.ed, best.sclen + qremain, best.indel, seq_len,
                     best.score)
            return True, pos
        return (best.qcovlen >= seq_len and best.ed <= ed_th), pos

    def extend_left(self, common_tid, qseq, pos, length, ed_th, lb,
                    best: AlignRes) -> Tuple[bool, int]:
        return run_gen(self.extend_left_g(common_tid, qseq, pos, length,
                                          ed_th, lb, best), self.svc)

    # --- chain-level wrappers (extend.cpp:37-280, utils.cpp:22-153) ---

    def extend_chain_right_g(self, common_tid, chain, qseq, seq_len, ub,
                             mm: MatchedMate, err: int):
        """extend.cpp:215-246. Returns (right_ok, err)."""
        last = chain.chain_len - 1
        rm_pos = int(chain.rpos[last] + chain.flen[last] - 1)
        remain_end = seq_len - int(chain.qpos[last] + chain.flen[last])
        right_ok = remain_end <= 0
        best = AlignRes(ub)
        if remain_end > 0:
            right_ok, rm_pos = yield from self.extend_right_g(
                common_tid, qseq[seq_len - remain_end:], rm_pos, remain_end,
                self.cfg.max_ed - err, ub, best)
        sclen_right = best.sclen
        err_right = best.ed
        remain_end -= best.qcovlen
        mm.epos = rm_pos
        mm.matched_len -= sclen_right if right_ok else remain_end
        mm.qepos -= sclen_right if right_ok else remain_end
        mm.sclen_right = sclen_right
        mm.right_ed = best.ed
        return right_ok, err + err_right

    def extend_chain_right(self, common_tid, chain, qseq, seq_len, ub,
                           mm: MatchedMate, err: int) -> Tuple[bool, int]:
        return run_gen(self.extend_chain_right_g(common_tid, chain, qseq,
                                                 seq_len, ub, mm, err),
                       self.svc)

    def extend_chain_left_g(self, common_tid, chain, qseq, qspos, lb,
                            mm: MatchedMate, err: int):
        """extend.cpp:248-280. qspos is 0-based exclusive left bound."""
        lm_pos = int(chain.rpos[0])
        remain_beg = int(chain.qpos[0]) - qspos
        left_ok = remain_beg <= 0
        best = AlignRes(lb)
        if remain_beg > 0:
            left_ok, lm_pos = yield from self.extend_left_g(
                common_tid, qseq, lm_pos, remain_beg,
                self.cfg.max_ed - err, lb, best)
        sclen_left = best.sclen
        err_left = best.ed
        remain_beg -= best.qcovlen
        mm.spos = lm_pos
        mm.matched_len -= sclen_left if left_ok else remain_beg
        mm.qspos += sclen_left if left_ok else remain_beg
        mm.sclen_left = sclen_left
        mm.left_ed = best.ed
        return left_ok, err + err_left

    def extend_chain_left(self, common_tid, chain, qseq, qspos, lb,
                          mm: MatchedMate, err: int) -> Tuple[bool, int]:
        return run_gen(self.extend_chain_left_g(common_tid, chain, qseq,
                                                qspos, lb, mm, err), self.svc)

    def extend_chain_both_sides_g(self, chain, qseq, seq_len,
                                  mm: MatchedMate, direction: int):
        """Genomic-path extension of a single chain (extend.cpp:131-213)."""
        cfg = self.cfg
        mm.is_concord = False
        if chain.chain_len <= 0:
            mm.type = ORPHAN
            return mm.type
        mm.middle_ed = estimate_middle_error(chain, cfg.band_width)
        if is_concord(chain, seq_len, mm):
            mm.dir = direction
            return mm.type

        lm_pos = int(chain.rpos[0])
        remain_beg = int(chain.qpos[0])
        left_ok = remain_beg <= 0
        best_left = AlignRes(MINLB)
        if remain_beg > 0:
            left_ok, lm_pos = yield from self.extend_left_g(
                [], qseq, lm_pos, remain_beg, cfg.max_ed - mm.middle_ed,
                MINLB, best_left)
        err_left = best_left.ed
        sclen_left = best_left.sclen
        remain_beg -= best_left.qcovlen

        last = chain.chain_len - 1
        rm_pos = int(chain.rpos[last] + chain.flen[last] - 1)
        remain_end = seq_len - int(chain.qpos[last] + chain.flen[last])
        right_ok = remain_end <= 0
        best_right = AlignRes(MAXUB)
        if remain_end > 0:
            right_ok, rm_pos = yield from self.extend_right_g(
                [], qseq[seq_len - remain_end:], rm_pos, remain_end,
                cfg.max_ed - mm.middle_ed - err_left, MAXUB, best_right)
        err_right = best_right.ed
        sclen_right = best_right.sclen
        remain_end -= best_right.qcovlen

        mm.spos = lm_pos
        mm.epos = rm_pos
        mm.matched_len = seq_len
        mm.matched_len -= sclen_left if left_ok else remain_beg
        mm.matched_len -= sclen_right if right_ok else remain_end
        mm.qspos = 1 + (sclen_left if left_ok else remain_beg)
        mm.qepos = seq_len - (sclen_right if right_ok else remain_end)
        mm.right_ed = best_right.ed
        mm.left_ed = best_left.ed
        mm.dir = direction
        if (left_ok and right_ok and err_left + err_right <= cfg.max_ed
                and sclen_left <= cfg.max_sc and sclen_right <= cfg.max_sc):
            mm.is_concord = True
            mm.type = CONCRD
        elif left_ok or right_ok:
            mm.type = CANDID
        else:
            mm.type = ORPHAN
        return mm.type

    def extend_chain_both_sides(self, chain, qseq, seq_len,
                                mm: MatchedMate, direction: int) -> int:
        return run_gen(self.extend_chain_both_sides_g(chain, qseq, seq_len,
                                                      mm, direction),
                       self.svc)

    def extend_both_mates_g(self, lch, rch, common_tid, lseq, rseq,
                            lqspos, rqspos, lseq_len, rseq_len,
                            lmm: MatchedMate, rmm: MatchedMate):
        """Paired extension of two chains (extend.cpp:37-125)."""
        cfg = self.cfg
        lmm.middle_ed = yield from self.calc_middle_ed_g(
            lch, cfg.max_ed, lseq, lseq_len)
        rmm.middle_ed = yield from self.calc_middle_ed_g(
            rch, cfg.max_ed, rseq, rseq_len)
        if lmm.middle_ed <= cfg.max_ed:
            is_concord2(lch, lseq_len, lmm)
        if rmm.middle_ed <= cfg.max_ed:
            is_concord2(rch, rseq_len, rmm)
        if lmm.middle_ed > cfg.max_ed or rmm.middle_ed > cfg.max_ed:
            return False

        l_extend = True
        lmm.is_concord = False
        if lch.chain_len <= 0:
            lmm.type = ORPHAN
            lmm.matched_len = 0
            l_extend = False
        r_extend = True
        rmm.is_concord = False
        if rch.chain_len <= 0:
            rmm.type = ORPHAN
            rmm.matched_len = 0
            r_extend = False

        llok = lrok = rlok = rrok = False
        lerr = lmm.middle_ed
        rerr = rmm.middle_ed
        if l_extend:
            lmm.matched_len = lseq_len - lqspos + 1
            lmm.qspos = lqspos
            lmm.qepos = lseq_len
            llok, lerr = yield from self.extend_chain_left_g(
                common_tid, lch, lseq, lqspos - 1, MINLB, lmm, lerr)
        if r_extend:
            rmm.matched_len = rseq_len - rqspos + 1
            rmm.qspos = rqspos
            rmm.qepos = rseq_len
            rlok, rerr = yield from self.extend_chain_left_g(
                common_tid, rch, rseq, rqspos - 1,
                lmm.spos if l_extend else MINLB, rmm, rerr)
        if r_extend:
            rrok, rerr = yield from self.extend_chain_right_g(
                common_tid, rch, rseq, rseq_len, MAXUB, rmm, rerr)
        if l_extend:
            lrok, lerr = yield from self.extend_chain_right_g(
                common_tid, lch, lseq, lseq_len,
                rmm.epos if r_extend else MAXUB, lmm, lerr)
        if l_extend:
            update_match_mate_info(llok, lrok, lerr, lmm, cfg)
        if r_extend:
            update_match_mate_info(rlok, rrok, rerr, rmm, cfg)
        return True

    def extend_both_mates(self, lch, rch, common_tid, lseq, rseq,
                          lqspos, rqspos, lseq_len, rseq_len,
                          lmm: MatchedMate, rmm: MatchedMate) -> bool:
        return run_gen(self.extend_both_mates_g(
            lch, rch, common_tid, lseq, rseq, lqspos, rqspos, lseq_len,
            rseq_len, lmm, rmm), self.svc)


# --- free helpers (utils.cpp:22-153) ----------------------------------------

def estimate_middle_error(chain, band_width: int) -> int:
    """utils.cpp:35-49."""
    mid_err = 0
    for i in range(chain.chain_len - 1):
        if chain.qpos[i + 1] > chain.qpos[i] + chain.flen[i]:
            diff = int((chain.rpos[i + 1] - chain.rpos[i]) -
                       (chain.qpos[i + 1] - chain.qpos[i]))
            if diff == 0:
                mid_err += 1
            elif 0 < diff <= band_width:
                mid_err += diff
            elif -band_width <= diff < 0:
                mid_err -= diff
    return mid_err


def is_concord(chain, seq_len: int, mm: MatchedMate) -> bool:
    """utils.cpp:116-132."""
    if chain.chain_len < 2:
        mm.is_concord = False
    elif (chain.qpos[-1] + chain.flen[-1] - chain.qpos[0]) >= seq_len:
        mm.is_concord = True
        mm.type = CONCRD
        mm.spos = int(chain.rpos[0])
        mm.epos = int(chain.rpos[-1] + chain.flen[-1] - 1)
        mm.matched_len = int(chain.qpos[-1] + chain.flen[-1] - chain.qpos[0])
        mm.qspos = int(chain.qpos[0])
        mm.qepos = int(chain.qpos[-1] + chain.flen[-1] - 1)
    else:
        mm.is_concord = False
    return mm.is_concord


def is_concord2(chain, seq_len: int, mm: MatchedMate) -> bool:
    """utils.cpp:134-153 (also flags edge-anchored chains as CANDID)."""
    if chain.chain_len < 2:
        mm.is_concord = False
    elif (chain.qpos[-1] + chain.flen[-1] - chain.qpos[0]) >= seq_len:
        mm.is_concord = True
        mm.type = CONCRD
        mm.spos = int(chain.rpos[0])
        mm.epos = int(chain.rpos[-1] + chain.flen[-1] - 1)
        mm.matched_len = int(chain.qpos[-1] + chain.flen[-1] - chain.qpos[0])
        mm.qspos = int(chain.qpos[0])
        mm.qepos = int(chain.qpos[-1] + chain.flen[-1] - 1)
    else:
        mm.is_concord = False
        if (chain.qpos[0] == 0
                or chain.qpos[-1] + chain.flen[-1] == seq_len):
            mm.type = CANDID
    return mm.is_concord


def update_match_mate_info(lok: bool, rok: bool, err: int,
                           mm: MatchedMate, cfg: Config):
    """utils.cpp:22-32."""
    mm.left_ok = lok and (mm.sclen_left <= cfg.max_sc)
    mm.right_ok = rok and (mm.sclen_right <= cfg.max_sc)
    if (lok and rok and err <= cfg.max_ed and mm.sclen_right <= cfg.max_sc
            and mm.sclen_left <= cfg.max_sc):
        mm.is_concord = True
        mm.type = CONCRD
    elif lok or rok:
        mm.type = CANDID
    else:
        mm.type = ORPHAN
