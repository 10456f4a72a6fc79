"""ctypes binding for the native circRNA-calling stage
(native/circ_kernels.cpp, compiled into libfilter.so).

One multithreaded C++ call runs the whole ProcessCirc per-read lattice —
per-gene RegionalHashTable, gene-local re-chaining, exact-coordinate
extension, split classification, breakpoint realignment — over a contig's
position-sorted BSJ stream; the Python side only formats report lines.
Parity with the Python oracle (pipeline/circ.py) is pinned by
tests/test_circ_e2e.py.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np

from ..config import Config
from .filter_native import NativeFilter, _load as _load_filter, _i32, _i64, _u32

RES_W = 16
CAND_W = 24

_sig_done = False


def _lib():
    lib = _load_filter()
    global _sig_done
    if not _sig_done:
        p = ctypes.c_void_p
        ci = ctypes.c_int32
        cl = ctypes.c_int64
        anno_sig = [p, p, ci, p,
                    p, p, p, p, p,
                    p, p,
                    p, p, p, ci,
                    p, p,
                    p, cl,
                    p, ci]
        chain_sig = [p, cl, p, p, p, p, p, p, p, p, ci]
        gv_sig = [p, p, ci, p, p, p, p]
        lib.batch_circ.argtypes = (
            [p, p, ci, ci, p, p, p, cl]
            + anno_sig + chain_sig + gv_sig
            + [ci] * 11 + [cl] + [ci] * 4
            + [p, ci, p, p, ci, p, ci])
        lib.batch_circ.restype = None
        _sig_done = True
    return lib


class NativeCirc:
    """Batched stage-2 circRNA calling for one contig."""

    def __init__(self, db, contig: int, genome_codes: np.ndarray,
                 cfg: Config):
        self.lib = _lib()
        if cfg.circ_window > 12:
            raise RuntimeError("dense gene table needs circ_window <= 12")
        self.cfg = cfg
        self.contig = contig
        # filter-anno arrays (reuse NativeFilter's marshalling)
        self.nf = NativeFilter(db, contig, genome_codes, cfg, align_type=1)
        ca = db.contigs[contig]
        # chain-DP anno arrays (ops/chain_native.py NativeChainer layout)
        self.nb = np.ascontiguousarray(ca.near_border.bits)

        def i32c(a):
            return np.ascontiguousarray(
                np.asarray(a).astype(np.int64).clip(-2**31, 2**31 - 1)
            ).astype(np.int32)

        self.c_iv_spos = i32c(ca.iv_spos)
        self.c_iv_epos = i32c(ca.iv_epos)
        self.c_iv_max_end = i32c(ca.iv_max_end)
        self.c_iv_min_end = i32c(ca.iv_min_end)
        self.c_iv_max_next = i32c(ca.iv_max_next)
        self.c_iv_seg_off = _i64(ca.iv_seg_off)
        self.c_seg_end = i32c(ca.seg_end)
        self.c_seg_next = i32c(ca.seg_next)
        self.c_n_iv = int(ca.iv_spos.shape[0])
        # gene view
        self.gv_spos = _u32(ca.gv_spos)
        self.gv_epos = _u32(ca.gv_epos)
        self.n_gv = int(ca.gv_spos.shape[0])
        self.gv_seg_off = _i64(ca.gv_seg_off)
        self.gv_gene_start = _u32(ca.gv_gene_start)
        self.gv_gene_end = _u32(ca.gv_gene_end)
        self.gv_gene_id = i32c(ca.gv_gene_id)
        self.chr_names = self.nf.chr_names
        self.shift_vals = self.nf.shift_vals

    def run(self, seqs: np.ndarray, lens: np.ndarray,
            mr_state: np.ndarray, evict_pos: np.ndarray,
            n_threads: int = None) -> Tuple[np.ndarray, np.ndarray]:
        """seqs int8 [4n, L]; lens int32 [4n]; mr_state int64 [n, 20]
        (CONTIG coords); evict_pos int64 [n] (raw chr-relative spos_r1).
        Returns (res [R, RES_W] int64, cand [C, CAND_W] int64), both
        stably ordered by read index."""
        nf = self.nf
        cfg = self.cfg
        n4, L = seqs.shape
        n = n4 // 4
        if n_threads is None:
            n_threads = cfg.resolved_threads
        a_seqs = np.ascontiguousarray(seqs, dtype=np.int8)
        a_lens = _i32(lens)
        a_mr = np.ascontiguousarray(mr_state, dtype=np.int64)
        a_ev = _i64(evict_pos)
        d = lambda a: a.ctypes.data
        res_cap = 4 * n + 64
        cand_cap = 16 * n + 256
        for _ in range(8):
            out_res = np.zeros((res_cap, RES_W), dtype=np.int64)
            out_cand = np.zeros((cand_cap, CAND_W), dtype=np.int64)
            res_n = np.zeros(1, dtype=np.int32)
            cand_n = np.zeros(1, dtype=np.int32)
            self.lib.batch_circ(
                a_seqs.ctypes.data, a_lens.ctypes.data, n, L,
                a_mr.ctypes.data, a_ev.ctypes.data,
                nf.genome.ctypes.data, int(nf.genome.shape[0]),
                *nf._anno_args(),
                d(self.nb), int(self.nb.shape[0]) * 8,
                d(self.c_iv_spos), d(self.c_iv_epos), d(self.c_iv_max_end),
                d(self.c_iv_min_end), d(self.c_iv_max_next),
                d(self.c_iv_seg_off), d(self.c_seg_end), d(self.c_seg_next),
                self.c_n_iv,
                d(self.gv_spos), d(self.gv_epos), self.n_gv,
                d(self.gv_seg_off), d(self.gv_gene_start),
                d(self.gv_gene_end), d(self.gv_gene_id),
                cfg.kmer, cfg.max_ed, cfg.max_sc, cfg.band_width,
                cfg.max_tlen, cfg.scan_level, self.contig,
                1, -3, -3, 8,
                cfg.max_intron,
                cfg.circ_window, cfg.circ_step, cfg.seed_lim,
                cfg.max_chain_len,
                out_res.ctypes.data, res_cap, res_n.ctypes.data,
                out_cand.ctypes.data, cand_cap, cand_n.ctypes.data,
                n_threads)
            nr, nc = int(res_n[0]), int(cand_n[0])
            if nr <= res_cap and nc <= cand_cap:
                res = out_res[:nr]
                cand = out_cand[:nc]
                # workers stripe reads; restore stream order (stable keeps
                # each read's own record order)
                if nr:
                    res = res[np.argsort(res[:, 0], kind="stable")]
                if nc:
                    cand = cand[np.argsort(cand[:, 0], kind="stable")]
                return res, cand
            res_cap = max(res_cap * 2, nr + 64)
            cand_cap = max(cand_cap * 2, nc + 64)
        raise RuntimeError("batch_circ output buffers kept overflowing")


def sig_str(a: np.ndarray) -> str:
    """int64 char-code pair -> signal string ('' when empty)."""
    return "".join(chr(int(c)) for c in a if c != 0)
