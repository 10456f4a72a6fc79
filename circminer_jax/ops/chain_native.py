"""ctypes bindings for the native batched chain DP
(native/chain_kernels.cpp).

Same semantics as the Python oracle ``ops.chain.chain_seeds_host`` (the
faithful port of the reference's chain_seeds_sorted_kbest,
src/chain.cpp:73-301), but one multithreaded C++ call chains a whole read
batch.  The device chain DP is ops/chain.py:chain_batch_device.
"""

from __future__ import annotations

import ctypes
import os
from typing import List

import numpy as np

from ..config import Config
from .native_build import load_library
from .chain import Chain

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = load_library("chain", ("chain_kernels.cpp",))
    # raw-pointer mode: arrays are passed as .ctypes.data ints (the callers
    # guarantee dtype + contiguity and keep references alive through the
    # call) — ndpointer from_param validation costs ~15 us per argument,
    # which dominated the circ stage's per-read chain calls
    p = ctypes.c_void_p
    ci = ctypes.c_int32
    cl = ctypes.c_int64
    lib.batch_chain.argtypes = [
        p, p, p, p, ci, ci, ci,
        p, cl,
        p, p, p, p, p, p, p, p, ci,
        ci, ci, cl, ci, cl,
        p, p, p, p, p, ci,
    ]
    lib.batch_chain.restype = None
    lib.batch_extract_kbest.argtypes = [
        p, p, p, p, p,
        ci, ci, ci, ci, ci, cl,
        p, p, p, p, p, ci,
    ]
    lib.batch_extract_kbest.restype = None
    _lib = lib
    return lib


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(
        np.asarray(a).astype(np.int64).clip(-2**31, 2**31 - 1)
    ).astype(np.int32)


class NativeChainer:
    """Batched chain DP against one contig's annotation."""

    def __init__(self, ca, cfg: Config):
        """ca: ContigAnnotation (annotation/annotation.py); None disables
        annotation gates (as if never near a border)."""
        self.lib = _load()
        self.cfg = cfg
        if ca is not None:
            self.nb = np.ascontiguousarray(ca.near_border.bits)
            self.iv_spos = _i32(ca.iv_spos)
            self.iv_epos = _i32(ca.iv_epos)
            self.iv_max_end = _i32(ca.iv_max_end)
            self.iv_min_end = _i32(ca.iv_min_end)
            self.iv_max_next = _i32(ca.iv_max_next)
            self.iv_seg_off = np.ascontiguousarray(ca.iv_seg_off,
                                                   dtype=np.int64)
            self.seg_end = _i32(ca.seg_end)
            self.seg_next = _i32(ca.seg_next)
            self.n_iv = int(ca.iv_spos.shape[0])
        else:
            self.nb = np.zeros(1, dtype=np.uint8)
            self.iv_spos = np.zeros(1, dtype=np.int32)
            self.iv_epos = np.zeros(1, dtype=np.int32)
            self.iv_max_end = np.zeros(1, dtype=np.int32)
            self.iv_min_end = np.zeros(1, dtype=np.int32)
            self.iv_max_next = np.zeros(1, dtype=np.int32)
            self.iv_seg_off = np.zeros(2, dtype=np.int64)
            self.seg_end = np.zeros(1, dtype=np.int32)
            self.seg_next = np.zeros(1, dtype=np.int32)
            self.n_iv = 0

    def chain_batch(self, pos: np.ndarray, cnt: np.ndarray,
                    qpos: np.ndarray, lens: np.ndarray,
                    k: int = None, shift: int = 0, n_threads: int = None,
                    reuse_buffers: bool = False):
        """pos int32 [R, NL, cap]; cnt/qpos int32 [R, NL]; lens int32 [R].
        Returns (rpos [R,C,NL], qp [R,C,NL], clen [R,C], score [R,C],
        n [R]) with C = cfg.max_chain_len.

        reuse_buffers=True returns instance-owned output buffers (valid
        until the next call) — for sequential per-read callers (the circ
        stage) where the allocation cost dominates the tiny DP."""
        cfg = self.cfg
        k = k if k is not None else cfg.kmer
        R, NL, cap = pos.shape
        C = cfg.max_chain_len
        if reuse_buffers:
            key = (R, C, NL)
            bufs = getattr(self, "_obuf", None)
            if bufs is None or bufs[0] != key:
                bufs = (key,
                        np.zeros((R, C, NL), dtype=np.int32),
                        np.zeros((R, C, NL), dtype=np.int32),
                        np.zeros((R, C), dtype=np.int32),
                        np.zeros((R, C), dtype=np.float64),
                        np.zeros(R, dtype=np.int32))
                self._obuf = bufs
            _, out_rpos, out_qpos, out_clen, out_score, out_n = bufs
        else:
            out_rpos = np.zeros((R, C, NL), dtype=np.int32)
            out_qpos = np.zeros((R, C, NL), dtype=np.int32)
            out_clen = np.zeros((R, C), dtype=np.int32)
            out_score = np.zeros((R, C), dtype=np.float64)
            out_n = np.zeros(R, dtype=np.int32)
        if n_threads is None:
            n_threads = cfg.resolved_threads
        a_pos = np.ascontiguousarray(pos, dtype=np.int32)
        a_cnt = np.ascontiguousarray(np.minimum(cnt, cap), dtype=np.int32)
        a_qpos = np.ascontiguousarray(qpos, dtype=np.int32)
        a_lens = np.ascontiguousarray(lens, dtype=np.int32)
        self.lib.batch_chain(
            a_pos.ctypes.data, a_cnt.ctypes.data, a_qpos.ctypes.data,
            a_lens.ctypes.data,
            R, NL, cap,
            self.nb.ctypes.data, int(self.nb.shape[0]) * 8,
            self.iv_spos.ctypes.data, self.iv_epos.ctypes.data,
            self.iv_max_end.ctypes.data, self.iv_min_end.ctypes.data,
            self.iv_max_next.ctypes.data, self.iv_seg_off.ctypes.data,
            self.seg_end.ctypes.data, self.seg_next.ctypes.data,
            self.n_iv,
            k, cfg.max_ed, cfg.max_intron, C, shift,
            out_rpos.ctypes.data, out_qpos.ctypes.data,
            out_clen.ctypes.data, out_score.ctypes.data, out_n.ctypes.data,
            n_threads)
        return out_rpos, out_qpos, out_clen, out_score, out_n

    @staticmethod
    def extract_batch(dp10: np.ndarray, back: np.ndarray, pos: np.ndarray,
                      qpos: np.ndarray, cnt: np.ndarray, k: int,
                      max_chain: int, shift: int = 0,
                      n_threads: int = None):
        """Batched k-best extraction from device chain-DP outputs
        (ops/chain.py:extract_kbest semantics).  dp10/back/pos int32
        [R, NL, S]; qpos/cnt int32 [R, NL].  Returns the batch_chain output
        layout (rpos [R,C,NL], qp [R,C,NL], clen [R,C], score [R,C],
        n [R])."""
        lib = _load()
        R, NL, S = dp10.shape
        C = max_chain
        out_rpos = np.zeros((R, C, NL), dtype=np.int32)
        out_qpos = np.zeros((R, C, NL), dtype=np.int32)
        out_clen = np.zeros((R, C), dtype=np.int32)
        out_score = np.zeros((R, C), dtype=np.float64)
        out_n = np.zeros(R, dtype=np.int32)
        if n_threads is None:
            n_threads = max(1, os.cpu_count() or 1)
        a = [np.ascontiguousarray(dp10, dtype=np.int32),
             np.ascontiguousarray(back, dtype=np.int32),
             np.ascontiguousarray(pos, dtype=np.int32),
             np.ascontiguousarray(qpos, dtype=np.int32),
             np.ascontiguousarray(cnt, dtype=np.int32)]
        lib.batch_extract_kbest(
            a[0].ctypes.data, a[1].ctypes.data, a[2].ctypes.data,
            a[3].ctypes.data, a[4].ctypes.data,
            R, NL, S, k, C, shift,
            out_rpos.ctypes.data, out_qpos.ctypes.data,
            out_clen.ctypes.data, out_score.ctypes.data,
            out_n.ctypes.data, n_threads)
        return out_rpos, out_qpos, out_clen, out_score, out_n

    @staticmethod
    def to_chains(rpos, qp, clen, score, n, k: int) -> List[Chain]:
        """Build Chain objects for one row of chain_batch outputs."""
        chains = []
        for c in range(int(n)):
            m = int(clen[c])
            chains.append(Chain(
                rpos=rpos[c, :m].astype(np.int64),
                qpos=qp[c, :m].astype(np.int64),
                flen=np.full(m, k, dtype=np.int64),
                score=float(score[c]),
            ))
        return chains
