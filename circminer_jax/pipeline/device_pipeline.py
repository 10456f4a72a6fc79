"""Batched mapping pipeline with pluggable chaining executors.

The per-read orchestration (extension, categories) runs in the native C++
finish engine (ops/filter_native.py); the seed lookup + chain DP — the hot
loops (filter.cpp:470-482, match_read.cpp:54-110, chain.cpp:73-301) — run
either on the accelerator or on host C++:

  - ``chain_exec="device"``: the index lives in device memory
    (entry_hv / entry_checksum / entry_pos arrays); per batch, ONE fused
    lookup dispatch (vectorized composite (hv, checksum) bisect over the
    sorted entry table) and one fused gather+chain-DP dispatch per
    occupancy bucket.  Only the small (start, cnt, qpos) tensors and the
    concatenated (dp10 | back) DP results cross the host boundary; k-best
    extraction and the filter engine consume them natively.
  - ``chain_exec="device-full"``: the whole finish in one fused device
    step (ops/device_full.py); deferred reads replay through host C++.
  - ``chain_exec="native"``: multithreaded host C++ lookup + chain DP.

Batches are software-pipelined two deep: while the host runs extension and
category logic for batch i, the device is already working on batch i+1.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import Iterable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config, CONCRD, CHIBSJ, CHI2BSJ
from ..annotation.device import AnnoDevice
from ..ops.chain import chain_batch_device, extract_kbest, Chain
from ..ops.seed import lookup_batch_device, gather_seeds_device
from ..utils.timing import GLOBAL_TIMER as T
from .mapping import Mapper, ReadRecord


@dataclasses.dataclass
class ContigDeviceState:
    anno: Optional[AnnoDevice]
    seeder: object  # NativeSeeder: host lookup + gather
    entry_hv: Optional[jnp.ndarray] = None      # device-resident index
    entry_checksum: Optional[jnp.ndarray] = None
    entry_pos: Optional[jnp.ndarray] = None
    entry_prefix: Optional[jnp.ndarray] = None  # radix-prefix offsets
    prefix_shift: int = 0
    prefix_iters: int = 1


@partial(jax.jit, static_argnames=("k", "cs_len", "n_slots", "seed_lim",
                                   "prefix_shift", "prefix_iters"))
def _lookup_even(reads, lens, entry_hv, entry_checksum, entry_prefix,
                 *, k, cs_len, n_slots, seed_lim, prefix_shift,
                 prefix_iters):
    """Device seed lookup; returns ONE 2-D int32 [B, 2*NL + 1] tensor
    (start | cnt | high-hit count) over the even (non-overlapping) k-mer
    slots.  qpos is NOT fetched — it is deterministic from the read length
    (slot*k when the k-mer fits) and recomputed host-side."""
    qpos, start, cnt, high = lookup_batch_device(
        reads, lens, entry_hv, entry_checksum, entry_prefix,
        k=k, cs_len=cs_len, n_slots=n_slots, seed_lim=seed_lim,
        prefix_shift=prefix_shift, prefix_iters=prefix_iters)
    hh = jnp.sum(high[:, ::2].astype(jnp.int32), axis=1)
    return jnp.concatenate([start[:, ::2], cnt[:, ::2], hh[:, None]], axis=1)


@partial(jax.jit, static_argnames=("cap", "k", "max_ed", "max_intron",
                                   "seg_pad"))
def _gather_chain_dp(entry_pos, start, cnt, qpos, lens,
                     nb_bits, iv_spos, iv_epos, iv_max_end, iv_min_end,
                     iv_max_next, iv_nseg, seg_end, seg_next,
                     *, cap, k, max_ed, max_intron, seg_pad):
    """Fused device seed gather + chain DP: one dispatch per occupancy
    bucket, one concatenated int32 [R, NL, 2*cap] = (dp10 | back) fetch."""
    pos, _ = gather_seeds_device(entry_pos, start, jnp.minimum(cnt, cap),
                                 cap=cap)
    dp10, back = chain_batch_device(
        pos, cnt, qpos, lens,
        nb_bits, iv_spos, iv_epos, iv_max_end, iv_min_end,
        iv_max_next, iv_nseg, seg_end, seg_next,
        k=k, max_ed=max_ed, max_intron=max_intron, seg_pad=seg_pad)
    R, NL = cnt.shape
    return jnp.concatenate([dp10, back], axis=-1).reshape(R * NL, 2 * cap)


def choose_seg_compact(resident_bytes: int, wide_temp_bytes: int,
                       bytes_limit) -> bool:
    """Pick the slim per-column seg fold (ops/chain.py _chain_prelude) when
    the device-resident state plus the wide form's row-gather temporaries
    would take more than half of what the device can allocate; the other
    half is left to the rest of the fused step.  A device that reports no
    limit (the host CPU backend) keeps the wide form."""
    if not bytes_limit:
        return False
    return resident_bytes + wide_temp_bytes > bytes_limit // 2


class DeviceMappingPipeline:
    """chain_exec selects the seed-lookup + chaining executor:
      - "auto" (default): estimate the device lookup's per-batch cost
        from two small timed fetches, time one host C++ lookup at warmup,
        and pick the faster of "device" and "native",
      - "device": seed lookup on the accelerator (index resident in device
        memory, one fused bisect dispatch per batch) + sparse k-best chain
        DP in host C++ (the chain DP is a tiny sparse pointer workload
        whose dense [S, M] device formulation does ~1000x the arithmetic
        of the sparse host loop),
      - "device-chain": lookup AND dense chain DP on the accelerator (the
        formulation the multi-chip sharded step uses),
      - "device-full": the fused on-device finish (ops/device_full.py),
      - "native": everything on host C++.
    The host C++ libraries are required by every executor (they replay
    deferred reads and finish the others); a failed build raises.
    """

    def __init__(self, db, gi, cfg: Config, batch_size: int = 4096,
                 seg_pad: int = 16, chain_exec: str = "auto",
                 extend_exec: str = "native"):
        self.db = db
        self.gi = gi
        self.cfg = cfg
        self.batch = batch_size
        self.seg_pad = seg_pad
        # extension executor: "native" = per-read C++ finish engine
        # (extension + categories, ops/filter_native.py), "device" = wave-
        # batched extension (generators in lockstep, each wave solved as
        # batched device DP dispatches — extend_batch.py/align_device.py)
        self.extend_exec = extend_exec
        self.align_svc = None
        self.wave_stats = {"waves": 0, "batches": 0}
        self.full_stats = {"reads": 0, "deferred": 0}
        if extend_exec == "device":
            from ..ops.align_device import DeviceAlignService
            self.align_svc = DeviceAlignService(cfg)
        from ..ops.chain_native import NativeChainer
        from ..ops.filter_native import NativeFilter
        from ..ops.seed_native import NativeSeeder
        self.chain_exec = chain_exec
        self.full_anno: List[object] = []
        self.full_genome: List[object] = []
        self.states: List[ContigDeviceState] = []
        self.mappers: List[Mapper] = []
        self.chainers: List[object] = []
        for c, ci in enumerate(gi.contigs):
            anno = (AnnoDevice.from_contig(db.contigs[c], seg_pad=seg_pad)
                    if chain_exec in ("device-chain", "device-full")
                    else None)
            if chain_exec == "device-full":
                from ..annotation.device import FinishAnnoDevice
                self.full_anno.append(FinishAnnoDevice.from_contig(
                    db.contigs[c], db.con2chr[c], seg_pad=seg_pad))
                self.full_genome.append(jnp.asarray(ci.codes))
            else:
                self.full_anno.append(None)
                self.full_genome.append(None)
            st = ContigDeviceState(anno=anno, seeder=NativeSeeder(ci, cfg))
            if chain_exec in ("device", "device-chain", "auto",
                              "device-full"):
                st.entry_hv = jnp.asarray(ci.entry_hv)
                # int16 on device: the composite bisect upcasts per probe
                # (ops/seed._bisect_hv_cv), and a GRCh38 contig's ~1.05 G
                # entries take 2.1 GB less device memory than as int32
                # (10 B/entry in all)
                st.entry_checksum = jnp.asarray(ci.entry_checksum)
                st.entry_pos = jnp.asarray(ci.entry_pos)
                from ..ops.seed import build_device_prefix
                pref, st.prefix_shift, st.prefix_iters = \
                    build_device_prefix(ci.entry_hv, cfg.window_size)
                st.entry_prefix = (jnp.asarray(pref) if pref is not None
                                   else None)
            self.states.append(st)
            self.mappers.append(Mapper(db, c, ci.codes, cfg, seeder=None))
            if chain_exec in ("native", "device", "auto", "device-full"):
                self.chainers.append(NativeChainer(db.contigs[c], cfg))
            else:
                self.chainers.append(None)
        # native per-read finish engine (extension + categories in C++)
        self.filters = [NativeFilter(db, c, ci.codes, cfg)
                        for c, ci in enumerate(gi.contigs)]
        self.n_lists = cfg.n_kmer_lists
        self.seg_compact = (self._seg_compact(cap=16)
                            if chain_exec == "device-full" else False)

    # ---- stage 1: encode + lookup dispatch ----
    def _encode(self, recs, pad_rows: Optional[int] = None):
        cfg = self.cfg
        n = len(recs)
        L = cfg.max_read_len
        R = 4 * n if pad_rows is None else pad_rows
        with T.phase("encode"):
            seqs = np.zeros((R, L), dtype=np.int8)
            lens = np.zeros(R, dtype=np.int32)
            for i, (r1, r2) in enumerate(recs):
                for o, s in enumerate((r1.seq, r1.rcseq, r2.seq, r2.rcseq)):
                    seqs[4 * i + o, :len(s)] = s
                    lens[4 * i + o] = len(s)
        return seqs, lens

    def _encode_se(self, recs, pad_rows: Optional[int] = None):
        """2 rows per read: (fwd, rc) — the SE layout (filter.cpp:86-121)."""
        cfg = self.cfg
        n = len(recs)
        L = cfg.max_read_len
        R = 2 * n if pad_rows is None else pad_rows
        with T.phase("encode"):
            seqs = np.zeros((R, L), dtype=np.int8)
            lens = np.zeros(R, dtype=np.int32)
            for i, r in enumerate(recs):
                for o, s in enumerate((r.seq, r.rcseq)):
                    seqs[2 * i + o, :len(s)] = s
                    lens[2 * i + o] = len(s)
        return seqs, lens

    def dispatch_lookup(self, recs, contig: int, rpr: int = 4):
        """rpr = rows per record: 4 for PE (r1f, r1rc, r2f, r2rc),
        2 for SE (fwd, rc)."""
        cfg = self.cfg
        st = self.states[contig]
        enc = self._encode if rpr == 4 else self._encode_se
        if self.chain_exec == "device-full" and rpr == 4:
            return self._dispatch_full(recs, contig)
        if self.chain_exec in ("device", "device-chain", "auto"):
            # pad to the compiled batch shape so the last partial batch
            # reuses the warm executable
            seqs, lens = enc(recs, pad_rows=rpr * self.batch)
            with T.phase("lookup_dispatch"):
                packed = _lookup_even(
                    jnp.asarray(seqs), jnp.asarray(lens),
                    st.entry_hv, st.entry_checksum, st.entry_prefix,
                    k=cfg.kmer, cs_len=cfg.checksum_len,
                    n_slots=cfg.max_seg_cnt, seed_lim=cfg.seed_lim,
                    prefix_shift=st.prefix_shift,
                    prefix_iters=st.prefix_iters)
            # fetch in the background so the d2h transfer overlaps the host
            # chain/filter work of the previous batch
            import threading
            holder = {}

            def _bg_fetch():
                holder["arr"] = np.asarray(packed)

            th = threading.Thread(target=_bg_fetch, daemon=True)
            th.start()
            return dict(recs=recs, contig=contig, dev_lookup=packed,
                        fetch_thread=th, fetch_holder=holder,
                        lens=lens, seqs=seqs, rpr=rpr)
        seqs, lens = enc(recs)
        with T.phase("host_lookup"):
            qpos, start, cnt, high = st.seeder.lookup(seqs, lens)
        return dict(recs=recs, contig=contig, qpos=qpos, start=start,
                    cnt=cnt, high=high, lens=lens, seqs=seqs, rpr=rpr)

    def _fetch_lookup(self, lf):
        """Fetch the device lookup result and rewrite lf to host layout,
        truncated to the real (unpadded) row count.  qpos is recomputed
        host-side (slot*k when the k-mer fits the read)."""
        with T.phase("lookup_fetch"):
            th = lf.get("fetch_thread")
            if th is not None:
                th.join()
                packed_h = lf["fetch_holder"]["arr"]  # [R, 2*NL + 1] int32
            else:
                packed_h = np.asarray(lf["dev_lookup"])
        NL = self.n_lists
        k = self.cfg.kmer
        n_rows = lf.get("rpr", 4) * len(lf["recs"])
        lens = lf["lens"][:n_rows]
        ql = (np.arange(NL, dtype=np.int32) * k)[None, :]
        qpos = np.where(ql + k <= lens[:, None], ql, 0).astype(np.int32)
        return dict(recs=lf["recs"], contig=lf["contig"],
                    qpos=qpos,
                    start=packed_h[:n_rows, :NL],
                    cnt=packed_h[:n_rows, NL:2 * NL],
                    high=packed_h[:n_rows, 2 * NL].copy(),
                    lens=lens, seqs=lf["seqs"][:n_rows],
                    rpr=lf.get("rpr", 4))

    # ---- the fused device-full executor ------------------------------
    def _full_statics(self):
        cfg = self.cfg
        from ..ops.align import ScoreMat
        sm = ScoreMat()
        B = self.batch
        return dict(
            k=cfg.kmer, cs_len=cfg.checksum_len, n_slots=cfg.max_seg_cnt,
            seed_lim=cfg.seed_lim, cap=16, max_ed=cfg.max_ed,
            max_sc=cfg.max_sc, band=cfg.band_width, max_tlen=cfg.max_tlen,
            max_intron=cfg.max_intron, seg_pad=self.seg_pad,
            scan_level=cfg.scan_level, KB=6, P_MAX=8, W_MAX=16,
            # pool budgets sized from the chr21 deferral histogram
            # (ospool/xdpool overflow deferred ~35% of reads at B//4 /
            # B//2)
            OS_POOL=max(2048, B), XD_POOL=max(4096, 2 * B),
            EX_ITERS=48, mat=sm.mat, mis=sm.mis, ind=sm.ind, xd=sm.xd,
            # walk-engine budgets (ops/device_walk.py): EW DP waves of
            # KSCAN-interval scans over a WPP-lane pool; unresolved lanes
            # defer (DEF_EXTWALK), so these trade pool compute for
            # deferral rate, never correctness
            # uniform per-wave pools (the wave loop is ONE lax.scan body,
            # so pool size is the only per-wave cost knob); tid dedup
            # keeps demand near the unique-walk count, and overflowed
            # lanes retry the next wave before deferring
            EW=4, KSCAN=12, WPP=max(512, (3 * B) // 2),
            MIDP=max(512, B // 8), ENDP=max(1024, B // 4),
            seg_compact=self.seg_compact)

    def _seg_compact(self, cap: int) -> bool:
        """Slim or wide seg tables in the fused step's chain prelude, from
        what this device can allocate (choose_seg_compact)."""
        # device-resident state of every contig: 10 B per index entry
        # (int32 hv + int16 checksum + int32 pos) + 1 B per genome base
        resident = sum(10 * ci.entry_hv.shape[0] + ci.codes.shape[0]
                       for ci in self.gi.contigs)
        # the wide form's four [4B, NL*cap, seg_pad] int32 row-gather
        # temporaries (two per table: the ub fold and the junction tables)
        wide = 4 * (4 * self.batch) * (self.n_lists * cap) \
            * self.seg_pad * 4
        stats = jax.local_devices()[0].memory_stats() or {}
        return choose_seg_compact(resident, wide, stats.get("bytes_limit"))

    def _dispatch_full(self, recs, contig: int):
        from ..ops.device_full import device_full_step, MRF
        from ..ops.filter_native import NativeFilter
        from .types import MatchedRead
        cfg = self.cfg
        st = self.states[contig]
        nf = self.filters[contig]
        seqs, lens = self._encode(recs, pad_rows=4 * self.batch)
        with T.phase("full_state"):
            default_row = NativeFilter.mr_to_state(
                MatchedRead.default(cfg.max_ed), nf.chr_names)
            mr_in = np.tile(default_row, (self.batch, 1))
            for i, (r1, _) in enumerate(recs):
                if r1.mr.touched:
                    mr_in[i] = NativeFilter.mr_to_state(r1.mr, nf.chr_names)
            mr_in = np.ascontiguousarray(mr_in.astype(np.int32))
        with T.phase("full_dispatch"):
            fut = device_full_step(
                jnp.asarray(seqs), jnp.asarray(lens), jnp.asarray(mr_in),
                st.entry_hv, st.entry_checksum, st.entry_pos,
                self.full_genome[contig], st.anno, self.full_anno[contig],
                st.entry_prefix, contig_num=contig,
                prefix_shift=st.prefix_shift,
                prefix_iters=st.prefix_iters, **self._full_statics())
        import threading
        holder = {}

        def _bg_fetch():
            holder["arr"] = np.asarray(fut)

        th = threading.Thread(target=_bg_fetch, daemon=True)
        th.start()
        return dict(recs=recs, contig=contig, full_fut=fut,
                    fetch_thread=th, fetch_holder=holder,
                    seqs=seqs, lens=lens, full=True)

    def _finish_full(self, cf) -> None:
        from ..ops.filter_native import NativeFilter
        recs = cf["recs"]
        n = len(recs)
        contig = cf["contig"]
        nf = self.filters[contig]
        with T.phase("full_fetch"):
            cf["fetch_thread"].join()
            blob = cf["fetch_holder"]["arr"]          # [B, MRF+1] int32
        dbits = blob[:n, -1]
        defer = dbits != 0
        # per-cause histogram (a read may carry several cause bits)
        from ..ops.device_full import DEFER_CAUSES
        causes = self.full_stats.setdefault("causes", {})
        for i, name in enumerate(DEFER_CAUSES):
            c = int(((dbits >> i) & 1).sum())
            if c:
                causes[name] = causes.get(name, 0) + c
        mr_state = blob[:n, :-1].astype(np.int64)
        with T.phase("full_writeback"):
            for i, (r1, _) in enumerate(recs):
                if not defer[i]:
                    NativeFilter.state_to_mr(mr_state[i], r1.mr,
                                             nf.chr_names)
        n_def = int(defer.sum())
        self.full_stats["reads"] += n
        self.full_stats["deferred"] += n_def
        if n_def:
            with T.phase("full_replay"):
                idx = np.nonzero(defer)[0]
                sub = [recs[i] for i in idx]
                rows = np.array([4 * i + o for i in idx for o in range(4)],
                                dtype=np.int64)
                lf = dict(recs=sub, contig=contig,
                          seqs=np.ascontiguousarray(cf["seqs"][rows]),
                          lens=np.ascontiguousarray(cf["lens"][rows]),
                          rpr=4)
                with T.phase("host_lookup"):
                    qpos, start, cnt, high = \
                        self.states[contig].seeder.lookup(lf["seqs"],
                                                          lf["lens"])
                lf.update(qpos=qpos, start=start, cnt=cnt, high=high)
                cf2 = self._chain_native(lf)
                self._finish_native(cf2)

    # ---- stage 2: bucket by occupancy, dispatch chain DP ----
    def dispatch_chain(self, lf):
        if lf.get("full"):
            return lf
        if "dev_lookup" in lf:
            lf = self._fetch_lookup(lf)
        if self.chain_exec in ("native", "device", "auto"):
            return self._chain_native(lf)
        cfg = self.cfg
        st = self.states[lf["contig"]]
        ad = st.anno
        qpos_h = np.maximum(lf["qpos"], 0)
        start_h = lf["start"]
        cnt_h = lf["cnt"]
        hh_h = lf["high"]
        maxocc = cnt_h.max(axis=1) if cnt_h.shape[1] > 0 else \
            np.zeros(len(cnt_h), np.int32)
        buckets = []
        prev = 0
        for cap in self._caps():
            rows = np.nonzero((maxocc <= cap) & (maxocc > prev))[0] \
                if prev else np.nonzero(maxocc <= cap)[0]
            prev = cap
            if len(rows) == 0:
                continue
            chunk = self._chunk_for(cap)
            for c0 in range(0, len(rows), chunk):
                sub = rows[c0:c0 + chunk]
                R = len(sub)
                start_p = np.zeros((chunk, cnt_h.shape[1]), np.int32)
                start_p[:R] = start_h[sub]
                cnt_p = np.zeros((chunk, cnt_h.shape[1]), np.int32)
                cnt_p[:R] = cnt_h[sub]
                qpos_p = np.zeros((chunk, cnt_h.shape[1]), np.int32)
                qpos_p[:R] = qpos_h[sub]
                lens_p = np.zeros(chunk, np.int32)
                lens_p[:R] = lf["lens"][sub]
                with T.phase(f"chain_dispatch_cap{cap}"):
                    fut = _gather_chain_dp(
                        st.entry_pos, jnp.asarray(start_p),
                        jnp.asarray(cnt_p), jnp.asarray(qpos_p),
                        jnp.asarray(lens_p),
                        ad.nb_bits, ad.iv_spos, ad.iv_epos, ad.iv_max_end,
                        ad.iv_min_end, ad.iv_max_next, ad.iv_nseg,
                        ad.seg_end, ad.seg_next,
                        cap=cap, k=cfg.kmer, max_ed=cfg.max_ed,
                        max_intron=cfg.max_intron, seg_pad=ad.seg_pad)
                buckets.append((sub, cap, start_h[sub], cnt_h[sub],
                                qpos_h[sub], fut))
        return dict(recs=lf["recs"], contig=lf["contig"], buckets=buckets,
                    cnt=cnt_h, qpos=qpos_h, hh=hh_h, seqs=lf["seqs"],
                    lens=lf["lens"], device=True, rpr=lf.get("rpr", 4))

    def _chain_native(self, lf):
        """Host path: gather + multithreaded C++ chain DP, occupancy-bucketed
        so the dense [R, NL, cap] seed tensor stays small for typical rows."""
        cfg = self.cfg
        st = self.states[lf["contig"]]
        chainer = self.chainers[lf["contig"]]
        cnt_h = lf["cnt"]
        qpos_h = np.maximum(lf["qpos"], 0)
        maxocc = cnt_h.max(axis=1) if cnt_h.shape[1] > 0 else \
            np.zeros(len(cnt_h), np.int32)
        parts = []
        prev = 0
        for cap in self._caps():
            rows = np.nonzero((maxocc <= cap) & (maxocc > prev))[0] \
                if prev else np.nonzero(maxocc <= cap)[0]
            prev = cap
            if len(rows) == 0:
                continue
            with T.phase(f"gather_cap{cap}"):
                pos_b = st.seeder.gather(
                    lf["start"][rows], np.minimum(cnt_h[rows], cap), cap)
            with T.phase(f"chain_native_cap{cap}"):
                rp, qp, cl, sc, n = chainer.chain_batch(
                    pos_b, cnt_h[rows], qpos_h[rows], lf["lens"][rows])
            parts.append((rows, rp, qp, cl, sc, n))
        return dict(recs=lf["recs"], contig=lf["contig"], parts=parts,
                    cnt=cnt_h, qpos=qpos_h, hh=lf["high"], native=True,
                    seqs=lf["seqs"], lens=lf["lens"], rpr=lf.get("rpr", 4))

    # ---- stage 3: fetch chains, finish on host ----
    def finish(self, cf) -> None:
        if cf.get("full"):
            return self._finish_full(cf)
        if self.extend_exec == "device":
            return self._finish_wave(cf)
        if cf.get("native"):
            return self._finish_native(cf)
        return self._finish_device(cf)

    def _finish_wave(self, cf) -> None:
        """Wave-batched finish: per-read generators run in lockstep, every
        wave of inner alignments solved as batched device dispatches (the
        batched formulation of extend.cpp:37-125 / filter.cpp:244-395)."""
        from .extend_batch import run_waves
        cfg = self.cfg
        recs = cf["recs"]
        n = len(recs)
        hh_h = cf["hh"]
        k = cfg.kmer
        chains_out: List = [None] * (4 * n)
        if cf.get("native"):
            from ..ops.chain_native import NativeChainer
            for rows, rp, qp, cl, sc, cn in cf["parts"]:
                for ri, r in enumerate(rows):
                    if r < 4 * n:
                        chains_out[r] = NativeChainer.to_chains(
                            rp[ri], qp[ri], cl[ri], sc[ri], cn[ri], k)
        else:
            from ..ops.chain import extract_kbest
            st = self.states[cf["contig"]]
            for rows, cap, start_b, cnt_b, qpos_b, fut in cf["buckets"]:
                with T.phase(f"chain_fetch_cap{cap}"):
                    fut.block_until_ready()
                    blob = np.asarray(fut).reshape(-1, self.n_lists, 2 * cap)
                pos_b = st.seeder.gather(start_b, np.minimum(cnt_b, cap),
                                         cap)
                for ri, r in enumerate(rows):
                    if r < 4 * n:
                        chains_out[r] = extract_kbest(
                            blob[ri, :, :cap], blob[ri, :, cap:], pos_b[ri],
                            qpos_b[ri], cnt_b[ri], cfg)
        mapper = self.mappers[cf["contig"]]
        from .types import round_skip
        gens = []
        with T.phase("wave_finish"):
            for i, (r1, r2) in enumerate(recs):
                if round_skip(r1.mr, r1.seq_len, r2.seq_len, cfg.scan_level):
                    continue
                quad = []
                for o in range(4):
                    r = 4 * i + o
                    ch = chains_out[r] if chains_out[r] is not None else []
                    quad.append((ch, int(hh_h[r])))
                gens.append(mapper.process_read_pe_g(r1, r2, tuple(quad)))
            _, n_waves = run_waves(gens, self.align_svc)
            self.wave_stats["waves"] += n_waves
            self.wave_stats["batches"] += 1

    def _finish_device(self, cf) -> None:
        """Fetch per-bucket DP results, extract k-best chains natively, and
        finish through the C++ filter engine (extension + categories)."""
        from ..ops.chain_native import NativeChainer
        cfg = self.cfg
        st = self.states[cf["contig"]]
        recs = cf["recs"]
        n = len(recs)
        k = cfg.kmer
        C = cfg.max_chain_len
        NL = self.n_lists
        from ..utils import logging as ulog
        nf = self.filters[cf["contig"]]
        # -d >= 1 routes the finish through the python orchestration, which
        # carries the per-read vaf trace channel end-to-end (the C++ engine
        # is opaque to it) — the reference's `make verbose` story
        use_native = ulog.TRACE_LEVEL < 1
        R_full = cf["cnt"].shape[0]

        if use_native:
            rp_f = np.zeros((R_full, C, NL), np.int32)
            qp_f = np.zeros((R_full, C, NL), np.int32)
            cl_f = np.zeros((R_full, C), np.int32)
            sc_f = np.zeros((R_full, C), np.float64)
            cn_f = np.zeros(R_full, np.int32)
            for rows, cap, start_b, cnt_b, qpos_b, fut in cf["buckets"]:
                with T.phase(f"chain_fetch_cap{cap}"):
                    fut.block_until_ready()
                    blob = np.asarray(fut).reshape(-1, NL, 2 * cap)
                Rb = len(rows)
                dp10 = blob[:Rb, :, :cap]
                back = blob[:Rb, :, cap:]
                with T.phase(f"gather_cap{cap}"):
                    pos_b = st.seeder.gather(
                        start_b, np.minimum(cnt_b, cap), cap)
                with T.phase(f"extract_cap{cap}"):
                    rp, qp, cl, sc, cn = NativeChainer.extract_batch(
                        dp10, back, pos_b, qpos_b, cnt_b, k, C,
                        n_threads=cfg.resolved_threads)
                rp_f[rows] = rp
                qp_f[rows] = qp
                cl_f[rows] = cl
                sc_f[rows] = sc
                cn_f[rows] = cn
            self._filter_batch(recs, cf["seqs"][:4 * n], cf["lens"][:4 * n],
                               rp_f[:4 * n], qp_f[:4 * n], cl_f[:4 * n],
                               sc_f[:4 * n], cn_f[:4 * n],
                               cf["hh"][:4 * n], cf["contig"])
            return

        # -d trace path: per-read extraction + python orchestration
        cnt_h, qpos_h, hh_h = cf["cnt"], cf["qpos"], cf["hh"]
        dp_out = [None] * (4 * n)
        back_out = [None] * (4 * n)
        pos_out = [None] * (4 * n)
        for rows, cap, start_b, cnt_b, qpos_b, fut in cf["buckets"]:
            with T.phase(f"chain_fetch_cap{cap}"):
                fut.block_until_ready()
                blob = np.asarray(fut).reshape(-1, self.n_lists, 2 * cap)
            Rb = len(rows)
            pos_b = st.seeder.gather(start_b, np.minimum(cnt_b, cap), cap)
            for ri, r in enumerate(rows):
                if r >= 4 * n:
                    continue
                dp_out[r] = blob[ri, :, :cap]
                back_out[r] = blob[ri, :, cap:]
                pos_out[r] = pos_b[ri]
        from .types import round_skip
        mapper = self.mappers[cf["contig"]]
        with T.phase("host_finish"):
            for i, (r1, r2) in enumerate(recs):
                if round_skip(r1.mr, r1.seq_len, r2.seq_len,
                              self.cfg.scan_level):
                    continue
                quad = []
                for o in range(4):
                    r = 4 * i + o
                    chains = extract_kbest(dp_out[r], back_out[r], pos_out[r],
                                           qpos_h[r], cnt_h[r], self.cfg)
                    quad.append((chains, int(hh_h[r])))
                mapper.process_read_pe(r1, r2, tuple(quad))

    def _filter_batch(self, recs, seqs, lens, rp_f, qp_f, cl_f, sc_f, cn_f,
                      hh, contig) -> None:
        """Shared native finish: chains -> extension + categories in C++."""
        from ..ops.filter_native import NativeFilter
        nf = self.filters[contig]
        with T.phase("filter_state"):
            # untouched MatchedReads hold exactly the default() state — a
            # single tiled row replaces per-read field serialization
            from .types import MatchedRead
            default_row = NativeFilter.mr_to_state(
                MatchedRead.default(self.cfg.max_ed), nf.chr_names)
            mr_state = np.tile(default_row, (len(recs), 1))
            for i, (r1, _) in enumerate(recs):
                if r1.mr.touched:
                    mr_state[i] = NativeFilter.mr_to_state(r1.mr,
                                                           nf.chr_names)
            mr_state = np.ascontiguousarray(mr_state)
        with T.phase("filter_native"):
            nf.filter_pe(seqs, lens, rp_f, qp_f, cl_f, sc_f,
                         cn_f, hh, mr_state)
        with T.phase("filter_writeback"):
            for i, (r1, _) in enumerate(recs):
                NativeFilter.state_to_mr(mr_state[i], r1.mr, nf.chr_names)

    def _finish_native(self, cf) -> None:
        from ..ops.chain_native import NativeChainer
        cfg = self.cfg
        recs = cf["recs"]
        n = len(recs)
        hh_h = cf["hh"]
        k = cfg.kmer
        from ..utils import logging as ulog
        nf = self.filters[cf["contig"]]
        if ulog.TRACE_LEVEL >= 1:
            nf = None  # python finish carries the per-read vaf traces
        if nf is not None:
            # fully native finish: extension + pairing + categories in C++.
            # The dense chain tensors are sliced to the batch's actual max
            # chain count (typically <= 3 of the 30 allocated) — copying
            # the full [R, 30, NL] tensors was the top mapping phase on
            # low-memory-bandwidth hosts.
            R = 4 * n
            NL = self.n_lists
            with T.phase("filter_assemble"):
                cmax = 1
                for _, _, _, _, _, cn in cf["parts"]:
                    if len(cn):
                        cmax = max(cmax, int(cn.max()))
                rp_f = np.zeros((R, cmax, NL), np.int32)
                qp_f = np.zeros((R, cmax, NL), np.int32)
                cl_f = np.zeros((R, cmax), np.int32)
                sc_f = np.zeros((R, cmax), np.float64)
                cn_f = np.zeros(R, np.int32)
                for rows, rp, qp, cl, sc, cn in cf["parts"]:
                    rp_f[rows] = rp[:, :cmax]
                    qp_f[rows] = qp[:, :cmax]
                    cl_f[rows] = cl[:, :cmax]
                    sc_f[rows] = sc[:, :cmax]
                    cn_f[rows] = cn
            self._filter_batch(recs, cf["seqs"], cf["lens"], rp_f, qp_f,
                               cl_f, sc_f, cn_f, hh_h, cf["contig"])
            return
        from .types import round_skip
        chains_out = [None] * (4 * n)
        for rows, rp, qp, cl, sc, cn in cf["parts"]:
            for ri, r in enumerate(rows):
                chains_out[r] = (rp[ri], qp[ri], cl[ri], sc[ri], cn[ri])
        mapper = self.mappers[cf["contig"]]
        with T.phase("host_finish"):
            for i, (r1, r2) in enumerate(recs):
                if round_skip(r1.mr, r1.seq_len, r2.seq_len, cfg.scan_level):
                    continue
                quad = []
                for o in range(4):
                    r = 4 * i + o
                    rp, qp, cl, sc, cn = chains_out[r]
                    chains = NativeChainer.to_chains(rp, qp, cl, sc, cn, k)
                    quad.append((chains, int(hh_h[r])))
                mapper.process_read_pe(r1, r2, tuple(quad))

    # ---- single-end batched pipeline (filter.cpp:86-121) ----

    def _assemble_chains(self, cf, R):
        """Stack per-bucket chain results into dense [R, C, NL] arrays."""
        cfg = self.cfg
        C = cfg.max_chain_len
        NL = self.n_lists
        rp_f = np.zeros((R, C, NL), np.int32)
        qp_f = np.zeros((R, C, NL), np.int32)
        cl_f = np.zeros((R, C), np.int32)
        sc_f = np.zeros((R, C), np.float64)
        cn_f = np.zeros(R, np.int32)
        if cf.get("native"):
            for rows, rp, qp, cl, sc, cn in cf["parts"]:
                rp_f[rows] = rp
                qp_f[rows] = qp
                cl_f[rows] = cl
                sc_f[rows] = sc
                cn_f[rows] = cn
        else:
            from ..ops.chain_native import NativeChainer
            st = self.states[cf["contig"]]
            k = cfg.kmer
            for rows, cap, start_b, cnt_b, qpos_b, fut in cf["buckets"]:
                with T.phase(f"chain_fetch_cap{cap}"):
                    fut.block_until_ready()
                    blob = np.asarray(fut).reshape(-1, NL, 2 * cap)
                Rb = len(rows)
                pos_b = st.seeder.gather(start_b, np.minimum(cnt_b, cap),
                                         cap)
                rp, qp, cl, sc, cn = NativeChainer.extract_batch(
                    blob[:Rb, :, :cap], blob[:Rb, :, cap:], pos_b, qpos_b,
                    cnt_b, k, C, n_threads=cfg.resolved_threads)
                sel = rows < R
                rp_f[rows[sel]] = rp[sel]
                qp_f[rows[sel]] = qp[sel]
                cl_f[rows[sel]] = cl[sel]
                sc_f[rows[sel]] = sc[sel]
                cn_f[rows[sel]] = cn[sel]
        return rp_f, qp_f, cl_f, sc_f, cn_f

    def _finish_se(self, cf) -> None:
        """SE finish: extend fwd then rc chains per read, first CONCRD wins
        (the batched form of Mapper.process_read_se)."""
        from ..ops.filter_native import NativeFilter
        from ..utils import logging as ulog
        cfg = self.cfg
        recs = cf["recs"]
        n = len(recs)
        R = 2 * n
        nf = self.filters[cf["contig"]]
        rp_f, qp_f, cl_f, sc_f, cn_f = self._assemble_chains(cf, R)
        if ulog.TRACE_LEVEL < 1:
            with T.phase("filter_state"):
                from .types import MatchedRead
                default_row = NativeFilter.mr_to_state(
                    MatchedRead.default(cfg.max_ed), nf.chr_names)
                mr_state = np.tile(default_row, (n, 1))
                for i, r in enumerate(recs):
                    if r.mr is not None and r.mr.touched:
                        mr_state[i] = NativeFilter.mr_to_state(r.mr,
                                                               nf.chr_names)
                mr_state = np.ascontiguousarray(mr_state)
            with T.phase("filter_native_se"):
                states = nf.filter_se(cf["seqs"][:R], cf["lens"][:R],
                                      rp_f, qp_f, cl_f, sc_f, cn_f, mr_state)
            with T.phase("filter_writeback"):
                from ..config import CONCRD as _CONCRD
                for i, r in enumerate(recs):
                    if r.mr is not None and mr_state[i][0] == _CONCRD:
                        NativeFilter.state_to_mr(mr_state[i], r.mr,
                                                 nf.chr_names)
            return
        # -d trace path: python orchestration
        from ..ops.chain_native import NativeChainer
        mapper = self.mappers[cf["contig"]]
        k = cfg.kmer
        with T.phase("host_finish"):
            for i, r in enumerate(recs):
                if cfg.scan_level == 0 and r.mr is not None \
                        and r.mr.type == CONCRD:
                    continue
                fc = NativeChainer.to_chains(rp_f[2 * i], qp_f[2 * i],
                                             cl_f[2 * i], sc_f[2 * i],
                                             cn_f[2 * i], k)
                bc = NativeChainer.to_chains(rp_f[2 * i + 1], qp_f[2 * i + 1],
                                             cl_f[2 * i + 1], sc_f[2 * i + 1],
                                             cn_f[2 * i + 1], k)
                mapper.process_read_se(r, ((fc, 0), (bc, 0)))

    def map_stream_se(self, reads: Iterable[ReadRecord], out=None,
                      fmt: Optional[str] = None) -> int:
        """Batched SE mapping over every contig (the batched equivalent of
        the reference's per-round SE loop, circminer.cpp:398-402)."""
        n_total = 0
        n_contigs = len(self.states)

        def flush(buf):
            if not buf:
                return 0
            for c in range(n_contigs):
                lf = self.dispatch_lookup(buf, c, rpr=2)
                cf = self.dispatch_chain(lf)
                self._finish_se(cf)
            for rec in buf:
                if out is not None and fmt == "sam":
                    out.write_sam_se(rec)
                elif out is not None and fmt == "pam":
                    out.write_pam_se(rec)
            return len(buf)

        buf = []
        for rec in reads:
            buf.append(rec)
            if len(buf) >= self.batch:
                n_total += flush(buf)
                buf = []
        n_total += flush(buf)
        return n_total

    def _caps(self):
        caps = [c for c in self.cfg.seed_buckets if c <= self.cfg.seed_lim]
        if not caps or caps[-1] < self.cfg.seed_lim:
            caps = list(caps) + [self.cfg.seed_lim]
        return caps

    def _chunk_for(self, cap: int) -> int:
        """Row-chunk size keeping the DP working set bounded; the transition
        tensor peaks at [chunk, cap, NL, cap] int32."""
        if cap <= 16:
            return 4 * self.batch
        if cap <= 128:
            return 2048
        return 128

    # ---- full stream mapping with 2-deep software pipelining ----
    def map_stream(self, pairs: Iterable[Tuple[ReadRecord, ReadRecord]],
                   out=None, remain=None, conloc=None,
                   contig: int = 0, emit=None) -> int:
        cfg = self.cfg
        n_total = 0

        def batches():
            buf = []
            for pr in pairs:
                buf.append(pr)
                if len(buf) >= self.batch:
                    yield buf
                    buf = []
            if buf:
                yield buf

        gen = batches()
        pending_chain = None  # chain-dispatched, host work not done
        nxt = next(gen, None)
        if nxt is not None:
            lf = self.dispatch_lookup(nxt, contig)
        while nxt is not None:
            cf = self.dispatch_chain(lf)
            upcoming = next(gen, None)
            if upcoming is not None:
                lf = self.dispatch_lookup(upcoming, contig)  # overlaps device
            if pending_chain is not None:
                self._finalize(pending_chain, out, remain, conloc, emit)
                n_total += len(pending_chain["recs"])
            pending_chain = cf
            nxt = upcoming
        if pending_chain is not None:
            self._finalize(pending_chain, out, remain, conloc, emit)
            n_total += len(pending_chain["recs"])
        return n_total

    def map_stream_all_contigs(self, pairs, out=None, remain=None,
                               conloc=None, workdir: Optional[str] = None
                               ) -> int:
        """Streaming multi-contig mapping: one pass per contig, carrying
        unresolved reads between rounds through on-disk remain-FASTQ files
        with the best-so-far state in their 23-token headers — the
        reference's round mechanism (circminer.cpp:229-308,
        filter.cpp:413-455) — so memory stays bounded by the batch size,
        not the library size.  Reads finalized early (scan_level 0 CONCRD)
        are emitted as they resolve."""
        import shutil
        import tempfile
        n_contigs = len(self.states)
        if n_contigs == 1:
            return self.map_stream(pairs, out=out, remain=remain,
                                   conloc=conloc, contig=0)
        from ..io.fastq import RemainWriter, read_pairs
        cfg = self.cfg
        tmpdir = workdir or tempfile.mkdtemp(prefix="circminer_rounds_")
        own_tmp = workdir is None
        os.makedirs(tmpdir, exist_ok=True)
        n_total = 0
        src = pairs
        try:
            for c in range(n_contigs):
                last = c == n_contigs - 1
                nxt = None if last else RemainWriter(
                    os.path.join(tmpdir, "carry"), c + 1)

                def emit(r1, r2, last=last, nxt=nxt):
                    from .types import round_skip
                    final = last or round_skip(r1.mr, r1.seq_len, r2.seq_len,
                                               cfg.scan_level)
                    if final:
                        self._emit_pair(r1, r2, out, remain, conloc)
                    else:
                        nxt.write(r1, r2, r1.mr, conloc)

                count = self.map_stream(src, contig=c, emit=emit)
                if c == 0:
                    n_total = count
                if nxt is not None:
                    nxt.close()
                    # iter_remain_pairs re-attaches the ORIGINAL global
                    # pair ordinal from the .ord sidecar, so reads carried
                    # across contig rounds keep the tie-order key the
                    # multi-host circ merge depends on
                    from ..io.fastq import iter_remain_pairs
                    src = iter_remain_pairs(nxt.p1, nxt.p2, cfg)
        finally:
            if own_tmp:
                shutil.rmtree(tmpdir, ignore_errors=True)
        return n_total

    def _emit_pair(self, r1, r2, out, remain, conloc):
        if out is not None and out.fmt:
            if out.fmt == "pam":
                out.write_pam_pe(r1, r2)
            else:
                out.write_sam_pe(r1, r2)
        if remain is not None and r1.mr.type in (CHIBSJ, CHI2BSJ):
            remain.write(r1, r2, r1.mr, conloc)

    def _finalize(self, cf, out, remain, conloc, emit=None):
        self.finish(cf)
        for r1, r2 in cf["recs"]:
            if emit is not None:
                emit(r1, r2)
            else:
                self._emit_pair(r1, r2, out, remain, conloc)

    def _dev_lookup_once(self, reads0, lens0, st):
        cfg = self.cfg
        packed = _lookup_even(
            reads0, lens0, st.entry_hv, st.entry_checksum,
            st.entry_prefix,
            k=cfg.kmer, cs_len=cfg.checksum_len,
            n_slots=cfg.max_seg_cnt, seed_lim=cfg.seed_lim,
            prefix_shift=st.prefix_shift, prefix_iters=st.prefix_iters)
        return np.asarray(packed)

    # ---- executor auto-selection (fast: small probes + decision cache) ----

    def _decision_cache_path(self):
        import hashlib
        import socket
        d = jax.devices()[0]
        key = f"{socket.gethostname()}|{d.platform}|{d.device_kind}|" \
              f"{self.batch}|{self.n_lists}"
        h = hashlib.sha1(key.encode()).hexdigest()[:16]
        from .. import CACHE_DIR
        root = os.environ.get("CIRCMINER_CACHE_DIR", CACHE_DIR)
        return os.path.join(root, f"executor_{h}.json"), key

    def _cached_decision(self):
        import json
        path, key = self._decision_cache_path()
        try:
            with open(path) as f:
                rec = json.load(f)
            if rec.get("key") == key:
                return rec.get("executor")
        except Exception:
            pass
        return None

    def _store_decision(self, executor: str, detail: dict):
        import json
        path, key = self._decision_cache_path()
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                json.dump({"key": key, "executor": executor, **detail}, f)
        except Exception:
            pass

    def _probe_decision(self) -> str:
        """Pick device vs host lookup in seconds: measure d2h latency +
        bandwidth with two SMALL 2-D int8 fetches, estimate the real
        per-batch lookup-fetch cost from them, and compare against one
        timed host C++ lookup."""
        import sys
        import time as _time
        st = self.states[0]
        # two fetch sizes separate latency from bandwidth
        sizes = [(512, 128), (4096, 256)]  # 64 KB, 1 MB
        times = []
        for shp in sizes:
            x = jnp.ones(shp, jnp.int8)
            np.asarray(x)  # absorb compile/first-transfer of this shape
            # a FRESH buffer for the timed fetch: jax.Array caches its host
            # value after the first np.asarray, which would make a repeat
            # fetch of the same array free and the bandwidth estimate bogus
            y = (x + 1).block_until_ready()
            t0 = _time.time()
            np.asarray(y)
            times.append(_time.time() - t0)
        b1, b2 = (s[0] * s[1] for s in sizes)
        t1, t2 = times
        # guard against timing variance making the slope estimate collapse
        if t2 > 1.05 * t1:
            bw = (b2 - b1) / (t2 - t1)               # bytes/s
        else:
            bw = b2 / max(t2, 1e-6)
        bw = max(bw, 1e5)
        lat = max(t1 - b1 / bw, 1e-4)
        # per-batch device path: a nominal 1 ms of lookup compute + one
        # [4B, 2NL+1] int32 fetch
        payload = 4 * self.batch * (2 * self.n_lists + 1) * 4
        est_dev = 1e-3 + lat + payload / bw
        R = 4 * self.batch
        reads_h = np.zeros((R, self.cfg.max_read_len), np.int8)
        lens_h = np.full(R, self.cfg.max_read_len, np.int32)
        t0 = _time.time()
        st.seeder.lookup(reads_h, lens_h)
        host_s = _time.time() - t0
        choice = "device" if est_dev < host_s else "native"
        detail = dict(d2h_bw_mbps=round(bw / 1e6, 1),
                      d2h_lat_ms=round(lat * 1e3, 2),
                      est_device_ms=round(est_dev * 1e3, 1),
                      host_ms=round(host_s * 1e3, 1))
        sys.stderr.write(
            f"[pipeline] auto executor: d2h {detail['d2h_bw_mbps']} MB/s "
            f"lat {detail['d2h_lat_ms']} ms -> est device lookup "
            f"{detail['est_device_ms']} ms vs host {detail['host_ms']} ms "
            f"per batch -> {choice}\n")
        if jax.devices()[0].platform != "cpu":
            self._store_decision(choice, detail)
        return choice

    def warmup(self):
        """Compile and exercise every device executable shape so no compile
        (or first transfer) lands inside the streamed region; in "auto"
        mode pick the executor from a cached decision or a seconds-scale
        probe.  No-op in native mode (nothing to compile)."""
        if self.align_svc is not None:
            self.align_svc.warm()
        if self.chain_exec == "native":
            return
        if self.chain_exec == "device-full":
            # compile the fused step + absorb the first d2h fetch
            from .mapping import ReadRecord
            from .types import MatchedRead
            z = np.zeros(0, np.int8)
            recs = [(ReadRecord("w", z, z, "", 0,
                                MatchedRead.default(self.cfg.max_ed)),
                     ReadRecord("w", z, z, "", 0, None))]
            lf = self._dispatch_full(recs, 0)
            lf["fetch_thread"].join()
            return
        cfg = self.cfg
        st = self.states[0]
        ad = st.anno
        NL = self.n_lists
        L = cfg.max_read_len
        R = 4 * self.batch
        if self.chain_exec == "auto":
            forced = os.environ.get("CIRCMINER_EXECUTOR")
            choice = forced or self._cached_decision()
            src = "env" if forced else ("cache" if choice else "probe")
            if choice is None:
                choice = self._probe_decision()
            else:
                import sys
                sys.stderr.write(
                    f"[pipeline] auto executor: {choice} (from {src})\n")
            self.chain_exec = choice
            if choice == "native":
                return
        reads0 = jnp.zeros((R, L), jnp.int8)
        lens0 = jnp.zeros(R, jnp.int32)
        # compile + absorb the first d2h fetch of the real batch shape
        self._dev_lookup_once(reads0, lens0, st)
        if self.chain_exec != "device-chain":
            return
        for cap in self._caps():
            chunk = self._chunk_for(cap)
            out = _gather_chain_dp(
                st.entry_pos,
                jnp.zeros((chunk, NL), jnp.int32),
                jnp.zeros((chunk, NL), jnp.int32),
                jnp.zeros((chunk, NL), jnp.int32),
                jnp.full((chunk,), cfg.max_read_len, jnp.int32),
                ad.nb_bits, ad.iv_spos, ad.iv_epos, ad.iv_max_end,
                ad.iv_min_end, ad.iv_max_next, ad.iv_nseg, ad.seg_end,
                ad.seg_next, cap=cap, k=cfg.kmer, max_ed=cfg.max_ed,
                max_intron=cfg.max_intron, seg_pad=ad.seg_pad)
            out.block_until_ready()
