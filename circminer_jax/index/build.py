"""Genome k-mer index: build, store, load.

Replaces the mrsFAST hash table (reference: src/mrsfast/HashTable.c).  The
reference keeps, per 14-bp window hash, a list of (checksum, position) entries
sorted by (checksum, position) and binary-searches the checksum range at query
time (HashTable.c:769-839, match_read.cpp:54-110).

Device layout: one flat, (hash, checksum, position)-sorted entry table per
contig with the window hash stored per entry (``entry_hv``).  Lookup is a
vectorized composite binary search over (hv, checksum) — no pointers, fully
batched.  A dense ``bucket_start[4^14 + 1]`` offset table was deliberately
rejected: it costs 1 GiB per contig regardless of genome size and this class
of host takes tens of seconds just to materialize it, while the composite
bisect adds only ~log2(n_entries) gather steps on either host or device.

Positions are 1-based (like the reference's ``loc``) and fit int32 since a
packed contig is at most 1.1 Gbp.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

from ..config import Config, WINDOW_SIZE

INDEX_MAGIC = "circminer-jax-index-v2"


@dataclasses.dataclass
class ContigIndex:
    """Dense k-mer index of one packed contig."""
    name: str                 # contig name ("1", "2", ...)
    length: int               # contig length in bases
    codes: np.ndarray         # int8[length] genome codes (A0 C1 G2 T3 N4)
    entry_hv: np.ndarray      # int32[n_entries] window hash (<= 28 bits),
                              # ascending; primary sort key
    entry_checksum: np.ndarray  # int16[n_entries], sorted within hv group
    entry_pos: np.ndarray     # int32[n_entries] 1-based k-mer start positions

    _entry_key: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def n_entries(self) -> int:
        return int(self.entry_pos.shape[0])

    @property
    def entry_key(self) -> np.ndarray:
        """int64[n] packed (hv << 16 | checksum) for host searchsorted;
        built lazily, cached."""
        if self._entry_key is None:
            self._entry_key = ((self.entry_hv.astype(np.int64) << 16)
                               | self.entry_checksum.astype(np.int64))
        return self._entry_key

    def bucket_range(self, hv: int):
        """(lo, hi) entry range of one window hash (replaces the dense
        bucket_start[hv], bucket_start[hv+1] pair)."""
        # probes in the table's own dtype: a Python int probe makes numpy
        # convert the whole int32 table to int64 on every call
        t = self.entry_hv.dtype.type
        lo = int(np.searchsorted(self.entry_hv, t(hv), side="left"))
        hi = int(np.searchsorted(self.entry_hv, t(hv + 1), side="left"))
        return lo, hi


@dataclasses.dataclass
class GenomeIndex:
    window_size: int
    checksum_len: int
    contigs: List[ContigIndex]

    @property
    def kmer(self) -> int:
        return self.window_size + self.checksum_len


def _rolling_hash(codes: np.ndarray, k: int) -> np.ndarray:
    """int64 hash of every k-window via k accumulation passes (memory-light)."""
    n = codes.shape[0]
    m = n - k + 1
    if m <= 0:
        return np.empty(0, dtype=np.int64)
    x = np.where(codes < 4, codes, 0)            # int8; ufunc casts chunked
    h = np.zeros(m, dtype=np.int64)
    for j in range(k):
        h <<= 2
        np.bitwise_or(h, x[j: j + m], out=h)
    return h


def _valid_windows(codes: np.ndarray, k: int) -> np.ndarray:
    """bool[m]: window of k bases contains no N."""
    n = codes.shape[0]
    m = n - k + 1
    if m <= 0:
        return np.empty(0, dtype=bool)
    is_n = codes >= 4                            # bool; cumsum dtype below
    cs = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(is_n, dtype=np.int32, out=cs[1:])
    return (cs[k:] - cs[:-k]) == 0


def build_contig_index(codes: np.ndarray, name: str, cfg: Config) -> ContigIndex:
    """Build the sorted entry table for one contig.

    Equivalent to generateHashTable[OnDisk] + sortHashTable
    (HashTable.c:257-476, 824-839) but as three vectorized passes:
    hash, filter, sort.
    """
    w = cfg.window_size
    cs_len = cfg.checksum_len
    k = w + cs_len
    n = codes.shape[0]

    full_hash = _rolling_hash(codes, k)          # k-base big-endian hash
    ok = _valid_windows(codes, k)
    # positions fit int32 (packed contig <= 1.1 Gbp < 2^31); converting
    # immediately halves the live footprint on Gbp-scale contigs
    idx = np.nonzero(ok)[0].astype(np.int32)
    del ok

    fh = full_hash[idx]
    del full_hash
    # fh IS the composite sort key: (hv << 2*cs_len) | checksum, and idx is
    # already ascending, so ONE stable argsort of fh yields the full
    # (hv, checksum, pos) order — replaces the 3-key lexsort, which peaked
    # ~3x higher in transient memory on Gbp contigs
    order = np.argsort(fh, kind="stable")
    fh = fh[order]
    pos = idx[order] + 1                         # 1-based, int32
    del idx, order
    hv = (fh >> (2 * cs_len)).astype(np.int64)   # 14-bp window hash
    if cs_len > 0:
        cv = (fh & ((1 << (2 * cs_len)) - 1)).astype(np.int16)
    else:
        cv = np.zeros(len(fh), dtype=np.int16)
    del fh

    return ContigIndex(
        name=name,
        length=n,
        codes=np.ascontiguousarray(codes, dtype=np.int8),
        entry_hv=np.ascontiguousarray(hv, dtype=np.int32),
        entry_checksum=np.ascontiguousarray(cv),
        entry_pos=np.ascontiguousarray(pos),
    )


def build_genome_index(contigs: List[np.ndarray], cfg: Config) -> GenomeIndex:
    cfg.validate()
    out = [
        build_contig_index(c, str(i + 1), cfg) for i, c in enumerate(contigs)
    ]
    return GenomeIndex(cfg.window_size, cfg.checksum_len, out)


# --- serialization -----------------------------------------------------------

def save_genome_index(gi: GenomeIndex, path: str, compact: bool = False,
                      compress: Optional[bool] = None) -> None:
    """Persist index. compact=True stores genome only (entries are rebuilt at
    load time), mirroring the reference's compact index (-m) trade-off
    (HashTable.c:383-476).  compress=None auto-disables zlib above ~2 GB of
    payload: genome-scale entry tables are near-incompressible and a
    2-vCPU host spends tens of minutes deflating them for nothing."""
    payload = {
        "magic": np.array(INDEX_MAGIC),
        "window_size": np.array(gi.window_size),
        "checksum_len": np.array(gi.checksum_len),
        "compact": np.array(int(compact)),
        "n_contigs": np.array(len(gi.contigs)),
    }
    for i, ci in enumerate(gi.contigs):
        payload[f"c{i}_name"] = np.array(ci.name)
        payload[f"c{i}_codes"] = ci.codes
        if not compact:
            payload[f"c{i}_hv"] = ci.entry_hv
            payload[f"c{i}_checksum"] = ci.entry_checksum
            payload[f"c{i}_pos"] = ci.entry_pos
    if compress is None:
        total = sum(a.nbytes for a in payload.values()
                    if isinstance(a, np.ndarray))
        compress = total < 2 << 30
    (np.savez_compressed if compress else np.savez)(path, **payload)


def load_genome_index(path: str) -> GenomeIndex:
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    z = np.load(path, allow_pickle=False)
    if str(z["magic"]) != INDEX_MAGIC:
        raise ValueError(f"bad index magic in {path}")
    w = int(z["window_size"])
    cs_len = int(z["checksum_len"])
    compact = bool(int(z["compact"]))
    cfg = Config(kmer=w + cs_len, window_size=w)
    contigs = []
    for i in range(int(z["n_contigs"])):
        codes = z[f"c{i}_codes"]
        name = str(z[f"c{i}_name"])
        if compact:
            contigs.append(build_contig_index(codes, name, cfg))
        else:
            contigs.append(ContigIndex(
                name=name,
                length=codes.shape[0],
                codes=codes,
                entry_hv=z[f"c{i}_hv"],
                entry_checksum=z[f"c{i}_checksum"],
                entry_pos=z[f"c{i}_pos"],
            ))
    return GenomeIndex(w, cs_len, contigs)
