"""Base encoding and k-mer hashing.

The reference encodes bases A,C,G,T,N -> 0,1,2,3,4 (3 bits in the packed
genome, mrsfast/HashTable.c:781-797) and hashes a k-mer big-endian 2 bits per
base: ``hv = (hv << 2) | code`` with any N invalidating the window
(mrsfast/HashTable.c:778-821, src/hash_table.cpp:95-105).

Here the genome and reads live as int8 code arrays; hashing is a vectorized
dot with a power-of-4 basis so it runs for whole batches at once.
"""

from __future__ import annotations

import numpy as np

# code values
A, C, G, T, N = 0, 1, 2, 3, 4

_CODE_LUT = np.full(256, N, dtype=np.int8)
for i, ch in enumerate("ACGT"):
    _CODE_LUT[ord(ch)] = i
    _CODE_LUT[ord(ch.lower())] = i

_CHAR_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)

# reverse complement in code space: A<->T, C<->G, N->N
_RC_LUT = np.array([T, G, C, A, N], dtype=np.int8)


def encode_seq(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> int8 codes (A=0 C=1 G=2 T=3, other=N=4)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _CODE_LUT[raw]


def decode_seq(codes: np.ndarray) -> str:
    """int8 codes -> ASCII string."""
    return _CHAR_LUT[np.clip(codes, 0, 4)].tobytes().decode("ascii")


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement along the last axis (reference: fastq_parser.cpp:155-162)."""
    return _RC_LUT[codes[..., ::-1]]


def kmer_hashes(codes: np.ndarray, k: int) -> np.ndarray:
    """Rolling big-endian 2-bit hash of every k-mer start position.

    Returns int64 array of length ``len(codes) - k + 1`` (or empty); -1 where
    the window contains an N. Matches mrsfast's
    ``hv = ((hv << 2) | val) & mask`` accumulation (HashTable.c:788-797).
    """
    n = codes.shape[-1]
    if n < k:
        return np.empty(codes.shape[:-1] + (0,), dtype=np.int64)
    if codes.ndim == 1:
        # shift-accumulate rolling form: ~10x cheaper than the sliding-
        # window matmul for the short per-read sequences the circ stage
        # hashes by the thousand
        x = codes.astype(np.int64, copy=False)
        L = n - k + 1
        h = np.zeros(L, dtype=np.int64)
        bad = np.zeros(L, dtype=bool)
        for j in range(k):
            xs = x[j:j + L]
            b = xs >= 4
            h = h * 4 + np.where(b, 0, xs)
            bad |= b
        return np.where(bad, -1, h)
    x = codes.astype(np.int64)
    valid = x < 4
    x = np.where(valid, x, 0)
    # hash via sliding dot with basis 4^(k-1-j)
    basis = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    windows = np.lib.stride_tricks.sliding_window_view(x, k, axis=-1)
    h = windows @ basis
    ok = np.all(
        np.lib.stride_tricks.sliding_window_view(valid, k, axis=-1), axis=-1
    )
    return np.where(ok, h, -1)


def hash_at(codes: np.ndarray, pos: int, k: int) -> int:
    """Hash of the single k-mer starting at pos; -1 if out of range / has N."""
    if pos < 0 or pos + k > codes.shape[-1]:
        return -1
    w = codes[pos: pos + k].astype(np.int64)
    if np.any(w >= 4):
        return -1
    basis = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    return int(w @ basis)
