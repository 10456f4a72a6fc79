"""mrsFAST binary index format: round-trip + structural parity.

The reference persists its index via save[Full]HashTable / loadHashTable
(src/mrsfast/HashTable.c); these tests check our writer/reader reproduce
that structure (header fields, VB stream, GeneralIndex payload geometry)
and that a written index loads back into identical dense arrays.
"""

import struct

import numpy as np
import pytest

from circminer_jax.config import Config
from circminer_jax.index.build import build_genome_index
from circminer_jax.index.mrsfast_format import (
    write_mrsfast_index, read_mrsfast_index, encode_vb, decode_vb,
    compress_codes, decompress_codes, IO_BUFFER_SIZE)


@pytest.fixture
def small_gi(rng):
    cfg = Config(kmer=12, window_size=8)
    codes = rng.integers(0, 4, size=5000).astype(np.int8)
    codes[100:110] = 4  # an N run: windows crossing it are dropped
    codes[-5:] = 4
    c2 = rng.integers(0, 4, size=3000).astype(np.int8)
    return build_genome_index([codes, c2], cfg)


def test_varbyte_roundtrip():
    for v in [0, 1, 127, 128, 129, 16383, 16384, 2**28 - 1, 2**31 - 1]:
        buf = bytearray()
        encode_vb(v, buf)
        got, nxt = decode_vb(bytes(buf), 0)
        assert got == v and nxt == len(buf)
    # mrsfast terminator convention: high bit set on the LAST byte only
    buf = bytearray()
    encode_vb(300, buf)      # 300 = 44 + 2*128
    assert buf[0] & 128 == 0 and buf[-1] & 128 == 128


def test_compress_codes_roundtrip(rng):
    for n in [1, 20, 21, 22, 100, 1000]:
        codes = rng.integers(0, 5, size=n).astype(np.int8)
        words = compress_codes(codes)
        assert words.shape[0] == -(-n // 21)
        np.testing.assert_array_equal(decompress_codes(words, n), codes)
    # base 0 of a word sits at bits 62..60 (match_read.cpp:308-332 layout)
    w = compress_codes(np.array([3], np.int8))
    assert (int(w[0]) >> 60) & 7 == 3


def test_full_index_roundtrip(small_gi, tmp_path):
    p = str(tmp_path / "ref.index")
    write_mrsfast_index(small_gi, p, full=True)
    gi2 = read_mrsfast_index(p)
    assert gi2.window_size == small_gi.window_size
    assert gi2.checksum_len == small_gi.checksum_len
    assert len(gi2.contigs) == len(small_gi.contigs)
    for a, b in zip(small_gi.contigs, gi2.contigs):
        assert a.name == b.name and a.length == b.length
        np.testing.assert_array_equal(a.codes, b.codes)
        np.testing.assert_array_equal(a.entry_hv, b.entry_hv)
        np.testing.assert_array_equal(a.entry_checksum, b.entry_checksum)
        np.testing.assert_array_equal(a.entry_pos, b.entry_pos)


def test_compact_index_roundtrip(small_gi, tmp_path):
    p = str(tmp_path / "ref.compact.index")
    write_mrsfast_index(small_gi, p, full=False)
    gi2 = read_mrsfast_index(p)
    for a, b in zip(small_gi.contigs, gi2.contigs):
        np.testing.assert_array_equal(a.codes, b.codes)
        np.testing.assert_array_equal(a.entry_hv, b.entry_hv)
        np.testing.assert_array_equal(a.entry_pos, b.entry_pos)


def test_header_structure(small_gi, tmp_path):
    """Byte-level header layout per HashTable.c:106-131."""
    p = str(tmp_path / "ref.index")
    write_mrsfast_index(small_gi, p, full=True)
    raw = open(p, "rb").read()
    magic, w, cs = struct.unpack_from("<BBb", raw, 0)
    assert magic == 3 and w == 8 and cs == 4
    mem, io, cmax = struct.unpack_from("<III", raw, 3)
    assert io == IO_BUFFER_SIZE and cmax == 1_300_000_000
    (n_contigs,) = struct.unpack_from("<i", raw, 15)
    assert n_contigs == 2
    (nl,) = struct.unpack_from("<i", raw, 19)
    assert raw[23:23 + nl].decode() == small_gi.contigs[0].name
    # payload cells = windows+1 per distinct hv; header records the max
    assert mem > 0


def test_payload_has_window_count_blocks(tmp_path, rng):
    """A window whose checksum extension is cut off by the contig end
    still owns an (empty) payload cell — block stride is windowCount+1
    while the header cell holds only the real entry count."""
    cfg = Config(kmer=12, window_size=8)
    codes = rng.integers(0, 4, size=300).astype(np.int8)
    gi = build_genome_index([codes], cfg)
    p = str(tmp_path / "t.index")
    write_mrsfast_index(gi, p, full=True)
    gi2 = read_mrsfast_index(p)
    ci, ci2 = gi.contigs[0], gi2.contigs[0]
    np.testing.assert_array_equal(ci.entry_pos, ci2.entry_pos)
    # windows exist in [1, 300-8+1]; full k-mers only in [1, 300-12+1]:
    # the last 4 window starts have no entry -> payload larger than entries
    n_windows = 300 - 8 + 1
    assert ci.n_entries < n_windows
