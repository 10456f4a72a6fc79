"""FASTA reading and genome packing.

Mirrors the reference GenomePacker (src/genome.cpp:96-167): chromosomes are
concatenated into "contigs" of at most ``contig_size`` bases, separated by 50
N's; a ``.packed.fa.index.info`` table records, per original chromosome, its
contig id and [start, end) offsets within the packed contig.  The packed
coordinate of a 1-based chromosome position x is ``x + start_pos``
(src/gene_annotation.cpp:182-189).

Unlike the reference, the packed genome is also kept as an int8 code array
per contig — the form the index builder and kernels consume directly.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Tuple

import numpy as np

from ..config import DEF_CONTIG_SIZE
from ..ops.encode import encode_seq, N

MID_N_COUNT = 50  # reference: src/genome.cpp:16


@dataclasses.dataclass
class ContigLen:
    """One original chromosome's placement (reference: common.h:130-136)."""
    name: str
    contig_id: int  # 1-based packed contig id
    start_pos: int
    end_pos: int

    @property
    def len(self) -> int:
        return self.end_pos - self.start_pos


def read_fasta(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (chr_id, sequence) per record. chr_id is the first token."""
    name = None
    chunks: List[str] = []
    opener = open
    if path.endswith(".gz"):
        import gzip
        opener = gzip.open
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)


class GenomePacker:
    def __init__(self, ref_fname: str, contig_size: int = None):
        if contig_size is None:
            # CIRCMINER_CONTIG_SIZE lets tests/tools exercise the
            # multi-contig round machinery on small genomes
            contig_size = int(os.environ.get("CIRCMINER_CONTIG_SIZE",
                                             DEF_CONTIG_SIZE))
        self.ref_fname = ref_fname
        self.contig_size = contig_size
        self.packed_fname = ref_fname + ".packed.fa"
        self.index_fname = self.packed_fname + ".index"
        self.index_info_fname = self.packed_fname + ".index.info"

    # --- packing (reference: src/genome.cpp:96-145) ---
    def pack_genome(self) -> Tuple[List[np.ndarray], List[ContigLen]]:
        contigs: List[np.ndarray] = []
        info: List[ContigLen] = []
        cur: List[np.ndarray] = []
        cur_size = 0
        contig_num = 0
        sep = np.full(MID_N_COUNT, N, dtype=np.int8)

        with open(self.packed_fname, "w") as fout, \
                open(self.index_info_fname, "w") as fout_info:
            for chr_id, chr_seq in read_fasta(self.ref_fname):
                chr_len = len(chr_seq)
                if cur_size == 0 or chr_len + MID_N_COUNT + cur_size > self.contig_size:
                    if cur:
                        contigs.append(np.concatenate(cur))
                    contig_num += 1
                    cur = [encode_seq(chr_seq)]
                    cur_size = 0
                    fout.write(f">{contig_num}\n{chr_seq}\n")
                    fout_info.write(f"{contig_num}\t0\t{chr_len}\t{chr_id}\n")
                    info.append(ContigLen(chr_id, contig_num, 0, chr_len))
                    cur_size = chr_len
                else:
                    cur.append(sep)
                    cur.append(encode_seq(chr_seq))
                    fout.write("N" * MID_N_COUNT + chr_seq + "\n")
                    start = cur_size + MID_N_COUNT
                    fout_info.write(f"{contig_num}\t{start}\t{start + chr_len}\t{chr_id}\n")
                    info.append(ContigLen(chr_id, contig_num, start, start + chr_len))
                    cur_size = start + chr_len
            if cur:
                contigs.append(np.concatenate(cur))
        return contigs, info

    # --- index info loading (reference: src/genome.cpp:147-167) ---
    def load_index_info(self) -> List[ContigLen]:
        out: List[ContigLen] = []
        with open(self.index_info_fname) as f:
            for line in f:
                parts = line.split()
                if len(parts) != 4:
                    continue
                contig, start, end, name = parts
                out.append(ContigLen(name, int(contig), int(start), int(end)))
        return out

    def load_packed_contigs(self) -> List[np.ndarray]:
        """Load packed contigs back as int8 code arrays."""
        return [encode_seq(seq) for _, seq in read_fasta(self.packed_fname)]

    @staticmethod
    def packed_contig_cnt(info: List[ContigLen]) -> int:
        return info[-1].contig_id if info else 0


@dataclasses.dataclass
class ConShift:
    """Contig <-> chromosome coordinate shift (reference: common.h:372-376)."""
    contig: str
    shift: int


def build_shift_maps(info: List[ContigLen]):
    """Return (chr2con, con2chr) like GTFParser::set_contig_shift
    (src/gene_annotation.cpp:424-449)."""
    chr2con = {}
    con2chr: List[List[ConShift]] = []
    for cl in info:
        chr2con[cl.name] = ConShift(str(cl.contig_id), cl.start_pos)
        while len(con2chr) < cl.contig_id:
            con2chr.append([])
        con2chr[cl.contig_id - 1].append(ConShift(cl.name, cl.start_pos))
    return chr2con, con2chr


def get_shift(con2chr, contig_id0: int, loc: int) -> ConShift:
    """Which chromosome contains packed-contig position loc
    (reference: src/gene_annotation.cpp:451-457)."""
    lst = con2chr[contig_id0]
    i = 1
    while i < len(lst) and loc >= lst[i].shift:
        i += 1
    return lst[i - 1]


def chrloc2conloc(chr2con, chrname: str, start: int, end: int):
    """Chromosome coords -> packed contig coords
    (reference: src/gene_annotation.cpp:182-189). Returns (contig, start, end);
    contig "0" when the chromosome is absent from the genome index."""
    cs = chr2con.get(chrname)
    if cs is None:
        return "0", start, end
    return cs.contig, start + cs.shift, end + cs.shift
