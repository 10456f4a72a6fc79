import numpy as np
import pytest
import jax.numpy as jnp

from circminer_jax.config import Config
from circminer_jax.ops.chain import (
    chain_seeds_host, chain_batch_device, extract_kbest, Chain)
from circminer_jax.annotation.device import AnnoDevice
from circminer_jax.annotation.annotation import AnnotationDB
from circminer_jax.io.fasta import ContigLen


def make_db(tmp_path, lines):
    gtf = tmp_path / "t.gtf"
    gtf.write_text("\n".join(lines) + "\n")
    cfg = Config(max_read_len=100)
    return AnnotationDB.from_gtf(str(gtf), [ContigLen("chr1", 1, 0, 100000)],
                                 1, cfg, contig_lengths=[100000])


def gtf_line(chrom, ftype, start, end, strand, gene, trans=None, exon=None):
    attrs = f'gene_id "{gene}";'
    if trans:
        attrs += f' transcript_id "{trans}";'
    if exon:
        attrs += f' exon_number "{exon}";'
    return f"{chrom}\tsrc\t{ftype}\t{start}\t{end}\t.\t{strand}\t.\t{attrs}"


def run_device(qpos, seed_pos, cfg, db, seq_len, k=None, S=8):
    k = k or cfg.kmer
    NL = len(seed_pos)
    pos = np.zeros((1, NL, S), dtype=np.int32)
    cnt = np.zeros((1, NL), dtype=np.int32)
    for l, sp in enumerate(seed_pos):
        cnt[0, l] = len(sp)
        pos[0, l, :len(sp)] = sp
    qp = np.array([qpos], dtype=np.int32)
    ad = AnnoDevice.from_contig(db.contigs[0], seg_pad=8)
    dp10, back = chain_batch_device(
        jnp.asarray(pos), jnp.asarray(cnt), jnp.asarray(qp),
        jnp.asarray(np.array([seq_len], np.int32)),
        ad.nb_bits, ad.iv_spos, ad.iv_epos, ad.iv_max_end, ad.iv_min_end,
        ad.iv_max_next, ad.iv_nseg, ad.seg_end, ad.seg_next,
        k=k, max_ed=cfg.max_ed, max_intron=cfg.max_intron,
        seg_pad=ad.seg_pad)
    return extract_kbest(np.asarray(dp10)[0], np.asarray(back)[0],
                         pos[0], qp[0], cnt[0], cfg, k=k)


def chain_key(c: Chain):
    return (tuple(c.rpos), tuple(c.qpos))


def test_simple_concordant_chain(tmp_path):
    """Exact-spacing seeds far from any gene chain into one full chain."""
    db = make_db(tmp_path, [gtf_line("chr1", "gene", 10, 20, "+", "G1")])
    cfg = Config(kmer=20, max_read_len=100)
    k = 20
    # read of length 100 mapped at 50000: kmers at q=0,20,40,60,80
    qpos = np.array([0, 20, 40, 60, 80])
    seed_pos = [np.array([50000 + q]) for q in qpos]
    chains = chain_seeds_host(100, qpos, seed_pos, cfg, db, 0)
    assert len(chains) == 1
    assert list(chains[0].rpos) == [50000, 50020, 50040, 50060, 50080]
    assert chains[0].score == pytest.approx(20 + 4 * 2e4 * 20)

    dev = run_device(qpos, seed_pos, cfg, db, 100)
    assert len(dev) == 1
    assert chain_key(dev[0]) == chain_key(chains[0])
    assert dev[0].score == pytest.approx(chains[0].score)


def test_junction_chain(tmp_path):
    """Seeds spanning an annotated exon junction chain via the trans gate."""
    lines = [
        gtf_line("chr1", "gene", 1000, 9000, "+", "G1"),
        gtf_line("chr1", "transcript", 1000, 9000, "+", "G1", "T1"),
        gtf_line("chr1", "exon", 1000, 1059, "+", "G1", "T1", 1),
        gtf_line("chr1", "exon", 5000, 9000, "+", "G1", "T1", 2),
    ]
    db = make_db(tmp_path, lines)
    cfg = Config(kmer=20, max_read_len=100)
    # 100bp read: 60bp on exon1 (1000-1059), 40bp on exon2 (5000-5039)
    qpos = np.array([0, 20, 40, 60, 80])
    seed_pos = [np.array([1000]), np.array([1020]), np.array([1040]),
                np.array([5000]), np.array([5020])]
    chains = chain_seeds_host(100, qpos, seed_pos, cfg, db, 0)
    assert len(chains) >= 1
    assert list(chains[0].rpos) == [1000, 1020, 1040, 5000, 5020]
    dev = run_device(qpos, seed_pos, cfg, db, 100)
    assert chain_key(dev[0]) == chain_key(chains[0])
    assert dev[0].score == pytest.approx(chains[0].score)


def test_no_chain_without_annotation_gap(tmp_path):
    """A big genomic gap with no junction support must NOT chain."""
    db = make_db(tmp_path, [gtf_line("chr1", "gene", 10, 20, "+", "G1")])
    cfg = Config(kmer=20, max_read_len=100)
    qpos = np.array([0, 20])
    seed_pos = [np.array([50000]), np.array([70000])]
    chains = chain_seeds_host(40, qpos, seed_pos, cfg, db, 0)
    # falls back to single-fragment chains, highest list first
    assert all(c.chain_len == 1 for c in chains)
    assert chains[0].rpos[0] == 70000
    dev = run_device(qpos, seed_pos, cfg, db, 40)
    assert [chain_key(c) for c in dev] == [chain_key(c) for c in chains]


@pytest.mark.parametrize("trial", range(8))
def test_random_host_vs_device(tmp_path, rng, trial):
    lines = [
        gtf_line("chr1", "gene", 1000, 20000, "+", "G1"),
        gtf_line("chr1", "transcript", 1000, 20000, "+", "G1", "T1"),
        gtf_line("chr1", "exon", 1000, 2000, "+", "G1", "T1", 1),
        gtf_line("chr1", "exon", 5000, 5500, "+", "G1", "T1", 2),
        gtf_line("chr1", "exon", 9000, 9800, "+", "G1", "T1", 3),
        gtf_line("chr1", "transcript", 1000, 20000, "+", "G1", "T2"),
        gtf_line("chr1", "exon", 1500, 2000, "+", "G1", "T2", 1),
        gtf_line("chr1", "exon", 9000, 9400, "+", "G1", "T2", 2),
    ]
    db = make_db(tmp_path, lines)
    cfg = Config(kmer=20, max_read_len=100, max_chain_len=30)
    NL, S = 5, 8
    qpos = np.arange(NL) * 20
    seed_pos = []
    for l in range(NL):
        n = int(rng.integers(0, S + 1))
        # positions biased into the gene region so junction gates engage
        ps = np.sort(rng.choice(
            np.concatenate([rng.integers(900, 10000, 40),
                            rng.integers(40000, 41000, 10)]), size=n,
            replace=False)) if n else np.zeros(0, np.int64)
        ps = np.unique(ps).astype(np.int64)
        seed_pos.append(ps)
    host = chain_seeds_host(100, qpos, seed_pos, cfg, db, 0)
    dev = run_device(qpos, seed_pos, cfg, db, 100, S=S)
    # top chain must agree exactly (score and fragments)
    if host:
        assert dev, "device found no chains but host did"
        assert chain_key(host[0]) == chain_key(dev[0])
        assert host[0].score == pytest.approx(dev[0].score, abs=0.05)
        # chain sets agree (order may differ within equal scores)
        hk = {chain_key(c) for c in host}
        dk = {chain_key(c) for c in dev}
        # device does not replay stale improvement events; host chain set
        # may contain extra stale duplicates but all device chains must be
        # real host chains when below the 30 cap
        if len(host) < cfg.max_chain_len and len(dev) < cfg.max_chain_len:
            assert dk <= hk or hk <= dk
    else:
        assert not dev or all(c.chain_len == 1 for c in dev)
