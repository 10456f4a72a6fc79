"""Index-sharded multi-chip path at scale (>= 10 Mbp).

Asserts sharded == replicated lookups + chain DP bit-exactly on an
8-device virtual mesh over a 10 Mbp genome with segmental duplications
(the occupancy skew driver), and records the shard-skew statistics that
sizing a sharded index depends on.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from circminer_jax.config import Config
from circminer_jax.sim import make_genome, simulate_reads
from circminer_jax.io.fasta import GenomePacker
from circminer_jax.index.build import build_genome_index
from circminer_jax.annotation.annotation import AnnotationDB
from circminer_jax.annotation.device import AnnoDevice
from circminer_jax.ops.encode import encode_seq
from circminer_jax.parallel.mesh import (make_mesh, shard_index_arrays,
                                         shard_index, shard_reads,
                                         replicate,
                                         make_index_sharded_map_step)

CAP = 16
GENOME_LEN = 10_000_000


@pytest.fixture(scope="module")
def big_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard10m")
    rng = np.random.default_rng(29)
    g = make_genome(rng, length=GENOME_LEN, n_genes=160, dup_frac=0.05)
    ref = str(tmp / "ref.fa")
    gtf = str(tmp / "ref.gtf")
    g.write_fasta(ref)
    g.write_gtf(gtf)
    cfg = Config(kmer=20, max_read_len=120)
    gp = GenomePacker(ref)
    contigs, info = gp.pack_genome()
    gi = build_genome_index(contigs, cfg)
    db = AnnotationDB.from_gtf(gtf, info, 1, cfg,
                               contig_lengths=[len(c) for c in contigs])
    ad = AnnoDevice.from_contig(db.contigs[0], seg_pad=16)
    reads, _ = simulate_reads(rng, g, 120, 8, read_len=100, err_rate=0.005)
    rows = []
    for r in reads:
        rows.append(encode_seq(r.r1))
        rows.append(encode_seq(r.r2))
    B = 256
    L = cfg.max_read_len
    seqs = np.zeros((B, L), np.int8)
    lens = np.zeros(B, np.int32)
    for i, s in enumerate(rows[:B]):
        seqs[i, :len(s)] = s
        lens[i] = len(s)
    return cfg, gi.contigs[0], ad, jnp.asarray(seqs), jnp.asarray(lens)


def test_shard_skew_at_scale(big_world):
    """Shard sizing: bucket-range sharding keeps entry-count skew bounded
    even with 5% segmental duplications."""
    cfg, ci, ad, reads, lens = big_world
    for D in (4, 8):
        lhv, lcs, lpos, blo, bhi = shard_index_arrays(
            ci, D, window_size=cfg.window_size)
        counts = [(lhv[s] < 2 ** 30).sum() for s in range(D)]
        total = int(np.sum(counts))
        assert total == ci.n_entries
        skew = max(counts) / (total / D)
        print(f"[shard-skew] D={D} entries={total} "
              f"per-shard={[int(c) for c in counts]} "
              f"max/mean={skew:.3f} padded-to={lhv.shape[1]}")
        # the padded shard must not blow memory up more than ~2x vs ideal
        assert lhv.shape[1] * D < 2.2 * total + D * 4096


def test_index_sharded_matches_replicated_at_scale(big_world):
    from tests.test_shard_index import _replicated
    cfg, ci, ad, reads, lens = big_world
    n_devices = 8
    if len(jax.devices()) < n_devices:
        pytest.skip("needs 8 virtual devices")
    B = int(reads.shape[0])
    pos_ref, cnt_ref, _, dp_ref, back_ref, hh_ref = _replicated(
        cfg, ci, ad, reads, lens)

    mesh = make_mesh(n_devices)
    step = make_index_sharded_map_step(
        mesh, cfg, k=cfg.kmer, cs_len=cfg.checksum_len,
        n_slots=cfg.max_seg_cnt, seed_lim=cfg.seed_lim,
        seg_pad=ad.seg_pad, seed_cap=CAP, shard_batch=B // n_devices)

    args = [shard_reads(mesh, reads), shard_reads(mesh, lens)]
    args.extend(shard_index(mesh, ci, window_size=cfg.window_size))
    for a in (ad.nb_bits, ad.iv_spos, ad.iv_epos, ad.iv_max_end,
              ad.iv_min_end, ad.iv_max_next, ad.iv_nseg,
              ad.seg_end, ad.seg_next):
        args.append(replicate(mesh, a))

    dp10, back, pos_m, cnt_m, hh = step(*args)
    np.testing.assert_array_equal(np.asarray(cnt_m), cnt_ref)
    np.testing.assert_array_equal(np.asarray(pos_m), pos_ref)
    np.testing.assert_array_equal(np.asarray(dp10), dp_ref)
    np.testing.assert_array_equal(np.asarray(back), back_ref)
    np.testing.assert_array_equal(np.asarray(hh), hh_ref)
