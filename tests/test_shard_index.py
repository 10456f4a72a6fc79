"""Bucket-sharded index lookup (TP analog) vs. the replicated device path.

SURVEY §5: when the full index exceeds one device's memory, hash buckets
are sharded across devices; each device answers the queries whose window hash it
owns and contributions are combined with psum over the mesh — results must
be bit-identical to the replicated single-device lookup.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from __graft_entry__ import _tiny_problem
from circminer_jax.ops.seed import (lookup_batch_device, gather_seeds_device,
                                    lookup_gather_sharded_local)
from circminer_jax.ops.chain import chain_batch_device
from circminer_jax.parallel.mesh import (make_mesh, shard_index_arrays,
                                         shard_index, shard_reads, replicate,
                                         make_index_sharded_map_step)

CAP = 16


def _replicated(cfg, ci, ad, reads, lens):
    k, cs_len = cfg.kmer, cfg.checksum_len
    qpos_d, start_d, cnt_d, hh_d = lookup_batch_device(
        reads, lens, jnp.asarray(ci.entry_hv),
        jnp.asarray(ci.entry_checksum),
        k=k, cs_len=cs_len, n_slots=cfg.max_seg_cnt, seed_lim=cfg.seed_lim)
    sl = slice(0, None, 2)
    cnt_c = cnt_d[:, sl]
    qpos_c = qpos_d[:, sl]
    pos_b, _ = gather_seeds_device(jnp.asarray(ci.entry_pos),
                                   start_d[:, sl], cnt_c, cap=CAP)
    dp10, back = chain_batch_device(
        pos_b, cnt_c, jnp.maximum(qpos_c, 0), lens,
        ad.nb_bits, ad.iv_spos, ad.iv_epos, ad.iv_max_end, ad.iv_min_end,
        ad.iv_max_next, ad.iv_nseg, ad.seg_end, ad.seg_next,
        k=k, max_ed=cfg.max_ed, max_intron=cfg.max_intron,
        seg_pad=ad.seg_pad)
    hh = np.asarray(hh_d[:, sl]).astype(np.int32).sum(axis=1)
    return (np.asarray(pos_b), np.asarray(cnt_c), np.asarray(qpos_c),
            np.asarray(dp10), np.asarray(back), hh)


def test_shard_index_arrays_cover_all_entries():
    cfg, ci, ad, reads, lens, _db = _tiny_problem(1)
    for d in (1, 3, 8):
        lhv, lcs, lpos, blo, bhi = shard_index_arrays(
            ci, d, window_size=cfg.window_size)
        total = 0
        for s in range(d):
            n_local = int((lhv[s] < 2 ** 30).sum())
            lo_b, hi_b = int(blo[s]), int(bhi[s])
            e_lo = int(np.searchsorted(ci.entry_hv, lo_b))
            total += n_local
            # local slices reproduce the global entry table
            np.testing.assert_array_equal(
                lhv[s, :n_local], ci.entry_hv[e_lo:e_lo + n_local])
            assert np.all(lhv[s, :n_local] >= lo_b)
            assert np.all(lhv[s, :n_local] < hi_b)
            np.testing.assert_array_equal(
                lpos[s, :n_local], ci.entry_pos[e_lo:e_lo + n_local])
        assert total == ci.n_entries


def test_sharded_local_lookup_psum_matches_replicated():
    """Sum of per-shard contributions == replicated lookup (pure numpy psum,
    no mesh — validates the owner-computes masking)."""
    cfg, ci, ad, reads, lens, _db = _tiny_problem(2)
    k, cs_len = cfg.kmer, cfg.checksum_len
    pos_ref, cnt_ref, qpos_ref, _, _, _ = _replicated(cfg, ci, ad, reads, lens)

    D = 4
    lhv, lcs, lpos, blo, bhi = shard_index_arrays(
        ci, D, window_size=cfg.window_size)
    pos_sum = np.zeros_like(pos_ref)
    cnt_sum = np.zeros_like(cnt_ref)
    for d in range(D):
        qpos, pos, cnt, high = lookup_gather_sharded_local(
            reads, lens, jnp.asarray(lhv[d]), jnp.asarray(lcs[d]),
            jnp.asarray(lpos[d]), jnp.int32(blo[d]), jnp.int32(bhi[d]),
            k=k, cs_len=cs_len, n_slots=cfg.max_seg_cnt,
            seed_lim=cfg.seed_lim, cap=CAP)
        np.testing.assert_array_equal(np.asarray(qpos), qpos_ref)
        pos_sum += np.asarray(pos)
        cnt_sum += np.asarray(cnt)
    np.testing.assert_array_equal(cnt_sum, cnt_ref)
    np.testing.assert_array_equal(pos_sum, pos_ref)


@pytest.mark.parametrize("n_devices", [2, 8])
def test_index_sharded_map_step_matches_replicated(n_devices):
    if len(jax.devices()) < n_devices:
        pytest.skip("needs virtual devices")
    cfg, ci, ad, reads, lens, _db = _tiny_problem(n_devices)
    B = reads.shape[0]
    assert B % n_devices == 0
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
