"""Device-resident mapping finish, part 1: k-best chain extraction.

The host pipeline fetches the chain-DP result tensors (dp10 | back) and
extracts k-best chains on the CPU (ops/chain.py extract_kbest /
native/chain_kernels.cpp batch_extract_kbest — the port of the reference's
event-ordered backtrack, src/chain.cpp:234-298).  For the fused
``device-full`` executor the chains must never leave the device: this
module re-expresses the same extraction as a fixed-shape jax program so it
can run inside the one fused dispatch, keeping only the final MatchedRead
state as the d2h payload.

Semantics replicated exactly (pinned by tests/test_device_finish.py
against extract_kbest):
  * event cells = DP cells improved by a transition (back >= 0),
  * candidate order: score desc, list desc, index asc,
  * backtrack with repeat suppression: a candidate whose head position was
    already used as a NON-head fragment of an earlier chain is skipped,
    unless it carries the global best score,
  * cap of C chains; single-fragment fallback (lists desc, index asc)
    when no chain was emitted.

Because the loop is fixed-length (ITERS event picks), a row whose event
list is longer than ITERS and still unfinished sets ``incomplete`` — the
caller defers that row to the host pipeline.

Layout: everything after the initial sort runs LANE-MAJOR — tensors carry
the row dimension R in the minor axis ([T, R], [T, M, R], [C, T, R]) and
every random access is a compare-and-reduce against an iota, never a
take_along_axis row gather or a scatter.  Whether this beats row gathers
on the GPU is open (ROADMAP 1.5).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_NEG = -(2 ** 29)


@partial(jax.jit, static_argnames=("k", "C", "iters"))
def extract_kbest_device(dp10, back, pos, qpos, cnt, *, k: int, C: int,
                         iters: int = 48):
    """dp10/back/pos int32 [R, NL, S], qpos/cnt int32 [R, NL].

    Returns (rpos [R,C,NL], qp [R,C,NL], clen [R,C], sc10 [R,C], cn [R],
    incomplete [R] bool) — identical layout to NativeChainer.extract_batch
    (scores as int32 score10)."""
    return extract_kbest_device_staged(dp10, back, pos, qpos, cnt, k=k,
                                       C=C, iters=iters, upto="full")


def extract_kbest_device_staged(dp10, back, pos, qpos, cnt, *, k: int,
                                C: int, iters: int = 48,
                                upto: str = "full"):
    """Implementation of extract_kbest_device with a stage cutoff for the
    on-chip micro-bisection (tools/bisect_extract.py):
    upto in ("sort", "walks", "emit", "assemble", "full")."""
    R, NL, S = dp10.shape
    M = NL * S
    dpf = dp10.reshape(R, M)
    backf = back.reshape(R, M)
    posf = pos.reshape(R, M)
    l_of = jnp.repeat(jnp.arange(NL, dtype=jnp.int32), S)        # [M]
    s_of = jnp.tile(jnp.arange(S, dtype=jnp.int32), NL)
    validf = (s_of[None, :] < cnt[:, l_of]) & (backf >= 0)

    best10 = jnp.max(jnp.where(validf, dpf, _NEG), axis=1)       # [R]
    # candidate secondary order among score ties: list desc, index asc
    sec = l_of * S + (S - 1 - s_of)                              # [M]

    # the pick order is STATIC — picks never change dp — so sort all cells
    # once by (score desc, sec desc)
    neg_dp = jnp.where(validf, -dpf, -_NEG)                      # [R, M]
    neg_sec = jnp.broadcast_to(-sec[None, :], (R, M))
    cell_idx = jnp.broadcast_to(jnp.arange(M, dtype=jnp.int32)[None, :],
                                (R, M))
    _, _, sorted_idx = jax.lax.sort((neg_dp, neg_sec, cell_idx),
                                    num_keys=2)
    n_valid = jnp.sum(validf.astype(jnp.int32), axis=1)          # [R]
    if upto == "sort":
        return sorted_idx, n_valid

    T = iters
    # ---- lane-major from here: R rides the minor axis -------------------
    heads_T = sorted_idx[:, :T].T                                # [T, R]
    dpf_T = dpf.T                                                # [M, R]
    backf_T = backf.T
    posf_T = posf.T
    qposf_T = qpos[:, l_of].T
    iota_m = jnp.arange(M, dtype=jnp.int32)[None, :, None]       # [1, M, 1]

    def fetch(cur_T, payloads):
        """payloads[i][m, r] at m = cur_T[t, r] -> [T, R] each, via ONE
        [T, M, R] equality mask shared across all payloads (the
        compare-reduce replacement for a row gather)."""
        eq = (cur_T[:, None, :] == iota_m)                       # [T, M, R]
        return [jnp.sum(jnp.where(eq, p[None, :, :], 0), axis=1)
                for p in payloads]

    # ---- walks of every candidate (bounded by NL fragments) -------------
    cur = heads_T                                                # [T, R]
    active = jnp.ones((T, R), jnp.bool_)
    wpos_f, wqp_f, wact_f = [], [], []
    sc_T = None
    for f in range(NL):
        if f == 0:
            wp, wq, sc_T, nxt = fetch(cur, (posf_T, qposf_T, dpf_T,
                                            backf_T))
        else:
            wp, wq, nxt = fetch(cur, (posf_T, qposf_T, backf_T))
        wpos_f.append(wp)
        wqp_f.append(wq)
        wact_f.append(active)
        active = active & (nxt >= 0)
        cur = jnp.where(active, nxt, cur)
    clen_T = sum(a.astype(jnp.int32) for a in wact_f)            # [T, R]
    hp_T = wpos_f[0]
    if upto == "walks":
        return wpos_f, wqp_f, clen_T, hp_T

    # ---- serial emission (repeat suppression is order-dependent) --------
    # The candidate walks are all known BEFORE emission, so the repeat test
    # collapses to a precomputed collision matrix:
    #   coll[t', t] = head_pos(t) appears among the NON-HEAD fragments of
    #                 candidate t'  (chain.cpp:266-270's repeat set, but
    #                 for every possible emitter at once)
    # and is_rep(t) = any(emitted & coll[:, t]).  The serial loop carries
    # only an emitted-mask [T, R] and does one slice + one [T, R]
    # reduction per step — no scatters, no repeat buffer.
    coll = jnp.zeros((T, T, R), jnp.bool_)
    for f in range(1, NL):
        coll = coll | ((wpos_f[f][:, None, :] == hp_T[None, :, :])
                       & wact_f[f][:, None, :])
    cn = jnp.zeros((R,), jnp.int32)
    emitted = jnp.zeros((T, R), jnp.bool_)

    def pick_body(t, carry):
        cn, emitted = carry
        msc = jax.lax.dynamic_index_in_dim(sc_T, t, axis=0,
                                           keepdims=False)       # [R]
        has = t < n_valid
        coll_t = jax.lax.dynamic_index_in_dim(coll, t, axis=1,
                                              keepdims=False)    # [T, R]
        is_rep = jnp.any(emitted & coll_t, axis=0)               # [R]
        emit = has & ~((msc < best10) & is_rep) & (cn < C)
        emitted = jax.lax.dynamic_update_slice_in_dim(
            emitted, emit[None, :], t, axis=0)
        cn = cn + emit.astype(jnp.int32)
        return cn, emitted

    cn, emitted = jax.lax.fori_loop(0, T, pick_body, (cn, emitted))
    if upto == "emit":
        return cn, emitted.T

    # ---- assembly: slot c <- the c-th emitted pick ----------------------
    # rank emitted picks along T; slot c's pick = the unique t with
    # (emitted & rank == c), found by a [C, T, R] compare-reduce (the
    # scatter-free pick_of_slot)
    ranke = jnp.cumsum(emitted.astype(jnp.int32), axis=0) - 1    # [T, R]
    iota_c = jnp.arange(C, dtype=jnp.int32)[:, None, None]       # [C, 1, 1]
    sel = emitted[None, :, :] & (ranke[None, :, :] == iota_c)    # [C, T, R]

    def pick_reduce(v_T):
        return jnp.sum(jnp.where(sel, v_T[None, :, :], 0), axis=1)  # [C, R]

    slot_valid = iota_c[:, 0, :] < cn[None, :]                   # [C, R]
    out_rpos_cf = []
    out_qp_cf = []
    for f in range(NL):
        wa_c = pick_reduce(wact_f[f].astype(jnp.int32)) != 0
        sel_wa = wa_c & slot_valid
        out_rpos_cf.append(jnp.where(sel_wa, pick_reduce(wpos_f[f]), 0))
        out_qp_cf.append(jnp.where(sel_wa, pick_reduce(wqp_f[f]), 0))
    out_clen_c = jnp.where(slot_valid, pick_reduce(clen_T), 0)   # [C, R]
    out_sc_c = jnp.where(slot_valid, pick_reduce(sc_T), 0)

    incomplete = (n_valid > iters) & (cn < C)
    if upto == "assemble":
        return (jnp.stack(out_rpos_cf, 1), jnp.stack(out_qp_cf, 1),
                out_clen_c, out_sc_c, cn, incomplete)

    # ---- single-fragment fallback (chain.cpp:283-298): lists desc, s asc
    fb_needed = cn == 0                                          # [R]
    perm = (np.arange(NL - 1, -1, -1, dtype=np.int32)[:, None] * S
            + np.arange(S, dtype=np.int32)[None, :]).reshape(M)  # [M]
    # validity (in-count, not event) in perm order, lane-major [M, R]
    v_sf_T = (s_of[perm][:, None] < cnt[:, l_of[perm]].T)        # [M, R]
    rank_fb = jnp.cumsum(v_sf_T.astype(jnp.int32), axis=0) - 1   # [M, R]
    take = v_sf_T & (rank_fb < C)
    selfb = take[None, :, :] & (rank_fb[None, :, :] == iota_c)   # [C, M, R]
    pperm = jnp.asarray(perm)

    def fb_reduce(v_T):
        return jnp.sum(jnp.where(selfb, v_T[pperm][None, :, :], 0), axis=1)

    fb_rpos = fb_reduce(posf_T)                                  # [C, R]
    fb_qp = fb_reduce(qposf_T)
    fb_sc = fb_reduce(dpf_T)
    n_fb = jnp.minimum(jnp.sum(v_sf_T.astype(jnp.int32), axis=0),
                       C).astype(jnp.int32)

    fbm = fb_needed[None, :]                                     # [1, R]
    out_rpos_cf[0] = jnp.where(fbm, fb_rpos, out_rpos_cf[0])
    out_qp_cf[0] = jnp.where(fbm, fb_qp, out_qp_cf[0])
    for f in range(1, NL):
        out_rpos_cf[f] = jnp.where(fbm, 0, out_rpos_cf[f])
        out_qp_cf[f] = jnp.where(fbm, 0, out_qp_cf[f])
    fb_len = (iota_c[:, 0, :] < n_fb[None, :]).astype(jnp.int32)
    out_clen_c = jnp.where(fbm, fb_len, out_clen_c)
    out_sc_c = jnp.where(fbm, fb_sc, out_sc_c)
    cn = jnp.where(fb_needed, n_fb, cn)

    # ---- back to row-major [R, C, NL] / [R, C] for the finish -----------
    out_rpos = jnp.stack(out_rpos_cf, axis=1).transpose(2, 0, 1)
    out_qp = jnp.stack(out_qp_cf, axis=1).transpose(2, 0, 1)
    out_clen = out_clen_c.T
    out_sc = out_sc_c.T
    return out_rpos, out_qp, out_clen, out_sc, cn, incomplete
