#!/usr/bin/env python
"""Micro-bisection of extract_kbest_device on the device: each cumulative
stage (sort | walks | emit | assemble | full) is its own jitted program,
timed to ``jax.block_until_ready``."""

import argparse
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import circminer_jax
    circminer_jax.enable_compilation_cache()

    R = 4 * args.batch
    NL, S = 6, 16
    M = NL * S
    rng = np.random.default_rng(0)
    # synthetic but structurally realistic DP outputs: sparse events
    dp10 = rng.integers(0, 3_000_000, size=(R, NL, S)).astype(np.int32)
    back = np.where(rng.random((R, NL, S)) < 0.15,
                    rng.integers(0, M, size=(R, NL, S)), -1).astype(np.int32)
    pos = np.sort(rng.integers(1, 90_000, size=(R, NL, S)).astype(np.int32),
                  axis=-1)
    qpos = (np.arange(NL, dtype=np.int32) * 20)[None, :].repeat(R, 0)
    cnt = rng.integers(0, S + 1, size=(R, NL)).astype(np.int32)

    from circminer_jax.ops import device_finish as DF

    k, C, iters = 20, 7, 48

    def staged(dp10, back, pos, qpos, cnt, upto):
        return DF.extract_kbest_device_staged(
            dp10, back, pos, qpos, cnt, k=k, C=C, iters=iters, upto=upto)

    a = tuple(map(jnp.asarray, (dp10, back, pos, qpos, cnt)))
    for name in ("sort", "walks", "emit", "assemble", "full"):
        fn = jax.jit(partial(staged, upto=name))
        t0 = time.time()
        jax.block_until_ready(fn(*a))
        tc = time.time() - t0
        ts = []
        for _ in range(args.reps):
            t0 = time.time()
            jax.block_until_ready(fn(*a))
            ts.append(time.time() - t0)
        print(f"[xbisect] {name:9s} {min(ts):7.3f}s (first={tc:.1f}s)",
              flush=True)


if __name__ == "__main__":
    main()
