#!/usr/bin/env python
"""Reduce a jax.profiler trace to device time per program and per op scope.

Reads the newest ``*.xplane.pb`` under a trace directory (``cli
--trace-dir``, ``chip_smoke.py --trace-dir``) and prints, for the GPU
planes:

  * the window (first to last device event), busy time (union of event
    intervals) and idle share;
  * device time per jitted program (``hlo_module``);
  * the top op scopes of one program (--module) — an event's ``name``
    stat is the op's JAX name stack down to the innermost jit
    (``jit(device_full_step)/jit(lookup_batch_device)``), cut here to
    --depth components; fusions without it show their HLO name;
  * that program's time grouped by how often each op was launched: ops
    inside a loop launch once per iteration (a 254-diagonal scan run in 4
    walk waves over 2 steps launches its ops 2,032 times);
  * the share of that program's time whose name stack contains each
    --match substring (such as ``xdrop_batch_ref``).

Usage: python tools/trace_ops.py TRACE_DIR [--module jit_device_full_step]
           [--match xdrop_batch_ref] [--depth 3] [--top 20]
"""

import argparse
import collections
import glob
import os
import sys


def load_events(trace_dir):
    """[(module, name_stack, hlo_op, start_ns, dur_ns)] of device events."""
    from jax.profiler import ProfileData
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise SystemExit(f"no .xplane.pb under {trace_dir}")
    pd = ProfileData.from_file(paths[-1])
    out = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                st = dict(ev.stats)
                out.append((str(st.get("hlo_module", "")),
                            str(st.get("name", ev.name)),
                            str(st.get("hlo_op", ev.name)),
                            float(ev.start_ns), float(ev.duration_ns)))
    return out


def busy_ns(events):
    """Length of the union of [start, start + dur) intervals."""
    total, end = 0.0, None
    for _, _, _, s, d in sorted(events, key=lambda e: e[3]):
        if end is None or s >= end:
            total += d
            end = s + d
        elif s + d > end:
            total += s + d - end
            end = s + d
    return total


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("trace_dir")
    ap.add_argument("--module", default="jit_device_full_step")
    ap.add_argument("--match", action="append", default=[])
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)

    evs = load_events(args.trace_dir)
    if not evs:
        raise SystemExit("the trace has no GPU device events")
    t0 = min(e[3] for e in evs)
    t1 = max(e[3] + e[4] for e in evs)
    busy = busy_ns(evs)
    print(f"window {(t1 - t0) / 1e6:.3f} ms, busy {busy / 1e6:.3f} ms, "
          f"idle share {1 - busy / (t1 - t0):.4f}, {len(evs)} events")

    per_mod = collections.Counter()
    n_mod = collections.Counter()
    for m, _, _, _, d in evs:
        per_mod[m] += d
        n_mod[m] += 1
    print("device time per program:")
    for m, d in per_mod.most_common():
        print(f"  {d / 1e6:10.3f} ms  {n_mod[m]:7d} events  {m or '(none)'}")

    mod = [e for e in evs if e[0] == args.module]
    tot = sum(e[4] for e in mod)
    if not mod:
        print(f"no events of {args.module}")
        return 0
    scopes = collections.Counter()
    for _, name, op, _, d in mod:
        parts = [p for p in name.split("/") if p]
        scopes["/".join(parts[:args.depth]) or op] += d
    print(f"top op scopes of {args.module} ({tot / 1e6:.3f} ms):")
    for sc, d in scopes.most_common(args.top):
        print(f"  {d / 1e6:10.3f} ms  {100 * d / tot:6.2f}%  {sc}")
    launches = collections.Counter(op for _, _, op, _, _ in mod)
    by_count = collections.Counter()
    for _, _, op, _, d in mod:
        by_count[launches[op]] += d
    print(f"{args.module} time by launches per op:")
    for c, d in by_count.most_common(args.top):
        print(f"  {d / 1e6:10.3f} ms  {100 * d / tot:6.2f}%  x{c}")
    for sub in args.match:
        d = sum(e[4] for e in mod if sub in e[1])
        print(f"share of {args.module} under '{sub}': {d / 1e6:.3f} ms "
              f"({100 * d / tot:.2f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
