#!/usr/bin/env python
"""Smoke run of the main path on a GPU: map + circRNA call end to end.

Drives the CLI in-process at chromosome scale — BASELINE config 1, the
deployment bench.py runs by default, with the read count cut to 50,000
pairs — on the fused device executor, and holds it bit for bit to the host
executors:

  a. device check: the first JAX device must be a GPU (no CPU fallback);
     the card's name and power limit from nvidia-smi head every number;
  b. data: a 47 Mbp synthetic genome (5% segmental duplications, one gene
     per 60 kbp) as FASTA + GTF, and 50,000 2x100 bp pairs (error rate
     0.005, 20% back-splice reads) in shuffled order;
  c. main path: ``--index -k 20``, then the search with ``--device
     device-full --pam``: index, warmup/compile, map and call seconds, the
     deferral share with its causes, the device memory peak;
  d. plain references: the same search with ``--device native`` on every
     pair, and the per-read python oracle (``--device host``) on the first
     2,000 pairs against device-full on the same pairs; circ_report,
     mapping.pam and candidates.pam must be byte-identical; recall against
     the planted back-splice events;
  e. the wavefront DPs of ops/wavefront.py compiled for the card at
     B=4096, I=128, bit-equal to the host oracle ops/align.py; ms/call.

Every comparison is exact: the device path does integer arithmetic only.
A phase that fails raises, and the script exits non-zero without printing
the last line, ``{"ok": true, "device": {...}}``.

    python chip_smoke.py              one card, phases a-e
    python chip_smoke.py --cards 4    four coordinated CLI processes, one
                                      per card, against a one-process run,
                                      then __graft_entry__.dryrun_multichip
"""

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

OUTPUTS = ("circ_report", "mapping.pam", "candidates.pam")
DP_W, DP_MAX_ED, DP_MAX_SC = 3, 4, 7


def card_names() -> str:
    """The cards' name and power limit, as nvidia-smi reports them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return "; ".join(ln.strip() for ln in res.stdout.splitlines()
                     if ln.strip())


def check_device(platform: str, allow_cpu: bool = False) -> None:
    """Refuse any backend but the GPU (the host CPU only when asked)."""
    if platform != "gpu" and not (allow_cpu and platform == "cpu"):
        raise SystemExit(f"chip_smoke: JAX found no GPU (platform "
                         f"{platform!r}); refusing to run on it")


class Log:
    """Prints one line per measurement, each tagged with the card."""

    def __init__(self, card: str):
        self.card = card

    def __call__(self, msg: str) -> None:
        print(f"[{self.card}] {msg}", flush=True)


def make_data(work: str, genome_len: int, n_pairs: int, n_oracle: int):
    """Phase b: genome FASTA + GTF, FASTQ of all pairs and of the first
    n_oracle pairs; returns the planted back-splice events."""
    import numpy as np
    from circminer_jax.sim import make_genome, simulate_reads, write_fastq

    g = make_genome(np.random.default_rng(20260817), length=genome_len,
                    n_genes=max(3, genome_len // 60_000), dup_frac=0.05)
    g.write_fasta(os.path.join(work, "ref.fa"))
    g.write_gtf(os.path.join(work, "ref.gtf"))
    n_circ = n_pairs // 5
    reads, truth = simulate_reads(np.random.default_rng(20260818), g,
                                  n_pairs - n_circ, n_circ, read_len=100,
                                  err_rate=0.005)
    # simulate_reads emits linear pairs first: shuffle so the oracle's
    # prefix carries back-splice reads too
    order = np.random.default_rng(20260819).permutation(len(reads))
    reads = [reads[i] for i in order]
    write_fastq(reads, os.path.join(work, "R1.fq"),
                os.path.join(work, "R2.fq"))
    write_fastq(reads[:n_oracle], os.path.join(work, "o1.fq"),
                os.path.join(work, "o2.fq"))
    return set(truth)


def search(work, out, device, r1="R1.fq", r2="R2.fq", extra=()):
    """One in-process CLI search; returns its stats."""
    from circminer_jax import cli
    stats = {}
    argv = ["-r", os.path.join(work, "ref.fa"),
            "-g", os.path.join(work, "ref.gtf"),
            "-1", os.path.join(work, r1), "-2", os.path.join(work, r2),
            "-o", os.path.join(work, out), "--pam", "--device", device,
            "-t", "0", *extra]
    if cli.main(argv, stats=stats) != 0:
        raise RuntimeError(f"cli search {device} -> {out} failed")
    return stats


def same_outputs(work, a, b) -> None:
    for ext in OUTPUTS:
        with open(os.path.join(work, f"{a}.{ext}"), "rb") as f:
            want = f.read()
        with open(os.path.join(work, f"{b}.{ext}"), "rb") as f:
            got = f.read()
        if want != got:
            raise AssertionError(f"{a}.{ext} and {b}.{ext} differ")


def report_events(path):
    with open(path) as f:
        return {(int(c[1]), int(c[2]))
                for c in (ln.split("\t") for ln in f) if len(c) > 2}


def random_dp_pairs(rng, B, I=128):
    """(s, t, n, m) batches in the banded regime (n > 2w, m > w): near-
    identical pairs, indels either side, unrelated pairs, some N bases."""
    import numpy as np
    W = DP_W
    s = np.zeros((B, I - 1), np.int8)
    t = np.zeros((B, I - 1), np.int8)
    ns = np.zeros(B, np.int32)
    ms = np.zeros(B, np.int32)
    for b in range(B):
        m = int(rng.integers(W + 1, 110))
        base = rng.integers(0, 4, size=m + 2 * W).astype(np.int8)
        kind = b % 4
        if kind == 0:
            sv = base[:m].copy()
            for _ in range(int(rng.integers(0, 3))):
                sv[rng.integers(0, m)] = rng.integers(0, 4)
        elif kind == 1:
            n = min(m + int(rng.integers(1, W + 1)), 110)
            sv = np.concatenate([base[:m], rng.integers(
                0, 4, size=n - m).astype(np.int8)])
        elif kind == 2:
            sv = base[:max(2 * W + 1, m - int(rng.integers(1, W + 1)))]
        else:
            sv = rng.integers(0, 4, size=int(rng.integers(2 * W + 1, 110))
                              ).astype(np.int8)
        sv = sv.copy()
        if len(sv) <= 2 * W:
            sv = np.concatenate([sv, np.zeros(2 * W + 1 - len(sv), np.int8)])
        if rng.random() < 0.1:
            sv[rng.integers(0, len(sv))] = 4
        s[b, :len(sv)] = sv
        t[b, :m] = base[:m]
        ns[b], ms[b] = len(sv), m
    return s, t, ns, ms


def dp_forms(log, B=4096, reps=20) -> None:
    """Phase e: the production wavefront DPs on the device vs ops/align."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from circminer_jax.ops import align as al
    from circminer_jax.ops.wavefront import xdrop_batch_ref, edit_sc_batch_ref

    sm = al.ScoreMat()
    s, t, ns, ms = random_dp_pairs(np.random.default_rng(11), B)
    args = tuple(jnp.asarray(x) for x in (s, t, ns, ms))
    forms = (
        ("xdrop_batch_ref", xdrop_batch_ref,
         dict(w=DP_W, mat=sm.mat, mis=sm.mis, ind=sm.ind, xd=sm.xd),
         lambda b: al.global_banded_alignment_drop(
             s[b, :ns[b]], t[b, :ms[b]], DP_W, sm)),
        ("edit_sc_batch_ref", edit_sc_batch_ref,
         dict(w=DP_W, max_ed=DP_MAX_ED, max_sc=DP_MAX_SC),
         lambda b: al.edit_local_alignment_right_sc(
             s[b, :ns[b]], t[b, :ms[b]], DP_W, DP_MAX_ED, DP_MAX_SC)),
    )
    for name, fn, kw, oracle in forms:
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kw))
        first = time.perf_counter() - t0
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args, **kw))
            times.append(time.perf_counter() - t0)
        got = np.stack([np.asarray(o) for o in out], axis=1)
        want = np.array([oracle(b) for b in range(B)], dtype=np.int64)
        bad = np.nonzero((got != want).any(axis=1))[0]
        if len(bad):
            b = int(bad[0])
            raise AssertionError(f"{name}: {len(bad)} of {B} rows differ "
                                 f"from ops/align.py, first row {b}: "
                                 f"{got[b].tolist()} != {want[b].tolist()}")
        log(f"e. {name} B={B} I=128: bit-equal to ops/align.py; "
            f"{1e3 * float(np.median(times)):.3f} ms/call median of {reps} "
            f"(min {1e3 * min(times):.3f}), first call {first:.2f} s")


def one_card(args) -> dict:
    import jax
    dev = jax.devices()[0]
    check_device(dev.platform, allow_cpu=args.cpu)
    card = card_names() if dev.platform == "gpu" else f"host {dev.platform}"
    print(card, flush=True)
    log = Log(card)
    from circminer_jax import CACHE_DIR, cli
    os.makedirs(CACHE_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=CACHE_DIR)
    try:
        t0 = time.perf_counter()
        truth = make_data(work, args.genome_len, args.pairs,
                          args.oracle_pairs)
        log(f"b. data: {args.genome_len} bp genome, {args.pairs} pairs, "
            f"{len(truth)} planted events ({time.perf_counter() - t0:.2f} s)")

        t0 = time.perf_counter()
        if cli.main(["--index", "-r", os.path.join(work, "ref.fa"),
                     "-k", "20"]) != 0:
            raise RuntimeError("cli --index failed")
        log(f"c. index build {time.perf_counter() - t0:.2f} s")
        st = search(work, "dev", "device-full")
        fs = st["full_stats"]
        causes = ", ".join(f"{k}={v}" for k, v in sorted(
            fs["causes"].items(), key=lambda kv: -kv[1])) or "none"
        log(f"c. device-full search: warmup/compile {st['warmup_s']:.2f} s, "
            f"map {st['map_s']:.2f} s, call {st['call_s']:.2f} s")
        log(f"c. deferred {fs['deferred']} of {fs['reads']} pairs "
            f"({100.0 * fs['deferred'] / max(1, fs['reads']):.3f}%); "
            f"causes: {causes}")
        mem = dev.memory_stats() or {}
        log(f"c. device memory peak {mem.get('peak_bytes_in_use', 0)} B of "
            f"{mem.get('bytes_limit', 0)} B limit")

        st = search(work, "nat", "native")
        same_outputs(work, "nat", "dev")
        log(f"d. native search (map {st['map_s']:.2f} s, call "
            f"{st['call_s']:.2f} s): circ_report, mapping.pam, "
            f"candidates.pam byte-identical to device-full")
        extra = ("--trace-dir", args.trace_dir) if args.trace_dir else ()
        st_dev = search(work, "dev_o", "device-full", "o1.fq", "o2.fq", extra)
        st = search(work, "host_o", "host", "o1.fq", "o2.fq")
        same_outputs(work, "host_o", "dev_o")
        log(f"d. python oracle on the first {args.oracle_pairs} pairs (map "
            f"{st['map_s']:.2f} s, call {st['call_s']:.2f} s; device-full "
            f"map {st_dev['map_s']:.2f} s): all three outputs "
            f"byte-identical")
        called = report_events(os.path.join(work, "dev.circ_report"))
        log(f"d. recall {len(called & truth)} of {len(truth)} planted "
            f"events ({len(called)} events reported)")
        if not called & truth:
            raise AssertionError("no planted event was called")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    dp_forms(log)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def _run(cmd, env, timeout=1500):
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=timeout)
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[:4])}... exited "
                           f"{res.returncode}:\n{res.stderr[-3000:]}")
    return res.stdout


def _wait(procs, what):
    try:
        outs = [p.communicate(timeout=1500) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"{what} {i} exited {p.returncode}:\n"
                               f"{err[-3000:]}")
    return [out for out, _ in outs]


def four_cards(args) -> dict:
    """The four-card path: 4 coordinated CLI processes, one card each, on
    the phase-b data against a one-process run, and the sharded fused steps
    of __graft_entry__.dryrun_multichip(4) against the single-card step.

    This process never opens a card.  The dryrun child compiles while the
    data is built and the CLI processes run, so every card holds two
    processes, each limited to a fifth of the card's memory."""
    child = dict(os.environ, PYTHONPATH=REPO)
    if not args.cpu:
        child["XLA_PYTHON_CLIENT_MEM_FRACTION"] = "0.2"
    os.environ["JAX_PLATFORMS"] = "cpu"     # this process stays off cards
    probe = json.loads(_run([sys.executable, "-c", (
        "import jax, json; d = jax.devices(); print(json.dumps(dict("
        "platform=d[0].platform, kind=d[0].device_kind, count=len(d))))")
    ], child).strip().splitlines()[-1])
    check_device(probe["platform"], allow_cpu=args.cpu)
    if probe["count"] != 4:
        raise SystemExit(f"chip_smoke: --cards 4 needs 4 devices, JAX "
                         f"found {probe['count']}")
    card = card_names() if probe["platform"] == "gpu" else "host cpu"
    print(card, flush=True)
    log = Log(card)
    t_all = time.perf_counter()
    dry = subprocess.Popen(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(4)"],
        cwd=REPO, env=child, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    from circminer_jax import CACHE_DIR, cli
    os.makedirs(CACHE_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke4_", dir=CACHE_DIR)
    try:
        make_data(work, args.genome_len, args.pairs, args.oracle_pairs)
        if cli.main(["--index", "-r", os.path.join(work, "ref.fa"),
                     "-k", "20"]) != 0:
            raise RuntimeError("cli --index failed")
        # the one-process reference: native, bit-identical to device-full
        # on these pairs (phase d of the one-card run)
        search(work, "single", "native")
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "circminer_jax.cli",
               "-r", os.path.join(work, "ref.fa"),
               "-g", os.path.join(work, "ref.gtf"),
               "-1", os.path.join(work, "R1.fq"),
               "-2", os.path.join(work, "R2.fq"), "-o",
               os.path.join(work, "multi"), "--pam", "--device",
               "device-full", "-t", "0", "--coordinator",
               f"localhost:{port}", "--num-hosts", "4"]
        procs = [subprocess.Popen(cmd + ["--host-id", str(h)], cwd=REPO,
                                  env=child, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for h in range(4)]
        _wait(procs, "CLI process")
        log(f"4. four coordinated device-full processes, one card each: "
            f"{time.perf_counter() - t0:.2f} s (process start, index load "
            f"and compile included)")
        with open(os.path.join(work, "single.circ_report"), "rb") as f:
            want = f.read()
        with open(os.path.join(work, "multi.circ_report"), "rb") as f:
            got = f.read()
        if not want or got != want:
            raise AssertionError("merged 4-process circ_report differs from "
                                 "the 1-process one")
        n_events = want.count(b"\n")
        log(f"4. merged circ_report of 4 processes byte-equal to a "
            f"1-process native run ({n_events} events)")
        out = _wait([dry], "dryrun")[0]
    finally:
        if dry.poll() is None:
            dry.kill()
        shutil.rmtree(work, ignore_errors=True)
    log(f"4. {out.strip().splitlines()[-1]} "
        f"({time.perf_counter() - t_all:.2f} s)")
    return probe


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    ap.add_argument("--genome-len", type=int, default=47_000_000)
    ap.add_argument("--pairs", type=int, default=50_000)
    ap.add_argument("--oracle-pairs", type=int, default=2_000)
    ap.add_argument("--trace-dir", default=None,
                    help="write a jax.profiler trace of the device-full "
                         "search on the oracle's pairs here")
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the host CPU backend")
    args = ap.parse_args(argv)
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.cards == 4:     # four virtual CPU devices for the children
            os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                       " --xla_force_host_platform_device_"
                                       "count=4").strip()
    device = four_cards(args) if args.cards == 4 else one_card(args)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
