"""Multi-host (shared-filesystem) CLI runs: striped mapping shards merge to
the single-host circ_report."""

import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _cli(args, cwd, env):
    subprocess.run([sys.executable, "-m", "circminer_jax.cli"] + args,
                   check=True, cwd=cwd, env=env, capture_output=True)


def test_stripe_pairs():
    from circminer_jax.parallel.distributed import stripe_pairs
    items = list(range(10))
    s0 = list(stripe_pairs(items, 0, 3))
    s1 = list(stripe_pairs(items, 1, 3))
    s2 = list(stripe_pairs(items, 2, 3))
    assert s0 == [0, 3, 6, 9] and s1 == [1, 4, 7] and s2 == [2, 5, 8]
    assert list(stripe_pairs(items, 1, 3, with_index=True))[0] == (1, 1)


def test_two_host_run_matches_single(tmp_path):
    env = _env()
    tmp = str(tmp_path)
    subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "make_synthetic.py"),
         "--out", tmp, "--genome-len", "60000", "--n-reads", "1500",
         "--circ-frac", "0.4", "--seed", "55"],
        check=True, cwd=tmp, env=env, capture_output=True)
    _cli(["--index", "-r", "ref.fa", "-k", "20"], tmp, env)

    base = ["-r", "ref.fa", "-g", "ref.gtf", "-1", "R1.fq", "-2", "R2.fq",
            "--device", "native"]
    # single host
    _cli(base + ["-o", "single"], tmp, env)
    with open(os.path.join(tmp, "single.circ_report"), "rb") as f:
        want = f.read()
    assert want, "single-host run found no events"

    # two 'hosts' sequentially over the shared directory: host 1 maps only,
    # host 0 maps then merges every shard's remain files for the circ stage
    _cli(base + ["-o", "multi", "--num-hosts", "2", "--host-id", "1"],
         tmp, env)
    _cli(base + ["-o", "multi", "--num-hosts", "2", "--host-id", "0"],
         tmp, env)
    with open(os.path.join(tmp, "multi.circ_report"), "rb") as f:
        got = f.read()
    assert got == want


def test_coordinated_two_process_run_matches_single(tmp_path):
    """Two CONCURRENT processes under a real jax.distributed coordinator
    (parallel/distributed.py maybe_initialize): the merged circ_report
    must equal the single-host one."""
    import socket
    env = _env()
    tmp = str(tmp_path)
    subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "make_synthetic.py"),
         "--out", tmp, "--genome-len", "25000", "--n-reads", "200",
         "--circ-frac", "0.3", "--seed", "77"],
        check=True, cwd=tmp, env=env, capture_output=True)
    _cli(["--index", "-r", "ref.fa", "-k", "20"], tmp, env)

    base = ["-r", "ref.fa", "-g", "ref.gtf", "-1", "R1.fq", "-2", "R2.fq",
            "--device", "native"]
    _cli(base + ["-o", "single"], tmp, env)
    with open(os.path.join(tmp, "single.circ_report"), "rb") as f:
        want = f.read()
    assert want

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    cmd = [sys.executable, "-m", "circminer_jax.cli"] + base + [
        "-o", "coord", "--coordinator", coord, "--num-hosts", "2"]
    procs = [subprocess.Popen(cmd + ["--host-id", str(h)], cwd=tmp, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for h in range(2)]
    outs = [p.communicate(timeout=420) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e.decode()[-2000:]
    with open(os.path.join(tmp, "coord.circ_report"), "rb") as f:
        got = f.read()
    assert got == want


@pytest.mark.parametrize("local_device,want", [(None, [3]), (0, [0])])
def test_each_process_opens_one_card(monkeypatch, local_device, want):
    """A coordinated process asks jax.distributed for one local device:
    its own card (default: its host id), never every card it can see."""
    import jax
    from circminer_jax.parallel.distributed import maybe_initialize
    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    assert maybe_initialize("localhost:1234", 4, 3, local_device) == (3, 4)
    assert seen == dict(coordinator_address="localhost:1234",
                        num_processes=4, process_id=3,
                        local_device_ids=want)
