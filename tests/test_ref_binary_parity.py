"""TRUE cross-binary parity: the reference CircMiner binary vs this
framework, byte-for-byte on circ_report + mapping.pam + candidates.pam.

The reference's lib/ submodules are empty, so the binary is built from
the reference's own sources plus minimal reconstructions of the four
missing mrsFAST files and logger.h (tools/refbuild/, APIs inferred from
call sites — SURVEY.md "Submodule caveat").  This is the parity anchor
the repo previously lacked: tests/test_golden.py pins against
self-generated goldens; this test pins against bytes the REFERENCE
emitted.
"""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/root/reference"
BUILD_DIR = "/tmp/refbuild_test"


@pytest.fixture(scope="module")
def ref_binary():
    if not os.path.isdir(os.path.join(REF, "src")):
        pytest.skip("reference checkout unavailable")
    exe = os.path.join(BUILD_DIR, "circminer_ref")
    if not os.path.exists(exe):
        r = subprocess.run(
            ["bash", os.path.join(REPO, "tools/refbuild/build.sh"),
             BUILD_DIR], capture_output=True, text=True)
        if r.returncode != 0:
            pytest.skip(f"reference build failed: {r.stderr[-500:]}")
    return exe


def _cli_env():
    # the subprocess must run CPU-only
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_PLATFORM_NAME", None)
    return env


def test_cross_binary_outputs_identical(ref_binary, tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools/make_synthetic.py"),
         "--out", str(data), "--genome-len", "50000", "--n-reads", "400",
         "--circ-frac", "0.25"], capture_output=True, text=True,
        env=_cli_env())
    assert r.returncode == 0, r.stderr[-500:]

    # reference binary: its own dir (both tools write ref.fa.packed.* in
    # place with colliding names)
    refd = tmp_path / "ref"
    refd.mkdir()
    for f in ("ref.fa", "ref.gtf", "R1.fq", "R2.fq"):
        shutil.copy(data / f, refd / f)
    for args in (["--index", "-r", "ref.fa", "-k", "20"],
                 ["-r", "ref.fa", "-g", "ref.gtf", "-1", "R1.fq",
                  "-2", "R2.fq", "-o", "refout", "--pam"]):
        r = subprocess.run([ref_binary] + args, cwd=refd,
                           capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, (args, r.stderr[-500:])

    ourd = tmp_path / "ours"
    ourd.mkdir()
    for f in ("ref.fa", "ref.gtf", "R1.fq", "R2.fq"):
        shutil.copy(data / f, ourd / f)
    for args in (["--index", "-r", "ref.fa", "-k", "20"],
                 ["-r", "ref.fa", "-g", "ref.gtf", "-1", "R1.fq",
                  "-2", "R2.fq", "-o", "ourout", "--pam"]):
        r = subprocess.run(
            [sys.executable, "-m", "circminer_jax.cli"] + args, cwd=ourd,
            capture_output=True, text=True, env=_cli_env(), timeout=900)
        assert r.returncode == 0, (args, r.stderr[-800:])

    for ref_f, our_f in (("refout.circ_report", "ourout.circ_report"),
                         ("refout.mapping.pam", "ourout.mapping.pam"),
                         ("refout.candidates.pam",
                          "ourout.candidates.pam")):
        a = (refd / ref_f).read_bytes()
        b = (ourd / our_f).read_bytes()
        assert a == b, f"{ref_f} differs from {our_f}"
    # and the run must have called something
    assert len((refd / "refout.circ_report").read_text().strip()) > 0
