"""Golden-output regression anchors.

Byte-for-byte comparison of the end-to-end CLI outputs (circ_report +
mapping.pam) on a pinned-seed synthetic dataset against checked-in golden
files (tests/golden/).  Parity-sensitive refactors of the seed/chain/extend/
category/circ code cannot silently drift past this.

To regenerate after an INTENDED behavior change:
    python tests/test_golden.py --regen
"""

import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "golden")


def _run_pipeline(tmp):
    """Build the pinned dataset and run index + search, returning output
    file paths."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # pin to CPU so golden outputs are hardware-independent
    env["JAX_PLATFORMS"] = "cpu"
    subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "make_synthetic.py"),
         "--out", tmp, "--genome-len", "30000", "--n-reads", "400",
         "--circ-frac", "0.25", "--seed", "777"],
        check=True, cwd=tmp, env=env, capture_output=True)
    subprocess.run(
        [sys.executable, "-m", "circminer_jax.cli", "--index",
         "-r", "ref.fa", "-k", "20"],
        check=True, cwd=tmp, env=env, capture_output=True)
    subprocess.run(
        [sys.executable, "-m", "circminer_jax.cli", "-r", "ref.fa",
         "-g", "ref.gtf", "-1", "R1.fq", "-2", "R2.fq", "-o", "out",
         "--pam", "--device", "native"],
        check=True, cwd=tmp, env=env, capture_output=True)
    return (os.path.join(tmp, "out.circ_report"),
            os.path.join(tmp, "out.mapping.pam"),
            os.path.join(tmp, "out.candidates.pam"))


FIXTURES = ["out.circ_report", "out.mapping.pam", "out.candidates.pam"]


def test_golden_outputs(tmp_path):
    paths = _run_pipeline(str(tmp_path))
    for got_path, name in zip(paths, FIXTURES):
        golden_path = os.path.join(GOLDEN, name)
        assert os.path.exists(golden_path), (
            f"golden fixture missing: {golden_path} — run "
            f"`python tests/test_golden.py --regen`")
        with open(got_path, "rb") as f:
            got = f.read()
        with open(golden_path, "rb") as f:
            want = f.read()
        if name == "out.mapping.pam":
            # mapping emission order is stream-dependent (finalized reads
            # print as they resolve, like the reference's threaded writer);
            # compare as a line set
            assert sorted(got.splitlines()) == sorted(want.splitlines()), \
                f"{name} drifted from golden"
        else:
            assert got == want, f"{name} drifted from golden"


if __name__ == "__main__":
    if "--regen" in sys.argv:
        import tempfile
        os.makedirs(GOLDEN, exist_ok=True)
        with tempfile.TemporaryDirectory() as tmp:
            paths = _run_pipeline(tmp)
            for got_path, name in zip(paths, FIXTURES):
                with open(got_path, "rb") as f:
                    data = f.read()
                with open(os.path.join(GOLDEN, name), "wb") as f:
                    f.write(data)
                print(f"regenerated {name} ({len(data)} bytes)")
    else:
        print(__doc__)
