"""chip_smoke.py refuses to run without a GPU: no CPU fallback, no result
line, non-zero exit."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("platform,allow_cpu,ok", [
    ("gpu", False, True),
    ("cpu", False, False),
    ("cpu", True, True),
])
def test_check_device(platform, allow_cpu, ok):
    if ok:
        chip_smoke.check_device(platform, allow_cpu=allow_cpu)
    else:
        with pytest.raises(SystemExit, match="no GPU"):
            chip_smoke.check_device(platform, allow_cpu=allow_cpu)


@pytest.mark.parametrize("alone", [False, True])
def test_refuses_cpu_backend(tmp_path, alone):
    """With only the CPU backend, in the checkout or copied alone into an
    empty directory, the script exits non-zero and prints no result."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, str(script)], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no GPU" in res.stderr
