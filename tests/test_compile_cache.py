"""enable_compilation_cache: JAX_COMPILATION_CACHE_DIR when set (and no
other directory), else one fixed directory inside the checkout."""

import os
import subprocess
import sys

import pytest

import circminer_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(tmp_path, env_set):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    if env_set:
        want = str(tmp_path / "xla")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    else:
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
        want = os.path.join(REPO, ".cache", "xla")
    # a fresh process: JAX reads the variable when it is first imported
    res = subprocess.run(
        [sys.executable, "-c", "import jax, circminer_jax; "
         "print(circminer_jax.enable_compilation_cache()); "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120, check=True)
    assert res.stdout.split() == [want, want]
    assert circminer_jax.CACHE_DIR == os.path.join(REPO, ".cache")
