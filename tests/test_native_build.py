"""Host C++ libraries are built from the committed sources at first use
(ops/native_build.py): content-keyed, race-free, loud on failure."""

import ctypes
import multiprocessing
import os

import numpy as np
import pytest

from circminer_jax.ops import native_build as nb


def test_builds_into_empty_dir_and_loads(tmp_path):
    out = str(tmp_path / "build")
    path = nb.build_library("align", ("align_kernels.cpp",), out_dir=out)
    assert os.path.dirname(path) == out and os.path.exists(path)
    assert path == nb.library_path("align", ("align_kernels.cpp",), out)
    lib = ctypes.CDLL(path)
    p, ci = ctypes.c_void_p, ctypes.c_int
    lib.one_side_banded.argtypes = [p, ci, p, ci, ci]
    lib.one_side_banded.restype = ctypes.c_int64
    s = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.int8)
    t = s.copy()
    t[3] = 0
    from circminer_jax.ops import align as al
    assert lib.one_side_banded(s.ctypes.data, len(s), t.ctypes.data, len(t),
                               3) == al.global_one_side_banded_alignment(
                                   s, t, 3)
    # a second call finds the build and compiles nothing
    mtime = os.path.getmtime(path)
    assert nb.build_library("align", ("align_kernels.cpp",), out) == path
    assert os.path.getmtime(path) == mtime


def _build(out_dir):
    return nb.build_library("align", ("align_kernels.cpp",), out_dir=out_dir)


def test_concurrent_builds_share_one_library(tmp_path):
    """More builders than cores race into one empty directory: all get the
    same complete library and no temporary file is left behind."""
    out = str(tmp_path / "build")
    n = 2 * (os.cpu_count() or 1) + 2
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(n, 12)) as pool:
        paths = pool.map_async(_build, [out] * n).get(timeout=300)
    assert len(set(paths)) == 1
    files = sorted(os.listdir(out))
    assert [f for f in files if f.endswith(".so")] == \
        [os.path.basename(paths[0])]
    assert not [f for f in files if f.startswith(".libalign-")]
    ctypes.CDLL(paths[0])


def test_failed_build_raises_with_compiler_stderr(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(nb, "NATIVE_DIR", str(src))
    with pytest.raises(nb.NativeBuildError, match="error"):
        nb.build_library("broken", ("broken.cpp",),
                         out_dir=str(tmp_path / "build"))
    assert not [f for f in os.listdir(tmp_path / "build")
                if f.endswith(".so")]
