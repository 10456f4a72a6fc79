"""Builds the host C++ kernels (circminer_jax/native/*.cpp) at first use.

A library's file name carries a hash of its sources and of the compile
command, so an edited source builds a new library and a stale one is never
loaded.  A build holds an fcntl lock on its output directory and writes a
temporary file that ``os.replace`` moves into place, so concurrent
processes (test workers, coordinated hosts on one filesystem) never load a
half-written library.  A failed build raises with the compiler's stderr:
nothing falls back to a slower path.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
from typing import Optional, Sequence

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
BUILD_DIR = os.path.join(NATIVE_DIR, "build")
CXX = ("g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


class NativeBuildError(RuntimeError):
    pass


def library_path(name: str, sources: Sequence[str],
                 out_dir: Optional[str] = None) -> str:
    """Path of lib<name> for the current content of ``sources`` (file
    names under NATIVE_DIR; the first is compiled, the rest are the files
    it #includes)."""
    h = hashlib.sha256(" ".join(CXX).encode())
    for src in sources:
        with open(os.path.join(NATIVE_DIR, src), "rb") as f:
            h.update(src.encode() + b"\0" + f.read())
    return os.path.join(out_dir or BUILD_DIR,
                        f"lib{name}-{h.hexdigest()[:16]}.so")


def build_library(name: str, sources: Sequence[str],
                  out_dir: Optional[str] = None) -> str:
    """Compile lib<name> unless a build of the same sources exists;
    returns its path."""
    path = library_path(name, sources, out_dir)
    if os.path.exists(path):
        return path
    out_dir = os.path.dirname(path)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f".lib{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):      # another process built it meanwhile
            return path
        fd, tmp = tempfile.mkstemp(dir=out_dir, prefix=f".lib{name}-",
                                   suffix=".so")
        os.close(fd)
        try:
            cmd = [*CXX, os.path.join(NATIVE_DIR, sources[0]), "-o", tmp]
            try:
                res = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise NativeBuildError(
                    f"cannot run the C++ compiler for lib{name}: {e}") from e
            if res.returncode != 0:
                raise NativeBuildError(
                    f"building lib{name} failed ({' '.join(cmd)}):\n"
                    f"{res.stderr}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return path


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    return ctypes.CDLL(build_library(name, sources))
