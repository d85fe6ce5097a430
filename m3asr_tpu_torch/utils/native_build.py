"""Race-safe on-demand build of the port's native (C++) host libraries.

The port builds its own shared library from a C++ source of the repo's
``native/`` directory into ``m3asr_tpu_torch/_build/`` (git-ignored), so
it never shares a build directory with another package's ``make``. The
library's name is keyed by a hash of the source and the flags: an edited
source builds anew, and a stale library is never loaded. An exclusive
``flock`` per library serialises concurrent first uses (pytest-xdist
workers, server threads); the losers find the library built. The build
runs at first use, never at import.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(_PKG)
BUILD_DIR = os.path.join(_PKG, "_build")
# no -march=native: a checkout copied to another host must not load a
# library built for this one's instruction set
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")


def lib_path(source: str) -> str:
    """The library built from ``source`` (a path under the repo) with
    :data:`CXX_FLAGS`."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(os.path.join(REPO, source), "rb") as f:
        digest.update(f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def ensure_built(source: str) -> str:
    """Build ``source`` with ``g++`` (``$CXX``) unless its library exists.
    Returns the library path; raises RuntimeError with the compiler's
    output on failure."""
    path = lib_path(source)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = os.path.splitext(os.path.basename(source))[0]
    with open(os.path.join(BUILD_DIR, f"{stem}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(path):
                return path
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp,
                   os.path.join(REPO, source)]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(
                    f"{cmd[0]} failed ({r.returncode}) building {source}: "
                    f"{(r.stderr or r.stdout).strip()[-500:]}")
            os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path
