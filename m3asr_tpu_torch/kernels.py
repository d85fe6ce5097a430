"""Build and load the port's hand-written CUDA kernels.

Each ``.cu`` source under ``csrc/`` (with the ``.cuh`` headers it
includes) is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, never at import, into ``m3asr_tpu_torch/_build/``
(listed in ``.gitignore``) under a name keyed by a hash of the source,
the headers and the flags, so an edited source or header rebuilds. A
file lock per source serialises concurrent builds of it; a failed build
raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels build on the card's host")
    return found


class KernelLibrary:
    """One ``csrc/`` source built into one shared library, lazily.

    ``build_seconds`` is the time of the build this process did, if it
    did one. ``log`` is nvcc's output (with ptxas register and spill
    counts) of the library's build, kept beside the library, so an earlier
    process's build has it too.
    """

    def __init__(self, source: str):
        self.source = source
        self.build_seconds: Optional[float] = None
        self.log = ""
        self.command: list = []
        self._lib: Optional[ctypes.CDLL] = None

    def _lib_path(self) -> str:
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        # the source and every shared header it may include
        for name in [self.source] + sorted(
                f for f in os.listdir(CSRC) if f.endswith(".cuh")):
            with open(os.path.join(CSRC, name), "rb") as f:
                digest.update(f.read())
        stem = os.path.splitext(self.source)[0]
        return os.path.join(BUILD_DIR,
                            f"lib{stem}_{digest.hexdigest()[:16]}.so")

    def build(self) -> str:
        """Compile the source unless a library for this exact source and
        these flags exists. Returns the library path."""
        path = self._lib_path()
        os.makedirs(BUILD_DIR, exist_ok=True)
        # one lock per source, so that different sources build at once
        stem = os.path.splitext(self.source)[0]
        with open(os.path.join(BUILD_DIR, f"{stem}.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if os.path.exists(path):
                    if os.path.exists(path + ".log"):
                        with open(path + ".log") as f:
                            self.log = f.read()
                    return path
                tmp = f"{path}.{os.getpid()}.tmp"
                self.command = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                                os.path.join(CSRC, self.source)]
                t0 = time.perf_counter()
                r = subprocess.run(self.command, capture_output=True,
                                   text=True)
                self.build_seconds = time.perf_counter() - t0
                self.log = r.stdout + r.stderr
                if r.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({r.returncode}) building "
                        f"{self.source}:\n{self.log}")
                with open(path + ".log", "w") as f:
                    f.write(self.log)
                os.replace(tmp, path)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
        return path

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(self.build())
            self._declare(lib)
            self._lib = lib
        return self._lib

    def _declare(self, lib: ctypes.CDLL) -> None:
        """Set argtypes/restype of every exported function."""
        vp, i = ctypes.c_void_p, ctypes.c_int
        if self.source == "moe_runs.cu":
            for name in ("moe_runs_tile_rows", "moe_runs_col_block",
                         "moe_runs_k_step", "moe_runs_f_col_block"):
                getattr(lib, name).argtypes = []
                getattr(lib, name).restype = i
            # dtype, x_pad, w1, b1, w2, b2, tile_e, starts, counts, n_tiles,
            # E, layer, d, h, hidden, y_pad, stream
            lib.moe_runs_f.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, vp, i,
                                       i, i, i, i, vp, vp, vp]
            lib.moe_runs_f.restype = i
            lib.moe_runs_q.argtypes = [i, i, vp, vp, vp, i, vp, vp, vp, i,
                                       vp, vp, vp, i, i, i, i, i, vp, vp,
                                       vp, vp, vp, vp, vp]
            lib.moe_runs_q.restype = i
            # the same after (act, clamp, upper): GEMM1's activation
            for name in ("moe_runs_f", "moe_runs_q"):
                self._declare_act(lib, name, [i, i, ctypes.c_float])
        elif self.source == "moe_q4.cu":
            for name in ("moe_q4_col_block", "moe_q4_k_step"):
                getattr(lib, name).argtypes = []
                getattr(lib, name).restype = i
            self._declare_front(lib, "moe_q4")
            # a8, x, gate, n_rows, w1, s1, g1, b1, w2, s2, g2, b2, E,
            # layer, d, h, front, hidden, xq, xs, hq, hs, out, stream
            lib.moe_q4_dense.argtypes = [i, vp, vp, i, vp, vp, i, vp, vp,
                                         vp, i, vp, i, i, i, i, vp, vp, vp,
                                         vp, vp, vp, vp, vp]
            lib.moe_q4_dense.restype = i
            self._declare_act(lib, "moe_q4_dense", [i, i, ctypes.c_float])
        elif self.source == "moe_q4_tiled.cu":
            for name in ("moe_q4_tiled_slice_rows", "moe_q4_tiled_col_block",
                         "moe_q4_tiled_k_step"):
                getattr(lib, name).argtypes = []
                getattr(lib, name).restype = i
            # dtype, a8, x_pad, w1, s1, g1, b1, w2, s2, g2, b2, tile_e,
            # starts, counts, tile, n_tiles, E, layer, d, h, clamp, upper,
            # hidden, xq, xs, hq, hs, y_pad, stream
            lib.moe_q4_tiled.argtypes = [i, i, vp, vp, vp, i, vp, vp, vp, i,
                                         vp, vp, vp, vp, i, i, i, i, i, i, i,
                                         ctypes.c_float, vp, vp, vp, vp, vp,
                                         vp, vp]
            lib.moe_q4_tiled.restype = i
            self._declare_act(lib, "moe_q4_tiled", [i])
        elif self.source == "moe_stream.cu":
            for name in ("moe_stream_col_block", "moe_stream_k_step"):
                getattr(lib, name).argtypes = []
                getattr(lib, name).restype = i
            self._declare_front(lib, "moe_stream")
            # dtype, quant, x, gate, n_rows, w1, s1, b1, w2, s2, b2, E, d,
            # h, front, hidden, out, stream
            lib.moe_stream.argtypes = [i, i, vp, vp, i, vp, vp, vp, vp, vp,
                                       vp, i, i, i, vp, vp, vp, vp]
            lib.moe_stream.restype = i
        elif self.source == "flash_attention.cu":
            f = ctypes.c_float
            # dtype, d2, dk, q2, k2, v, [g, lse, delta,] lens, lo, hi,
            # mem_cols, B, H, T, S, scale, rows, outputs..., stream
            head = [i, i, i, vp, vp, vp]
            tail = [vp, vp, vp, i, i, i, i, i, f, i]
            lib.flash_fwd.argtypes = head + tail + [vp, vp, vp]
            lib.flash_bwd_dq.argtypes = head + [vp, vp, vp] + tail + [vp, vp]
            lib.flash_bwd_dkv.argtypes = (head + [vp, vp, vp] + tail
                                          + [vp, vp, vp])
            for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                getattr(lib, name).restype = i
        else:
            raise ValueError(f"no C interface declared for {self.source}")

    @staticmethod
    def _declare_act(lib: ctypes.CDLL, name: str, head: list) -> None:
        """``name + "_act"``: ``head`` (the activation's arguments), then
        ``name``'s arguments. A library built from a source older than
        the activation entry points (``chip_compare.py``'s parent) has
        none, and gets none declared."""
        if hasattr(lib, name + "_act"):
            fn = getattr(lib, name + "_act")
            fn.argtypes = head + getattr(lib, name).argtypes
            fn.restype = ctypes.c_int

    @staticmethod
    def _declare_front(lib: ctypes.CDLL, prefix: str) -> None:
        """The row-tile front's size and launch (csrc/row_tiles.cuh),
        which each dense streamer's library exports under its prefix."""
        vp, i = ctypes.c_void_p, ctypes.c_int
        size = getattr(lib, f"{prefix}_front_ints")
        size.argtypes, size.restype = [i, i], i
        # gate, n_rows, E, front, stream
        run = getattr(lib, f"{prefix}_row_tiles")
        run.argtypes, run.restype = [vp, i, i, vp, vp], i


MOE_RUNS = KernelLibrary("moe_runs.cu")   # K1, K4, K5
MOE_Q4 = KernelLibrary("moe_q4.cu")       # K6
MOE_Q4_TILED = KernelLibrary("moe_q4_tiled.cu")  # K7
MOE_STREAM = KernelLibrary("moe_stream.cu")      # K8
FLASH = KernelLibrary("flash_attention.cu")  # K2, K3

ALL = (MOE_RUNS, MOE_Q4, MOE_Q4_TILED, MOE_STREAM, FLASH)
