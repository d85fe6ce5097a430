"""ctypes bindings for the native (C++) Kaldi ark reader (the port's copy
of ``m3asr_tpu/io/native_io.py``).

The library is built at first use from ``native/io/ark_reader.cpp`` into
``m3asr_tpu_torch/_build/`` by ``utils/native_build.py`` (g++), as
``decode/native.py`` builds the decoder. The native path covers the hot
format only, binary float32 matrices ("\\0BFM"), and raises
:class:`UnsupportedArk` for anything else, at which point
``kaldi_io.read_ark`` carries on with the pure-Python reader (which also
handles CompressedMatrix and text arks). When the library cannot be
built or loaded, :func:`available` is False, :func:`load_error` keeps
the reason, and ``kaldi_io.read_ark`` reads everything in Python.
"""

from __future__ import annotations

import ctypes
import logging
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from m3asr_tpu_torch.utils.native_build import ensure_built

SOURCE = os.path.join("native", "io", "ark_reader.cpp")

_lib = None
_load_failed = False
_load_error: Optional[str] = None

_OK, _END, _UNSUPPORTED, _CORRUPT = 1, 0, -1, -2


class UnsupportedArk(Exception):
    """Entry format the native reader does not parse."""


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed, _load_error
    if _lib is not None or _load_failed:
        return _lib
    try:
        lib = ctypes.CDLL(ensure_built(SOURCE))
        lib.ark_open.restype = ctypes.c_void_p
        lib.ark_open.argtypes = [ctypes.c_char_p]
        lib.ark_close.argtypes = [ctypes.c_void_p]
        lib.ark_next_header.restype = ctypes.c_int
        lib.ark_next_header.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.ark_read_data.restype = ctypes.c_int
        lib.ark_read_data.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_float)]
        lib.ark_skip.restype = ctypes.c_int
        lib.ark_skip.argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception as e:
        _load_failed = True
        _load_error = f"{type(e).__name__}: {e}"
        logging.getLogger("m3asr_tpu_torch").warning(
            "native ark reader unavailable (python fallback): %s",
            _load_error)
    return _lib


def available() -> bool:
    return _load() is not None


def load_error() -> Optional[str]:
    """Why the native library failed to load (None if loaded or not yet
    attempted)."""
    return _load_error


def read_ark(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Stream (key, float32 matrix) from a binary-BFM ark via the
    native reader. Raises UnsupportedArk on other entry formats."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native ark reader unavailable: {load_error()}")
    handle = lib.ark_open(path.encode())
    if not handle:
        raise FileNotFoundError(path)
    key_buf = ctypes.create_string_buffer(1024)
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    try:
        while True:
            rc = lib.ark_next_header(handle, key_buf, 1024,
                                     ctypes.byref(rows),
                                     ctypes.byref(cols))
            if rc == _END:
                return
            if rc == _UNSUPPORTED:
                raise UnsupportedArk(path)
            if rc != _OK:
                raise IOError(f"corrupt ark: {path}")
            mat = np.empty((rows.value, cols.value), np.float32)
            rc = lib.ark_read_data(
                handle, mat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if rc != _OK:
                raise IOError(f"corrupt ark data: {path}")
            yield key_buf.value.decode(), mat
    finally:
        lib.ark_close(handle)
