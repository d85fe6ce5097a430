"""Kaldi ark/scp IO (pure python, no Kaldi dependency).

Replaces the reference's vendored loader/kaldi_io.py + the pykaldi
SequentialMatrixReader usage in the loaders. Implements the subset the
stack needs: binary/text float matrices (FM/DM), int vectors, ark
streaming, scp indirection, and writers that emit ark(+scp).

Format notes (Kaldi archive): each record is
    <key> ' ' [\\0B] <payload>
where \\0B marks binary mode. A binary float matrix is
    'FM ' \\4 <rows> \\4 <cols> <rows*cols float32 little-endian>
('DM' = float64). A binary int vector is
    '\\4 <n> (\\4 <int32>)*n'.

The port's numpy copy of ``m3asr_tpu/io/kaldi_io.py``.
"""

from __future__ import annotations

import io
import struct
from typing import IO, Iterator, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# low-level readers
# ---------------------------------------------------------------------------

def _read_key(f: IO[bytes]) -> Optional[str]:
    chars = []
    while True:
        c = f.read(1)
        if not c:
            return None
        if c == b" ":
            break
        chars.append(c)
    key = b"".join(chars).decode()
    return key if key else None


def _expect(f: IO[bytes], token: bytes):
    got = f.read(len(token))
    if got != token:
        raise ValueError(f"expected {token!r}, got {got!r}")


def _read_int32(f: IO[bytes]) -> int:
    size = f.read(1)
    assert size == b"\x04", size
    return struct.unpack("<i", f.read(4))[0]


def _read_binary_matrix(f: IO[bytes]) -> np.ndarray:
    token = f.read(3)
    if token == b"CM ":
        return _read_compressed_matrix(f)
    assert token in (b"FM ", b"DM "), token
    rows = _read_int32(f)
    cols = _read_int32(f)
    dtype = np.float32 if token == b"FM " else np.float64
    data = np.frombuffer(f.read(rows * cols * dtype().itemsize), dtype)
    return data.reshape(rows, cols).astype(np.float32)


def _read_compressed_matrix(f: IO[bytes]) -> np.ndarray:
    """Kaldi CompressedMatrix format 1 (per-column 4-point quantized
    uint8 with uint16 percentile headers)."""
    min_value, rnge = struct.unpack("<ff", f.read(8))
    rows, cols = struct.unpack("<ii", f.read(8))
    # per-column header: 4 uint16 (p0, p25, p75, p100)
    headers = np.frombuffer(f.read(8 * cols), np.uint16).reshape(cols, 4)
    data = np.frombuffer(f.read(rows * cols), np.uint8).reshape(cols, rows)

    def u16_to_f(u):
        return min_value + rnge * (u.astype(np.float64) / 65535.0)

    p = u16_to_f(headers)  # (cols, 4)
    out = np.zeros((cols, rows), np.float64)
    c = data.astype(np.float64)
    m0 = data < 64
    m1 = (data >= 64) & (data < 192)
    m2 = data >= 192
    p0, p25, p75, p100 = (p[:, i:i + 1] for i in range(4))
    out = np.where(m0, p0 + (p25 - p0) * (c / 64.0), out)
    out = np.where(m1, p25 + (p75 - p25) * ((c - 64.0) / 128.0), out)
    out = np.where(m2, p75 + (p100 - p75) * ((c - 192.0) / 63.0), out)
    return out.T.astype(np.float32)


def _read_text_matrix(f: IO[bytes]) -> np.ndarray:
    rows = []
    cur: list = []
    started = False
    while True:
        line = f.readline()
        if not line:
            break
        txt = line.decode().strip()
        if "[" in txt:
            started = True
            txt = txt.split("[", 1)[1]
        end = "]" in txt
        if end:
            txt = txt.replace("]", "")
        if txt.strip():
            cur = [float(x) for x in txt.split()]
            rows.append(cur)
        if started and end:
            break
    return np.asarray(rows, np.float32)


def read_mat(f: IO[bytes]) -> np.ndarray:
    """Read one matrix at the current position (after the key)."""
    binary = f.read(2)
    if binary == b"\x00B":
        return _read_binary_matrix(f)
    # text: push back what we consumed
    rest = binary + f.readline()
    buf = io.BytesIO(rest)
    stream = _ConcatStream(buf, f)
    return _read_text_matrix(stream)


class _ConcatStream:
    def __init__(self, first: IO[bytes], second: IO[bytes]):
        self.first, self.second = first, second

    def readline(self):
        line = self.first.readline()
        return line if line else self.second.readline()


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def read_ark_py(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Pure-python ark reader (all formats incl. CompressedMatrix)."""
    with open(path, "rb") as f:
        while True:
            key = _read_key(f)
            if key is None:
                return
            yield key, read_mat(f)


def read_ark(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Stream (key, matrix) pairs from a Kaldi ark file. Binary float32
    arks go through the native C++ reader (native/io/ark_reader.cpp);
    other formats fall back to the python parser."""
    from m3asr_tpu_torch.io import native_io
    done = 0
    if native_io.available():
        try:
            for kv in native_io.read_ark(path):
                done += 1
                yield kv
            return
        except native_io.UnsupportedArk:
            pass  # mixed-format ark: python re-read, skipping what we
            # already emitted (entries stream in file order)
    it = read_ark_py(path)
    for _ in range(done):
        next(it)
    yield from it


def read_scp(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Stream (key, matrix) via an scp index 'key path:offset'."""
    with open(path) as f:
        for line in f:
            key, rx = line.strip().split(None, 1)
            ark_path, _, offset = rx.rpartition(":")
            with open(ark_path, "rb") as a:
                a.seek(int(offset))
                yield key, read_mat(a)


def read_kaldi_matrix(path: str) -> np.ndarray:
    """Read a standalone Kaldi matrix file (e.g. CMVN stats), binary or
    text."""
    with open(path, "rb") as f:
        return read_mat(f)


def read_int_vector_ark(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Stream (key, int32 vector) pairs (alignment/label archives)."""
    with open(path, "rb") as f:
        while True:
            key = _read_key(f)
            if key is None:
                return
            first = f.read(1)
            if first == b"\x00":
                assert f.read(1) == b"B", "malformed binary marker"
                n = _read_int32(f)
                vec = np.empty(n, np.int32)
                for i in range(n):
                    vec[i] = _read_int32(f)
                yield key, vec
            elif first == b"\n" or first == b"":
                # empty transcript ("utt0 \n")
                yield key, np.zeros((0,), np.int32)
            else:
                line = first + f.readline().rstrip(b"\n")
                rest = line.decode().split()
                yield key, np.asarray([int(x) for x in rest], np.int32)


class ArkWriter:
    """Write binary float32 matrices to ark (+ optional scp index)."""

    def __init__(self, ark_path: str, scp_path: Optional[str] = None):
        self.ark = open(ark_path, "wb")
        self.ark_path = ark_path
        self.scp = open(scp_path, "w") if scp_path else None

    def write(self, key: str, mat: np.ndarray):
        mat = np.ascontiguousarray(mat, np.float32)
        self.ark.write(key.encode() + b" ")
        offset = self.ark.tell()
        self.ark.write(b"\x00BFM ")
        self.ark.write(b"\x04" + struct.pack("<i", mat.shape[0]))
        self.ark.write(b"\x04" + struct.pack("<i", mat.shape[1]))
        self.ark.write(mat.tobytes())
        if self.scp:
            self.scp.write(f"{key} {self.ark_path}:{offset}\n")

    def close(self):
        self.ark.close()
        if self.scp:
            self.scp.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
