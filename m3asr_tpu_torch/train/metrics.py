"""Rolling metric aggregation, the training logger and the scalar writers
(JSONL and TensorBoard event files, no TensorFlow): the port's own copy
of ``m3asr_tpu/train/metrics.py``, pure Python."""

from __future__ import annotations

import logging
import sys
import time
from typing import List, Sequence


class MetricStat:
    """Per-tag (sum, count) accumulators with a rolling log window."""

    def __init__(self, tags: Sequence[str]):
        self.tags = list(tags)
        n = len(self.tags)
        self.total_count = [0] * n
        self.total_sum = [0.0] * n
        self.log_count = [0] * n
        self.log_sum = [0.0] * n

    def update_stat(self, metrics: Sequence[float], counts: Sequence[int]):
        for i, (m, c) in enumerate(zip(metrics, counts)):
            self.log_sum[i] += float(m)
            self.log_count[i] += int(c)

    def log_stat(self) -> List[float]:
        """Average over the window since the last call; folds the window
        into the totals."""
        avg = []
        for i in range(len(self.tags)):
            c = self.log_count[i]
            avg.append(0.0 if c == 0 else self.log_sum[i] / c)
            self.total_sum[i] += self.log_sum[i]
            self.total_count[i] += c
            self.log_sum[i] = 0.0
            self.log_count[i] = 0
        return avg

    def summary_stat(self) -> List[float]:
        avg = []
        for i in range(len(self.tags)):
            self.total_sum[i] += self.log_sum[i]
            self.total_count[i] += self.log_count[i]
            self.log_sum[i] = 0.0
            self.log_count[i] = 0
            c = self.total_count[i]
            avg.append(0.0 if c == 0 else self.total_sum[i] / c)
        return avg

    def reset(self):
        n = len(self.tags)
        self.total_count = [0] * n
        self.total_sum = [0.0] * n
        self.log_count = [0] * n
        self.log_sum = [0.0] * n


def set_logger(name: str = "m3asr", log_file: str = None,
               level=logging.INFO) -> logging.Logger:
    """File + stderr logger (utils/logger.py set_logger)."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter(
        "%(asctime)s [%(levelname)s] %(message)s", "%Y-%m-%d %H:%M:%S")
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class ScalarWriter:
    """JSONL scalar logger — the framework's stand-in for the
    reference's TensorBoard scalars (bk/..._hier.py:190-193,622-623):
    one line per event {step, tag, value, wall_time}, trivially
    plottable and dependency-free."""

    def __init__(self, path: str):
        import os
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def add_scalar(self, tag: str, value: float, step: int):
        import json
        self._f.write(json.dumps({"step": int(step), "tag": tag,
                                  "value": float(value),
                                  "wall_time": time.time()}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


# ---------------------------------------------------------------------------
# TensorBoard event files (bk/..._hier.py:190-193,622-623 used
# tensorboardX). Dependency-free: a TB event file is TFRecord framing
# ([u64 len][crc(len)][Event proto][crc(data)]) of Event protobufs with
# {wall_time(1,double), step(2,int64), file_version(3,str) |
# summary(5) -> Value(1) -> {tag(1,str), simple_value(2,float)}}.
# ---------------------------------------------------------------------------

_CRC_TABLE = None


def _crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _tb_event(wall_time: float, step: int = 0, file_version: str = None,
              scalars=None) -> bytes:
    import struct
    msg = b"\x09" + struct.pack("<d", wall_time)          # wall_time=1
    if step:
        msg += b"\x10" + _varint(step)                    # step=2
    if file_version is not None:
        fv = file_version.encode()
        msg += b"\x1a" + _varint(len(fv)) + fv            # file_version=3
    if scalars:
        summ = b""
        for tag, value in scalars:
            t = tag.encode()
            val = (b"\x0a" + _varint(len(t)) + t          # Value.tag=1
                   + b"\x15" + struct.pack("<f", value))  # simple_value=2
            summ += b"\x0a" + _varint(len(val)) + val     # Summary.value=1
        msg += b"\x2a" + _varint(len(summ)) + summ        # summary=5
    return msg


class TensorBoardWriter:
    """Minimal TensorBoard scalar writer (event-file format), no TF/
    tensorboardX dependency. Files land as
    <logdir>/events.out.tfevents.<t>.<host> and open in TensorBoard."""

    def __init__(self, logdir: str):
        import os
        import socket
        os.makedirs(logdir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}." \
               f"{socket.gethostname()}"
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._write(_tb_event(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes):
        import struct
        header = struct.pack("<Q", len(payload))
        self._f.write(header + struct.pack("<I", _masked_crc(header))
                      + payload + struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        self._write(_tb_event(time.time(), int(step),
                              scalars=[(tag, float(value))]))

    def close(self):
        self._f.close()


def read_tb_scalars(path: str):
    """Parse scalar events back out of a TB event file (test/debug
    utility — also validates the record CRCs)."""
    import struct
    out = []
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        (n,) = struct.unpack_from("<Q", data, off)
        header = data[off:off + 8]
        (hcrc,) = struct.unpack_from("<I", data, off + 8)
        assert hcrc == _masked_crc(header), "corrupt length crc"
        payload = data[off + 12:off + 12 + n]
        (pcrc,) = struct.unpack_from("<I", data, off + 12 + n)
        assert pcrc == _masked_crc(payload), "corrupt data crc"
        off += 12 + n + 4
        # decode the few fields we emit
        pos, step, scalars = 0, 0, []
        while pos < len(payload):
            key = payload[pos]
            pos += 1
            if key == 0x09:
                pos += 8
            elif key == 0x10:
                step = 0
                shift = 0
                while True:
                    b = payload[pos]
                    pos += 1
                    step |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
            elif key in (0x1A, 0x2A):
                ln = 0
                shift = 0
                while True:
                    b = payload[pos]
                    pos += 1
                    ln |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                body = payload[pos:pos + ln]
                pos += ln
                if key == 0x2A:  # summary -> values
                    bpos = 0
                    while bpos < len(body):
                        assert body[bpos] == 0x0A
                        bpos += 1
                        vlen = 0
                        shift = 0
                        while True:
                            b = body[bpos]
                            bpos += 1
                            vlen |= (b & 0x7F) << shift
                            shift += 7
                            if not b & 0x80:
                                break
                        v = body[bpos:bpos + vlen]
                        bpos += vlen
                        assert v[0] == 0x0A
                        tlen = v[1]
                        tag = v[2:2 + tlen].decode()
                        assert v[2 + tlen] == 0x15
                        (val,) = struct.unpack_from("<f", v, 3 + tlen)
                        scalars.append((tag, val))
            else:
                raise ValueError(f"unexpected field key {key:#x}")
        for tag, val in scalars:
            out.append((step, tag, val))
    return out


class ThroughputMeter:
    """Frames/s throughput logging (bk/..._hier.py:617-632)."""

    def __init__(self):
        self.frames = 0
        self.t0 = time.perf_counter()

    def update(self, n_frames: int):
        self.frames += int(n_frames)

    def rate(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.frames / dt if dt > 0 else 0.0

    def reset(self):
        self.frames = 0
        self.t0 = time.perf_counter()
