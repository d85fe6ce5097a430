"""Host-side streaming sessions: raw-frame buffering around one stream's
chunk program (port of ``m3asr_tpu/runtime/streaming_session.py``).

* :class:`StreamingSession` (the conformer families): push feature
  pieces of any size; it emits a chunk output whenever a full window
  (4 * chunk + 3 raw frames, stride 4 * chunk) is buffered, and
  ``finish()`` flushes the tail zero-padded.
* :class:`DfsmnStreamingSession` and :class:`DfsmnMoeStreamingSession`
  (the DFSMN families, ``models/dfsmn_streaming.py``): no subsampling,
  so chunks are frame-aligned (stride == chunk). Output frame j of a
  stream is input frame j - ``delay`` (the FIR look-aheads, and the MoE
  net's input delay), so the first ``delay`` frames emitted are warm-up
  and dropped; ``finish()`` pushes ``delay`` zero frames to flush the
  matured tail.

The chunk step is a :class:`~m3asr_tpu_torch.runtime.graphs.
GraphProgram` over static inputs (the window or chunk and the state
tensors, written in place by the step): a CUDA graph on ``cuda``,
captured at the session's first chunk with its own graph pool; eager on
the CPU, with ``cuda_graphs=False``, and for a stage of
``ops/moe.HOST_SYNC_STAGES``. Outputs are logits chunks (B, C, V), or
with ``topk`` the per-frame log-softmax top-K on the device
(:func:`sparse_topk`), as numpy arrays. A float32 session on the card
turns TF32 off for cuBLAS and cuDNN, as the engine does.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from m3asr_tpu_torch.config import EncoderConfig, MoEEncoderConfig
from m3asr_tpu_torch.models import dfsmn_streaming, streaming
from m3asr_tpu_torch.models.dfsmn import check_moe_stage
from m3asr_tpu_torch.ops.moe import HOST_SYNC_STAGES
from m3asr_tpu_torch.runtime.graphs import (DEVICE_LOCK, GraphProgram,
                                            HostStaging, copy_to_host)


def sparse_topk(logits: torch.Tensor, k: int):
    """Per-frame log-softmax top-K, best first, on the logits' device:
    (values float32, ids int32) of (..., min(k, V)). Only these cross to
    the host, instead of (..., V) logits. Greedy partials read column 0;
    beam partials feed PrefixBeamState.advance_sparse."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    vals, idx = torch.topk(lp, min(k, logits.shape[-1]), dim=-1)
    return vals, idx.to(torch.int32)


def chunk_frames(out) -> int:
    """Time-axis length of a dense or sparse chunk output."""
    return (out[0] if isinstance(out, tuple) else out).shape[1]


def chunk_slice(out, start: int, end: int):
    """Slice the time axis of a dense or sparse chunk output."""
    if isinstance(out, tuple):
        return tuple(o[:, start:end] for o in out)
    return out[:, start:end]


def params_device_dtype(params):
    """The device and activation dtype of a parameter tree: those of its
    positional table (conformer trees), or of its output projection's
    kernel (DFSMN trees, which hold no table)."""
    if "pos_enc" in params:
        t = params["pos_enc"]["pe"]
    else:
        t = params["out_linear_sw" if "out_linear_sw" in params
                   else "out_linear"]["kernel"]
    return t.device, t.dtype


def full_float32(device: torch.device, dtype: torch.dtype) -> None:
    """A float32 stream on the card runs full float32: TF32 off for cuBLAS
    and cuDNN (whose convolutions default to TF32), as the engine turns
    it off."""
    if device.type == "cuda" and dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def chunk_step_fn(params, cfg, moe: bool, moe_impl: str, topk: int,
                  masked: bool):
    """The chunk program's function of its static inputs: (windows,
    [mask,] *state tensors) -> the output tuple. It writes the new state
    into the state tensors in place (only the mask's slots when
    ``masked``) and returns (logits,) or (values, ids) with ``topk``."""
    def step(windows, *rest):
        mask, st = (rest[0], rest[1:]) if masked else (None, rest)
        state = streaming.StreamState(*st[:3])
        if moe:
            e_state = streaming.StreamState(*st[3:])
            out, new, e_new = streaming.forward_chunk_moe(
                params, cfg, windows, state, e_state, moe_impl=moe_impl)
            streaming.write_state(e_state, e_new, mask)
        else:
            out, new = streaming.forward_chunk(params, cfg, windows, state)
        streaming.write_state(state, new, mask)
        return sparse_topk(out, topk) if topk else (out,)
    return step


def state_tensors(cfg, moe: bool, batch: int, cache_T: int, per_slot: bool,
                  dtype, device, params=None):
    """Zero state tensors of the chunk program, in its input order. With
    ``params`` the main blocks' K/V caches hold the heads those weights
    hold (``streaming.local_heads``: H/tp on a tp rank); the hier embed
    sub-encoder's, replicated, all of its own."""
    heads = None if params is None else streaming.local_heads(
        params["blocks"])
    st = streaming.init_state(cfg, batch, cache_T, per_slot, dtype, device,
                              heads)
    tensors = st.tensors()
    if moe:
        tensors += streaming.init_state(cfg.embed_conf, batch, cache_T,
                                        per_slot, dtype, device).tensors()
    return tensors


def use_graph(device: torch.device, cuda_graphs: bool, moe: bool,
              moe_impl: str) -> bool:
    return (device.type == "cuda" and cuda_graphs
            and not (moe and moe_impl in HOST_SYNC_STAGES))


class ChunkProgramSession:
    """What the conformer and DFSMN sessions share: the params' device
    and dtype, the host staging, and one chunk step through the chunk
    program (``_program``, built by the subclass at the first chunk) whose
    first static input is the chunk or window and whose other inputs are
    the state tensors."""

    def _init_program(self, params, batch: int, topk: int,
                      cuda_graphs: bool) -> None:
        self.params = params
        self.topk = topk
        self.cuda_graphs = cuda_graphs
        self._batch = batch
        self.device, self.dtype = params_device_dtype(params)
        full_float32(self.device, self.dtype)
        self._staging = HostStaging(pin=self.device.type == "cuda")
        self._prog: Optional[GraphProgram] = None

    def _zero_state(self) -> None:
        with DEVICE_LOCK.shared(), torch.inference_mode():
            for t in self._prog.inputs[1:]:
                t.zero_()

    def _step(self, w: np.ndarray):
        prog = self._program(w.shape[-1])
        with DEVICE_LOCK.shared(), torch.inference_mode():
            hw, = self._staging.views("in", [(tuple(w.shape),
                                              torch.float32)])
            hw.numpy()[...] = w
            prog.inputs[0].copy_(hw, non_blocking=True)
            out = copy_to_host(self._staging, "out", prog.run(), self.device)
        return tuple(out) if self.topk else out[0]


class StreamingSession(ChunkProgramSession):
    """One stream (or ``batch`` streams in lock-step) of a dense
    (``moe=False``) or hier MoE conformer encoder. ``params`` are on the
    device the session runs on, in its activation dtype (an engine's
    ``params``, or the stream copy ``serve`` makes of them)."""

    def __init__(self, params, cfg: EncoderConfig, chunk_size: int = 16,
                 num_left_chunks: int = 2, batch: int = 1,
                 moe: bool = False, moe_impl: str = "dense",
                 topk: int = 0, cuda_graphs: bool = True):
        if moe and not isinstance(cfg, MoEEncoderConfig):
            raise TypeError("moe=True needs a MoEEncoderConfig")
        streaming.check_stream_supported(cfg)
        self._init_program(params, batch, topk, cuda_graphs)
        self.cfg = cfg
        self.chunk = chunk_size
        self.left = num_left_chunks
        self.window = 4 * chunk_size + 3
        self.stride = 4 * chunk_size
        self.moe = moe
        self.moe_impl = moe_impl
        self._cache_T = chunk_size * num_left_chunks
        self._buf: Optional[np.ndarray] = None
        self._consumed = 0

    def _program(self, input_dim: int) -> GraphProgram:
        """The chunk program, built (on ``cuda``: captured) at the first
        chunk, when the feature width is known; its state starts at
        zero."""
        if self._prog is None:
            # the static inputs and the capture hold DEVICE_LOCK alone
            with DEVICE_LOCK.exclusive(), torch.inference_mode():
                window = torch.zeros((self._batch, self.window, input_dim),
                                     dtype=self.dtype, device=self.device)
                state = state_tensors(self.cfg, self.moe, self._batch,
                                      self._cache_T, False, self.dtype,
                                      self.device)
                pool = (torch.cuda.graph_pool_handle()
                        if use_graph(self.device, self.cuda_graphs,
                                     self.moe, self.moe_impl) else None)
                self._prog = GraphProgram(
                    chunk_step_fn(self.params, self.cfg, self.moe,
                                  self.moe_impl, self.topk, masked=False),
                    (window,) + state, pool)
                self._zero_state()      # the warm-up runs advanced it
        return self._prog

    def push(self, feat: np.ndarray) -> List:
        """feat: (B, t, input_dim) new frames. Returns the chunk outputs
        that became ready: (B, chunk, V) logits, or (values, ids) of
        (B, chunk, K) with ``topk``."""
        feat = np.asarray(feat, np.float32)
        self._buf = feat if self._buf is None else np.concatenate(
            [self._buf, feat], axis=1)
        outs = []
        while self._buf.shape[1] - self._consumed >= self.window:
            w = self._buf[:, self._consumed: self._consumed + self.window]
            outs.append(self._step(w))
            self._consumed += self.stride
        if self._consumed > 0:  # bound memory on long-lived streams
            self._buf = self._buf[:, self._consumed:]
            self._consumed = 0
        return outs

    def reset(self) -> None:
        """Back to a fresh stream, keeping the chunk program (pooled
        sessions capture once)."""
        if self._prog is not None:
            self._zero_state()
        self._buf = None
        self._consumed = 0

    def clone(self) -> "StreamingSession":
        """A fresh-stream session with this one's params and settings; it
        builds its own chunk program (its own state) at its first
        chunk."""
        return StreamingSession(self.params, self.cfg, self.chunk, self.left,
                                self._batch, self.moe, self.moe_impl,
                                self.topk, self.cuda_graphs)

    def finish(self) -> List:
        """Flush the remaining frames (zero-padded to a full window); emits
        only the output frames covered by real input."""
        if self._buf is None:
            return []
        rest = self._buf.shape[1] - self._consumed
        n_out = (rest - 3) // 4 if rest >= 7 else 0
        if n_out <= 0:   # fewer raw frames than one output frame needs
            return []
        w = np.zeros((self._buf.shape[0], self.window,
                      self._buf.shape[2]), np.float32)
        w[:, :rest] = self._buf[:, self._consumed:]
        return [chunk_slice(self._step(w), 0, n_out)]


def dfsmn_state(cfg, moe: bool, batch: int, cache_T: int, chunk_size: int,
                input_dim: int, per_slot: bool, dtype, device):
    """Zero state of a DFSMN chunk program (``models/dfsmn_streaming``);
    the MoE state's input delay buffer is sized by ``input_dim``."""
    if moe:
        return dfsmn_streaming.init_moe_state(cfg, batch, cache_T,
                                              chunk_size, input_dim,
                                              per_slot, dtype, device)
    return dfsmn_streaming.init_state(cfg, batch, cache_T, per_slot, dtype,
                                      device)


def dfsmn_step_fn(params, cfg, moe: bool, moe_impl: str, topk: int,
                  masked: bool, template):
    """The DFSMN chunk program's function of its static inputs: (chunk,
    [mask,] *state tensors of ``template``'s structure) -> the output
    tuple, writing the new state into the state tensors in place (only
    the mask's slots when ``masked``)."""
    def step(chunk, *rest):
        mask, st = (rest[0], rest[1:]) if masked else (None, rest)
        state = dfsmn_streaming.state_like(template, st)
        if moe:
            out, new = dfsmn_streaming.forward_chunk_moe(
                params, cfg, chunk, state, moe_impl=moe_impl)
        else:
            out, new = dfsmn_streaming.forward_chunk(params, cfg, chunk,
                                                     state)
        dfsmn_streaming.write_state(state, new, mask)
        return sparse_topk(out, topk) if topk else (out,)
    return step


class DfsmnStreamingSession(ChunkProgramSession):
    """One stream (or ``batch`` streams in lock-step) of a dfsmn_san net
    (``models/registry.dfsmn_stream_config``). ``params`` are on the
    device the session runs on, in its activation dtype. The chunk
    program is built (on ``cuda``: captured) at the first chunk, when the
    feature width is known; ``reset()`` keeps it. Its chunks are
    frame-aligned (stride == chunk), not the conformer's windows."""

    moe = False

    def __init__(self, params, cfg, chunk_size: int = 16, batch: int = 1,
                 cache_T: int = 256, topk: int = 0,
                 cuda_graphs: bool = True):
        self._setup(params, cfg, chunk_size, batch, cache_T, "dense", topk,
                    cuda_graphs)

    def _setup(self, params, cfg, chunk_size, batch, cache_T, moe_impl,
               topk, cuda_graphs):
        if self.moe:
            check_moe_stage(moe_impl)
            self.delay = dfsmn_streaming.moe_stream_delay(cfg, chunk_size)
        else:
            self.delay = dfsmn_streaming.stream_delay(cfg)
        self._init_program(params, batch, topk, cuda_graphs)
        self.cfg = cfg
        self.chunk = chunk_size
        self.moe_impl = moe_impl
        self._cache_T = cache_T
        self._buf: Optional[np.ndarray] = None
        self._consumed = 0         # buffer-relative frames consumed
        self._fed = 0              # frames fed to the model
        self._next_pos = 0         # the next matured input position

    def _program(self, input_dim: int) -> GraphProgram:
        if self._prog is None:
            with DEVICE_LOCK.exclusive(), torch.inference_mode():
                chunk = torch.zeros((self._batch, self.chunk, input_dim),
                                    dtype=self.dtype, device=self.device)
                state = dfsmn_state(self.cfg, self.moe, self._batch,
                                    self._cache_T, self.chunk, input_dim,
                                    False, self.dtype, self.device)
                pool = (torch.cuda.graph_pool_handle()
                        if use_graph(self.device, self.cuda_graphs,
                                     self.moe, self.moe_impl) else None)
                self._prog = GraphProgram(
                    dfsmn_step_fn(self.params, self.cfg, self.moe,
                                  self.moe_impl, self.topk, False, state),
                    (chunk,) + dfsmn_streaming.state_tensors(state), pool)
                self._zero_state()      # the warm-up runs advanced it
        return self._prog

    def _run(self, c: np.ndarray, real_limit: Optional[int]):
        """One chunk, then the maturity bookkeeping: the output frames of
        input positions not emitted yet, and below ``real_limit``."""
        out = self._step(c)
        self._fed += c.shape[1]
        C = chunk_frames(out)
        first_pos = self._fed - C - self.delay       # position of out[0]
        start = max(0, self._next_pos - first_pos)
        end = C if real_limit is None else min(C, real_limit - first_pos)
        if end <= start:
            return None
        self._next_pos = first_pos + end
        return chunk_slice(out, start, end)

    def push(self, feat: np.ndarray) -> List:
        """feat: (B, t, input_dim). Returns the matured output pieces."""
        feat = np.asarray(feat, np.float32)
        self._buf = feat if self._buf is None else np.concatenate(
            [self._buf, feat], axis=1)
        outs = []
        while self._buf.shape[1] - self._consumed >= self.chunk:
            c = self._buf[:, self._consumed: self._consumed + self.chunk]
            self._consumed += self.chunk
            o = self._run(c, None)
            if o is not None:
                outs.append(o)
        if self._consumed > 0:  # bound memory on long-lived streams
            self._buf = self._buf[:, self._consumed:]
            self._consumed = 0
        return outs

    def reset(self) -> None:
        """A fresh stream, keeping the chunk program (pooled sessions
        capture once)."""
        if self._prog is not None:
            self._zero_state()
        self._buf = None
        self._consumed = 0
        self._fed = 0
        self._next_pos = 0

    def clone(self):
        """A fresh-stream session with this one's params and settings; it
        builds its own chunk program at its first chunk."""
        s = object.__new__(type(self))
        s._setup(self.params, self.cfg, self.chunk, self._batch,
                 self._cache_T, self.moe_impl, self.topk, self.cuda_graphs)
        return s

    def finish(self) -> List:
        """Zero-pad the tail and ``delay`` frames more so that every real
        frame matures; emits only frames covered by real input."""
        if self._buf is None:
            return []
        rest = self._buf.shape[1] - self._consumed
        total = self._fed + rest           # the stream's length
        need = rest + self.delay
        pad = (-need) % self.chunk
        tail = np.zeros((self._buf.shape[0], need + pad,
                         self._buf.shape[2]), np.float32)
        if rest:
            tail[:, :rest] = self._buf[:, self._consumed:]
        outs = []
        for off in range(0, tail.shape[1], self.chunk):
            o = self._run(tail[:, off:off + self.chunk], total)
            if o is not None:
                outs.append(o)
        return outs


class DfsmnMoeStreamingSession(DfsmnStreamingSession):
    """A stream of the MoE-DFSMN net
    (``dfsmn_streaming.forward_chunk_moe``): the embed sub-stream, its
    router-alignment ring and the main path's input delay live in the
    chunk program's state, sized at the first chunk (the input width
    sizes the delay buffer); this session adds the total delay to the
    plain session's bookkeeping. ``moe_impl`` is a stage of the
    DFSMN-MoE table (``runs_f``: K1; ``quant4_pallas``: K6; ...)."""

    moe = True

    def __init__(self, params, cfg, chunk_size: int = 16, batch: int = 1,
                 cache_T: int = 256, moe_impl: str = "dense", topk: int = 0,
                 cuda_graphs: bool = True):
        self._setup(params, cfg, chunk_size, batch, cache_T, moe_impl, topk,
                    cuda_graphs)
