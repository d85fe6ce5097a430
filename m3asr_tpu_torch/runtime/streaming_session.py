"""Host-side streaming session: raw-frame buffering around one stream's
chunk program (port of ``m3asr_tpu/runtime/streaming_session.py``,
conformer families).

Push feature pieces of any size; the session emits a chunk output
whenever a full window (4 * chunk + 3 raw frames, stride 4 * chunk) is
buffered, and ``finish()`` flushes the tail zero-padded. The chunk step
(``models/streaming.py``) is a :class:`~m3asr_tpu_torch.runtime.graphs.
GraphProgram` over static inputs (the window and the state tensors,
written in place by the step): a CUDA graph on ``cuda``, captured at the
session's first chunk with its own graph pool; eager on the CPU, with
``cuda_graphs=False``, and for a stage of ``ops/moe.HOST_SYNC_STAGES``.
Outputs are logits chunks (B, C, V), or with ``topk`` the per-frame
log-softmax top-K on the device (:func:`sparse_topk`), as numpy arrays.

The DFSMN sessions of the JAX package are not ported yet:
:class:`DfsmnStreamingSession` and :class:`DfsmnMoeStreamingSession`
raise ``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from m3asr_tpu_torch.config import EncoderConfig, MoEEncoderConfig
from m3asr_tpu_torch.models import streaming
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


def chunk_slice(out, start: int, end: int):
    """Slice the time axis of a dense or sparse chunk output."""
    if isinstance(out, tuple):
        return tuple(o[:, start:end] for o in out)
    return out[:, start:end]


def params_device_dtype(params):
    """The device and activation dtype of a parameter tree: those of its
    positional table."""
    pe = params["pos_enc"]["pe"]
    return pe.device, pe.dtype


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
                  dtype, device):
    """Zero state tensors of the chunk program, in its input order."""
    st = streaming.init_state(cfg, batch, cache_T, per_slot, dtype, device)
    tensors = st.tensors()
    if moe:
        tensors += streaming.init_state(cfg.embed_conf, batch, cache_T,
                                        per_slot, dtype, device).tensors()
    return tensors


def use_graph(device: torch.device, cuda_graphs: bool, moe: bool,
              moe_impl: str) -> bool:
    return (device.type == "cuda" and cuda_graphs
            and not (moe and moe_impl in HOST_SYNC_STAGES))


class StreamingSession:
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
        self.params = params
        self.cfg = cfg
        self.chunk = chunk_size
        self.left = num_left_chunks
        self.window = 4 * chunk_size + 3
        self.stride = 4 * chunk_size
        self.moe = moe
        self.moe_impl = moe_impl
        self.topk = topk
        self.cuda_graphs = cuda_graphs
        self._batch = batch
        self._cache_T = chunk_size * num_left_chunks
        self.device, self.dtype = params_device_dtype(params)
        self._staging = HostStaging(pin=self.device.type == "cuda")
        self._prog: Optional[GraphProgram] = None
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

    def _zero_state(self) -> None:
        with DEVICE_LOCK.shared(), torch.inference_mode():
            for t in self._prog.inputs[1:]:
                t.zero_()

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

    def _step(self, w: np.ndarray):
        prog = self._program(w.shape[-1])
        with DEVICE_LOCK.shared(), torch.inference_mode():
            hw, = self._staging.views("in", [(tuple(w.shape),
                                              torch.float32)])
            hw.numpy()[...] = w
            prog.inputs[0].copy_(hw, non_blocking=True)
            out = copy_to_host(self._staging, "out", prog.run(), self.device)
        return tuple(out) if self.topk else out[0]

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


class DfsmnStreamingSession:
    """The DFSMN family's stream session: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "DFSMN streaming sessions are not ported yet (ROADMAP Queue 1 "
            "item 10)")


class DfsmnMoeStreamingSession(DfsmnStreamingSession):
    """The MoE-DFSMN family's stream session: not ported yet."""
