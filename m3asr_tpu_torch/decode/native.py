"""ctypes bindings for the native (C++) decoder core (the port's copy of
``m3asr_tpu/decode/native.py``).

The library is built at first use from ``native/ctc_decoder/
ctc_prefix_beam.cpp`` into ``m3asr_tpu_torch/_build/`` by
``utils/native_build.py`` (g++). When it cannot be built or loaded, every
search here falls back to its Python twin in ``decode/ctc.py`` (the same
contract), logs why once, and :func:`load_error` keeps the reason;
:func:`available` says which one runs. The JAX module's batched
searches (thread pools over these, for ``recognize.py``) come with the
recognize flows (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import ctypes
import logging
import os
import weakref
from typing import List, Optional, Tuple

import numpy as np

from m3asr_tpu_torch.decode import ctc as py
from m3asr_tpu_torch.utils.native_build import ensure_built

SOURCE = os.path.join("native", "ctc_decoder", "ctc_prefix_beam.cpp")

_lib = None
_load_failed = False
_load_error: Optional[str] = None


def _load() -> Optional[ctypes.CDLL]:
    """Build (once) and dlopen the library. A failure is recorded in
    :func:`load_error` and logged once."""
    global _lib, _load_failed, _load_error
    if _lib is not None or _load_failed:
        return _lib
    try:
        lib = ctypes.CDLL(ensure_built(SOURCE))
        lib.ctc_prefix_beam_search.restype = ctypes.c_int
        lib.ctc_prefix_beam_search.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float)]
        lib.ctc_greedy_decode.restype = ctypes.c_int
        lib.ctc_greedy_decode.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
        lib.ctc_prefix_beam_search_ext.restype = ctypes.c_int
        lib.ctc_prefix_beam_search_ext.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
        lib.ctc_prefix_beam_search_sparse_ext.restype = ctypes.c_int
        lib.ctc_prefix_beam_search_sparse_ext.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
        lib.beam_state_advance_sparse.restype = None
        lib.beam_state_advance_sparse.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int]
        lib.ngram_lm_create.restype = ctypes.c_void_p
        lib.ngram_lm_create.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.ngram_lm_free.restype = None
        lib.ngram_lm_free.argtypes = [ctypes.c_void_p]
        lib.ngram_lm_logp.restype = ctypes.c_float
        lib.ngram_lm_logp.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.c_int32]
        lib.beam_state_create.restype = ctypes.c_void_p
        lib.beam_state_create.argtypes = [
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_float]
        lib.beam_state_free.restype = None
        lib.beam_state_free.argtypes = [ctypes.c_void_p]
        lib.beam_state_reset.restype = None
        lib.beam_state_reset.argtypes = [ctypes.c_void_p]
        lib.beam_state_advance.restype = None
        lib.beam_state_advance.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int]
        lib.beam_state_nbest.restype = ctypes.c_int
        lib.beam_state_nbest.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
    except Exception as e:
        _load_failed = True
        _load_error = f"{type(e).__name__}: {e}"
        logging.getLogger("m3asr_tpu_torch").warning(
            "native decoder unavailable (falling back to python): %s",
            _load_error)
    return _lib


def available() -> bool:
    return _load() is not None


def load_error() -> Optional[str]:
    """Why the native library failed to load (None if loaded or not yet
    attempted)."""
    return _load_error


def ctc_prefix_beam_search(log_probs: np.ndarray, out_len: int,
                           beam_size: int, blank_idx: int = 0
                           ) -> List[Tuple[Tuple[int, ...], float]]:
    """Native prefix beam search; same contract as
    ``decode/ctc.py``'s ctc_prefix_beam_search."""
    lib = _load()
    if lib is None:
        return py.ctc_prefix_beam_search(log_probs, out_len, beam_size,
                                         blank_idx)
    lp = np.ascontiguousarray(log_probs[:int(out_len)], np.float32)
    T, V = lp.shape
    max_len = max(T, 1)
    tokens = np.full((beam_size, max_len), -1, np.int32)
    lens = np.zeros((beam_size,), np.int32)
    scores = np.zeros((beam_size,), np.float32)
    n = lib.ctc_prefix_beam_search(
        lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), T, V,
        beam_size, blank_idx, beam_size, max_len,
        tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return [(tuple(int(t) for t in tokens[i, :lens[i]]), float(scores[i]))
            for i in range(n)]


def _lm_handle(lib, lm) -> int:
    """Build (once) and cache the native n-gram table handle on the
    NgramLM instance; freed when the LM object is collected. The handle
    is read-only at decode time, so batch-decode threads share it."""
    h = getattr(lm, "_native_handle", None)
    if h is not None:
        return h
    ids, offsets, logps, backoffs = lm.to_arrays()
    ids = np.ascontiguousarray(ids, np.int32)
    offsets = np.ascontiguousarray(offsets, np.int32)
    logps = np.ascontiguousarray(logps, np.float32)
    backoffs = np.ascontiguousarray(backoffs, np.float32)
    h = lib.ngram_lm_create(
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(logps),
        logps.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        backoffs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lm.order)
    lm._native_handle = h
    weakref.finalize(lm, lib.ngram_lm_free, h)
    return h


def _trie_arrays(context):
    """Re-flatten a ContextTrie into phrase arrays (DFS over end nodes)
    so the C++ side rebuilds an identical trie."""
    if context is None or len(context.children) <= 1:
        return np.zeros(1, np.int32), np.zeros(2, np.int32), 0, 0.0
    phrases = []
    stack = [(0, [])]
    while stack:
        node, path = stack.pop()
        if context.is_end[node]:
            phrases.append(path)
        for tok, child in context.children[node].items():
            stack.append((child, path + [int(tok)]))
    toks = np.array([t for ph in phrases for t in ph], np.int32)
    offs = np.cumsum([0] + [len(ph) for ph in phrases]).astype(np.int32)
    return toks, offs, len(phrases), context.bonus


class NativeBeamState:
    """The C++ chunk-incremental extended prefix beam, with the interface
    of ``decode/ctc.py``'s PrefixBeamState (advance, advance_sparse,
    nbest) plus reset(), for streaming serving. Keeps the LM object
    referenced so that its native handle outlives the state."""

    def __init__(self, beam_size: int, blank_idx: int = 0, context=None,
                 lm=None, lm_weight: float = 0.5):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native lib unavailable: {load_error()}")
        self._lib = lib
        self._lm = lm  # keep alive (borrowed by the C++ state)
        toks, offs, n_ctx, bonus = _trie_arrays(context)
        lm_h = _lm_handle(lib, lm) if lm is not None else None
        self._h = lib.beam_state_create(
            beam_size, blank_idx,
            toks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n_ctx, ctypes.c_float(bonus), lm_h, ctypes.c_float(lm_weight))
        self.beam_size = beam_size
        self.t = 0
        self._finalizer = weakref.finalize(self, lib.beam_state_free,
                                           self._h)

    def reset(self) -> None:
        self._lib.beam_state_reset(self._h)
        self.t = 0

    def advance(self, log_probs: np.ndarray) -> None:
        lp = np.ascontiguousarray(log_probs, np.float32)
        if lp.ndim != 2:
            raise ValueError("advance takes (T, V) log-probs")
        T, V = lp.shape
        self._lib.beam_state_advance(
            self._h, lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            T, V)
        self.t += T

    def advance_sparse(self, values: np.ndarray,
                       indices: np.ndarray) -> None:
        """(T, K) top-K values and token ids per frame (the engine's
        decode_output "topk"), as PrefixBeamState.advance_sparse."""
        vals = np.ascontiguousarray(values, np.float32)
        idx = np.ascontiguousarray(indices, np.int32)
        if vals.ndim != 2 or vals.shape != idx.shape:
            raise ValueError("advance_sparse takes matching (T, K) "
                             "values/indices")
        T, K = vals.shape
        self._lib.beam_state_advance_sparse(
            self._h, vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), T, K)
        self.t += T

    def nbest(self):
        max_len = max(self.t, 1)
        tokens = np.full((self.beam_size, max_len), -1, np.int32)
        times = np.full((self.beam_size, max_len), -1, np.int32)
        lens = np.zeros((self.beam_size,), np.int32)
        scores = np.zeros((self.beam_size,), np.float32)
        n = self._lib.beam_state_nbest(
            self._h, self.beam_size, max_len,
            tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            times.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return [py.Hyp(tuple(int(x) for x in tokens[i, :lens[i]]),
                       float(scores[i]),
                       tuple(int(x) for x in times[i, :lens[i]]))
                for i in range(n)]


def make_beam_state(beam_size: int, blank_idx: int = 0, context=None,
                    lm=None, lm_weight: float = 0.5):
    """Streaming beam state: the C++ core when available, else the
    python PrefixBeamState (identical contract)."""
    if available():
        return NativeBeamState(beam_size, blank_idx, context, lm,
                               lm_weight)
    return py.PrefixBeamState(beam_size, blank_idx, context, lm, lm_weight)


def ctc_prefix_beam_search_ext(log_probs: np.ndarray, out_len: int,
                               beam_size: int, blank_idx: int = 0,
                               context=None, lm=None,
                               lm_weight: float = 0.5):
    """Native extended prefix beam search (per-token emission frames +
    optional ContextTrie biasing + optional NgramLM shallow fusion);
    the contract of ``decode/ctc.py``'s ctc_prefix_beam_search_ext:
    returns a list of Hyp(tokens, score, times)."""
    lib = _load()
    if lib is None:
        return py.ctc_prefix_beam_search_ext(log_probs, out_len, beam_size,
                                             blank_idx, context, lm=lm,
                                             lm_weight=lm_weight)
    lp = np.ascontiguousarray(log_probs[:int(out_len)], np.float32)
    T, V = lp.shape
    max_len = max(T, 1)
    toks, offs, n_ctx, bonus = _trie_arrays(context)
    tokens = np.full((beam_size, max_len), -1, np.int32)
    times = np.full((beam_size, max_len), -1, np.int32)
    lens = np.zeros((beam_size,), np.int32)
    scores = np.zeros((beam_size,), np.float32)
    lm_h = _lm_handle(lib, lm) if lm is not None else None
    n = lib.ctc_prefix_beam_search_ext(
        lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), T, V,
        beam_size, blank_idx, beam_size, max_len,
        toks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_ctx, ctypes.c_float(bonus), lm_h, ctypes.c_float(lm_weight),
        tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        times.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return [py.Hyp(tuple(int(t) for t in tokens[i, :lens[i]]),
                   float(scores[i]),
                   tuple(int(t) for t in times[i, :lens[i]]))
            for i in range(n)]


def ctc_prefix_beam_search_sparse_ext(values: np.ndarray,
                                      indices: np.ndarray, out_len: int,
                                      beam_size: int, blank_idx: int = 0,
                                      context=None, lm=None,
                                      lm_weight: float = 0.5):
    """Native extended prefix beam over the engine's (T, K) on-device
    top-K decode output (decode_output "topk"); same contract as
    ``decode/ctc.py``'s ctc_prefix_beam_search_sparse_ext."""
    lib = _load()
    if lib is None:
        return py.ctc_prefix_beam_search_sparse_ext(
            values, indices, out_len, beam_size, blank_idx, context, lm=lm,
            lm_weight=lm_weight)
    T = int(out_len)
    vals = np.ascontiguousarray(values[:T], np.float32)
    idx = np.ascontiguousarray(indices[:T], np.int32)
    K = vals.shape[1]
    max_len = max(T, 1)
    toks, offs, n_ctx, bonus = _trie_arrays(context)
    tokens = np.full((beam_size, max_len), -1, np.int32)
    times = np.full((beam_size, max_len), -1, np.int32)
    lens = np.zeros((beam_size,), np.int32)
    scores = np.zeros((beam_size,), np.float32)
    lm_h = _lm_handle(lib, lm) if lm is not None else None
    n = lib.ctc_prefix_beam_search_sparse_ext(
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), T, K,
        beam_size, blank_idx, beam_size, max_len,
        toks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_ctx, ctypes.c_float(bonus), lm_h, ctypes.c_float(lm_weight),
        tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        times.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return [py.Hyp(tuple(int(t) for t in tokens[i, :lens[i]]),
                   float(scores[i]),
                   tuple(int(t) for t in times[i, :lens[i]]))
            for i in range(n)]


def ctc_greedy_search(logits: np.ndarray, out_lens: np.ndarray,
                      blank_idx: int = 0) -> List[List[int]]:
    """Native greedy CTC over (B, T, V) logits; the contract of
    ``decode/ctc.py``'s ctc_greedy_search."""
    lib = _load()
    if lib is None:
        return py.ctc_greedy_search(logits, out_lens, blank_idx)
    logits = np.ascontiguousarray(logits, np.float32)
    out_lens = np.asarray(out_lens)
    hyps = []
    for b in range(logits.shape[0]):
        T = int(out_lens[b])
        V = logits.shape[2]
        out = np.zeros((max(T, 1),), np.int32)
        n = lib.ctc_greedy_decode(
            logits[b].ctypes.data_as(ctypes.POINTER(ctypes.c_float)), T, V,
            blank_idx, max(T, 1),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        hyps.append([int(x) for x in out[:n]])
    return hyps
