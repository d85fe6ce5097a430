"""The drivers a mix can name (``"driver"`` in its file): each builds
the system under test from the configuration, warms up the shapes its
traffic will use, drives the window, and hands back what the check and
the metrics read.

* ``offline``: closed-loop batches through ``Engine.infer``, their
  features made in set-up, going round the corpus again when it ends.

Spans (``trace.Spans``) are taken around each call into the program:
``infer``, ``stage`` and ``copy_back`` (the engine's staging and
copy-back).
"""

from __future__ import annotations

import copy
import itertools
import time

import numpy as np
import torch

from port_bench.harness import traffic, weights

NS = 1_000_000_000


class Cell:
    """One run's cell: its configuration and mix (dicts), the reference
    and counts modules of its family, the seed and the device."""

    def __init__(self, name, config, mix, seed, device, reference, counts):
        self.name, self.config, self.mix = name, config, mix
        self.seed, self.device = int(seed), torch.device(device)
        self.reference, self.counts = reference, counts
        self.model = config["model"]
        self.idim = self.model["input_dim"]


def _dtype(cell):
    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[cell.config["engine"]["dtype"]]


def make_params(cell):
    return weights.make(cell.reference.layout(cell.model), cell.seed,
                        _dtype(cell), cell.device)


def make_engine(cell, params, spans):
    """The port's engine for the configuration, its staging and
    copy-back under spans."""
    from m3asr_tpu_torch.config import model_config_from_dict
    from m3asr_tpu_torch.runtime.engine import Engine, EngineConfig
    mc = model_config_from_dict(copy.deepcopy(cell.model))
    eng = Engine(mc, params, EngineConfig(**cell.config["engine"]),
                 device=cell.device,
                 cuda_graphs=cell.config.get("cuda_graphs", True))
    for attr, name in (("_stage_in", "stage"), ("_copy_back", "copy_back")):
        inner = getattr(eng, attr, None)
        if inner is not None:
            setattr(eng, attr, _spanned(spans, name, inner))
    return eng


def _spanned(spans, name, fn):
    def call(*a, **k):
        with spans.span(name):
            return fn(*a, **k)
    return call


def warm_buckets(eng, buckets, idim):
    """Capture each bucket and serve it once at its full size, so that
    the staging buffers reach their largest size before the window."""
    eng.warmup(buckets)
    for b, t in buckets:
        eng.infer(np.zeros((b, t, idim), np.float32), np.full((b,), t,
                                                              np.int32))
    if eng.device.type == "cuda":
        torch.cuda.synchronize()


def _sample(n: int, k: int, seed: int, lengths, salt: int):
    """k seeded indices of n, and the longest."""
    r = traffic.rng(seed, salt)
    pick = set(r.choice(n, size=min(k, n), replace=False).tolist())
    pick.add(int(np.argmax(lengths)))
    return pick


class Result:
    """What a window did: the numbers the metrics read, the answers kept
    for the check (inputs and outputs), and the spans."""

    def __init__(self):
        self.t0 = self.t1 = 0
        self.kept = []          # (id, length, the program's answer)
        self.calls = []         # (utterance ids, lengths, bucket) a call
        self.extra = {}


# ---------------------------------------------------------------------------
# offline
# ---------------------------------------------------------------------------

class Offline:
    def __init__(self, cell, spans):
        self.cell, self.spans = cell, spans

    def setup(self):
        c, mix = self.cell, self.cell.mix
        self.lengths, self.batches = traffic.offline_corpus(mix, c.seed)
        self.features = traffic.Features(c.seed, c.idim)
        # the sample: among the utterances of the first batches, which
        # every window serves, and the longest of them
        first = [u for b in self.batches[:mix["check"]["batches"]]
                 for u in b]
        self.sample = {first[i] for i in _sample(
            len(first), mix["check"]["sample"], c.seed,
            self.lengths[first], 6)}
        # every batch's features, made before the window, so that the
        # window's host work is the program's alone
        self.feats = []
        for idx in self.batches:
            lens = self.lengths[idx].astype(np.int32)
            feat = np.zeros((len(idx), int(lens.max()), c.idim), np.float32)
            for j, u in enumerate(idx):
                feat[j, :lens[j]] = self.features.utterance(u, lens[j])
            self.feats.append((idx, feat, lens))
        self.params = make_params(c)
        self.engine = make_engine(c, self.params, self.spans)
        buckets = sorted({self.engine.buckets.pick(
            len(b), int(self.lengths[b].max())) for b in self.batches})
        warm_buckets(self.engine, buckets, c.idim)
        self.buckets = buckets

    def window(self, seconds, tracer):
        eng, res = self.engine, Result()
        res.t0 = tracer.mark()
        deadline = res.t0 + int(seconds * NS)
        frames, kept = 0, set()
        for idx, feat, lens in itertools.cycle(self.feats):
            bucket = eng.buckets.pick(*feat.shape[:2])
            with self.spans.span("infer", lens=lens.tolist(), bucket=bucket):
                out, out_len = eng.infer(feat, lens)[:2]
            now = time.time_ns()
            frames += int(lens.sum())
            res.calls.append(([int(u) for u in idx], lens.tolist(), bucket))
            for j, u in enumerate(idx):
                if u in self.sample and u not in kept:
                    kept.add(u)
                    res.kept.append((u, int(lens[j]),
                                     out[j, :out_len[j]].copy()))
            if now >= deadline:
                break
        res.t1 = now
        res.extra["audio_s"] = frames * traffic.FRAME_S
        return res

    def end_to_end(self, res):
        return {"audio_s_per_s": res.extra["audio_s"]
                * NS / (res.t1 - res.t0)}

    def notes(self, res):
        return [f"{len(res.calls)} batches, {res.extra['audio_s']:.1f} s of "
                f"audio in {(res.t1 - res.t0) / NS:.3f} s, buckets "
                f"{self.buckets}"]

    def free(self):
        del self.engine

    def reference_pairs(self, res, prec):
        ref, c = self.cell.reference, self.cell
        for u, T, got in res.kept:
            feat = torch.from_numpy(self.features.utterance(u, T)).to(
                c.device)
            yield got, ref.forward(self.params, c.model, feat, prec)

    def active_experts(self, calls, prec):
        """Per call, the number of experts that its valid tokens route
        to in each MoE layer: the reference's routing of each utterance
        the calls served, worked out from the same weights and
        features."""
        ref, c = self.cell.reference, self.cell
        E = ref.num_experts(c.model)
        seen, out = {}, []
        for ids, lens, _ in calls:
            for u, T in zip(ids, lens):
                if u not in seen:
                    routes = []
                    feat = torch.from_numpy(self.features.utterance(u, T))
                    ref.forward(self.params, c.model, feat.to(c.device), prec,
                                routes=routes)
                    seen[u] = torch.stack(routes)      # (layers, frames)
            r = torch.cat([seen[u] for u in ids], dim=1)
            hit = torch.zeros((r.shape[0], E), device=r.device)
            out.append(hit.scatter_(1, r, 1.0).sum(1))
        return torch.stack(out).long().tolist() if out else []


DRIVERS = {"offline": Offline}
