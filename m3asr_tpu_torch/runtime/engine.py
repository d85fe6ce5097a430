"""The inference engine (port of the float subset of
``m3asr_tpu/runtime/engine.py``).

An engine directory has the JAX package's format, so either package
reads what the other wrote:

    engine_dir/
      config.yaml   the model config (reference YAML schema)
      engine.json   engine settings (dtype, buckets, prior, ...)
      params.npz    weights, flat "a/b/c" paths, float32 on disk

Precision: ``float32`` engines run full float32 on the card. They turn
TF32 off for cuBLAS and cuDNN (PyTorch's cuDNN default is TF32 for
convolutions), whatever ``fp32_precision`` an engine.json names: the JAX
package's bf16_3x "high" mode has no PyTorch twin. ``bfloat16`` engines
hold weights and activations in bf16; attention scores, softmax, layer
norm statistics, router logits and the expert accumulation run in
float32, as in the JAX package.

MoE policy: ``auto`` (and ``runs``/``runs_f``) runs the K1 expert
kernel on ``cuda`` and its plain PyTorch version on ``cpu``; an explicit
``dense`` is honoured.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from m3asr_tpu_torch.checkpoint import to_torch
from m3asr_tpu_torch.config import (ModelConfig, model_config_from_dict,
                                    model_config_to_dict)
from m3asr_tpu_torch.device import resolve_device
from m3asr_tpu_torch.models import moe_conformer
from m3asr_tpu_torch.runtime.buckets import (BucketSpec, DEFAULT_BATCHES,
                                             DEFAULT_LENGTHS)

log = logging.getLogger("m3asr_tpu_torch")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_MOE_IMPLS = {"auto": "runs_f", "runs": "runs_f", "runs_f": "runs_f",
              "dense": "dense"}

# JAX engine.json settings this slice does not run: name -> (the value
# the port runs, the ROADMAP item that brings the others)
_NOT_PORTED = {
    "fuse_qkv": (False, "Queue 1 item 6 (quantized serving modes)"),
    "dense_quant": (False, "Queue 1 item 6 (quantized serving modes)"),
    "act_quant": (False, "Queue 1 item 6 (quantized serving modes)"),
    "attn_impl": ("xla", "Queue 1 item 7 (flash attention, K2)"),
    "ep": (1, "Queue 1 item 12 (parallelism)"),
    "tp": (1, "Queue 1 item 12 (parallelism)"),
    "return_hidden": (False, "Queue 1 item 8 (decode outputs and taps)"),
    "return_taps": (False, "Queue 1 item 8 (decode outputs and taps)"),
}
# JAX engine.json settings with no effect on this port's results
_IGNORED = {"decode_topk", "fp32_precision", "donate_input"}


@dataclasses.dataclass
class EngineConfig:
    dtype: str = "float32"            # float32 | bfloat16
    decode_output: str = "logits"     # logits | log_softmax
    use_prior: bool = False           # subtract log-prior from logits
    bucket_lengths: Tuple[int, ...] = DEFAULT_LENGTHS
    bucket_batches: Tuple[int, ...] = DEFAULT_BATCHES
    moe_impl: str = "auto"            # auto | runs_f | runs | dense

    def validate(self) -> None:
        if self.dtype in ("int8", "int4"):
            raise NotImplementedError(
                f"dtype {self.dtype!r} is not ported yet: ROADMAP Queue 1 "
                "item 6 (quantized serving modes, K4-K6)")
        if self.dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}")
        if self.decode_output in ("argmax", "topk", "beam"):
            raise NotImplementedError(
                f"decode_output {self.decode_output!r} is not ported yet: "
                "ROADMAP Queue 1 item 8 (decode outputs)")
        if self.decode_output not in ("logits", "log_softmax"):
            raise ValueError(f"unknown decode_output {self.decode_output!r}")
        if self.moe_impl not in _MOE_IMPLS:
            raise NotImplementedError(
                f"moe_impl {self.moe_impl!r} is not ported; the port runs "
                f"{sorted(_MOE_IMPLS)} (ROADMAP Queue 1 item 6 lists the "
                "other expert impls)")


def config_from_engine_json(meta: Dict) -> Tuple[EngineConfig, Optional[list]]:
    """Parse a (JAX- or port-written) engine.json. Settings this slice
    does not run raise NotImplementedError naming their ROADMAP item.
    Returns (config, neg_log_prior or None)."""
    meta = dict(meta)
    meta.pop("nnet_proto", None)
    neg_log_prior = meta.pop("neg_log_prior", None)
    for name, (ported, item) in _NOT_PORTED.items():
        value = meta.pop(name, ported)
        if value != ported:
            raise NotImplementedError(
                f"engine.json {name}={value!r} is not ported yet: "
                f"ROADMAP {item}")
    for name in _IGNORED:
        meta.pop(name, None)
    fields = {f.name for f in dataclasses.fields(EngineConfig)}
    unknown = sorted(set(meta) - fields)
    if unknown:
        raise ValueError(f"unknown engine.json settings: {unknown}")
    cfg = EngineConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in meta.items()})
    cfg.validate()
    return cfg, neg_log_prior


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif tree is not None:
        out[prefix[:-1]] = tree.detach().float().cpu().numpy() \
            if tree.is_floating_point() else tree.detach().cpu().numpy()
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


class Engine:
    """Inference engine for one hier MoE conformer and its weights.

    ``device`` defaults to ``cuda`` and raises when there is no card;
    pass ``device="cpu"`` for the plain PyTorch path."""

    def __init__(self, model_cfg: ModelConfig, params,
                 engine_cfg: Optional[EngineConfig] = None,
                 prior: Optional[np.ndarray] = None, device=None):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.cfg = engine_cfg or EngineConfig()
        self.cfg.validate()
        self.buckets = BucketSpec(tuple(self.cfg.bucket_lengths),
                                  tuple(self.cfg.bucket_batches))
        self.dtype = _DTYPES[self.cfg.dtype]
        self.moe_impl = _MOE_IMPLS[self.cfg.moe_impl]
        if self.dtype == torch.float32 and self.device.type == "cuda":
            # full float32: cuDNN convolutions default to TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            log.info("float32 engine: TF32 disabled for cuBLAS and cuDNN")
        self.params = to_torch(params, self.device, self.dtype)
        self.neg_log_prior = None
        if prior is not None and self.cfg.use_prior:
            self.neg_log_prior = torch.as_tensor(
                -np.log(np.asarray(prior))).to(self.device, self.dtype)

    def forward(self, feat: torch.Tensor, feat_len: torch.Tensor):
        """The padded forward on device tensors: (out, out_len)."""
        out, out_len = moe_conformer.forward(
            self.params, self.model_cfg.encoder_conf, feat, feat_len,
            moe_impl=self.moe_impl)
        if self.neg_log_prior is not None:
            out = out + self.neg_log_prior
        if self.cfg.decode_output == "log_softmax":
            out = torch.log_softmax(out.float(), dim=-1)
        return out, out_len

    def infer(self, feat: np.ndarray, feat_len: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
        """feat: (B, T, input_dim); feat_len: (B,) or (1, B). Pads to the
        bucket, runs, trims to the valid region. Returns float32 numpy
        (B, T', V) and int32 (B,)."""
        feat = np.asarray(feat)
        feat_len = np.asarray(feat_len).reshape(-1).astype(np.int32)
        B, T = feat.shape[:2]
        bb, bt = self.buckets.pick(B, T)
        pad_feat = np.zeros((bb, bt, feat.shape[2]), np.float32)
        pad_feat[:B, :T] = feat
        pad_len = np.zeros((bb,), np.int32)
        pad_len[:B] = feat_len
        x = torch.from_numpy(pad_feat).to(self.device, self.dtype)
        lens = torch.from_numpy(pad_len).to(self.device)
        with torch.inference_mode():
            out, out_len = self.forward(x, lens)
            out = out.float().cpu().numpy()
            out_len = out_len.cpu().numpy().astype(np.int32)
        max_out = int(out_len[:B].max()) if B else 0
        return out[:B, :max_out], out_len[:B]

    # ------------------------------------------------------------------
    # engine directories (the JAX package's format)
    # ------------------------------------------------------------------
    def save(self, engine_dir: str, raw_yaml: Optional[dict] = None):
        import yaml
        os.makedirs(engine_dir, exist_ok=True)
        np.savez(os.path.join(engine_dir, "params.npz"),
                 **_flatten(self.params))
        meta = dataclasses.asdict(self.cfg)
        meta["nnet_proto"] = self.model_cfg.nnet_proto
        if self.neg_log_prior is not None:
            meta["neg_log_prior"] = self.neg_log_prior.float().cpu().tolist()
        with open(os.path.join(engine_dir, "engine.json"), "w") as f:
            json.dump(meta, f, indent=1)
        with open(os.path.join(engine_dir, "config.yaml"), "w") as f:
            yaml.safe_dump(raw_yaml or model_config_to_dict(self.model_cfg),
                           f)

    @classmethod
    def load(cls, engine_dir: str, device=None) -> "Engine":
        import yaml
        with open(os.path.join(engine_dir, "config.yaml")) as f:
            model_cfg = model_config_from_dict(yaml.safe_load(f))
        with open(os.path.join(engine_dir, "engine.json")) as f:
            ecfg, neg_log_prior = config_from_engine_json(json.load(f))
        with np.load(os.path.join(engine_dir, "params.npz")) as z:
            params = _unflatten(dict(z))
        eng = cls(model_cfg, params, ecfg, device=device)
        if neg_log_prior is not None:
            eng.neg_log_prior = torch.as_tensor(
                np.asarray(neg_log_prior)).to(eng.device, eng.dtype)
        return eng
