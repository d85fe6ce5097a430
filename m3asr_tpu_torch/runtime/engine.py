"""The inference engine (port of the float and quantized serving
subset of ``m3asr_tpu/runtime/engine.py``).

An engine directory has the JAX package's format, so either package
reads what the other wrote:

    engine_dir/
      config.yaml   the model config (reference YAML schema)
      engine.json   engine settings (dtype, buckets, prior, ...)
      params.npz    weights, flat "a/b/c" paths: floats as float32,
                    quantized expert weights as int8, scales float32

Precision: ``float32`` engines run full float32 on the card. They turn
TF32 off for cuBLAS and cuDNN (PyTorch's cuDNN default is TF32 for
convolutions), whatever ``fp32_precision`` an engine.json names: the JAX
package's bf16_3x "high" mode has no PyTorch twin. ``bfloat16`` engines
hold weights and activations in bf16; attention scores, softmax, layer
norm statistics, router logits and the expert accumulation run in
float32, as in the JAX package. ``int8`` / ``int4`` engines are bf16
engines whose expert weights are quantized once, at construction, from
their bf16 values (``ops/quant.py``; int4 with 128-row scale groups);
``act_quant`` also quantizes the experts' activations per token (w8a8,
w4a8).

MoE policy: :func:`moe_auto_impl`, the JAX engine's measured TPU policy
taken as the card's, chosen per request bucket from its
post-subsampling token count. Float engines run K1 (``runs_f``); int4
runs K6 up to 128 tokens and K5 beyond; int8 runs the plain-PyTorch
``quant`` stage up to 128 tokens and K4 beyond; ``act_quant`` swaps each
for its a8 twin. On ``cuda`` the kernels run; on ``cpu`` their plain
PyTorch versions do, under the same names.

Attention: ``attn_impl="xla"`` (plain PyTorch, the default) or
``"flash"``, which runs every attention layer on the flash kernel (K2,
``ops/flash_attention.py``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from m3asr_tpu_torch.checkpoint import (flatten_tree, params_to_numpy,
                                        to_torch, unflatten_tree)
from m3asr_tpu_torch.config import (ModelConfig, model_config_from_dict,
                                    model_config_to_dict)
from m3asr_tpu_torch.device import resolve_device
from m3asr_tpu_torch.models import moe_conformer
from m3asr_tpu_torch.ops.masking import SUBSAMPLED_LENGTH
from m3asr_tpu_torch.ops.quant import pack_int4, quantize_moe_params
from m3asr_tpu_torch.runtime.buckets import (BucketSpec, DEFAULT_BATCHES,
                                             DEFAULT_LENGTHS)

log = logging.getLogger("m3asr_tpu_torch")

# engine dtype -> activation (and dense weight) dtype
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.bfloat16, "int4": torch.bfloat16}
_QUANT_BITS = {"int8": 8, "int4": 4}

# The JAX engine's token thresholds (m3asr_tpu/runtime/engine.py:101-107):
# a bucket of at most this many post-subsampling tokens takes the
# small-bucket stage.
MOE_Q4_DENSE_TOKEN_THRESHOLD = 128       # int4: K6, else K5
MOE_W4A8_DENSE_TOKEN_THRESHOLD = 128     # w4a8: K6 a8, else K5 a8
MOE_Q8_RUNS_TOKEN_THRESHOLD = 128        # int8/w8a8: quant[_a8], else K4

# Explicit moe_impl requests per engine mode -> the stage the port runs,
# as the JAX engine's TPU branch maps the names this port has.
_FLOAT_IMPL = {"auto": "runs_f", "runs": "runs_f", "runs_f": "runs_f",
               "dense": "dense"}
_INT8_IMPL = {"dense": "quant", "quant": "quant", "runs": "quant_runs",
              "runs_f": "quant_runs", "quant_runs": "quant_runs",
              "quant_a8": "quant_a8", "quant_a8_runs": "quant_a8_runs"}
_W8A8_IMPL = {"dense": "quant_a8", "quant": "quant_a8",
              "quant_a8": "quant_a8", "runs": "quant_a8_runs",
              "runs_f": "quant_a8_runs", "quant_runs": "quant_a8_runs",
              "quant_a8_runs": "quant_a8_runs"}
_INT4_IMPL = {"dense": "quant4_pallas", "quant": "quant4_pallas",
              "pallas": "quant4_pallas", "quant_pallas": "quant4_pallas",
              "quant4_pallas": "quant4_pallas", "quant4_a8": "quant4_a8",
              "runs": "quant4_runs", "runs_f": "quant4_runs",
              "quant4_runs": "quant4_runs",
              "quant4_a8_runs": "quant4_a8_runs"}
_W4A8_IMPL = {"dense": "quant4_a8", "quant": "quant4_a8",
              "pallas": "quant4_a8", "quant_pallas": "quant4_a8",
              "quant4_pallas": "quant4_a8", "quant4_a8": "quant4_a8",
              "runs": "quant4_a8_runs", "runs_f": "quant4_a8_runs",
              "quant4_a8_runs": "quant4_a8_runs",
              "quant4_runs": "quant4_runs"}


def moe_auto_impl(tokens: int, requested: str = "auto",
                  quant_bits: Optional[int] = None,
                  act_quant: bool = False) -> str:
    """The expert stage for a bucket of ``tokens`` post-subsampling
    tokens: the JAX engine's ``moe_auto_impl`` with its TPU branch as the
    card's policy. quant_bits: None (float), 8 or 4; act_quant: w8a8 /
    w4a8. An explicit ``requested`` name maps as the JAX engine maps it;
    one this port does not run raises NotImplementedError."""
    small = tokens <= (MOE_Q8_RUNS_TOKEN_THRESHOLD if quant_bits == 8
                       else MOE_W4A8_DENSE_TOKEN_THRESHOLD if act_quant
                       else MOE_Q4_DENSE_TOKEN_THRESHOLD)
    if quant_bits == 4:
        if requested == "auto":
            if act_quant:
                return "quant4_a8" if small else "quant4_a8_runs"
            return "quant4_pallas" if small else "quant4_runs"
        table = _W4A8_IMPL if act_quant else _INT4_IMPL
    elif quant_bits == 8:
        if requested == "auto":
            if act_quant:
                return "quant_a8" if small else "quant_a8_runs"
            return "quant" if small else "quant_runs"
        table = _W8A8_IMPL if act_quant else _INT8_IMPL
    else:
        table = _FLOAT_IMPL
    impl = table.get(requested)
    if impl is None:
        raise NotImplementedError(
            f"moe_impl {requested!r} is not ported for this engine mode; "
            f"the port runs {sorted(table)} here (ROADMAP Queue 1 item 6b "
            "brings the tiled, ragged, capacity and streamer impls)")
    return impl


# JAX engine.json settings this slice does not run: name -> (the value
# the port runs, the ROADMAP item that brings the others)
_NOT_PORTED = {
    "fuse_qkv": (False, "Queue 1 item 6b (dense_quant, fuse_qkv)"),
    "dense_quant": (False, "Queue 1 item 6b (dense_quant, fuse_qkv)"),
    "ep": (1, "Queue 1 item 12 (parallelism)"),
    "tp": (1, "Queue 1 item 12 (parallelism)"),
    "return_hidden": (False, "Queue 1 item 8 (decode outputs and taps)"),
    "return_taps": (False, "Queue 1 item 8 (decode outputs and taps)"),
}
# JAX engine.json settings with no effect on this port's results
_IGNORED = {"decode_topk", "fp32_precision", "donate_input"}


@dataclasses.dataclass
class EngineConfig:
    dtype: str = "float32"            # float32 | bfloat16 | int8 | int4
    decode_output: str = "logits"     # logits | log_softmax
    use_prior: bool = False           # subtract log-prior from logits
    bucket_lengths: Tuple[int, ...] = DEFAULT_LENGTHS
    bucket_batches: Tuple[int, ...] = DEFAULT_BATCHES
    moe_impl: str = "auto"            # auto, or a stage moe_auto_impl maps
    act_quant: bool = False           # int8/int4: per-token int8
                                      # activations (w8a8 / w4a8)
    attn_impl: str = "xla"            # xla | flash: every attention layer
                                      # on the flash kernel (K2)

    def validate(self) -> None:
        if self.dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}")
        if self.act_quant and self.dtype not in _QUANT_BITS:
            raise ValueError("act_quant requires quantized expert weights: "
                             "dtype='int8' (w8a8) or dtype='int4' (w4a8)")
        if self.attn_impl not in ("xla", "flash"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        if self.decode_output in ("argmax", "topk", "beam"):
            raise NotImplementedError(
                f"decode_output {self.decode_output!r} is not ported yet: "
                "ROADMAP Queue 1 item 8 (decode outputs)")
        if self.decode_output not in ("logits", "log_softmax"):
            raise ValueError(f"unknown decode_output {self.decode_output!r}")
        moe_auto_impl(1, self.moe_impl, _QUANT_BITS.get(self.dtype),
                      self.act_quant)          # raises on an unported name


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


def _flatten(tree) -> Dict[str, np.ndarray]:
    return flatten_tree(params_to_numpy(tree))


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    out = {}
    for path, v in flat.items():
        if path.endswith("__i4"):
            # legacy JAX engine dirs stored unpacked int4 leaves, one
            # value per byte: repack to the nibble-packed layout
            path, v = path[:-4] + "4", pack_int4(v)
        out[path] = v
    return unflatten_tree(out)


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
        self.quant_bits = _QUANT_BITS.get(self.cfg.dtype)
        if self.device.type == "cuda" and (self.dtype == torch.float32
                                           or self.cfg.act_quant):
            # full float32 (cuDNN convolutions default to TF32); w8a8's
            # s8 products are summed exactly in float32 (ops/quant.py)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            log.info("TF32 disabled for cuBLAS and cuDNN")
        self.params = to_torch(params, self.device, self.dtype)
        blocks = self.params["blocks"]
        if self.quant_bits is not None and "w1" in blocks["feed_forward"]:
            # quantize once, from the bf16 values, unless the params
            # (an engine dir, another engine's tree) already are
            blocks["feed_forward"] = to_torch(
                quantize_moe_params(blocks["feed_forward"],
                                    bits=self.quant_bits),
                self.device, self.dtype)
        self.neg_log_prior = None
        if prior is not None and self.cfg.use_prior:
            self.neg_log_prior = torch.as_tensor(
                -np.log(np.asarray(prior))).to(self.device, self.dtype)

    def moe_impl_for(self, batch: int, length: int) -> str:
        """The expert stage of a (batch, length) bucket, from its
        post-subsampling token count (the JAX engine's _moe_impl_for)."""
        sub = SUBSAMPLED_LENGTH[self.model_cfg.encoder_conf.input_layer]
        return moe_auto_impl(batch * int(sub(length)), self.cfg.moe_impl,
                             self.quant_bits, self.cfg.act_quant)

    def forward(self, feat: torch.Tensor, feat_len: torch.Tensor):
        """The padded forward on device tensors: (out, out_len)."""
        out, out_len = moe_conformer.forward(
            self.params, self.model_cfg.encoder_conf, feat, feat_len,
            moe_impl=self.moe_impl_for(feat.shape[0], feat.shape[1]),
            attn_impl=self.cfg.attn_impl)
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
