"""Checkpoint ingestion: reference PyTorch state dicts -> the port's
parameter tree (port of the MoE-encoder converters of
``m3asr_tpu/checkpoint.py``).

The tree is a nested dict of tensors with the JAX package's paths and
layouts, so weights carry across by a plain walk:

 * nn.Linear weight (out, in)            -> kernel (in, out)
 * nn.Conv2d weight (O, I, kh, kw)       -> kernel (kh, kw, I, O) [HWIO]
 * pointwise nn.Conv1d weight (O, I, 1)  -> kernel (I, O)
 * depthwise nn.Conv1d weight (C, 1, K)  -> kernel (K, C)
 * BatchNorm1d (inference)               -> folded scale/shift, eps 1e-5
 * FMoELinear weight (E, out, in)        -> (E, in, out)
 * per-block trees                       -> stacked over layers (L, ...)

Conversion runs in numpy on the host; :func:`to_torch` places the
result on a device.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

import numpy as np
import torch

from m3asr_tpu_torch.config import EncoderConfig, ModelConfig, MoEEncoderConfig
from m3asr_tpu_torch.ops.positional import sinusoid_table

BN_EPS = 1e-5


class TrackedDict(dict):
    """State dict that records which keys conversion consumed."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self._used: set = set()


_IGNORE_UNCONSUMED = re.compile(r"\.num_batches_tracked$")


def unconsumed_keys(state_dict) -> List[str]:
    used = getattr(state_dict, "_used", set())
    return sorted(k for k in state_dict
                  if k not in used and not _IGNORE_UNCONSUMED.search(k))


def check_consumed(state_dict, strict: bool = False, log=print) -> List[str]:
    """Report (and under ``strict``, reject) unconsumed checkpoint keys."""
    missing = unconsumed_keys(state_dict)
    if not missing:
        log(f"checkpoint conversion: all {len(state_dict)} keys consumed")
        return missing
    log(f"checkpoint conversion: {len(missing)} of {len(state_dict)} "
        "keys NOT consumed:")
    for k in missing:
        log(f"  unconsumed: {k}")
    if strict:
        raise KeyError(f"strict conversion: {len(missing)} unconsumed "
                       f"checkpoint keys (first: {missing[0]})")
    return missing


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().float().numpy() \
        if t.dtype == torch.bfloat16 else t.detach().cpu().numpy()


class StateDict:
    """View over a flat name -> tensor dict with prefix scoping."""

    def __init__(self, d: Dict[str, Any], prefix: str = ""):
        self.d = d
        self.prefix = prefix
        self.used: set = getattr(d, "_used", set())

    def sub(self, name: str) -> "StateDict":
        s = StateDict(self.d, self.prefix + name + ".")
        s.used = self.used
        return s

    def __contains__(self, name: str) -> bool:
        return self.prefix + name in self.d

    def get(self, name: str) -> np.ndarray:
        key = self.prefix + name
        self.used.add(key)
        return _np(self.d[key])


def _linear(sd: StateDict, name: str, bias: bool = True) -> Dict:
    p = {"kernel": sd.get(f"{name}.weight").T.copy()}
    if bias and f"{name}.bias" in sd:
        p["bias"] = sd.get(f"{name}.bias")
    return p


def _layer_norm(sd: StateDict, name: str) -> Dict:
    return {"scale": sd.get(f"{name}.weight"), "bias": sd.get(f"{name}.bias")}


def _conv2d(sd: StateDict, name: str) -> Dict:
    w = sd.get(f"{name}.weight")                        # (O, I, kh, kw)
    return {"kernel": w.transpose(2, 3, 1, 0).copy(),
            "bias": sd.get(f"{name}.bias")}


def _pointwise_conv1d(sd: StateDict, name: str) -> Dict:
    w = sd.get(f"{name}.weight")                        # (O, I, 1)
    return {"kernel": w[:, :, 0].T.copy(), "bias": sd.get(f"{name}.bias")}


def _depthwise_conv1d(sd: StateDict, name: str) -> Dict:
    w = sd.get(f"{name}.weight")                        # (C, 1, K)
    return {"kernel": w[:, 0, :].T.copy(), "bias": sd.get(f"{name}.bias")}


def _folded_batch_norm(sd: StateDict, name: str, eps: float = BN_EPS) -> Dict:
    gamma = sd.get(f"{name}.weight")
    beta = sd.get(f"{name}.bias")
    mean = sd.get(f"{name}.running_mean")
    var = sd.get(f"{name}.running_var")
    scale = gamma / np.sqrt(var + eps)
    return {"scale": scale, "bias": beta - mean * scale}


def convert_subsampling(sd: StateDict, input_layer: str) -> Dict:
    if input_layer != "conv2d":
        raise NotImplementedError(
            f"input_layer {input_layer!r}: only 'conv2d' is ported")
    p = {"conv0": _conv2d(sd, "conv.0"), "conv1": _conv2d(sd, "conv.2")}
    p["out"] = _linear(sd, "out.0" if "out.0.weight" in sd else "out")
    return p


def convert_attention(sd: StateDict) -> Dict:
    p = {n: _linear(sd, n) for n in
         ("linear_q", "linear_k", "linear_v", "linear_out")}
    p["linear_pos"] = _linear(sd, "linear_pos", bias=False)
    p["pos_bias_u"] = sd.get("pos_bias_u")
    p["pos_bias_v"] = sd.get("pos_bias_v")
    return p


def convert_conv_module(sd: StateDict, cnn_module_norm: str) -> Dict:
    p = {"pointwise_conv1": _pointwise_conv1d(sd, "pointwise_conv1"),
         "depthwise_conv": _depthwise_conv1d(sd, "depthwise_conv"),
         "pointwise_conv2": _pointwise_conv1d(sd, "pointwise_conv2")}
    p["norm"] = (_folded_batch_norm(sd, "norm")
                 if cnn_module_norm == "batch_norm"
                 else _layer_norm(sd, "norm"))
    return p


def convert_ffn(sd: StateDict) -> Dict:
    return {"w_1": _linear(sd, "w_1"), "w_2": _linear(sd, "w_2")}


def convert_moe_ffn(sd: StateDict) -> Dict:
    w1 = sd.get("experts.w_1.weight")                   # (E, hidden, idim)
    w2 = sd.get("experts.w_2.weight")                   # (E, idim, hidden)
    p = {"w1": w1.transpose(0, 2, 1).copy(),
         "b1": sd.get("experts.w_1.bias"),
         "w2": w2.transpose(0, 2, 1).copy(),
         "b2": sd.get("experts.w_2.bias"),
         "router": {"kernel": sd.get("router_weights")}}
    if "router_bias" in sd:
        p["router"]["bias"] = sd.get("router_bias")
    return p


def convert_block(sd: StateDict, cfg: EncoderConfig, moe: bool) -> Dict:
    p = {"norm_mha": _layer_norm(sd, "norm_mha"),
         "self_attn": convert_attention(sd.sub("self_attn")),
         "norm_ff": _layer_norm(sd, "norm_ff"),
         "feed_forward": (convert_moe_ffn(sd.sub("feed_forward")) if moe
                          else convert_ffn(sd.sub("feed_forward")))}
    if cfg.macaron_style:
        p["norm_ff_macaron"] = _layer_norm(sd, "norm_ff_macaron")
        p["feed_forward_macaron"] = convert_ffn(
            sd.sub("feed_forward_macaron"))
    if cfg.use_cnn_module:
        p["norm_conv"] = _layer_norm(sd, "norm_conv")
        p["conv_module"] = convert_conv_module(sd.sub("conv_module"),
                                               cfg.cnn_module_norm)
        p["norm_final"] = _layer_norm(sd, "norm_final")
    return p


def _stack_blocks(blocks: List[Dict]) -> Dict:
    return {k: (_stack_blocks([b[k] for b in blocks])
                if isinstance(blocks[0][k], dict)
                else np.stack([b[k] for b in blocks]))
            for k in blocks[0]}


def _convert_dense_encoder(sd: StateDict, cfg: EncoderConfig) -> Dict:
    p = {"subsampling": convert_subsampling(sd.sub("subsampling"),
                                            cfg.input_layer),
         "pos_enc": {"pe": sinusoid_table(cfg.attention_dim).numpy()},
         "after_norm": _layer_norm(sd, "after_norm"),
         "out_linear": _linear(sd, "out_linear")}
    p["blocks"] = _stack_blocks([convert_block(sd.sub(f"blocks.{i}"), cfg,
                                               moe=False)
                                 for i in range(cfg.num_blocks)])
    return p


def convert_moe_encoder(sd: StateDict, cfg: MoEEncoderConfig) -> Dict:
    """Numpy parameter tree of the hier MoE encoder."""
    p = {"embed": _convert_dense_encoder(sd.sub("embed"), cfg.embed_conf),
         "subsampling": convert_subsampling(sd.sub("subsampling"),
                                            cfg.input_layer),
         "pos_enc": {"pe": sinusoid_table(cfg.attention_dim).numpy()},
         "after_norm": _layer_norm(sd, "after_norm"),
         "out_linear": _linear(sd, "out_linear")}
    for tap in ("after_norm_6", "after_norm_12"):
        if f"{tap}.weight" in sd:
            p[tap] = _layer_norm(sd, tap)
    p["blocks"] = _stack_blocks([convert_block(sd.sub(f"blocks.{i}"), cfg,
                                               moe=True)
                                 for i in range(cfg.num_blocks)])
    return p


def convert_encoder(state_dict: Dict[str, Any], cfg: ModelConfig,
                    device="cpu", dtype: torch.dtype = torch.float32) -> Dict:
    """Convert the encoder of a (possibly AED-wrapped) reference
    checkpoint into the port's tree of tensors on ``device``."""
    sd = StateDict(state_dict)
    if any(k.startswith("encoder.") for k in state_dict):
        sd = sd.sub("encoder")
    return to_torch(convert_moe_encoder(sd, cfg.encoder_conf), device, dtype)


def load_torch_checkpoint(path: str) -> "TrackedDict":
    """torch.load a reference .pt checkpoint on the CPU; returns a flat,
    consumption-tracked numpy state dict."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]                # trainer checkpoints wrap it
    return TrackedDict({k: _np(v) for k, v in obj.items()})


def to_torch(tree, device="cpu", dtype: torch.dtype = torch.float32,
             _name: str = ""):
    """Numpy (or tensor) tree -> tensors on ``device``; floating leaves
    take ``dtype``, except quantization scales (``*_scale``), which stay
    float32 as the JAX engine keeps them; integer leaves (quantized
    weights) keep their type; None leaves stay None."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device, dtype, k) for k, v in tree.items()}
    if tree is None:
        return None
    t = tree if torch.is_tensor(tree) else torch.tensor(np.asarray(tree))
    if t.is_floating_point():
        t = t.to(torch.float32 if _name.endswith("_scale") else dtype)
    return t.to(device).contiguous()


def params_from_jax(tree, device="cpu", dtype: torch.dtype = torch.float32):
    """The JAX package's parameter tree (nested dict of numpy arrays, as
    ``jax.tree.map(np.asarray, params)`` gives it) -> the port's tree on
    ``device`` with floating leaves in ``dtype`` (``*_scale`` leaves in
    float32, integer leaves as they are). Paths and layouts are shared,
    so this is a plain walk."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if node is None:
            return None
        a = np.asarray(node)
        if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
            a = a.astype(np.float32)
        return a
    return to_torch(walk(tree), device, dtype)
