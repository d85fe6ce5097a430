"""Checkpoint ingestion: reference PyTorch state dicts -> the port's
parameter tree (port of the MoE-encoder, DFSMN and AED-decoder
converters of ``m3asr_tpu/checkpoint.py``).

The tree is a nested dict of tensors with the JAX package's paths and
layouts, so weights carry across by a plain walk:

 * nn.Linear weight (out, in)            -> kernel (in, out)
 * nn.Conv2d weight (O, I, kh, kw)       -> kernel (kh, kw, I, O) [HWIO]
 * pointwise nn.Conv1d weight (O, I, 1)  -> kernel (I, O)
 * depthwise nn.Conv1d weight (C, 1, K)  -> kernel (K, C)
 * BatchNorm1d (inference)               -> folded scale/shift, eps 1e-5
 * FMoELinear weight (E, out, in)        -> (E, in, out)
 * per-block trees                       -> stacked over layers (L, ...)
   (the conformers); the DFSMN nets keep per-layer lists

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
    """The input layer: Conv2dSubsampling4 / 6 / 8 (``conv.0``,
    ``conv.2``[, ``conv.4``], then ``out`` or ``out.0``) or
    LinearNoSubsampling (``out.0`` Linear, ``out.1`` LayerNorm)."""
    if input_layer == "linear":
        return {"out": _linear(sd, "out.0"), "norm": _layer_norm(sd, "out.1")}
    convs = {"conv2d": 2, "conv2d6": 2, "conv2d8": 3}.get(input_layer)
    if convs is None:
        raise ValueError(f"unknown input_layer {input_layer!r}")
    p = {f"conv{i}": _conv2d(sd, f"conv.{2 * i}") for i in range(convs)}
    p["out"] = _linear(sd, "out.0" if "out.0.weight" in sd else "out")
    return p


def convert_attention(sd: StateDict) -> Dict:
    """Self-attention of an encoder block (with its relative-position
    weights) or an attention of a decoder block (plain)."""
    p = {n: _linear(sd, n) for n in
         ("linear_q", "linear_k", "linear_v", "linear_out")}
    if "linear_pos.weight" in sd:
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
        # ExMarc: the macaron FFN of a MoE block is a MoE FFN too
        p["feed_forward_macaron"] = (
            convert_moe_ffn(sd.sub("feed_forward_macaron"))
            if moe and getattr(cfg, "exmarc", False)
            else convert_ffn(sd.sub("feed_forward_macaron")))
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


def convert_dense_encoder(sd: StateDict, cfg: EncoderConfig) -> Dict:
    """Numpy parameter tree of a dense conformer encoder (a dense proto's
    encoder, or the hier model's embed sub-encoder), with the front end's
    LayerNorm when the checkpoint has one."""
    p = {"subsampling": convert_subsampling(sd.sub("subsampling"),
                                            cfg.input_layer),
         "pos_enc": {"pe": sinusoid_table(cfg.attention_dim).numpy()},
         "after_norm": _layer_norm(sd, "after_norm"),
         "out_linear": _linear(sd, "out_linear")}
    if "subsampling_layer_norm.weight" in sd:
        p["subsampling_layer_norm"] = _layer_norm(sd,
                                                  "subsampling_layer_norm")
    p["blocks"] = _stack_blocks([convert_block(sd.sub(f"blocks.{i}"), cfg,
                                               moe=False)
                                 for i in range(cfg.num_blocks)])
    return p


def convert_moe_encoder(sd: StateDict, cfg: MoEEncoderConfig) -> Dict:
    """Numpy parameter tree of the hier MoE encoder."""
    p = {"embed": convert_dense_encoder(sd.sub("embed"), cfg.embed_conf),
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
    checkpoint into the port's tree of tensors on ``device``, by the
    converter of its nnet_proto's family (``models/registry.py``)."""
    from m3asr_tpu_torch.models.registry import get_family
    return to_torch(get_family(cfg.nnet_proto).convert(state_dict, cfg),
                    device, dtype)


# ---------------------------------------------------------------------------
# DFSMN families: per-layer lists, as the JAX package's trees hold them
# ---------------------------------------------------------------------------

def convert_cfsmn(sd: StateDict) -> Dict:
    return {"left_factor": sd.get("left_factor"),
            "cur_factor": sd.get("cur_factor"),
            "right_factor": sd.get("right_factor"),
            "hid_proj": _linear(sd, "hid_proj"),
            "mem_proj": _linear(sd, "mem_proj")}


def convert_attn_mem(sd: StateDict) -> Dict:
    p = {n: _linear(sd, n) for n in ("linear_query", "linear_key",
                                     "linear_value", "linear_out")}
    if "key_memory" in sd:
        p["key_memory"] = sd.get("key_memory")
        p["value_memory"] = sd.get("value_memory")
    return p


def convert_dfsmn_san(sd: StateDict, num_block: int, fsmn_each_block: int,
                      norm_type: str = "LN") -> Dict:
    """A dfsmn_san_res Net state dict."""
    blocks = []
    for i in range(num_block):
        b = sd.sub(f"blocks.{i}")
        fsmn = [convert_cfsmn(b.sub(f"fsmn_layers.{j}"))
                for j in range(fsmn_each_block)]
        attn = {"attn_layer": convert_attn_mem(
            b.sub("attn_layer.attn_layer"))}
        if norm_type == "LN":
            attn["ln_layer"] = _layer_norm(b.sub("attn_layer"), "ln_layer")
        else:
            # MaskBatchNorm's eval fold (eps 1e-8), stats shaped (1, D)
            bb = b.sub("attn_layer.bn_layer")
            gamma, beta = bb.get("weight")[0], bb.get("bias")[0]
            mean, var = bb.get("running_mean")[0], bb.get("running_var")[0]
            scale = gamma / np.sqrt(var + 1e-8)
            attn["bn_layer"] = {"scale": scale, "bias": beta - mean * scale}
        blocks.append({"fsmn_layers": fsmn, "attn_layer": attn})
    return {"blocks": blocks, "out_linear": _linear(sd, "out_linear")}


def convert_dfsmn_san_domain_acc(sd: StateDict, num_block: int,
                                 fsmn_each_block: int,
                                 norm_type: str = "LN") -> Dict:
    """A dfsmn_san_res_embed_domain_acc Net state dict: the san net plus
    out_linear_{domain,accent}[_embed]."""
    p = convert_dfsmn_san(sd, num_block, fsmn_each_block, norm_type)
    for name in ("out_linear_domain", "out_linear_accent",
                 "out_linear_domain_embed", "out_linear_accent_embed"):
        p[name] = _linear(sd, name)
    return p


def convert_cfsmn_moe(sd: StateDict) -> Dict:
    """MoE cFSMN layer: FMoELinear experts {hid_proj (bias), mem_proj (no
    bias)}, the router ('rooter' in the reference) and the FIR factors."""
    w1 = sd.get("experts.hid_proj.weight")               # (E, h, d)
    w2 = sd.get("experts.mem_proj.weight")               # (E, d, h)
    p = {"left_factor": sd.get("left_factor"),
         "cur_factor": sd.get("cur_factor"),
         "right_factor": sd.get("right_factor"),
         "w1": w1.transpose(0, 2, 1).copy(),
         "b1": sd.get("experts.hid_proj.bias"),
         "w2": w2.transpose(0, 2, 1).copy(),
         "b2": None,
         "router": {"kernel": sd.get("rooter_weights")}}
    if "rooter_bias" in sd:
        p["router"]["bias"] = sd.get("rooter_bias")
    if "ln_for_router.weight" in sd:
        p["ln_for_router"] = _layer_norm(sd, "ln_for_router")
    return p


def convert_dfsmn_san_moe(sd: StateDict, num_block: int,
                          fsmn_each_block: int, embed_num_block: int,
                          embed_fsmn_each_block: int,
                          norm_type: str = "LN") -> Dict:
    """A dfsmn_san_fmoe_localComm_catEmbed Net state dict: the embed
    sub-net and the blocks_sw stack (a layer with experts converts as the
    MoE layer, the others as plain cFSMN)."""
    p = {"embed": convert_dfsmn_san(sd.sub("embed"), embed_num_block,
                                    embed_fsmn_each_block, norm_type)}
    blocks = []
    for i in range(num_block):
        b = sd.sub(f"blocks_sw.{i}")
        fsmn = []
        for j in range(fsmn_each_block):
            lj = b.sub(f"fsmn_layers.{j}")
            fsmn.append(convert_cfsmn_moe(lj)
                        if "experts.hid_proj.weight" in lj
                        else convert_cfsmn(lj))
        attn = {"attn_layer": convert_attn_mem(
            b.sub("attn_layer.attn_layer")),
            "ln_layer": _layer_norm(b.sub("attn_layer"), "ln_layer")}
        blocks.append({"fsmn_layers": fsmn, "attn_layer": attn})
    p["blocks_sw"] = blocks
    p["out_linear_sw"] = _linear(sd, "out_linear_sw")
    return p


def convert_dfsmn_base(sd: StateDict, fsmn_layers: int) -> Dict:
    """A dfsmn_base_res Net state dict."""
    return {"fsmn_layers": [convert_cfsmn(sd.sub(f"fsmn_layers.{i}"))
                            for i in range(fsmn_layers)],
            "out_linear": _linear(sd, "out_linear")}


def convert_decoder_layer(sd: StateDict) -> Dict:
    return {"norm1": _layer_norm(sd, "norm1"),
            "norm2": _layer_norm(sd, "norm2"),
            "norm3": _layer_norm(sd, "norm3"),
            "self_attn": convert_attention(sd.sub("self_attn")),
            "src_attn": convert_attention(sd.sub("src_attn")),
            "feed_forward": convert_ffn(sd.sub("feed_forward"))}


def _convert_single_decoder(sd: StateDict, num_blocks: int,
                            d_model: int) -> Dict:
    p = {"embed": {"weight": sd.get("embed.0.weight")},
         "pos_enc": {"pe": sinusoid_table(d_model).numpy()},
         "after_norm": _layer_norm(sd, "after_norm"),
         "output_layer": _linear(sd, "output_layer")}
    p["decoders"] = _stack_blocks([
        convert_decoder_layer(sd.sub(f"decoders.{i}"))
        for i in range(num_blocks)])
    return p


def convert_decoder(state_dict: Dict[str, Any], cfg: ModelConfig,
                    name: str = "decoder", device="cpu",
                    dtype: torch.dtype = torch.float32) -> Dict:
    """Convert one AED decoder of a reference checkpoint (a
    TransformerDecoder, or a BiTransformerDecoder's ``left_decoder`` and,
    with ``r_num_blocks``, ``right_decoder``) into the port's tree on
    ``device``. The hier AED wrapper has three: decoder, decoder_1 and
    decoder_2. Every key read counts as consumed for
    :func:`check_consumed`."""
    sd = StateDict(state_dict).sub(name)
    d_model = cfg.encoder_conf.attention_dim
    dc = cfg.decoder_conf
    if f"{name}.left_decoder.after_norm.weight" in state_dict:
        p = {"left_decoder": _convert_single_decoder(
            sd.sub("left_decoder"), dc.num_blocks, d_model)}
        if dc.r_num_blocks > 0:
            p["right_decoder"] = _convert_single_decoder(
                sd.sub("right_decoder"), dc.r_num_blocks, d_model)
    else:
        p = _convert_single_decoder(sd, dc.num_blocks, d_model)
    return to_torch(p, device, dtype)


AED_DECODERS = ("decoder", "decoder_1", "decoder_2")


def convert_decoders(state_dict: Dict[str, Any], cfg: ModelConfig,
                     device="cpu", dtype: torch.dtype = torch.float32
                     ) -> Dict:
    """Every AED decoder the checkpoint holds ({name: tree}, possibly
    empty), as the JAX ``build.py`` collects them."""
    return {name: convert_decoder(state_dict, cfg, name, device, dtype)
            for name in AED_DECODERS
            if any(k.startswith(name + ".") for k in state_dict)}


DECODERS_FILE = "decoders.npz"


def save_decoders(engine_dir: str, decoders: Dict) -> str:
    """Write {name: decoder tree} to ``engine_dir/decoders.npz`` in the JAX
    engine's flat format ("decoder/decoders/norm1/scale", float32), which
    either package's recognizer reads. Returns the path."""
    import os
    flat = flatten_tree({name: params_to_numpy(tree)
                         for name, tree in decoders.items()})
    path = os.path.join(engine_dir, DECODERS_FILE)
    np.savez(path, **flat)
    return path


def load_decoders(engine_dir: str, device="cpu",
                  dtype: torch.dtype = torch.float32) -> Dict:
    """Read ``engine_dir/decoders.npz`` (either package's) into
    {name: tree of tensors on ``device``}."""
    import os
    with np.load(os.path.join(engine_dir, DECODERS_FILE)) as z:
        return to_torch(unflatten_tree(dict(z)), device, dtype)


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
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, device, dtype, _name) for v in tree]
    if tree is None:
        return None
    t = tree if torch.is_tensor(tree) else torch.tensor(np.asarray(tree))
    if t.is_floating_point():
        t = t.to(torch.float32 if _name.endswith("_scale") else dtype)
    return t.to(device).contiguous()


def flatten_tree(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts and lists -> {"a/b/c": leaf} (the JAX package's flat
    paths, as in engine ``params.npz``): a list's items take their index
    as the path element ("blocks/0/fsmn_layers/1/w1", the DFSMN nets'
    per-layer lists); None leaves are left out."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        if tree is not None:
            out[prefix[:-1]] = tree
        return out
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}{k}/"))
    return out


def unflatten_tree(flat: Dict[str, Any]) -> Dict:
    """Inverse of :func:`flatten_tree`: a node whose keys are all digits
    becomes a list in index order (the JAX engine's ``listify``)."""
    tree: Dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(tree)


def params_to_numpy(tree):
    """The port's tree -> the JAX tree's paths and layouts as numpy, float
    leaves in float32: gradients, optimizer moments and parameters
    compare leaf by leaf with ``jax.tree.map(np.asarray, ...)``."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    if tree is None:
        return None
    t = tree.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy()


def params_from_jax(tree, device="cpu", dtype: torch.dtype = torch.float32):
    """The JAX package's parameter tree (nested dict of numpy arrays, as
    ``jax.tree.map(np.asarray, params)`` gives it) -> the port's tree on
    ``device`` with floating leaves in ``dtype`` (``*_scale`` leaves in
    float32, integer leaves as they are). Paths and layouts are shared,
    so this is a plain walk."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        if node is None:
            return None
        a = np.asarray(node)
        if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
            a = a.astype(np.float32)
        return a
    return to_torch(walk(tree), device, dtype)


# ---------------------------------------------------------------------------
# expert resharding of reference state dicts (the reference's
# state_dict_comm / load_state_dict_comm)
# ---------------------------------------------------------------------------

_EXPERT_RE = re.compile(r"experts")


def shard_experts(state_dict: Dict[str, np.ndarray], rank: int,
                  world_size: int) -> Dict[str, np.ndarray]:
    """A gathered full-expert state dict sliced to ``rank``'s shard: every
    key naming ``experts`` keeps its ``[rank*E/w, (rank+1)*E/w)`` slice of
    the leading expert axis; the rest stays whole."""
    out = {}
    for k, v in state_dict.items():
        if _EXPERT_RE.search(k):
            e = v.shape[0]
            if e % world_size:
                raise ValueError(f"{k}: {e} experts do not split over "
                                 f"{world_size} ranks")
            per = e // world_size
            out[k] = v[rank * per:(rank + 1) * per]
        else:
            out[k] = v
    return out


def gather_expert_shards(shards: List[Dict[str, np.ndarray]]
                         ) -> Dict[str, np.ndarray]:
    """Inverse of :func:`shard_experts`: the ranks' expert slices
    concatenated in rank order; other keys from the first shard."""
    out = dict(shards[0])
    for k in shards[0]:
        if _EXPERT_RE.search(k):
            out[k] = np.concatenate([s[k] for s in shards], axis=0)
    return out
