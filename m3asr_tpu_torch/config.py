"""Configuration schema for the hier MoE conformer.

The port's own copy of the reference YAML schema (the JAX package's
``m3asr_tpu/config.py``), limited to the hier MoE conformer family.
Other ``nnet_proto`` families raise ``NotImplementedError`` until the
slice that ports them. ``yaml`` is imported only inside
:func:`load_yaml_config`: nothing on the inference path reads a YAML.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


def _update_from_dict(obj, d: Optional[Dict[str, Any]]):
    """Apply a config dict onto a dataclass; unknown keys land in
    ``obj.extra`` (training-only knobs the reference carries)."""
    if not d:
        return obj
    names = {f.name for f in dataclasses.fields(obj)}
    for k, v in d.items():
        if k in names:
            cur = getattr(obj, k)
            if dataclasses.is_dataclass(cur) and isinstance(v, dict):
                _update_from_dict(cur, v)
            else:
                setattr(obj, k, v)
        else:
            obj.extra[k] = v
    return obj


@dataclass
class MoEConfig:
    """MoE FFN config (defaults match the reference ``moe_conf``)."""

    num_experts: int = 4
    hidden_units: int = 1024
    dropout_rate: float = 0.0
    activation: str = "swish"
    capacity_factor: float = -1.0
    router_regularization: str = "l1_plus_importance"
    router_with_bias: bool = False
    keep_expert_output: bool = False
    rand_init_router: bool = False
    ln_before_router: bool = False
    detach_router_input: bool = False
    non_expert_dropout: float = 0.0
    rank: int = 0
    world_size: int = 1
    comm: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def total_experts(self) -> int:
        # a gathered checkpoint holds num_experts * world_size experts
        return self.num_experts * self.world_size


@dataclass
class EncoderConfig:
    """Conformer encoder config (defaults match the reference encoder)."""

    attention_heads: int = 4
    attention_dim: int = 256
    linear_units: int = 2048
    num_blocks: int = 6
    dropout_rate: float = 0.1
    positional_dropout_rate: float = 0.1
    attention_dropout_rate: float = 0.0
    input_layer: str = "conv2d"
    pos_enc_layer_type: str = "rel_pos"
    normalize_before: bool = True
    concat_after: bool = False
    static_chunk_size: int = 0
    use_dynamic_chunk: bool = False
    use_dynamic_left_chunk: bool = False
    positionwise_conv_kernel_size: int = 1
    macaron_style: bool = True
    selfattention_layer_type: str = "rel_selfattn"
    activation_type: str = "swish"
    use_cnn_module: bool = True
    cnn_module_kernel: int = 15
    causal: bool = False
    cnn_module_norm: str = "batch_norm"
    conv_subsample_in_ch: int = 1
    output_dim_domain: int = 6
    output_dim_acc: int = 8
    subsampling_feat_norm: bool = False
    scan_unroll: int = 1
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def head_dim(self) -> int:
        if self.attention_dim % self.attention_heads:
            raise ValueError("attention_dim must divide by attention_heads")
        return self.attention_dim // self.attention_heads


def _default_embed_conf() -> EncoderConfig:
    return EncoderConfig(attention_heads=4, attention_dim=512,
                         linear_units=1024, num_blocks=6)


@dataclass
class MoEEncoderConfig(EncoderConfig):
    """The hier MoE conformer encoder: embed sub-encoder + MoE FFNs."""

    embed_conf: EncoderConfig = field(default_factory=_default_embed_conf)
    moe_conf: MoEConfig = field(default_factory=MoEConfig)
    exmarc: bool = False

    @property
    def embed_dim(self) -> int:
        return self.embed_conf.attention_dim


@dataclass
class DecoderConfig:
    """AED decoder config; carried so engine dirs round-trip, unused by
    the encoder-only inference path."""

    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 6
    r_num_blocks: int = 0
    dropout_rate: float = 0.1
    positional_dropout_rate: float = 0.1
    self_attention_dropout_rate: float = 0.0
    src_attention_dropout_rate: float = 0.0
    input_layer: str = "embed"
    use_output_layer: bool = True
    normalize_before: bool = True
    concat_after: bool = False
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ModelConfig:
    """Top-level model config."""

    nnet_proto: str = "conformer_aed_fmoe_localComm_catEmbed_domain_acc_hier"
    input_dim: int = 40
    output_dim: int = 9000
    encoder_conf: MoEEncoderConfig = field(default_factory=MoEEncoderConfig)
    decoder_type: str = "transformer"
    decoder_conf: DecoderConfig = field(default_factory=DecoderConfig)
    reverse_weight: float = 0.0
    padding_idx: Optional[int] = None
    extra: Dict[str, Any] = field(default_factory=dict)


# nnet_proto values of the hier MoE conformer family
MOE_HIER_PROTOS = {
    "conformer_aed_fmoe_localComm_catEmbed_domain_acc_hier",
    "conformer_fmoe_localComm_catEmbed_domain_acc_hier",
    "conformer_aed_fmoe_localComm_catEmbed_domain_acc",
    "conformer_aed_fmoe_localComm_catEmbed",
    "conformer_fmoe_localComm_catEmbed_domain_acc",
    "conformer_fmoe_localComm_catEmbed",
}


def model_config_from_dict(configs: Dict[str, Any]) -> ModelConfig:
    """Build a :class:`ModelConfig` from a reference-format config dict."""
    cfg = ModelConfig()
    cfg.nnet_proto = configs.get("nnet_proto", cfg.nnet_proto)
    if cfg.nnet_proto not in MOE_HIER_PROTOS:
        raise NotImplementedError(
            f"nnet_proto {cfg.nnet_proto!r}: the PyTorch port serves the "
            "hier MoE conformer family only (ROADMAP Queue 1 item 10 brings "
            "the dense conformer, AED and DFSMN families)")
    cfg.input_dim = configs.get("input_dim", cfg.input_dim)
    cfg.output_dim = configs.get("output_dim", cfg.output_dim)
    model_conf = dict(configs.get("model_conf") or {})
    # AED wrappers nest the encoder conf; bare encoders put encoder keys
    # directly in model_conf
    if "encoder_conf" in model_conf:
        enc = model_conf.pop("encoder_conf")
    else:
        enc = model_conf
        model_conf = {k: model_conf.get(k) for k in
                      ("decoder_type", "decoder_conf", "reverse_weight",
                       "padding_idx") if k in model_conf}
    enc = dict(enc or {})
    embed_conf = enc.pop("embed_conf", None)
    moe_conf = enc.pop("moe_conf", None)
    _update_from_dict(cfg.encoder_conf, enc)
    if embed_conf:
        _update_from_dict(cfg.encoder_conf.embed_conf, embed_conf)
    if moe_conf:
        _update_from_dict(cfg.encoder_conf.moe_conf, moe_conf)
    cfg.decoder_type = model_conf.get("decoder_type", cfg.decoder_type)
    if model_conf.get("decoder_conf"):
        _update_from_dict(cfg.decoder_conf, model_conf["decoder_conf"])
    cfg.reverse_weight = model_conf.get("reverse_weight", cfg.reverse_weight)
    cfg.padding_idx = model_conf.get("padding_idx", cfg.padding_idx)
    return cfg


def load_yaml_config(path: str, input_dim: int = 40) -> ModelConfig:
    """Load a reference-format YAML config (input_dim defaults to 40)."""
    import yaml
    with open(path, "r") as f:
        configs = yaml.safe_load(f)
    configs.setdefault("input_dim", input_dim)
    return model_config_from_dict(configs)


def model_config_to_dict(cfg: ModelConfig) -> dict:
    """Inverse of :func:`model_config_from_dict` (the engine dir's
    ``config.yaml`` when no raw YAML is at hand)."""
    def clean(dc):
        d = {}
        for f in dataclasses.fields(dc):
            v = getattr(dc, f.name)
            if f.name == "extra":
                d.update(v)
            elif dataclasses.is_dataclass(v):
                d[f.name] = clean(v)
            else:
                d[f.name] = v
        return d

    return {
        "nnet_proto": cfg.nnet_proto,
        "input_dim": cfg.input_dim,
        "output_dim": cfg.output_dim,
        "model_conf": {
            "encoder_conf": clean(cfg.encoder_conf),
            "decoder_type": cfg.decoder_type,
            "decoder_conf": clean(cfg.decoder_conf),
            "reverse_weight": cfg.reverse_weight,
            "padding_idx": cfg.padding_idx,
        },
    }
