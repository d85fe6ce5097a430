"""The port's model families: nnet_proto -> (init, forward, convert)
(port of ``m3asr_tpu/models/registry.py``).

* ``moe_conformer``: the hier MoE conformer protos (``MOE_HIER_PROTOS``);
* ``dfsmn``: dfsmn_base_res and the dfsmn_san_res protos;
* ``dfsmn_moe``: the dfsmn_*_fmoe_localComm_catEmbed protos;
* ``conformer``: the dense conformer protos (``DENSE_CONFORMER_PROTOS``).

A family's ``forward(params, model_cfg, feat, feat_len, **kw)`` keeps the
JAX family's contract with the engine: ``moe_impl`` and ``attn_impl``,
and ``return_hidden`` (MoE families) or ``output_embed`` (dense ones) for
the pre-out_linear hidden, returned after (out, lengths);
``dfsmn_base_res`` has no hidden and refuses one, and the domain/accent
proto returns its pooled heads with ``domain_acc``. ``init(model_cfg,
generator, dtype)`` draws seeded random parameters on the generator's
device; ``convert(state_dict, model_cfg)`` is the checkpoint converter
(a numpy tree).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from m3asr_tpu_torch.config import (DENSE_CONFORMER_PROTOS, DFSMN_PROTOS,
                                    MOE_HIER_PROTOS, DfsmnEncoderConfig,
                                    ModelConfig)


@dataclasses.dataclass(frozen=True)
class ModelFamily:
    name: str
    init: Callable        # (model_cfg, generator, dtype) -> params
    forward: Callable     # (params, model_cfg, feat, feat_len, **kw)
    convert: Callable     # (state_dict, model_cfg) -> numpy params


def _moe_family() -> ModelFamily:
    from m3asr_tpu_torch import checkpoint as ckpt
    from m3asr_tpu_torch.models import moe_conformer

    def init(mc, generator, dtype=torch.float32):
        return moe_conformer.init(mc.encoder_conf, mc.input_dim,
                                  mc.output_dim, generator,
                                  device=generator.device, dtype=dtype)

    def convert(sd, mc):
        s = ckpt.StateDict(sd)
        if any(k.startswith("encoder.") for k in sd):
            s = s.sub("encoder")
        return ckpt.convert_moe_encoder(s, mc.encoder_conf)

    return ModelFamily(
        name="moe_conformer", init=init,
        forward=lambda p, mc, feat, feat_len, **kw: moe_conformer.forward(
            p, mc.encoder_conf, feat, feat_len, **kw),
        convert=convert)


def dfsmn_enc_conf(mc: ModelConfig) -> DfsmnEncoderConfig:
    ec = mc.encoder_conf
    if not isinstance(ec, DfsmnEncoderConfig):
        raise TypeError(f"{mc.nnet_proto}: the encoder config is not a "
                        "DfsmnEncoderConfig")
    return ec


def dfsmn_san_config(e: DfsmnEncoderConfig):
    from m3asr_tpu_torch.models import dfsmn
    return dfsmn.DfsmnSanConfig(
        num_block=e.num_block, fsmn_each_block=e.fsmn_each_block,
        hidden_dim=e.hidden_dim, memory_dim=e.memory_dim,
        look_back=e.look_back, look_ahead=e.look_ahead,
        stride_left=e.stride_left, stride_right=e.stride_right,
        num_head=e.num_head, num_memory=e.num_memory,
        norm_type=e.norm_type)


def dfsmn_embed_config(e: DfsmnEncoderConfig):
    """The embed sub-net's config: the reference embed_conf defaults,
    updated from ``embed_conf``."""
    from m3asr_tpu_torch.models import dfsmn
    c = dfsmn.DfsmnSanConfig()
    for k, v in (e.embed_conf or {}).items():
        if hasattr(c, k):
            setattr(c, k, v)
    return c


def dfsmn_moe_config(e: DfsmnEncoderConfig):
    from m3asr_tpu_torch.models import dfsmn
    emb = dfsmn_embed_config(e)
    return dfsmn.DfsmnSanMoEConfig(
        **dataclasses.asdict(dfsmn_san_config(e)),
        num_experts=e.moe_conf.total_experts, embed_dim=emb.memory_dim,
        ln_before_router=e.moe_conf.ln_before_router,
        keep_expert_output=e.moe_conf.keep_expert_output, embed_conf=emb)


def dfsmn_base_config(e: DfsmnEncoderConfig):
    from m3asr_tpu_torch.models import dfsmn
    return dfsmn.DfsmnBaseConfig(
        fsmn_layers=e.fsmn_layers, hidden_dim=e.hidden_dim,
        memory_dim=e.memory_dim, look_back=e.look_back,
        look_ahead=e.look_ahead, stride_left=e.stride_left,
        stride_right=e.stride_right)


def dfsmn_stream_config(mc: ModelConfig):
    """The models.dfsmn config a streaming session needs: DfsmnSanMoEConfig
    (its embed_conf filled in) for the MoE family, DfsmnSanConfig
    otherwise. dfsmn_base_res has no stream forward (no blocks): it
    raises ValueError here, where the JAX server fails at the first
    chunk."""
    e = dfsmn_enc_conf(mc)
    if mc.nnet_proto == "dfsmn_base_res":
        raise ValueError(f"{mc.nnet_proto}: the plain cFSMN stack has no "
                         "stream forward (models/dfsmn_streaming.py streams "
                         "the san nets)")
    return (dfsmn_moe_config(e) if "fmoe" in mc.nnet_proto
            else dfsmn_san_config(e))


def _dfsmn_family(nnet_proto: str) -> ModelFamily:
    from m3asr_tpu_torch import checkpoint as ckpt
    from m3asr_tpu_torch.models import dfsmn

    is_moe = "fmoe" in nnet_proto
    is_base = nnet_proto == "dfsmn_base_res"
    is_domain_acc = nnet_proto == "dfsmn_san_res_embed_domain_acc"

    def forward(p, mc, feat, feat_len, **kw):
        e = dfsmn_enc_conf(mc)
        attn_impl = kw.get("attn_impl", "xla")
        # the engine asks for the hidden as "return_hidden" on MoE
        # families and "output_embed" on dense ones
        want_hidden = bool(kw.get("return_hidden") or kw.get("output_embed"))
        if is_moe:
            res = dfsmn.dfsmn_san_moe_forward(
                p, dfsmn_moe_config(e), feat, feat_len,
                moe_impl=kw.get("moe_impl", "dense"), attn_impl=attn_impl,
                return_hidden=want_hidden)
            if want_hidden:
                out, _, lens, hid = res
                return out, lens, hid
            return res[0], res[2]
        if is_base:
            if want_hidden:
                raise ValueError(
                    "return_hidden is not supported for dfsmn_base_res: the "
                    "plain cFSMN stack has no hidden tap")
            return dfsmn.dfsmn_base_forward(p, dfsmn_base_config(e), feat,
                                            feat_len)
        if is_domain_acc:
            res = dfsmn.dfsmn_san_domain_acc_forward(
                p, dfsmn_san_config(e), feat, feat_len,
                output_embed=want_hidden, attn_impl=attn_impl)
            if want_hidden:
                out, pool, pool_acc, x_cat_2, lens = res
                if kw.get("domain_acc"):
                    return out, lens, x_cat_2, pool, pool_acc
                return out, lens, x_cat_2
            out, pool, pool_acc, lens = res
            if kw.get("domain_acc"):
                return out, lens, pool, pool_acc
            return out, lens
        if want_hidden:
            out, hid, lens = dfsmn.dfsmn_san_forward(
                p, dfsmn_san_config(e), feat, feat_len, output_embed=True,
                attn_impl=attn_impl)
            return out, lens, hid
        return dfsmn.dfsmn_san_forward(p, dfsmn_san_config(e), feat,
                                       feat_len, attn_impl=attn_impl)

    def convert(sd, mc):
        e = dfsmn_enc_conf(mc)
        s = ckpt.StateDict(sd)
        if any(k.startswith("encoder.") for k in sd):
            s = s.sub("encoder")
        if is_moe:
            emb = dfsmn_embed_config(e)
            return ckpt.convert_dfsmn_san_moe(
                s, e.num_block, e.fsmn_each_block, emb.num_block,
                emb.fsmn_each_block, e.norm_type)
        if is_base:
            return ckpt.convert_dfsmn_base(s, e.fsmn_layers)
        if is_domain_acc:
            return ckpt.convert_dfsmn_san_domain_acc(
                s, e.num_block, e.fsmn_each_block, e.norm_type)
        return ckpt.convert_dfsmn_san(s, e.num_block, e.fsmn_each_block,
                                      e.norm_type)

    def init(mc, generator, dtype=torch.float32):
        e = dfsmn_enc_conf(mc)
        if is_moe:
            return dfsmn.init_dfsmn_san_moe(
                generator, dfsmn_moe_config(e), mc.input_dim, mc.output_dim,
                rand_init_router=e.moe_conf.rand_init_router, dtype=dtype)
        if is_base:
            return dfsmn.init_dfsmn_base(generator, dfsmn_base_config(e),
                                         mc.input_dim, mc.output_dim, dtype)
        if is_domain_acc:
            return dfsmn.init_dfsmn_san_domain_acc(
                generator, dfsmn_san_config(e), mc.input_dim, mc.output_dim,
                e.output_dim_domain, e.output_dim_acc, dtype)
        return dfsmn.init_dfsmn_san(generator, dfsmn_san_config(e),
                                    mc.input_dim, mc.output_dim, dtype)

    return ModelFamily(name="dfsmn_moe" if is_moe else "dfsmn", init=init,
                       forward=forward, convert=convert)


def _conformer_family() -> ModelFamily:
    """The dense conformer protos (and the AED wrappers' encoder): the
    forward takes the JAX family's ``output_embed`` and ``attn_impl`` and
    ignores the rest (an engine's ``moe_impl``: no experts)."""
    from m3asr_tpu_torch import checkpoint as ckpt
    from m3asr_tpu_torch.models import conformer

    def convert(sd, mc):
        s = ckpt.StateDict(sd)
        if any(k.startswith("encoder.") for k in sd):
            s = s.sub("encoder")
        return ckpt.convert_dense_encoder(s, mc.encoder_conf)

    return ModelFamily(
        name="conformer",
        init=lambda mc, generator, dtype=torch.float32: conformer.init(
            mc.encoder_conf, mc.input_dim, mc.output_dim, generator, dtype),
        forward=lambda p, mc, feat, feat_len, **kw: conformer.forward(
            p, mc.encoder_conf, feat, feat_len,
            **{k: v for k, v in kw.items()
               if k in ("output_embed", "attn_impl")}),
        convert=convert)


def get_family(nnet_proto: str) -> ModelFamily:
    """The family of ``nnet_proto``, resolved as the JAX package resolves
    it (a name outside the tables goes by its parts); KeyError for an
    unknown proto."""
    if nnet_proto in MOE_HIER_PROTOS or ("fmoe" in nnet_proto
                                         and "dfsmn" not in nnet_proto):
        return _moe_family()
    if nnet_proto in DFSMN_PROTOS or nnet_proto.startswith("dfsmn"):
        return _dfsmn_family(nnet_proto)
    if nnet_proto in DENSE_CONFORMER_PROTOS or "conformer" in nnet_proto:
        return _conformer_family()
    raise KeyError(f"unknown nnet_proto: {nnet_proto}")
