"""The flagship hier MoE conformer with the catEmbed router (port of
``m3asr_tpu/models/moe_conformer.py``, the forward of inference and of
the CTC training step):

    embed_out, _, embed = embed_encoder(feat, feat_len)   # dense blocks
    x, x_len = Conv2dSubsampling4(feat, feat_len)         # own stack
    x, pos_emb = RelPositionalEncoding(x)
    for each MoE block: x = conformer_block(x, router sees cat[embed, x])
    out = out_linear(after_norm(x))

The block loop walks per-layer views of the stacked ``(L, ...)``
parameters; the expert weights ``(L, E, d, h)`` are indexed, not copied.
Under an ep/tp mesh (``parallel/mesh.sharded``) the MoE blocks hold this
rank's shard and reduce across ranks; the embed sub-encoder stays
replicated and runs outside the mesh.
The ExMarc protos (``cfg.exmarc``) make each block's macaron FFN a MoE
FFN as well: two expert stacks per block, each indexed the same way.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.utils.checkpoint

from m3asr_tpu_torch.config import EncoderConfig, MoEEncoderConfig
from m3asr_tpu_torch.models import conformer
from m3asr_tpu_torch.models.layers import conformer_block
from m3asr_tpu_torch.ops import positional
from m3asr_tpu_torch.ops.common import (init_layer_norm, init_linear,
                                        layer_norm, linear)
from m3asr_tpu_torch.ops.moe import init_moe_ffn
from m3asr_tpu_torch.parallel import mesh as pmesh
from m3asr_tpu_torch.parallel import pp as ppipe
from m3asr_tpu_torch.parallel import sp as psp


def forward(params, cfg: MoEEncoderConfig, feat: torch.Tensor,
            feat_len: Optional[torch.Tensor], output_embed: bool = False,
            moe_impl: str = "dense", hier_taps: bool = False,
            chunk_mask=None, embed_chunk_mask="same",
            return_hidden: bool = False, attn_impl: str = "xla",
            return_router_probs: bool = False, remat: bool = False,
            return_embed_hidden: bool = False):
    """feat: (B, T, input_dim) -> (logits (B, T', V), out_len)
    | + embed_out (output_embed) | + (h6, h12, h_final) (hier_taps: the
    hidden after blocks 6 and 12, clamped for shallow models, through
    after_norm_6 / after_norm_12, and the normalized final hidden) |
    + router probs (return_router_probs: (L, B, T', E) float32, each
    block's final FFN router only) | + h_final (return_hidden) | + the
    embed encoder's hidden before the routers' detach
    (return_embed_hidden: the domain/accent heads train through it), in
    the JAX package's order.

    chunk_mask: optional (B|1, 1, T', T') attend-mask of the MoE blocks;
    embed_chunk_mask: the embed encoder's own ("same": chunk_mask's).
    attn_impl: "xla" or "flash" for every attention layer. remat: each
    MoE block's activations are recomputed in the backward
    (``torch.utils.checkpoint``, as ``jax.checkpoint`` per block), so its
    forward runs twice in a training step; the embed encoder has none.

    Under a mesh (``parallel/mesh.sharded``) with "sp" the blocks run on
    this rank's rows (``parallel/sp.py``), and with "pp" as a GPipe
    pipeline over this stage's blocks (``parallel/pp.py``: the
    ``pp.microbatches`` count; not with hier_taps or
    return_router_probs)."""
    if isinstance(embed_chunk_mask, str) and embed_chunk_mask == "same":
        embed_chunk_mask = chunk_mask
    with pmesh.sharded(None):     # the embed sub-encoder is replicated
        embed_out, _, embed = conformer.forward(
            params["embed"], cfg.embed_conf, feat, feat_len,
            output_embed=True, chunk_mask=embed_chunk_mask,
            attn_impl=attn_impl)
    embed_hidden = embed
    # the router input never backprops into the embed encoder: it trains
    # only through its own CTC head (jax.lax.stop_gradient in the JAX
    # package)
    embed = embed.detach()
    x, pos_emb, out_len = conformer.frontend(params, cfg, feat, feat_len)
    kw = conformer.block_kwargs(cfg)
    blocks = params["blocks"]
    n_layers = conformer.num_layers(blocks)
    mesh = pmesh.active_mesh()
    # sequence parallelism: the blocks run on this rank's rows
    sp_mesh = psp.active()
    if sp_mesh is not None:
        x, pos_emb, embed, chunk_mask, T = psp.split(
            sp_mesh, x, pos_emb, embed, chunk_mask)
    hiddens, probs = {}, []
    if mesh is not None and mesh.shape[pmesh.PIPE_AXIS] > 1:
        # GPipe over "pp": this stage's blocks (parallel/pp.py)
        if hier_taps or return_router_probs:
            raise ValueError(
                "pipeline parallelism runs the non-hier recipes without "
                "router-prob outputs (the hier taps need every block's "
                "hidden on one stage)")

        def block_fn(p, h, lengths, emb, mask, pos):
            return conformer_block(p, h, lengths, pos, moe=True, embed=emb,
                                   moe_impl=moe_impl, moe_macaron=cfg.exmarc,
                                   mask=mask, attn_impl=attn_impl, **kw)
        x = ppipe.pipeline_blocks(mesh, block_fn, blocks, x, out_len,
                                  pos_emb, embed=embed, mask=chunk_mask,
                                  remat=remat)
        n_layers = 0
    # taps after blocks 6 and 12 (1-indexed), clamped for shallow models;
    # no other block's hidden is kept
    taps = {min(5, n_layers - 1), min(11, n_layers - 1)} if hier_taps \
        else set()

    def block(p, h):
        return conformer_block(p, h, out_len, pos_emb, moe=True,
                               embed=embed, moe_impl=moe_impl,
                               moe_macaron=cfg.exmarc, mask=chunk_mask,
                               return_moe_aux=return_router_probs,
                               attn_impl=attn_impl, **kw)

    for i in range(n_layers):
        p_i = conformer.layer_view(blocks, i)
        if remat:
            x = torch.utils.checkpoint.checkpoint(block, p_i, x,
                                                  use_reentrant=False)
        else:
            x = block(p_i, x)
        if return_router_probs:
            x, p_i = x
            probs.append(p_i)
        if i in taps:
            hiddens[i] = x
    if sp_mesh is not None:
        x = psp.join(sp_mesh, x, T)
        hiddens = {i: psp.join(sp_mesh, h, T) for i, h in hiddens.items()}
        probs = [psp.join(sp_mesh, p, T) for p in probs]
    x_normed = layer_norm(params["after_norm"], x) if cfg.normalize_before \
        else x
    ret = [linear(params["out_linear"], x_normed), out_len]
    if output_embed:
        ret.append(embed_out)
    if hier_taps:
        ret += [layer_norm(params["after_norm_6"],
                           hiddens[min(5, n_layers - 1)]),
                layer_norm(params["after_norm_12"],
                           hiddens[min(11, n_layers - 1)]),
                x_normed]
    if return_router_probs:
        ret.append(torch.stack(probs))
    if return_hidden:
        ret.append(x_normed)
    if return_embed_hidden:
        ret.append(embed_hidden)
    return tuple(ret)


# ---------------------------------------------------------------------------
# synthetic weights (random, from a torch.Generator), with the JAX tree's
# paths and shapes
# ---------------------------------------------------------------------------

class _Init:
    def __init__(self, generator: torch.Generator, device, dtype):
        self.g, self.device, self.dtype = generator, device, dtype

    def uniform(self, shape, bound):
        u = torch.rand(shape, generator=self.g, device=self.device)
        return ((u * 2 - 1) * bound).to(self.dtype)

    def zeros(self, shape):
        return torch.zeros(shape, device=self.device, dtype=self.dtype)

    def linear(self, d_in, d_out, bias=True):
        return init_linear(self.g, d_in, d_out, bias, self.dtype)

    def norm(self, d):
        return init_layer_norm(d, self.device, self.dtype)

    def subsampling4(self, idim, odim, in_ch):
        f_out = ((idim - 1) // 2 - 1) // 2

        def conv(cin):
            b = 1.0 / math.sqrt(cin * 9)
            return {"kernel": self.uniform((3, 3, cin, odim), b),
                    "bias": self.uniform((odim,), b)}
        return {"conv0": conv(in_ch), "conv1": conv(odim),
                "out": self.linear(odim * f_out, odim)}

    def block(self, d, heads, ffn_hidden, kernel, moe=None,
              moe_macaron=False):
        dk = d // heads
        xb = math.sqrt(6.0 / (heads + dk))
        attn = {n: self.linear(d, d) for n in
                ("linear_q", "linear_k", "linear_v", "linear_out")}
        attn["linear_pos"] = self.linear(d, d, bias=False)
        attn["pos_bias_u"] = self.uniform((heads, dk), xb)
        attn["pos_bias_v"] = self.uniform((heads, dk), xb)
        p = {
            "norm_mha": self.norm(d), "self_attn": attn,
            "norm_ff": self.norm(d), "norm_ff_macaron": self.norm(d),
            "feed_forward_macaron": (
                init_moe_ffn(self.g, d, *moe, self.dtype) if moe_macaron else
                {"w_1": self.linear(d, ffn_hidden),
                 "w_2": self.linear(ffn_hidden, d)}),
            "norm_conv": self.norm(d),
            "conv_module": {
                "pointwise_conv1": {
                    "kernel": self.uniform((d, 2 * d), 1 / math.sqrt(d)),
                    "bias": self.zeros((2 * d,))},
                "depthwise_conv": {
                    "kernel": self.uniform((kernel, d),
                                           1 / math.sqrt(kernel)),
                    "bias": self.zeros((d,))},
                "norm": self.norm(d),
                "pointwise_conv2": {
                    "kernel": self.uniform((d, d), 1 / math.sqrt(d)),
                    "bias": self.zeros((d,))}},
            "norm_final": self.norm(d),
        }
        if moe is None:
            p["feed_forward"] = {"w_1": self.linear(d, ffn_hidden),
                                 "w_2": self.linear(ffn_hidden, d)}
        else:
            p["feed_forward"] = init_moe_ffn(self.g, d, *moe, self.dtype)
        return p

    def stacked(self, n, make):
        blocks = [make() for _ in range(n)]

        def stack(*xs):
            if isinstance(xs[0], dict):
                return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
            return torch.stack(xs)
        return stack(*blocks)

    def dense_encoder(self, cfg: EncoderConfig, input_dim, output_dim):
        d = cfg.attention_dim
        return {
            "subsampling": self.subsampling4(
                input_dim // cfg.conv_subsample_in_ch, d,
                cfg.conv_subsample_in_ch),
            "pos_enc": {"pe": positional.sinusoid_table(
                d, dtype=self.dtype, device=self.device)},
            "after_norm": self.norm(d),
            "out_linear": self.linear(d, output_dim),
            "blocks": self.stacked(cfg.num_blocks, lambda: self.block(
                d, cfg.attention_heads, cfg.linear_units,
                cfg.cnn_module_kernel)),
        }


def init(cfg: MoEEncoderConfig, input_dim: int, output_dim: int,
         generator: torch.Generator, device=None,
         dtype: torch.dtype = torch.float32):
    """Random parameters for the hier MoE conformer, drawn on
    ``generator``'s device. Routers start at zero, as in the reference
    (every token then goes to expert 0): randomise them for real
    dispatch. ExMarc configs (``cfg.exmarc``) get a MoE macaron FFN in
    every MoE block."""
    ini = _Init(generator, device, dtype)
    d = cfg.attention_dim
    params = ini.dense_encoder(cfg, input_dim, output_dim)
    del params["blocks"]
    params["embed"] = ini.dense_encoder(cfg.embed_conf, input_dim,
                                        output_dim)
    moe = (cfg.embed_dim, cfg.moe_conf.total_experts,
           cfg.moe_conf.hidden_units, cfg.moe_conf.router_with_bias)
    params["blocks"] = ini.stacked(cfg.num_blocks, lambda: ini.block(
        d, cfg.attention_heads, cfg.moe_conf.hidden_units,
        cfg.cnn_module_kernel, moe=moe, moe_macaron=cfg.exmarc))
    params["after_norm_6"] = ini.norm(d)
    params["after_norm_12"] = ini.norm(d)
    return params
