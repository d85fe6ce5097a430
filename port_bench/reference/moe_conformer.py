"""Plain float32 reference of the 3M-ASR hier MoE conformer (catEmbed
router), written from the model's equations:

    embed = after_norm(dense conformer encoder(feat))       # 6 blocks
    x = Conv2dSubsampling4(feat) * sqrt(d); pos = pe[:T']
    for each MoE block:
        x += 0.5 * ffn(LN(x))                                # macaron
        x += rel_mha(LN(x), pos)                             # Transformer-XL
        x += conv_module(LN(x))                              # GLU, depthwise 15
        x += 0.5 * top1_moe(LN(x), router sees cat[embed, LN(x)])
        x = LN(x)
    logits = out_linear(after_norm(x))

One utterance at a time, at its own length (no padding), every product
in float32 (or, for the control, on operands rounded by
:class:`~port_bench.reference.common.Precision`). The routing is worked
out here, from the same weights and features.

:func:`layout` gives the parameter tree (paths, shapes and how the
benchmark draws each leaf), in the layout the port's engine reads.
"""

from __future__ import annotations

import math

import torch

from port_bench.reference.common import (Precision, depthwise, layer_norm,
                                         linear, swish, top1_experts)

LN_EPS = 1e-12
PE_ROWS = 5000


def _enc(model):
    return model["model_conf"]["encoder_conf"]


def num_experts(model) -> int:
    return _enc(model)["moe_conf"]["num_experts"]


def check_supported(model) -> None:
    """The equations above hold for this configuration's settings; any
    other setting raises."""
    enc = _enc(model)
    for conf in (enc, enc["embed_conf"]):
        want = {"input_layer": "conv2d", "pos_enc_layer_type": "rel_pos",
                "normalize_before": True, "macaron_style": True,
                "use_cnn_module": True, "cnn_module_norm": "batch_norm",
                "causal": False}
        bad = {k: conf.get(k) for k, v in want.items() if conf.get(k) != v}
        if bad:
            raise ValueError(f"the reference covers {want}; got {bad}")
    if enc["moe_conf"].get("router_with_bias"):
        raise ValueError("the reference's router has no bias")


# ---------------------------------------------------------------------------
# parameter layout: nested dicts of (shape, init); init is ("u", b):
# uniform in [-b, b], ("c", c, b): c + uniform in [-b, b], ("pe", d): the
# sinusoid table
# ---------------------------------------------------------------------------

def _lin(d_in, d_out, bias=True, lead=()):
    b = 1.0 / math.sqrt(d_in)
    p = {"kernel": (lead + (d_in, d_out), ("u", b))}
    if bias:
        p["bias"] = (lead + (d_out,), ("u", b))
    return p


def _norm(d, lead=()):
    return {"scale": (lead + (d,), ("c", 1.0, 0.1)),
            "bias": (lead + (d,), ("u", 0.1))}


def _subsampling(idim, d):
    f_out = ((idim - 1) // 2 - 1) // 2
    return {"conv0": {"kernel": ((3, 3, 1, d), ("u", 1 / 3.0)),
                      "bias": ((d,), ("u", 1 / 3.0))},
            "conv1": {"kernel": ((3, 3, d, d), ("u", 1 / math.sqrt(9 * d))),
                      "bias": ((d,), ("u", 1 / math.sqrt(9 * d)))},
            "out": _lin(d * f_out, d)}


def _block(L, d, heads, ffn, kernel, moe=None):
    lead = (L,)
    dk = d // heads
    xb = math.sqrt(6.0 / (heads + dk))
    attn = {n: _lin(d, d, lead=lead)
            for n in ("linear_q", "linear_k", "linear_v", "linear_out")}
    attn["linear_pos"] = _lin(d, d, bias=False, lead=lead)
    attn["pos_bias_u"] = (lead + (heads, dk), ("u", xb))
    attn["pos_bias_v"] = (lead + (heads, dk), ("u", xb))
    p = {"norm_mha": _norm(d, lead), "self_attn": attn,
         "norm_ff": _norm(d, lead), "norm_ff_macaron": _norm(d, lead),
         "feed_forward_macaron": {"w_1": _lin(d, ffn, lead=lead),
                                  "w_2": _lin(ffn, d, lead=lead)},
         "norm_conv": _norm(d, lead),
         "conv_module": {
             "pointwise_conv1": _lin(d, 2 * d, lead=lead),
             "depthwise_conv": {
                 "kernel": (lead + (kernel, d), ("u", 1 / math.sqrt(kernel))),
                 "bias": (lead + (d,), ("u", 0.1))},
             "norm": _norm(d, lead),
             "pointwise_conv2": _lin(d, d, lead=lead)},
         "norm_final": _norm(d, lead)}
    if moe is None:
        p["feed_forward"] = {"w_1": _lin(d, ffn, lead=lead),
                             "w_2": _lin(ffn, d, lead=lead)}
    else:
        d_embed, E, h = moe
        xe = 0.5 * math.sqrt(6.0 / (d + h))
        # router logits of std 0.5 * sqrt(d_r) on unit-norm features, so
        # that every expert gets tokens
        p["feed_forward"] = {
            "router": {"kernel": (lead + (d_embed + d, E),
                                  ("u", 0.5 * math.sqrt(3.0)))},
            "w1": (lead + (E, d, h), ("u", xe)),
            "b1": (lead + (E, h), ("u", 0.05)),
            "w2": (lead + (E, h, d), ("u", xe)),
            "b2": (lead + (E, d), ("u", 0.05))}
    return p


def _dense_encoder(conf, idim, odim):
    d = conf["attention_dim"]
    return {"subsampling": _subsampling(idim, d),
            "pos_enc": {"pe": ((PE_ROWS, d), ("pe", d))},
            "after_norm": _norm(d), "out_linear": _lin(d, odim)}


def layout(model):
    check_supported(model)
    enc = _enc(model)
    emb = enc["embed_conf"]
    idim, odim = model["input_dim"], model["output_dim"]
    p = _dense_encoder(enc, idim, odim)
    p["embed"] = _dense_encoder(emb, idim, odim)
    p["embed"]["blocks"] = _block(
        emb["num_blocks"], emb["attention_dim"], emb["attention_heads"],
        emb["linear_units"], emb["cnn_module_kernel"])
    d = enc["attention_dim"]
    moe = enc["moe_conf"]
    p["blocks"] = _block(
        enc["num_blocks"], d, enc["attention_heads"], moe["hidden_units"],
        enc["cnn_module_kernel"],
        moe=(emb["attention_dim"], moe["num_experts"], moe["hidden_units"]))
    p["after_norm_6"] = _norm(d)
    p["after_norm_12"] = _norm(d)
    return p


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def sub4_len(n: int) -> int:
    return ((n - 1) // 2 - 1) // 2


def _subsample(p, feat, prec):
    """Two (3x3, stride 2) ReLU convs, the per-frame flatten in (C, F')
    order, then a linear: feat (1, T, F) -> (1, T', d)."""
    h = feat[:, None]
    for name in ("conv0", "conv1"):
        w = p[name]["kernel"].permute(3, 2, 0, 1)          # HWIO -> OIHW
        h = torch.relu(torch.nn.functional.conv2d(
            prec.q(h), prec.q(w), p[name]["bias"].float(), stride=2))
    B, C, T, Fp = h.shape
    return linear(p["out"], h.permute(0, 2, 1, 3).reshape(B, T, C * Fp),
                  prec)


def _heads(t, h):
    B, T, D = t.shape
    return t.reshape(B, T, h, D // h).transpose(1, 2)


def _attention(p, x, pos, heads, prec):
    """Rel-pos self-attention of x's rows; ``pos`` holds the positional
    rows (T, d)."""
    q = _heads(linear(p["linear_q"], x, prec), heads)
    k = _heads(linear(p["linear_k"], x, prec), heads)
    v = _heads(linear(p["linear_v"], x, prec), heads)
    pp = _heads(linear(p["linear_pos"], pos[None], prec), heads)[0]
    u = p["pos_bias_u"].float()[None, :, None, :]
    w = p["pos_bias_v"].float()[None, :, None, :]
    dk = q.shape[-1]
    s = torch.matmul(prec.q(q + u), prec.q(k).transpose(-1, -2)) \
        + torch.matmul(prec.q(q + w), prec.q(pp).transpose(-1, -2))
    a = torch.softmax(s / math.sqrt(dk), dim=-1)
    ctx = torch.matmul(prec.q(a), prec.q(v))
    B, _, T, _ = ctx.shape
    return linear(p["linear_out"], ctx.transpose(1, 2).reshape(B, T, -1),
                  prec)


def _ffn(p, x, prec):
    return linear(p["w_2"], swish(linear(p["w_1"], x, prec)), prec)


def _conv_module(p, x, prec):
    """GLU, depthwise conv over (K-1)/2 zero frames on both sides, the
    folded batch norm, swish, pointwise."""
    K = p["depthwise_conv"]["kernel"].shape[0]
    h = linear(p["pointwise_conv1"], x, prec)
    a, b = torch.chunk(h, 2, dim=-1)
    h = a * torch.sigmoid(b)
    h = depthwise(h, p["depthwise_conv"]["kernel"],
                  p["depthwise_conv"]["bias"], (K - 1) // 2, (K - 1) // 2,
                  prec)
    h = h * p["norm"]["scale"].float() + p["norm"]["bias"].float()
    return linear(p["pointwise_conv2"], swish(h), prec)


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _block_fwd(p, x, pos, heads, prec, embed=None, routes=None):
    """One conformer block."""
    x = x + 0.5 * _ffn(p["feed_forward_macaron"],
                       layer_norm(p["norm_ff_macaron"], x, LN_EPS), prec)
    x = x + _attention(p["self_attn"], layer_norm(p["norm_mha"], x, LN_EPS),
                       pos, heads, prec)
    x = x + _conv_module(p["conv_module"],
                         layer_norm(p["norm_conv"], x, LN_EPS), prec)
    h = layer_norm(p["norm_ff"], x, LN_EPS)
    if embed is None:
        y = _ffn(p["feed_forward"], h, prec)
    else:
        B, T, d = h.shape
        y, idx = top1_experts(p["feed_forward"], h.reshape(-1, d),
                              torch.cat([embed, h], -1).reshape(B * T, -1),
                              prec, swish)
        y = y.reshape(B, T, d)
        if routes is not None:
            routes.append(idx)
    x = x + 0.5 * y
    return layer_norm(p["norm_final"], x, LN_EPS)


def _encoder(p, conf, feat, prec, embed=None, routes=None):
    d = conf["attention_dim"]
    x = _subsample(p["subsampling"], feat, prec) * math.sqrt(d)
    pos = p["pos_enc"]["pe"].float()[:x.shape[1]]
    for i in range(conf["num_blocks"]):
        x = _block_fwd(_layer(p["blocks"], i), x, pos,
                       conf["attention_heads"], prec, embed, routes)
    return layer_norm(p["after_norm"], x, LN_EPS)


def forward(params, model, feat: torch.Tensor, prec: Precision = None,
            routes=None):
    """feat (T, input_dim) of one utterance -> logits (sub4(T), V)
    float32. ``routes``: a list that gets each MoE block's expert index
    per frame."""
    prec = prec or Precision()
    enc = _enc(model)
    feat = feat.float()[None]
    embed = _encoder(params["embed"], enc["embed_conf"], feat, prec)
    x = _encoder(params, enc, feat, prec, embed=embed, routes=routes)
    return linear(params["out_linear"], x, prec)[0]
