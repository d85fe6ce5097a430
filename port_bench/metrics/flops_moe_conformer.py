"""Operation counts of the hier MoE conformer (2 per multiply-add), from
the configuration's shapes: what the logits need, at valid lengths.
The embed encoder's own output layer is left out: the logits do not
need it."""

from __future__ import annotations


def _enc(model):
    return model["model_conf"]["encoder_conf"]


def sub4(n: int) -> int:
    return ((n - 1) // 2 - 1) // 2


def tokens(model, frames: int) -> int:
    return sub4(frames)


def _subsampling(idim, d, T):
    t1, f1 = (T - 1) // 2, (idim - 1) // 2
    t2, f2 = sub4(T), (f1 - 1) // 2
    return 2 * t1 * f1 * d * 9 + 2 * t2 * f2 * d * d * 9 + 2 * t2 * f2 * d * d


def _block(d, heads, ffn, kernel, n, moe=None):
    """One block on n frames."""
    f = 2 * n * 2 * d * ffn                          # macaron FFN
    f += 4 * 2 * n * d * d + 2 * n * d * d           # q, k, v, out; pos
    f += 2 * 2 * n * n * d + 2 * n * n * d           # ac + bd, PV
    f += 2 * n * d * 2 * d + 2 * n * d * kernel + 2 * n * d * d
    if moe is None:
        f += 2 * n * 2 * d * ffn
    else:
        d_embed, E, h = moe
        f += 2 * n * (d_embed + d) * E + 2 * n * 2 * d * h
    return f


def _encoder(conf, idim, frames, moe=None):
    d = conf["attention_dim"]
    return _subsampling(idim, d, frames) + conf["num_blocks"] * _block(
        d, conf["attention_heads"],
        moe[2] if moe else conf["linear_units"], conf["cnn_module_kernel"],
        sub4(frames), moe)


def utterance(model, frames: int) -> int:
    """The forward of one utterance of ``frames`` feature frames."""
    enc, idim = _enc(model), model["input_dim"]
    emb, moe = enc["embed_conf"], enc["moe_conf"]
    f = _encoder(emb, idim, frames)
    f += _encoder(enc, idim, frames, moe=(
        emb["attention_dim"], moe["num_experts"], moe["hidden_units"]))
    return f + 2 * sub4(frames) * enc["attention_dim"] * model["output_dim"]


def k1_layers(model):
    """(MoE layers a forward, d, h, experts)."""
    enc = _enc(model)
    moe = enc["moe_conf"]
    return (enc["num_blocks"], enc["attention_dim"], moe["hidden_units"],
            moe["num_experts"])


def k2_layers(model):
    """Each K2 call of a forward: (heads, dk) of its rel-pos
    attention."""
    enc = _enc(model)
    out = []
    for conf in (enc["embed_conf"], enc):
        h = conf["attention_heads"]
        out += [(h, conf["attention_dim"] // h)] * conf["num_blocks"]
    return out
