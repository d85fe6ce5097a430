"""Training steps (port of ``m3asr_tpu/train/step.py``): the CTC / CE
step of every model family (:func:`make_train_step`: the hier MoE and
ExMarc conformers, the dense conformers, the DFSMN nets with the
in-model domain/accent heads of ``dfsmn_san_res_embed_domain_acc``) and
the deployed hier AED recipe of the MoE conformers
(:func:`make_hier_train_step`).

One step: the forward with the dense expert stage (every expert on every
token, as the JAX step trains), the loss in float32, gradients by
autograd with respect to every float leaf of the parameter tree, and the
optimizer (``lr_scheduler.Optimizer``). With ``attn_impl="flash"`` every
attention layer runs K2 forward and K3 backward (``ops/flash_attention``:
the conformers' rel-pos blocks, the DFSMN memory-slot attention; the
no_pos blocks' plain MHA has no flash path, as in the JAX package).
With ``compute_dtype="bfloat16"`` the forward and backward run on bf16
copies of the float32 master weights, and the gradients come back to
them in float32 through the casts. ``accum_steps`` splits the batch into
equal microbatches, each run forward and backward on its own, and takes
the means; ``remat`` recomputes each MoE block in the backward;
``spec_aug`` masks the features on the device first.

The step is functional, as the JAX one: it returns new parameters and
optimizer state and leaves its inputs as they were. A parameter the loss
does not reach (an embed encoder or sub-net, without an embed CTC weight
or the heads: the routers see its output detached) gets a zero gradient,
as ``jax.grad`` gives it. Random draws (SpecAugment, dynamic chunk sizes)
come from a CPU ``torch.Generator`` handed to the step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from m3asr_tpu_torch.checkpoint import flatten_tree, unflatten_tree
from m3asr_tpu_torch.config import (EXMARC_PROTOS, MOE_HIER_PROTOS,
                                    ModelConfig)
from m3asr_tpu_torch.device import resolve_device
from m3asr_tpu_torch.models import aed, conformer, dfsmn, moe_conformer
from m3asr_tpu_torch.models import registry
from m3asr_tpu_torch.ops import masking
from m3asr_tpu_torch.ops.common import init_linear, linear
from m3asr_tpu_torch.parallel import mesh as pmesh
from m3asr_tpu_torch.train import losses
from m3asr_tpu_torch.train.lr_scheduler import (Optimizer, build_optimizer,
                                                global_norm)

@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 1e-3
    warmup_steps: int = 25000
    weight_decay: float = 0.0
    grad_clip: float = 5.0
    ctc_weight: float = 1.0
    loss_type: str = "ctc"            # 'ctc' | 'ce' (frame-level CE on
                                      # alignment labels)
    padding_idx: int = -1             # ignored frame label in CE mode
    embed_ctc_weight: float = 0.0     # aux CTC on the embed encoder head
    router_l1_weight: float = 0.0     # read by the hier recipe only, as
    router_importance_weight: float = 0.0   # in the JAX package
    blank_idx: int = 0
    remat: bool = False               # per-block rematerialization
    ce_weight: float = 1e-5           # domain/accent head CE weight
    attn_impl: str = "xla"            # 'flash': K2 forward, K3 backward
    compute_dtype: str = "float32"    # 'bfloat16': bf16 compute over
                                      # float32 master weights
    spec_aug: bool = False            # SpecAugment on the device
    spec_aug_conf: Optional[dict] = None  # num_t_mask/num_f_mask/max_t/
                                          # max_f overrides
    accum_steps: int = 1              # equal microbatches per update


@dataclasses.dataclass
class HierTrainConfig(TrainConfig):
    """Weights of the deployed hier recipe:

        loss = [ctc_w*CTC + (1-ctc_w)*(AED + tap_w*AED_6 + tap_w*AED_12)]
               * loss_scale + embed_ctc_weight*CTC(embed) + ce_weight*heads
               + router aux

    ``loss_scale`` (1e-4) multiplies the CTC + AED sum before the embed,
    head and router terms are added."""
    ctc_weight: float = 0.7
    lsm_weight: float = 0.1
    tap_weight: float = 0.1
    loss_scale: float = 1e-4
    embed_ctc_weight: float = 0.3
    router_l1_weight: float = 0.0
    router_importance_weight: float = 0.0


MOE_PROTOS = MOE_HIER_PROTOS | EXMARC_PROTOS


def check_supported(model_cfg: ModelConfig, tcfg: TrainConfig,
                    hier: bool = False) -> None:
    """Raise ValueError for an unknown setting, and for the hier recipe
    (``hier``) on a proto outside the MoE conformers: the recipe runs
    ``moe_conformer.forward`` and its taps, which the JAX recipe calls on
    any proto and which fails there inside the forward."""
    if hier and model_cfg.nnet_proto not in MOE_PROTOS:
        raise ValueError(
            f"the hier AED recipe trains the MoE conformer protos only, not "
            f"{model_cfg.nnet_proto!r}: train it with the CTC / CE step")
    if tcfg.loss_type not in ("ctc", "ce"):
        raise ValueError(f"unknown loss_type {tcfg.loss_type!r}")
    if tcfg.attn_impl not in ("xla", "flash"):
        raise ValueError(f"unknown attn_impl {tcfg.attn_impl!r}")
    if tcfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown compute_dtype {tcfg.compute_dtype!r}")
    if tcfg.accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, not {tcfg.accum_steps}")


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    """WarmupNoam schedule + Adam (AdamW with weight decay), global-norm
    clip at ``grad_clip``, and the runtime lr_scale knob."""
    return build_optimizer(
        "warmup_noam", {"warmup_steps": cfg.warmup_steps},
        cfg.learning_rate, optim_type="adam", max_grad_norm=cfg.grad_clip,
        weight_decay=cfg.weight_decay)


def train_chunk_mask(enc_cfg, feat: torch.Tensor, feat_len: torch.Tensor,
                     generator: Optional[torch.Generator]):
    """The per-batch chunk mask of the training forward (random dynamic
    chunks with ``use_dynamic_chunk``, else the static chunk mask), or
    None when neither chunk mode is configured."""
    if not (enc_cfg.use_dynamic_chunk or enc_cfg.static_chunk_size > 0):
        return None
    sub_len = masking.SUBSAMPLED_LENGTH[enc_cfg.input_layer]
    return masking.add_optional_chunk_mask(
        sub_len(feat_len), int(sub_len(feat.shape[1])),
        enc_cfg.use_dynamic_chunk, enc_cfg.use_dynamic_left_chunk, 0,
        enc_cfg.static_chunk_size, -1, generator=generator)


def _cast_compute(params, feat: torch.Tensor, tcfg: TrainConfig):
    """bf16 copies of the float leaves and of the input under
    ``compute_dtype="bfloat16"``; autograd carries the gradients back
    through the casts to the float32 masters."""
    if tcfg.compute_dtype != "bfloat16":
        return params, feat

    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):      # the DFSMN nets' layer lists
            return [cast(v) for v in t]
        if t is not None and t.is_floating_point():
            return t.to(torch.bfloat16)
        return t
    return cast(params), feat.to(torch.bfloat16)


def _apply_spec_aug(tcfg: TrainConfig, generator, feat, feat_len):
    if not tcfg.spec_aug:
        return feat
    if generator is None:
        raise ValueError("spec_aug=True needs the per-batch step generator")
    return masking.spec_augment(generator, feat, feat_len,
                                **(tcfg.spec_aug_conf or {}))


def _ce_targets(targets, target_lens, T_out: int, padding_idx: int):
    """CE labels padded (or cut) to the model's T_out frames, padding_idx
    past each length."""
    U = targets.shape[1]
    tgt = targets.long()
    if U < T_out:
        tgt = torch.cat([tgt, tgt.new_full((tgt.shape[0], T_out - U),
                                           padding_idx)], 1)
    else:
        tgt = tgt[:, :T_out]
    valid = torch.arange(T_out, device=tgt.device)[None, :] \
        < target_lens[:, None]
    return torch.where(valid, tgt, torch.full_like(tgt, padding_idx))


def _forward(params, model_cfg: ModelConfig, tcfg: TrainConfig, feat,
             feat_len, generator, domain_acc: bool):
    """The CTC / CE branch's forward of each family: (out, out_len,
    embed_out or None, (out_pool, out_pool_acc) or None). The MoE nets run
    the dense expert stage; the DFSMN nets run unsubsampled and take no
    chunk mask, as in the JAX step."""
    if "dfsmn" in model_cfg.nnet_proto:
        e = registry.dfsmn_enc_conf(model_cfg)
        if "fmoe" in model_cfg.nnet_proto:
            out, embed_out, out_len = dfsmn.dfsmn_san_moe_forward(
                params, registry.dfsmn_moe_config(e), feat, feat_len,
                moe_impl="dense", attn_impl=tcfg.attn_impl)
            return out, out_len, embed_out, None
        fwd = registry.get_family(model_cfg.nnet_proto).forward
        if domain_acc:
            out, out_len, pool, pool_acc = fwd(
                params, model_cfg, feat, feat_len, domain_acc=True,
                attn_impl=tcfg.attn_impl)
            return out, out_len, None, (pool, pool_acc)
        out, out_len = fwd(params, model_cfg, feat, feat_len,
                           attn_impl=tcfg.attn_impl)
        return out, out_len, None, None
    enc = model_cfg.encoder_conf
    chunk_mask = train_chunk_mask(enc, feat, feat_len, generator)
    if model_cfg.nnet_proto in MOE_PROTOS:
        embed_mask = train_chunk_mask(enc.embed_conf, feat, feat_len,
                                      generator)
        out, out_len, embed_out = moe_conformer.forward(
            params, enc, feat, feat_len, output_embed=True,
            moe_impl="dense", chunk_mask=chunk_mask,
            embed_chunk_mask=embed_mask, remat=tcfg.remat,
            attn_impl=tcfg.attn_impl)
        return out, out_len, embed_out, None
    out, out_len = conformer.forward(params, enc, feat, feat_len,
                                     chunk_mask=chunk_mask,
                                     attn_impl=tcfg.attn_impl)
    return out, out_len, None, None


def loss_fn(params, model_cfg: ModelConfig, tcfg: TrainConfig,
            feat: torch.Tensor, feat_len: torch.Tensor,
            targets: torch.Tensor, target_lens: torch.Tensor,
            generator: Optional[torch.Generator] = None,
            domain_targets: Optional[torch.Tensor] = None,
            acc_targets: Optional[torch.Tensor] = None):
    """(loss, metrics) of the CTC (or CE) branch of any family; the loss
    math runs in float32 whatever the compute dtype. The router weights
    are not read here, as in the JAX package. With domain or accent ids
    (B,) on ``dfsmn_san_res_embed_domain_acc``, its in-model pooled heads
    add their CE (summed over the batch, / B) at ``ce_weight``, with the
    hit rate as a metric; on any other proto the ids are not read, as in
    the JAX package."""
    check_supported(model_cfg, tcfg)
    params, feat = _cast_compute(params, feat, tcfg)
    feat = _apply_spec_aug(tcfg, generator, feat, feat_len)
    domain_acc = (model_cfg.nnet_proto == "dfsmn_san_res_embed_domain_acc"
                  and (domain_targets is not None
                       or acc_targets is not None))
    out, out_len, embed_out, pools = _forward(
        params, model_cfg, tcfg, feat, feat_len, generator, domain_acc)
    out = out.float()
    metrics = {}
    if tcfg.loss_type == "ce":
        tgt = _ce_targets(targets, target_lens, out.shape[1],
                          tcfg.padding_idx)
        loss, (_, likely, hit), (frames, _, _) = losses.ce_loss(
            out, tgt, tcfg.padding_idx, mean_in_frames=True)
        metrics["ce_loss"] = loss
        metrics["likely"] = likely / frames.clamp(min=1)
        metrics["acc"] = hit / frames.clamp(min=1)
    else:
        loss = tcfg.ctc_weight * losses.ctc_loss(out, out_len, targets,
                                                 target_lens, tcfg.blank_idx)
        metrics["ctc_loss"] = loss
    if embed_out is not None and tcfg.embed_ctc_weight > 0:
        e_loss = losses.ctc_loss(embed_out.float(), out_len, targets,
                                 target_lens, tcfg.blank_idx)
        metrics["embed_ctc_loss"] = e_loss
        loss = loss + tcfg.embed_ctc_weight * e_loss
    if pools is not None:
        B = feat.shape[0]
        for tag, logits, tgt in (("domain", pools[0], domain_targets),
                                 ("acc", pools[1], acc_targets)):
            if tgt is None:
                continue
            ce_sum, (_, _, hit), (frames, _, _) = losses.ce_loss(
                logits.float(), tgt[:, None], -1, mean_in_frames=False)
            ce = ce_sum / losses.global_count(B)
            metrics[f"{tag}_loss"] = ce
            metrics[f"{tag}_hit"] = hit / frames.clamp(min=1)
            loss = loss + tcfg.ce_weight * ce
    metrics["loss"] = loss
    return loss, metrics


def add_sos_eos_t(targets: torch.Tensor, target_lens: torch.Tensor, sos: int,
                  eos: int, ignore_id: int):
    """(B, U) -> ys_in, ys_out (B, U+1) on the device (``add_sos_eos_jnp``):
    ys_in = sos + targets, ys_out = targets + eos, ignore_id past each."""
    B, U = targets.shape
    tgt = targets.long()
    lens = target_lens.long()[:, None]
    pos = torch.arange(U + 1, device=tgt.device)[None, :]
    zero = tgt.new_zeros((B, 1))
    shifted = torch.cat([zero, tgt], 1)
    ys_in = torch.where(pos == 0, torch.full_like(shifted, sos),
                        torch.where(pos <= lens, shifted,
                                    torch.full_like(shifted, ignore_id)))
    padded = torch.cat([tgt, zero], 1)
    ys_out = torch.where(pos == lens, torch.full_like(padded, eos),
                         torch.where(pos < lens, padded,
                                     torch.full_like(padded, ignore_id)))
    return ys_in, ys_out


def init_domain_acc_heads(generator: torch.Generator, d_model: int,
                          output_dim_domain: int = 6,
                          output_dim_acc: int = 8, bottleneck: int = 4,
                          dtype: torch.dtype = torch.float32):
    """The domain and accent classifier heads on the embed hidden: a
    Linear(d -> bottleneck) and a Linear(bottleneck -> classes) each,
    torch.nn.Linear's init drawn on ``generator``'s device."""
    def head(n_out):
        return {"embed": init_linear(generator, d_model, bottleneck,
                                     dtype=dtype),
                "out": init_linear(generator, bottleneck, n_out,
                                   dtype=dtype)}
    return {"domain_head": head(output_dim_domain),
            "acc_head": head(output_dim_acc)}


DECODER_TAPS = (("decoder", "h_final"), ("decoder_1", "h6"),
                ("decoder_2", "h12"))


def hier_aed_loss_fn(params, model_cfg: ModelConfig,
                     tcfg: HierTrainConfig, feat, feat_len, targets,
                     target_lens, aed_targets, aed_target_lens,
                     generator: Optional[torch.Generator] = None,
                     domain_targets=None, acc_targets=None):
    """The deployed recipe: CTC (final) + label-smoothing AED on the
    final hidden and the taps after blocks 6 and 12, scaled by
    ``loss_scale``, + embed CTC + the domain/accent heads on the embed
    hidden pooled over the valid frames + the router aux terms (averaged
    over the blocks). ``params`` holds ``encoder`` and the decoders
    ``decoder``, ``decoder_1``, ``decoder_2`` (and the heads). No remat,
    as in the JAX recipe."""
    check_supported(model_cfg, tcfg, hier=True)
    params, feat = _cast_compute(params, feat, tcfg)
    feat = _apply_spec_aug(tcfg, generator, feat, feat_len)
    enc = params["encoder"] if "encoder" in params else params
    enc_cfg = model_cfg.encoder_conf
    chunk_mask = train_chunk_mask(enc_cfg, feat, feat_len, generator)
    embed_mask = train_chunk_mask(enc_cfg.embed_conf, feat, feat_len,
                                  generator)
    with_heads = domain_targets is not None or acc_targets is not None
    res = moe_conformer.forward(enc, enc_cfg, feat, feat_len,
                                output_embed=True, hier_taps=True,
                                return_router_probs=True, moe_impl="dense",
                                chunk_mask=chunk_mask,
                                embed_chunk_mask=embed_mask,
                                return_embed_hidden=with_heads,
                                attn_impl=tcfg.attn_impl)
    out, out_len, embed_out, h6, h12, h_final, router_ps = res[:7]
    taps = {"h6": h6, "h12": h12, "h_final": h_final}
    embed_hidden = res[7] if with_heads else None
    metrics = {}
    ctc = losses.ctc_loss(out.float(), out_len, targets, target_lens,
                          tcfg.blank_idx)
    metrics["ctc_loss"] = ctc
    loss = tcfg.ctc_weight * ctc

    sos = eos = model_cfg.output_dim - 1
    ys_in, ys_out = add_sos_eos_t(aed_targets, aed_target_lens, sos, eos, -1)
    ys_in = ys_in.clamp(min=0)
    ys_in_lens = aed_target_lens + 1
    aed_total = 0.0
    for i, (name, tap) in enumerate(DECODER_TAPS):
        if name not in params:
            continue
        dp = params[name]
        dp = dp.get("left_decoder", dp)
        with pmesh.sharded(None):     # the decoders are replicated
            dec_out = aed.forward(dp, model_cfg.decoder_conf, taps[tap],
                                  out_len, ys_in, ys_in_lens)
        a_loss = losses.label_smoothing_loss(dec_out.float(), ys_out, -1,
                                             tcfg.lsm_weight)
        metrics[f"aed_loss_{i}"] = a_loss
        aed_total = aed_total + (a_loss if i == 0
                                 else tcfg.tap_weight * a_loss)
    loss = loss + (1.0 - tcfg.ctc_weight) * aed_total
    loss = loss * tcfg.loss_scale

    if tcfg.embed_ctc_weight > 0:
        e_loss = losses.ctc_loss(embed_out.float(), out_len, targets,
                                 target_lens, tcfg.blank_idx)
        metrics["embed_ctc_loss"] = e_loss
        loss = loss + tcfg.embed_ctc_weight * e_loss

    B = feat.shape[0]
    for tag, head_name, tgt in (("domain", "domain_head", domain_targets),
                                ("acc", "acc_head", acc_targets)):
        if tgt is None or head_name not in params:
            continue
        head = params[head_name]
        valid = (torch.arange(embed_hidden.shape[1],
                              device=feat.device)[None, :]
                 < out_len[:, None]).to(embed_hidden.dtype)
        pooled = ((embed_hidden * valid[:, :, None]).sum(1)
                  / valid.sum(1).clamp(min=1.0)[:, None])
        logits = linear(head["out"], linear(head["embed"], pooled)).float()
        ce_sum, (_, _, hit), (frames, _, _) = losses.ce_loss(
            logits[:, None, :], tgt[:, None], -1, mean_in_frames=False)
        ce = ce_sum / losses.global_count(B)
        metrics[f"{tag}_loss"] = ce
        metrics[f"{tag}_hit"] = hit / frames.clamp(min=1)
        loss = loss + tcfg.ce_weight * ce

    if tcfg.router_l1_weight > 0 or tcfg.router_importance_weight > 0:
        ps = router_ps.float()                    # (L, B, T', E)
        l1 = torch.stack([losses.router_l1_loss(p, out_len)
                          for p in ps]).mean()
        imp = torch.stack([losses.router_importance_loss(p, out_len)
                           for p in ps]).mean()
        metrics["router_l1"] = l1
        metrics["router_importance"] = imp
        loss = loss + tcfg.router_l1_weight * l1 + \
            tcfg.router_importance_weight * imp

    metrics["loss"] = loss
    return loss, metrics


def _value_and_grad(call, params):
    """((loss, metrics), grads) of ``call(tree) -> (loss, metrics)``:
    grads a flat ``{"a/b/c": tensor}`` dict over every float leaf of
    ``params``, zeros where the loss does not reach."""
    flat = flatten_tree(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()
              if v.is_floating_point()}
    loss, metrics = call(unflatten_tree({**flat, **leaves}))
    names = list(leaves)
    got = torch.autograd.grad(loss, [leaves[k] for k in names],
                              allow_unused=True)
    grads = {k: torch.zeros_like(leaves[k]) if g is None else g
             for k, g in zip(names, got)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), \
        grads


def _accum_value_and_grad(per_mb_loss, params, mb_arrays, accum_steps: int):
    """Gradient accumulation over ``accum_steps`` equal microbatches, in
    row order: each runs forward and backward on its own (peak activation
    memory is one microbatch); the loss, metrics and gradients returned
    are the microbatch means, summed in order and scaled by
    1 / accum_steps as the JAX scan does. per_mb_loss(tree, mb) -> (loss,
    metrics); mb_arrays: batch-leading tensors (entries may be None)."""
    B = next(a.shape[0] for a in mb_arrays if a is not None)
    if B % accum_steps != 0:
        raise ValueError(f"batch {B} not divisible by accum_steps "
                         f"{accum_steps}")
    n = B // accum_steps
    loss = metrics = grads = None
    for i in range(accum_steps):
        mb = tuple(None if a is None else a[i * n:(i + 1) * n]
                   for a in mb_arrays)
        (l_i, m_i), g_i = _value_and_grad(lambda p: per_mb_loss(p, mb),
                                          params)
        if loss is None:
            loss, metrics, grads = l_i, m_i, g_i
            continue
        loss = loss + l_i
        metrics = {k: metrics[k] + m_i[k] for k in metrics}
        for k, g in g_i.items():
            grads[k].add_(g)
        del g_i
    inv = 1.0 / accum_steps
    return (loss * inv, {k: v * inv for k, v in metrics.items()}), \
        {k: g.mul_(inv) for k, g in grads.items()}


def value_and_grad(params, model_cfg: ModelConfig, tcfg: TrainConfig, feat,
                   feat_len, targets, target_lens, generator=None,
                   domain_targets=None, acc_targets=None):
    """((loss, metrics), grads) of :func:`loss_fn` (``jax.value_and_grad``),
    over ``accum_steps`` microbatches when it is > 1."""
    def call(p, mb):
        f, fl, tg, tl, dt, ac = mb
        return loss_fn(p, model_cfg, tcfg, f, fl, tg, tl,
                       generator=generator, domain_targets=dt,
                       acc_targets=ac)
    batch = (feat, feat_len, targets, target_lens, domain_targets,
             acc_targets)
    if tcfg.accum_steps > 1:
        return _accum_value_and_grad(call, params, batch, tcfg.accum_steps)
    return _value_and_grad(lambda p: call(p, batch), params)


def hier_value_and_grad(params, model_cfg: ModelConfig,
                        tcfg: HierTrainConfig, feat, feat_len, targets,
                        target_lens, aed_targets, aed_target_lens,
                        generator=None, domain_targets=None,
                        acc_targets=None):
    """((loss, metrics), grads) of :func:`hier_aed_loss_fn`, over
    ``accum_steps`` microbatches when it is > 1."""
    def call(p, mb):
        f, fl, tg, tl, at, atl, dt, ac = mb
        return hier_aed_loss_fn(p, model_cfg, tcfg, f, fl, tg, tl, at, atl,
                                generator=generator, domain_targets=dt,
                                acc_targets=ac)
    batch = (feat, feat_len, targets, target_lens, aed_targets,
             aed_target_lens, domain_targets, acc_targets)
    if tcfg.accum_steps > 1:
        return _accum_value_and_grad(call, params, batch, tcfg.accum_steps)
    return _value_and_grad(lambda p: call(p, batch), params)


def step_checks(tcfg: TrainConfig, device):
    """(device, check(params)): a float32 step on CUDA turns TF32 off for
    cuBLAS and cuDNN (process-wide flags) when it is built, as the engine
    does, and again at each check; bf16 compute leaves them as they are.
    The check raises unless the parameters lie on the step's device."""
    dev = resolve_device(device)
    full_fp32 = dev.type == "cuda" and tcfg.compute_dtype == "float32"

    def no_tf32():
        # full float32 (cuDNN convolutions default to TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    if full_fp32:
        no_tf32()

    def check(params):
        if full_fp32:        # in case TF32 was turned on since
            no_tf32()
        if any(t.device.type != dev.type
               for t in flatten_tree(params).values()):
            raise ValueError(f"the step runs on {dev}: the parameters "
                             "must lie there")
    return dev, check


def _step_runner(tcfg: TrainConfig, optimizer: Optimizer, device):
    """run(params, opt_state, batch, value_and_grad_of_batch) -> (params,
    opt_state, metrics) on ``device``: the batch (tensors, numpy arrays or
    None) moved there, the update, and ``grad_norm`` (before clipping)
    (TF32 and the parameters' device: :func:`step_checks`)."""
    dev, check = step_checks(tcfg, device)

    def run(params, opt_state, batch, vg):
        check(params)
        batch = tuple(None if a is None else torch.as_tensor(a, device=dev)
                      for a in batch)
        (_, metrics), grads = vg(params, batch)
        flat = flatten_tree(params)
        current = {k: flat[k] for k in grads}
        updates, opt_state = optimizer.update(grads, opt_state, current)
        flat.update(optimizer.apply_updates(current, updates))
        metrics["grad_norm"] = global_norm(grads.values())
        return unflatten_tree(flat), opt_state, metrics

    return run


def _sharded_runner(par, tcfg: TrainConfig, optimizer: Optimizer, device,
                    loss):
    """The run of :func:`_step_runner` over a ``train.parallel.Parallel``
    layout: ``loss(tree, tcfg, batch, generator)`` on this rank's rows,
    SpecAugment on each global microbatch before it is cut."""
    from m3asr_tpu_torch.parallel import pp as ppipe
    from m3asr_tpu_torch.train.parallel import make_sharded_step
    local = dataclasses.replace(tcfg, spec_aug=False, accum_steps=1)

    def call(tree, mb, generator):
        with ppipe.microbatches(par.pp_microbatches):
            return loss(tree, local, mb, generator)

    return make_sharded_step(
        par, tcfg, optimizer, device, call,
        lambda f, fl, g: _apply_spec_aug(tcfg, g, f, fl))


def _runner(tcfg: TrainConfig, optimizer: Optimizer, device, mesh, loss,
            value_and_grad_of):
    """run(params, opt_state, batch, generator) -> (params, opt_state,
    metrics): the one-rank step's (``value_and_grad_of(params, batch,
    generator)``) or, with ``mesh`` (a ``train.parallel.Parallel``), the
    sharded step's of ``loss(tree, tcfg, batch, generator)``."""
    if mesh is not None:
        return _sharded_runner(mesh, tcfg, optimizer, device, loss)
    run = _step_runner(tcfg, optimizer, device)
    return lambda params, opt_state, batch, generator: run(
        params, opt_state, batch,
        lambda p, b: value_and_grad_of(p, b, generator))


def _with_grads(step, run, n_batch: int):
    """``step`` with ``step.value_and_grad(params, *batch,
    generator=None)`` -> (metrics, this rank's blocks of the whole
    gradient, its norm), the sharded step's before its update, and
    ``step.apply(params, opt_state, metrics, grads, norm)`` -> the step's
    (params, opt_state, metrics) from them."""
    def value_and_grad(params, *batch, generator=None):
        batch = tuple(batch) + (None,) * (n_batch - len(batch))
        return run.value_and_grad(params, batch, generator)
    step.value_and_grad, step.apply = value_and_grad, run.apply
    return step


def make_train_step(model_cfg: ModelConfig, tcfg: TrainConfig,
                    optimizer: Optimizer, with_domain_acc: bool = False,
                    device=None, mesh=None):
    """step(params, opt_state, feat, feat_len, targets, target_lens,
    generator=None) -> (params, opt_state, metrics), metrics holding
    ``loss``, ``ctc_loss`` (``ce_loss``, ``likely``, ``acc`` in CE mode)
    and ``grad_norm`` (before clipping). With ``with_domain_acc`` the step
    takes the per-utterance domain and accent ids after the CTC labels
    (the Trainer's batch key order: ``..., domain, acc[, generator]``)
    and trains the in-model heads of ``dfsmn_san_res_embed_domain_acc``.
    The step runs on ``device`` (``cuda`` unless the caller asks for the
    CPU): the parameters must lie there, the batch (tensors or numpy
    arrays) is moved there. The optimizer state comes from
    :func:`init_opt_state`. ``generator`` (a CPU ``torch.Generator``)
    draws the SpecAugment masks and the dynamic chunk sizes, when the
    config asks for them.

    ``mesh``: a ``train.parallel.Parallel`` layout over a rank mesh: the
    parameters and the optimizer state are this rank's blocks, the batch
    is the global batch (in BMUF mode this replica's slice), and the
    step is the one-rank step's, sharded."""
    check_supported(model_cfg, tcfg)
    run = _runner(
        tcfg, optimizer, device, mesh,
        lambda p, t, b, g: loss_fn(p, model_cfg, t, *b[:4], generator=g,
                                   domain_targets=b[4], acc_targets=b[5]),
        lambda p, b, g: value_and_grad(p, model_cfg, tcfg, *b[:4],
                                       generator=g, domain_targets=b[4],
                                       acc_targets=b[5]))

    if with_domain_acc:
        def step(params, opt_state, feat, feat_len, targets, target_lens,
                 domain_targets, acc_targets, generator=None):
            return run(params, opt_state,
                       (feat, feat_len, targets, target_lens,
                        domain_targets, acc_targets), generator)
    else:
        def step(params, opt_state, feat, feat_len, targets, target_lens,
                 generator=None):
            return run(params, opt_state,
                       (feat, feat_len, targets, target_lens, None, None),
                       generator)
    return step if mesh is None else _with_grads(step, run, 6)


def make_hier_train_step(model_cfg: ModelConfig, tcfg: HierTrainConfig,
                         optimizer: Optimizer, with_domain_acc: bool = False,
                         device=None, mesh=None):
    """The deployed hier AED recipe's step: step(params, opt_state, feat,
    feat_len, targets, target_lens, aed_targets, aed_target_lens,
    generator=None), with ``with_domain_acc`` taking the per-utterance
    domain and accent ids after the AED labels (the Trainer's batch key
    order) and training the heads of :func:`init_domain_acc_heads` on the
    embed hidden. Device, batch and generator as :func:`make_train_step`.
    ValueError for a proto outside the MoE conformers. ``mesh`` as
    :func:`make_train_step`'s."""
    check_supported(model_cfg, tcfg, hier=True)
    run = _runner(
        tcfg, optimizer, device, mesh,
        lambda p, t, b, g: hier_aed_loss_fn(
            p, model_cfg, t, *b[:6], generator=g, domain_targets=b[6],
            acc_targets=b[7]),
        lambda p, b, g: hier_value_and_grad(
            p, model_cfg, tcfg, *b[:6], generator=g, domain_targets=b[6],
            acc_targets=b[7]))

    if with_domain_acc:
        def step(params, opt_state, feat, feat_len, targets, target_lens,
                 aed_targets, aed_target_lens, domain_targets, acc_targets,
                 generator=None):
            return run(params, opt_state,
                       (feat, feat_len, targets, target_lens, aed_targets,
                        aed_target_lens, domain_targets, acc_targets),
                       generator)
    else:
        def step(params, opt_state, feat, feat_len, targets, target_lens,
                 aed_targets, aed_target_lens, generator=None):
            return run(params, opt_state,
                       (feat, feat_len, targets, target_lens, aed_targets,
                        aed_target_lens, None, None), generator)
    return step if mesh is None else _with_grads(step, run, 8)


def needs_generator(model_cfg: ModelConfig, tcfg: TrainConfig) -> bool:
    """Whether a step draws random numbers (SpecAugment, dynamic chunks):
    the JAX ``_needs_rng``."""
    enc = model_cfg.encoder_conf
    embed = getattr(enc, "embed_conf", None)
    return bool(tcfg.spec_aug or enc.use_dynamic_chunk
                or getattr(embed, "use_dynamic_chunk", False))


def init_opt_state(optimizer: Optimizer, params):
    """The optimizer state of a parameter tree (its float leaves)."""
    return optimizer.init({k: v for k, v in flatten_tree(params).items()
                           if v.is_floating_point()})
