"""CTC training step of the hier MoE conformer (port of the MoE-conformer
CTC branch of ``m3asr_tpu/train/step.py``).

One step: the forward with the dense expert stage (every expert on every
token, as the JAX step trains), the CTC loss of the final logits (plus
the embed encoder's, weighted by ``embed_ctc_weight``), gradients by
autograd with respect to every float leaf of the parameter tree, and the
optimizer (``lr_scheduler.Optimizer``). With ``attn_impl="flash"`` the 24
attention layers run K2 forward and K3 backward (``ops/flash_attention``).
With ``compute_dtype="bfloat16"`` the forward and backward run on bf16
copies of the float32 master weights, and the gradients come back to
them in float32 through the casts.

The step is functional, as the JAX one: it returns new parameters and
optimizer state and leaves its inputs as they were (the card holds both
copies for the length of the update). A parameter the loss does not
reach (the embed encoder, without an embed CTC weight: the routers see
its output detached) gets a zero gradient, as ``jax.grad`` gives it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from m3asr_tpu_torch.checkpoint import flatten_tree, unflatten_tree
from m3asr_tpu_torch.config import MOE_HIER_PROTOS, ModelConfig
from m3asr_tpu_torch.device import resolve_device
from m3asr_tpu_torch.models import moe_conformer
from m3asr_tpu_torch.ops import masking
from m3asr_tpu_torch.train import losses
from m3asr_tpu_torch.train.lr_scheduler import (Optimizer, build_optimizer,
                                                global_norm)

_TODO = "ROADMAP Queue 1 item 11 (training: the rest)"


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 1e-3
    warmup_steps: int = 25000
    weight_decay: float = 0.0
    grad_clip: float = 5.0
    ctc_weight: float = 1.0
    loss_type: str = "ctc"            # 'ce' is not ported
    embed_ctc_weight: float = 0.0     # aux CTC on the embed encoder head
    router_l1_weight: float = 0.0     # > 0 is not ported
    router_importance_weight: float = 0.0
    blank_idx: int = 0
    remat: bool = False               # True is not ported
    attn_impl: str = "xla"            # 'flash': K2 forward, K3 backward
    compute_dtype: str = "float32"    # 'bfloat16': bf16 compute over
                                      # float32 master weights
    spec_aug: bool = False            # True is not ported
    accum_steps: int = 1              # > 1 is not ported


def check_supported(model_cfg: ModelConfig, tcfg: TrainConfig) -> None:
    """Raise NotImplementedError for the settings this slice does not
    train, naming the ROADMAP item that brings them."""
    if model_cfg.nnet_proto not in MOE_HIER_PROTOS:
        raise NotImplementedError(
            f"training {model_cfg.nnet_proto!r}: only the hier MoE conformer "
            "CTC step is ported; the DFSMN and dense-conformer branches come "
            "with ROADMAP Queue 1 item 10")
    refused = [("loss_type", tcfg.loss_type != "ctc"),
               ("spec_aug", tcfg.spec_aug),
               ("accum_steps", tcfg.accum_steps > 1),
               ("remat", tcfg.remat),
               ("router_l1_weight", tcfg.router_l1_weight > 0),
               ("router_importance_weight",
                tcfg.router_importance_weight > 0)]
    for name, bad in refused:
        if bad:
            raise NotImplementedError(
                f"TrainConfig {name}={getattr(tcfg, name)!r} is not ported "
                f"yet: {_TODO}")
    if tcfg.attn_impl not in ("xla", "flash"):
        raise ValueError(f"unknown attn_impl {tcfg.attn_impl!r}")
    if tcfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown compute_dtype {tcfg.compute_dtype!r}")


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
        if t is not None and t.is_floating_point():
            return t.to(torch.bfloat16)
        return t
    return cast(params), feat.to(torch.bfloat16)


def loss_fn(params, model_cfg: ModelConfig, tcfg: TrainConfig,
            feat: torch.Tensor, feat_len: torch.Tensor,
            targets: torch.Tensor, target_lens: torch.Tensor,
            generator: Optional[torch.Generator] = None):
    """(loss, metrics) of the MoE-conformer CTC branch; the loss math runs
    in float32 whatever the compute dtype."""
    check_supported(model_cfg, tcfg)
    enc = model_cfg.encoder_conf
    params, feat = _cast_compute(params, feat, tcfg)
    chunk_mask = train_chunk_mask(enc, feat, feat_len, generator)
    embed_mask = train_chunk_mask(enc.embed_conf, feat, feat_len, generator)
    out, out_len, embed_out = moe_conformer.forward(
        params, enc, feat, feat_len, output_embed=True, moe_impl="dense",
        chunk_mask=chunk_mask, embed_chunk_mask=embed_mask,
        attn_impl=tcfg.attn_impl)
    metrics = {}
    loss = tcfg.ctc_weight * losses.ctc_loss(out.float(), out_len, targets,
                                             target_lens, tcfg.blank_idx)
    metrics["ctc_loss"] = loss
    if tcfg.embed_ctc_weight > 0:
        e_loss = losses.ctc_loss(embed_out.float(), out_len, targets,
                                 target_lens, tcfg.blank_idx)
        metrics["embed_ctc_loss"] = e_loss
        loss = loss + tcfg.embed_ctc_weight * e_loss
    metrics["loss"] = loss
    return loss, metrics


def value_and_grad(params, model_cfg: ModelConfig, tcfg: TrainConfig, feat,
                   feat_len, targets, target_lens, generator=None):
    """((loss, metrics), grads): grads a flat ``{"a/b/c": tensor}`` dict
    over every float leaf of ``params``, zeros where the loss does not
    reach (``jax.value_and_grad`` of ``loss_fn``)."""
    flat = flatten_tree(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()
              if v.is_floating_point()}
    loss, metrics = loss_fn(unflatten_tree({**flat, **leaves}), model_cfg,
                            tcfg, feat, feat_len, targets, target_lens,
                            generator)
    names = list(leaves)
    got = torch.autograd.grad(loss, [leaves[k] for k in names],
                              allow_unused=True)
    grads = {k: torch.zeros_like(leaves[k]) if g is None else g
             for k, g in zip(names, got)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), \
        grads


def make_train_step(model_cfg: ModelConfig, tcfg: TrainConfig,
                    optimizer: Optimizer, with_domain_acc: bool = False,
                    device=None):
    """step(params, opt_state, feat, feat_len, targets, target_lens,
    generator=None) -> (params, opt_state, metrics), metrics holding
    ``loss``, ``ctc_loss`` and ``grad_norm`` (before clipping). The step
    runs on ``device`` (``cuda`` unless the caller asks for the CPU): the
    parameters must lie there, the batch (tensors or numpy arrays) is
    moved there. The optimizer state comes from :func:`init_opt_state`.
    ``generator`` (a CPU ``torch.Generator``) draws the dynamic chunk
    sizes, when the config asks for them. A float32 step on CUDA turns
    TF32 off for cuBLAS and cuDNN (process-wide flags) when it is built,
    as the engine does, and again at each call; bf16 compute leaves them
    as they are."""
    check_supported(model_cfg, tcfg)
    if with_domain_acc:
        raise NotImplementedError(
            "the domain/accent heads (DFSMN in-model heads) are not ported "
            "yet: ROADMAP Queue 1 item 10")
    dev = resolve_device(device)
    full_fp32 = dev.type == "cuda" and tcfg.compute_dtype == "float32"

    def no_tf32():
        # full float32 (cuDNN convolutions default to TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    if full_fp32:
        no_tf32()

    def step(params, opt_state, feat, feat_len, targets, target_lens,
             generator=None):
        if full_fp32:        # in case TF32 was turned on since
            no_tf32()
        if any(t.device.type != dev.type
               for t in flatten_tree(params).values()):
            raise ValueError(f"the step runs on {dev}: the parameters "
                             "must lie there")
        feat, feat_len, targets, target_lens = (
            torch.as_tensor(a, device=dev)
            for a in (feat, feat_len, targets, target_lens))
        (_, metrics), grads = value_and_grad(
            params, model_cfg, tcfg, feat, feat_len, targets, target_lens,
            generator)
        flat = flatten_tree(params)
        current = {k: flat[k] for k in grads}
        updates, opt_state = optimizer.update(grads, opt_state, current)
        flat.update(optimizer.apply_updates(current, updates))
        metrics["grad_norm"] = global_norm(grads.values())
        return unflatten_tree(flat), opt_state, metrics

    return step


def init_opt_state(optimizer: Optimizer, params):
    """The optimizer state of a parameter tree (its float leaves)."""
    return optimizer.init({k: v for k, v in flatten_tree(params).items()
                           if v.is_floating_point()})


def make_hier_train_step(*_, **__):
    """The deployed hier AED recipe (CTC + AED taps + router aux)."""
    raise NotImplementedError(
        "the hier AED training recipe is not ported yet: ROADMAP Queue 1 "
        "item 11 (training: the rest)")
