"""Sequence-discriminative (sMBR-style) training (port of
``m3asr_tpu/train/smbr.py``).

Each batch: the model's posteriors (logits) go out to a Kaldi ark, an
external lattice command computes d(loss)/d(logits) and writes it back
as a gradient ark, and :func:`external_grad_step` pushes that gradient
through the model (``torch.autograd.grad`` with ``grad_outputs``, the
reference's ``output.backward(beam_grad)``) into one optimizer update.
:class:`KaldiLatticeBridge` is the process boundary: a command with
``{post}`` / ``{grad}`` / ``{trans}`` placeholders run by ``subprocess``,
or a Python runner. It always writes the whole batch's posteriors (and
transcripts) and reads the batch's gradient ark, the multi-stream
lattice recipe's shape; a per-utterance tool gets the same arithmetic
one key at a time.
"""

from __future__ import annotations

import os
import subprocess
from typing import Callable, Dict, Optional

import numpy as np
import torch

from m3asr_tpu_torch.checkpoint import (flatten_tree, params_to_numpy,
                                        unflatten_tree)
from m3asr_tpu_torch.io.kaldi_io import ArkWriter, read_ark
from m3asr_tpu_torch.train.lr_scheduler import Optimizer
from m3asr_tpu_torch.train.step import init_opt_state


def external_grad_step(forward: Callable, params, opt_state,
                       optimizer: Optimizer, feat, feat_len, out_grad):
    """One update from an external d(loss)/d(logits).

    forward(params, feat, feat_len) -> (logits, out_len); ``out_grad`` has
    the logits' shape. The gradient of every float leaf of ``params`` is
    the pullback of ``out_grad`` through the forward (zero where the
    logits do not depend on the leaf). Returns (params, opt_state,
    out_len)."""
    flat = flatten_tree(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()
              if v.is_floating_point()}
    out, out_len = forward(unflatten_tree({**flat, **leaves}), feat,
                           feat_len)
    names = list(leaves)
    got = torch.autograd.grad(
        out, [leaves[k] for k in names],
        grad_outputs=torch.as_tensor(out_grad, dtype=out.dtype,
                                     device=out.device),
        allow_unused=True)
    grads = {k: torch.zeros_like(leaves[k]) if g is None else g
             for k, g in zip(names, got)}
    current = {k: flat[k] for k in grads}
    updates, opt_state = optimizer.update(grads, opt_state, current)
    flat.update(optimizer.apply_updates(current, updates))
    return unflatten_tree(flat), opt_state, out_len.detach()


class KaldiLatticeBridge:
    """Posteriors out, gradients in, around an external lattice tool."""

    def __init__(self, command: Optional[list] = None,
                 runner: Optional[Callable[[str, str], None]] = None):
        """Either ``command`` (a list with ``{post}`` / ``{grad}`` /
        ``{trans}`` placeholders), run by ``subprocess``, or
        ``runner(post_ark, grad_ark)``."""
        self.command = command
        self.runner = runner

    def __call__(self, keys, logits: np.ndarray, out_lens: np.ndarray,
                 post_ark: str, grad_ark: str,
                 trans: Optional[list] = None) -> Dict[str, np.ndarray]:
        """Writes each utterance's valid frames of ``logits`` to
        ``post_ark`` (and ``trans`` lines to ``post_ark + ".trans"``),
        runs the tool and returns the gradient ark's {key: matrix}."""
        with ArkWriter(post_ark) as w:
            for i, key in enumerate(keys):
                w.write(key, logits[i, :int(out_lens[i])])
        trans_path = post_ark + ".trans"
        if trans is not None:
            with open(trans_path, "w") as f:
                for line in trans:
                    f.write(line + "\n")
        if self.runner is not None:
            self.runner(post_ark, grad_ark)
        elif self.command is not None:
            cmd = [c.format(post=post_ark, grad=grad_ark, trans=trans_path)
                   for c in self.command]
            subprocess.run(cmd, check=True)
        else:
            raise ValueError("no lattice command or runner configured")
        return dict(read_ark(grad_ark))


def make_external_grad_step(forward: Callable, optimizer: Optimizer):
    """step(params, opt_state, feat, feat_len, out_grad) of
    :func:`external_grad_step`, for the epoch loop."""
    def step(params, opt_state, feat, feat_len, out_grad):
        return external_grad_step(forward, params, opt_state, optimizer,
                                  feat, feat_len, out_grad)
    return step


def batch_out_grad(keys, grads: Dict[str, np.ndarray], logits: np.ndarray,
                   out_lens: np.ndarray, logger=None) -> np.ndarray:
    """The batch's d(loss)/d(logits) from the tool's {key: matrix}: zero
    for an utterance the tool returned nothing for (skipped and logged),
    a gradient longer or shorter than the utterance's posteriors clamped
    to the frames both have (logged)."""
    out_grad = np.zeros_like(logits)
    for i, k in enumerate(keys):
        g = grads.get(k)
        if g is None:
            if logger is not None:
                logger.warning(f"lattice tool returned no gradient for "
                               f"{k!r}; skipping the utterance")
            continue
        n = min(g.shape[0], int(out_lens[i]))
        if g.shape[0] != out_lens[i] and logger is not None:
            logger.warning(f"gradient length {g.shape[0]} != posterior "
                           f"length {int(out_lens[i])} for {k!r}; "
                           f"clamping to {n}")
        out_grad[i, :n] = g[:n]
    return out_grad


def run_smbr_training(model_cfg, forward: Callable, params,
                      optimizer: Optimizer, make_loader: Callable,
                      bridge: KaldiLatticeBridge, work_dir: str,
                      max_epochs: int = 1, logger=None,
                      log_period: int = 100):
    """The sMBR epoch loop: per batch, the posteriors (no grad) to
    ``work_dir/post.ark``, the external tool, its gradient ark read back
    (a stale one removed first), and :func:`external_grad_step`. The batch
    runs on the parameters' device. After each epoch the parameters go to
    ``work_dir/smbr_epoch{n}.pkl`` (a pickle of the numpy tree).

    forward(params, feat, feat_len) -> (logits, out_len); make_loader()
    yields batches with ``keys`` (and ``trans`` when the loader has a
    transcript stream). Returns (params, opt_state, number of batches)."""
    import pickle

    device = next(iter(flatten_tree(params).values())).device
    opt_state = init_opt_state(optimizer, params)
    grad_step = make_external_grad_step(forward, optimizer)
    post = os.path.join(work_dir, "post.ark")
    grad = os.path.join(work_dir, "grad.ark")
    n = 0
    for epoch in range(max_epochs):
        for batch in make_loader():
            keys = batch["keys"]
            feat = torch.as_tensor(batch["data"], device=device)
            feat_len = torch.as_tensor(batch["lens"], device=device)
            with torch.no_grad():
                logits, out_len = forward(params, feat, feat_len)
            logits_np = logits.float().cpu().numpy()
            out_len_np = out_len.cpu().numpy()
            if os.path.exists(grad):
                os.remove(grad)       # never read a stale gradient ark
            grads = bridge(keys, logits_np, out_len_np, post, grad,
                           trans=batch.get("trans"))
            out_grad = batch_out_grad(keys, grads, logits_np, out_len_np,
                                      logger)
            params, opt_state, _ = grad_step(params, opt_state, feat,
                                             feat_len, out_grad)
            n += 1
            if logger is not None and n % log_period == 0:
                logger.info(f"smbr epoch {epoch} batch {n}")
        with open(os.path.join(work_dir, f"smbr_epoch{epoch}.pkl"),
                  "wb") as f:
            pickle.dump(params_to_numpy(params), f)
    return params, opt_state, n
