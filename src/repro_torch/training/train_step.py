"""Training steps — the port of ``repro/training/train_step.py``: masked
next-token loss, LoRA-only (the Floe local client step, frozen base) and
full-parameter variants, with the optional DP hook.

Eager PyTorch: a step takes ``torch.autograd.grad`` of the loss over the
trainable leaves only (the bank's body, or the parameters), so the
frozen base keeps no gradient.  On CUDA the forward runs K3 and K5 and
the backward K8 and K9 (``models/attention.py``, ``models/layers.py``).
A step returns its loss as a 0-d tensor on the device; the caller reads
it when it needs it.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.core import dp as DP
from repro_torch.core import lora as LORA
from repro_torch.core import tree as T

Tree = Any


def masked_cross_entropy(logits, targets, mask) -> torch.Tensor:
    """logits (B,S,V) f32; targets (B,S) int; mask (B,S) float."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    denom = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / denom


def lora_loss_fn(lm, params, bank, batch, gates=None,
                 aux_weight: float = 0.01) -> torch.Tensor:
    """Loss of the frozen base + trainable LoRA bank (Floe client step)."""
    logits, aux = lm.train_logits(
        params, {k: v for k, v in batch.items()
                 if k not in ("targets", "mask")},
        lora=LORA.bank_for_model(bank), gates=gates)
    t = batch["targets"]
    logits = logits[:, -t.shape[1]:]
    return masked_cross_entropy(logits, t, batch["mask"]) + aux_weight * aux


def value_and_grad(loss_fn, tree):
    """(loss, grads): ``loss_fn`` of fresh leaves of ``tree`` that
    require a gradient, and its gradient as a tree shaped as ``tree``.
    A leaf the loss does not reach (the grouped layout's empty tail
    stack) gets a zero gradient, as ``jax.value_and_grad`` gives it."""
    leaves = [x.detach().requires_grad_(True) for x in T.leaves(tree)]
    with torch.enable_grad():
        loss = loss_fn(T.unflatten(tree, leaves))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    return loss.detach(), T.unflatten(tree, grads)


def make_lora_train_step(lm, opt, aux_weight: float = 0.01,
                         dp_clip: Optional[float] = None,
                         dp_noise: float = 0.0) -> Callable:
    """(params, bank, opt_state, batch[, gates, dp_key]) -> (bank,
    opt_state, loss).  ``dp_key`` is a ``core/prng`` key (the reference's
    jax key) when ``dp_clip`` is set."""

    def step(params, bank, opt_state, batch, gates=None, dp_key=None):
        meta = {k: v for k, v in bank.items() if k.startswith("_")}
        body = {k: v for k, v in bank.items() if not k.startswith("_")}
        loss, grads = value_and_grad(
            lambda b: lora_loss_fn(lm, params, b, batch, gates, aux_weight),
            body)
        if dp_clip is not None:
            grads, _ = DP.privatize(grads, dp_key, dp_clip, dp_noise)
        body, opt_state = opt.update(grads, opt_state, body)
        return {**body, **meta}, opt_state, loss

    return step


def full_loss_fn(lm, params, batch, aux_weight: float = 0.01
                 ) -> torch.Tensor:
    logits, aux = lm.train_logits(
        params, {k: v for k, v in batch.items()
                 if k not in ("targets", "mask")})
    t = batch["targets"]
    logits = logits[:, -t.shape[1]:]
    return masked_cross_entropy(logits, t, batch["mask"]) + aux_weight * aux


def make_full_train_step(lm, opt, aux_weight: float = 0.01) -> Callable:
    def step(params, opt_state, batch):
        loss, grads = value_and_grad(
            lambda p: full_loss_fn(lm, p, batch, aux_weight), params)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss
    return step
