"""Logit-level LLM-SLM alignment — paper Sec. IV-C (Eq. 14-15) and the
Sec. IV-D timeout fallback; the port of ``repro/core/fusion.py``.

A small MLP maps the two concatenated next-token distributions to a
fusion weight w in [0, 1] (Eq. 14); the output distribution is
w * P_SLM + (1 - w) * P_LLM (Eq. 15), with w forced to 1 when the cloud
logits miss the budget.  ``fused_distribution_kernel`` sends Eq. 15
through K1 (``kernels/logit_fusion``).  ``train_alignment`` fits the
MLP by SGD on ``alignment_loss`` (the reference's ``fusion.py:94-121``),
with autograd through the plain ``fused_distribution``, as the
reference differentiates its jnp one: K1 has no backward.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels.logit_fusion.ops import fused_probs_masked


def alignment_shapes(vocab: int, hidden: int = 64) -> Dict[str, tuple]:
    """The reference's ``alignment_spec``: name -> (shape, init)."""
    return {"w1": ((2 * vocab, hidden), "fan_in"), "b1": ((hidden,), "zeros"),
            "w2": ((hidden, 1), "fan_in"), "b2": ((1,), "zeros")}


def init_alignment(seed: int, vocab: int, hidden: int = 64, device=None
                   ) -> Dict[str, torch.Tensor]:
    """Random float32 Eq. 14 MLP on the device from a seeded generator
    (the reference's laws: fan-in normal weights, zero biases)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name in sorted(alignment_shapes(vocab, hidden)):
        shape, init = alignment_shapes(vocab, hidden)[name]
        if init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            std = 1.0 / math.sqrt(shape[0])
            out[name] = torch.randn(shape, generator=gen,
                                    device=device) * std
    return out


def fusion_weight(mlp, p_slm: torch.Tensor, p_llm: torch.Tensor
                  ) -> torch.Tensor:
    """Eq. 14: w = sigmoid(MLP([P_SLM ; P_LLM])).  p_*: (B, V)."""
    h = torch.cat([p_slm, p_llm], dim=-1).float()
    h = torch.tanh(h @ mlp["w1"].float() + mlp["b1"])
    z = h @ mlp["w2"].float() + mlp["b2"]
    return torch.sigmoid(z[..., 0])


def fuse(p_slm: torch.Tensor, p_llm: torch.Tensor, w: torch.Tensor
         ) -> torch.Tensor:
    """Eq. 15: P_out = w * P_SLM + (1 - w) * P_LLM."""
    w = w[..., None]
    return w * p_slm + (1.0 - w) * p_llm


def fused_distribution(mlp, slm_logits, llm_logits, llm_arrived=True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sec. IV-C/IV-D step from raw logits in plain PyTorch.
    Returns (P_out (B, V), w (B,))."""
    p_slm = torch.softmax(slm_logits.float(), dim=-1)
    p_llm = torch.softmax(llm_logits.float(), dim=-1)
    w = fusion_weight(mlp, p_slm, p_llm)
    arrived = torch.as_tensor(llm_arrived, device=w.device)
    w = torch.where(arrived, w, torch.ones_like(w))
    return fuse(p_slm, p_llm, w), w


@torch.inference_mode()
def fused_distribution_kernel(mlp, slm_logits, llm_logits,
                              arrived: torch.Tensor, block_b: int = 4
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Sec. IV-C/IV-D step with Eq. 15 on K1.  The Eq. 14 MLP
    needs the two probability vectors, so the softmaxes are computed
    here as well; K1 re-derives them from the raw logits.
    arrived: (B,) bool.  Returns (P_out (B, V), w (B,))."""
    p_slm = torch.softmax(slm_logits.float(), dim=-1)
    p_llm = torch.softmax(llm_logits.float(), dim=-1)
    w = fusion_weight(mlp, p_slm, p_llm)
    arrived = arrived.bool()
    p = fused_probs_masked(slm_logits, llm_logits, w, arrived,
                           block_b=block_b)
    return p, torch.where(arrived, w, torch.ones_like(w))


def alignment_loss(mlp, slm_logits, llm_logits, targets) -> torch.Tensor:
    """Mean negative log-probability of the reference next tokens
    ``targets`` (B,) under the fused distribution (distillation-style)."""
    p, _ = fused_distribution(mlp, slm_logits, llm_logits)
    logp = torch.log(torch.clamp(p, min=1e-9))
    nll = -torch.gather(logp, -1, targets[:, None].long())[:, 0]
    return nll.mean()


def train_alignment(mlp, batches, lr: float = 1e-2, steps: int = 200):
    """SGD on ``alignment_loss``; batches: iterable of (slm_logits,
    llm_logits, targets), cycled once exhausted.  Returns (mlp, losses)."""
    losses = []
    it = iter(batches)
    cached = []
    mlp = {k: v.detach() for k, v in mlp.items()}
    for i in range(steps):
        try:
            b = next(it)
            cached.append(b)
        except StopIteration:
            b = cached[i % len(cached)]
        names = sorted(mlp)
        leaves = [mlp[k].requires_grad_(True) for k in names]
        with torch.enable_grad():
            loss = alignment_loss(dict(zip(names, leaves)), *b)
            grads = torch.autograd.grad(loss, leaves)
        mlp = {k: (p - lr * g).detach()
               for k, p, g in zip(names, leaves, grads)}
        losses.append(float(loss.detach()))
    return mlp, losses
