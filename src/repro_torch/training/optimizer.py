"""Optimizers — the port of ``repro/training/optimizer.py``: pure
tensor-tree updates (no ``torch.optim``), so one update equals the
reference's on the same gradients.

  adamw     — default for LoRA / small-model training
  adafactor — factored second moments (the memory-sane choice for very
              large models)

Trees are nested dicts of tensors; state tensors live beside the
parameters, and the step count is a 0-d int32 tensor on their device,
so an update never waits on the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import tree as T
from repro_torch.core.dp import global_norm

Tree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]

__all__ = ["constant_schedule", "cosine_schedule", "global_norm", "adamw",
           "adafactor", "Optimizer"]


def constant_schedule(lr: float) -> Schedule:
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> Schedule:
    def fn(step):
        step = step.float()
        warm = step / max(1, warmup)
        prog = torch.clamp((step - warmup) / max(1, total - warmup), 0.0,
                           1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(torch.pi * prog))
        return base_lr * torch.where(step < warmup, warm, cos)
    return fn


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree], Tuple[Tree, Tree]]


def _state_leaves(tree):
    """Adafactor's per-parameter state dicts ({"vr", "vc"} or {"v"}) in
    the parameters' leaf order."""
    if "v" in tree or "vr" in tree:
        return [tree]
    return [x for k in sorted(tree) for x in _state_leaves(tree[k])]


def _first_device(tree):
    leaves = T.leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def adamw(schedule: Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          clip_norm: Optional[float] = 1.0,
          state_dtype=torch.float32) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                      device=p.device)
        return {"m": T.map_tree(zeros, params),
                "v": T.map_tree(zeros, params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=_first_device(params))}

    def update(grads, state, params):
        step = state["step"] + 1
        if clip_norm is not None:
            g_norm = global_norm(grads)
            scale = torch.clamp(clip_norm / torch.clamp(g_norm, min=1e-9),
                                max=1.0)
            grads = T.map_tree(lambda g: g * scale, grads)
        lr = schedule(step)
        stepf = step.float()
        bc1 = 1 - torch.pow(torch.full_like(stepf, b1), stepf)
        bc2 = 1 - torch.pow(torch.full_like(stepf, b2), stepf)

        def upd(g, m, v, p):
            g32 = g.to(state_dtype)
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * torch.square(g32)
            mhat = m / bc1
            vhat = v / bc2
            delta = mhat / (torch.sqrt(vhat) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.to(state_dtype)
            return (p.float() - lr * delta).to(p.dtype), m, v

        outs = [upd(g, m, v, p) for g, m, v, p in zip(
            T.leaves(grads), T.leaves(state["m"]), T.leaves(state["v"]),
            T.leaves(params))]
        return T.unflatten(grads, [o[0] for o in outs]), {
            "m": T.unflatten(grads, [o[1] for o in outs]),
            "v": T.unflatten(grads, [o[2] for o in outs]), "step": step}

    return Optimizer(init, update)


def adafactor(schedule: Schedule, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second-moment estimator (Shazeer & Stern).  Memory:
    O(rows+cols) per matrix instead of O(rows·cols)."""
    def init(params):
        def st(p):
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)}
        return {"s": T.map_tree(st, params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=_first_device(params))}

    def update(grads, state, params):
        step = state["step"] + 1
        lr = schedule(step)
        beta2 = 1.0 - torch.pow(step.float(), -0.8)

        def upd(g, s, p):
            g32 = torch.square(g.float()) + eps
            if p.dim() >= 2:
                vr = beta2 * s["vr"] + (1 - beta2) * g32.mean(-1)
                vc = beta2 * s["vc"] + (1 - beta2) * g32.mean(-2)
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(-1, keepdim=True)[..., None],
                                       min=eps))
                u = g.float() * torch.rsqrt(denom)
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta2 * s["v"] + (1 - beta2) * g32
                u = g.float() * torch.rsqrt(v)
                new_s = {"v": v}
            rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return (p.float() - lr * u).to(p.dtype), new_s

        outs = [upd(g, s, p) for g, s, p in zip(
            T.leaves(grads), _state_leaves(state["s"]), T.leaves(params))]
        return T.unflatten(grads, [o[0] for o in outs]), {
            "s": T.unflatten(grads, [o[1] for o in outs]), "step": step}

    return Optimizer(init, update)
