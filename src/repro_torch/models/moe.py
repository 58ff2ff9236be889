"""Mixture-of-Experts FFN with sort-based capacity dispatch — the port of
``repro/models/moe.py``.

Top-k routing (``router``: f32 logits, softmax, top-k, the chosen
probabilities renormalised and cast to the model dtype, and the
Switch-style load-balance loss), then the reference's sort/scatter
dispatch (``moe_ffn``): the T·k (token, expert) assignments sorted by
expert with a STABLE sort, each one's position inside its expert's
bucket, a capacity of ceil(cf · T · k / E) slots an expert, the kept
assignments scattered into an (E, C, d) buffer, the experts' SwiGLU as
two batched products over it, and the weighted combine back to tokens.
Which assignments a full expert drops follows token order inside the
expert, so the sort must be stable (``jnp.argsort`` is, in the
reference's JAX).

The expert products are ``torch.bmm`` over the (E, C, d) buffer in the
activation dtype, as the port's ``linear`` runs its projections (the
reference computes them as einsums with f32 accumulation, outside any
Pallas kernel).  On CUDA they run under PyTorch's default
``allow_bf16_reduced_precision_reduction = True``: cuBLAS accumulates
in f32 but may add split-K partial sums in bf16.  The
dispatch and the combine are plain tensor ops on both devices, with no
host sync: bucket starts come from ``searchsorted`` over the sorted
expert ids, not from ``bincount``, whose CUDA form reads the device back.

Two departures from the reference's scatter/gather, with the same
values:
* dropped assignments go to a sink row past the E·C buffer rows (the
  reference's ``mode="drop"``), so no out-of-range index reaches the
  device; the sink is never read;
* the combine brings each (token, j) term back through the sort's
  inverse permutation and adds a token's k terms in order j = 0..k-1 in
  float32 (the reference scatter-adds them in expert order), so two
  calls on the same inputs give the same bits on CUDA, where
  ``index_add_`` would add with atomics.
"""
from __future__ import annotations

import contextlib
import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

# the dropped-assignment counts of ``moe_ffn`` calls, while
# ``record_drops`` collects them
_DROPS: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def record_drops():
    """Collect each ``moe_ffn`` call's dropped-assignment count, a 0-d
    int64 tensor on its device, into the yielded list (read it after the
    block: the counts stay on the device until then)."""
    global _DROPS
    prev, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = prev


def capacity(cfg, tokens: int) -> int:
    """Slots an expert: ceil(cf · T · k / E), at least 1 (the
    reference's ``moe.py:63``)."""
    return max(1, math.ceil(cfg.capacity_factor * tokens
                            * cfg.experts_per_token / cfg.num_experts))


def router(cfg, p, x_flat: torch.Tensor, aux: bool = True):
    """Top-k routing of x_flat (T, d) (the reference's ``_router``).
    Returns (expert ids (T, k) int64, renormalised probabilities (T, k)
    in x's dtype, aux loss 0-d f32: 0.0 without ``aux``)."""
    logits = x_flat.float() @ p["router"]["w"].float()
    k, e = cfg.experts_per_token, cfg.num_experts
    gate = torch.softmax(logits, dim=-1)
    probs, ids = torch.topk(gate, k, dim=-1)
    probs = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-9)
    if not aux:
        return ids, probs.to(x_flat.dtype), torch.zeros(
            (), device=x_flat.device)
    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e, f_e the
    # mean number of a token's k picks that chose e (the reference's
    # one-hot sum: a token's k ids are distinct)
    me = gate.mean(0)
    ce = torch.zeros_like(me).index_add_(
        0, ids.reshape(-1), torch.ones(ids.numel(), device=ids.device)
    ) / x_flat.shape[0]
    aux = e * torch.sum(me * ce)
    return ids, probs.to(x_flat.dtype), aux


def moe_ffn(cfg, p, x: torch.Tensor, lora=None, gates=None,
            aux: bool = True):
    """x (B, S, d) -> (y (B, S, d), aux loss 0-d f32).  ``lora``/
    ``gates`` reach the shared expert's MLP (its ``mlp_in``/``mlp_out``
    targets), as the reference passes them.  Without ``aux`` (prefill
    and decode, which discard it) the aux loss is not computed and
    comes back 0.0."""
    b, s, d = x.shape
    t = b * s
    k, e = cfg.experts_per_token, cfg.num_experts
    cap = capacity(cfg, t)
    x_flat = x.reshape(t, d)
    ids, probs, aux = router(cfg, p, x_flat, aux)

    # sort the T·k assignments by expert (stable: ties keep token order)
    flat_e = ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = torch.div(order, k, rounding_mode="floor")      # their tokens
    sp = probs.reshape(-1)[order]
    experts = torch.arange(e, device=x.device)
    starts = torch.searchsorted(se, experts)
    pos_in_e = torch.arange(t * k, device=x.device) - starts[se]
    keep = pos_in_e < cap
    if _DROPS is not None:
        _DROPS.append((~keep).sum())
    slot = se * cap + torch.clamp(pos_in_e, max=cap - 1)
    # kept assignments fill their own slots; dropped ones the sink row
    buf = x.new_zeros((e * cap + 1, d)).index_put(
        (torch.where(keep, slot, e * cap),), x_flat[st])
    buf = buf[:e * cap].view(e, cap, d)

    h = torch.bmm(buf, p["w_in"]["w"])
    g, u = torch.chunk(h, 2, dim=-1)
    y_e = torch.bmm(F.silu(g) * u, p["w_out"]["w"])

    # combine: each kept term y · p (in the model dtype, as the
    # reference multiplies) back in (token, j) order, summed over j in f32
    y_slots = y_e.reshape(e * cap, d)[slot]
    terms = torch.where(keep[:, None], y_slots * sp[:, None], 0.0)
    terms = torch.empty_like(terms).index_put_((order,), terms)
    terms = terms.float().view(t, k, d)
    y_flat = terms[:, 0]
    for j in range(1, k):
        y_flat = y_flat + terms[:, j]
    y = y_flat.to(x.dtype).view(b, s, d)

    if cfg.num_shared_experts:
        get = (lora or {}).get
        y = y + L.mlp(cfg, p["shared"], x, get("mlp_in"), get("mlp_out"),
                      gates)
    return y, aux
