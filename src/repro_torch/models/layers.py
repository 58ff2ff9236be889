"""Core layer primitives — the port of ``repro/models/layers.py``
(``rmsnorm`` and the ``norm`` dispatch, ``linear`` with an optional bias
and its merged multi-LoRA delta ``lora_delta``, ``rope``, ``mlp``,
``embed``, tied and untied ``unembed``).

Parameters are plain dicts of tensors in the reference's layout:
weights ``(in, out)``, norm scales ``(d,)``, the embedding ``(V, d)``.
Rounding follows the reference: norms, rope and the unembedding compute
in float32, a projection rounds its float32-accumulated product back
to the activation dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_lora.kernel import (moe_lora_delta,
                                                 moe_lora_delta_slots,
                                                 moe_lora_delta_train)


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * p["scale"].float()).to(dt)


def norm(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """The config's norm: RMSNorm (LayerNorm is a later slice)."""
    if cfg.norm_type != "rmsnorm":
        raise NotImplementedError(f"{cfg.norm_type}: later slice")
    return rmsnorm(p, x, cfg.norm_eps)


def linear(p, x: torch.Tensor, lora=None, gates=None) -> torch.Tensor:
    """y = x @ W in the activation dtype (float32 accumulation), plus the
    bias ``b`` (added after the product is rounded, as the reference
    adds it) and the Floe merged-LoRA delta Σ_j ω_j · x A_jᵀ B_jᵀ rounded
    to that dtype when ``lora`` = {"A": (E, r, d_in), "B": (E, d_out, r)}
    is given."""
    y = torch.matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    if lora is not None:
        y = y + lora_delta(lora, x, gates).to(y.dtype)
    return y


def lora_delta(lora, x: torch.Tensor, gates) -> torch.Tensor:
    """Σ_j ω_j B_j A_j x (paper Eq. 8), float32, shaped (..., d_out).

    ``gates``: float (B, E) per-request weights (row b's gate covers
    every position of x[b]), float (E,) global weights, None (every
    expert at weight 1, the reference's ungated sum) — all through K5
    ``moe_lora_delta`` — or a 1-D INTEGER tensor of per-row adapter
    slots (negative = no adapter) through K4 ``moe_lora_delta_slots``,
    the slot kernel's decode path.

    A ``rank_mask`` leaf (E, r) (adaptive-rank compression Q_r) multiplies
    A's rank rows before the launch, so a masked rank's (A m) x is an
    exact 0, as the reference's u * m is, on either kernel.

    With a gradient (autograd on, and x, A or B requiring one): on CUDA
    K5 runs inside ``moe_lora_delta_train`` (backward K9); on the CPU the
    plain version runs under autograd.  Gates that require a gradient,
    and integer slots (K4 has no backward), raise."""
    a, b = lora["A"], lora["B"]
    if "rank_mask" in lora:
        m = lora["rank_mask"]
        if tuple(m.shape) != tuple(a.shape[:2]):
            raise ValueError(f"rank_mask {tuple(m.shape)} does not fit the "
                             f"bank's (E, r) = {tuple(a.shape[:2])}")
        a = a * m.to(a)[:, :, None]
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or a.requires_grad or b.requires_grad)
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1]).contiguous()
    if gates is not None and gates.dim() == 1 \
            and not gates.is_floating_point():
        if needs_grad:
            raise NotImplementedError("integer-slot LoRA (K4) has no "
                                      "backward: train with float gates")
        delta = moe_lora_delta_slots(xf, a, b, gates.to(torch.int32),
                                     xf.shape[0] // gates.shape[0])
    else:
        if gates is None:
            gates = torch.ones((1, a.shape[0]), device=x.device)
        elif gates.dim() == 1:
            gates = gates[None]
        if gates.requires_grad:
            raise ValueError("lora_delta: the gates take no gradient")
        fn = moe_lora_delta_train if needs_grad and x.is_cuda \
            else moe_lora_delta
        delta = fn(xf, a, b, gates.float(), xf.shape[0] // gates.shape[0])
    return delta.reshape(*lead, b.shape[1])


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S)."""
    return rope_turn(x, rope_angles(positions, x.shape[-1], theta,
                                    x.device))


def rope_angles(positions: torch.Tensor, hd: int, theta: float,
                device: torch.device):
    """(cos, sin) of rope's angles at ``positions`` (broadcastable to
    (..., S)), each (..., S, 1, hd // 2) f32: computed once, they turn
    attention's q and k alike (``rope_turn``)."""
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    # torch.full, not torch.tensor: a fill on the device, where a copy
    # from pageable host memory could not be captured in a CUDA graph
    freq = torch.pow(torch.full((), theta, dtype=torch.float32,
                                device=device), exps)
    ang = positions[..., None].float() * freq              # (..., S, half)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rope_turn(x: torch.Tensor, angles) -> torch.Tensor:
    """x: (..., S, H, hd) turned by ``rope_angles``' (cos, sin)."""
    cos, sin = angles
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp(cfg, p, x: torch.Tensor, lora_in=None, lora_out=None,
        gates=None) -> torch.Tensor:
    h = linear(p["in"], x, lora_in, gates)
    if cfg.mlp_type in ("swiglu", "geglu"):
        g, u = torch.chunk(h, 2, dim=-1)
        # jax.nn.gelu defaults to the tanh approximation
        act = F.silu(g) if cfg.mlp_type == "swiglu" \
            else F.gelu(g, approximate="tanh")
        h = act * u
    else:
        h = F.gelu(h, approximate="tanh")
    return linear(p["out"], h, lora_out, gates)


def embed(cfg, p, tokens: torch.Tensor) -> torch.Tensor:
    x = p["tok"]["w"][tokens]
    if cfg.embed_scale:
        # the scale is rounded to the activation dtype first, as in the
        # reference: in bf16, sqrt(3072) = 55.43 becomes 55.5
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype,
                           device=x.device)
    return x


class _MatmulF32(torch.autograd.Function):
    """x (T, k) bf16 @ w (k, n) bf16 -> f32 on CUDA with a gradient for x
    (``torch.mm``'s ``out_dtype`` form has none): dx = dy w^T in f32, the
    reference's transpose of its f32-preferring dot, rounded to x's
    dtype.  w's rows are cast to f32 a block at a time, so no f32 copy
    of a (V, d) embedding is held whole."""

    _BLOCK = 1 << 15

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, dy):
        (w,) = ctx.saved_tensors
        dx = None
        for lo in range(0, w.shape[1], _MatmulF32._BLOCK):
            hi = min(lo + _MatmulF32._BLOCK, w.shape[1])
            part = torch.mm(dy[:, lo:hi], w[:, lo:hi].float().t())
            dx = part if dx is None else dx + part
        return dx.to(torch.bfloat16), None


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., k) @ w (k, n) with float32 accumulation and output."""
    if x.dtype == torch.bfloat16 and x.is_cuda:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and x.requires_grad:
            y = _MatmulF32.apply(x2, w)
        else:
            y = torch.mm(x2, w, out_dtype=torch.float32)
        return y.reshape(*lead, w.shape[-1])
    return torch.matmul(x.float(), w.float())


def unembed(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """Float32 logits (..., V) through the tied embedding, or through
    the untied ``unembed`` projection (d, V)."""
    if cfg.tie_embeddings:
        return _matmul_f32(x, p["tok"]["w"].t())
    return _matmul_f32(x, p["unembed"]["w"])
