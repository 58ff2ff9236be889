"""Core layer primitives — the port of ``repro/models/layers.py``
(``rmsnorm``, ``linear`` without LoRA or bias, ``rope``, ``mlp``,
``embed``, tied ``unembed``).

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


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * p["scale"].float()).to(dt)


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W in the activation dtype (float32 accumulation)."""
    return torch.matmul(x, p["w"])


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device), exps)
    ang = positions[..., None].float() * freq              # (..., S, half)
    sin = torch.sin(ang)[..., None, :]                     # (..., S, 1, half)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp(cfg, p, x: torch.Tensor) -> torch.Tensor:
    h = linear(p["in"], x)
    if cfg.mlp_type in ("swiglu", "geglu"):
        g, u = torch.chunk(h, 2, dim=-1)
        # jax.nn.gelu defaults to the tanh approximation
        act = F.silu(g) if cfg.mlp_type == "swiglu" \
            else F.gelu(g, approximate="tanh")
        h = act * u
    else:
        h = F.gelu(h, approximate="tanh")
    return linear(p["out"], h)


def embed(cfg, p, tokens: torch.Tensor) -> torch.Tensor:
    x = p["tok"]["w"][tokens]
    if cfg.embed_scale:
        # the scale is rounded to the activation dtype first, as in the
        # reference: in bf16, sqrt(3072) = 55.43 becomes 55.5
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., k) @ w (k, n) with float32 accumulation and output."""
    if x.dtype == torch.bfloat16 and x.is_cuda:
        lead = x.shape[:-1]
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*lead, w.shape[-1])
    return torch.matmul(x.float(), w.float())


def unembed(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """Float32 logits (..., V) through the tied embedding."""
    return _matmul_f32(x, p["tok"]["w"].t())
