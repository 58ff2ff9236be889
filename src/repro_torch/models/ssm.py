"""Mamba-1 (falcon-mamba) and Mamba-2/SSD (zamba2) state-space blocks —
the port of ``repro/models/ssm.py``.

Mamba-1 prefill runs the selective scan through K6 (``kernels/ssm_scan``:
the CUDA kernel on a CUDA tensor, its plain step-by-step version on a
CPU tensor); decode is the O(1) single-step recurrence against (conv
state, ssm state) in plain torch ops, as the reference writes it in jnp
outside any kernel.  Train mode is the prefill's scan with a gradient:
K6 forward and K10 backward (``ssm_scan_train``), and no state.

LoRA on the four projections, as the reference puts it
(``repro/models/ssm.py:111-150``): ``ssm_in`` on ``in_proj``, ``ssm_x``
on ``x_proj``, ``ssm_dt`` on ``dt_proj`` (its bias added before the
delta, as ``layers.linear`` adds it) and ``ssm_out`` on ``out_proj``,
each through ``layers.lora_delta`` (K5/K9 for float gates, K4 for
integer slots at decode).  dt_proj's input is a column slice of
x_proj's output, which ``lora_delta`` copies once into a contiguous
(T, dt_rank) operand for K4/K5/K9.

The reference's prefill scan is chunked (``_mamba1_inner``: chunk 128)
and asserts s % min(128, s) == 0, so it serves prompts of at most 128
tokens or a multiple of 128, and trains on such sequences.  The port
keeps that rule in prefill and train mode and refuses the other lengths
with a ``ValueError``, although K6 and K10 take any length.

Mamba-2 (``mamba2_block``, the reference's ``ssm.py:192-247``): one
in_proj into [z | xBC | dt], the causal conv over xBC's d_inner + 2 G N
channels, per-head scalar decays a = -exp(A_log), and the SSD scan over
H = d_inner / P heads of P channels and N states, through K11
(``kernels/ssd_scan``) in prefill mode, which reads x, B and C in place
as column slices of the conv output; decode is the O(1) recurrence in
plain torch, as the reference's jnp.  The D skip is added in float32,
then the gated RMSNorm over d_inner and out_proj.  LoRA on ``ssm_in``
(in_proj) and ``ssm_out`` (out_proj).  The reference's 256-token chunk
rule (``ssm.py:226-227``) is kept as a ``ValueError``.  Train mode
differentiates the plain chunk loop on the CPU; on CUDA it runs K11 with
its chunk states forward and K12 backward (``ssd_scan_train``), whose
gradients reach xBC's columns through the column views autograd keeps.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.kernel import ssd_scan, ssd_scan_train
from repro_torch.kernels.ssm_scan.kernel import ssm_scan, ssm_scan_train
from repro_torch.models import layers as L

# the reference's mamba1_block and mamba2_block default chunks
CHUNK = 128
SSD_CHUNK = 256


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: (B, S, C); w: (k, C); b: (C,).

    With ``conv_state`` (B, k-1, C) (decode) it is the left context;
    otherwise the input is zero-padded (prefill).  The conv runs in
    float32 and rounds to x's dtype before the bias, as the reference's.
    Returns (y, the last k-1 inputs of the context) — zero padding
    included when S < k-1 — for the cache."""
    k, s = w.shape[0], x.shape[1]
    if conv_state is not None:
        ctx = torch.cat([conv_state, x], dim=1)            # (B, k-1+S, C)
    else:
        ctx = F.pad(x, (0, 0, k - 1, 0))
    cf, wf = ctx.float(), w.float()
    y = cf[:, :s] * wf[0]
    for j in range(1, k):
        y = y + cf[:, j:j + s] * wf[j]
    y = y.to(x.dtype) + b.to(x.dtype)
    new_state = ctx[:, ctx.shape[1] - (k - 1):]
    return y, new_state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def check_prefill_length(s: int, chunk: int = CHUNK,
                         what: str = "Mamba-1",
                         where: str = "_mamba1_inner") -> None:
    """The reference's chunked-scan rule: s <= chunk or s % chunk == 0."""
    if s % min(chunk, s):
        raise ValueError(
            f"a {what} prefill of {s} tokens: the reference's chunked scan "
            f"(models/ssm.py {where}, chunk {chunk}) takes at most "
            f"{chunk} tokens or a multiple of {chunk}, and the port keeps "
            "its rule")


def mamba1_block(cfg, p, x: torch.Tensor, *,
                 cache: Optional[Dict[str, torch.Tensor]] = None,
                 mode: str = "prefill", lora=None, gates=None
                 ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One Mamba-1 block in ``prefill``, ``train`` or ``decode`` mode (S =
    1 against ``cache`` {"conv" (B, k-1, di), "h" (B, di, N) float32}).
    ``lora`` is this layer's {"ssm_in", "ssm_x", "ssm_dt", "ssm_out":
    {"A", "B"}} bank slice (any target may be missing) and ``gates`` its
    gates, as ``layers.lora_delta`` takes them.  Returns (out (B, S, d),
    {"conv", "h"}, the state after the last position; None in train
    mode)."""
    if mode not in ("prefill", "decode", "train"):
        raise ValueError(f"mamba1_block: mode {mode!r}")
    dtr, n = cfg.dt_rank, cfg.ssm_state
    get = (lora or {}).get
    if mode != "decode":
        check_prefill_length(x.shape[1])

    xz = L.linear(p["in_proj"], x, get("ssm_in"), gates)
    xin, z = torch.chunk(xz, 2, dim=-1)
    conv_state = cache["conv"] if mode == "decode" else None
    xin, new_conv = causal_conv(xin, p["conv_w"], p["conv_b"], conv_state)
    xin = F.silu(xin)

    xdbc = L.linear(p["x_proj"], xin, get("ssm_x"), gates)
    dt_r, bm, cm = torch.split(xdbc, [dtr, n, n], dim=-1)
    dt = softplus(L.linear(p["dt_proj"], dt_r, get("ssm_dt"),
                           gates).float())
    a = -torch.exp(p["A_log"].float())                     # (di, N)

    if mode == "decode":
        da = torch.exp(dt[:, 0, :, None] * a)              # (B, di, N)
        dbx = (dt[:, 0] * xin[:, 0].float())[..., None] \
            * bm[:, 0, None, :].float()
        h = cache["h"].float() * da + dbx
        y = torch.einsum("bdn,bn->bd", h, cm[:, 0].float())[:, None]
    elif mode == "train":
        y, h = ssm_scan_train(dt, xin, bm, cm, a), None
    else:
        y, h = ssm_scan(dt, xin, bm, cm, a)

    y = y.to(x.dtype) + xin * p["D"].to(x.dtype)
    y = y * F.silu(z)
    out = L.linear(p["out_proj"], y, get("ssm_out"), gates)
    return out, None if h is None else {"conv": new_conv, "h": h}


def mamba2_block(cfg, p, x: torch.Tensor, *,
                 cache: Optional[Dict[str, torch.Tensor]] = None,
                 mode: str = "prefill", lora=None, gates=None
                 ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One Mamba-2 block in ``prefill``, ``train`` or ``decode`` mode (S =
    1 against ``cache`` {"conv" (B, k-1, d_inner + 2 G N), "h" (B, H, P,
    N) float32}).  ``lora`` is this layer's {"ssm_in", "ssm_out": {"A",
    "B"}} bank slice (either may be missing) and ``gates`` its gates, as
    ``layers.lora_delta`` takes them.  Returns (out (B, S, d), {"conv",
    "h"}, the state after the last position; None in train mode)."""
    if mode not in ("prefill", "decode", "train"):
        raise ValueError(f"mamba2_block: mode {mode!r}")
    b, s, _ = x.shape
    di, n = cfg.d_inner, cfg.ssm_state
    g, nh, hp = cfg.ssm_ngroups, cfg.ssm_nheads, cfg.ssm_head_dim
    get = (lora or {}).get
    if mode != "decode":
        check_prefill_length(s, SSD_CHUNK, "Mamba-2", "mamba2_block")

    zxbcdt = L.linear(p["in_proj"], x, get("ssm_in"), gates)
    z, xbc, dt_raw = torch.split(zxbcdt, [di, di + 2 * g * n, nh], dim=-1)
    conv_state = cache["conv"] if mode == "decode" else None
    xbc, new_conv = causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = F.silu(xbc)
    xin, bm, cm = torch.split(xbc, [di, g * n, g * n], dim=-1)
    dt = softplus((dt_raw + p["dt_bias"].to(dt_raw.dtype)).float())
    a = -torch.exp(p["A_log"].float())                     # (H,)
    # (B, S, H, P) and (B, S, G, N) views of the conv output
    xh, bh, ch = (xin.unflatten(-1, (nh, hp)), bm.unflatten(-1, (g, n)),
                  cm.unflatten(-1, (g, n)))

    if mode == "decode":
        rep = nh // g
        bt = bh[:, 0].float().repeat_interleave(rep, dim=1)   # (B, H, N)
        ct = ch[:, 0].float().repeat_interleave(rep, dim=1)
        dec = torch.exp(dt[:, 0] * a)                          # (B, H)
        h = cache["h"].float() * dec[:, :, None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dt[:, 0], xh[:, 0].float(), bt)
        y = torch.einsum("bhpn,bhn->bhp", h, ct)[:, None]      # (B,1,H,P)
    elif mode == "train":
        y, h = ssd_scan_train(xh, bh, ch, dt.contiguous(), a), None
    else:
        y, h = ssd_scan(xh, bh, ch, dt.contiguous(), a)

    y = y + xh.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype)
    y = L.rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = L.linear(p["out_proj"], y, get("ssm_out"), gates)
    return out, None if h is None else {"conv": new_conv, "h": h}
