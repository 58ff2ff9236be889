"""K3: causal (+ sliding-window) GQA flash attention for prefill.

``flash_attention`` launches the CUDA kernel of
``csrc/flash_attention.cu`` on a CUDA tensor and runs
``flash_attention_plain`` on a CPU tensor.  It replaces the Pallas
kernel ``repro/kernels/flash_attention/kernel.py::flash_attention``:
q (B, H, S, D), k/v (B, KVH, S, D) -> (B, H, S, D), query head h reading
KV head h // (H // KVH), masked scores at NEG_INF = -2**30.  Unlike the
Pallas kernel, S need not be a multiple of a block: a prefill is exactly
as long as its prompt.  The CUDA kernel takes bfloat16 and head_dim 256
(the 2b pair at full width) or 32 (its reduced configs).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

NEG_INF = -2.0 ** 30
HEAD_DIMS = (32, 256)
_CTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7 + (
    ctypes.c_float, ctypes.c_void_p)


def attention_mask(s: int, causal: bool, window: int,
                   device) -> torch.Tensor:
    """(S, S) bool visibility of key k_pos from query q_pos."""
    qp = torch.arange(s, device=device)[:, None]
    kp = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: an f32 softmax over the
    masked scores (the port of ``flash_attention/ref.py``)."""
    b, h, s, d = q.shape
    group = h // k.shape[1]
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) / math.sqrt(d)
    mask = attention_mask(s, causal, window, q.device)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


@functools.cache
def _lib():
    lib = build.load("flash_attention")
    lib.flash_attention_bf16.argtypes = _CTYPES
    lib.flash_attention_bf16.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, H, S, D); k/v (B, KVH, S, D) -> (B, H, S, D)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: q must be (B, H, S, D) and k, v "
                         "(B, KVH, S, D)")
    b, h, s, d = q.shape
    kvh = k.shape[1]
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d \
            or kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: mismatched shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_attention: the CUDA kernel takes bfloat16, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v must share a device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    out = torch.empty_like(q)
    rc = _lib().flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, kvh,
        s, d, int(causal), int(window), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
