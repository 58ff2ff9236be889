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

History-offset mode (``hist_k``/``hist_v`` of P positions): the queries
sit at absolute positions P + i and attend over the P history positions
0..P-1 ahead of the S fresh ones, key j visible iff its position is
<= P + i (and, with a window, > P + i - window) — the suffix and chunk
prefills of COW prefix sharing and chunked prefill, which the reference
computes in jnp over [history; fresh] (``repro/models/attention.py:
327-342``; its Pallas kernel takes q_len == kv_len only).  The history
is (1, KVH, P, D), shared by every row: it is read in place, never
expanded.

Layout: q, k and v may be strided views, as ``x.transpose(1, 2)`` of a
model's (B, S, H, D) projection gives them: a unit stride over D, every
other stride (of a dimension longer than 1) a multiple of 16 bytes, and
16-byte aligned data.  The result is a (B, H, S, D) view whose
``transpose(1, 2)`` is contiguous.  Any other layout raises a
``ValueError`` on every device.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -2.0 ** 30
HEAD_DIMS = (32, 256)
_CTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 8 + (
    ctypes.c_float, ctypes.c_void_p)


def attention_mask(s: int, causal: bool, window: int, device,
                   hist: int = 0) -> torch.Tensor:
    """(S, P + S) bool visibility of key position k_pos (0..P+S-1) from
    the query at position P + i, behind a history of P = ``hist``."""
    qp = hist + torch.arange(s, device=device)[:, None]
    kp = torch.arange(hist + s, device=device)[None, :]
    mask = torch.ones((s, hist + s), dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          hist_k: Optional[torch.Tensor] = None,
                          hist_v: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: an f32 softmax over the
    masked scores (the port of ``flash_attention/ref.py``), over
    [history; fresh] in the history-offset mode."""
    b, h, s, d = q.shape
    hist = 0
    if hist_k is not None:
        hist = hist_k.shape[2]
        k = torch.cat([hist_k.expand(b, -1, -1, -1), k], dim=2)
        v = torch.cat([hist_v.expand(b, -1, -1, -1), v], dim=2)
    group = h // k.shape[1]
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) / math.sqrt(d)
    mask = attention_mask(s, causal, window, q.device, hist)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


@functools.cache
def _lib():
    lib = build.load("flash_attention")
    lib.flash_attention_bf16.argtypes = _CTYPES
    lib.flash_attention_bf16.restype = ctypes.c_int
    return lib


def _layout(name: str, t: torch.Tensor) -> list:
    """Element strides of a (B, N, S, D) tensor over (S, N, B) as the
    kernel's tensor maps take them; a dimension of size 1 gets the stride
    a contiguous tensor would give it.  Raises ``ValueError`` unless the
    stride over D is 1, the others are multiples of 16 bytes and the data
    is 16-byte aligned."""
    nb, nh, ns, d = t.shape
    sb, sh, ss, sd = t.stride()
    if sd != 1 and d > 1:
        raise ValueError(f"flash_attention: {name} needs a unit stride over "
                         f"head_dim, got strides {t.stride()}")
    unit = max(1, 16 // t.element_size())          # elements in 16 bytes
    if (ns > 1 and ss % unit) or (nh > 1 and sh % unit) \
            or (nb > 1 and sb % unit) or t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} strides {t.stride()} "
                         "must be multiples of 16 bytes and its data "
                         "16-byte aligned")
    return [ss if ns > 1 else d, sh if nh > 1 else d * ns,
            sb if nb > 1 else d * ns * nh]


def check_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> list:
    """Raise ``ValueError`` unless q (B, H, S, D) and k, v (B, KVH, S, D)
    have matching shapes and a layout the CUDA kernel reads in place;
    returns the nine strides of q, k, v that ``_layout`` gives."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: q must be (B, H, S, D) and k, v "
                         "(B, KVH, S, D)")
    b, h, s, d = q.shape
    kvh = k.shape[1]
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d \
            or kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: mismatched shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    return _layout("q", q) + _layout("k", k) + _layout("v", v)


def check_history(q: torch.Tensor, k: torch.Tensor, hist_k, hist_v) -> list:
    """Raise ``ValueError`` unless the history hist_k, hist_v (1, KVH,
    P, D) matches k and has a layout the CUDA kernel reads in place;
    returns its six strides (zeros without a history)."""
    if (hist_k is None) != (hist_v is None):
        raise ValueError("flash_attention: hist_k and hist_v go together")
    if hist_k is None:
        return [0] * 6
    if hist_k.dim() != 4 or hist_v.shape != hist_k.shape \
            or hist_k.shape[0] != 1 \
            or hist_k.shape[1] != k.shape[1] or hist_k.shape[3] != k.shape[3] \
            or hist_k.shape[2] < 1:
        raise ValueError(f"flash_attention: history {tuple(hist_k.shape)} "
                         f"does not match k {tuple(k.shape)}")
    return _layout("hist_k", hist_k) + _layout("hist_v", hist_v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    hist_k: Optional[torch.Tensor] = None,
                    hist_v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, H, S, D); k/v (B, KVH, S, D) -> (B, H, S, D); with a
    history hist_k/hist_v (1, KVH, P, D) the queries sit at
    positions P + i and attend over [history; fresh]."""
    strides = check_layout(q, k, v)
    hist_strides = check_history(q, k, hist_k, hist_v)
    if q.device.type == "cpu":
        out = flash_attention_plain(q, k, v, causal=causal, window=window,
                                    hist_k=hist_k, hist_v=hist_v)
        return out.transpose(1, 2).contiguous().transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, h, s, d = q.shape
    kvh = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    ts = (q, k, v) if hist_k is None else (q, k, v, hist_k, hist_v)
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise TypeError(f"flash_attention: the CUDA kernel takes bfloat16, "
                        f"got {[t.dtype for t in ts]}")
    if any(t.device != q.device for t in ts):
        raise ValueError("flash_attention: q, k, v and the history must "
                         "share a device")
    hist = hk = hv = 0
    if hist_k is not None:
        hist = hist_k.shape[2]
        hk, hv = hist_k.data_ptr(), hist_v.data_ptr()
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    rc = _lib().flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), hk, hv, out.data_ptr(),
        (ctypes.c_longlong * 18)(*strides, *_layout("out", out),
                                 *hist_strides),
        b, h, kvh, s, hist, d, int(causal), int(window),
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    flash_attention.windowed_launches += bool(window)
    flash_attention.offset_launches += hist_k is not None
    return out


# launches of the kernel, and of those the windowed ones (window > 0) and
# the history-offset ones
flash_attention.launches = 0
flash_attention.windowed_launches = 0
flash_attention.offset_launches = 0
