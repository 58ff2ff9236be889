"""K3: causal (+ sliding-window) GQA flash attention for prefill.

``flash_attention`` launches the CUDA kernel of
``csrc/flash_attention.cu`` on a CUDA tensor and runs
``flash_attention_plain`` on a CPU tensor.  It replaces the Pallas
kernel ``repro/kernels/flash_attention/kernel.py::flash_attention``:
q (B, H, S, D), k/v (B, KVH, S, D) -> (B, H, S, D), query head h reading
KV head h // (H // KVH), masked scores at NEG_INF = -2**30.  Unlike the
Pallas kernel, S need not be a multiple of a block: a prefill is exactly
as long as its prompt.  The CUDA kernel takes bfloat16 and head_dim 256
(the 2b pair at full width), 112 (zamba2-7b's shared attention block),
64 (granite-moe-3b-a800m, a GQA group of 3) or 32 (their reduced
configs).

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

Training (``flash_attention_train``, the ``FlashAttentionFn`` autograd
function): the forward is K3 with ``return_lse=True`` (each row's
natural-log log-sum-exp, (B, H, S) f32, written through the kernel's
optional LSE pointer; serving calls pass it null and keep their bits),
the backward is K8 (``flash_attention_bwd``, ``csrc/flash_attention_bwd.cu``,
no Pallas original: the reference differentiates its jnp
``chunked_causal_attention``, ``repro/models/attention.py:82``), causal,
with or without a sliding window (gemma3's local layers: key j visible
from query i iff i - window < j <= i, K3's mask), without a history.
K8 reads q, k, v, o and dO in the
layouts K3 takes and returns dq, dk, dv as (B, H, S, D) views of (B, S,
H, D) memory; a dO in another layout is made contiguous first.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -2.0 ** 30
HEAD_DIMS = (32, 64, 112, 256)
# K8's head dims: the 2b SLM's, zamba2's shared block's, granite-moe's,
# their reduced
BWD_HEAD_DIMS = (32, 64, 112, 256)
_CTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 8 + (
    ctypes.c_float, ctypes.c_void_p)
_BWD_CTYPES = (ctypes.c_void_p,) * 11 + (ctypes.c_int,) * 7 + (
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


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, *,
                        causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """(B, H, S) f32 natural-log log-sum-exp of each query row's scaled,
    masked scores: the statistic K3 writes for the backward."""
    b, h, s, d = q.shape
    kk = k.repeat_interleave(h // k.shape[1], dim=1).float()
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) / math.sqrt(d)
    mask = attention_mask(s, causal, window, q.device)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    return torch.logsumexp(scores, dim=-1)


def flash_attention_bwd_plain(q, k, v, o, do, lse, *, causal: bool = True,
                              window: int = 0):
    """K8's function in plain PyTorch, in f32: P = exp(q k^T scale - lse)
    under the mask (causal, and with a ``window`` the sliding window), dV = P^T dO and dK = dS^T q scale summed over each KV
    head's group of query heads, dQ = dS k scale, dS = P (dO v^T - D),
    D = rowsum(dO o).  Returns (dq, dk, dv) in the inputs' dtype."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    qf, dof, of = q.float(), do.float(), o.float()
    kk = k.repeat_interleave(g, dim=1).float()
    vv = v.repeat_interleave(g, dim=1).float()
    mask = attention_mask(s, causal, window, q.device)
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kk) * scale
    p = torch.where(mask, torch.exp(scores - lse[..., None]),
                    torch.zeros_like(scores))
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vv)
    di = (dof * of).sum(-1, keepdim=True)
    ds = p * (dp - di)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dk.reshape(b, kvh, g, s, d).sum(2)
    dv = dv.reshape(b, kvh, g, s, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _lib():
    lib = build.load("flash_attention")
    lib.flash_attention_bf16.argtypes = _CTYPES
    lib.flash_attention_bf16.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_lib():
    lib = build.load("flash_attention_bwd")
    lib.flash_attention_bwd_bf16.argtypes = _BWD_CTYPES
    lib.flash_attention_bwd_bf16.restype = ctypes.c_int
    lib.flash_attention_bwd_scratch.argtypes = (ctypes.c_int,) * 5
    lib.flash_attention_bwd_scratch.restype = ctypes.c_longlong
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
                    hist_v: Optional[torch.Tensor] = None,
                    return_lse: bool = False):
    """q (B, H, S, D); k/v (B, KVH, S, D) -> (B, H, S, D); with a
    history hist_k/hist_v (1, KVH, P, D) the queries sit at
    positions P + i and attend over [history; fresh].  With
    ``return_lse`` (no history) returns (out, lse (B, H, S) f32)."""
    strides = check_layout(q, k, v)
    hist_strides = check_history(q, k, hist_k, hist_v)
    if return_lse and hist_k is not None:
        raise ValueError("flash_attention: return_lse takes no history")
    if q.device.type == "cpu":
        out = flash_attention_plain(q, k, v, causal=causal, window=window,
                                    hist_k=hist_k, hist_v=hist_v)
        out = out.transpose(1, 2).contiguous().transpose(1, 2)
        if return_lse:
            return out, attention_lse_plain(q, k, causal=causal,
                                            window=window)
        return out
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
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) \
        if return_lse else None
    rc = _lib().flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), hk, hv, out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        (ctypes.c_longlong * 18)(*strides, *_layout("out", out),
                                 *hist_strides),
        b, h, kvh, s, hist, d, int(causal), int(window),
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    flash_attention.windowed_launches += bool(window)
    flash_attention.offset_launches += hist_k is not None
    return (out, lse) if return_lse else out


def _bhsd(shape, like: torch.Tensor) -> torch.Tensor:
    """An empty (B, N, S, D) view of (B, S, N, D) memory."""
    b, n, s, d = shape
    return torch.empty((b, s, n, d), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _strides_bhs(t: torch.Tensor) -> list:
    """(batch, head, position) element strides of a (B, N, S, D) tensor
    as K8 takes them (``_layout``'s order is (S, N, B))."""
    ss, sh, sb = _layout("K8 operand", t)
    return [sb, sh, ss]


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        window: int = 0):
    """K8: the gradients (dq, dk, dv) of causal GQA attention, within a
    sliding ``window`` when it is > 0, from q (B, H, S, D), k/v (B, KVH,
    S, D), the forward output o, its gradient do and the forward's row
    LSE (B, H, S) f32 (K3's, with the same window).  On CUDA it launches the
    kernel of ``csrc/flash_attention_bwd.cu`` (bf16, head_dim 32, 64, 112
    or 256) or raises; on the CPU it runs ``flash_attention_bwd_plain``."""
    check_layout(q, k, v)
    if o.shape != q.shape or do.shape != q.shape \
            or lse.shape != q.shape[:3]:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)} and lse {tuple(lse.shape)} must "
                         f"match q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                         window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    b, h, s, d = q.shape
    kvh = k.shape[1]
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head_dim {d} not in "
                         f"{BWD_HEAD_DIMS}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v, o, do)) \
            or lse.dtype != torch.float32:
        raise TypeError("flash_attention_bwd: the CUDA kernel takes "
                        "bfloat16 q, k, v, o, dO and an f32 LSE")
    if any(t.device != q.device for t in (k, v, o, do, lse)):
        raise ValueError("flash_attention_bwd: every input must share a "
                         "device")
    try:
        _layout("dO", do)
    except ValueError:
        do = do.contiguous()
    lse = lse.contiguous()
    dq, dk, dv = _bhsd(q.shape, q), _bhsd(k.shape, k), _bhsd(v.shape, v)
    lib = _bwd_lib()
    # D_i (B, H, S), then the dK/dV pass's f32 parts when it splits heads
    di = torch.empty(lib.flash_attention_bwd_scratch(b, h, kvh, s, d),
                     dtype=torch.float32, device=q.device)
    strides = []
    for t in (q, k, v, o, do, dq, dk, dv):
        strides += _strides_bhs(t)
    rc = lib.flash_attention_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), (ctypes.c_longlong * 24)(*strides),
        b, h, kvh, s, d, int(causal), int(window), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.windowed_launches += bool(window)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Causal GQA attention, within a sliding window when ``window`` >
    0, with a gradient: K3 forward (saving its row LSE), K8 backward."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        out, lse = flash_attention(q, k, v, causal=True, window=window,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, out, do, lse, causal=True,
                                   window=ctx.window) + (None,)


def flash_attention_train(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Causal attention of a training forward, windowed when ``window``
    > 0: q (B, H, S, D), k/v (B, KVH, S, D) -> (B, H, S, D),
    differentiable through K3 and K8."""
    return FlashAttentionFn.apply(q, k, v, window)


# launches of the kernel, and of those the windowed ones (window > 0) and
# the history-offset ones
flash_attention.launches = 0
flash_attention.windowed_launches = 0
flash_attention.offset_launches = 0
flash_attention_bwd.launches = 0
flash_attention_bwd.windowed_launches = 0
