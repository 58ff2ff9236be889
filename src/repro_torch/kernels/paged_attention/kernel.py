"""K2: one-token GQA decode attention over a paged KV pool.

``paged_decode_attention`` launches the CUDA kernel of
``csrc/paged_attention.cu`` on a CUDA tensor and runs
``paged_decode_attention_plain`` on a CPU tensor.  It replaces the
Pallas kernel ``repro/kernels/paged_attention/kernel.py::
paged_decode_attention`` with the same contract: q (B, H, hd), pools
(P, page_size, KV, hd), table (B, n_pages) int32 page ids (the row's
block table, or its ring-local table when ``window > 0``), pos (B,)
int32 per-row absolute positions -> (B, H, hd) in q's dtype.  Query
head h reads KV head h // (H // KV); sentinel table entries are clamped
onto page P - 1 and masked by position; masked scores are
NEG_INF = -2**30, so they weigh exactly 0 once a live slot is seen.
The CUDA kernel takes bfloat16, page_size 16 and head_dim 256 (the 2b
pair at full width) or 32 (its reduced configs).  For a parked row
(pos >= FREED_POS = 2**30) it reads no page and writes zeros, where the
Pallas kernel and the plain version attend over clamped garbage: the
engine never reads a parked row's output.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

NEG_INF = -2.0 ** 30
HEAD_DIMS = (32, 256)
PAGE_SIZE = 16
_CTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 8 + (
    ctypes.c_float, ctypes.c_void_p)


def paged_decode_attention_plain(q, pool_k, pool_v, table, pos, *,
                                 window: int = 0):
    """The kernel's function in plain PyTorch (the port of
    ``paged_attention/ref.py``): gather each row's mapped pages, f32
    scores, an f32 softmax over the live slots, output in q's dtype."""
    b, h, hd = q.shape
    n_pool, ps, kvh, _ = pool_k.shape
    nb = table.shape[1]
    group = h // kvh
    n_slots = window if window else nb * ps
    j = torch.arange(n_slots, device=q.device)
    pid = table[:, j // ps].long()                              # (B, n)
    flat = pid.clamp(0, n_pool - 1) * ps + (j % ps)[None, :]
    k = pool_k.reshape(n_pool * ps, kvh, hd)[flat]              # (B,n,KV,hd)
    v = pool_v.reshape(n_pool * ps, kvh, hd)[flat]
    pos = pos.long()[:, None]
    if window:
        kv_pos = pos - torch.remainder(pos - j[None, :], window)
        mask = (kv_pos >= 0) & (kv_pos <= pos)
    else:
        mask = j[None, :] <= pos
    kk = k.float().repeat_interleave(group, dim=2)              # (B,n,H,hd)
    vv = v.float().repeat_interleave(group, dim=2)
    scores = torch.einsum("bhd,bnhd->bhn", q.float(), kk) / math.sqrt(hd)
    scores = torch.where(mask[:, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhn,bnhd->bhd", p, vv).to(q.dtype)


@functools.cache
def _lib():
    lib = build.load("paged_attention")
    lib.paged_decode_attention_bf16.argtypes = _CTYPES
    lib.paged_decode_attention_bf16.restype = ctypes.c_int
    return lib


def paged_decode_attention(q, pool_k, pool_v, table, pos, *,
                           window: int = 0):
    """q (B, H, hd); pools (P, ps, KV, hd); table (B, nb) int32; pos
    (B,) int32 -> (B, H, hd)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, pool_k, pool_v, table, pos,
                                            window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    if q.dim() != 3 or pool_k.dim() != 4 or pool_v.shape != pool_k.shape:
        raise ValueError("paged_decode_attention: q must be (B, H, hd) and "
                         "the pools (P, page_size, KV, hd)")
    b, h, hd = q.shape
    n_pool, ps, kvh, hd_k = pool_k.shape
    if hd_k != hd or kvh == 0 or h % kvh or n_pool == 0:
        raise ValueError(f"paged_decode_attention: mismatched shapes q "
                         f"{tuple(q.shape)}, pool {tuple(pool_k.shape)}")
    if table.dim() != 2 or table.shape[0] != b or pos.shape != (b,):
        raise ValueError("paged_decode_attention: table must be (B, nb) "
                         "and pos (B,)")
    nb = table.shape[1]
    if window and nb * ps < window:
        raise ValueError(f"paged_decode_attention: {nb} pages of {ps} "
                         f"cannot hold a window of {window}")
    if hd not in HEAD_DIMS or ps != PAGE_SIZE:
        raise ValueError(f"paged_decode_attention: the CUDA kernel takes "
                         f"head_dim in {HEAD_DIMS} and page_size "
                         f"{PAGE_SIZE}, got {hd} and {ps}")
    if not (q.dtype == pool_k.dtype == pool_v.dtype == torch.bfloat16):
        raise TypeError(f"paged_decode_attention: the CUDA kernel takes "
                        f"bfloat16, got {q.dtype}/{pool_k.dtype}/"
                        f"{pool_v.dtype}")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("paged_decode_attention: table and pos must be "
                        "int32")
    for t in (pool_k, pool_v, table, pos):
        if t.device != q.device:
            raise ValueError("paged_decode_attention: all inputs must be "
                             "on one device")
        if not t.is_contiguous():
            raise ValueError("paged_decode_attention: inputs must be "
                             "contiguous")
    if not q.is_contiguous():
        raise ValueError("paged_decode_attention: inputs must be contiguous")
    out = torch.empty_like(q)
    rc = _lib().paged_decode_attention_bf16(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        table.data_ptr(), pos.data_ptr(), out.data_ptr(), b, h, kvh, hd,
        n_pool, ps, nb, int(window), 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
