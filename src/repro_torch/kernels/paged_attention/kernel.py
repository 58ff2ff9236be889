"""K2: one-token GQA decode attention over a paged KV pool.

``paged_decode_attention`` launches the CUDA kernel of
``csrc/paged_attention.cu`` on a CUDA tensor and runs
``paged_decode_attention_plain`` on a CPU tensor.  It replaces the
Pallas kernel ``repro/kernels/paged_attention/kernel.py::
paged_decode_attention`` with the same contract: q (B, H, hd), pools
(P, page_size, KV, hd), table (B, n_pages) int32 page ids (the row's
block table, or its ring-local table when ``window > 0`` and ``ring``),
pos (B,) int32 per-row absolute positions -> (B, H, hd) in q's dtype.
A window with ``ring=False`` reads the row's full-length block table
(slot j is position j) and masks slots below pos - window + 1; the
CUDA kernel then walks only the pages those live slots touch, at most
ceil((window - 1) / page_size) + 1 of them (the reference gathers the
whole table and masks it, ``attention.py:366-371``).  Query
head h reads KV head h // (H // KV); sentinel table entries are clamped
onto page P - 1 and masked by position; masked scores are
NEG_INF = -2**30, so they weigh exactly 0 once a live slot is seen.
The CUDA kernel takes bfloat16, page_size 16, head_dim 256 (the 2b
pair at full width) or 32 (its reduced configs) and H // KV in
{1, 2, 4, 8}.  It splits each row's pages over many CTAs (split-K,
flash-decoding) and combines the partials in a fixed order;
``paged_decode_splitk_model`` is that two-stage algorithm in plain
PyTorch, for the tests only.  For a parked row (pos >= FREED_POS =
2**30) the kernel reads no page and writes zeros, where the Pallas
kernel and the plain version attend over clamped garbage: the engine
never reads a parked row's output.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

NEG_INF = -2.0 ** 30
FREED_POS = 1 << 30
HEAD_DIMS = (32, 256)
GROUPS = (1, 2, 4, 8)
PAGE_SIZE = 16
_CTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 9 + (
    ctypes.c_float, ctypes.c_void_p)


def paged_decode_attention_plain(q, pool_k, pool_v, table, pos, *,
                                 window: int = 0, ring: bool = True):
    """The kernel's function in plain PyTorch (the port of
    ``paged_attention/ref.py``): gather each row's mapped pages, f32
    scores, an f32 softmax over the live slots, output in q's dtype."""
    b, h, hd = q.shape
    n_pool, ps, kvh, _ = pool_k.shape
    nb = table.shape[1]
    group = h // kvh
    ring = bool(window) and ring
    n_slots = window if ring else nb * ps
    j = torch.arange(n_slots, device=q.device)
    pid = table[:, j // ps].long()                              # (B, n)
    flat = pid.clamp(0, n_pool - 1) * ps + (j % ps)[None, :]
    k = pool_k.reshape(n_pool * ps, kvh, hd)[flat]              # (B,n,KV,hd)
    v = pool_v.reshape(n_pool * ps, kvh, hd)[flat]
    pos = pos.long()[:, None]
    if ring:
        kv_pos = pos - torch.remainder(pos - j[None, :], window)
        mask = (kv_pos >= 0) & (kv_pos <= pos)
    else:
        mask = j[None, :] <= pos
        if window:
            mask &= j[None, :] > pos - window
    kk = k.float().repeat_interleave(group, dim=2)              # (B,n,H,hd)
    vv = v.float().repeat_interleave(group, dim=2)
    scores = torch.einsum("bhd,bnhd->bhn", q.float(), kk) / math.sqrt(hd)
    scores = torch.where(mask[:, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhn,bnhd->bhd", p, vv).to(q.dtype)


def paged_decode_splitk_model(q, pool_k, pool_v, table, pos, *,
                              window: int = 0, ring: bool = True,
                              splits: int, skip_dead: bool = True):
    """The CUDA kernel's two-stage algorithm in plain PyTorch, for the
    tests (nothing on the serving path calls it).  Each row's covered
    pages (nb, the ring's ceil(window / ps), or a full-length window's
    ceil((window - 1) / ps) + 1 from the page of pos - window + 1) are
    cut into ``splits`` ranges of ceil(cover / splits) pages; a range is
    clipped to the row's live pages (min(cover, pos // ps + 1), or the
    pages up to pos // ps of a full-length window), and an empty one is
    skipped; ``skip_dead=False`` keeps every covered page of the table
    instead, as the Pallas kernel walks them, so splits whose slots
    exist but are all masked reach the combine and must weigh 0 through
    exp(m_s - m_row).
    A range's partial is (m, l, O): its masked f32 score maximum, the sum
    of exp(score - m) and the unnormalised exp-weighted sum of V.  The
    partials are combined in ascending split order with weights
    exp(m_s - m_row).  A parked row (pos >= FREED_POS) is zeros."""
    b, h, hd = q.shape
    n_pool, ps, kvh, _ = pool_k.shape
    group = h // kvh
    nb = table.shape[1]
    ring = bool(window) and ring
    if not window:
        cover = nb
    elif ring:
        cover = -(-window // ps)
    else:
        cover = min(nb, (window + ps - 2) // ps + 1)
    pps = -(-cover // splits)
    out = torch.zeros(b, h, hd, dtype=torch.float32)
    qf = q.float() / math.sqrt(hd)
    for row in range(b):
        p = int(pos[row])
        if p >= FREED_POS:
            continue
        base = max(0, p - window + 1) // ps if window and not ring else 0
        live = min(cover, p // ps + 1 - base) if skip_dead \
            else min(cover, nb - base)
        parts = []
        for s in range(splits):
            lo, hi = s * pps, min((s + 1) * pps, live)
            if lo >= hi:
                continue
            j = torch.arange((base + lo) * ps, (base + hi) * ps)
            pid = table[row, j // ps].long().clamp(0, n_pool - 1)
            k = pool_k[pid, j % ps].float()                   # (n, KV, hd)
            v = pool_v[pid, j % ps].float()
            if ring:
                kv_pos = p - torch.remainder(p - j, window)
                mask = (kv_pos >= 0) & (kv_pos <= p) & (j < window)
            else:
                mask = j <= p
                if window:
                    mask &= j > p - window
            sc = torch.einsum("hd,nhd->hn", qf[row],
                              k.repeat_interleave(group, dim=1))
            sc = torch.where(mask[None, :], sc, torch.full_like(sc, NEG_INF))
            m = sc.amax(-1)                                   # (H,)
            e = torch.exp(sc - m[:, None])
            parts.append((m, e.sum(-1), torch.einsum(
                "hn,nhd->hd", e, v.repeat_interleave(group, dim=1))))
        m_row = torch.stack([m for m, _, _ in parts]).amax(0)
        l_row = torch.zeros(h)
        o_row = torch.zeros(h, hd)
        for m, l, o in parts:
            w = torch.exp(m - m_row)
            l_row = l_row + w * l
            o_row = o_row + w[:, None] * o
        out[row] = o_row / l_row[:, None]
    return out.to(q.dtype)


@functools.cache
def _lib():
    lib = build.load("paged_attention")
    lib.paged_decode_attention_bf16.argtypes = _CTYPES
    lib.paged_decode_attention_bf16.restype = ctypes.c_int
    lib.paged_decode_splits.argtypes = (ctypes.c_int,) * 5
    lib.paged_decode_splits.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def _layout(q_shape, pool_shape, pool_v_shape, table_shape, pos_shape,
            dtypes, window, ring):
    """Check what the CUDA kernel takes from the shapes and dtypes alone
    (cached: a serving loop repeats them) and return the C entry point,
    the launch's static arguments and the floats of its scratch."""
    if len(q_shape) != 3 or len(pool_shape) != 4 \
            or pool_v_shape != pool_shape:
        raise ValueError("paged_decode_attention: q must be (B, H, hd) and "
                         "the pools (P, page_size, KV, hd)")
    b, h, hd = q_shape
    n_pool, ps, kvh, hd_k = pool_shape
    if hd_k != hd or kvh == 0 or h % kvh or n_pool == 0:
        raise ValueError(f"paged_decode_attention: mismatched shapes q "
                         f"{tuple(q_shape)}, pool {tuple(pool_shape)}")
    if len(table_shape) != 2 or table_shape[0] != b or pos_shape != (b,):
        raise ValueError("paged_decode_attention: table must be (B, nb) "
                         "and pos (B,)")
    nb = table_shape[1]
    if window and ring and nb * ps < window:
        raise ValueError(f"paged_decode_attention: {nb} pages of {ps} "
                         f"cannot hold a window of {window}")
    if hd not in HEAD_DIMS or ps != PAGE_SIZE or h // kvh not in GROUPS:
        raise ValueError(f"paged_decode_attention: the CUDA kernel takes "
                         f"head_dim in {HEAD_DIMS}, page_size {PAGE_SIZE} "
                         f"and H // KV in {GROUPS}, got {hd}, {ps} and "
                         f"{h // kvh}")
    q_dt, k_dt, v_dt, table_dt, pos_dt = dtypes
    if not (q_dt == k_dt == v_dt == torch.bfloat16):
        raise TypeError(f"paged_decode_attention: the CUDA kernel takes "
                        f"bfloat16, got {q_dt}/{k_dt}/{v_dt}")
    if table_dt != torch.int32 or pos_dt != torch.int32:
        raise TypeError("paged_decode_attention: table and pos must be "
                        "int32")
    # per split and (row, head): unnormalised O (hd floats), then (m, l)
    lib = _lib()
    splits = lib.paged_decode_splits(b, kvh, nb, int(window), int(ring))
    return lib.paged_decode_attention_bf16, (
        b, h, kvh, hd, n_pool, ps, nb, int(window), int(ring),
        1.0 / math.sqrt(hd)), splits * b * h * (hd + 2)


def paged_decode_attention(q, pool_k, pool_v, table, pos, *,
                           window: int = 0, ring: bool = True):
    """q (B, H, hd); pools (P, ps, KV, hd); table (B, nb) int32; pos
    (B,) int32 -> (B, H, hd).  ``window`` > 0 reads a ring-local table
    with ``ring``, a full-length block table without."""
    ring = bool(window) and ring
    if not q.is_cuda:
        if q.device.type == "cpu":
            return paged_decode_attention_plain(q, pool_k, pool_v, table,
                                                pos, window=window,
                                                ring=ring)
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    entry, dims, n_scratch = _layout(
        q.shape, pool_k.shape, pool_v.shape, table.shape, pos.shape,
        (q.dtype, pool_k.dtype, pool_v.dtype, table.dtype, pos.dtype),
        window, ring)
    dev = q.get_device()
    if not (pool_k.get_device() == pool_v.get_device() == table.get_device()
            == pos.get_device() == dev):
        raise ValueError("paged_decode_attention: all inputs must be on "
                         "one device")
    if not (q.is_contiguous() and pool_k.is_contiguous()
            and pool_v.is_contiguous() and table.is_contiguous()
            and pos.is_contiguous()):
        raise ValueError("paged_decode_attention: inputs must be "
                         "contiguous")
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    rc = entry(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
               table.data_ptr(), pos.data_ptr(), scratch.data_ptr(),
               out.data_ptr(), *dims,
               torch._C._cuda_getCurrentRawStream(dev))
    if rc:
        build.check(rc, "paged_decode_attention")
    paged_decode_attention.launches += 1
    paged_decode_attention.ring_launches += ring
    paged_decode_attention.window_launches += bool(window) and not ring
    return out


# launches of the kernel, and of those the ring-mode ones and the
# full-length window ones
paged_decode_attention.launches = 0
paged_decode_attention.ring_launches = 0
paged_decode_attention.window_launches = 0
