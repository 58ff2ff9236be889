"""Attention: GQA prefill and decode with full-causal and
sliding-window layers — the port of ``repro/models/attention.py``.

``attention_block`` covers ``prefill`` (the reference's branches at
``attention.py:327-345``: without a history, or against one — the
suffix and chunk prefills of COW prefix sharing and chunked prefill,
whose queries sit at positions P + i and attend over [history; fresh])
and four decode forms:
scalar-position decode against a dense cache (``attention.py:396-415``),
full-length or window-sized ring; per-row decode against a dense lane
cache (``:372-395``), each row at its own depth; and **paged** decode
with per-row positions against a page pool through a block table, or
through a row's ring-local table on a windowed layer (``:346-371``).
``is_global`` picks a layer's rope theta and window as the reference
does (``:312-321``): a local layer of a mixed layout (gemma3) attends
over the last ``sliding_window`` positions.  On CUDA, prefill
attention is the hand-written kernel K3 (``kernels/flash_attention``,
windowed on a local layer, in its history-offset mode against a
history) and per-row decode attention, paged or
dense, is K2 (``kernels/paged_attention``: in its ring mode on a
ring-local table, in its full-length window mode on a window layer's
full block table); each launches or raises.  A dense lane's (B, S, KV,
hd) leaf is read by K2 in place as B * S / 16 pages of 16 slots
through the lane's identity tables (row b's page j is b * S / 16 + j),
so a dense lane and a paged one run the same kernel over the same
values.  On the CPU, prefill is ``chunked_causal_attention`` and
per-row decode ``rowwise_decode_attention`` or
``rowwise_ring_decode_attention`` (over ``gather_pages`` views on a
paged lane), the reference's own math.  Scalar-position decode
attention (``decode_attention``, ``ring_decode_attention``) is plain
PyTorch on both, as the reference computes it outside any Pallas
kernel.

``train`` mode (the reference's ``attention.py:323-326``) attends
causally over the whole sequence (a window layer within its sliding
window) and returns no cache.  On CUDA with a gradient it runs K3 and
K8 through ``flash_attention_train``, windowed on gemma3's local
layers; without one, K3; on the CPU the plain
``chunked_causal_attention`` under autograd.

Decode writes the new token's K/V into the cache IN PLACE (the
reference returns an updated copy).  torch has neither
``mode="drop"`` nor ``mode="clip"``, so the writes the reference drops
are masked explicitly: a parked row (pos >= FREED_POS), a slot past the
cache and an unmapped NO_PAGE table entry write nothing.  A dense row
that writes nothing rewrites its slot's own value.  A paged pool
carries one extra SINK page after its P real pages, (P + 1, ps, KV,
hd): dropped writes land there, so the scatter needs no host sync and
no out-of-range index ever reaches the device.  Nothing reads the sink:
gathers clamp page ids into [0, P - 1], as the reference does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention, flash_attention_train)
from repro_torch.kernels.paged_attention.kernel import (
    PAGE_SIZE, paged_decode_attention)
from repro_torch.models import layers as L

NEG_INF = -2.0 ** 30
# Continuous batching: a freed batch row is "parked" at this position
# until re-admission; its cache writes drop and decode freezes its
# position (reference ``attention.py:36``).
FREED_POS = 1 << 30


def _sdpa(q, k, v, mask, scale):
    """q: (B,Sq,KV,G,hd)  k/v: (B,Sk,KV,hd)  mask: (B?,Sq,Sk) bool."""
    scores = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.float(), v.float())
    return out.to(v.dtype)


def _group(q, num_kv):
    b, s, h, hd = q.shape
    return q.reshape(b, s, num_kv, h // num_kv, hd)


def chunked_causal_attention(q, k, v, q_pos, kv_pos, window: int = 0,
                             chunk: int = 1024):
    """Exact causal (optionally sliding-window) attention.

    q: (B, S, H, hd); k/v: (B, S, KV, hd); q_pos/kv_pos: (S,) absolute.
    Returns (B, S, H, hd)."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qg = _group(q, kvh)
    if s <= chunk:
        mask = kv_pos[None, None, :] <= q_pos[None, :, None]
        if window:
            mask &= kv_pos[None, None, :] > q_pos[None, :, None] - window
        return _sdpa(qg, k, v, mask, scale).reshape(b, s, h, hd)
    outs = []
    for lo in range(0, s, chunk):
        hi = min(lo + chunk, s)
        k_lo = max(0, hi - chunk - window) if window else 0
        qp, kp = q_pos[lo:hi], kv_pos[k_lo:hi]
        mask = kp[None, None, :] <= qp[None, :, None]
        if window:
            mask &= kp[None, None, :] > qp[None, :, None] - window
        outs.append(_sdpa(qg[:, lo:hi], k[:, k_lo:hi], v[:, k_lo:hi], mask,
                          scale).reshape(b, hi - lo, h, hd))
    return torch.cat(outs, dim=1)


def decode_attention(q, cache_k, cache_v, pos: int, window: int = 0):
    """One-token decode: q (B,1,H,hd), cache (B,S,KV,hd), pos int."""
    b, _, h, hd = q.shape
    s_max = cache_k.shape[1]
    kvh = cache_k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    if window and window < s_max:
        start = min(max(pos + 1 - window, 0), s_max - window)
        k = cache_k[:, start:start + window]
        v = cache_v[:, start:start + window]
        kv_pos = start + torch.arange(window, device=q.device)
    else:
        k, v = cache_k, cache_v
        kv_pos = torch.arange(s_max, device=q.device)
    mask = (kv_pos <= pos)[None, None, :]
    return _sdpa(_group(q, kvh), k, v, mask, scale).reshape(b, 1, h, hd)


def rowwise_decode_attention(q, cache_k, cache_v, pos_b, window: int = 0):
    """One-token decode with PER-ROW positions — the CPU path of paged
    decode, over ``gather_pages`` views.  q (B,1,H,hd), cache
    (B,S,KV,hd), pos_b (B,) integer tensor.  A window layer keeps the
    full cache and masks the neighbourhood instead of slicing (per-row
    starts preclude one slice)."""
    b, _, h, hd = q.shape
    s_max = cache_k.shape[1]
    kvh = cache_k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    kv_pos = torch.arange(s_max, device=q.device)
    mask = kv_pos[None, None, :] <= pos_b[:, None, None]       # (B,1,S)
    if window and window < s_max:
        mask &= kv_pos[None, None, :] > pos_b[:, None, None] - window
    return _sdpa(_group(q, kvh), cache_k, cache_v, mask,
                 scale).reshape(b, 1, h, hd)


def ring_kv_positions(pos, window: int, device=None) -> torch.Tensor:
    """Absolute position held by each slot of a ring cache at depth
    ``pos``: slot i holds p = pos - ((pos - i) mod window), the most
    recent position <= pos that maps to slot i (= p % window); p < 0
    marks a slot not yet written.  pos an int -> (window,) on
    ``device``; pos a (B,) tensor -> (B, window) on its device.  Decode
    writes, decode masks and the prefill placement of ring leaves all
    follow it."""
    if isinstance(pos, torch.Tensor):
        pos = pos.long()[..., None]
        device = pos.device
    slots = torch.arange(window, device=device)
    return pos - torch.remainder(pos - slots, window)


def ring_decode_attention(q, cache_k, cache_v, pos: int, window: int):
    """Decode against a window-sized ring cache (B, window, KV, hd) at
    one depth ``pos``: the mask keeps slot positions in
    [max(0, pos - window + 1), pos]."""
    b, _, h, hd = q.shape
    kvh = cache_k.shape[2]
    kv_pos = ring_kv_positions(pos, window, q.device)
    mask = ((kv_pos >= 0) & (kv_pos <= pos))[None, None, :]
    return _sdpa(_group(q, kvh), cache_k, cache_v, mask,
                 1.0 / math.sqrt(hd)).reshape(b, 1, h, hd)


def rowwise_ring_decode_attention(q, cache_k, cache_v, pos_b, window: int):
    """Ring decode with PER-ROW positions (each row at its own depth and
    ring write index) — the CPU path of paged decode through a ring-local
    table.  q (B,1,H,hd), cache (B,window,KV,hd), pos_b (B,) integer
    tensor; rows that have not wrapped yet mask their empty slots."""
    b, _, h, hd = q.shape
    kvh = cache_k.shape[2]
    kv_pos = ring_kv_positions(pos_b, window)                   # (B, W)
    mask = ((kv_pos >= 0) & (kv_pos <= pos_b[:, None]))[:, None, :]
    return _sdpa(_group(q, kvh), cache_k, cache_v, mask,
                 1.0 / math.sqrt(hd)).reshape(b, 1, h, hd)


def gather_pages(pool_flat, table, n_slots: int, page_size: int):
    """Dense per-row view of a paged pool.  pool_flat: (P*ps, ...)
    slot-flattened pool of P real pages; table: (B, n_pages).  Returns
    (B, n_slots, ...): row b, slot j = pool[table[b, j//ps], j%ps], with
    sentinel page ids clamped into [0, P - 1] (callers mask them)."""
    n_pool = pool_flat.shape[0] // page_size
    j = torch.arange(n_slots, device=table.device)
    pid = table[:, j // page_size].long()                      # (B, n)
    flat = pid.clamp(0, n_pool - 1) * page_size + (j % page_size)[None, :]
    return pool_flat[flat]


def scatter_page_token(pool, table, row_pos, slot, token_kv,
                       slot_limit: int):
    """Write one decode token per row into its mapped page, IN PLACE.

    pool: (P + 1, ps, ...) with the sink page last; table: (B, n_pages);
    slot: (B,) in-row slot index; token_kv: (B, ...).  Parked rows
    (row_pos >= FREED_POS), slots at or past ``slot_limit`` and unmapped
    (NO_PAGE) entries write into the sink page instead, as the
    reference's out-of-pool index drops."""
    n_pool, ps = pool.shape[0] - 1, pool.shape[1]
    slot = slot.long()
    page_ix = torch.clamp(slot // ps, max=table.shape[1] - 1)
    pid = table.gather(1, page_ix[:, None])[:, 0].long()
    ok = (row_pos < FREED_POS) & (slot < slot_limit) & (pid < n_pool)
    flat = torch.where(ok, pid * ps + slot % ps,
                       torch.full_like(pid, n_pool * ps))
    pool.view((n_pool + 1) * ps, *pool.shape[2:])[flat] = token_kv


def write_row_token(leaf, row_pos, slot, token_kv) -> None:
    """Write one decode token per row of a dense lane leaf (B, S, KV,
    hd) at its in-row ``slot``, IN PLACE.  A parked row (row_pos >=
    FREED_POS), and a slot past the row (a speculative draft's), rewrite
    the current value of the (clamped) slot, so nothing changes, as the
    reference's out-of-range scatter drops: no host sync and no
    out-of-range index reaches the device."""
    b, s_len = leaf.shape[:2]
    rows = torch.arange(b, device=leaf.device)
    slot = slot.long()
    drop = ((row_pos >= FREED_POS) | (slot >= s_len)).view(
        b, *(1,) * (leaf.dim() - 2))
    slot = slot.clamp(0, s_len - 1)
    leaf[rows, slot] = torch.where(drop, leaf[rows, slot], token_kv)


def identity_tables(batch: int, n_slots: int, device) -> torch.Tensor:
    """(B, n_slots / 16) int32 page ids b * n_slots / 16 + j: a dense
    lane leaf (B, n_slots, KV, hd) read in place as K2's 16-slot
    pages."""
    if n_slots % PAGE_SIZE:
        raise ValueError(f"a dense lane of {n_slots} slots is not a whole "
                         f"number of K2's {PAGE_SIZE}-slot pages")
    nb = n_slots // PAGE_SIZE
    return torch.arange(batch * nb, dtype=torch.int32,
                        device=device).view(batch, nb)


def check_row_positions(host_pos, n_slots: int) -> None:
    """Host-side guard before a per-row decode dispatch, as a scalar
    position past the cache raises: a live row (pos < FREED_POS) at or
    past the cache's ``n_slots`` raises instead of having its write
    dropped silently, as the reference's scatter would."""
    host_pos = np.asarray(host_pos)
    live = host_pos < FREED_POS
    if (host_pos[live] >= n_slots).any() or (host_pos < 0).any():
        raise ValueError(f"decode positions {host_pos.tolist()} outside "
                         f"the {n_slots}-slot cache")


def _k2(q, pool_k, pool_v, table, row_pos, window: int, ring: bool,
        n_slots: int) -> torch.Tensor:
    """Per-row decode attention through K2: q (B, 1, H, hd), pools (P,
    16, KV, hd) -> (B, 1, H, hd).  A ring reads its ring-local table; a
    full-length window layer its whole table in K2's window mode, where
    a window no shorter than the table masks nothing."""
    b, _, h, hd = q.shape
    if not ring and window >= n_slots:
        window = 0
    return paged_decode_attention(q[:, 0].contiguous(), pool_k, pool_v,
                                  table, row_pos, window=window,
                                  ring=ring).reshape(b, 1, h, hd)


def _qk_norm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm over head_dim in float32, scaled by ``x * scale`` (not
    ``1 + scale``), as the reference's ``_qk_norm``."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * p["scale"].float()).to(dt)


def layer_window(cfg, is_global: bool) -> int:
    """Attention window of a layer (0 = full causal)."""
    if cfg.attn_type == "sliding" or (cfg.attn_type == "mixed"
                                      and not is_global):
        return cfg.sliding_window
    return 0


def attention_block(cfg, p, x, *, positions, cache=None, mode="prefill",
                    pages=None, ident=None, host_pos=None, lora=None,
                    gates=None, is_global: bool = True):
    """Attention sub-layer of one layer.

    ``is_global``: False on a local layer of a mixed layout, which
    takes the local rope theta and attends over a window.
    train: ``positions`` (S,) tensor; causal attention over the whole
    sequence, returns (y, None).
    prefill: ``positions`` (S,) tensor; returns (y, (k, v)) with the
    fresh (B, S, KV, hd) keys and values.  A ``cache`` of {"k", "v":
    (1 or B, P, KV, hd)} is a prefix HISTORY at positions 0..P-1: the
    queries, at ``positions`` = P + arange(S), attend over [history;
    fresh] and only the fresh K/V are returned (the reference's suffix
    prefill).
    decode: ``cache`` is this layer's {"k", "v"}; the new token's K/V
    are written into it IN PLACE (the reference returns an updated
    copy; the port saves the copy).  ``positions`` is an int (dense
    (B, S, KV, hd) cache, every row at one depth; a window layer's cache
    of exactly ``window`` slots is a ring written at pos % window) or,
    with ``pages`` = {"block": (B, nb) int32 table[, "local": (B, nl)
    ring-local table]}, a (B,) int32 tensor of per-row depths against
    page pools (P + 1, ps, KV, hd) with the sink page last; a window
    layer with a "local" table writes slot pos % window of its ring.
    Without ``pages``, a (B,) ``positions`` tensor decodes a dense lane:
    (B, S, KV, hd) rows, a window layer's leaf of exactly ``window``
    slots a ring per row; on CUDA ``ident`` holds the lane's identity
    tables ({"block"[, "local"]}, ``identity_tables``) through which K2
    reads the rows as pages.  ``host_pos``, the host's mirror of per-row
    ``positions``, is validated against the full-length table or rows
    before any dispatch (a ring never overflows).  Returns (y, None).

    ``lora`` is this layer's {"q", "k", "v", "o": {"A", "B"}} bank slice
    (any target may be missing) and ``gates`` its gates, as
    ``layers.lora_delta`` takes them."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    get = (lora or {}).get
    q = L.linear(p["q"], x, get("q"), gates).reshape(b, s, h, hd)
    k = L.linear(p["k"], x, get("k"), gates).reshape(b, s, kvh, hd)
    v = L.linear(p["v"], x, get("v"), gates).reshape(b, s, kvh, hd)
    if cfg.use_qk_norm:
        q = _qk_norm(p["q_norm"], q, cfg.norm_eps)
        k = _qk_norm(p["k_norm"], k, cfg.norm_eps)

    row_pos = positions if mode == "decode" and isinstance(
        positions, torch.Tensor) and positions.dim() == 1 else None
    if mode in ("prefill", "train"):
        rope_pos = positions
    elif row_pos is not None:
        rope_pos = row_pos[:, None]
    else:
        rope_pos = torch.tensor(positions, device=x.device)
    theta = cfg.rope_theta_global if (is_global and cfg.rope_theta_global) \
        else cfg.rope_theta
    angles = L.rope_angles(rope_pos, hd, theta, x.device)
    q = L.rope_turn(q, angles)
    k = L.rope_turn(k, angles)
    window = layer_window(cfg, is_global)

    if mode == "train":
        if x.device.type == "cuda":
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), \
                v.transpose(1, 2)
            if torch.is_grad_enabled() and (q.requires_grad
                                            or k.requires_grad
                                            or v.requires_grad):
                out = flash_attention_train(qt, kt, vt,
                                            window=window).transpose(1, 2)
            else:
                out = flash_attention(qt, kt, vt, causal=True,
                                      window=window).transpose(1, 2)
        else:
            out = chunked_causal_attention(q, k, v, positions, positions,
                                           window)
        new_kv = None
    elif mode == "prefill" and cache is not None:
        # against a history: causality makes the history's K/V what a
        # full-prompt prefill computes there, so these rows attend as a
        # one-shot prefill would at the same positions
        hk, hv = cache["k"], cache["v"]
        if x.device.type == "cuda":
            # K3's history-offset mode reads a B=1 history in place for
            # every row
            out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True,
                                  window=window,
                                  hist_k=hk.transpose(1, 2),
                                  hist_v=hv.transpose(1, 2)).transpose(1, 2)
        else:
            kv_pos = torch.cat([torch.arange(hk.shape[1],
                                             device=x.device), positions])
            out = chunked_causal_attention(
                q, torch.cat([hk.expand(b, -1, -1, -1), k], dim=1),
                torch.cat([hv.expand(b, -1, -1, -1), v], dim=1),
                positions, kv_pos, window, chunk=max(1024, s))
        new_kv = (k, v)
    elif mode == "prefill":
        if x.device.type == "cuda":
            # K3 reads the (B, H, S, D) views in place and returns one
            # whose transpose is a contiguous (B, S, H, D)
            out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True,
                                  window=window).transpose(1, 2)
        else:
            out = chunked_causal_attention(q, k, v, positions, positions,
                                           window)
        new_kv = (k, v)
    elif mode == "decode" and pages is not None:
        pool_k, pool_v = cache["k"], cache["v"]
        ps = pool_k.shape[1]
        ring = bool(window) and "local" in pages
        if ring:
            table, n_slots = pages["local"], window
            slot = torch.remainder(row_pos, window)
        else:
            table, slot = pages["block"], row_pos
            n_slots = table.shape[1] * ps
            if host_pos is not None:
                check_row_positions(host_pos, n_slots)
        scatter_page_token(pool_k, table, row_pos, slot, k[:, 0], n_slots)
        scatter_page_token(pool_v, table, row_pos, slot, v[:, 0], n_slots)
        n_pool = pool_k.shape[0] - 1
        if x.device.type == "cuda":
            out = _k2(q, pool_k[:n_pool], pool_v[:n_pool], table, row_pos,
                      window, ring, n_slots)
        else:
            flat = lambda a: a[:n_pool].reshape(n_pool * ps, *a.shape[2:])
            gk = gather_pages(flat(pool_k), table, n_slots, ps)
            gv = gather_pages(flat(pool_v), table, n_slots, ps)
            out = rowwise_ring_decode_attention(q, gk, gv, row_pos, window) \
                if ring else rowwise_decode_attention(q, gk, gv, row_pos,
                                                      window)
        new_kv = None
    elif mode == "decode" and row_pos is not None:
        # a dense lane: each row writes its token at its own position
        # (a ring leaf: at pos % window), parked rows write nothing
        n_slots = cache["k"].shape[1]
        ring = bool(window) and n_slots == window
        if ring:
            slot = torch.remainder(row_pos, window)
        else:
            slot = row_pos
            if host_pos is not None:
                check_row_positions(host_pos, n_slots)
        write_row_token(cache["k"], row_pos, slot, k[:, 0])
        write_row_token(cache["v"], row_pos, slot, v[:, 0])
        if x.device.type == "cuda":
            if ident is None:
                raise ValueError("per-row decode of a dense lane on CUDA "
                                 "needs the lane's identity tables")
            pages_of = lambda a: a.view(-1, PAGE_SIZE, *a.shape[2:])
            out = _k2(q, pages_of(cache["k"]), pages_of(cache["v"]),
                      ident["local" if ring else "block"], row_pos, window,
                      ring, n_slots)
        elif ring:
            out = rowwise_ring_decode_attention(q, cache["k"], cache["v"],
                                                row_pos, window)
        else:
            out = rowwise_decode_attention(q, cache["k"], cache["v"],
                                           row_pos, window)
        new_kv = None
    elif mode == "decode":
        pos = positions
        if pos < 0:
            raise ValueError(f"decode position {pos} outside the cache")
        if window and cache["k"].shape[1] == window:
            # ring: a window layer keeps only ``window`` slots
            cache["k"][:, pos % window] = k[:, 0]
            cache["v"][:, pos % window] = v[:, 0]
            out = ring_decode_attention(q, cache["k"], cache["v"], pos,
                                        window)
        else:
            if pos >= cache["k"].shape[1]:
                raise ValueError(f"decode position {pos} outside the cache")
            cache["k"][:, pos] = k[:, 0]
            cache["v"][:, pos] = v[:, 0]
            out = decode_attention(q, cache["k"], cache["v"], pos, window)
        new_kv = None
    else:
        raise ValueError(mode)
    y = L.linear(p["o"], out.reshape(b, s, h * hd), get("o"), gates)
    return y, new_kv
