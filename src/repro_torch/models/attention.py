"""Attention: GQA prefill and decode — the port of
``repro/models/attention.py`` for the plain dense layout.

``attention_block`` covers ``prefill`` (no history; the reference's
branch at ``attention.py:343-345``) and scalar-position ``decode``
against a dense cache (``attention.py:396-415``, non-ring).  On CUDA,
prefill attention is the hand-written kernel K3
(``kernels/flash_attention``), which launches or raises; on the CPU it
is ``chunked_causal_attention``, the reference's own prefill math.
Decode attention is ``decode_attention`` in plain PyTorch on both, as
the reference computes it outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.models import layers as L

NEG_INF = -2.0 ** 30


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


def attention_block(cfg, p, x, *, positions, cache=None, mode="prefill"):
    """Attention sub-layer of one layer.

    prefill: ``positions`` (S,) tensor; returns (y, (k, v)) with the
    fresh (B, S, KV, hd) keys and values.
    decode: ``positions`` an int, ``cache`` this layer's {"k", "v"}
    (B, max_seq, KV, hd) views; the new token's K/V are written into the
    cache IN PLACE at ``positions`` (the reference returns an updated
    copy; the port saves the copy).  Returns (y, None)."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = L.linear(p["q"], x).reshape(b, s, h, hd)
    k = L.linear(p["k"], x).reshape(b, s, kvh, hd)
    v = L.linear(p["v"], x).reshape(b, s, kvh, hd)

    rope_pos = positions if mode == "prefill" else torch.tensor(
        positions, device=x.device)
    # every layer of the plain layout is global
    theta = cfg.rope_theta_global or cfg.rope_theta
    q = L.rope(q, rope_pos, theta)
    k = L.rope(k, rope_pos, theta)

    if mode == "prefill":
        if x.device.type == "cuda":
            out = flash_attention(q.transpose(1, 2).contiguous(),
                                  k.transpose(1, 2).contiguous(),
                                  v.transpose(1, 2).contiguous(),
                                  causal=True).transpose(1, 2)
        else:
            out = chunked_causal_attention(q, k, v, positions, positions)
        new_kv = (k, v)
    elif mode == "decode":
        pos = positions
        if not 0 <= pos < cache["k"].shape[1]:
            raise ValueError(f"decode position {pos} outside the cache")
        cache["k"][:, pos] = k[:, 0]
        cache["v"][:, pos] = v[:, 0]
        out = decode_attention(q, cache["k"], cache["v"], pos)
        new_kv = None
    else:
        raise ValueError(mode)
    y = L.linear(p["o"], out.reshape(b, s, h * hd))
    return y, new_kv
