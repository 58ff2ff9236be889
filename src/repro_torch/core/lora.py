"""Multi-expert LoRA adapter banks — the serving subset of
``repro/core/lora.py`` (paper Sec. III-B, Eq. 1-2, Eq. 8).

An *adapter* is one client's LoRA module φ_i: per layer stack and target
projection, A (*dims, r_max, d_in) drawn with a Kaiming law and masked
to the adapter's rank, and B (*dims, d_out, r_max) zero at init, plus
its rank under ``"_rank"``.  A *bank* stacks E adapters on an expert
axis inserted after the stack dims — A (*dims, E, r_max, d_in), B
(*dims, E, d_out, r_max), ranks under ``"_ranks"`` — and the model
consumes ``bank_for_model(bank)``: ``layers.lora_delta`` computes
Σ_j ω_j B_j A_j x from it.

A *slot bank* (``empty_bank``) is the fixed E-slot device bank behind
the per-user adapter cache (``serving/adapters.py``): an empty slot is
all zeros, so its delta is an exact 0.0 under any gate, and a row picks
its slot with a one-hot gate row (``slot_gates``) or, on the slot
kernel's decode path, an integer slot id.  ``write_slot`` writes one
adapter into a slot IN PLACE (the reference returns an updated copy).

Adapters and banks are nested dicts of tensors in the reference's
layout, so ``bridge.py`` carries them across leaf for leaf.  The
adaptive-rank helpers (``rank_mask``, ``average_adapters``,
``adapter_vector``, ``count_params``) belong to the federated slice.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch


def init_adapter(model, seed: int, rank: int, r_max: Optional[int] = None,
                 dtype=torch.float32, device=None) -> Dict[str, Any]:
    """One client's LoRA module (no expert axis) on ``device`` (default:
    the model's).  A ~ N(0, 2 / d_in) from a ``torch.Generator`` seeded
    with ``seed``, rows at or past ``rank`` zeroed; B zero, so the
    adapter's delta is 0 until it is trained.  The reference draws A
    with threefry: the values differ, the law and layout do not."""
    r_max = r_max or model.cfg.lora_rank_max
    device = torch.device(device) if device is not None else model.device
    gen = torch.Generator(device=device).manual_seed(seed)
    mask = (torch.arange(r_max, device=device) < rank).float()[:, None]
    out: Dict[str, Any] = {"_rank": torch.tensor(rank, dtype=torch.int32)}
    for stack, (dims, targets) in sorted(model.lora_layout().items()):
        st = {}
        for tgt, (din, dout) in sorted(targets.items()):
            a = torch.randn(dims + (r_max, din), generator=gen,
                            device=device) * math.sqrt(2.0 / din) * mask
            st[tgt] = {"A": a.to(dtype),
                       "B": torch.zeros(dims + (dout, r_max), dtype=dtype,
                                        device=device)}
        out[stack] = st
    return out


def _body(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in tree.items() if not k.startswith("_")}


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_adapters(adapters: List[Dict[str, Any]]) -> Dict[str, Any]:
    """E adapters -> a bank, the expert axis inserted after the stack
    dims: A (*dims, r, din) -> (*dims, E, r, din), B likewise."""
    bank = _map(lambda *ls: torch.stack(ls, dim=ls[0].dim() - 2),
                *[_body(a) for a in adapters])
    bank["_ranks"] = torch.stack([torch.as_tensor(a["_rank"],
                                                  dtype=torch.int32)
                                  for a in adapters])
    return bank


def bank_for_model(bank: Dict[str, Any]) -> Dict[str, Any]:
    """Strip metadata -> the tree the model's ``lora=`` argument takes."""
    return _body(bank)


def adapter_of(bank: Dict[str, Any], j: int) -> Dict[str, Any]:
    """Expert j of a bank, its expert axis removed (views, not copies)."""
    out = _map(lambda t: t.select(t.dim() - 3, j), bank_for_model(bank))
    out["_rank"] = bank["_ranks"][j]
    return out


def empty_bank(model, num_slots: int, r_max: Optional[int] = None,
               dtype=torch.float32, device=None) -> Dict[str, Any]:
    """All-zero bank of ``num_slots`` slots in the ``stack_adapters``
    layout, on ``device`` (default: the model's)."""
    r_max = r_max or model.cfg.lora_rank_max
    device = torch.device(device) if device is not None else model.device
    out: Dict[str, Any] = {"_ranks": torch.zeros((num_slots,),
                                                 dtype=torch.int32)}
    for stack, (dims, targets) in sorted(model.lora_layout().items()):
        out[stack] = {
            tgt: {"A": torch.zeros(dims + (num_slots, r_max, din),
                                   dtype=dtype, device=device),
                  "B": torch.zeros(dims + (num_slots, dout, r_max),
                                   dtype=dtype, device=device)}
            for tgt, (din, dout) in sorted(targets.items())}
    return out


def write_slot(bank: Dict[str, Any], adapter: Dict[str, Any],
               slot: int) -> Dict[str, Any]:
    """Write one adapter (``init_adapter`` layout) into slot ``slot`` of
    ``bank`` IN PLACE, casting to the bank's dtype and device; returns
    the bank."""
    def wr(t, leaf):
        dst = t.select(t.dim() - 3, int(slot))
        if dst.shape != leaf.shape:
            raise ValueError(f"adapter leaf {tuple(leaf.shape)} does not "
                             f"fit a bank slot {tuple(dst.shape)}")
        dst.copy_(leaf)

    _map(wr, bank_for_model(bank), _body(adapter))
    bank["_ranks"][int(slot)].fill_(int(adapter["_rank"]))
    return bank


def slot_gates(slots: Sequence[Optional[int]], num_slots: int) -> np.ndarray:
    """(B, E) one-hot gate rows selecting each row's slot; a negative or
    None slot (no adapter) gives an all-zero row, whose delta over
    zero-filled empty slots is exactly 0.0."""
    rows = np.zeros((len(slots), num_slots), np.float32)
    for i, s in enumerate(slots):
        if s is not None and int(s) >= 0:
            rows[i, int(s)] = 1.0
    return rows
