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

The federated side (Sec. III-B/C): ``init_adapter_keyed`` draws an
adapter with the reference's threefry split tree from a ``core/prng``
key, bit for bit the reference's ``init_adapter`` (``init_adapter``
keeps a ``torch.Generator`` draw for the serving callers);
``rank_mask`` is the compression operator Q_r as an (E, r_max) mask;
``single_expert_bank`` wraps a client's adapter as an E = 1 bank;
``average_adapters`` is Eq. 4/5; ``adapter_vector`` the fine-tuning
dynamics half of the aggregator's encoder E(φ), whose projection
``save_projection`` draws in one process and ``load_projection`` hands
to another.

Adapters and banks are nested dicts of tensors in the reference's
layout, so ``bridge.py`` carries them across leaf for leaf.
"""
from __future__ import annotations

import math
import os
import pickle
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core import tree as T


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


def init_adapter_keyed(model, key: prng.Key, rank: int,
                       r_max: Optional[int] = None, dtype=torch.float32,
                       device=None) -> Dict[str, Any]:
    """``init_adapter`` drawn as the reference draws it: ``key`` (a
    ``core/prng`` key) split over the sorted stacks, each stack's key
    over its sorted targets, A = normal(key, (*dims, r_max, d_in)) ·
    sqrt(2 / d_in) with rows at or past ``rank`` zeroed, B zero.  The
    normals are threefry's on the host (``core/prng.py``), bit for bit
    the reference's, then copied to ``device`` (default: the model's)."""
    r_max = r_max or model.cfg.lora_rank_max
    device = torch.device(device) if device is not None else model.device
    layout = model.lora_layout()
    mask = (np.arange(r_max) < rank).astype(np.float32)[:, None]
    out: Dict[str, Any] = {"_rank": torch.tensor(rank, dtype=torch.int32)}
    keys = prng.split(key, max(1, len(layout)))
    for i, (stack, (dims, targets)) in enumerate(sorted(layout.items())):
        tks = prng.split(prng.key_at(keys, i), max(1, len(targets)))
        st = {}
        for j, (tgt, (din, dout)) in enumerate(sorted(targets.items())):
            a = prng.normal(prng.key_at(tks, j), dims + (r_max, din))
            a = (a * np.float32(math.sqrt(2.0 / din))) * mask
            st[tgt] = {"A": torch.from_numpy(a).to(device, dtype),
                       "B": torch.zeros(dims + (dout, r_max), dtype=dtype,
                                        device=device)}
        out[stack] = st
    return out


def rank_mask(ranks: Sequence[int], r_max: int, device=None) -> torch.Tensor:
    """(E, r_max) 0/1 float32 mask — expert j uses only its first
    ranks[j] ranks (the compression operator Q_r of Theorem 1)."""
    m = torch.zeros((len(ranks), r_max), dtype=torch.float32, device=device)
    for j, r in enumerate(ranks):
        m[j, : int(r)] = 1.0
    return m


def _body(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in tree.items() if not k.startswith("_")}


def stack_adapters(adapters: List[Dict[str, Any]]) -> Dict[str, Any]:
    """E adapters -> a bank, the expert axis inserted after the stack
    dims: A (*dims, r, din) -> (*dims, E, r, din), B likewise."""
    bank = T.map_tree(lambda *ls: torch.stack(ls, dim=ls[0].dim() - 2),
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
    out = T.map_tree(lambda t: t.select(t.dim() - 3, j),
                     bank_for_model(bank))
    out["_rank"] = bank["_ranks"][j]
    return out


def single_expert_bank(adapter: Dict[str, Any]) -> Dict[str, Any]:
    """Wrap one adapter as an E = 1 bank (for local client training)."""
    return stack_adapters([adapter])


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

    T.map_tree(wr, bank_for_model(bank), _body(adapter))
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


def adapter_vector(adapter: Dict[str, Any], dim: int = 64,
                   seed: int = 0) -> np.ndarray:
    """Fixed random projection of the flattened adapter -> R^dim, the
    reference's numpy computation on the same leaves in the same order.

    Part of the domain-conditioned encoder E(φ) (Sec. III-C): captures the
    *fine-tuning dynamics* component; aggregator.py concatenates it with
    the task-data embedding (the *adaptation semantics* component)."""
    return adapter_vectors([adapter], dim, seed)[0]


def adapter_vectors(adapters: List[Dict[str, Any]], dim: int = 64,
                    seed: int = 0) -> List[np.ndarray]:
    """``adapter_vector`` of each adapter (all of one layout), the random
    projection drawn once for all of them: each chunk of the projection
    is applied to every adapter's chunk by the same product as for one
    adapter alone, so each vector is the reference's bit for bit.  At the
    2b SLM's width the projection is 1.2 G normals from numpy's legacy
    generator (4.8 GB in f32), drawn once a process and then reused
    (``_projection_chunks``)."""
    flats = []
    for adapter in adapters:
        leaves = [x.detach().float().cpu().numpy().ravel()
                  for x in T.leaves(_body(adapter))]
        flats.append(np.concatenate(leaves) if leaves
                     else np.zeros(1, np.float32))
    if len({f.size for f in flats}) > 1:
        raise ValueError("adapter_vectors: adapters of different sizes")
    outs = [np.zeros(dim, np.float32) for _ in flats]
    for i, proj in enumerate(_projection_chunks(seed, dim, flats[0].size)):
        lo = i * _PROJ_CHUNK
        for out, flat in zip(outs, flats):
            out += flat[lo:lo + _PROJ_CHUNK] @ proj
    return [out / np.linalg.norm(out) if np.linalg.norm(out) > 0 else out
            for out in outs]


# E(φ)'s projection, drawn in chunks of _PROJ_CHUNK rows and kept for the
# process's life per (seed, dim): it is fixed, and redrawing it cost a
# server most of a round's host time.  The legacy generator's stream is
# one sequence whatever the adapter's size (every chunk draws an even
# count, so no cached Gaussian crosses a chunk's edge), so a longer
# adapter extends the cached rows and a shorter one reads their first
# rows: each product is the one a fresh ``RandomState(seed)`` gives.
_PROJ_CHUNK = 1 << 16
_PROJECTIONS: Dict[Any, Any] = {}


def _projection_chunks(seed: int, dim: int, n: int):
    """The f32 projection rows [0, n) of (seed, dim), as chunks of
    _PROJ_CHUNK rows (the last one cut to fit), drawn on first use."""
    rng, chunks = _PROJECTIONS.setdefault(
        (seed, dim), (np.random.RandomState(seed), []))
    for i in range(0, n, _PROJ_CHUNK):
        j = i // _PROJ_CHUNK
        if j == len(chunks):
            chunks.append(rng.standard_normal(
                (_PROJ_CHUNK, dim)).astype(np.float32))
        yield chunks[j][:min(_PROJ_CHUNK, n - i)]


def save_projection(path: str, seed: int, dim: int, n: int) -> None:
    """Draw E(φ)'s projection rows [0, n) of (seed, dim) into this
    process's cache and write them to ``path``.npy, with the generator's
    state after them to ``path``.rng, for ``load_projection`` in another
    process."""
    for _ in _projection_chunks(seed, dim, n):
        pass
    rng, chunks = _PROJECTIONS[(seed, dim)]
    out = np.lib.format.open_memmap(
        path + ".npy", mode="w+", dtype=np.float32,
        shape=(len(chunks) * _PROJ_CHUNK, dim))
    for i, c in enumerate(chunks):
        out[i * _PROJ_CHUNK:(i + 1) * _PROJ_CHUNK] = c
    out.flush()
    with open(path + ".rng", "wb") as f:
        pickle.dump(rng, f)


def load_projection(path: str, seed: int, dim: int) -> int:
    """Make what ``save_projection`` wrote at ``path`` this process's
    cached projection of (seed, dim), the rows memory-mapped, and remove
    the files (the mapping outlives their names): every later product is
    the one this process's own draw gives.  Returns the row count."""
    rows = np.load(path + ".npy", mmap_mode="r")
    with open(path + ".rng", "rb") as f:
        rng = pickle.load(f)
    for ext in (".npy", ".rng"):
        os.unlink(path + ext)
    _PROJECTIONS[(seed, dim)] = (
        rng, [rows[i:i + _PROJ_CHUNK] for i in range(0, len(rows),
                                                      _PROJ_CHUNK)])
    return rows.shape[0]


def average_adapters(adapters: List[Dict[str, Any]],
                     weights: Optional[Sequence[float]] = None
                     ) -> Dict[str, Any]:
    """Eq. 4 (uniform) / Eq. 5 (weighted) parameter averaging: the
    reference's f32 sum w_0 x_0 + w_1 x_1 + ... in the same order, the
    weights normalised in float64; ``_rank`` is the largest rank."""
    if weights is None:
        weights = [1.0 / len(adapters)] * len(adapters)
    w = np.asarray(weights, np.float64)
    w = w / w.sum()

    def avg(*xs):
        acc = None
        for wi, x in zip(w, xs):
            term = x * float(wi)
            acc = term if acc is None else acc + term
        return acc
    out = T.map_tree(avg, *[_body(a) for a in adapters])
    out["_rank"] = torch.tensor(max(int(a["_rank"]) for a in adapters),
                                dtype=torch.int32)
    return out


def count_params(adapter: Dict[str, Any]) -> int:
    return sum(int(x.numel()) for x in T.leaves(_body(adapter)))
