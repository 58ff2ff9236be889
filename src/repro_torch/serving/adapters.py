"""Resident adapter cache — the port's copy of
``repro/serving/adapters.py`` (per-user LoRA at serving scale, paper
Sec. III-B).

Every user may bring an adapter, and one lane batch mixes users in one
dispatch.  The device side is a fixed E-slot bank (``core/lora.py``
``empty_bank``); this module is the host side, a refcounted
registry-to-slot map with the KV page pool's residency rules:

  * ``register`` puts an adapter in the registry, the set of ids
    ``submit(adapter_id=)`` may name.  An unknown id is a HARD reject
    (``UnknownAdapter``), like a page demand beyond the pool.
  * ``acquire`` pins an adapter into a slot: resident -> refcount bump
    (a hit); else a free or evictable (refcount 0, least recently used)
    slot is written through ``write`` (a load, possibly an eviction);
    every slot pinned -> None, a SOFT refusal the admission gate
    retries FIFO when pins drop.
  * ``release`` drops one pin (at completion).

Determinism: eviction picks the least recently used refcount-0 slot
(ties -> lowest index), driven only by the acquire/release order, so a
replayed trace maps adapters to the same slots; the one-hot gate math
makes outputs slot-invariant anyway.  The port's ``write`` updates the
bank IN PLACE (the reference's donates and replaces it); ``bank`` still
holds the current bank either way.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional


class UnknownAdapter(KeyError):
    """An adapter id that was never registered — a hard reject (the
    request can never run), not a retryable refusal."""


class AdapterCache:
    """Host bookkeeping for an E-slot device adapter bank.

    ``write`` is ``(bank, adapter, slot) -> bank``; ``bank`` and
    ``write`` may be None for pure bookkeeping."""

    def __init__(self, num_slots: int, bank: Any = None,
                 write: Optional[Callable] = None):
        if num_slots < 0:
            raise ValueError(f"num_slots={num_slots} must be >= 0")
        self.num_slots = num_slots
        self.bank = bank
        self._write = write
        self.registry: Dict[Any, Any] = {}
        self.adapter_in: List[Optional[Any]] = [None] * num_slots
        self.refs: List[int] = [0] * num_slots
        self._used: List[int] = [0] * num_slots   # LRU clock per slot
        self._clock = 0
        self._stats = dict(hits=0, loads=0, evictions=0, refusals=0)

    # ------------------------------------------------------------ registry
    def register(self, adapter_id: Any, adapter: Any):
        """Add (or replace) a registry entry.  Replacing an id whose
        adapter is resident drops the stale residency, so the next
        acquire reloads the new weights."""
        if adapter_id in self.registry:
            slot = self.slot_of(adapter_id)
            if slot is not None:
                if self.refs[slot]:
                    raise RuntimeError(f"adapter {adapter_id!r} replaced "
                                       "while pinned")
                self.adapter_in[slot] = None
        self.registry[adapter_id] = adapter

    def known(self, adapter_id: Any) -> bool:
        return adapter_id in self.registry

    def slot_of(self, adapter_id: Any) -> Optional[int]:
        for s, aid in enumerate(self.adapter_in):
            if aid == adapter_id:
                return s
        return None

    # ----------------------------------------------------------- residency
    def _touch(self, slot: int):
        self._clock += 1
        self._used[slot] = self._clock

    def acquire(self, adapter_id: Any) -> Optional[int]:
        """Pin ``adapter_id`` into a slot and return it; None = soft
        refusal (every slot pinned).  Raises UnknownAdapter for an id
        never registered."""
        if adapter_id not in self.registry:
            raise UnknownAdapter(
                f"unknown adapter id {adapter_id!r}: register it before "
                f"submitting requests that name it")
        slot = self.slot_of(adapter_id)
        if slot is not None:
            self.refs[slot] += 1
            self._stats["hits"] += 1
            self._touch(slot)
            return slot
        slot = self._claim_slot()
        if slot is None:
            self._stats["refusals"] += 1
            return None
        if self.adapter_in[slot] is not None:
            self._stats["evictions"] += 1
        self.adapter_in[slot] = adapter_id
        self.refs[slot] = 1
        self._stats["loads"] += 1
        self._touch(slot)
        if self._write is not None:
            self.bank = self._write(self.bank,
                                    self.registry[adapter_id], slot)
        return slot

    def _claim_slot(self) -> Optional[int]:
        """A free slot if any, else the least recently used refcount-0
        slot (lowest index on ties); None when every slot is pinned."""
        for s in range(self.num_slots):
            if self.adapter_in[s] is None:
                return s
        best = None
        for s in range(self.num_slots):
            if self.refs[s] == 0 and (best is None
                                      or self._used[s] < self._used[best]):
                best = s
        return best

    def release(self, slot: int):
        if not (0 <= slot < self.num_slots and self.refs[slot] > 0):
            raise RuntimeError(f"release of unpinned slot {slot}")
        self.refs[slot] -= 1

    # --------------------------------------------------------------- stats
    def stats(self) -> Dict[str, int]:
        """hits/loads/evictions/refusals counters plus current
        residency."""
        out = dict(self._stats)
        out["resident"] = sum(a is not None for a in self.adapter_in)
        out["pinned"] = sum(r > 0 for r in self.refs)
        return out
