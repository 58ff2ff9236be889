"""Paged lane KV state, host side — the port of ``repro/serving/paging.py``
(which imports JAX, so the port keeps its own numpy copy).

A paged lane cache keeps each layer's K and V as a page pool
(P, page_size, KV, hd): position ``p`` of a row lives at page
``table[row, p // page_size]``, offset ``p % page_size``.
``PageAllocator`` is a free list over page ids that hands
pages out in ascending order, so the same admission sequence always
gives the same block tables as the reference's.  A row reserves its
lazy demand at admission (prompt pages plus one decode page, capped at
the worst case) and ``grow``s page by page at decode boundaries.  The
ring leaves of a grouped model (gemma3's local layers) page from a
second, local pool through a second table: a row takes its whole ring
(``nl`` pages of ``local_len`` slots) at admission and never grows it.

Shared prefixes are copy-on-write at page granularity: a preamble's
whole pages are written into the pool once and mapped into every
sharing row's block table with a refcount bump (``fork``).  A row never
writes inside its shared range (its writes start at its own prompt
length), and the partial tail of the prefix lives in the row's first
owned page, so no copy is ever made in place.  Of the reference's
layout helpers only ``page_bytes`` is here, counted over layers (the
deployment sums the layers of each pool's leaves).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Block-table sentinel for an unmapped page slot, far beyond any real
# pool: decode writes through it drop and gathers clamp onto masked
# garbage.
NO_PAGE = 1 << 20


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` positions."""
    return -(-int(n_tokens) // page_size) if n_tokens > 0 else 0


class PageAllocator:
    """Refcounted free-list allocator over ``num_pages`` page ids,
    deterministic (ascending ids).  ``alloc`` is atomic: ``n`` fresh
    pages at refcount 1, or None without side effects.  ``fork`` adds a
    reader to live pages (the COW share); ``release`` drops one and
    frees a page at refcount 0.  A double free and a fork of a dead page
    raise."""

    def __init__(self, num_pages: int, page_size: int):
        assert num_pages >= 0 and page_size > 0
        self.num_pages = num_pages
        self.page_size = page_size
        # pop() from the tail -> ascending allocation order
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._ref: Dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        return len(self._ref)

    def refcount(self, pid: int) -> int:
        return self._ref.get(pid, 0)

    def check(self) -> None:
        """Internal consistency: every page is exactly live or free."""
        free = set(self._free)
        assert len(free) == len(self._free), "free list holds duplicates"
        assert not (free & set(self._ref)), "page both live and free"
        assert len(free) + len(self._ref) == self.num_pages, "leaked pages"
        assert all(r > 0 for r in self._ref.values())

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        pids = [self._free.pop() for _ in range(n)]
        for p in pids:
            self._ref[p] = 1
        return pids

    def fork(self, pids: Sequence[int]) -> None:
        """COW-share live pages: one more reader per page."""
        for p in pids:
            if p not in self._ref:
                raise ValueError(f"fork of dead page {p}")
        for p in pids:
            self._ref[p] += 1

    def release(self, pids: Sequence[int]) -> None:
        """Drop one reader per page; a page at refcount 0 is free."""
        for p in pids:
            if p not in self._ref:
                raise ValueError(f"double free of page {p}")
        for p in pids:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                self._free.append(p)


class RowPages:
    """One lane row's page mappings: ``shared`` prefix pages (forked,
    never written by this row) then ``owned`` private pages, together
    ``full`` in position order, and its ``local`` ring pages;
    ``cap_pages`` bounds lazy growth at the row's worst-case reservation
    (shared pages included)."""

    def __init__(self, shared: Sequence[int], owned: Sequence[int],
                 local: Sequence[int], cap_pages: Optional[int] = None):
        self.shared = list(shared)
        self.owned = list(owned)
        self.local = list(local)
        self.cap_pages = cap_pages

    @property
    def full(self) -> List[int]:
        return self.shared + self.owned


class LanePager:
    """Page bookkeeping for one lane-model cache: a full-sequence pool
    allocator, an optional local/ring pool allocator and the per-slot
    row mappings."""

    def __init__(self, batch: int, max_seq: int, page_size: int,
                 pages: int, local_len: int = 0,
                 local_pages: int = 0, max_ctx: Optional[int] = None):
        self.page_size = page_size
        self.max_ctx = max_ctx or max_seq
        self.nb = pages_for(self.max_ctx, page_size)
        self.local_len = local_len
        self.nl = pages_for(local_len, page_size) if local_len else 0
        self.alloc = PageAllocator(pages, page_size)
        self.local_alloc = (PageAllocator(local_pages, page_size)
                            if local_len else None)
        self.rows: List[Optional[RowPages]] = [None] * batch

    # ------------------------------------------------------- accounting
    def pool_pages(self) -> Tuple[int, int]:
        """(full, local) pool sizes in pages (0 local without rings)."""
        return (self.alloc.num_pages,
                self.local_alloc.num_pages if self.local_alloc else 0)

    def demand(self, alloc_len: int, shared_pages: int = 0
               ) -> Tuple[int, int]:
        """(new full pages, local pages) a row of worst-case depth
        ``alloc_len`` needs beyond ``shared_pages`` forked ones."""
        return (max(pages_for(alloc_len, self.page_size) - shared_pages, 0),
                self.nl)

    def demand_lazy(self, prompt_len: int, alloc_len: int,
                    shared_pages: int = 0) -> Tuple[int, int]:
        """Lazy reservation: prompt pages + ONE decode page, capped at
        the worst case, beyond ``shared_pages`` forked ones."""
        ps = self.page_size
        want = min(pages_for(prompt_len, ps) + 1, pages_for(alloc_len, ps))
        return max(want - shared_pages, 0), self.nl

    def fits_pool(self, n_full: int, n_local: int) -> bool:
        """Whether the demand could EVER be satisfied (total capacity) —
        the hard-reject predicate."""
        ok = n_full <= self.alloc.num_pages
        if self.local_alloc is not None:
            ok = ok and n_local <= self.local_alloc.num_pages
        return ok

    def fits_free(self, n_full: int, n_local: int) -> bool:
        ok = n_full <= self.alloc.free_pages
        if self.local_alloc is not None:
            ok = ok and n_local <= self.local_alloc.free_pages
        return ok

    def live_bytes(self, page_bytes_full: int, page_bytes_local: int
                   ) -> int:
        b = self.alloc.live_pages * page_bytes_full
        if self.local_alloc is not None:
            b += self.local_alloc.live_pages * page_bytes_local
        return b

    # ------------------------------------------------------- row events
    def admit(self, slot: int, n_full: int, shared: Sequence[int] = (),
              cap_pages: Optional[int] = None) -> Optional[RowPages]:
        """Reserve a row's pages: fork the ``shared`` prefix pages, alloc
        ``n_full`` owned ones (and the ring), atomically (None and no
        side effects when the free lists cannot cover it).
        ``cap_pages`` counts shared + owned pages."""
        assert self.rows[slot] is None, f"slot {slot} already mapped"
        if not self.fits_free(n_full, self.nl):
            return None
        owned = self.alloc.alloc(n_full)
        local: List[int] = []
        if self.local_alloc is not None and self.nl:
            local = self.local_alloc.alloc(self.nl)
        self.alloc.fork(shared)
        row = RowPages(shared, owned, local, cap_pages)
        self.rows[slot] = row
        return row

    def grow(self, slot: int, n: int) -> Optional[List[int]]:
        """Extend a live row's owned pages by ``n`` (atomic, bounded by
        the row's worst-case reservation)."""
        row = self.rows[slot]
        assert row is not None, f"grow of empty slot {slot}"
        if row.cap_pages is not None:
            assert len(row.full) + n <= row.cap_pages, \
                f"growth beyond worst-case reservation ({row.cap_pages})"
        pids = self.alloc.alloc(n)
        if pids is None:
            return None
        row.owned.extend(pids)
        return pids

    def ungrow(self, slot: int, pids: Sequence[int]) -> None:
        """Roll back the most recent ``grow``."""
        row = self.rows[slot]
        assert row is not None and row.owned[len(row.owned) - len(pids):] \
            == list(pids)
        del row.owned[len(row.owned) - len(pids):]
        self.alloc.release(pids)

    def rollback_to(self, slot: int, pos: int) -> List[int]:
        """Speculative rollback of a row to the accepted depth ``pos``
        (tokens [0, pos) kept): the pages grown for rejected drafts stay
        mapped (the next accepted tokens fill them), so nothing is
        freed; checks that the mapping still covers the accepted prefix
        and returns the page ids mapped past it."""
        row = self.rows[slot]
        assert row is not None, f"rollback of empty slot {slot}"
        need = pages_for(pos, self.page_size)
        assert len(row.full) >= need, \
            f"slot {slot}: mapping ({len(row.full)} pages) lost the " \
            f"accepted prefix ({need} pages for pos {pos})"
        return row.full[need:]

    def release(self, slot: int) -> None:
        """Return a drained row's pages to the free lists: its forks of
        shared prefix pages drop one reader and survive for the others."""
        row = self.rows[slot]
        if row is None:
            return
        self.rows[slot] = None
        self.alloc.release(row.shared)
        self.alloc.release(row.owned)
        if self.local_alloc is not None and row.local:
            self.local_alloc.release(row.local)

    # ---------------------------------------------------- device tables
    def table_row(self, row: RowPages) -> np.ndarray:
        """(nb,) int32 block-table row: mapped pages then NO_PAGE."""
        t = np.full((self.nb,), NO_PAGE, np.int32)
        t[:len(row.full)] = row.full
        return t

    def local_row(self, row: RowPages) -> np.ndarray:
        t = np.full((self.nl,), NO_PAGE, np.int32)
        t[:len(row.local)] = row.local
        return t


def page_bytes(num_layers: int, num_kv_heads: int, head_dim: int,
               page_size: int, itemsize: int) -> int:
    """Bytes ONE page id costs across ``num_layers`` layers' K and V
    leaves (pages span every layer, vLLM-style shared tables) — the
    reference's ``page_bytes`` for (..., B, S, KV, hd) leaves."""
    return 2 * num_layers * page_size * num_kv_heads * head_dim * itemsize
