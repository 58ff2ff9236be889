"""The port's host-side paging (``repro_torch/serving/paging.py``) vs the
JAX package's: the same admit/grow/ungrow/release sequences must give
equal block tables, row mappings and free counts, exactly."""
import numpy as np
import pytest

from repro.serving import paging as JPAG
from repro_torch.serving import paging as PAG


def _state(pager):
    rows = [None if r is None else (r.shared, r.owned, r.full, r.local,
                                    r.cap_pages)
            for r in pager.rows]
    tables = [None if r is None else pager.table_row(r).tolist()
              for r in pager.rows]
    return (rows, tables, pager.alloc.free_pages, pager.alloc.live_pages,
            pager.nb, pager.nl)


def test_constants_and_pages_for():
    assert PAG.NO_PAGE == JPAG.NO_PAGE == 1 << 20
    for n in (0, 1, 15, 16, 17, 95, 96, 2047, 2048):
        for ps in (1, 4, 16):
            assert PAG.pages_for(n, ps) == JPAG.pages_for(n, ps)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("lazy", [True, False])
def test_random_admit_grow_release_sequences(seed, lazy):
    """Random lane traffic driven through both pagers in lockstep."""
    rng = np.random.default_rng(seed)
    batch, max_seq, ps = 4, 96, 16
    pages = int(rng.integers(6, batch * max_seq // ps + 1))
    args = (batch, max_seq, ps, pages)
    port, ref = PAG.LanePager(*args), JPAG.LanePager(*args)
    for _ in range(200):
        op = rng.integers(0, 4)
        slot = int(rng.integers(0, batch))
        if op == 0 and port.rows[slot] is None:
            plen = int(rng.integers(1, 80))
            alloc_len = min(plen + int(rng.integers(1, 40)), max_seq)
            demand = (port.demand_lazy(plen, alloc_len) if lazy
                      else port.demand(alloc_len))
            assert demand == (ref.demand_lazy(plen, alloc_len) if lazy
                              else ref.demand(alloc_len))
            assert port.fits_pool(*demand) == ref.fits_pool(*demand)
            assert port.fits_free(*demand) == ref.fits_free(*demand)
            cap = PAG.pages_for(alloc_len, ps)
            got = port.admit(slot, demand[0], cap_pages=cap)
            want = ref.admit(slot, demand[0], cap_pages=cap)
            assert (got is None) == (want is None)
        elif op == 1 and port.rows[slot] is not None:
            room = port.rows[slot].cap_pages - len(port.rows[slot].full)
            if room > 0:
                n = int(rng.integers(1, room + 1))
                got, want = port.grow(slot, n), ref.grow(slot, n)
                assert got == want
                if got is not None and rng.integers(0, 3) == 0:
                    port.ungrow(slot, got)
                    ref.ungrow(slot, want)
        elif op == 2:
            port.release(slot)
            ref.release(slot)
        port.alloc.check()
        assert _state(port) == _state(ref)
        assert port.live_bytes(1000, 0) == ref.live_bytes(1000, 0)


def test_allocator_refcounts_and_errors():
    """Ascending allocation, atomic refusal, a double free raising and
    released pages handed out again, as the reference's allocator does;
    a forked page survives one release and dies at refcount 0, a fork
    of a dead page raises."""
    port, ref = PAG.PageAllocator(5, 16), JPAG.PageAllocator(5, 16)
    for a in (port, ref):
        got = a.alloc(3)
        assert got == [0, 1, 2]
        a.release([1, 2])
        assert a.live_pages == 1 and a.free_pages == 4
        assert a.alloc(5) is None and a.free_pages == 4
        with pytest.raises(ValueError):
            a.release([2])
        assert a.alloc(4) == [2, 1, 3, 4]
        a.check()
        a.fork([0, 3])
        a.fork([0])
        assert [a.refcount(p) for p in range(5)] == [3, 1, 1, 2, 1]
        a.release([0, 3])
        a.release([3])
        assert a.refcount(3) == 0 and a.free_pages == 1
        with pytest.raises(ValueError, match="dead"):
            a.fork([3])
        a.check()


def _alloc_soup(rng, handles, num_pages):
    """One random alloc, fork or release, as (op, argument); the
    caller mirrors ``handles`` (each a list of pids holding one
    reference each) across port and reference."""
    op = int(rng.integers(3))
    if op == 0:
        n = int(rng.integers(0, num_pages + 2))
        return ("alloc", n)
    if op == 1 and handles:
        src = handles[int(rng.integers(len(handles)))]
        if src:
            k = int(rng.integers(1, len(src) + 1))
            return ("fork", [int(p) for p in
                             rng.choice(src, size=k, replace=False)])
    if op == 2 and handles:
        return ("release", int(rng.integers(len(handles))))
    return ("noop", None)


@pytest.mark.parametrize("seed,num_pages", [(0, 1), (1, 3), (2, 6), (3, 8),
                                            (4, 12), (5, 5)])
def test_random_alloc_fork_release_interleavings(seed, num_pages):
    """``tests/test_property.py``'s allocator soup on the port's class in
    lockstep with the reference's: each op gives the same result, every
    outstanding reference is counted (refcounts, live and free pages
    equal a model of the handles), and draining returns to pristine."""
    rng = np.random.default_rng(seed)
    port, ref = (PAG.PageAllocator(num_pages, 16),
                 JPAG.PageAllocator(num_pages, 16))
    handles = []
    for _ in range(60):
        op, arg = _alloc_soup(rng, handles, num_pages)
        if op == "alloc":
            got, want = port.alloc(arg), ref.alloc(arg)
            assert got == want
            if got is not None:
                handles.append(got)
        elif op == "fork":
            port.fork(arg)
            ref.fork(arg)
            handles.append(arg)
        elif op == "release":
            h = handles.pop(arg)
            port.release(h)
            ref.release(h)
        port.check()
        want = {}
        for h in handles:
            for p in h:
                want[p] = want.get(p, 0) + 1
        assert {p: port.refcount(p) for p in want} == want
        assert {p: ref.refcount(p) for p in want} == want
        assert port.live_pages == ref.live_pages == len(want)
        assert port.free_pages == ref.free_pages == num_pages - len(want)
    for h in handles:
        port.release(h)
    port.check()
    assert port.free_pages == num_pages and port.live_pages == 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_random_cow_pager_interleavings(seed):
    """``tests/test_property.py``'s lane-pager soup with a COW-shared
    registry prefix (on half the admits) and lazy growth, on the port's
    pager in lockstep with the reference's: equal rows (shared, owned,
    local), tables, demands and free counts; refusals atomic; the
    shared pages held by exactly 1 + the rows that fork them; owned
    pages exclusive to their row."""
    rng = np.random.default_rng(seed)
    batch, ps, max_seq = 4, 4, 32
    nb = PAG.pages_for(max_seq, ps)
    local = seed % 2
    kw = dict(local_len=8 if local else 0,
              local_pages=int(rng.integers(2, 9)) if local else 0)
    pages = int(rng.integers(4, batch * nb + 1))
    port = PAG.LanePager(batch, max_seq, ps, pages, **kw)
    ref = JPAG.LanePager(batch, max_seq, ps, pages, **kw)
    registry = port.alloc.alloc(2) or []
    assert (ref.alloc.alloc(2) or []) == registry
    share = len(registry)
    for _ in range(60):
        slot = int(rng.integers(batch))
        row = port.rows[slot]
        if row is None:
            sh = registry if (registry and rng.random() < 0.5) else ()
            plen = int(rng.integers(1, max_seq))
            alloc_len = min(plen + int(rng.integers(1, 16)), max_seq)
            n_sh = share if sh else 0
            lazy = port.demand_lazy(plen, alloc_len, n_sh)
            assert lazy == ref.demand_lazy(plen, alloc_len, n_sh)
            assert port.demand(alloc_len, n_sh) == ref.demand(alloc_len,
                                                              n_sh)
            free = port.alloc.free_pages
            cap = PAG.pages_for(alloc_len, ps)
            got = port.admit(slot, lazy[0], shared=sh, cap_pages=cap)
            want = ref.admit(slot, lazy[0], shared=sh, cap_pages=cap)
            assert (got is None) == (want is None)
            if got is None:
                assert port.alloc.free_pages == free
        elif rng.random() < 0.5 and row.cap_pages > len(row.full):
            n = int(rng.integers(1, row.cap_pages - len(row.full) + 1))
            assert port.grow(slot, n) == ref.grow(slot, n)
        else:
            port.release(slot)
            ref.release(slot)
        port.alloc.check()
        assert _state(port) == _state(ref)
        sharers = sum(r is not None and r.shared == registry
                      for r in port.rows)
        for p in registry:
            assert port.alloc.refcount(p) == 1 + sharers
        owned = [p for r in port.rows if r is not None for p in r.owned]
        assert len(owned) == len(set(owned))
        assert not set(owned) & set(registry)


def test_page_bytes_matches_reference_geometry():
    """``page_bytes`` of the plain layout equals the reference's tree
    walk over an (L, B, max_seq, KV, hd) K and V pair."""
    import jax
    import jax.numpy as jnp
    L, kv, hd, ms, ps = 3, 2, 32, 96, 16
    abs_c = {"k": jax.ShapeDtypeStruct((L, 2, ms, kv, hd), jnp.bfloat16),
             "v": jax.ShapeDtypeStruct((L, 2, ms, kv, hd), jnp.bfloat16)}
    axes = {"k": 1, "v": 1}
    assert PAG.page_bytes(L, kv, hd, ps, 2) == JPAG.page_bytes(
        abs_c, axes, ms, ps, local=False)
