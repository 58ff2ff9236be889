"""The port's host-side paging (``repro_torch/serving/paging.py``) vs the
JAX package's: the same admit/grow/ungrow/release sequences must give
equal block tables, row mappings and free counts, exactly."""
import numpy as np
import pytest

from repro.serving import paging as JPAG
from repro_torch.serving import paging as PAG


def _state(pager):
    rows = [None if r is None else (r.full, r.local, r.cap_pages)
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
    released pages handed out again, as the reference's allocator does
    for pages with one reader (COW forks are a later slice)."""
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
