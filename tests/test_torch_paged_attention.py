"""K2 and the paged decode path of the port vs the JAX package.

CPU cases run in float32: K2's plain version against the Pallas kernel
in interpret mode and its jnp oracle ``paged_decode_ref`` (the sweep of
``tests/test_kernels.py``: GQA groups 1 and 2, sentinel table entries,
window mode), and the port's paged ``attention_block`` decode against
the reference's with the same pools and block tables.  Tolerance 1e-5:
the same f32 softmax reduced in another order.  The CUDA kernel is held
against its plain version on the card by ``tests/test_torch_gpu.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.paged_attention.kernel import \
    paged_decode_attention as jpaged
from repro.kernels.paged_attention.ref import paged_decode_ref
from repro.models import attention as JATT
from repro.models.model import LM as JLM
from repro_torch import bridge
from repro_torch.kernels.paged_attention import kernel as K2
from repro_torch.models import attention as ATT
from _threads import one_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
NO_PAGE = 1 << 20


def _case(seed, b, h, kvh, hd, n_pool, ps, nb, window):
    """Random pool and a block table shaped as the allocator builds it:
    plain rows map the pages their position needs (sentinel past that),
    ring rows a full page ring."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    pk = rng.standard_normal((n_pool, ps, kvh, hd)).astype(np.float32)
    pv = rng.standard_normal((n_pool, ps, kvh, hd)).astype(np.float32)
    free = list(rng.permutation(n_pool))
    if window:
        pos = rng.integers(0, 3 * window, (b,)).astype(np.int32)
        table = np.asarray([[free.pop() for _ in range(nb)]
                            for _ in range(b)], np.int32)
    else:
        pos = rng.integers(0, nb * ps, (b,)).astype(np.int32)
        table = np.full((b, nb), NO_PAGE, np.int32)
        for i in range(b):
            for t in range(int(pos[i]) // ps + 1):
                table[i, t] = free.pop()
    return q, pk, pv, table, pos


def _both(q, pk, pv, table, pos, window=0):
    got = K2.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, pk, pv, table, pos)),
        window=window).numpy()
    j = [jnp.asarray(a) for a in (q, pk, pv, table, pos)]
    pallas = jpaged(*j, window=window, interpret=True)
    ref = paged_decode_ref(*j, window=window)
    return got, np.asarray(pallas), np.asarray(ref)


@pytest.mark.parametrize("b,h,kvh,hd,n_pool,ps,nb", [
    (3, 4, 2, 16, 12, 4, 3),      # group 2
    (2, 8, 8, 32, 16, 8, 2),      # group 1
    (4, 4, 1, 64, 20, 16, 3),     # extreme GQA, serving page size
])
def test_plain_paged_matches_pallas_and_ref(b, h, kvh, hd, n_pool, ps, nb):
    got, pallas, ref = _both(*_case(11 + b, b, h, kvh, hd, n_pool, ps, nb,
                                    0))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("window,ps,nb", [(12, 4, 3), (10, 4, 3)])
def test_plain_paged_ring_matches_pallas_and_ref(window, ps, nb):
    got, pallas, ref = _both(*_case(12, 3, 4, 2, 16, 12, ps, nb, window),
                             window=window)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


def test_plain_paged_parked_row_and_sentinels():
    """A parked row (pos = FREED_POS, table all NO_PAGE) reads clamped
    garbage exactly as the Pallas kernel does; live rows are unaffected
    by the sentinel tails of their tables."""
    q, pk, pv, table, pos = _case(5, 3, 4, 2, 16, 12, 4, 3, 0)
    table[1] = NO_PAGE
    pos[1] = ATT.FREED_POS
    got, pallas, ref = _both(q, pk, pv, table, pos)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


def test_gather_and_scatter_match_reference():
    """``gather_pages`` and the in-place ``scatter_page_token`` (sink
    page last) against the reference's functional versions: parked
    rows, slots past the limit and NO_PAGE entries all drop."""
    rng = np.random.default_rng(3)
    n_pool, ps, nb = 6, 4, 3
    pool = rng.standard_normal((n_pool, ps, 2, 8)).astype(np.float32)
    table = np.array([[2, 0, NO_PAGE], [1, 4, 5], [3, NO_PAGE, NO_PAGE],
                      [NO_PAGE] * 3], np.int32)
    row_pos = np.array([5, 11, 6, ATT.FREED_POS], np.int32)
    tok = rng.standard_normal((4, 2, 8)).astype(np.float32)
    want = JATT.scatter_page_token(jnp.asarray(pool), jnp.asarray(table),
                                   jnp.asarray(row_pos),
                                   jnp.asarray(row_pos), jnp.asarray(tok),
                                   nb * ps)
    port = torch.from_numpy(np.concatenate([pool, np.zeros_like(pool[:1])]))
    ATT.scatter_page_token(port, torch.from_numpy(table),
                           torch.from_numpy(row_pos),
                           torch.from_numpy(row_pos), torch.from_numpy(tok),
                           nb * ps)
    np.testing.assert_array_equal(port[:n_pool].numpy(), np.asarray(want))
    flat = np.array(want).reshape(n_pool * ps, 2, 8)
    gwant = JATT.gather_pages(jnp.asarray(flat), jnp.asarray(table),
                              nb * ps, ps)
    ggot = ATT.gather_pages(torch.from_numpy(flat), torch.from_numpy(table),
                            nb * ps, ps)
    np.testing.assert_array_equal(ggot.numpy(), np.asarray(gwant))


@pytest.mark.parametrize("name", ["floe-slm-2b", "floe-llm-7b"])
def test_paged_attention_block_matches_reference(name):
    """One paged decode layer of the reduced model: same pools, tables
    and per-row positions (one parked row, one row whose next slot
    opens a fresh page) through both ``attention_block``s."""
    cfg = get_config(name).reduced()
    jparams = JLM(cfg, remat=False).init(jax.random.key(4))
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    p = bridge.from_numpy(jax.device_get(jp))
    rng = np.random.default_rng(9)
    b, ps, nb, n_pool = 4, 16, 6, 20
    kvh, hd = cfg.num_kv_heads, cfg.head_dim
    pk = rng.standard_normal((n_pool, ps, kvh, hd)).astype(np.float32)
    pv = rng.standard_normal((n_pool, ps, kvh, hd)).astype(np.float32)
    table = np.full((b, nb), NO_PAGE, np.int32)
    table[0, :2] = [3, 7]
    table[1, :6] = [0, 1, 2, 4, 5, 6]
    table[3, :3] = [8, 9, 10]
    pos = np.array([17, 90, ATT.FREED_POS, 32], np.int32)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)

    jy, jc = JATT.attention_block(
        cfg, jp, jnp.asarray(x), positions=jnp.asarray(pos),
        cache={"k": jnp.asarray(pk), "v": jnp.asarray(pv)}, mode="decode",
        pages={"block": jnp.asarray(table)})
    sink = np.zeros((1, ps, kvh, hd), np.float32)
    cache = {"k": torch.from_numpy(np.concatenate([pk, sink])),
             "v": torch.from_numpy(np.concatenate([pv, sink]))}
    y, _ = ATT.attention_block(
        cfg, p, torch.from_numpy(x), positions=torch.from_numpy(pos),
        cache=cache, mode="decode",
        pages={"block": torch.from_numpy(table)}, host_pos=pos)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for name_ in ("k", "v"):
        np.testing.assert_allclose(cache[name_][:n_pool].numpy(),
                                   np.asarray(jc[name_]), **TOL)


def test_live_row_past_the_cache_raises():
    """The host-mirror guard: a live row at or past n_slots raises before
    any dispatch (parked rows are exempt)."""
    ATT.check_row_positions(np.array([0, 95, ATT.FREED_POS]), 96)
    with pytest.raises(ValueError, match="outside"):
        ATT.check_row_positions(np.array([0, 96]), 96)


def _splitk(q, pk, pv, table, pos, window=0, **kw):
    return K2.paged_decode_splitk_model(
        *(torch.from_numpy(a) for a in (q, pk, pv, table, pos)),
        window=window, **kw).numpy()


def _hold_live_rows(got, q, pk, pv, table, pos, window=0):
    """Live rows against interpret-mode Pallas and ``paged_decode_ref``;
    parked rows must be zeros (the kernel reads no page for them)."""
    _, pallas, ref = _both(q, pk, pv, table, pos, window=window)
    live = pos < ATT.FREED_POS
    np.testing.assert_allclose(got[live], pallas[live], **TOL)
    np.testing.assert_allclose(got[live], ref[live], **TOL)
    assert not got[~live].any()


# ps 4, nb 6: live pages 1, 1, 2, 3, 3, 6, 0 (parked), 2.  With 2 splits
# (3 pages each) the 3-page rows end at the split edge; with 3 splits (2
# pages each) the 2-page rows end at an edge and the 3-page rows inside
# a split; with nb splits every page is one and short rows leave most
# splits empty.
SPLIT_POSITIONS = [0, 3, 7, 8, 11, 23, 1 << 30, 5]


@pytest.mark.parametrize("splits", [1, 2, 3, 6])
@pytest.mark.parametrize("skip_dead", [True, False])
def test_splitk_model_matches_pallas_and_ref(splits, skip_dead):
    """The two-stage split-K algorithm of the CUDA kernel (per-split
    partials (m, l, O) over fixed page ranges, fixed-order combine) vs
    the reference, with a parked row and NO_PAGE sentinels past each
    row's live pages and one inside a live range (clamped onto page
    P - 1 by all three).  ``skip_dead=False`` also walks the pages past
    pos, whose splits are all masked and must weigh exactly 0."""
    b, h, kvh, hd, n_pool, ps, nb = 8, 8, 2, 16, 40, 4, 6
    rng = np.random.default_rng(21 + splits)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    pk = rng.standard_normal((n_pool, ps, kvh, hd)).astype(np.float32)
    pv = rng.standard_normal((n_pool, ps, kvh, hd)).astype(np.float32)
    pos = np.asarray(SPLIT_POSITIONS, np.int32)
    free = list(rng.permutation(n_pool - 1))
    table = np.full((b, nb), NO_PAGE, np.int32)
    for i, p in enumerate(SPLIT_POSITIONS):
        if p < ATT.FREED_POS:
            table[i, :p // ps + 1] = [free.pop() for _ in range(p // ps + 1)]
    table[7, 1] = NO_PAGE                 # a live page clamped onto P - 1
    got = _splitk(q, pk, pv, table, pos, splits=splits, skip_dead=skip_dead)
    _hold_live_rows(got, q, pk, pv, table, pos)


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("skip_dead", [True, False])
@pytest.mark.parametrize("window", [12, 10])
def test_splitk_model_ring_matches_pallas_and_ref(splits, skip_dead,
                                                  window):
    """Window mode on ring-local tables (3 pages of 4): young rows (pos <
    window) whose later ring slots are all masked — with
    ``skip_dead=False`` whole splits of them — a row whose slot count is
    past the ring, and a parked row."""
    b, h, kvh, hd, n_pool, ps, nb = 6, 4, 1, 16, 30, 4, 3
    rng = np.random.default_rng(window + splits)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    pk = rng.standard_normal((n_pool, ps, kvh, hd)).astype(np.float32)
    pv = rng.standard_normal((n_pool, ps, kvh, hd)).astype(np.float32)
    pos = np.asarray([0, 2, 5, window - 1, 3 * window + 1, 1 << 30],
                     np.int32)
    free = list(rng.permutation(n_pool))
    table = np.asarray([[free.pop() for _ in range(nb)] for _ in range(b)],
                       np.int32)
    table[5] = NO_PAGE
    got = _splitk(q, pk, pv, table, pos, window=window, splits=splits,
                  skip_dead=skip_dead)
    _hold_live_rows(got, q, pk, pv, table, pos, window=window)
