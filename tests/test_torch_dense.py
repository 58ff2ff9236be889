"""Dense lanes of the port's batched engine (``paged=False``, the in-port
parity oracle) and K2's full-length window mode, float32 on the CPU.

* Paged lanes equal dense lanes bit for bit — texts, token, cloud and
  fallback counts, latencies and fusion weights — with greedy and seeded
  rows, the private lane, at ``macro_k`` 0 and 4, on the reduced 2b pair
  and on the reduced gemma3 pair with ring caches (rows run past the
  window of 16), as ``tests/test_paged.py::test_paged_matches_dense{,
  _ring}`` hold the reference's; the gemma3 SLM built without rings
  (full-length window leaves) serves the same texts on paged and dense
  lanes.
* The port's dense engine against the reference's ``paged=False`` engine:
  texts, counts and latencies equal, fusion weights within 1e-5 (as
  ``test_torch_batched.py``), the same lane bytes.
* A dense row parked at FREED_POS is not written; a dense packed prefill
  places its rows as the reference's ``_pad_cache(lengths=)``.
* K2's plain version and split-K model in the full-length window mode
  against the reference's ``rowwise_decode_attention(window)`` over
  ``gather_pages``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import fusion as JFUS
from repro.models import attention as JATT
from repro.models.model import LM as JLM
from repro.serving.engine import BatchedHybridEngine as JBatched
from repro.serving.latency import LatencyModel as JLat
from repro.serving.scheduler import ContinuousBatchScheduler as JCBS
from repro_torch import bridge
from repro_torch.kernels.paged_attention import kernel as K2
from repro_torch.models.attention import FREED_POS
from repro_torch.models.model import LM
from repro_torch.serving.deployment import ServingDeployment
from repro_torch.serving.engine import BatchedHybridEngine
from repro_torch.serving.latency import LatencyModel
from repro_torch.serving.scheduler import ContinuousBatchScheduler
from _threads import one_thread  # noqa: F401

LAT = dict(rtt_ms=10, jitter_ms=0)
JITTER = dict(rtt_ms=160, jitter_ms=40.0, cloud_compute_ms=20, seed=7)
MAX_SEQ = 48
W_TOL = 1e-5
TOL = dict(rtol=1e-5, atol=1e-5)
PROMPTS = [
    "math: compute 12 plus 7 =",
    "my ssn is 123-45-6789, fill the benefits form",       # private
    "translate to french: water ->",
    "sort ascending: 40 12 77 31 ->",
    "explain how rainbows form",
    "list three colors",
]


def _bridge(tree):
    return bridge.from_numpy(jax.device_get(tree))


@pytest.fixture(scope="module")
def pairs(slm, llm):
    """{"2b", "gemma3"}: (reference parts, port parts); the gemma3 SLM
    is the reduced floe-slm-gemma3 (a local and a global layer, window
    16) with ring caches, as the reference's ``test_paged.py`` builds
    it."""
    (jslm, sp), (jllm, lp) = slm, llm
    mlp = JFUS.init_alignment(jax.random.key(2), jslm.cfg.vocab_size)
    gcfg = get_config("floe-slm-gemma3").reduced()
    jg = JLM(gcfg, remat=False, ring_cache=True)
    gp = jg.init(jax.random.key(0))
    out = {}
    for name, (js, jsp) in (("2b", (jslm, sp)), ("gemma3", (jg, gp))):
        port = (LM(js.cfg, device="cpu", ring_cache=js.ring_cache),
                _bridge(jsp), LM(jllm.cfg, device="cpu"), _bridge(lp),
                _bridge(mlp))
        out[name] = ((js, jsp, jllm, lp, mlp), port)
    return out


def _dep(port, lat=LAT, slm=None):
    s, sp, l, lp, mlp = port
    return ServingDeployment(slm or s, sp, l, lp, mlp,
                             latency=LatencyModel(**lat), max_seq=MAX_SEQ,
                             device="cpu")


def _run(eng, n_tokens):
    sched = ContinuousBatchScheduler(eng)
    for i, p in enumerate(PROMPTS):
        sched.submit(p, n_tokens, greedy=(i % 2 == 0), seed=i)
    return sched.run()


def _engine(dep, paged, macro_k):
    return BatchedHybridEngine(deployment=dep, batch_size=4,
                               edge_batch_size=1, macro_k=macro_k,
                               paged=paged)


def _exact(ref, got):
    """Bit-identity of two runs' responses."""
    assert [r.rid for r in got] == [r.rid for r in ref]
    for a, b in zip(ref, got):
        assert b.text == a.text, (a.rid, a.text, b.text)
        for f in ("private", "tokens", "cloud_tokens", "fallback_tokens",
                  "cloud_calls", "truncated", "latency_ms", "fusion_w"):
            assert getattr(b.stats, f) == getattr(a.stats, f), (a.rid, f)


@pytest.mark.parametrize("name,n_tokens", [("2b", 5), ("gemma3", 8)])
@pytest.mark.parametrize("macro_k", [0, 4])
def test_paged_matches_dense(pairs, name, n_tokens, macro_k):
    """Paged lanes are bit for bit the dense lanes, greedy and seeded
    rows, per-token and macro cadence, private and cloud lanes."""
    dep = _dep(pairs[name][1])
    dense = _engine(dep, False, macro_k)
    r_dense = _run(dense, n_tokens)
    r_paged = _run(_engine(dep, True, macro_k), n_tokens)
    _exact(r_dense, r_paged)
    assert any(r.stats.private for r in r_dense)
    assert dense.cloud_lane.pager_s is None
    assert "block" not in dense.cloud_lane.s_cache
    assert dense.resident_kv_bytes() == dense.kv_pool_bytes()


def test_dense_matches_reference(pairs):
    """The port's dense engine against the reference's ``paged=False``
    engine under jittery weather, at macro_k 0: texts, counts and
    latencies equal, fusion weights within 1e-5, the same lane bytes."""
    (jslm, sp, jllm, lp, mlp), port = pairs["2b"]
    kw = dict(batch_size=3, edge_batch_size=2, macro_k=0, paged=False)
    jeng = JBatched(jslm, sp, jllm, lp, mlp, latency=JLat(**JITTER),
                    max_seq=MAX_SEQ, **kw)
    eng = BatchedHybridEngine(deployment=_dep(port, JITTER), **kw)
    assert eng.kv_pool_bytes() == jeng.kv_pool_bytes()
    runs = []
    for e in (jeng, eng):
        sched = (JCBS if e is jeng else ContinuousBatchScheduler)(e)
        for p, n in zip(PROMPTS, (9, 6, 12, 5, 10, 3)):
            sched.submit(p, n)
        runs.append(sched.run())
    jres, tres = runs
    assert [r.rid for r in tres] == [r.rid for r in jres]
    for a, b in zip(jres, tres):
        assert b.text == a.text, (a.rid, a.text, b.text)
        for f in ("private", "tokens", "cloud_tokens", "fallback_tokens",
                  "cloud_calls", "truncated", "latency_ms", "admit_seq"):
            assert getattr(b.stats, f) == getattr(a.stats, f), (a.rid, f)
        np.testing.assert_allclose(b.stats.fusion_w, a.stats.fusion_w,
                                   rtol=0, atol=W_TOL)
    assert any(0 < r.stats.fallback_tokens < r.stats.tokens for r in tres)
    assert eng.resident_kv_bytes() == jeng.resident_kv_bytes() > 0


def test_dense_parked_rows_not_written(pairs):
    """A drained dense row is parked (pos = FREED_POS on the device and
    the host) and keeps its K/V bit for bit while the other row decodes;
    an admission into it replaces the whole row and gives the
    fresh-admit text."""
    dep = _dep(pairs["2b"][1])
    eng = _engine(dep, False, 0)
    lane = eng.cloud_lane
    alone = {}
    assert eng.add_request("translate to french: water ->", 3, True, 9)
    while eng.active_count():
        alone.update((rid, text) for rid, text, _ in eng.step())
    assert eng.add_request("translate to french: water ->", 2, True, 0)
    assert eng.add_request("explain how rainbows form", 10, True, 1)
    slot = next(i for i, s in enumerate(lane.slots) if s and s.rid == 0)
    done = []
    while not any(d[0] == 0 for d in done):
        done += eng.step()
    for cache in (lane.s_cache, lane.l_cache):
        assert int(cache["pos"][slot]) == FREED_POS
        assert cache["pos_host"][slot] == FREED_POS
    snap = [c["k"][:, slot].clone() for c in (lane.s_cache, lane.l_cache)]
    for _ in range(3):                                  # rid 1 decodes on
        eng.step()
    for c, before in zip((lane.s_cache, lane.l_cache), snap):
        assert torch.equal(c["k"][:, slot], before)
    while eng.active_count():
        eng.step()
    assert eng.add_request("translate to french: water ->", 3, True, 9)
    got = {}
    while eng.active_count():
        got.update((rid, text) for rid, text, _ in eng.step())
    assert got == alone


@pytest.mark.parametrize("macro_k", [0, 4])
def test_full_length_window_leaves_match_rings(pairs, macro_k):
    """The gemma3 SLM built without ring caches (the reference's ``LM``
    default) keeps full-length local leaves, masked to the window per
    row: on paged and on dense lanes it serves the ring lanes' texts."""
    port = pairs["gemma3"][1]
    flat = LM(port[0].cfg, device="cpu")
    ring = _run(_engine(_dep(port), True, macro_k), 8)
    for paged in (True, False):
        eng = _engine(_dep(port, slm=flat), paged, macro_k)
        got = _run(eng, 8)
        assert [r.text for r in got] == [r.text for r in ring], paged
        leaf = eng.cloud_lane.s_cache["inner"]["k"]
        if paged:
            assert "local" not in eng.cloud_lane.s_cache
        else:
            assert leaf.shape[-3] == MAX_SEQ


def test_dense_packed_prefill_matches_reference(pairs):
    """``LM.prefill_packed`` without a ``write_kv`` returns the dense
    cache: every leaf (full-length, and ring rows gathered per row past
    the window) equal to the reference's ``_pad_cache(lengths=)``
    placement, positions = lengths, last-token logits within 1e-4."""
    (js, sp, *_), (slm, tsp, *_) = pairs["gemma3"]
    lengths = np.array([20, 9, 33, 1], np.int32)
    rng = np.random.default_rng(5)
    toks = np.zeros((4, 48), np.int64)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(3, 259, n)
    jl, jc = js.prefill_packed(sp, {"tokens": jnp.asarray(toks, jnp.int32)},
                               jnp.asarray(lengths), MAX_SEQ)
    logits, cache = slm.prefill_packed(tsp, torch.from_numpy(toks),
                                       lengths, MAX_SEQ)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(cache["pos"].numpy(), lengths)
    assert cache["inner"]["k"].shape[-3] == 16          # a ring of 16
    for kind in ("inner", "tail", "global"):
        for leaf in ("k", "v"):
            np.testing.assert_allclose(cache[kind][leaf].numpy(),
                                       np.asarray(jc[kind][leaf]), **TOL)


# rows below, at and past the window, one past the table's middle and a
# parked row, on a 6-page table of 4-slot pages
WINDOW_POSITIONS = [0, 5, 9, 10, 17, 23, 1 << 30]


def _window_case(window, seed):
    b, h, kvh, hd, n_pool, ps, nb = 7, 4, 2, 16, 48, 4, 6
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    pk = rng.standard_normal((n_pool, ps, kvh, hd)).astype(np.float32)
    pv = rng.standard_normal((n_pool, ps, kvh, hd)).astype(np.float32)
    pos = np.asarray(WINDOW_POSITIONS, np.int32)
    free = list(rng.permutation(n_pool))
    table = np.full((b, nb), 1 << 20, np.int32)
    for i, p in enumerate(WINDOW_POSITIONS):
        if p < FREED_POS:
            table[i, :p // ps + 1] = [free.pop() for _ in range(p // ps + 1)]
    # the reference: gather the whole table, mask to the window
    flat = lambda a: jnp.asarray(a).reshape(n_pool * ps, kvh, hd)
    jt = jnp.asarray(table)
    gk = JATT.gather_pages(flat(pk), jt, nb * ps, ps)
    gv = JATT.gather_pages(flat(pv), jt, nb * ps, ps)
    ref = JATT.rowwise_decode_attention(jnp.asarray(q)[:, None], gk, gv,
                                        jnp.asarray(pos), window)
    return (q, pk, pv, table, pos), np.asarray(ref)[:, 0]


@pytest.mark.parametrize("window", [10, 8, 5])
def test_k2_window_mode_matches_reference(window):
    """K2's full-length window mode (``ring=False``): the plain version
    and the split-K model (every split count, walking the live pages or
    every covered page) against the reference's masked gather, live
    rows within 1e-5; the split-K model's parked row is zeros."""
    args, ref = _window_case(window, 40 + window)
    t = [torch.from_numpy(a) for a in args]
    live = args[4] < FREED_POS
    plain = K2.paged_decode_attention(*t, window=window, ring=False).numpy()
    np.testing.assert_allclose(plain[live], ref[live], **TOL)
    cover = (window + 2) // 4 + 1
    for splits in range(1, cover + 1):
        for skip_dead in (True, False):
            got = K2.paged_decode_splitk_model(
                *t, window=window, ring=False, splits=splits,
                skip_dead=skip_dead).numpy()
            np.testing.assert_allclose(got[live], ref[live], **TOL)
            assert not got[~live].any()
