"""Paging under pool pressure in the port's batched engine: rows park
when their growth cannot be met, a wedged lane evicts its youngest rows
and re-admits them from prompt + tokens so far, the growth counters,
FIFO admission with no overtake and no starvation — the port of
``tests/test_growth.py``, float32 on the CPU.

page_size=4 deployments make page-boundary crossings and pool
exhaustion cheap to trigger (a 10-token prompt with a 16-token budget
spans 3-7 pages); the default-pool engine on the same deployment is the
oracle, bit for bit: backpressure may change when rows decode, never
what they decode.  One run holds the port's pool-pressure engine to the
reference's (texts, counts, latencies and ``growth_stats()`` equal,
fusion weights within 1e-5), and the gemma3 pair serves under SLM, LLM
and ring-page budgets at ``macro_k`` 0 and 8."""
import jax
import numpy as np
import pytest

from repro.configs import get_config
from repro.core import fusion as JFUS
from repro.models.model import LM as JLM
from repro.serving.deployment import ServingDeployment as JDep
from repro.serving.engine import BatchedHybridEngine as JBatched
from repro.serving.latency import LatencyModel as JLat
from repro.serving.scheduler import ContinuousBatchScheduler as JCBS
from repro_torch import bridge
from repro_torch.data import tokenizer as TOK
from repro_torch.models.model import LM
from repro_torch.serving.deployment import ServingDeployment
from repro_torch.serving.engine import BatchedHybridEngine
from repro_torch.serving.latency import LatencyModel
from repro_torch.serving.scheduler import ContinuousBatchScheduler
from _threads import one_thread  # noqa: F401

LAT = dict(rtt_ms=10, jitter_ms=0)
SHORT = "hi there"            # 10 tokens: 3 pages @ 4 + 1 decode page
W_TOL = 1e-5


def _bridge(tree):
    return bridge.from_numpy(jax.device_get(tree))


@pytest.fixture(scope="module")
def parts(slm, llm):
    """(reference parts, port parts) of the reduced 2b pair."""
    (jslm, sp), (jllm, lp) = slm, llm
    mlp = JFUS.init_alignment(jax.random.key(2), jslm.cfg.vocab_size)
    port = (LM(jslm.cfg, device="cpu"), _bridge(sp),
            LM(jllm.cfg, device="cpu"), _bridge(lp), _bridge(mlp))
    return (jslm, sp, jllm, lp, mlp), port


@pytest.fixture(scope="module")
def dep4(parts):
    slm, sp, llm, lp, mlp = parts[1]
    return ServingDeployment(slm, sp, llm, lp, mlp,
                             latency=LatencyModel(**LAT), max_seq=48,
                             page_size=4, device="cpu")


def _run(eng, reqs, sched=ContinuousBatchScheduler):
    s = sched(eng)
    for i, (p, mn) in enumerate(reqs):
        s.submit(p, mn, greedy=(i % 2 == 0), seed=i)
    return s.run()


def _assert_same(ref, got):
    assert [r.rid for r in got] == [r.rid for r in ref]
    for a, b in zip(ref, got):
        assert b.text == a.text, (a.rid, a.text, b.text)
        for f in ("private", "tokens", "cloud_tokens", "fallback_tokens",
                  "cloud_calls", "latency_ms", "fusion_w", "admit_seq"):
            assert getattr(b.stats, f) == getattr(a.stats, f), (a.rid, f)


def _engine(dep, **kw):
    kw.setdefault("batch_size", 2)
    kw.setdefault("edge_batch_size", 1)
    return BatchedHybridEngine(deployment=dep, **kw)


@pytest.mark.parametrize("macro_k", [0, 4])
def test_park_backpressure_bit_identity(dep4, macro_k):
    """A pool too small for both rows' growth parks one of them until
    pages free; the parked row's stream stays bit-identical to the
    roomy-pool engine's."""
    reqs = [(SHORT, 16), (SHORT + " x", 16)]
    ref = _run(_engine(dep4, macro_k=macro_k), reqs)
    assert any(r.stats.tokens == 16 for r in ref)
    eng = _engine(dep4, macro_k=macro_k, pool_pages=9)
    _assert_same(ref, _run(eng, reqs))
    st = eng.growth_stats()
    assert st["grown_pages"] > 0 and st["parks"] > 0
    assert st["forced"] == 0


@pytest.mark.parametrize("macro_k", [0, 4])
@pytest.mark.parametrize("pool", [7, 8])
def test_wedge_evicts_and_resumes(dep4, macro_k, pool):
    """A pool that holds only one row's full depth: the second request
    soft-waits at admission (7 pages) or both rows are admitted, wedge
    at their first growth and the younger is evicted (8 pages); it
    re-prefills from prompt + tokens so far once the first completes and
    still gives the roomy-pool stream bit for bit (its re-prefill's
    logits equal the decode logits it was parked on, in f32 on the
    CPU), keeping its admission number."""
    reqs = [(SHORT, 16), (SHORT + " x", 16)]
    ref = _run(_engine(dep4, macro_k=macro_k), reqs)
    eng = _engine(dep4, macro_k=macro_k, pool_pages=pool)
    got = _run(eng, reqs)
    _assert_same(ref, got)
    assert all(r.stats.tokens == 16 for r in got)
    st = eng.growth_stats()
    assert (st["evictions"] > 0) == (pool == 8) and st["forced"] == 0
    # the younger request, every time
    assert eng.evicted_rids == [got[1].rid] * st["evictions"]
    assert eng.active_count() == 0 and eng.resident_kv_bytes() == 0


def test_growth_stats_counters(dep4):
    """Grown pages count both models; parks, evictions and forced
    completions stay zero when the pool is roomy."""
    eng = _engine(dep4, macro_k=0)
    _run(eng, [(SHORT, 16)])
    st = eng.growth_stats()
    # a 10-token prompt reserves 3 + 1 pages and decodes to depth 25:
    # pages 5..7 arrive by growth, on the SLM and the LLM pager
    assert st["grown_pages"] >= 6
    assert st["parks"] == st["evictions"] == st["forced"] == 0
    assert eng.evicted_rids == []


def test_fifo_no_overtake_in_burst(dep4):
    """Within one burst a soft-refused request blocks later arrivals
    bound for the same lane, and a lane with an eviction pending admits
    nothing external."""
    eng = _engine(dep4, batch_size=4, edge_batch_size=None, pool_pages=12)
    assert eng.add_request(SHORT, 16, True, 0)          # 4 lazy pages
    assert eng.add_request(SHORT + " x", 16, True, 1)   # 4 more
    big = "sixteen toks ->"
    assert len(TOK.encode(big + " ")) == 17             # 5 + 1 pages
    flags = eng.add_requests([(big, 16, True, 2),
                              (SHORT, 4, True, 3)])     # 3 would fit
    assert flags == [False, False], \
        "a later small request overtook the soft-refused head"
    assert eng.pop_rejected() == []
    lane = eng.cloud_lane
    lane._evictq.append(lane.slots[1])                  # pending eviction
    assert not eng.add_request("hi", 2, True, 4)
    assert eng.active_count() == 3


def test_fifo_no_starvation_under_stream(dep4):
    """A big request soft-refused once must still admit in submission
    order under a sustained stream of small ones that would fit."""
    eng = _engine(dep4, macro_k=0, pool_pages=12)
    filler = "please fill all the pool"   # 26 toks: 8 lazy pages of 12
    big = "sixteen toks ->"               # 17 toks: lazy 6 > 4 free
    assert len(TOK.encode(filler + " ")) == 26
    sched = ContinuousBatchScheduler(eng)
    sched.submit(filler, 12)
    sched.submit(big, 16)
    for _ in range(6):
        sched.submit(SHORT, 2)
    res = sched.run()
    assert all(r.error is None for r in res)
    seqs = [r.stats.admit_seq for r in res]
    assert seqs == sorted(seqs), f"admission overtook FIFO: {seqs}"
    assert res[1].stats.tokens == 16


def test_pool_pressure_matches_reference(parts):
    """The port's engine under a pool that parks and evicts against the
    reference's, per-token: texts, counts, latencies, admission numbers
    and ``growth_stats()`` equal, fusion weights within 1e-5."""
    (jslm, sp, jllm, lp, mlp), port = parts
    slm, tsp, llm, tlp, tmlp = port
    kw = dict(batch_size=3, edge_batch_size=1, macro_k=0, pool_pages=14)
    jeng = JBatched(deployment=JDep(jslm, sp, jllm, lp, mlp,
                                    latency=JLat(**LAT), max_seq=48,
                                    page_size=4), paged=True, **kw)
    eng = BatchedHybridEngine(deployment=ServingDeployment(
        slm, tsp, llm, tlp, tmlp, latency=LatencyModel(**LAT), max_seq=48,
        page_size=4, device="cpu"), **kw)
    reqs = [(SHORT, 16), (SHORT + " x", 14), ("my ssn is 123", 9),
            ("list three colors", 12), (SHORT + " y", 10)]
    jres = _run(jeng, reqs, JCBS)
    tres = _run(eng, reqs)
    assert [r.rid for r in tres] == [r.rid for r in jres]
    for a, b in zip(jres, tres):
        assert b.text == a.text, (a.rid, a.text, b.text)
        for f in ("private", "tokens", "cloud_tokens", "fallback_tokens",
                  "cloud_calls", "latency_ms", "admit_seq"):
            assert getattr(b.stats, f) == getattr(a.stats, f), (a.rid, f)
        np.testing.assert_allclose(b.stats.fusion_w, a.stats.fusion_w,
                                   rtol=0, atol=W_TOL)
    st = eng.growth_stats()
    assert st == jeng.growth_stats()
    assert st["parks"] > 0 and st["evictions"] > 0 and st["forced"] == 0


@pytest.mark.parametrize("macro_k", [0, 8])
def test_gemma3_budgets_match_roomy_pools(parts, macro_k):
    """The gemma3 pair (rings of 16 slots paged from the local pool) under
    an SLM, an LLM and a ring-page budget that make rows wait for pages
    and park: the roomy pools' streams bit for bit."""
    _, (_, _, llm, tlp, tmlp) = parts
    gcfg = get_config("floe-slm-gemma3").reduced()
    gp = JLM(gcfg, remat=False, ring_cache=True).init(jax.random.key(0))
    g = LM(gcfg, device="cpu", ring_cache=True)
    dep = ServingDeployment(g, _bridge(gp), llm, tlp, tmlp,
                            latency=LatencyModel(**LAT), max_seq=48,
                            page_size=4, device="cpu")
    reqs = [(SHORT, 16), ("translate to french: water ->", 12),
            (SHORT + " x", 14), ("list three colors", 9)]
    ref = _run(_engine(dep, batch_size=3, macro_k=macro_k), reqs)
    eng = _engine(dep, batch_size=3, macro_k=macro_k, pool_pages=12,
                  llm_pool_pages=14, local_pool_pages=8)
    _assert_same(ref, _run(eng, reqs))
    assert eng.growth_stats()["parks"] > 0
    assert eng.pop_rejected() == []
    assert eng.cloud_lane.pager_s.local_alloc.num_pages == 8
    assert eng.cloud_lane.pager_l.alloc.num_pages == 14

