"""The port's continuous-batching engine on paged lanes vs the JAX
package's ``BatchedHybridEngine(macro_k=0, paged=True)``, on the reduced
2b pair, float32 on the CPU, from the same (bridged) parameters.

Texts, cloud and fallback counts and per-token latencies must be equal;
fusion weights agree within 1e-5 (the Eq. 14 MLP's f32 dot products,
reduced in another order).  The greedy tokens must also equal the
port's own sequential engine.  Mirrors the batched cases of
``tests/test_serving.py`` (batched vs sequential, fallback regime,
private rows, refills, freed rows parked) and ``tests/test_paged.py``
(lazy vs worst case, growth across a page boundary, page-gated
refusals, a hard reject naming the model)."""
import jax
import numpy as np
import pytest
import torch

from repro.core import fusion as JFUS
from repro.serving.deployment import ServingDeployment as JDep
from repro.serving.engine import BatchedHybridEngine as JBatched
from repro.serving.latency import LatencyModel as JLat
from repro.serving.scheduler import ContinuousBatchScheduler as JCBS
from repro_torch import bridge
from repro_torch.data import tokenizer as TOK
from repro_torch.models.attention import FREED_POS
from repro_torch.models.model import LM
from repro_torch.serving import paging as PAG
from repro_torch.serving.deployment import ServingDeployment
from repro_torch.serving.engine import BatchedHybridEngine, HybridEngine
from repro_torch.serving.latency import FaultModel, LatencyModel
from repro_torch.serving.scheduler import (ContinuousBatchScheduler,
                                           ResponseStatus)
from _threads import one_thread  # noqa: F401

W_TOL = 1e-5
MAX_SEQ = 96
PROMPTS = [
    "math: compute 12 plus 7 =",
    "my ssn is 123-45-6789, fill the benefits form",       # private
    "translate to french: water ->",
    "sort ascending: 40 12 77 31 ->",
    "my doctor said my blood pressure is 140 over 90",     # private
    "explain how rainbows form when sunlight passes through rain",
    "list three colors",
]
BUDGETS = [12, 6, 20, 5, 9, 14, 3]
JITTER = dict(rtt_ms=160, jitter_ms=40.0, cloud_compute_ms=20, seed=7)


@pytest.fixture(scope="module")
def pair(slm, llm):
    (jslm, sp), (jllm, lp) = slm, llm
    mlp = JFUS.init_alignment(jax.random.key(2), jslm.cfg.vocab_size)
    port = (LM(jslm.cfg, device="cpu"),
            bridge.from_numpy(jax.device_get(sp)),
            LM(jllm.cfg, device="cpu"),
            bridge.from_numpy(jax.device_get(lp)),
            bridge.from_numpy(jax.device_get(mlp)))
    return (jslm, sp, jllm, lp, mlp), port


def _dep(pair, lat, max_seq=MAX_SEQ):
    slm, tsp, llm, tlp, tmlp = pair[1]
    return ServingDeployment(slm, tsp, llm, tlp, tmlp,
                             latency=LatencyModel(**lat), max_seq=max_seq,
                             device="cpu")


def _jdep(pair, lat, max_seq=MAX_SEQ):
    jslm, sp, jllm, lp, mlp = pair[0]
    return JDep(jslm, sp, jllm, lp, mlp, latency=JLat(**lat),
                max_seq=max_seq)


def _run(sched, prompts=PROMPTS, budgets=BUDGETS):
    for p, n in zip(prompts, budgets):
        sched.submit(p, n)
    return sched.run()


def _same(jr, tr, fusion=True):
    assert [r.rid for r in tr] == [r.rid for r in jr]
    for a, b in zip(jr, tr):
        assert b.text == a.text, (a.rid, a.text, b.text)
        assert b.status.value == a.status.value
        assert b.stats.private == a.stats.private
        assert b.stats.tokens == a.stats.tokens
        assert b.stats.cloud_tokens == a.stats.cloud_tokens
        assert b.stats.fallback_tokens == a.stats.fallback_tokens
        assert b.stats.cloud_calls == a.stats.cloud_calls
        assert b.stats.truncated == a.stats.truncated
        assert b.stats.latency_ms == a.stats.latency_ms
        if fusion:
            np.testing.assert_allclose(b.stats.fusion_w, a.stats.fusion_w,
                                       rtol=0, atol=W_TOL)


@pytest.mark.parametrize("batch,lazy", [(4, True), (4, False), (3, True),
                                        (3, False)])
def test_scheduler_matches_reference(pair, batch, lazy):
    """Seven requests, two private, under jittery weather (rows fall back
    at different steps), over four or three cloud rows (refills), with
    lazy or eager pages: the same stats as the reference, and the same
    greedy tokens as the port's sequential engine."""
    kw = dict(batch_size=batch, edge_batch_size=2, macro_k=0,
              lazy_pages=lazy)
    jres = _run(JCBS(JBatched(deployment=_jdep(pair, JITTER), paged=True,
                              **kw)))
    sched = ContinuousBatchScheduler.from_deployment(_dep(pair, JITTER),
                                                     **kw)
    tres = _run(sched)
    _same(jres, tres)
    assert sum(r.stats.private for r in tres) == 2
    assert any(0 < r.stats.fallback_tokens < r.stats.tokens for r in tres)
    seq = HybridEngine(deployment=_dep(pair, JITTER))
    for r, p, n in zip(tres, PROMPTS, BUDGETS):
        text, st = seq.generate(p, n, rid=r.rid)
        assert text == r.text and st.latency_ms == r.stats.latency_ms
    st = sched.engine.growth_stats()
    assert (st["grown_pages"] > 0) == lazy
    assert sched.engine.resident_kv_bytes() == 0


def test_fallback_regime_and_private_rows(pair):
    """Catastrophic RTT: every cloud row falls back (w = 1) each step,
    private rows never touch the cloud, as in the reference."""
    lat = dict(rtt_ms=1000, jitter_ms=0)
    kw = dict(batch_size=3, edge_batch_size=2, macro_k=0)
    jres = _run(JCBS(JBatched(deployment=_jdep(pair, lat), paged=True,
                              **kw)), budgets=[4] * len(PROMPTS))
    tres = _run(ContinuousBatchScheduler.from_deployment(_dep(pair, lat),
                                                         **kw),
                budgets=[4] * len(PROMPTS))
    _same(jres, tres)
    for r in tres:
        if r.stats.private:
            assert r.stats.cloud_tokens == 0 and r.stats.cloud_calls == 0
        else:
            assert r.stats.fallback_tokens == r.stats.tokens
            assert all(w == 1.0 for w in r.stats.fusion_w)


def test_refills_freed_slots(pair):
    """More requests than slots: the lane drains the queue by admitting
    into freed rows."""
    sched = ContinuousBatchScheduler.from_deployment(
        _dep(pair, dict(rtt_ms=10, jitter_ms=0)), batch_size=2,
        edge_batch_size=1, macro_k=0)
    for i in range(5):
        sched.submit(f"count to {i} please", 3)
    res = sched.run()
    assert [r.rid for r in res] == list(range(5))
    assert all(r.stats.tokens == 3 for r in res)
    seqs = sorted(r.stats.admit_seq for r in res)
    assert seqs == list(range(5))


def test_freed_rows_parked_not_written(pair):
    """A drained row's pages return to the free list, its device row is
    parked (pos = FREED_POS, table NO_PAGE) and its old pages are not
    written while the surviving row decodes; re-admission into the
    recycled pages gives the fresh-admit text."""
    eng = BatchedHybridEngine(
        deployment=_dep(pair, dict(rtt_ms=10, jitter_ms=0)), batch_size=2,
        edge_batch_size=1, macro_k=0)
    p2 = "sort ascending: 40 12 77 31 ->"
    assert eng.add_request(p2, 4, True, 2)
    ref = {}
    while eng.active_count():
        for rid, text, _ in eng.step():
            ref[rid] = text
    lane = eng.cloud_lane
    assert lane.pager_s.alloc.live_pages == 0
    assert eng.add_request("translate to french: water ->", 2, True, 0)
    assert eng.add_request("explain how rainbows form", 10, True, 1)
    slot = next(i for i, s in enumerate(lane.slots) if s and s.rid == 0)
    old_pages = lane.pager_s.rows[slot].full
    done = []
    while not any(d[0] == 0 for d in done):
        done += eng.step()
    assert lane.pager_s.rows[slot] is None
    assert lane.pager_l.rows[slot] is None
    for cache in (lane.s_cache, lane.l_cache):
        assert int(cache["pos"][slot]) == FREED_POS
        assert cache["pos_host"][slot] == FREED_POS
        assert bool((cache["block"][slot] == PAG.NO_PAGE).all())
    snap = lane.s_cache["k"][:, old_pages].clone()
    for _ in range(3):                                  # rid 1 decodes on
        eng.step()
    assert torch.equal(lane.s_cache["k"][:, old_pages], snap)
    while eng.active_count():
        eng.step()
    assert lane.pager_s.alloc.live_pages == 0
    assert eng.add_request(p2, 4, True, 2)
    got = {}
    while eng.active_count():
        for rid, text, _ in eng.step():
            got[rid] = text
    assert got == ref


def test_lazy_growth_crosses_boundary(pair):
    """Rows engineered to decode across a page boundary: growth fires
    mid-decode and the streams equal the eager reservation's."""
    prompt = "sum 1 and 2"
    n = len(TOK.encode(prompt + " "))
    assert PAG.pages_for(n, 16) + 1 < PAG.pages_for(min(n + 20, 48), 16)
    lat = dict(rtt_ms=10, jitter_ms=0)
    runs = {}
    for lazy in (False, True):
        sched = ContinuousBatchScheduler.from_deployment(
            _dep(pair, lat, max_seq=48), batch_size=4, macro_k=0,
            lazy_pages=lazy)
        runs[lazy] = (_run(sched, [prompt, prompt + " no"], [20, 20]),
                      sched.engine.growth_stats())
    _same(runs[False][0], runs[True][0])
    st = runs[True][1]
    assert st["grown_pages"] > 0
    assert st["parks"] == st["evictions"] == st["forced"] == 0
    assert runs[False][1]["grown_pages"] == 0


def test_page_gated_admission_refusals(pair):
    """A demand beyond the free list is a soft refusal (admitted once
    pages free up, with the fresh-admit text); a demand beyond the total
    pool is a hard reject, surfaced once and never retried; resident
    bytes follow the rows — all as the reference decides."""
    lat = dict(rtt_ms=10, jitter_ms=0)
    jeng = JBatched(deployment=_jdep(pair, lat, 48), batch_size=3,
                    macro_k=0, paged=True, pool_pages=2)
    eng = BatchedHybridEngine(deployment=_dep(pair, lat, 48), batch_size=3,
                              macro_k=0, pool_pages=2)
    geo = eng.dep.paged_geometry(eng.slm)["page_bytes_full"] + \
        eng.dep.paged_geometry(eng.llm)["page_bytes_full"]
    a, c, big = "list three colors", "hi", "what time is it now"
    for e in (jeng, eng):
        assert e.add_request(c, 2, True, 7)
        ref = {}
        while e.active_count():
            for rid, text, _ in e.step():
                ref[rid] = text
        assert e.add_request(a, 2, True, 0)
        assert not e.add_request(c, 2, True, 7)          # soft
        assert e.pop_rejected() == []
        assert not e.add_request(big, 40, True, 9)       # hard
        (rid, reason), = e.pop_rejected()
        assert rid == 9 and "exceeds pool capacity 2 pages" in reason
        if e is eng:
            assert eng.resident_kv_bytes() == 2 * geo
        while e.active_count():
            e.step()
        assert e.resident_kv_bytes() == 0
        assert e.add_request(c, 2, True, 7)
        got = {}
        while e.active_count():
            for rid, text, _ in e.step():
                got[rid] = text
        assert got == ref
    sched = ContinuousBatchScheduler(eng)
    sched.submit(big, 40)
    res = sched.run()
    assert len(res) == 1 and res[0].status is ResponseStatus.REJECTED
    assert res[0].text == "" and res[0].stats.tokens == 0


def test_hard_reject_names_offending_model(pair):
    """The hard-reject reason names the model whose pool overflowed,
    with the reference's wording."""
    lat = dict(rtt_ms=10, jitter_ms=0)
    for kw, want in ((dict(pool_pages=2, llm_pool_pages=64), "slm"),
                     (dict(llm_pool_pages=2), "llm")):
        jeng = JBatched(deployment=_jdep(pair, lat, 48), batch_size=3,
                        macro_k=0, paged=True, **kw)
        eng = BatchedHybridEngine(deployment=_dep(pair, lat, 48),
                                  batch_size=3, macro_k=0, **kw)
        reasons = []
        for e in (jeng, eng):
            assert not e.add_request("what time is it now", 40, True, 11)
            (rid, reason), = e.pop_rejected()
            assert rid == 11
            reasons.append(reason)
        assert reasons[0] == reasons[1]
        assert reasons[1].startswith(f"{want} page demand 3")


def test_unported_options_raise(pair):
    dep = _dep(pair, dict(rtt_ms=10, jitter_ms=0))
    # the macro step is ported: the default (macro_k=8) and macro_k=4
    # construct and serve
    for kw in (dict(), dict(macro_k=4)):
        sched = ContinuousBatchScheduler.from_deployment(dep, batch_size=2,
                                                         **kw)
        res = _run(sched, PROMPTS[:3], BUDGETS[:3])
        assert [r.stats.tokens for r in res] == BUDGETS[:3]
        assert sched.engine.resident_kv_bytes() == 0
    # dense lanes and pool budgets are ported: they construct
    for kw in (dict(macro_k=0, paged=False), dict(macro_k=0, pool_pages=4),
               dict(macro_k=0, llm_pool_pages=4),
               dict(macro_k=0, local_pool_pages=4)):
        BatchedHybridEngine(deployment=dep, **kw)
    # speculative decode is ported: spec_k constructs on paged and dense
    # lanes; a negative one raises
    for kw in (dict(macro_k=0, spec_k=2),
               dict(macro_k=0, paged=False, spec_k=2)):
        assert BatchedHybridEngine(deployment=dep, **kw).spec_k == 2
    with pytest.raises(ValueError, match="spec_k"):
        BatchedHybridEngine(deployment=dep, macro_k=0, spec_k=-1)
    # chunked prefill is ported: a page-aligned chunk_width constructs
    BatchedHybridEngine(deployment=dep, macro_k=0, chunk_width=48)
    eng = BatchedHybridEngine(deployment=dep, batch_size=2, macro_k=0)
    # deadlines are ported: a request with one is admitted, and its
    # first token (65 ms on the simulated clock) passes the 50 ms
    done = []
    assert eng.add_requests([("hi", 2, True, 0, None, None, None,
                              50.0)]) == [True]
    while eng.active_count():
        done += eng.step()
    assert [(st.tokens, st.cancelled) for _, _, st in done] == [(1, True)]
    # COW prefix sharing is ported: a prefix= request is served (this
    # preamble is under one page, so it is prefilled unshared)
    assert eng.add_requests([("hi", 2, True, 0, None, "pre ")]) == [True]
    done = []
    while eng.active_count():
        done += eng.step()
    assert [st.tokens for _, _, st in done] == [2]
    assert eng.cloud_lane._prefixes == {"pre ": None}
    # per-user adapters are ported: on an engine without adapter slots
    # an adapter_id is a hard reject, as in the reference
    assert eng.add_requests([("hi", 2, True, 7, None, None, "user0")]) \
        == [False]
    (rid, why), = eng.pop_rejected()
    assert rid == 7 and "adapter_slots" in why
    assert eng.active_count() == 0
    # keyed sampling is ported: a sampled request is served
    assert eng.add_requests([("hi", 2, False, 0)]) == [True]
    done = []
    while eng.active_count():
        done += eng.step()
    assert [st.tokens for _, _, st in done] == [2]
    # max_ctx > max_seq is ported (chunked prefill): it constructs, its
    # block tables cover max_ctx; a max_ctx below max_seq raises
    wide = ServingDeployment(pair[1][0], pair[1][1], max_seq=48,
                             max_ctx=96, device="cpu")
    assert wide.paged_geometry(pair[1][0])["nb"] == 96 // 16
    with pytest.raises(ValueError, match="max_ctx"):
        ServingDeployment(pair[1][0], pair[1][1], max_seq=48, max_ctx=32,
                          device="cpu")
    # fault injection is ported: a fault model constructs, an all-zero
    # one is the fault-free path
    faulted = ServingDeployment(pair[1][0], pair[1][1],
                                fault=FaultModel(loss_rate=0.5),
                                device="cpu")
    assert faulted.fault is not None and faulted.fault_batched is not None
    clear = ServingDeployment(pair[1][0], pair[1][1], fault=FaultModel(),
                              device="cpu")
    assert clear.fault is None and clear.fault_batched is None
    # per-row decode against a dense cache is ported (dense lanes): a
    # live row past its rows still raises before any write
    slm, params = pair[1][0], pair[1][1]
    dense = dict(slm.init_cache(2, 48), pos=torch.tensor([3, 5],
                                                         dtype=torch.int32),
                 pos_host=np.array([3, 48]))
    with pytest.raises(ValueError, match="outside"):
        slm.decode_step(params, dense, torch.tensor([[4], [4]]))


@pytest.mark.parametrize("which", ["slm", "llm"])
def test_paged_admission_scatter_matches_reference(pair, which):
    """Paged admission of a ragged burst of three into lane slots 3, 0, 2
    of a four-row lane (lazy tables, NO_PAGE tails): the reference's
    dense packed prefill + page-row scatter and the port's streaming
    ``page_writer`` give the same pools, admitted positions and tables.
    The row never admitted stays parked (the reference starts it at 0;
    its output is never read)."""
    import jax.numpy as jnp
    lat = dict(rtt_ms=10, jitter_ms=0)
    jdep, dep = _jdep(pair, lat), _dep(pair, lat)
    jlm, lm = getattr(jdep, which), getattr(dep, which)
    jp, p = getattr(jdep, f"{which}_params"), getattr(dep, f"{which}_params")
    lengths = np.array([20, 9, 33, 1], np.int32)          # + a pad row
    rng = np.random.default_rng(5)
    toks = np.zeros((4, 48), np.int64)
    for i, n in enumerate(lengths[:3]):
        toks[i, :n] = rng.integers(3, 259, n)
    pages, nb = 24, MAX_SEQ // 16
    tables = np.full((3, nb), PAG.NO_PAGE, np.int32)
    free = list(range(pages))
    for i, n in enumerate(lengths[:3]):
        for j in range(PAG.pages_for(n, 16) + 1):
            tables[i, j] = free.pop(0)
    src, dst = [0, 1, 2], [3, 0, 2]
    jprefill = jdep.slm_prefill_packed if which == "slm" else \
        jdep.llm_prefill_packed
    args = (None, None) if which == "slm" else ()
    _, jcache = jprefill(jp, jnp.asarray(toks, jnp.int32),
                         jnp.asarray(lengths), *args)
    jrows = (jdep.slm_page_rows if which == "slm"
             else jdep.llm_page_rows)(jcache)
    jfull = jdep.init_paged_lane_cache(jlm, 4, pages, 0)
    jins = jdep.insert_slm_paged if which == "slm" else jdep.insert_llm_paged
    empty = jnp.zeros((3, 0), jnp.int32)
    jfull = jins(jfull, jrows, jnp.asarray(src), jnp.asarray(dst),
                 jnp.asarray(tables), empty, jnp.asarray(tables), empty)

    prefill = dep.slm_prefill_packed if which == "slm" else \
        dep.llm_prefill_packed
    cache = dep.init_paged_lane_cache(lm, 4, pages)
    prefill(p, torch.from_numpy(toks), lengths,
            dep.page_writer(cache, src, tables))
    dep.finish_paged_insert(cache, dst, lengths[:3], tables)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(cache[leaf][:, :pages].numpy(),
                                   np.asarray(jfull[leaf]),
                                   rtol=1e-5, atol=1e-5)
    want = np.asarray(jfull["pos"]).copy()
    np.testing.assert_array_equal(want[dst], lengths[:3])
    want[1] = FREED_POS
    np.testing.assert_array_equal(cache["pos"].numpy(), want)
    np.testing.assert_array_equal(cache["pos_host"], want)
    np.testing.assert_array_equal(cache["block"].numpy(),
                                  np.asarray(jfull["block"]))


def test_unused_rows_outlast_the_table(pair):
    """One request at a time through a four-row cloud lane whose other
    rows are never admitted, for more lane steps than the 96-slot table
    holds: the unused rows stay parked (no position creeps past the
    table), and every request gives the fresh-admit text."""
    sched = ContinuousBatchScheduler.from_deployment(
        _dep(pair, dict(rtt_ms=10, jitter_ms=0)), batch_size=4, macro_k=0)
    lane = sched.engine.cloud_lane
    texts, steps = set(), 0
    while steps <= 2 * MAX_SEQ:
        sched.submit("list three colors", 6)
        (r,) = sched.run()
        assert r.stats.tokens == 6 and not r.stats.private
        texts.add(r.text)
        steps += r.stats.tokens
        for cache in (lane.s_cache, lane.l_cache):
            np.testing.assert_array_equal(cache["pos_host"][1:], FREED_POS)
    assert len(texts) == 1
