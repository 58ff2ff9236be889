"""Serving the gemma3 pair (floe-slm-gemma3 + floe-llm-7b) with the
port vs the JAX package, float32 on the CPU, from the same (bridged)
parameters.  The SLM is the reduced floe-slm-gemma3 at ``num_layers=5``
(two groups of a local and a global layer and a tail of one local
layer; window 16) with ring caches, as ``serve --pair gemma3`` builds
it; the paged admission also runs at ``.reduced()`` (one group, no
tail).

* The paged admission scatter: the reference's dense packed prefill,
  ``_pad_cache(lengths=)`` ring placement and page-row scatter against
  the port's streaming ``page_writer`` — full-length pools, ring-local
  pools, block and local tables and positions — at a padded width past
  the window (rows on both sides of it) and within it; then 24 paged
  decode steps past the window with one parked row, against the
  reference's paged ``decode_step``: live rows' logits (1e-4, as
  ``test_torch_model.py``) every step and the pools at the end.
* The engines: the sequential ``HybridEngine`` (through ``Scheduler``)
  and ``BatchedHybridEngine`` at ``macro_k`` 0, 3 and 8 against the
  reference's engines — texts, private, token, cloud and fallback counts
  and ``latency_ms`` equal, fusion weights within 1e-5 (as
  ``test_torch_batched.py``) — and the batched texts equal the port's
  sequential engine; lazy growth with fixed local rings against eager
  reservation; a mixed-adapter batch against the reference; the macro
  step's lane tensors (pools, both tables) keep their addresses.
Prompts run past the window at admission and budgets of 20 tokens wrap
every ring while decoding."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import fusion as JFUS
from repro.core import lora as JLORA
from repro.models.model import LM as JLM
from repro.serving.deployment import ServingDeployment as JDep
from repro.serving.engine import BatchedHybridEngine as JBatched
from repro.serving.engine import HybridEngine as JEngine
from repro.serving.latency import LatencyModel as JLat
from repro.serving.scheduler import ContinuousBatchScheduler as JCBS
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch import bridge
from repro_torch.models.attention import FREED_POS
from repro_torch.models.model import LM
from repro_torch.serving import paging as PAG
from repro_torch.serving.deployment import ServingDeployment
from repro_torch.serving.engine import BatchedHybridEngine, HybridEngine
from repro_torch.serving.latency import LatencyModel
from repro_torch.serving.scheduler import (ContinuousBatchScheduler,
                                           Scheduler)
from _threads import one_thread  # noqa: F401

W_TOL = 1e-5
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MAX_SEQ = 96
KINDS = ("inner", "tail", "global")
JITTER = dict(rtt_ms=160, jitter_ms=40.0, cloud_compute_ms=20, seed=7)
PROMPTS = [
    "math: compute 12 plus 7 =",
    "my ssn is 123-45-6789, fill the benefits form",       # private
    "translate to french: water ->",
    "explain how rainbows form when sunlight passes through rain",
    "my doctor said my blood pressure is 140 over 90",     # private
    "sort ascending: 40 12 77 31 ->",
    "list three colors",
]
BUDGETS = [20, 12, 20, 9, 20, 14, 5]
LANES = dict(batch_size=4, edge_batch_size=2)


def _slm_cfg(layers=5):
    cfg = get_config("floe-slm-gemma3").reduced()
    return cfg if layers == 2 else dataclasses.replace(cfg,
                                                       num_layers=layers)


def _port(jparams):
    return bridge.from_numpy(jax.device_get(jparams))


@pytest.fixture(scope="module")
def pair(llm):
    jllm, lp = llm
    scfg = _slm_cfg()
    jslm = JLM(scfg, remat=False, ring_cache=True)
    sp = jax.jit(jslm.init)(jax.random.key(0))
    mlp = JFUS.init_alignment(jax.random.key(2), scfg.vocab_size)
    port = (LM(scfg, device="cpu", ring_cache=True), _port(sp),
            LM(jllm.cfg, device="cpu"), _port(lp), _port(mlp))
    return (jslm, sp, jllm, lp, mlp), port


def _deps(pair, lat=JITTER, **kw):
    (jslm, sp, jllm, lp, mlp), (slm, tsp, llm, tlp, tmlp) = pair
    return (JDep(jslm, sp, jllm, lp, mlp, latency=JLat(**lat),
                 max_seq=MAX_SEQ, **kw),
            ServingDeployment(slm, tsp, llm, tlp, tmlp,
                              latency=LatencyModel(**lat), max_seq=MAX_SEQ,
                              device="cpu", **kw))


def _same(jr, tr):
    assert [r.rid for r in tr] == [r.rid for r in jr]
    for a, b in zip(jr, tr):
        assert b.text == a.text, (a.rid, a.text, b.text)
        for f in ("private", "tokens", "cloud_tokens", "fallback_tokens",
                  "cloud_calls", "truncated", "latency_ms"):
            assert getattr(b.stats, f) == getattr(a.stats, f), (a.rid, f)
        np.testing.assert_allclose(b.stats.fusion_w, a.stats.fusion_w,
                                   rtol=0, atol=W_TOL)


def _submit(sched, prompts=PROMPTS, budgets=BUDGETS, aids=None):
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        sched.submit(p, n, adapter_id=aids[i] if aids else None)
    return sched.run()


# ------------------------------------------------------------ paged lanes
def _admission(layers, lengths, lpad, seed=5):
    """One paged admission of ``lengths`` (+ a pad row) into lane slots
    3, 0, 2 of a four-row lane on both sides: (reference deployment,
    its lane cache, port deployment, its lane cache, the models)."""
    scfg = _slm_cfg(layers)
    jslm = JLM(scfg, remat=False, ring_cache=True)
    sp = jax.jit(jslm.init)(jax.random.key(seed))
    slm = LM(scfg, device="cpu", ring_cache=True)
    jdep = JDep(jslm, sp, max_seq=MAX_SEQ)
    dep = ServingDeployment(slm, _port(sp), max_seq=MAX_SEQ, device="cpu")
    geo = dep.paged_geometry(slm)
    assert (geo["local_len"], geo["nl"]) == (16, 1)
    n = len(lengths)
    lens = np.ones(4, np.int32)
    lens[:n] = lengths
    rng = np.random.default_rng(seed)
    toks = np.zeros((4, lpad), np.int64)
    for i, m in enumerate(lengths):
        toks[i, :m] = rng.integers(3, 259, m)
    pages, local_pages, nb = 24, 6, MAX_SEQ // 16
    tables = np.full((n, nb), PAG.NO_PAGE, np.int32)
    free = list(range(pages))
    for i, m in enumerate(lengths):
        for j in range(PAG.pages_for(m, 16) + 1):
            tables[i, j] = free.pop(0)
    local = np.asarray([[5], [1], [3]], np.int32)[:n]
    src, dst = list(range(n)), [3, 0, 2][:n]
    _, jcache = jdep.slm_prefill_packed(sp, jnp.asarray(toks, jnp.int32),
                                        jnp.asarray(lens), None, None)
    jfull = jdep.insert_slm_paged(
        jdep.init_paged_lane_cache(jslm, 4, pages, local_pages),
        jdep.slm_page_rows(jcache), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(tables), jnp.asarray(local), jnp.asarray(tables),
        jnp.asarray(local))
    cache = dep.init_paged_lane_cache(slm, 4, pages, local_pages)
    dep.slm_prefill_packed(dep.slm_params, torch.from_numpy(toks), lens,
                           dep.page_writer(cache, src, tables, lens, local,
                                           geo["local_len"]))
    dep.finish_paged_insert(cache, dst, lengths, tables, local)
    return jdep, jfull, dep, cache, (jslm, sp, slm)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree.copy()


def _pools_equal(cache, jfull, tol):
    for kind in KINDS:
        for n in "kv":
            ref = np.asarray(jfull[kind][n])
            got = cache[kind][n].numpy()
            assert got.shape[-4] == ref.shape[-4] + 1      # the sink page
            np.testing.assert_allclose(got[..., :-1, :, :, :], ref, **tol)


WRAP = (5, [20, 9, 33], 48)


@pytest.fixture(scope="module")
def wrapped():
    """The admission whose padded width (48) wraps the ring, at depth 5."""
    return _admission(*WRAP)


@pytest.mark.parametrize("case", [WRAP, (2, [20, 9, 33], 48),
                                  (5, [5, 9, 14], 16)],
                         ids=["2groups+tail-wrap", "1group-wrap",
                              "2groups+tail-within"])
def test_paged_admission_scatter_matches_reference(case, wrapped):
    """Pools, tables and positions after the admission of a ragged burst
    whose padded width wraps the 16-slot ring (rows shorter and longer
    than the window) or fits in it; the row never admitted stays parked
    (the reference starts it at 0; its output is never read)."""
    _, jfull, _, cache, _ = wrapped if case == WRAP else _admission(*case)
    _pools_equal(cache, jfull, dict(rtol=1e-5, atol=1e-5))
    for table in ("block", "local"):
        np.testing.assert_array_equal(cache[table].numpy(),
                                      np.asarray(jfull[table]))
    want = np.asarray(jfull["pos"]).copy()
    want[1] = FREED_POS
    np.testing.assert_array_equal(cache["pos"].numpy(), want)
    np.testing.assert_array_equal(cache["pos_host"], want)


def test_paged_decode_24_steps_past_the_window(wrapped):
    """After the wrapping admission, 24 paged decode steps on forced ids
    (every ring wraps at least once more): the live rows' logits every
    step, the positions, and every live page of both pools at the end,
    against the reference's paged ``decode_step``."""
    _, jfull, dep, cache, (jslm, sp, slm) = wrapped
    cache = _clone(cache)           # the fixture's stays as admitted
    # the pad-free lanes: rows 3, 0, 2 live, row 1 parked on both sides
    jfull = dict(jfull, pos=jfull["pos"].at[1].set(FREED_POS))
    live = [3, 0, 2]
    rng = np.random.default_rng(11)
    jstep = jax.jit(jslm.decode_step)
    for _ in range(24):
        ids = rng.integers(3, 259, (4, 1))
        jlogits, jfull = jstep(sp, jfull, jnp.asarray(ids, jnp.int32))
        logits, cache = slm.decode_step(dep.slm_params, cache,
                                        torch.from_numpy(ids))
        np.testing.assert_allclose(logits.numpy()[live],
                                   np.asarray(jlogits)[live], **LOGIT_TOL)
    np.testing.assert_array_equal(cache["pos"].numpy()[live],
                                  np.asarray(jfull["pos"])[live])
    assert cache["pos_host"][1] == FREED_POS
    # pages 18-23 of the full pool and page 0, 2, 4 of the local pool
    # were never mapped: their content is garbage on both sides
    mapped = np.unique(cache["block"].numpy()[live])
    mapped = mapped[mapped < 24]
    for kind in KINDS:
        for n in "kv":
            ref, got = np.asarray(jfull[kind][n]), cache[kind][n].numpy()
            pids = mapped if kind == "global" else np.asarray([5, 1, 3])
            np.testing.assert_allclose(got[..., pids, :, :, :],
                                       ref[..., pids, :, :, :], **LOGIT_TOL)


# ---------------------------------------------------------------- engines
@pytest.fixture(scope="module")
def reference(pair):
    """The reference's runs of the traffic, built once: sequential, and
    batched on paged lanes at macro_k 0 and 3 (lazy pages)."""
    jdep, _ = _deps(pair)
    # five requests: a jitted prefill compiles per prompt length
    out = {"seq": _submit(JScheduler(JEngine(deployment=jdep)),
                          PROMPTS[:5], BUDGETS[:5])}
    for k in (0, 3):
        out[k] = _submit(JCBS(JBatched(deployment=jdep, paged=True,
                                       macro_k=k, **LANES)))
    return out


def test_sequential_engine_matches_reference(pair, reference):
    _, dep = _deps(pair)
    res = _submit(Scheduler(HybridEngine(deployment=dep)), PROMPTS[:5],
                  BUDGETS[:5])
    _same(reference["seq"], res)
    assert sum(r.stats.private for r in res) == 2
    assert any(0 < r.stats.fallback_tokens < r.stats.tokens for r in res)


@pytest.mark.parametrize("k", [0, 3, 8])
def test_batched_engine_matches_reference(pair, reference, k):
    """macro_k 0 and 3 against the reference's same K; 8 against its
    per-token run (the reference holds its macro step to that run bit
    for bit); the per-token run's requests equal the port's sequential
    engine (text and latency charges)."""
    _, dep = _deps(pair)
    sched = ContinuousBatchScheduler.from_deployment(dep, macro_k=k,
                                                     **LANES)
    res = _submit(sched)
    _same(reference[k if k in reference else 0], res)
    if k == 0:               # and so, through the reference, every K
        seq = HybridEngine(deployment=dep)
        for r, p, n in zip(res, PROMPTS, BUDGETS):
            text, st = seq.generate(p, n, rid=r.rid)
            assert text == r.text and st.latency_ms == r.stats.latency_ms
    eng = sched.engine
    assert eng.growth_stats()["grown_pages"] > 0
    assert eng.resident_kv_bytes() == 0
    assert eng.cloud_lane.pager_s.nl == 1 and eng.cloud_lane.pager_l.nl == 0
    assert eng.edge_lane.pager_s.local_alloc.live_pages == 0


def test_lazy_growth_with_fixed_local_rings(pair):
    """Lazy reservation (prompt pages + 1, grown at page boundaries)
    equals eager worst-case reservation token for token; rings are
    reserved whole at admission and never grow: while rows decode, the
    local pool holds exactly one ring per occupied row while the block
    tables grow."""
    _, dep = _deps(pair)
    eager = _submit(ContinuousBatchScheduler.from_deployment(
        dep, macro_k=0, lazy_pages=False, **LANES))
    eng = BatchedHybridEngine(deployment=dep, macro_k=0, **LANES)
    flags = eng.add_requests([(p, n, True, i) for i, (p, n) in
                              enumerate(zip(PROMPTS, BUDGETS))])
    assert sum(flags) == 6
    while eng.active_count():
        eng.step()
        for ln in (eng.cloud_lane, eng.edge_lane):
            rows = [r for r in ln.pager_s.rows if r is not None]
            assert ln.pager_s.local_alloc.live_pages == len(rows)
            assert all(len(r.local) == 1 for r in rows)
    assert eng.growth_stats()["grown_pages"] > 0
    lazy = _submit(ContinuousBatchScheduler.from_deployment(
        dep, macro_k=0, **LANES))
    _same(eager, lazy)


def test_full_length_window_leaves_match_rings(pair, reference):
    """An SLM built without ring caches keeps full-length local leaves
    paged from the block table, masked to the window per row: the same
    requests as on rings (the reference's per-token run)."""
    (jslm, sp, jllm, lp, mlp), (slm, tsp, llm, tlp, tmlp) = pair
    flat = LM(slm.cfg, device="cpu")
    dep = ServingDeployment(flat, tsp, llm, tlp, tmlp,
                            latency=LatencyModel(**JITTER), max_seq=MAX_SEQ,
                            device="cpu")
    assert dep.paged_geometry(flat)["nl"] == 0
    sched = ContinuousBatchScheduler.from_deployment(dep, macro_k=0, **LANES)
    _same(reference[0], _submit(sched))
    assert "local" not in sched.engine.cloud_lane.s_cache


def _adapters(jslm, names, scale=0.5, seed=100):
    """{name: numpy adapter tree}: reference A, random B on every stack
    (inner, tail and the global layers' "special")."""
    out = {}
    for j, name in enumerate(names):
        ad = jax.device_get(JLORA.init_adapter(
            jslm, jax.random.key(seed + j), rank=2))
        rng = np.random.default_rng(seed + 500 + j)
        for stack in ("inner", "tail", "special"):
            for leaf in ad[stack].values():
                leaf["B"] = (scale * rng.standard_normal(leaf["B"].shape)
                             ).astype(np.float32)
        out[name] = ad
    return out


def test_mixed_adapter_batch_matches_reference(pair):
    """Per-user adapters and adapter-free rows in one lane batch on the
    grouped layout, two slots for three users (evictions), against the
    reference's batched engine; the adapters change tokens."""
    jdep, dep = _deps(pair, adapter_slots=2)
    aids = ["u0", None, "u1", "u2", "u0", None, "u1"]
    ads = _adapters(pair[0][0], ["u0", "u1", "u2"])
    jeng = JBatched(deployment=jdep, paged=True, macro_k=0, **LANES)
    sched = ContinuousBatchScheduler.from_deployment(dep, macro_k=0, **LANES)
    for name, ad in ads.items():
        jeng.adapters.register(name, jax.tree.map(jnp.asarray, ad))
        sched.engine.adapters.register(name, bridge.from_numpy(ad))
    jres = _submit(JCBS(jeng), aids=aids)
    res = _submit(sched, aids=aids)
    _same(jres, res)
    assert sched.engine.adapter_stats() == jeng.adapter_stats()
    _, plain = _deps(pair)
    base = _submit(ContinuousBatchScheduler.from_deployment(
        plain, macro_k=0, **LANES))
    assert any(a.text != b.text for a, b in zip(res, base))


def _tensors(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tensors(v, f"{prefix}.{k}"))
        return out
    return {prefix: tree.data_ptr()} if isinstance(tree, torch.Tensor) \
        else {}


def test_macro_lane_tensors_keep_their_addresses(pair):
    """The macro step's updates of a gemma3 lane are in place: every
    pool (full-length and ring-local), both tables and the positions
    keep their storage across macros and admissions (on the card, the
    graph reads and writes these addresses)."""
    _, dep = _deps(pair)
    eng = BatchedHybridEngine(deployment=dep, macro_k=3, **LANES)
    reqs = [(p, n, True, i) for i, (p, n) in
            enumerate(zip(PROMPTS, BUDGETS))]
    flags = eng.add_requests(reqs)
    eng.step()

    def addrs():
        return {**_tensors(eng.cloud_lane.s_cache, "cloud.s"),
                **_tensors(eng.cloud_lane.l_cache, "cloud.l"),
                **_tensors(eng.edge_lane.s_cache, "edge.s")}
    first = addrs()
    assert {"cloud.s.local", "cloud.s.block", "cloud.s.inner.k",
            "cloud.s.tail.v", "cloud.s.global.k", "edge.s.local"} \
        <= set(first)
    while eng.active_count() or not all(flags):
        eng.dispatch_step()
        rest = [r for r, f in zip(reqs, flags) if not f]
        for j, ok in zip([i for i, f in enumerate(flags) if not f],
                         eng.add_requests(rest)):
            flags[j] = ok
        eng.collect_step()
        assert addrs() == first
