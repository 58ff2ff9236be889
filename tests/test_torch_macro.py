"""The port's K-token macro step (``BatchedHybridEngine(macro_k=K)``) vs
the JAX package's and vs the port's own per-token path, on the reduced
2b pair, float32 on the CPU, from the same (bridged) parameters, under
jittery weather and a mix of private and cloud rows.  Mirrors
``tests/test_macro_step.py``.

* At ``macro_k=3`` the port equals the reference's ``macro_k=3``:
  texts, ``private``, token, cloud and fallback counts and
  ``latency_ms`` exactly, fusion weights within 1e-5 (the Eq. 14 MLP's
  f32 dot products, reduced in another order, as in
  ``test_torch_batched.py``).  Budgets are not multiples of 3, so final
  macros are ragged.
* Within the port, ``macro_k`` 1, 3 and 8 equal ``macro_k=0``: K = 1
  bit for bit (its admission groups are the per-token path's), K = 3
  and 8 under the same limits as above; also at K = 8 with per-user
  adapters (decode LoRA through K5 and through K4 slot ids) and with a
  router-gated expert bank.
* The dispatch discipline: one trace fetch per non-idle lane per macro,
  and on the CPU the body runs exactly K times per dispatch; the lane's
  tensors keep their addresses across macros (the port's stand-in for
  the reference's donation); the host position mirror equals the
  device's after a collect, rows admitted between dispatch and collect
  included."""
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
from repro_torch.core import lora as LORA
from repro_torch.core.router import ExpertMeta, Router, expert_embedding
from repro_torch.models.model import LM
from repro_torch.serving.deployment import ServingDeployment
from repro_torch.serving.engine import BatchedHybridEngine
from repro_torch.serving.latency import LatencyModel
from repro_torch.serving.macro import LaneMacro
from repro_torch.serving.scheduler import ContinuousBatchScheduler
from _threads import one_thread  # noqa: F401

W_TOL = 1e-5
MAX_SEQ = 48
PROMPTS = [
    "math: compute 12 plus 7 =",
    "my ssn is 123-45-6789, fill the benefits form",       # private
    "translate to french: water ->",
    "my doctor said my blood pressure is 140 over 90",     # private
    "sort ascending: 40 12 77 31 ->",
    "explain how rainbows form",
    "list three colors",
]
BUDGETS = [5, 7, 4, 10, 11, 2, 8]
AID_OF = ["u0", None, "u1", "u2", "u0", None, "u1"]
DOMAINS = {"math": ["compute 2 plus 2", "what is 3 times 9"],
           "lang": ["translate water", "say hello in french"],
           "sort": ["sort ascending: 3 1 2", "order these numbers"],
           "science": ["explain how rain forms", "why is the sky blue"]}
# jittery weather so rows mix arrived and fallback tokens per step
JITTER = dict(rtt_ms=160, jitter_ms=40.0, cloud_compute_ms=20, seed=7)
LANES = dict(batch_size=4, edge_batch_size=2)


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


def _dep(pair, **kw):
    slm, tsp, llm, tlp, tmlp = pair[1]
    return ServingDeployment(slm, tsp, llm, tlp, tmlp,
                             latency=LatencyModel(**JITTER),
                             max_seq=MAX_SEQ, device="cpu", **kw)


def _adapters(slm, names, scale=2.0, seed=100):
    """Port adapters with random B (``init_adapter`` zeroes B)."""
    out = []
    for j, _ in enumerate(names):
        ad = LORA.init_adapter(slm, seed + j, rank=2, device="cpu")
        gen = torch.Generator().manual_seed(seed + 500 + j)
        for leaf in ad["layers"].values():
            leaf["B"] = scale * torch.randn(leaf["B"].shape, generator=gen)
        out.append(ad)
    return out


def _serve(pair, macro_k, lora=None, use_slot_kernel=False):
    """The seven requests through the port's scheduler: plain, with
    per-user adapters ("adapters") or with a router-gated bank
    ("router")."""
    slm = pair[1][0]
    kw, aids = {}, [None] * len(PROMPTS)
    if lora == "adapters":
        dep = _dep(pair, adapter_slots=3)
        aids = AID_OF
    elif lora == "router":
        dep = _dep(pair, expert_bank=LORA.stack_adapters(
            _adapters(slm, range(4), seed=200)))
        kw["router"] = Router([ExpertMeta(n, expert_embedding(s), i)
                               for i, (n, s) in enumerate(
                                   sorted(DOMAINS.items()))])
    else:
        dep = _dep(pair)
    eng = BatchedHybridEngine(deployment=dep, macro_k=macro_k,
                              use_slot_kernel=use_slot_kernel, **LANES,
                              **kw)
    if lora == "adapters":
        for name, ad in zip(("u0", "u1", "u2"), _adapters(slm, range(3))):
            eng.adapters.register(name, ad)
    sched = ContinuousBatchScheduler(eng)
    for p, n, aid in zip(PROMPTS, BUDGETS, aids):
        sched.submit(p, n, adapter_id=aid)
    res = sched.run()
    assert eng.resident_kv_bytes() == 0
    assert eng.adapter_stats().get("pinned", 0) == 0
    return res


def _same(ra, rb, exact=False):
    assert [r.rid for r in rb] == [r.rid for r in ra]
    for a, b in zip(ra, rb):
        assert b.text == a.text, (a.rid, a.text, b.text)
        assert b.error is None and a.error is None
        assert b.stats.private == a.stats.private
        assert b.stats.tokens == a.stats.tokens
        assert b.stats.cloud_tokens == a.stats.cloud_tokens
        assert b.stats.fallback_tokens == a.stats.fallback_tokens
        assert b.stats.cloud_calls == a.stats.cloud_calls
        assert b.stats.latency_ms == a.stats.latency_ms
        if exact:
            assert b.stats.fusion_w == a.stats.fusion_w
        else:
            np.testing.assert_allclose(b.stats.fusion_w, a.stats.fusion_w,
                                       rtol=0, atol=W_TOL)


@pytest.fixture(scope="module")
def per_token(pair):
    return {lora: _serve(pair, 0, lora)
            for lora in (None, "adapters", "router")}


def test_macro_matches_reference(pair, per_token):
    """macro_k=3 on both sides, ragged final macros, one reference run
    (its scan's compile is the slow part)."""
    jslm, sp, jllm, lp, mlp = pair[0]
    jeng = JBatched(deployment=JDep(jslm, sp, jllm, lp, mlp,
                                    latency=JLat(**JITTER),
                                    max_seq=MAX_SEQ),
                    paged=True, macro_k=3, **LANES)
    jsched = JCBS(jeng)
    for p, n in zip(PROMPTS, BUDGETS):
        jsched.submit(p, n)
    jres = jsched.run()
    tres = _serve(pair, 3)
    _same(jres, tres)
    assert sum(r.stats.private for r in tres) == 2
    assert any(0 < r.stats.fallback_tokens < r.stats.tokens for r in tres)
    _same(per_token[None], tres)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_macro_equals_per_token_path(pair, per_token, k):
    _same(per_token[None], _serve(pair, k), exact=k == 1)


@pytest.mark.parametrize("lora,use_slot_kernel", [("adapters", False),
                                                  ("adapters", True),
                                                  ("router", False)])
def test_macro_with_lora_equals_per_token_path(pair, per_token, lora,
                                               use_slot_kernel):
    _same(per_token[lora], _serve(pair, 8, lora, use_slot_kernel))


def test_default_engine_is_the_macro_step(pair):
    eng = BatchedHybridEngine(deployment=_dep(pair))
    assert eng.macro_k == 8
    with pytest.raises(ValueError, match="macro_k"):
        BatchedHybridEngine(deployment=_dep(pair), macro_k=-1)


def test_dispatch_discipline(pair, monkeypatch):
    """Four cloud rows and two private rows, 8 tokens each, K = 4: two
    macros, each one trace fetch per lane and K body iterations per
    dispatch, and no per-token step; the per-token path's entry points
    run only inside the body."""
    k, n_tok = 4, 8
    eng = BatchedHybridEngine(deployment=_dep(pair), macro_k=k, **LANES)
    counts = dict(fetch=0, body=0, step=0)

    def count(name, fn):
        def run(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return run
    monkeypatch.setattr(eng.dep, "fetch_traces",
                        count("fetch", eng.dep.fetch_traces))
    monkeypatch.setattr(LaneMacro, "body", count("body", LaneMacro.body))
    for lane in (eng.cloud_lane, eng.edge_lane):
        monkeypatch.setattr(lane, "step", count("step", lane.step))
    cloud = [p for p in PROMPTS if not eng.detector.detect(p)][:4]
    private = [p for p in PROMPTS if eng.detector.detect(p)]
    assert eng.add_requests([(p, n_tok, True, i) for i, p in
                             enumerate(cloud + private)]) == [True] * 6
    macros = 0
    while eng.active_count():
        eng.step()
        macros += 1
    assert macros == n_tok // k == 2
    assert counts == dict(fetch=2 * macros, body=2 * k * macros, step=0)
    # an idle lane neither dispatches nor fetches
    assert eng.add_requests([(cloud[0], 3, True, 9)]) == [True]
    eng.step()
    assert counts["fetch"] == 2 * macros + 1
    assert counts["body"] == 2 * k * macros + k
    # one macro step per lane for its life, keyed on K: no other K
    assert eng.cloud_lane.macro(k) is eng.cloud_lane._macro
    with pytest.raises(ValueError, match="macro step was built"):
        eng.cloud_lane.macro(k + 1)
    assert eng.active_count() == 0


def _lane_tensors(eng):
    out = {}
    for name, lane in (("cloud", eng.cloud_lane), ("edge", eng.edge_lane)):
        for attr in ("sl", "ll", "gates"):
            t = getattr(lane, attr)
            if t is not None:
                out[f"{name}.{attr}"] = t
        for which, c in (("s", lane.s_cache), ("l", lane.l_cache)):
            for leaf in ("k", "v", "pos", "block"):
                if c is not None:
                    out[f"{name}.{which}.{leaf}"] = c[leaf]
        if lane._macro is not None:
            for attr in ("ok", "steps", "max_new", "done", "traces"):
                out[f"{name}.macro.{attr}"] = getattr(lane._macro, attr)
    return {key: t.data_ptr() for key, t in out.items()}


def test_lane_tensors_keep_their_addresses(pair):
    """Every update of a macro step is in place: the caches, positions,
    pending logits, gate rows and the step's static buffers keep their
    storage across macros and admissions (on the card, the graph reads
    and writes these addresses)."""
    eng = BatchedHybridEngine(deployment=_dep(pair, adapter_slots=3),
                              macro_k=3, **LANES)
    for name, ad in zip(("u0", "u1", "u2"), _adapters(eng.dep.slm,
                                                      range(3))):
        eng.adapters.register(name, ad)
    reqs = [(p, n, True, i, None, None, a)
            for i, (p, n, a) in enumerate(zip(PROMPTS, BUDGETS, AID_OF))]
    flags = eng.add_requests(reqs)
    eng.step()
    first = _lane_tensors(eng)
    assert len(first) == 27
    while eng.active_count() or not all(flags):
        eng.dispatch_step()
        rest = [r for r, f in zip(reqs, flags) if not f]
        for j, ok in zip([i for i, f in enumerate(flags) if not f],
                         eng.add_requests(rest)):
            flags[j] = ok
        eng.collect_step()
        assert _lane_tensors(eng) == first


def test_host_positions_follow_the_device(pair):
    """After every collect the host mirror of each lane cache equals the
    device positions, including rows admitted while a macro step was in
    flight (those start decoding at the next dispatch)."""
    eng = BatchedHybridEngine(deployment=_dep(pair), macro_k=3, batch_size=4,
                              edge_batch_size=3)
    eng.add_requests([(PROMPTS[0], 5, True, 0), (PROMPTS[1], 4, True, 1)])
    admitted_in_flight = 0
    for i in range(8):
        eng.dispatch_step()
        if i < 3:
            flags = eng.add_requests([(PROMPTS[2 + i], 6, True, 10 + i)])
            admitted_in_flight += flags[0]
        eng.collect_step()
        for lane in (eng.cloud_lane, eng.edge_lane):
            for c in (lane.s_cache, lane.l_cache):
                if c is not None:
                    np.testing.assert_array_equal(c["pos_host"],
                                                  c["pos"].numpy())
    assert admitted_in_flight == 3
    assert eng.active_count() == 0
