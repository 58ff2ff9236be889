"""The port's LoRA serving vs the JAX package's, on the reduced 2b pair,
float32 on the CPU, from the same (bridged) parameters and adapters.

* ``AdapterCache`` against the reference under one seeded random
  register/acquire/release sequence; ``Router`` gates equal.
* The model with a bank: prefill + 16 greedy decode steps under one-hot,
  soft and slot gates, logits within the model tolerance (1e-4, as
  ``test_torch_model.py``) and greedy tokens equal.
* ``HybridEngine`` with a router, and the batched engine serving mixed
  per-user adapters (``use_slot_kernel`` False and True) against the
  reference's engines: texts, cloud/fallback counts and ``latency_ms``
  equal, fusion weights within 1e-5; the batched texts also equal the
  port's own sequential (solo) serving.
* Oversubscription (4 users over 2 slots) with the reference's
  ``adapter_stats()``, hard rejects of unknown adapters, the two
  construction errors, and adapters that do change tokens.

Adapters get random B (``init_adapter`` zeroes B, which would make every
delta 0 and the parity vacuous)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fusion as JFUS
from repro.core import lora as JLORA
from repro.core.router import ExpertMeta as JMeta
from repro.core.router import Router as JRouter
from repro.core.router import expert_embedding as jexpert_embedding
from repro.serving.adapters import AdapterCache as JCache
from repro.serving.deployment import ServingDeployment as JDep
from repro.serving.engine import BatchedHybridEngine as JBatched
from repro.serving.engine import HybridEngine as JEngine
from repro.serving.latency import LatencyModel as JLat
from repro.serving.scheduler import ContinuousBatchScheduler as JCBS
from repro_torch import bridge
from repro_torch.core import lora as LORA
from repro_torch.core.router import ExpertMeta, Router, expert_embedding
from repro_torch.models.model import LM
from repro_torch.serving.adapters import AdapterCache, UnknownAdapter
from repro_torch.serving.deployment import ServingDeployment
from repro_torch.serving.engine import BatchedHybridEngine, HybridEngine
from repro_torch.serving.scheduler import (ContinuousBatchScheduler,
                                           ResponseStatus, Scheduler)
from repro_torch.serving.latency import LatencyModel
from _threads import one_thread  # noqa: F401

W_TOL = 1e-5
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MAX_SEQ = 48
JITTER = dict(rtt_ms=160, jitter_ms=40.0, cloud_compute_ms=20, seed=7)
PROMPTS = [
    "math: compute 12 plus 7 =",
    "my ssn is 123-45-6789, fill the benefits form",       # private
    "translate to french: water ->",
    "sort ascending: 40 12 77 31 ->",
    "explain how rainbows form",
    "list three colors",
]
BUDGETS = [6, 5, 7, 4, 6, 5]
# users and adapter-free rows mixed in one lane batch
AID_OF = ["u0", None, "u1", "u2", "u0", None]
DOMAINS = {"math": ["compute 2 plus 2", "what is 3 times 9",
                    "math: add 5 and 6"],
           "lang": ["translate water", "say hello in french",
                    "translate to german: cat"],
           "sort": ["sort ascending: 3 1 2", "order these numbers"],
           "science": ["explain how rain forms", "why is the sky blue"]}


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


def _adapters(jslm, names, scale=0.5, seed=100):
    """{name: numpy adapter tree}: reference A, random B."""
    out = {}
    for j, name in enumerate(names):
        ad = jax.device_get(JLORA.init_adapter(
            jslm, jax.random.key(seed + j), rank=2))
        rng = np.random.default_rng(seed + 500 + j)
        for leaf in ad["layers"].values():
            leaf["B"] = (scale * rng.standard_normal(leaf["B"].shape)
                         ).astype(np.float32)
        out[name] = ad
    return out


def _register(jeng, teng, adapters):
    for name, ad in adapters.items():
        if jeng is not None:
            jeng.adapters.register(name, jax.tree.map(jnp.asarray, ad))
        if teng is not None:
            teng.adapters.register(name, bridge.from_numpy(ad))


def _deps(pair, lat=JITTER, **kw):
    (jslm, sp, jllm, lp, mlp), (slm, tsp, llm, tlp, tmlp) = pair
    jkw, tkw = dict(kw), dict(kw)
    if "expert_bank" in kw:
        jkw["expert_bank"] = jax.tree.map(jnp.asarray, kw["expert_bank"])
        tkw["expert_bank"] = bridge.from_numpy(kw["expert_bank"])
    jdep = JDep(jslm, sp, jllm, lp, mlp, latency=JLat(**lat),
                max_seq=MAX_SEQ, **jkw)
    tdep = ServingDeployment(slm, tsp, llm, tlp, tmlp,
                             latency=LatencyModel(**lat), max_seq=MAX_SEQ,
                             device="cpu", **tkw)
    return jdep, tdep


def _same_stats(a, b):
    assert b.private == a.private
    assert b.tokens == a.tokens
    assert b.cloud_tokens == a.cloud_tokens
    assert b.fallback_tokens == a.fallback_tokens
    assert b.cloud_calls == a.cloud_calls
    assert b.latency_ms == a.latency_ms
    np.testing.assert_allclose(b.fusion_w, a.fusion_w, rtol=0, atol=W_TOL)


def _router(cls_router, cls_meta, embed):
    metas = [cls_meta(n, embed(s), i)
             for i, (n, s) in enumerate(sorted(DOMAINS.items()))]
    return cls_router(metas)


# -------------------------------------------------------- host-side pieces
def test_adapter_cache_matches_reference_on_a_random_trace():
    rng = np.random.default_rng(0)
    jc, tc = JCache(3), AdapterCache(3)
    ids = [f"a{i}" for i in range(6)]
    for aid in ids[:4]:
        jc.register(aid, aid)
        tc.register(aid, aid)
    pins = []
    for _ in range(400):
        op = rng.integers(0, 10)
        if op < 5:
            aid = ids[rng.integers(0, len(ids))]
            if not jc.known(aid):
                with pytest.raises(UnknownAdapter):
                    tc.acquire(aid)
                continue
            js, ts = jc.acquire(aid), tc.acquire(aid)
            assert js == ts
            if ts is not None:
                pins.append(ts)
        elif op < 9 and pins:
            slot = pins.pop(rng.integers(0, len(pins)))
            jc.release(slot)
            tc.release(slot)
        else:
            aid = ids[rng.integers(0, len(ids))]
            slot = jc.slot_of(aid)
            if slot is None or jc.refs[slot] == 0:   # replace when unpinned
                jc.register(aid, aid + "'")
                tc.register(aid, aid + "'")
        assert tc.adapter_in == jc.adapter_in and tc.refs == jc.refs
        assert tc.stats() == jc.stats()
    st = tc.stats()
    assert st["evictions"] > 0 and st["refusals"] > 0 and st["hits"] > 0


def test_router_matches_reference():
    jr = _router(JRouter, JMeta, jexpert_embedding)
    tr = _router(Router, ExpertMeta, expert_embedding)
    for p in PROMPTS + ["compute 40 plus 2", "why do leaves change"]:
        np.testing.assert_array_equal(tr.gate_weights(p),
                                      jr.gate_weights(p))
        assert tr.top1(p).name == jr.top1(p).name
    np.testing.assert_array_equal(tr.gate_weights_batch(PROMPTS),
                                  jr.gate_weights_batch(PROMPTS))
    for r, meta in ((jr, JMeta), (tr, ExpertMeta)):
        r.add_expert(meta("extra", r.experts[1].embedding, 0))
        r.remove_expert("lang")
    np.testing.assert_array_equal(tr.gate_weights(PROMPTS[0]),
                                  jr.gate_weights(PROMPTS[0]))


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("kind", ["one_hot", "soft", "slots"])
def test_model_with_bank_matches_reference(pair, kind):
    """Prefill of two prompts (one-hot or soft (B, E) gate rows), then 16
    greedy decode steps with the same gates, or with (B,) integer slots
    (K4 on the port, the Pallas slot kernel in interpret mode on the
    reference)."""
    (jslm, sp, *_), (slm, tsp, *_) = pair
    ads = _adapters(jslm, ["a", "b", "c"])
    jbank = JLORA.stack_adapters([jax.tree.map(jnp.asarray, a)
                                  for a in ads.values()])
    bank = bridge.from_numpy(jax.device_get(jbank))
    jl, tl = JLORA.bank_for_model(jbank), LORA.bank_for_model(bank)
    rng = np.random.default_rng(3)
    g = (rng.random((2, 3)).astype(np.float32) if kind == "soft"
         else JLORA.slot_gates([2, 0], 3))
    dg = np.asarray([2, -1], np.int32) if kind == "slots" else g
    prompt = rng.integers(3, 259, (2, 11))
    jlogits, jcache = jslm.prefill(sp, {"tokens": jnp.asarray(
        prompt, jnp.int32)}, MAX_SEQ, lora=jl, gates=jnp.asarray(g))
    logits, cache = slm.prefill(tsp, torch.from_numpy(prompt), MAX_SEQ,
                                tl, torch.from_numpy(g))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    jstep = jax.jit(jslm.decode_step)
    for _ in range(16):
        jt = np.asarray(jnp.argmax(jlogits[:, -1], -1))
        tt = torch.argmax(logits[:, -1], -1).numpy()
        np.testing.assert_array_equal(tt, jt)
        jlogits, jcache = jstep(sp, jcache, jnp.asarray(jt[:, None],
                                                        jnp.int32),
                                jl, jnp.asarray(dg))
        logits, cache = slm.decode_step(tsp, cache,
                                        torch.from_numpy(tt[:, None]),
                                        tl, torch.from_numpy(dg))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **LOGIT_TOL)


# ------------------------------------------------------------ engines
def test_router_gated_sequential_engine_matches_reference(pair):
    ads = _adapters(pair[0][0], ["e0", "e1", "e2", "e3"], scale=2.0)
    bank = jax.device_get(JLORA.stack_adapters(
        [jax.tree.map(jnp.asarray, a) for a in ads.values()]))
    jdep, tdep = _deps(pair, expert_bank=bank)
    jeng = JEngine(deployment=jdep,
                   router=_router(JRouter, JMeta, jexpert_embedding))
    teng = HybridEngine(deployment=tdep, router=_router(Router, ExpertMeta,
                                             expert_embedding))
    plain = HybridEngine(deployment=_deps(pair)[1])
    moved = 0
    for i, (p, n) in enumerate(zip(PROMPTS, BUDGETS)):
        jtext, jst = jeng.generate(p, n, rid=i)
        ttext, tst = teng.generate(p, n, rid=i)
        assert ttext == jtext
        _same_stats(jst, tst)
        moved += int(ttext != plain.generate(p, n, rid=i)[0])
    assert moved > 0                  # the experts do steer the tokens


@pytest.mark.parametrize("use_slot_kernel", [False, True])
def test_mixed_adapter_batch_matches_reference_and_solo(pair,
                                                        use_slot_kernel):
    adapters = _adapters(pair[0][0], ["u0", "u1", "u2"], scale=2.0)
    jdep, tdep = _deps(pair, adapter_slots=3)
    kw = dict(batch_size=4, edge_batch_size=2, macro_k=0)
    jeng = JBatched(deployment=jdep, paged=True,
                    use_slot_kernel=use_slot_kernel, **kw)
    teng = BatchedHybridEngine(deployment=tdep,
                               use_slot_kernel=use_slot_kernel, **kw)
    _register(jeng, teng, adapters)
    jsched, tsched = JCBS(jeng), ContinuousBatchScheduler(teng)
    for p, n, aid in zip(PROMPTS, BUDGETS, AID_OF):
        jsched.submit(p, n, adapter_id=aid)
        tsched.submit(p, n, adapter_id=aid)
    jres, tres = jsched.run(), tsched.run()
    assert [r.rid for r in tres] == [r.rid for r in jres]
    for a, b in zip(jres, tres):
        assert b.text == a.text and b.status.value == a.status.value
        _same_stats(a.stats, b.stats)
    assert teng.adapter_stats() == jeng.adapter_stats()
    assert teng.adapter_stats()["pinned"] == 0
    solo = HybridEngine(deployment=tdep)
    _register(None, solo, adapters)
    plain = HybridEngine(deployment=_deps(pair)[1])
    moved = 0
    for r, p, n, aid in zip(tres, PROMPTS, BUDGETS, AID_OF):
        text, st = solo.generate(p, n, rid=r.rid, adapter_id=aid)
        assert text == r.text and st.latency_ms == r.stats.latency_ms
        moved += int(text != plain.generate(p, n, rid=r.rid)[0])
    assert solo.adapter_stats()["pinned"] == 0
    assert moved > 0                  # the adapters do steer the tokens


def test_oversubscribed_adapters_match_reference_stats(pair):
    """4 users over 2 slots: evictions and soft refusals, every request
    served, the same texts and ``adapter_stats()`` as the reference."""
    adapters = _adapters(pair[0][0], ["u0", "u1", "u2", "u3"])
    jdep, tdep = _deps(pair, adapter_slots=2)
    kw = dict(batch_size=4, edge_batch_size=1, macro_k=0)
    jeng = JBatched(deployment=jdep, paged=True, **kw)
    teng = BatchedHybridEngine(deployment=tdep, **kw)
    _register(jeng, teng, adapters)
    jsched, tsched = JCBS(jeng), ContinuousBatchScheduler(teng)
    for i in range(8):
        for s in (jsched, tsched):
            s.submit(PROMPTS[i % 3 * 2], 5, adapter_id=f"u{i % 4}")
    jres, tres = jsched.run(), tsched.run()
    assert [r.text for r in tres] == [r.text for r in jres]
    assert all(r.error is None and r.stats.tokens > 0 for r in tres)
    st = teng.adapter_stats()
    assert st == jeng.adapter_stats()
    assert st["evictions"] >= 1 and st["refusals"] >= 1
    assert st["pinned"] == 0 and st["resident"] <= 2


def test_unknown_adapter_is_a_hard_reject(pair):
    _, tdep = _deps(pair, adapter_slots=2)
    adapters = _adapters(pair[0][0], ["u0"])
    eng = BatchedHybridEngine(deployment=tdep, batch_size=2, macro_k=0)
    _register(None, eng, adapters)
    sched = ContinuousBatchScheduler(eng)
    good = sched.submit(PROMPTS[0], 4, adapter_id="u0")
    bad = sched.submit(PROMPTS[2], 4, adapter_id="ghost")
    res = {r.rid: r for r in sched.run()}
    assert res[good].status is ResponseStatus.OK
    assert res[good].stats.tokens > 0
    assert res[bad].status is ResponseStatus.REJECTED
    assert "ghost" in res[bad].error
    seq = Scheduler.from_deployment(tdep)
    _register(None, seq.engine, adapters)
    seq.submit(PROMPTS[0], 4, adapter_id="nope")
    (r,) = seq.run()
    assert r.status is ResponseStatus.REJECTED and "nope" in r.error
    with pytest.raises(UnknownAdapter):
        seq.engine.generate(PROMPTS[0], 4, adapter_id="nope")
    plain = HybridEngine(deployment=_deps(pair)[1])
    with pytest.raises(ValueError, match="adapter_slots"):
        plain.generate(PROMPTS[0], 4, adapter_id="u0")


def test_construction_errors(pair):
    ads = _adapters(pair[0][0], ["e0"])
    bank = jax.device_get(JLORA.stack_adapters(
        [jax.tree.map(jnp.asarray, a) for a in ads.values()]))
    _, tdep = _deps(pair, expert_bank=bank)
    with pytest.raises(ValueError, match="nothing gates it"):
        HybridEngine(deployment=tdep)
    with pytest.raises(ValueError, match="nothing gates it"):
        BatchedHybridEngine(deployment=tdep, macro_k=0)
    _, both = _deps(pair, expert_bank=bank, adapter_slots=2)
    router = _router(Router, ExpertMeta, expert_embedding)
    with pytest.raises(ValueError, match="mutually exclusive"):
        HybridEngine(deployment=both, router=router)


def test_adapters_change_tokens_and_empty_slots_do_not(pair):
    """A non-zero adapter steers greedy decoding away from the
    adapter-free stream for some prompt; an adapter-free request on an
    adapter engine (all-zero gate rows) is exactly the plain engine."""
    _, tdep = _deps(pair, adapter_slots=2)
    solo = HybridEngine(deployment=tdep)
    _register(None, solo, _adapters(pair[0][0], ["u0"], scale=2.0))
    plain = HybridEngine(deployment=_deps(pair)[1])
    diff = 0
    for i, p in enumerate(PROMPTS):
        with_ad = solo.generate(p, 6, rid=i, adapter_id="u0")[0]
        without, st = solo.generate(p, 6, rid=i)
        ref, ref_st = plain.generate(p, 6, rid=i)
        assert without == ref and st.fusion_w == ref_st.fusion_w
        diff += int(with_ad != without)
    assert diff > 0


def test_serve_adapter_demo_prints_the_reference_lines(capsys):
    """``serve --local --device cpu --batch 4 --macro-k 0 --adapters 3
    --adapter-slots 2`` prints the reference launcher's per-request
    stats lines (queue waits aside) and its ``adapter cache:`` line."""
    import os
    import re
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.launch import serve

    argv = ["--local", "--batch", "4", "--macro-k", "0", "--adapters", "3",
            "--adapter-slots", "2"]
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "-m", "repro.launch.serve", *argv],
                         env=env, capture_output=True, text=True,
                         timeout=600, check=True).stdout
    serve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out

    def lines(out):
        keep = [ln for ln in out.splitlines()
                if ln.startswith(("[", "adapter", "lane KV"))]
        return [re.sub(r" wait=\d+ms", "", ln) for ln in keep]
    assert lines(got) == lines(ref)
    assert any(ln.startswith("adapter cache:") for ln in lines(got))
    with pytest.raises(SystemExit):
        serve.main(["--local", "--adapters", "3", "--device", "cpu"])
