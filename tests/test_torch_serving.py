"""The port's sequential serving path vs the JAX package's on the
reduced 2b pair, from the same (bridged) parameters, float32 on the CPU.

Texts, cloud and fallback counts and per-token latencies must be equal;
fusion weights agree within 1e-5 (the Eq. 14 MLP's 1024-long f32 dot
product, reduced in another order).  Mirrors the sequential cases of
``tests/test_serving.py``: private prompt, catastrophic RTT, good
network, scheduler summary."""
import jax
import numpy as np
import pytest
import torch

from repro.core import fusion as JFUS
from repro.serving.deployment import ServingDeployment as JDep
from repro.serving.engine import HybridEngine as JEngine
from repro.serving.latency import LatencyModel as JLat
from repro.serving.scheduler import Scheduler as JScheduler
from repro.serving.scheduler import summarize as jsummarize
from repro_torch import bridge
from repro_torch.models.model import LM
from repro_torch.serving.deployment import ServingDeployment
from repro_torch.serving.engine import HybridEngine
from repro_torch.serving.latency import LatencyModel
from repro_torch.serving.scheduler import Scheduler, summarize
from _threads import one_thread  # noqa: F401

W_TOL = 1e-5
MAX_SEQ = 48


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


def _engines(pair, **lat):
    (jslm, sp, jllm, lp, mlp), (slm, tsp, llm, tlp, tmlp) = pair
    jeng = JEngine(deployment=JDep(
        jslm, sp, jllm, lp, mlp, latency=JLat(**lat) if lat else None,
        max_seq=MAX_SEQ))
    teng = HybridEngine(deployment=ServingDeployment(
        slm, tsp, llm, tlp, tmlp, latency=LatencyModel(**lat) if lat else None,
        max_seq=MAX_SEQ, device="cpu"))
    return jeng, teng


def _same(jstats, tstats):
    assert tstats.private == jstats.private
    assert tstats.tokens == jstats.tokens
    assert tstats.cloud_tokens == jstats.cloud_tokens
    assert tstats.fallback_tokens == jstats.fallback_tokens
    assert tstats.cloud_calls == jstats.cloud_calls
    assert tstats.truncated == jstats.truncated
    assert tstats.latency_ms == jstats.latency_ms
    np.testing.assert_allclose(tstats.fusion_w, jstats.fusion_w, rtol=0,
                               atol=W_TOL)


def test_private_prompt_never_uses_cloud(pair):
    jeng, teng = _engines(pair)
    prompt = "my ssn is 123-45-6789 please file it"
    jtext, jst = jeng.generate(prompt, max_new_tokens=3)
    text, st = teng.generate(prompt, max_new_tokens=3)
    assert st.private and st.cloud_tokens == 0
    assert text == jtext
    _same(jst, st)


def test_fallback_under_catastrophic_rtt(pair):
    jeng, teng = _engines(pair, rtt_ms=1000, jitter_ms=0)
    prompt = "what is the capital of france"
    jtext, jst = jeng.generate(prompt, max_new_tokens=4, rid=0)
    text, st = teng.generate(prompt, max_new_tokens=4, rid=0)
    assert st.fallback_tokens == st.tokens
    assert all(w == 1.0 for w in st.fusion_w)
    assert max(st.latency_ms) <= 200.0
    assert text == jtext
    _same(jst, st)


def test_good_network_uses_cloud(pair):
    jeng, teng = _engines(pair, rtt_ms=10, jitter_ms=0)
    prompt = "translate to french: water ->"
    jtext, jst = jeng.generate(prompt, max_new_tokens=4)
    text, st = teng.generate(prompt, max_new_tokens=4)
    assert st.cloud_tokens == st.tokens
    assert max(st.latency_ms) <= 66.0
    assert text == jtext
    _same(jst, st)


def test_scheduler_matches_reference(pair):
    """Jittered weather keyed by rid: the four demo prompts of the
    serving launcher plus a prompt long enough to be truncated."""
    jeng, teng = _engines(pair)
    prompts = ["math: compute 12 plus 7 =",
               "my ssn is 123-45-6789, fill the benefits form",
               "translate to french: water ->",
               "my doctor said my blood pressure is 140 over 90",
               "explain how rainbows form " * 3]
    jsched, tsched = JScheduler(jeng), Scheduler(teng)
    for p in prompts:
        jsched.submit(p, 8)
        tsched.submit(p, 8)
    jres, tres = jsched.run(), tsched.run()
    assert [r.rid for r in tres] == [r.rid for r in jres] == [0, 1, 2, 3, 4]
    for jr, tr in zip(jres, tres):
        assert tr.text == jr.text
        assert tr.status.value == jr.status.value
        _same(jr.stats, tr.stats)
    assert tres[4].truncated
    js, ts = jsummarize(jres), summarize(tres)
    assert sorted(ts) == sorted(js)
    for k in ("requests", "private_frac", "cloud_token_frac",
              "fallback_token_frac", "mean_token_latency_ms",
              "p95_token_latency_ms", "cloud_calls_per_token", "cancelled"):
        assert ts[k] == js[k], k
    assert 0.0 < ts["private_frac"] < 1.0


def test_deadline_cancels_like_reference(pair):
    """The simulated-clock deadline cuts the request at the same token."""
    jeng, teng = _engines(pair)
    prompt = "translate to french: water ->"
    jtext, jst = jeng.generate(prompt, max_new_tokens=8, rid=3,
                               deadline_ms=200.0)
    text, st = teng.generate(prompt, max_new_tokens=8, rid=3,
                             deadline_ms=200.0)
    assert st.cancelled and jst.cancelled and st.tokens < 8
    assert text == jtext
    _same(jst, st)


# ------------------------------------------------- the engines' keyword form


class _AllPrivate:
    """A detector that holds every prompt on the device."""

    @staticmethod
    def detect(prompt):
        return True


def test_keyword_form_equals_deployment_form(pair):
    """The reference's keyword form builds the deployment the engine
    would otherwise be given: the same greedy and sampled tokens, stats
    and sampling seed, for all three engines."""
    from repro_torch.serving.engine import BatchedHybridEngine, SoloEngine
    _, (slm, tsp, llm, tlp, tmlp) = pair
    kw = dict(latency=LatencyModel(rtt_ms=160, jitter_ms=40.0, seed=7),
              max_seq=MAX_SEQ, sample_seed=5)
    by_kw = HybridEngine(slm, tsp, llm, tlp, tmlp, device="cpu", **kw)
    by_dep = HybridEngine(deployment=ServingDeployment(
        slm, tsp, llm, tlp, tmlp, device="cpu", **kw))
    assert by_kw.sample_seed == by_kw.dep.sample_seed == 5
    assert by_kw.dep.device == torch.device("cpu")
    for greedy in (True, False):
        a = by_kw.generate("translate to french: water ->", 6,
                           greedy=greedy, rid=3)
        b = by_dep.generate("translate to french: water ->", 6,
                            greedy=greedy, rid=3)
        assert a[0] == b[0]
        _same(a[1], b[1])
    batched = [BatchedHybridEngine(slm, tsp, llm, tlp, tmlp, batch_size=2,
                                   macro_k=0, device="cpu", **kw),
               BatchedHybridEngine(deployment=by_dep.dep, batch_size=2,
                                   macro_k=0)]
    outs = []
    for eng in batched:
        assert eng.add_requests([("list three colors", 5, False, 0, 9),
                                 ("explain rain", 5, True, 1)]) == [True] * 2
        done = []
        while eng.active_count():
            done += eng.step()
        outs.append(sorted((rid, text, st.tokens) for rid, text, st in done))
    assert outs[0] == outs[1]
    solo = [SoloEngine(slm, tsp, max_seq=MAX_SEQ, device="cpu"),
            SoloEngine(deployment=ServingDeployment(slm, tsp,
                                                    max_seq=MAX_SEQ,
                                                    device="cpu"))]
    assert len({s.generate("list three colors", 5) for s in solo}) == 1


@pytest.mark.parametrize("clash", [
    dict(max_seq=48), dict(timeout_ms=100.0), dict(sample_seed=1),
    dict(latency="lat"), dict(slm="slm", llm_params="lp"),
    dict(alignment_mlp="mlp", expert_bank="bank")])
def test_reject_deployment_args(pair, clash):
    """Deployment-level arguments beside ``deployment=`` raise, naming
    them, as the reference's ``_reject_deployment_args`` does (the
    reference's cases; the port's ``device=`` too)."""
    from repro.serving.engine import BatchedHybridEngine as JBatched
    from repro.serving.engine import SoloEngine as JSolo
    from repro_torch.serving.engine import BatchedHybridEngine, SoloEngine
    jeng, teng = _engines(pair)
    args = {k: (JLat() if v == "lat" else v) for k, v in clash.items()}
    targs = {k: (LatencyModel() if v == "lat" else v)
             for k, v in clash.items()}
    for jcls, tcls in ((JEngine, HybridEngine),
                       (JBatched, BatchedHybridEngine)):
        with pytest.raises(ValueError) as jerr:
            jcls(deployment=jeng.dep, **args)
        with pytest.raises(ValueError) as terr:
            tcls(deployment=teng.dep, **targs)
        assert str(terr.value) == str(jerr.value)
        with pytest.raises(ValueError, match=r"\['device'\]"):
            tcls(deployment=teng.dep, device="cpu")
    solo = {k: v for k, v in targs.items() if k == "max_seq"}
    if solo:
        with pytest.raises(ValueError) as jerr:
            JSolo(deployment=jeng.dep, **solo)
        with pytest.raises(ValueError) as terr:
            SoloEngine(deployment=teng.dep, **solo)
        assert str(terr.value) == str(jerr.value)


def test_detector_is_honoured(pair):
    """``detector=`` replaces the privacy detector: a detector that holds
    every prompt private keeps each request off the cloud, in the
    sequential and the batched engine."""
    from repro_torch.serving.engine import BatchedHybridEngine
    _, teng = _engines(pair)
    prompt = "translate to french: water ->"
    assert not teng.detector.detect(prompt)
    eng = HybridEngine(deployment=teng.dep, detector=_AllPrivate())
    _, st = eng.generate(prompt, 4, rid=0)
    assert st.private and st.cloud_tokens == 0 and st.cloud_calls == 0
    bat = BatchedHybridEngine(deployment=teng.dep, detector=_AllPrivate(),
                              batch_size=2, macro_k=0)
    assert bat.add_requests([(prompt, 4, True, 0)]) == [True]
    assert bat.edge_lane.active == 1 and bat.cloud_lane.active == 0
    while bat.active_count():
        for _, _, st in bat.step():
            assert st.private and st.cloud_tokens == 0
