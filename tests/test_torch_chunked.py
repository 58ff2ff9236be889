"""Chunked prefill up to ``max_ctx`` in the port, float32 on the CPU.

* The reference's ``test_chunked_matches_oneshot`` (2b and gemma3 with
  rings) and ``test_long_prompt_served`` in the port: ``chunk_width=16``
  streams every prompt chunk by chunk and gives the one-shot prefill's
  responses bit for bit at ``macro_k`` 0 and 4; a prompt past
  max_seq = 48 is served untruncated up to max_ctx = 96, equal at
  ``macro_k`` 0 and 4 and at chunk widths 48 and 16, and equal to the
  port's one-shot prefill on a max_seq = 96 deployment (the dense-lane
  oracle there); on a max_ctx = 48 deployment it is truncated and says
  so.
* The chunk schedule: chunk 0 is one B=1 ``build_prefix``, every middle
  chunk is exactly ``chunk_width`` tokens, B=1, and writes no ring; the
  final ragged chunk writes the row's ring, position and tables.
* The port's engine against the reference's on long-prompt traffic
  (also with a per-user adapter riding every chunk): texts, counts,
  latencies and admission numbers equal, fusion weights within 1e-5.
* An evicted chunked row resuming through chunked prefill, ids
  unchanged; ``chunk_width`` and ``max_ctx`` validation; the dense
  lane's cap stays max_seq while the paged one is max_ctx."""
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
JITTER = dict(rtt_ms=160, jitter_ms=40.0, cloud_compute_ms=20, seed=7)
W_TOL = 1e-5
PROMPTS = [
    "math: compute 12 plus 7 =",
    "my ssn is 123-45-6789, fill the benefits form",       # private
    "translate to french: water ->",
    "sort ascending: 40 12 77 31 ->",
    "explain how rainbows form",
    "list three colors",
]
# past max_seq = 48, inside max_ctx = 96 with a budget of 6: a private
# prompt (its digit run) and a cloud-eligible one
LONG = "sort these numbers ascending please: 40 12 77 31 55 63 98 2 ->"
CLOUD_LONG = "explain how rainbows form when sunlight passes through the rain"


def _bridge(tree):
    return bridge.from_numpy(jax.device_get(tree))


@pytest.fixture(scope="module")
def pairs(slm, llm):
    """{"2b", "gemma3"}: (reference parts, port parts), the gemma3 SLM
    with ring caches (window 16)."""
    (jslm, sp), (jllm, lp) = slm, llm
    mlp = JFUS.init_alignment(jax.random.key(2), jslm.cfg.vocab_size)
    jg = JLM(get_config("floe-slm-gemma3").reduced(), remat=False,
             ring_cache=True)
    gp = jg.init(jax.random.key(0))
    out = {}
    for name, (js, jsp) in (("2b", (jslm, sp)), ("gemma3", (jg, gp))):
        port = (LM(js.cfg, device="cpu", ring_cache=js.ring_cache),
                _bridge(jsp), LM(jllm.cfg, device="cpu"), _bridge(lp),
                _bridge(mlp))
        out[name] = ((js, jsp, jllm, lp, mlp), port)
    return out


def _dep(port, lat=LAT, max_seq=48, **kw):
    s, sp, l, lp, mlp = port
    return ServingDeployment(s, sp, l, lp, mlp, latency=LatencyModel(**lat),
                             max_seq=max_seq, device="cpu", **kw)


def _engine(dep, macro_k=4, **kw):
    kw.setdefault("batch_size", 4)
    kw.setdefault("edge_batch_size", 1)
    return BatchedHybridEngine(deployment=dep, macro_k=macro_k, **kw)


def _run(eng, prompts, n_tokens=5, sched=ContinuousBatchScheduler, **kw):
    s = sched(eng)
    for i, p in enumerate(prompts):
        s.submit(p, n_tokens, greedy=(i % 2 == 0), seed=i, **kw)
    return s.run()


def _exact(ref, got):
    assert [r.rid for r in got] == [r.rid for r in ref]
    for a, b in zip(ref, got):
        assert b.text == a.text, (a.rid, a.text, b.text)
        for f in ("private", "tokens", "cloud_tokens", "fallback_tokens",
                  "cloud_calls", "truncated", "latency_ms", "fusion_w"):
            assert getattr(b.stats, f) == getattr(a.stats, f), (a.rid, f)


def _close_to_reference(jres, tres):
    assert [r.rid for r in tres] == [r.rid for r in jres]
    for a, b in zip(jres, tres):
        assert b.text == a.text, (a.rid, a.text, b.text)
        for f in ("private", "tokens", "cloud_tokens", "fallback_tokens",
                  "cloud_calls", "truncated", "latency_ms", "admit_seq"):
            assert getattr(b.stats, f) == getattr(a.stats, f), (a.rid, f)
        np.testing.assert_allclose(b.stats.fusion_w, a.stats.fusion_w,
                                   rtol=0, atol=W_TOL)


@pytest.mark.parametrize("name,n_tokens", [("2b", 5), ("gemma3", 8)])
@pytest.mark.parametrize("macro_k", [0, 4])
def test_chunked_matches_oneshot(pairs, name, n_tokens, macro_k):
    """``chunk_width=16`` forces every prompt through the chunked path
    (1-2 middle chunks, gemma3's rings written by the final chunk
    only): bit for bit the one-shot prefill's responses."""
    dep = _dep(pairs[name][1])
    one = _run(_engine(dep, macro_k), PROMPTS, n_tokens)
    chunked = _engine(dep, macro_k, chunk_width=16)
    _exact(one, _run(chunked, PROMPTS, n_tokens))
    assert chunked.cloud_lane._prefixes == {}


@pytest.mark.parametrize("macro_k", [0, 4])
def test_long_prompt_served(pairs, macro_k):
    """A prompt longer than the dense row (max_seq 48) is served
    untruncated through chunked prefill when max_ctx = 96 covers it:
    equal at chunk widths 48 and 16 and, bit for bit, to the one-shot
    prefill of a max_seq = 96 deployment on its paged and its dense
    lanes.  On a max_ctx = 48 deployment the same prompt is truncated
    and says so."""
    port = pairs["2b"][1]
    n = len(TOK.encode(LONG + " "))
    assert 48 < n <= 96 - 6 - 1, n
    dep = _dep(port, max_ctx=96)
    kw = dict(batch_size=2, edge_batch_size=1)
    got = _run(_engine(dep, macro_k, **kw), [LONG], 6)
    assert not got[0].truncated and got[0].stats.tokens == 6
    _exact(got, _run(_engine(dep, macro_k, chunk_width=16, **kw), [LONG], 6))
    wide = _dep(port, max_seq=96)
    for paged in (True, False):
        _exact(got, _run(_engine(wide, macro_k, paged=paged, **kw), [LONG],
                         6))
    cut = _run(_engine(_dep(port), macro_k, **kw), [LONG], 6)
    assert cut[0].truncated


def test_chunk_schedule(pairs):
    """A 63-token cloud prompt at width 16 on gemma3: chunk 0 is one B=1
    ``build_prefix`` of 16 tokens per model, then exactly two middle
    chunks of 16 (B=1, unpadded) per model, which write no ring page,
    and a final chunk of 15 padded to 16 that writes the ring."""
    dep = _dep(pairs["gemma3"][1], max_ctx=96)
    calls = []
    for name in ("slm_build_prefix", "llm_build_prefix", "slm_prefill_chunk",
                 "llm_prefill_chunk", "slm_prefill_suffix",
                 "llm_prefill_suffix"):
        orig = getattr(dep, name)

        def spy(params, toks, *a, _name=name, _orig=orig, **k):
            calls.append((_name, tuple(toks.shape)))
            return _orig(params, toks, *a, **k)
        setattr(dep, name, spy)
    writers = []
    orig_writer = dep.page_writer

    def writer(full, src, dpf, lengths=None, dpl=None, *a, **k):
        writers.append(dpl is not None)
        return orig_writer(full, src, dpf, lengths, dpl, *a, **k)
    dep.page_writer = writer
    prompt = CLOUD_LONG[:61]
    assert len(TOK.encode(prompt + " ")) == 63
    eng = _engine(dep, 0, chunk_width=16, batch_size=2, edge_batch_size=1)
    assert eng.add_request(prompt, 4, True, 0)
    assert calls == [("slm_build_prefix", (1, 16)),
                     ("llm_build_prefix", (1, 16)),
                     ("slm_prefill_chunk", (1, 16)),
                     ("llm_prefill_chunk", (1, 16)),
                     ("slm_prefill_chunk", (1, 16)),
                     ("llm_prefill_chunk", (1, 16)),
                     ("slm_prefill_suffix", (1, 16)),
                     ("llm_prefill_suffix", (1, 16))]
    # middle chunks write no ring; the SLM's final chunk does (the LLM
    # has no ring leaves)
    assert writers == [False] * 4 + [True, False]
    lane = eng.cloud_lane
    assert lane.s_cache["pos_host"][0] == 63
    assert lane.pager_s.rows[0].shared == []


@pytest.mark.parametrize("macro_k", [0, 4])
def test_chunked_engine_matches_reference(pairs, macro_k):
    """The port's engine against the reference's at max_seq 48, max_ctx
    96 and chunk width 16 under jittery weather: long and short prompts,
    texts, counts, latencies and admission numbers equal, fusion weights
    within 1e-5."""
    (js, sp, jl, lp, mlp), port = pairs["2b"]
    kw = dict(batch_size=2, edge_batch_size=1, macro_k=macro_k,
              chunk_width=16)
    jeng = JBatched(deployment=JDep(js, sp, jl, lp, mlp,
                                    latency=JLat(**JITTER), max_seq=48,
                                    max_ctx=96), **kw)
    eng = BatchedHybridEngine(deployment=_dep(port, JITTER, max_ctx=96),
                              **kw)
    prompts = [LONG, PROMPTS[0], CLOUD_LONG, PROMPTS[1], LONG[:50]]
    _close_to_reference(_run(jeng, prompts, 6, JCBS), _run(eng, prompts, 6))


def test_chunked_adapter_matches_reference(pairs):
    """A chunked request carrying a per-user adapter (random B): the
    adapter's gates ride every chunk, against the reference's engine
    (texts and counts equal, fusion weights within 1e-5), and it moves
    the text off the adapter-free run's."""
    (js, sp, jl, lp, mlp), port = pairs["2b"]
    ad = jax.device_get(JLORA.init_adapter(js, jax.random.key(7), rank=2))
    rng = np.random.default_rng(7)
    for leaf in ad["layers"].values():
        leaf["B"] = (2.0 * rng.standard_normal(leaf["B"].shape)
                     ).astype(np.float32)
    kw = dict(batch_size=2, edge_batch_size=1, macro_k=0, chunk_width=16)
    jeng = JBatched(deployment=JDep(js, sp, jl, lp, mlp,
                                    latency=JLat(**LAT), max_seq=48,
                                    max_ctx=96, adapter_slots=2), **kw)
    eng = BatchedHybridEngine(deployment=_dep(port, max_ctx=96,
                                              adapter_slots=2), **kw)
    jeng.adapters.register("u", jax.tree.map(jnp.asarray, ad))
    eng.adapters.register("u", bridge.from_numpy(ad))
    prompts = [LONG, CLOUD_LONG, PROMPTS[2]]
    runs = [_run(e, prompts, 6, s, adapter_id="u")
            for e, s in ((jeng, JCBS), (eng, ContinuousBatchScheduler))]
    _close_to_reference(*runs)
    plain = _run(BatchedHybridEngine(deployment=_dep(port, max_ctx=96),
                                     **kw), prompts, 6)
    assert runs[1][1].text != plain[1].text


@pytest.mark.parametrize("macro_k", [0, 4])
def test_evicted_chunked_row_resumes(pairs, macro_k):
    """Page size 4, max_seq 48, max_ctx 96: two long rows admitted
    through chunked prefill wedge in a 32-page pool and the younger is
    evicted; its re-admission of prompt + tokens so far is wider than
    the chunk width, so it streams through chunked prefill again: ids
    and stats equal to the roomy pool's."""
    port = pairs["2b"][1]
    dep = _dep(port, max_ctx=96, page_size=4)
    prompts = [CLOUD_LONG[:50], CLOUD_LONG[:48]]
    kw = dict(batch_size=2, edge_batch_size=1, chunk_width=16)
    roomy = _run(_engine(dep, macro_k, **kw), prompts, 24)
    eng = _engine(dep, macro_k, pool_pages=32, **kw)
    got = _run(eng, prompts, 24)
    _exact(roomy, got)
    st = eng.growth_stats()
    assert st["evictions"] > 0 and st["forced"] == 0, st


def test_validation_and_caps(pairs):
    """``max_ctx`` must be page-aligned and >= max_seq, ``chunk_width``
    page-aligned in [page_size, max_seq].  On a max_ctx = 96 deployment
    a dense lane still cuts a prompt to max_seq - max_new - 1 tokens
    (the reference's ``admit_many``) while a paged lane keeps up to
    max_ctx - max_new - 1."""
    port = pairs["2b"][1]
    for bad in (100, 32):
        with pytest.raises(ValueError, match="max_ctx"):
            _dep(port, max_ctx=bad)
    dep = _dep(port, max_ctx=96)
    for bad in (8, 24, 64):
        with pytest.raises(ValueError, match="chunk_width"):
            _engine(dep, chunk_width=bad)
    n = len(TOK.encode(LONG + " "))
    dense = _engine(dep, 0, paged=False, batch_size=1)
    paged = _engine(dep, 0, batch_size=1)
    for eng, cap in ((dense, 48 - 6 - 1), (paged, n)):
        assert eng.add_request(LONG, 6, True, 0)
        s = eng.edge_lane.slots[0]                   # LONG is private
        assert s.prompt_len == cap and s.stats.truncated == (cap < n)
        while eng.active_count():
            eng.step()
