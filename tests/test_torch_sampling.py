"""Keyed sampling from the fused distribution in the port vs the JAX
package, float32 on the CPU.

* The numpy threefry's vectorised bits, uniforms and Gumbel noise equal
  ``jax.random``'s bit for bit at V = 512 and 256,000.
* K7's plain version behind ``sample_fused`` and ``select_sample_fused``
  (``kernels/logit_fusion/ops.py``) gives the reference's jitted ops'
  ids on near-flat and peaked distributions, mixed greedy rows,
  ``sample=False``, negative and large key ids and a seed past 2**32,
  and its perturbed scores equal the reference's bit for bit.
* The engines, from the same (bridged) parameters: ports of the
  reference's sampling tests (``tests/test_serving.py`` and
  ``tests/test_macro_step.py``), fusion stubbed flat as they stub it so
  the draws spread, and sampled traffic on the real fused distribution
  of the reduced 2b and gemma3 pairs.  The sequential engine, the
  batched per-token step (``macro_k=0``) and the macro step
  (``macro_k`` 3 and 4) each give the reference's token ids for the
  same (seed, key id, step); fusion weights agree within 1e-5, as in
  ``test_torch_batched.py``.  Token ids are compared through the
  decoded text with the tokenizers' ``decode`` patched to print ids
  (the byte tokenizer drops ids past 258).
* All-greedy lanes never reach the sampler.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import fusion as JFUS
from repro.data import tokenizer as JTOK
from repro.kernels.logit_fusion import ops as JOPS
from repro.models.model import LM as JLM
from repro.serving.deployment import ServingDeployment as JDep
from repro.serving.engine import BatchedHybridEngine as JBatched
from repro.serving.engine import HybridEngine as JEngine
from repro.serving.latency import LatencyModel as JLat
from repro.serving.scheduler import ContinuousBatchScheduler as JCBS
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch import bridge
from repro_torch.core import prng
from repro_torch.data import tokenizer as TOK
from repro_torch.kernels.logit_fusion import ops as OPS
from repro_torch.kernels.logit_fusion import sample as K7
from repro_torch.models.model import LM
from repro_torch.serving.deployment import ServingDeployment
from repro_torch.serving.engine import BatchedHybridEngine, HybridEngine
from repro_torch.serving.latency import LatencyModel
from repro_torch.serving.scheduler import (ContinuousBatchScheduler,
                                           Scheduler)
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
]
PARITY_PROMPTS = [
    "math: compute 12 plus 7 =",
    "translate to french: water ->",
    "sort ascending: 40 12 77 31 ->",
    "explain how rainbows form",
]
JITTER = dict(rtt_ms=160, jitter_ms=40.0, cloud_compute_ms=20, seed=7)
CALM = dict(rtt_ms=10, jitter_ms=0)
LANES = dict(batch_size=4, edge_batch_size=2)


@pytest.fixture
def token_ids(monkeypatch):
    """Both engines' texts become their token ids ("12,7,2")."""
    ids = lambda seq: ",".join(str(int(i)) for i in seq)
    monkeypatch.setattr(JTOK, "decode", ids)
    monkeypatch.setattr(TOK, "decode", ids)


def _port(jparams):
    return bridge.from_numpy(jax.device_get(jparams))


@pytest.fixture(scope="module")
def pair(slm, llm):
    (jslm, sp), (jllm, lp) = slm, llm
    mlp = JFUS.init_alignment(jax.random.key(2), jslm.cfg.vocab_size)
    port = (LM(jslm.cfg, device="cpu"), _port(sp),
            LM(jllm.cfg, device="cpu"), _port(lp), _port(mlp))
    return (jslm, sp, jllm, lp, mlp), port


@pytest.fixture(scope="module")
def gemma_pair(llm):
    """The reduced gemma3 SLM at 5 layers (two groups and a tail, window
    16, ring caches) beside the reduced 7b LLM."""
    jllm, lp = llm
    scfg = dataclasses.replace(get_config("floe-slm-gemma3").reduced(),
                               num_layers=5)
    jslm = JLM(scfg, remat=False, ring_cache=True)
    sp = jax.jit(jslm.init)(jax.random.key(0))
    mlp = JFUS.init_alignment(jax.random.key(2), scfg.vocab_size)
    port = (LM(scfg, device="cpu", ring_cache=True), _port(sp),
            LM(jllm.cfg, device="cpu"), _port(lp), _port(mlp))
    return (jslm, sp, jllm, lp, mlp), port


def _deps(pair, lat, flat=False, max_seq=MAX_SEQ, **kw):
    """(reference, port) deployments; ``flat`` stubs both fusions with
    the uniform distribution, as the reference's sampling tests do."""
    (jslm, sp, jllm, lp, mlp), (slm, tsp, llm, tlp, tmlp) = pair
    jdep = JDep(jslm, sp, jllm, lp, mlp, latency=JLat(**lat),
                max_seq=max_seq, **kw)
    tdep = ServingDeployment(slm, tsp, llm, tlp, tmlp,
                             latency=LatencyModel(**lat), max_seq=max_seq,
                             device="cpu", **kw)
    if flat:
        v = slm.cfg.vocab_size
        jdep.fuse = lambda sl, ll, arrived: (jnp.full((1, v), 1.0 / v),
                                             jnp.ones((1,)))
        jdep.fuse_batched = lambda sl, ll, arrived: (
            jnp.full((sl.shape[0], v), 1.0 / v), jnp.ones((sl.shape[0],)))
        # the port's sequential, per-token and macro paths all fuse
        # through fuse_mask
        tdep.fuse_mask = lambda sl, ll, arrived: (
            torch.full((sl.shape[0], v), 1.0 / v), torch.ones(sl.shape[0]))
    return jdep, tdep


def _same(jr, tr):
    assert [r.rid for r in tr] == [r.rid for r in jr]
    for a, b in zip(jr, tr):
        assert b.text == a.text, (a.rid, a.text, b.text)
        for f in ("private", "tokens", "cloud_tokens", "fallback_tokens",
                  "cloud_calls", "truncated", "latency_ms"):
            assert getattr(b.stats, f) == getattr(a.stats, f), (a.rid, f)
        np.testing.assert_allclose(b.stats.fusion_w, a.stats.fusion_w,
                                   rtol=0, atol=W_TOL)


def _submit(sched, n_tokens, greedy_of, seed_of):
    for i, p in enumerate(PROMPTS):
        sched.submit(p, n_tokens, greedy=greedy_of(i), seed=seed_of(i))
    return sched.run()


# ------------------------------------------------------------ the draw


@pytest.mark.parametrize("n", [512, 256_000])
def test_random_bits_uniform_gumbel_exact(n):
    seeds = [(0, 0, 0), (5, -7, 3), (2 ** 32 + 9, 2 ** 31 - 1, 2 ** 20)]
    for seed, kid, step in seeds:
        jk = jax.random.fold_in(jax.random.fold_in(
            jax.random.key(seed), np.int32(kid)), np.int32(step))
        k = prng.fold_in(prng.fold_in(prng.key(seed), np.array([kid])),
                         np.array([step]))
        tiny = np.finfo(np.float32).tiny
        np.testing.assert_array_equal(
            prng.random_bits(k, n)[0],
            np.asarray(jax.random.bits(jk, (n,), jnp.uint32)))
        np.testing.assert_array_equal(
            prng.uniform_array(k, n, tiny, 1.0)[0].view(np.uint32),
            np.asarray(jax.random.uniform(jk, (n,), jnp.float32, tiny,
                                          1.0)).view(np.uint32))
        np.testing.assert_array_equal(
            prng.gumbel(k, n)[0].view(np.uint32),
            np.asarray(jax.random.gumbel(jk, (n,))).view(np.uint32))


def _probs(rng, b, v, kind):
    x = rng.randn(b, v).astype(np.float32) * (0.1 if kind == "flat"
                                              else 8.0)
    return np.array(jax.nn.softmax(jnp.asarray(x), -1))


@pytest.mark.parametrize("kind,b,v", [("flat", 8, 512), ("peaked", 8, 512),
                                      ("flat", 2, 256_000),
                                      ("peaked", 2, 256_000)])
def test_sample_ops_match_reference(kind, b, v):
    """ids of ``sample_fused`` and ``select_sample_fused`` (mixed greedy
    rows, and ``sample=False``) equal the reference's jitted ops'."""
    rng = np.random.RandomState(v + b)
    p = _probs(rng, b, v, kind)
    keys = np.concatenate([[-1, 2 ** 31 - 1], rng.randint(
        -2 ** 31, 2 ** 31 - 1, b - 2)]).astype(np.int32)
    steps = rng.randint(0, 4096, b).astype(np.int32)
    greedy = np.arange(b) % 2 == 0
    tp = torch.from_numpy(p)
    targs = [torch.from_numpy(a) for a in (keys, steps)]
    drawn_any = False
    for seed in (0, 11, 2 ** 32 + 9):
        want = np.asarray(JOPS.sample_fused(jnp.asarray(p), keys, steps,
                                            seed=seed))
        got = OPS.sample_fused(tp, *targs, seed=seed)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        drawn_any |= bool((want != p.argmax(1)).any())
        for sample in (True, False):
            want = np.asarray(JOPS.select_sample_fused(
                jnp.asarray(p), greedy, keys, steps, seed=seed,
                sample=sample))
            got = OPS.select_sample_fused(tp, torch.from_numpy(greedy),
                                          *targs, seed=seed, sample=sample)
            np.testing.assert_array_equal(got.numpy(), want)
    assert drawn_any        # some draw left the argmax


def test_sample_scores_are_the_references():
    """The plain version's perturbed scores log(max(p, 1e-9)) + gumbel
    equal the reference's expression under ``jax.jit``, bit for bit."""
    rng = np.random.RandomState(3)
    p = _probs(rng, 2, 256_000, "flat")
    keys, steps = np.array([11, -4], np.int32), np.array([4, 900], np.int32)

    @jax.jit
    def scores(p, k, s):
        def one(p, k, s):
            key = jax.random.fold_in(jax.random.fold_in(
                jax.random.key(3), k), s)
            return jnp.log(jnp.clip(p, 1e-9)) + jax.random.gumbel(
                key, p.shape)
        return jax.vmap(one)(p, k, s)
    want = np.asarray(scores(jnp.asarray(p), keys, steps))
    ids, got = K7.sample_fused(torch.from_numpy(p), None,
                               torch.from_numpy(keys),
                               torch.from_numpy(steps), 3, scores=True)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    np.testing.assert_array_equal(ids.numpy(), want.argmax(1))


def test_vmapped_sampling_bitexact_and_distinct():
    """The batched draw equals the reference's per-row categorical with
    the same fold_in(rid, step) keys, and rows with distinct keys draw
    distinct tokens from a flat distribution (the reference's test of
    the same name)."""
    rng = np.random.RandomState(0)
    b, v = 8, 512
    p = _probs(rng, b, v, "flat")
    rids = rng.randint(0, 1000, (b,)).astype(np.int32)
    steps = rng.randint(0, 64, (b,)).astype(np.int32)
    got = OPS.sample_fused(torch.from_numpy(p), torch.from_numpy(rids),
                           torch.from_numpy(steps), seed=5).numpy()
    for i in range(b):
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.key(5), int(rids[i])), int(steps[i]))
        assert int(got[i]) == int(jax.random.categorical(
            key, jnp.log(jnp.clip(jnp.asarray(p[i]), 1e-9))))
    flat = torch.full((b, v), 1.0 / v)
    toks = OPS.sample_fused(flat, torch.arange(b),
                            torch.zeros(b, dtype=torch.int64), seed=0)
    assert len(set(toks.tolist())) == b


def test_all_greedy_lanes_draw_nothing(pair, monkeypatch):
    """``sample=False`` and all-greedy batched traffic, per token and in
    the macro step, never reach K7."""
    def refuse(*a, **kw):
        raise AssertionError("K7 reached on greedy traffic")
    monkeypatch.setattr(OPS, "_k7", refuse)
    p = torch.softmax(torch.randn(3, 512), -1)
    got = OPS.select_sample_fused(p, torch.ones(3, dtype=torch.bool),
                                  torch.zeros(3, dtype=torch.int32),
                                  torch.zeros(3, dtype=torch.int32),
                                  sample=False)
    assert torch.equal(got, p.argmax(-1))
    for k in (0, 3):
        tdep = _deps(pair, JITTER)[1]
        res = _submit(ContinuousBatchScheduler(BatchedHybridEngine(
            deployment=tdep, macro_k=k, **LANES)), 5, lambda i: True,
            lambda i: None)
        assert all(r.stats.tokens for r in res)


# ------------------------------------------------------------ engines


def test_sampling_keys_differ_across_requests(pair, token_ids):
    """The sequential engine keys each request's draws apart (fusion
    stubbed flat): distinct streams per rid, the same stream for the same
    rid, and the reference's ids for each."""
    jdep, tdep = _deps(pair, CALM, flat=True)
    jeng, teng = JEngine(deployment=jdep), HybridEngine(deployment=tdep)
    prompt = "tell me a fun fact"
    outs = []
    for rid in range(4):
        jt, jst = jeng.generate(prompt, 8, greedy=False, rid=rid)
        tt, tst = teng.generate(prompt, 8, greedy=False, rid=rid)
        assert tt == jt and tst.tokens == jst.tokens
        outs.append(tt)
    assert len(set(outs)) > 1
    assert teng.generate(prompt, 8, greedy=False, rid=0)[0] == outs[0]
    # sample_key_id replaces the rid in the sampling key only
    jt, jst = jeng.generate(prompt, 8, greedy=False, rid=2,
                            sample_key_id=0)
    tt, tst = teng.generate(prompt, 8, greedy=False, rid=2,
                            sample_key_id=0)
    assert tt == jt == outs[0] and tst.latency_ms == jst.latency_ms


def test_batched_sampling_matches_sequential_stream(pair, token_ids):
    """The batched per-token step replays the sequential engine's sample
    stream exactly, and both equal the reference's sequential engine
    (fusion stubbed flat in all three)."""
    jdep, tdep = _deps(pair, CALM, flat=True)
    jseq, seq = JEngine(deployment=jdep), HybridEngine(deployment=tdep)
    want = [jseq.generate(p, 6, greedy=False, rid=i)[0]
            for i, p in enumerate(PARITY_PROMPTS)]
    assert [seq.generate(p, 6, greedy=False, rid=i)[0]
            for i, p in enumerate(PARITY_PROMPTS)] == want
    bat = BatchedHybridEngine(deployment=tdep, batch_size=4, macro_k=0)
    for i, p in enumerate(PARITY_PROMPTS):
        assert bat.add_request(p, 6, greedy=False, rid=i)
    got = {}
    while bat.active_count():
        for rid, text, _ in bat.step():
            got[rid] = text
    assert [got[i] for i in range(len(PARITY_PROMPTS))] == want
    assert len(set(want)) > 1


def test_macro_k_bitexact_sampling(pair, token_ids):
    """Seeded sampled traffic through the scheduler: the macro step's
    epilogue (K = 4, ragged final macros at 6 tokens) and the per-token
    step give the reference's per-token ids (fusion stubbed flat)."""
    jdep, tdep = _deps(pair, JITTER, flat=True)
    sampled = (lambda i: False, lambda i: 1000 + i)
    ref = _submit(JCBS(JBatched(deployment=jdep, macro_k=0, **LANES)), 6,
                  *sampled)
    for k in (0, 4):
        _same(ref, _submit(ContinuousBatchScheduler(BatchedHybridEngine(
            deployment=tdep, macro_k=k, **LANES)), 6, *sampled))
    publics = [r.text for r in ref if not r.stats.private]
    assert len(set(publics)) > 1          # distinct per-request keys


def test_macro_k_mixed_greedy_and_sampled(pair, token_ids):
    """A batch mixing greedy and sampled rows exercises the epilogue's
    per-row select in the same macro step (fusion stubbed flat)."""
    jdep, tdep = _deps(pair, JITTER, flat=True)
    mixed = (lambda i: i % 2 == 0, lambda i: 2000 + i)
    ref = _submit(JCBS(JBatched(deployment=jdep, macro_k=0, **LANES)), 5,
                  *mixed)
    for k in (0, 4):
        _same(ref, _submit(ContinuousBatchScheduler(BatchedHybridEngine(
            deployment=tdep, macro_k=k, **LANES)), 5, *mixed))


@pytest.mark.parametrize("which", ["2b", "gemma3"])
def test_sampled_traffic_on_the_fused_distribution(which, pair, gemma_pair,
                                                   token_ids):
    """Mixed greedy and seeded sampled requests on the real fused
    distribution (K1's plain version) under jittery weather: the port's
    sequential scheduler, per-token step and macro step (K = 3) give the
    reference's ids; on gemma3 prompts and budgets run past the window
    of 16, so the rings wrap."""
    pr, n_tok, max_seq = ((pair, 8, MAX_SEQ) if which == "2b"
                          else (gemma_pair, 20, 96))
    jdep, tdep = _deps(pr, JITTER, max_seq=max_seq)
    mixed = (lambda i: i % 3 == 0, lambda i: 3000 + i)
    ref = _submit(JCBS(JBatched(deployment=jdep, macro_k=0, **LANES)),
                  n_tok, *mixed)
    _same(ref, _submit(JScheduler(JEngine(deployment=jdep)), n_tok,
                       *mixed))
    _same(ref, _submit(Scheduler(HybridEngine(deployment=tdep)), n_tok,
                       *mixed))
    for k in (0, 3):
        _same(ref, _submit(ContinuousBatchScheduler(BatchedHybridEngine(
            deployment=tdep, macro_k=k, **LANES)), n_tok, *mixed))


def test_scheduler_submit_seed(pair, token_ids):
    """``Scheduler.submit(seed=)`` keys a request's draws by the seed in
    place of its rid, as the reference's does; weather stays rid-keyed."""
    jdep, tdep = _deps(pair, JITTER, flat=True)
    seeded = (lambda i: False, lambda i: [7, None, 7, 5, None, 9][i])
    ref = _submit(JScheduler(JEngine(deployment=jdep)), 6, *seeded)
    res = _submit(Scheduler(HybridEngine(deployment=tdep)), 6, *seeded)
    _same(ref, res)
    # rids 0 and 2 share seed 7: the same sampled stream
    assert res[0].text == res[2].text and res[0].text != res[5].text
