"""COW prefix sharing in the port (``prefix=`` on paged lanes), float32
on the CPU, against the JAX package and against the port's own oracles.

* K3's plain history-offset version against the reference's
  ``chunked_causal_attention`` over [history; fresh] (its suffix-prefill
  branch), causal and windowed, B > 1 with pad rows; the CPU wrapper
  and its shape checks.
* ``build_prefix``, ``prefill_suffix``, ``prefix_page_rows``,
  ``suffix_page_rows`` and ``extend_history`` against the reference's
  (1e-5), and the suffix prefill against the port's own one-shot
  ``prefill_packed`` of prefix + suffix bit for bit.
* The reference's ``test_paged_matches_dense_prefix`` in the port, on
  the reduced 2b and gemma3 pairs at ``macro_k`` 0 and 4: paged lanes
  with COW sharing equal dense lanes fed the concatenated prompts bit
  for bit, ``build_prefix`` runs once per (lane, model), and the
  registry's pages are back at refcount 1 once the rows drained.
* The port's engine against the reference's on the same ``prefix=``
  traffic: texts, counts, latencies and admission numbers equal, fusion
  weights within 1e-5 (as ``test_torch_batched.py``).
* The COW gate's refusals (a prefix under one page, a prompt cut at the
  prefix boundary, router and adapter requests, a prompt wider than
  ``chunk_width``), an evicted COW row resuming unshared with its ids
  unchanged, and ``Scheduler.submit(prefix=)``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import fusion as JFUS
from repro.models import attention as JATT
from repro.models.model import LM as JLM
from repro.serving.deployment import ServingDeployment as JDep
from repro.serving.engine import BatchedHybridEngine as JBatched
from repro.serving.latency import LatencyModel as JLat
from repro.serving.scheduler import ContinuousBatchScheduler as JCBS
from repro_torch import bridge
from repro_torch.core import lora as LORA
from repro_torch.core.router import ExpertMeta, Router, expert_embedding
from repro_torch.data import tokenizer as TOK
from repro_torch.kernels.flash_attention import kernel as K3
from repro_torch.models.model import LM
from repro_torch.serving.deployment import ServingDeployment
from repro_torch.serving.engine import BatchedHybridEngine, HybridEngine
from repro_torch.serving.latency import LatencyModel
from repro_torch.serving.scheduler import (ContinuousBatchScheduler,
                                           Scheduler)
from _threads import one_thread  # noqa: F401

LAT = dict(rtt_ms=10, jitter_ms=0)
JITTER = dict(rtt_ms=160, jitter_ms=40.0, cloud_compute_ms=20, seed=7)
MAX_SEQ = 48
W_TOL = 1e-5
TOL = dict(rtol=1e-5, atol=1e-5)
PREFIX = "you are a helpful assistant. "      # 30 tokens: 1 page + 14
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
    keeps ring caches (window 16), as the reference's ``test_paged.py``
    builds it."""
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


def _dep(port, lat=LAT, **kw):
    s, sp, l, lp, mlp = port
    return ServingDeployment(s, sp, l, lp, mlp, latency=LatencyModel(**lat),
                             max_seq=kw.pop("max_seq", MAX_SEQ),
                             device="cpu", **kw)


def _engine(dep, paged=True, macro_k=4, **kw):
    kw.setdefault("batch_size", 4)
    kw.setdefault("edge_batch_size", 1)
    return BatchedHybridEngine(deployment=dep, macro_k=macro_k, paged=paged,
                               **kw)


def _run(eng, reqs, n_tokens=5, sched=ContinuousBatchScheduler):
    s = sched(eng)
    for i, (p, prefix) in enumerate(reqs):
        s.submit(p, n_tokens, greedy=(i % 2 == 0), seed=i, prefix=prefix)
    return s.run()


def _exact(ref, got):
    """Bit-identity of two runs' responses."""
    assert [r.rid for r in got] == [r.rid for r in ref]
    for a, b in zip(ref, got):
        assert b.text == a.text, (a.rid, a.text, b.text)
        for f in ("private", "tokens", "cloud_tokens", "fallback_tokens",
                  "cloud_calls", "truncated", "latency_ms", "fusion_w"):
            assert getattr(b.stats, f) == getattr(a.stats, f), (a.rid, f)


def _close_to_reference(jres, tres):
    """The port's responses against the reference's: texts, counts,
    latencies and admission numbers equal, fusion weights within
    1e-5."""
    assert [r.rid for r in tres] == [r.rid for r in jres]
    for a, b in zip(jres, tres):
        assert b.text == a.text, (a.rid, a.text, b.text)
        for f in ("private", "tokens", "cloud_tokens", "fallback_tokens",
                  "cloud_calls", "truncated", "latency_ms", "admit_seq"):
            assert getattr(b.stats, f) == getattr(a.stats, f), (a.rid, f)
        np.testing.assert_allclose(b.stats.fusion_w, a.stats.fusion_w,
                                   rtol=0, atol=W_TOL)


def _count_builds(dep):
    """Wrap the deployment's build_prefix entry points with counters."""
    calls = {"slm": 0, "llm": 0}
    for name in calls:
        orig = getattr(dep, f"{name}_build_prefix")

        def counted(*a, _name=name, _orig=orig, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        setattr(dep, f"{name}_build_prefix", counted)
    return calls


def _kv_leaves(tree):
    """The K/V leaves of a history or cache tree in sorted key order,
    without the reference's "hpos" or the port's "len"."""
    return jax.tree.leaves({k: _kv_leaves(v) if isinstance(v, dict) else v
                            for k, v in tree.items()
                            if k not in ("hpos", "len")})


# ------------------------------------------------------- K3's offset mode


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("h,kvh", [(4, 1), (4, 2)])
def test_k3_offset_plain_matches_reference(h, kvh, window):
    """K3's plain version with a history of P = 19 against the
    reference's suffix-prefill attention: ``chunked_causal_attention``
    over [history; fresh] with kv positions [0, P) + (P + [0, S)), at
    B = 3 whose last row is a length-1 pad row (its padded queries are
    compared too: the kernel computes every row)."""
    rng = np.random.default_rng(h + kvh + window)
    b, p, s, d = 3, 19, 13, 32
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kvh, d)).astype(np.float32)
            for _ in range(2))
    hk, hv = (rng.standard_normal((1, p, kvh, d)).astype(np.float32)
              for _ in range(2))
    k[2, 1:] = v[2, 1:] = 0.0                       # the pad row
    pos = p + np.arange(s)
    ref = JATT.chunked_causal_attention(
        jnp.asarray(q), jnp.concatenate([jnp.broadcast_to(hk, (b, p, kvh, d)),
                                         jnp.asarray(k)], 1),
        jnp.concatenate([jnp.broadcast_to(hv, (b, p, kvh, d)),
                         jnp.asarray(v)], 1),
        jnp.asarray(pos), jnp.concatenate([jnp.arange(p), jnp.asarray(pos)]),
        window, chunk=max(1024, s))
    t = lambda a: torch.from_numpy(a).transpose(1, 2)
    got = K3.flash_attention_plain(t(q), t(k), t(v), window=window,
                                   hist_k=t(hk), hist_v=t(hv))
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(ref),
                               **TOL)
    # the wrapper on CPU tensors runs the plain version and launches
    # nothing; the history is one row shared by every batch row, so a
    # history of one row per batch row is refused
    before = K3.flash_attention.offset_launches
    wrapped = K3.flash_attention(t(q), t(k), t(v), window=window,
                                 hist_k=t(hk), hist_v=t(hv))
    assert torch.equal(wrapped, got)
    assert K3.flash_attention.offset_launches == before
    with pytest.raises(ValueError, match="history"):
        K3.flash_attention(t(q), t(k), t(v), hist_k=t(np.repeat(hk, b, 0)),
                           hist_v=t(np.repeat(hv, b, 0)))
    with pytest.raises(ValueError, match="history"):
        K3.flash_attention(t(q), t(k), t(v), hist_k=t(hk)[:, :, :, :16],
                           hist_v=t(hv)[:, :, :, :16])
    with pytest.raises(ValueError, match="together"):
        K3.flash_attention(t(q), t(k), t(v), hist_k=t(hk))


# ------------------------------------------------------ the history API


@pytest.mark.parametrize("name,key", [("floe-slm-2b", 0),
                                      ("floe-slm-gemma3", 0),
                                      ("floe-llm-7b", 1)])
def test_history_api_matches_reference(name, key):
    """``build_prefix`` (P = 37), ``prefill_suffix`` (B = 4 ragged
    suffixes, two pad rows), ``prefix_page_rows`` / ``suffix_page_rows``
    (share 32 of 37, page 16) and ``extend_history`` (one exact-width
    chunk of 16) against the reference's functions, 1e-5; and the suffix
    prefill against the port's one-shot ``prefill_packed`` of prefix +
    suffix, logits and K/V bit for bit."""
    ring = name == "floe-slm-gemma3"
    cfg = get_config(name).reduced()
    jlm = JLM(cfg, remat=False, ring_cache=ring)
    jp = jlm.init(jax.random.key(key))
    lm = LM(cfg, device="cpu", ring_cache=ring)
    params = _bridge(jp)
    rng = np.random.default_rng(key + 3)
    pre_len, share, ps, max_seq = 37, 32, 16, 96
    pre = rng.integers(3, 259, (1, pre_len))
    lens = np.array([5, 20, 1, 1], np.int32)
    sfx = rng.integers(3, 259, (4, 32))

    jh = jlm.build_prefix(jp, jnp.asarray(pre, jnp.int32))
    hist = lm.build_prefix(params, torch.from_numpy(pre))
    assert hist["len"] == pre_len
    jl, jpc = jlm.prefill_suffix(jp, {"tokens": jnp.asarray(sfx, jnp.int32)},
                                 jnp.asarray(lens), jh, pre_len)
    logits, pc = lm.prefill_suffix(params, torch.from_numpy(sfx), lens, hist)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    for got, want in ((hist, jh), (pc, jpc)):
        g, w = _kv_leaves(bridge.to_numpy(got)), _kv_leaves(want)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)
    for got, want in (
            (lm.prefix_page_rows(hist, share, ps, max_seq),
             jlm.prefix_page_rows(jh, share, ps, max_seq)),
            (lm.suffix_page_rows(hist, pc, lens, share, ps, max_seq),
             jlm.suffix_page_rows(jh, jpc, jnp.asarray(lens), pre_len,
                                  share, ps, max_seq))):
        g = jax.tree.leaves(bridge.to_numpy(got))
        w = jax.tree.leaves(want)
        assert [np.shape(a) for a in g] == [np.shape(b) for b in w]
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)
    chunk = rng.integers(3, 259, (1, 16))
    _, cpc = lm.prefill_suffix(params, torch.from_numpy(chunk), [16], hist)
    _, jcpc = jlm.prefill_suffix(jp, {"tokens": jnp.asarray(chunk,
                                                            jnp.int32)},
                                 jnp.asarray([16]), jh, pre_len)
    ext, jext = lm.extend_history(hist, cpc), jlm.extend_history(jh, jcpc)
    assert ext["len"] == pre_len + 16
    for a, b in zip(_kv_leaves(bridge.to_numpy(ext)), _kv_leaves(jext)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    # one-shot: prefix + suffix through the packed prefill, bit for bit
    full = np.concatenate([np.repeat(pre, 4, 0), sfx], 1)
    seen = {}
    one = lm.prefill_packed(params, torch.from_numpy(full), lens + pre_len,
                            max_seq, write_kv=lambda a, k, v: seen.update(
                                {a: (k, v)}))
    assert torch.equal(one, logits)
    site = lm.layer_sites()[-1]
    k_one = seen[site.addr][0]
    assert torch.equal(k_one[:, pre_len:],
                       pc["k"][site.addr] if "k" in pc
                       else pc[site.addr[0]]["k"][site.addr[1]])
    h_k = (hist["k"][site.addr] if "k" in hist
           else hist[site.addr[0]]["k"][site.addr[1]])
    assert torch.equal(k_one[:1, :pre_len], h_k)


# ----------------------------------------------------------- COW serving


@pytest.mark.parametrize("name,n_tokens", [("2b", 5), ("gemma3", 8)])
@pytest.mark.parametrize("macro_k", [0, 4])
def test_paged_prefix_matches_dense(pairs, name, n_tokens, macro_k):
    """COW shared-prefix admission: the dense engine fed the
    concatenated prompts gives the same responses bit for bit, the
    preamble is prefilled exactly ONCE per (lane, model) and its pages
    are refcount-shared, then back at 1 (the registry's reference) once
    the rows drained."""
    reqs = [(p, PREFIX if i % 2 == 0 else None)
            for i, p in enumerate(PROMPTS[2:])] + [(PROMPTS[0], PREFIX)]
    dep = _dep(pairs[name][1])
    dense = _engine(dep, False, macro_k)
    calls = _count_builds(dep)
    r_dense = _run(dense, reqs, n_tokens)
    assert calls == {"slm": 0, "llm": 0}
    paged = _engine(dep, True, macro_k)
    r_paged = _run(paged, reqs, n_tokens)
    _exact(r_dense, r_paged)
    assert calls == {"slm": 1, "llm": 1}, calls
    lane = paged.cloud_lane
    entry = lane._prefixes[PREFIX]
    assert entry is not None and entry["share_np"] == 1
    assert entry["pre_len"] == len(TOK.encode(PREFIX)) == 30
    for pager, pids in ((lane.pager_s, entry["pids_s"]),
                        (lane.pager_l, entry["pids_l"])):
        assert [pager.alloc.refcount(p) for p in pids] == [1]
        assert pager.alloc.live_pages == 1
        pager.alloc.check()
    # the shared page is held once: the live bytes are the registry's
    assert paged.resident_kv_bytes() == sum(
        p.geo["page_bytes_full"] for p in (lane.pager_s, lane.pager_l))


def test_shared_rows_fork_the_registry_pages(pairs):
    """While three COW rows are live, each of the prefix's shared pages
    has 1 + 3 readers and sits first in every row's block table; the
    rows' own pages start after it (the partial tail lives in the first
    of them), and the rows' positions start at their full prompt."""
    dep = _dep(pairs["2b"][1])
    eng = _engine(dep, True, 0)
    for i, p in enumerate((PROMPTS[0], PROMPTS[2], PROMPTS[3])):
        assert eng.add_request(p, 4, True, i, prefix=PREFIX)
    lane = eng.cloud_lane
    entry = lane._prefixes[PREFIX]
    (pid,) = entry["pids_s"]
    assert lane.pager_s.alloc.refcount(pid) == 4
    for i, s in enumerate(lane.slots[:3]):
        row = lane.pager_s.rows[i]
        assert row.shared == [pid] and pid not in row.owned
        assert int(lane.s_cache["block"][i, 0]) == pid
        assert lane.s_cache["pos_host"][i] == s.prompt_len == min(
            len(TOK.encode(PREFIX + PROMPTS[0 if i == 0 else i + 1] + " ")),
            MAX_SEQ - 4 - 1)
    while eng.active_count():
        eng.step()
    assert lane.pager_s.alloc.refcount(pid) == 1


@pytest.mark.parametrize("macro_k", [0, 4])
def test_prefix_engine_matches_reference(pairs, macro_k):
    """The port's engine against the reference's on ``prefix=`` traffic
    under jittery weather: shared, unshared and private requests (the
    detector sees prefix + prompt; the edge lane shares too), texts,
    counts, latencies and admission numbers equal, fusion weights within
    1e-5."""
    (js, sp, jl, lp, mlp), port = pairs["2b"]
    kw = dict(batch_size=3, edge_batch_size=2, macro_k=macro_k)
    jeng = JBatched(js, sp, jl, lp, mlp, latency=JLat(**JITTER),
                    max_seq=MAX_SEQ, **kw)
    eng = BatchedHybridEngine(deployment=_dep(port, JITTER), **kw)
    reqs = [(p, PREFIX if i != 3 else None) for i, p in enumerate(PROMPTS)]
    runs = [_run(e, reqs, 7, s) for e, s in ((jeng, JCBS),
                                             (eng, ContinuousBatchScheduler))]
    _close_to_reference(*runs)
    assert any(r.stats.private for r in runs[1])
    for lane, jlane in ((eng.cloud_lane, jeng.cloud_lane),
                        (eng.edge_lane, jeng.edge_lane)):
        assert (lane._prefixes[PREFIX]["pids_s"]
                == jlane._prefixes[PREFIX]["pids_s"])


def test_cow_gate_refusals(pairs):
    """Requests that must not share, each served unshared: a prefix
    under one page (None cached, nothing allocated), a prompt cut at the
    prefix boundary (no suffix left: the registry entry is built but no
    row forks it), router-gated and adapter requests, and a prompt wider
    than ``chunk_width`` (chunked, owning every page it writes).  Each
    gives the dense engine's response."""
    port = pairs["2b"][1]
    dep = _dep(port)
    dense = _engine(dep, False, 0)
    oracle = {}

    def served(eng, prompt, n, prefix, **kw):
        assert eng.add_request(prompt, n, True, 0, prefix=prefix, **kw)
        done = []
        while eng.active_count():
            done += eng.step()
        (rid, text, st), = done
        return text, st.tokens

    def check(eng, prompt, n, prefix, **kw):
        key = (prompt, n, prefix, tuple(kw.items()))
        if key not in oracle:
            oracle[key] = served(dense, prompt, n, prefix, **kw)
        assert served(eng, prompt, n, prefix, **kw) == oracle[key]

    short = "be brief. "                            # 11 tokens < 1 page
    eng = _engine(dep, True, 0)
    check(eng, PROMPTS[0], 4, short)
    assert eng.cloud_lane._prefixes == {short: None}
    assert eng.cloud_lane.pager_s.alloc.live_pages == 0
    # a budget that cuts the ids to the prefix itself: no suffix
    check(eng, PROMPTS[0], MAX_SEQ - 31, PREFIX)
    entry = eng.cloud_lane._prefixes[PREFIX]
    assert entry is not None
    assert eng.cloud_lane.pager_s.alloc.refcount(entry["pids_s"][0]) == 1
    # wider than chunk_width: chunked, unshared
    wide = _engine(dep, True, 0, chunk_width=32)
    calls = _count_builds(dep)
    check(wide, PROMPTS[2], 4, PREFIX)
    assert calls["slm"] == 1 and not wide.cloud_lane._prefixes
    # adapter and router requests never share
    ad_dep = _dep(port, adapter_slots=2)
    slm = port[0]
    adapter = LORA.init_adapter(slm, 5, rank=2, r_max=ad_dep.adapter_rank)
    ad_dense, ad_paged = (_engine(ad_dep, paged, 0) for paged in (False,
                                                                  True))
    for e in (ad_dense, ad_paged):
        e.adapters.register("u", adapter)
    want = served(ad_dense, PROMPTS[0], 4, PREFIX, adapter_id="u")
    assert served(ad_paged, PROMPTS[0], 4, PREFIX, adapter_id="u") == want
    assert ad_paged.cloud_lane._prefixes == {}
    bank = LORA.stack_adapters([LORA.init_adapter(slm, j, rank=2)
                                for j in (7, 8)])
    r_dep = _dep(port, expert_bank=bank)
    router = Router([ExpertMeta(n, expert_embedding(s), i) for i, (n, s)
                     in enumerate((("math", ["compute 2 plus 2"]),
                                   ("lang", ["translate water"])))])
    engines = [_engine(r_dep, paged, 0, router=router)
               for paged in (False, True)]
    r_out = [served(e, PROMPTS[0], 4, PREFIX) for e in engines]
    assert r_out[0] == r_out[1] and engines[1].cloud_lane._prefixes == {}


@pytest.mark.parametrize("macro_k", [0, 4])
def test_evicted_cow_row_resumes(pairs, macro_k):
    """Under a 12-page pool (page 4, max_seq 96) two COW rows behind a
    2-page preamble wedge and the younger is evicted, dropping only its
    fork of the shared pages; it is re-admitted unshared from prompt +
    tokens so far once the older drains: ids and stats equal to the
    roomy pool's, the shared pages back at refcount 1.  At ``macro_k``
    0 the reference's engine on the same traffic gives the same
    responses and ``growth_stats()``."""
    (js, sp, jl, lp, mlp), port = pairs["2b"]
    short = "be brief. "                 # 11 tokens: 2 pages of 4 + 3
    dep = _dep(port, page_size=4, max_seq=96)
    reqs = [("math: com", short), ("translat", short)]
    kw = dict(batch_size=2, edge_batch_size=1, macro_k=macro_k)
    roomy = _run(BatchedHybridEngine(deployment=dep, **kw), reqs, 16)
    eng = BatchedHybridEngine(deployment=dep, pool_pages=12, **kw)
    got = _run(eng, reqs, 16)
    _exact(roomy, got)
    st = eng.growth_stats()
    assert st["evictions"] == 1 and st["forced"] == 0, st
    assert eng.evicted_rids == [1]
    entry = eng.cloud_lane._prefixes[short]
    assert entry["share_np"] == 2
    assert all(eng.cloud_lane.pager_s.alloc.refcount(p) == 1
               for p in entry["pids_s"])
    if macro_k == 0:
        jeng = JBatched(deployment=JDep(js, sp, jl, lp, mlp,
                                        latency=JLat(**LAT), max_seq=96,
                                        page_size=4),
                        paged=True, pool_pages=12, **kw)
        _close_to_reference(_run(jeng, reqs, 16, JCBS), got)
        assert jeng.growth_stats() == st


def test_sequential_scheduler_prefix(pairs):
    """``Scheduler.submit(prefix=)`` serves prefix + prompt: the same
    responses as submitting the concatenated prompt, and a private
    prefix makes the request private."""
    dep = _dep(pairs["2b"][1])
    runs = []
    for split in (True, False):
        sched = Scheduler(HybridEngine(deployment=dep))
        for p in (PROMPTS[0], PROMPTS[2]):
            if split:
                sched.submit(p, 4, prefix=PREFIX)
            else:
                sched.submit(PREFIX + p, 4)
        sched.submit("fill the form", 3,
                     prefix="my ssn is 123-45-6789. " if split else None)
        runs.append(sched.run())
    assert runs[0][2].stats.private and not runs[1][2].stats.private
    for a, b in zip(runs[0][:2], runs[1][:2]):
        assert a.text == b.text and a.stats.fusion_w == b.stats.fusion_w
