"""Speculative decode in the port (``BatchedHybridEngine(spec_k=k)``:
the SLM drafts k tokens, one chained LLM verify scores them, the fused
choices accept the longest agreeing prefix and the rejected writes roll
back) against the JAX package and against the port's own per-token
path, float32 on the CPU: the port of ``tests/test_speculative.py``.

* ``accept_prefix`` equals the reference's op and its host oracle
  ``accept_prefix_ref`` on random windows; ``spec_snapshot`` and
  ``spec_restore`` equal the reference's on plain paged, dense and
  gemma3 ring caches (parked rows, writes past the table and rows whose
  window wraps its ring included).
* Under CALM weather the engines equal the reference's at k 1 and 4 x
  ``macro_k`` 0 and 8 on the 2b pair and k 4, ``macro_k`` 8 on gemma3:
  texts, counts, ``cloud_calls``, ``spec_drafted``, ``spec_accepted``
  and latencies exactly, fusion weights within 1e-5; one seeded run.
* With a fusion stub whose choice sometimes leaves the SLM's argmax
  (a torch twin of the reference tests' skew stub; the two are not
  compared with each other: torch and XLA may round its hash apart) the
  spec path equals the port's per-token path with drafts rejected, the
  dense lane caches end as a never-drafted run's, pools drain.
* Under CHAOS at 16 tokens, k 2, the port equals the reference and the
  breaker degrades bursts; ``spec_k`` past a ring window raises; spec on
  dense lanes, under pool pressure (evicted rows resume one behind) and
  the ``--spec-k`` launcher."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config
from repro.core import fusion as JFUS
from repro.kernels.logit_fusion import ops as JOPS
from repro.models.model import LM as JLM
from repro.serving import paging as JPAG
from repro.serving.deployment import ServingDeployment as JDep
from repro.serving.latency import FaultModel as JFault
from repro.serving.latency import LatencyModel as JLat
from repro.serving.scheduler import ContinuousBatchScheduler as JCBS
from repro_torch import bridge
from repro_torch.kernels.logit_fusion import ops as OPS
from repro_torch.models.attention import FREED_POS
from repro_torch.models.model import LM
from repro_torch.serving import paging as PAG
from repro_torch.serving.deployment import ServingDeployment
from repro_torch.serving.engine import BatchedHybridEngine
from repro_torch.serving.latency import FaultModel, LatencyModel
from repro_torch.serving.scheduler import ContinuousBatchScheduler, summarize
from repro_torch.serving.spec import LaneSpec
from _threads import one_thread  # noqa: F401

W_TOL = 1e-5
PROMPTS = [
    "math: 12 plus 7 =",
    "my ssn is 123-45-6789",     # private -> edge lane
    "translate: water ->",
    "my doctor said rest",       # private -> edge lane
    "sort: 40 12 77 31 ->",
    "explain rainbows",
]
CALM = dict(rtt_ms=50.0, jitter_ms=5.0, cloud_compute_ms=20.0, seed=7)
CHAOS = dict(loss_rate=0.25, outage_period=10, outage_len=3, seed=3,
             breaker_n=2, breaker_m=3)
N_TOK = 10


def _bridge(tree):
    return bridge.from_numpy(jax.device_get(tree))


def _pair_parts(jslm, sp, jllm, lp, ring=False):
    mlp = JFUS.init_alignment(jax.random.key(2), jslm.cfg.vocab_size)
    port = (LM(jslm.cfg, device="cpu", ring_cache=ring), _bridge(sp),
            LM(jllm.cfg, device="cpu"), _bridge(lp), _bridge(mlp))
    return (jslm, sp, jllm, lp, mlp), port


@pytest.fixture(scope="module")
def parts(slm, llm):
    return _pair_parts(*slm, *llm)


@pytest.fixture(scope="module")
def gemma_parts(llm):
    cfg = get_config("floe-slm-gemma3").reduced()
    jslm = JLM(cfg, remat=False, ring_cache=True)
    return _pair_parts(jslm, jslm.init(jax.random.key(0)), *llm, ring=True)


def _deps(parts, fault=None, **kw):
    ref, port = parts
    j = JDep(*ref, latency=JLat(**CALM), timeout_ms=200.0, max_seq=48,
             fault=JFault(**fault) if fault else None, **kw)
    t = ServingDeployment(*port, latency=LatencyModel(**CALM),
                          timeout_ms=200.0, max_seq=48,
                          fault=FaultModel(**fault) if fault else None,
                          device="cpu", **kw)
    return j, t


def _run(cls, dep, spec_k, macro_k, n_tok=N_TOK, seeded=False, **kw):
    sched = cls.from_deployment(dep, batch_size=4, edge_batch_size=2,
                                macro_k=macro_k, spec_k=spec_k, **kw)
    for i, p in enumerate(PROMPTS):
        sched.submit(p, n_tok, greedy=not seeded,
                     seed=1000 + i if seeded else None)
    return sched.run(), sched.engine


def _assert_same(ra, rb, fields=("tokens", "cloud_tokens",
                                 "fallback_tokens", "cloud_calls",
                                 "spec_drafted", "spec_accepted",
                                 "latency_ms", "degraded_tokens",
                                 "cloud_lost", "clock_ms")):
    assert [r.rid for r in rb] == [r.rid for r in ra]
    for a, b in zip(ra, rb):
        assert b.text == a.text, (a.rid, a.text, b.text)
        assert b.status.value == a.status.value
        for f in fields:
            assert getattr(b.stats, f) == getattr(a.stats, f), (a.rid, f)
        np.testing.assert_allclose(b.stats.fusion_w, a.stats.fusion_w,
                                   atol=W_TOL, rtol=0)


def _reconciled(base, spec):
    """The spec run emits the per-token run's stream bit for bit (the
    latencies legitimately differ: one round-trip a burst)."""
    _assert_same(base, spec, ("tokens", "cloud_tokens", "fallback_tokens"))
    for a, b in zip(base, spec):
        assert b.stats.fusion_w == a.stats.fusion_w, a.rid


def _skew(sl, ll, arrived):
    """A deterministic fusion whose choice leaves argmax(sl) for about a
    third of the rows (a hash of the SLM logits): the reduced pair agrees
    everywhere on its own, so without it no draft would be rejected."""
    v = sl.shape[-1]
    h = torch.sum(torch.abs(sl) * 1e3, -1).to(torch.int32) % 3
    top = torch.argmax(sl, -1)
    choice = torch.where(h == 0, (top + 7) % v, top)
    return F.one_hot(choice, v).float(), torch.ones(sl.shape[0])


# ------------------------------------------------------------ the ops


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_accept_prefix_matches_reference(k):
    rng = np.random.default_rng(k)
    ref_op = jax.jit(JOPS.accept_prefix, static_argnums=5)
    b = 8
    for _ in range(25):
        draft = rng.integers(0, 4, (k, b)).astype(np.int32)
        sel = np.where(rng.random((k, b)) < 0.7, draft,
                       rng.integers(0, 4, (k, b))).astype(np.int32)
        steps = rng.integers(0, 10, b).astype(np.int32)
        max_new = (steps + rng.integers(1, 8, b)).astype(np.int32)
        active = rng.random(b) < 0.8
        want = ref_op(*(jnp.asarray(a) for a in (
            draft, sel, steps, max_new, active)), 1)
        got = OPS.accept_prefix(*(torch.from_numpy(a) for a in (
            draft, sel, steps, max_new, active)), 1)
        ref = OPS.accept_prefix_ref(draft, sel, steps, max_new, active, 1)
        for w, g, r in zip(want, got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(r, np.asarray(w))


def test_cloud_arrival_mask_fault_terms():
    rng = np.random.default_rng(0)
    ok, active, lost, outage, degraded = (rng.random(32) < 0.6
                                          for _ in range(5))
    want = np.asarray(JOPS.cloud_arrival_mask(ok, active, lost, outage,
                                              degraded))
    np.testing.assert_array_equal(
        OPS.cloud_arrival_mask(ok, active, lost, outage, degraded), want)
    got = OPS.cloud_arrival_mask(*(torch.from_numpy(a) for a in (
        ok, active, lost, outage, degraded)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(OPS.cloud_arrival_mask(ok, active),
                                  ok & active)


# ------------------------------------------------- snapshot and restore


def _random_lane(lm, dep, paged, pos, rng):
    """A port lane cache of ``lm`` (paged through ``dep``'s pools, or
    dense) with random K/V, per-row positions ``pos`` and, when paged,
    each row's pages in a shuffled order; and the reference's cache of
    the same values (the pools without the port's sink page)."""
    b, ps = len(pos), dep.page_size
    if paged:
        geo = dep.paged_geometry(lm)
        cache = dep.init_paged_lane_cache(lm, b, b * geo["nb"],
                                          b * geo["nl"])
        perm = rng.permutation(b * geo["nb"]).reshape(b, geo["nb"])
        cache["block"].copy_(torch.from_numpy(perm.astype(np.int32)))
        # row 4 maps only its first page: its writes past it drop
        cache["block"][4, 1:] = PAG.NO_PAGE
        if "local" in cache:
            loc = rng.permutation(b * geo["nl"]).reshape(b, geo["nl"])
            cache["local"].copy_(torch.from_numpy(loc.astype(np.int32)))
    else:
        cache = dep.init_lane_cache(lm, b)
    for kind in ("", "inner", "tail", "global"):
        sub = cache if kind == "" else cache.get(kind)
        if sub is None or "k" not in sub:
            continue
        for name in ("k", "v"):
            sub[name].copy_(torch.from_numpy(rng.standard_normal(
                tuple(sub[name].shape)).astype(np.float32)))
    cache["pos"].copy_(torch.tensor(pos, dtype=torch.int32))
    cache.pop("pos_host")

    def ref_leaf(t):
        a = t.numpy()
        return jnp.asarray(a[..., :-1, :, :, :] if paged else a)
    ref = {}
    for key, v in cache.items():
        if isinstance(v, dict):
            ref[key] = {n: ref_leaf(v[n]) for n in ("k", "v")}
        elif key in ("k", "v"):
            ref[key] = ref_leaf(v)
        else:
            ref[key] = jnp.asarray(v.numpy())
    return cache, ref


@pytest.mark.parametrize("layout", ["plain-paged", "plain-dense",
                                    "gemma3-paged", "gemma3-dense"])
def test_snapshot_restore_matches_reference(parts, gemma_parts, layout):
    """Snapshot the k write targets, overwrite every leaf with noise (a
    burst's writes and more), restore with random keep counts: the port's
    snapshot (at the targets the decode writes) and restored leaves equal
    the reference's."""
    pair, paged = layout.split("-")
    ref_parts, port_parts = gemma_parts if pair == "gemma3" else parts
    jlm, lm = ref_parts[0], port_parts[0]
    dep = ServingDeployment(lm, port_parts[1], max_seq=48, device="cpu")
    paged = paged == "paged"
    k = 4
    rng = np.random.default_rng(len(layout))
    # rows mid-table, near the end (some writes past max_seq 48), parked,
    # past a ring's wrap (window 16 on gemma3), and a short mapping
    pos = [5, 45, FREED_POS, 30, 14, 7]
    cache, ref = _random_lane(lm, dep, paged, pos, rng)
    pos0 = torch.tensor(pos, dtype=torch.int32)
    snap = lm.spec_snapshot(cache, pos0, k, 48)
    jsnap = jlm.spec_snapshot(ref, jnp.asarray(pos), k, 48)
    for (kind, name), got in snap.items():
        want = np.asarray(jsnap[kind][name])
        leaf = cache if kind == "" else cache[kind]
        _, written = lm._spec_slots(cache, leaf[name], pos0, k,
                                    kind in ("inner", "tail")
                                    and lm._ring_local_len(48) > 0, 48)
        m = written.numpy()
        np.testing.assert_array_equal(
            got.numpy()[:, m], want.reshape(got.shape)[:, m])
    noise = np.random.default_rng(99)
    for kind, name, leaf, _ in lm._spec_leaves(cache, 48):
        fresh = noise.standard_normal(tuple(leaf.shape)).astype(np.float32)
        leaf.copy_(torch.from_numpy(fresh))
        sub = ref if kind == "" else ref[kind]
        sub[name] = jnp.asarray(fresh[..., :-1, :, :, :] if paged
                                else fresh)
    keep = np.array([0, 2, 4, 1, 3, 0], np.int32)
    lm.spec_restore(cache, snap, pos0, torch.from_numpy(keep), 48)
    jout = jlm.spec_restore(ref, jsnap, jnp.asarray(pos), jnp.asarray(keep),
                            48)
    for kind, name, leaf, _ in lm._spec_leaves(cache, 48):
        got = leaf.numpy()
        if paged:
            got = got[..., :-1, :, :, :]
        want = np.asarray(jout[name] if kind == "" else jout[kind][name])
        np.testing.assert_array_equal(got, want, err_msg=f"{kind}{name}")


def test_pager_rollback_to_matches_reference():
    """``rollback_to`` frees nothing and reports the pages mapped past
    the accepted depth, as the reference's pager does."""
    got = PAG.LanePager(2, 48, 4, 24)
    want = JPAG.LanePager(2, 48, 4, 24)
    for pager in (got, want):
        pager.admit(0, 3)
        pager.grow(0, 2)
    for pos in (0, 5, 12, 20):
        assert got.rollback_to(0, pos) == want.rollback_to(0, pos)
    assert got.alloc.free_pages == want.alloc.free_pages
    with pytest.raises(AssertionError):
        got.rollback_to(0, 21)


# ------------------------------------------ engines against the reference


@pytest.fixture(scope="module")
def calm(parts, gemma_parts):
    return {"2b": _deps(parts), "gemma3": _deps(gemma_parts)}


@pytest.mark.parametrize("pair,k,macro_k,seeded", [
    ("2b", 1, 0, False), ("2b", 4, 0, False), ("2b", 1, 8, False),
    ("2b", 4, 8, False), ("gemma3", 4, 8, False), ("2b", 4, 8, True)])
def test_spec_matches_reference(calm, pair, k, macro_k, seeded):
    j, t = calm[pair]
    ref, ref_eng = _run(JCBS, j, k, macro_k, seeded=seeded)
    got, eng = _run(ContinuousBatchScheduler, t, k, macro_k, seeded=seeded)
    _assert_same(ref, got)
    drafted = sum(r.stats.spec_drafted for r in got)
    accepted = sum(r.stats.spec_accepted for r in got)
    assert drafted > 0 and 0 < accepted <= drafted
    for r in got:
        if r.stats.cloud_tokens:
            assert r.stats.cloud_calls <= 1 + -(-(r.stats.tokens - 1) // k)
    chain = eng.cloud_lane._spec_chain
    assert isinstance(chain, LaneSpec)
    assert (chain.n_bursts, chain.k) == (-(-macro_k // k) or 1, k)
    assert summarize(got)["accept_rate"] == pytest.approx(accepted / drafted)


def test_spec_reconciles_with_per_token_path(calm):
    """Within the port under CALM, k = 4 at K 8 emits the per-token
    path's stream with strictly fewer cloud calls."""
    _, t = calm["2b"]
    base, _ = _run(ContinuousBatchScheduler, t, 0, 0)
    spec, _ = _run(ContinuousBatchScheduler, t, 4, 8)
    _reconciled(base, spec)
    assert sum(r.stats.cloud_calls for r in spec) \
        < sum(r.stats.cloud_calls for r in base)
    assert all(r.stats.spec_drafted == 0 for r in base)


def test_spec_dispatch_discipline(calm):
    """4 cloud rows x 9 tokens at k = 4, macro_k = 0: the seed token
    rides the prefill logits, then exactly ceil(8 / 4) = 2 bursts, each
    one chain run and one trace fetch."""
    _, dep = calm["2b"]
    eng = BatchedHybridEngine(deployment=dep, batch_size=4,
                              edge_batch_size=2, macro_k=0, spec_k=4)
    cloud = [p for p in PROMPTS if not eng.detector.detect(p)][:4]
    counts = {"run": 0, "fetch": 0}
    for i, p in enumerate(cloud):
        assert eng.add_request(p, 9, True, i)
    eng.step()
    chain = eng.cloud_lane._spec_chain
    run, fetch = chain.run, dep.fetch_traces

    def counted_run(*a, **kw):
        counts["run"] += 1
        return run(*a, **kw)

    def counted_fetch(*a, **kw):
        counts["fetch"] += 1
        return fetch(*a, **kw)
    chain.run, dep.fetch_traces = counted_run, counted_fetch
    try:
        while eng.active_count():
            eng.step()
    finally:
        del chain.run, dep.fetch_traces
    assert counts == {"run": 1, "fetch": 1}
    assert chain.n_bursts == 1


# ------------------------------------------------ rollback and the stub


@pytest.fixture(scope="module")
def skew(parts, gemma_parts):
    out = {}
    for name, p in (("2b", parts), ("gemma3", gemma_parts)):
        _, t = _deps(p)
        t.fuse_mask = _skew
        out[name] = t
    return out


@pytest.mark.parametrize("pair", ["2b", "gemma3"])
@pytest.mark.parametrize("k,seeded", [(2, False), (4, False), (4, True)])
def test_divergent_fusion_rolls_back_and_reconciles(skew, pair, k, seeded):
    dep = skew[pair]
    for macro_k in (0, 8):
        base, _ = _run(ContinuousBatchScheduler, dep, 0, macro_k,
                       seeded=seeded)
        spec, _ = _run(ContinuousBatchScheduler, dep, k, macro_k,
                       seeded=seeded)
        _reconciled(base, spec)
        drafted = sum(r.stats.spec_drafted for r in spec)
        accepted = sum(r.stats.spec_accepted for r in spec)
        # drafts were rejected: the restore and correction ran
        assert 0 < accepted < drafted


def test_rollback_leaves_state_as_never_drafted(skew):
    """After a run with rejected drafts the spec lane's dense caches (and
    positions) are those the per-token run leaves; paged pools drain."""
    dep = skew["2b"]
    engines = []
    for k in (0, 4):
        eng = BatchedHybridEngine(deployment=dep, batch_size=4,
                                  edge_batch_size=2, macro_k=0,
                                  paged=False, spec_k=k)
        sched = ContinuousBatchScheduler(eng)
        for p in PROMPTS:
            sched.submit(p, N_TOK)
        engines.append((sched.run(), eng))
    _reconciled(engines[0][0], engines[1][0])
    for which in ("s_cache", "l_cache"):
        a = getattr(engines[0][1].cloud_lane, which)
        b = getattr(engines[1][1].cloud_lane, which)
        for key in ("k", "v", "pos"):
            assert torch.equal(a[key], b[key]), (which, key)
        np.testing.assert_array_equal(a["pos_host"], b["pos_host"])
    _, eng = _run(ContinuousBatchScheduler, dep, 4, 0)
    for pager in (eng.cloud_lane.pager_s, eng.cloud_lane.pager_l):
        pager.alloc.check()
        assert pager.alloc.live_pages == 0
        assert pager.alloc.free_pages == pager.alloc.num_pages


# ------------------------------------------------------------ faults


def test_spec_under_chaos_matches_reference(parts):
    """CHAOS at 16 tokens, k = 2, K 8: the burst weather (one draw and
    one breaker transition a burst) equals the reference's bit for bit;
    the breaker degrades bursts to pure SLM drafting at no cloud
    cost."""
    j, t = _deps(parts, fault=CHAOS)
    ref, ref_eng = _run(JCBS, j, 2, 8, n_tok=16)
    got, eng = _run(ContinuousBatchScheduler, t, 2, 8, n_tok=16)
    _assert_same(ref, got)
    assert eng.health_stats() == ref_eng.health_stats()
    assert sum(r.stats.degraded_tokens for r in got) >= 1
    assert sum(r.stats.fallback_tokens for r in got) >= 1
    for r in got:
        assert r.stats.tokens > 0
        assert r.stats.cloud_calls + r.stats.degraded_tokens \
            <= r.stats.tokens


# ------------------------------------------------------ lanes and CLI


def test_spec_k_validates_against_ring_window(gemma_parts, parts):
    slm, sp, llm, lp, mlp = gemma_parts[1]
    window = slm._ring_local_len(48)
    assert window == 16
    with pytest.raises(ValueError, match="ring window"):
        BatchedHybridEngine(slm, sp, llm, lp, mlp, max_seq=48,
                            latency=LatencyModel(**CALM),
                            spec_k=window + 1, device="cpu")
    BatchedHybridEngine(slm, sp, llm, lp, mlp, max_seq=48,
                        latency=LatencyModel(**CALM), spec_k=window,
                        device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        BatchedHybridEngine(*parts[1], max_seq=48,
                            latency=LatencyModel(**CALM), spec_k=-1,
                            device="cpu")


@pytest.mark.parametrize("pair", ["2b", "gemma3"])
def test_spec_dense_lanes_equal_paged(calm, pair):
    """Dense lanes serve the bursts as paged ones do, bit for bit."""
    _, t = calm[pair]
    paged, _ = _run(ContinuousBatchScheduler, t, 4, 8)
    dense, _ = _run(ContinuousBatchScheduler, t, 4, 8, paged=False)
    _assert_same(paged, dense)


@pytest.mark.parametrize("macro_k", [0, 4])
def test_spec_under_pool_pressure(parts, macro_k):
    """Page size 4 and pools too small for both rows: rows park, one is
    evicted and re-prefilled (its LLM goes back one behind), and the
    streams equal the roomy-pool spec run's and the reference's."""
    lat = dict(rtt_ms=10, jitter_ms=0)
    j = JDep(*parts[0], latency=JLat(**lat), max_seq=48, page_size=4)
    t = ServingDeployment(*parts[1], latency=LatencyModel(**lat),
                          max_seq=48, page_size=4, device="cpu")
    reqs = [("hi there", 16), ("hi there x", 16)]

    def run(cls, dep, **kw):
        sched = cls.from_deployment(dep, batch_size=2, edge_batch_size=1,
                                    macro_k=macro_k, spec_k=2, **kw)
        for i, (p, n) in enumerate(reqs):
            sched.submit(p, n, greedy=(i % 2 == 0), seed=i)
        return sched.run(), sched.engine
    roomy, _ = run(ContinuousBatchScheduler, t)
    got, eng = run(ContinuousBatchScheduler, t, pool_pages=8)
    ref, _ = run(JCBS, j, pool_pages=8)
    _assert_same(ref, got)
    _reconciled(roomy, got)
    st = eng.growth_stats()
    assert st["evictions"] >= 1 and st["parks"] >= 1 and st["forced"] == 0
    assert eng.active_count() == 0 and eng.resident_kv_bytes() == 0


def test_chain_keeps_lane_addresses(calm):
    """The burst chain updates the lane's tensors in place (on the card
    its graph reads and writes these addresses): caches, positions,
    tables, pending logits and ``lt`` keep their storage across
    dispatches and admissions."""
    _, t = calm["2b"]
    eng = BatchedHybridEngine(deployment=t, batch_size=4, edge_batch_size=2,
                              macro_k=8, spec_k=4)
    lane = eng.cloud_lane

    def ptrs():
        out = [lane.sl.data_ptr(), lane.ll.data_ptr(), lane.lt.data_ptr()]
        for c in (lane.s_cache, lane.l_cache):
            out += [v.data_ptr() for v in c.values()
                    if isinstance(v, torch.Tensor)]
        return out
    reqs = [(p, 12, True, i) for i, p in enumerate(PROMPTS)]
    flags = eng.add_requests(reqs[:3])
    eng.step()
    first = ptrs()
    while eng.active_count() or len(flags) < len(reqs):
        eng.dispatch_step()
        if len(flags) < len(reqs):
            flags += eng.add_requests([reqs[len(flags)]])
        eng.collect_step()
        assert ptrs() == first
        for c in (lane.s_cache, lane.l_cache):
            live = c["pos_host"] < FREED_POS
            np.testing.assert_array_equal(c["pos"].numpy()[live],
                                          c["pos_host"][live])


def test_serve_spec_flag_on_cpu(capsys):
    """``serve --batch 4 --spec-k 4`` emits the ``--spec-k 0`` run's
    texts and counts (latencies aside: one round-trip a burst), with
    fewer cloud calls a token and a nonzero acceptance."""
    import re

    from repro_torch.launch import serve

    def run(argv):
        res = serve.main(["--local", "--device", "cpu", "--batch", "4"]
                         + argv)
        out = capsys.readouterr().out.splitlines()
        return summarize(res), [re.sub(r" (lat|wait)=\d+ms", "", ln)
                                for ln in out if ln.startswith("[")]
    base_sum, base = run([])
    for argv in (["--spec-k", "4"], ["--spec-k", "4", "--macro-k", "0"]):
        got_sum, got = run(argv)
        assert got == base and len(got) == 4
        assert got_sum["cloud_calls_per_token"] \
            < base_sum["cloud_calls_per_token"]
        assert got_sum["accept_rate"] > 0.0 == base_sum["accept_rate"]
