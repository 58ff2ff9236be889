"""The fault-injected cloud link in the port — ``FaultModel``, the circuit
breaker, deadline cancellation and the health counters — against the
JAX package on the reduced pairs, float32 on the CPU: the port of
``tests/test_faults.py``.

* The loss and outage draws equal the reference's bit for bit over a
  grid of (rid, step, seed, rate); ``breaker_step`` and the torch
  ``breaker_transition_device`` equal the reference's recurrence on
  random sequences.
* Under the reference tests' CHAOS weather (loss 0.25, outage 3 of
  every 10 steps, breaker n 2 m 3) at 12 tokens the port equals the
  reference on the sequential engine and the batched one at ``macro_k``
  0, 1 and 4: texts, status, token, cloud, fallback, degraded and lost
  counts, ``latency_ms``, ``clock_ms`` and ``health_stats()`` exactly,
  fusion weights within 1e-5; its own paths equal each other.  The
  budget is the smallest at which a breaker trips, recovers and
  degrades a token (at 8 tokens the weather does not bite: the outage
  phase puts the link down at steps 7-9).
* Sampled traffic, gemma3 ring lanes at 20 tokens, an all-lost link, an
  outage that trips and recovers, deadlines on every path (pools and
  adapter pins released) and the watchdog's ``health`` line."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import fusion as JFUS
from repro.models.model import LM as JLM
from repro.serving.deployment import ServingDeployment as JDep
from repro.serving import latency as JLAT
from repro.serving.scheduler import ContinuousBatchScheduler as JCBS
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch import bridge
from repro_torch.core import lora as LORA
from repro_torch.models.model import LM
from repro_torch.serving import latency as LAT
from repro_torch.serving.deployment import ServingDeployment
from repro_torch.serving.engine import BatchedHybridEngine
from repro_torch.serving.macro import LaneMacro
from repro_torch.serving.scheduler import (ContinuousBatchScheduler,
                                           ResponseStatus, Scheduler)
from _threads import one_thread  # noqa: F401

W_TOL = 1e-5
PROMPTS = [
    "math: 12 plus 7 =",
    "my ssn is 123-45-6789",     # private
    "translate: water ->",
    "my doctor said rest",       # private
    "sort: 40 12 77 31 ->",
    "explain rainbows",
]
JITTERY = dict(rtt_ms=160, jitter_ms=40.0, cloud_compute_ms=20, seed=7)
JITTERY_EDGE = 65.0
CHAOS = dict(loss_rate=0.25, outage_period=10, outage_len=3, seed=3,
             breaker_n=2, breaker_m=3)
N_TOK = 12
ZERO_HEALTH = dict(losses=0, outage_steps=0, breaker_trips=0,
                   breaker_recoveries=0, degraded_tokens=0, cancellations=0)


def _bridge(tree):
    return bridge.from_numpy(jax.device_get(tree))


def _pair_parts(jslm, sp, jllm, lp, ring=False):
    mlp = JFUS.init_alignment(jax.random.key(2), jslm.cfg.vocab_size)
    port = (LM(jslm.cfg, device="cpu", ring_cache=ring), _bridge(sp),
            LM(jllm.cfg, device="cpu"), _bridge(lp), _bridge(mlp))
    return (jslm, sp, jllm, lp, mlp), port


@pytest.fixture(scope="module")
def parts(slm, llm):
    """(reference parts, port parts) of the reduced 2b pair."""
    return _pair_parts(*slm, *llm)


@pytest.fixture(scope="module")
def gemma_parts(llm):
    cfg = get_config("floe-slm-gemma3").reduced()
    jslm = JLM(cfg, remat=False, ring_cache=True)
    return _pair_parts(jslm, jslm.init(jax.random.key(0)), *llm, ring=True)


def _deps(parts, fault=None, **kw):
    """(reference, port) deployments of ``parts`` under JITTERY weather
    and the fault model ``fault`` (a dict of FaultModel fields)."""
    ref, port = parts
    j = JDep(*ref, latency=JLAT.LatencyModel(**JITTERY), timeout_ms=200.0,
             max_seq=48, fault=JLAT.FaultModel(**fault) if fault else None,
             **kw)
    t = ServingDeployment(*port, latency=LAT.LatencyModel(**JITTERY),
                          timeout_ms=200.0, max_seq=48,
                          fault=LAT.FaultModel(**fault) if fault else None,
                          device="cpu", **kw)
    return j, t


def _batched(cls, dep, macro_k, n_tokens=N_TOK, seeded=False,
             deadline_ms=None):
    sched = cls.from_deployment(dep, batch_size=4, edge_batch_size=2,
                                macro_k=macro_k)
    for i, p in enumerate(PROMPTS):
        sched.submit(p, n_tokens, greedy=not seeded,
                     seed=1000 + i if seeded else None,
                     deadline_ms=deadline_ms)
    return sched.run(), sched.engine


def _sequential(cls, dep, n_tokens=N_TOK, deadline_ms=None):
    sched = cls.from_deployment(dep)
    for p in PROMPTS:
        sched.submit(p, n_tokens, deadline_ms=deadline_ms)
    return sched.run(), sched.engine


def _assert_same(ra, rb):
    """Tokens, status, counts, latencies, clock and fault accounting
    exact; fusion weights within W_TOL."""
    assert [r.rid for r in rb] == [r.rid for r in ra]
    for a, b in zip(ra, rb):
        assert b.text == a.text, (a.rid, a.text, b.text)
        assert b.status.value == a.status.value, a.rid
        for f in ("private", "tokens", "cloud_tokens", "fallback_tokens",
                  "cloud_calls", "latency_ms", "degraded_tokens",
                  "cloud_lost", "clock_ms", "cancelled"):
            assert getattr(b.stats, f) == getattr(a.stats, f), (a.rid, f)
        np.testing.assert_allclose(b.stats.fusion_w, a.stats.fusion_w,
                                   atol=W_TOL, rtol=0)


# ------------------------------------------------------- weather and breaker


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_fault_draws_bit_equal(seed):
    rids = np.repeat(np.arange(24, dtype=np.int32), 40)
    steps = np.tile(np.arange(40, dtype=np.int32), 24)
    for rate in (0.1, 0.25, 0.5, 1.0):
        for period, olen in ((10, 3), (6, 3), (0, 0)):
            kw = dict(loss_rate=rate, outage_period=period,
                      outage_len=olen, seed=seed)
            j, t = JLAT.FaultModel(**kw), LAT.FaultModel(**kw)
            assert t.offset == j.offset
            jl, jo = j.faults_device(rids, steps)
            tl, to = t.faults_device(rids, steps)
            np.testing.assert_array_equal(tl, np.asarray(jl))
            np.testing.assert_array_equal(to, np.asarray(jo))
            for r, s in ((0, 0), (5, 17), (23, 39)):
                assert t.lost_at(r, s) == j.lost_at(r, s)
                assert t.outage_at(s) == j.outage_at(s)
    # a zero rate draws nothing
    assert not LAT.FaultModel(seed=seed).lost_device(rids, steps).any()


@pytest.mark.parametrize("n,m", [(2, 3), (3, 4), (1, 1)])
def test_breaker_recurrence_matches_reference(n, m):
    """Random (B,) sequences of activity and injected failures: the
    torch transition equals the reference's jnp one, term for term, and
    the scalar ``breaker_step`` (the host mirror) equals both."""
    rng = np.random.default_rng(n * 10 + m)
    b = 16
    fails = np.zeros(b, np.int32)
    cool = np.zeros(b, np.int32)
    for _ in range(60):
        active = rng.random(b) < 0.8
        raw = rng.random(b) < 0.45
        want = JLAT.breaker_transition_device(
            jnp.asarray(fails), jnp.asarray(cool), jnp.asarray(active),
            jnp.asarray(raw), n, m)
        got = LAT.breaker_transition_device(
            torch.from_numpy(fails), torch.from_numpy(cool),
            torch.from_numpy(active), torch.from_numpy(raw), n, m)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for i in range(b):
            scalar = LAT.breaker_step(int(fails[i]), int(cool[i]),
                                      bool(active[i]), bool(raw[i]), n, m)
            assert tuple(int(x) for x in scalar) == tuple(
                int(np.asarray(w)[i]) for w in want)
        fails, cool = got[0].numpy(), got[1].numpy()
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32


def test_zero_fault_normalizes_to_oracle(parts):
    """An all-zero FaultModel is the fault-free path: the deployment
    drops it, no fault entry point exists, the faulted macro graph's
    breaker buffers are absent, and a served run reports all-zero
    health, like a run without a fault model."""
    _, dep = _deps(parts, fault=dict(loss_rate=0.0, outage_period=0,
                                     outage_len=0))
    assert dep.fault is None
    assert dep.fault_batched is None and dep.fault_request is None
    res, eng = _batched(ContinuousBatchScheduler, dep, 4, n_tokens=4)
    assert eng.health_stats() == ZERO_HEALTH
    assert all(r.status is ResponseStatus.OK and r.degraded_tokens == 0
               and r.cloud_lost == 0 for r in res)
    m = eng.cloud_lane._macro
    assert m.fault is None and not hasattr(m, "fails")
    assert m.traces.shape[0] == 3
    _, plain = _deps(parts)
    _assert_same(_batched(ContinuousBatchScheduler, plain, 4,
                          n_tokens=4)[0], res)


# ------------------------------------------------------ CHAOS parity


@pytest.fixture(scope="module")
def chaos(parts):
    """CHAOS at N_TOK tokens: {path: (responses, health)} of the
    reference and of the port, runs made once on first use."""
    deps = _deps(parts, fault=CHAOS)
    cache = {}

    def run(side, path):
        if (side, path) not in cache:
            dep = deps[side == "port"]
            if path == "seq":
                res, eng = _sequential(
                    Scheduler if side == "port" else JScheduler, dep)
            else:
                res, eng = _batched(
                    ContinuousBatchScheduler if side == "port" else JCBS,
                    dep, path)
            cache[side, path] = (res, eng.health_stats())
        return cache[side, path]
    return run


@pytest.mark.parametrize("path", ["seq", 0, 1, 4])
def test_chaos_parity_with_reference(chaos, path):
    ref, ref_health = chaos("ref", path)
    got, health = chaos("port", path)
    _assert_same(ref, got)
    assert health == ref_health
    # the weather bit: lost attempts, trips, recoveries, degraded tokens
    assert sum(r.cloud_lost for r in got) >= 1
    assert sum(r.degraded_tokens for r in got) >= 1
    assert health["breaker_trips"] >= 1
    assert health["breaker_recoveries"] >= 1
    for r in got:
        # degraded tokens never dispatch
        assert r.stats.cloud_calls == r.stats.tokens - r.degraded_tokens \
            or r.stats.private


@pytest.mark.parametrize("path", ["seq", 1, 4])
def test_chaos_port_paths_agree(chaos, path):
    """Within the port: the sequential engine and K = 1 and 4 equal the
    per-token batched path."""
    base, base_health = chaos("port", 0)
    got, health = chaos("port", path)
    _assert_same(base, got)
    assert health == base_health


def test_faulted_macro_graph_state(parts):
    """A faulted cloud lane's macro step carries the breaker in static
    buffers and traces the arrived mask and the loss draw; the edge
    lane's step has no breaker."""
    _, dep = _deps(parts, fault=CHAOS)
    res, eng = _batched(ContinuousBatchScheduler, dep, 4, n_tokens=6)
    cloud, edge = eng.cloud_lane._macro, eng.edge_lane._macro
    assert isinstance(cloud, LaneMacro) and cloud.fault is dep.fault
    assert cloud.traces.shape[0] == 5 and cloud.lost.shape == (4, 4)
    assert cloud.fails.dtype == torch.int32
    assert edge.fault is None and edge.traces.shape[0] == 3
    assert all(r.stats.tokens == 6 for r in res)


def test_sampled_traffic_under_faults(parts):
    """Seeded non-greedy rows under CHAOS: the port's K = 0 and K = 3
    equal the reference's K = 0 (keyed draws over the identically
    masked fused distribution)."""
    j, t = _deps(parts, fault=CHAOS)
    ref, _ = _batched(JCBS, j, 0, n_tokens=8, seeded=True)
    for k in (0, 3):
        _assert_same(ref, _batched(ContinuousBatchScheduler, t, k,
                                   n_tokens=8, seeded=True)[0])


def test_ring_lanes_under_faults(gemma_parts):
    """gemma3 ring lanes under CHAOS at 20 tokens, past the reduced
    window of 16: the port's K = 0 and 6 equal the reference's K = 0."""
    j, t = _deps(gemma_parts, fault=CHAOS)
    ref, ref_eng = _batched(JCBS, j, 0, n_tokens=20)
    for k in (0, 6):
        got, eng = _batched(ContinuousBatchScheduler, t, k, n_tokens=20)
        _assert_same(ref, got)
        assert eng.health_stats() == ref_eng.health_stats()
    assert ref_eng.health_stats()["breaker_trips"] >= 1


# --------------------------------------------------- injected behaviour


def test_all_lost_never_fuses_and_trips(parts):
    """loss_rate = 1: no token fuses cloud logits, every public token is
    charged the fallback wait or, degraded, the edge decode; breakers
    trip and never recover — and the port equals the reference."""
    fault = dict(loss_rate=1.0, breaker_n=2, breaker_m=3, seed=1)
    j, t = _deps(parts, fault=fault)
    ref, ref_eng = _batched(JCBS, j, 4, n_tokens=8)
    res, eng = _batched(ContinuousBatchScheduler, t, 4, n_tokens=8)
    _assert_same(ref, res)
    edge32 = float(np.float32(JITTERY_EDGE))
    fb32 = max(edge32, float(np.float32(200.0)))
    for r in res:
        if r.stats.private:
            continue
        assert r.stats.cloud_tokens == 0
        assert r.stats.fallback_tokens == r.stats.tokens
        assert r.degraded_tokens >= 1
        assert r.cloud_lost == r.stats.tokens - r.degraded_tokens
        assert set(r.stats.latency_ms) <= {edge32, fb32}
        assert r.stats.latency_ms.count(edge32) == r.degraded_tokens
        assert set(r.stats.fusion_w) == {1.0}
    h = eng.health_stats()
    assert h == ref_eng.health_stats()
    assert h["breaker_trips"] >= 1 and h["breaker_recoveries"] == 0


def test_outage_trips_then_recovers(parts):
    """A pure outage (no loss): rows fail outage_len steps in a row,
    trip, sit out the back-off, and the probe recovers them."""
    fault = dict(loss_rate=0.0, outage_period=6, outage_len=3,
                 breaker_n=3, breaker_m=2, seed=0)
    j, t = _deps(parts, fault=fault)
    ref, ref_eng = _batched(JCBS, j, 4, n_tokens=14)
    res, eng = _batched(ContinuousBatchScheduler, t, 4, n_tokens=14)
    _assert_same(ref, res)
    h = eng.health_stats()
    assert h == ref_eng.health_stats()
    assert h["breaker_trips"] >= 1 and h["breaker_recoveries"] >= 1
    assert h["losses"] == 0 and h["outage_steps"] >= 3
    assert any(not r.stats.private and r.stats.cloud_tokens > 0
               for r in res)


# ---------------------------------------------------------- deadlines


def _drained(eng):
    assert eng.active_count() == 0
    for lane in (eng.cloud_lane, eng.edge_lane):
        for pager in (lane.pager_s, lane.pager_l):
            if pager is not None:
                pager.alloc.check()
                assert pager.alloc.live_pages == 0


@pytest.mark.parametrize("path", ["seq", 0, 4])
def test_deadline_cancels_identically(parts, path):
    """``deadline_ms`` cancels a request at the first boundary where its
    simulated clock has reached it, alike on every path and in both
    packages: every row (private, public, degraded) is cancelled
    mid-request with its partial text, and the pools drain."""
    deadline = 400.0
    j, t = _deps(parts, fault=CHAOS)
    ref, ref_eng = _batched(JCBS, j, 0, n_tokens=10, deadline_ms=deadline)
    if path == "seq":
        got, eng = _sequential(Scheduler, t, 10, deadline_ms=deadline)
    else:
        got, eng = _batched(ContinuousBatchScheduler, t, path, n_tokens=10,
                            deadline_ms=deadline)
        _drained(eng)
    _assert_same(ref, got)
    assert eng.health_stats() == ref_eng.health_stats()
    assert eng.health_stats()["cancellations"] == len(PROMPTS)
    for r in got:
        assert r.status is ResponseStatus.CANCELLED and r.cancelled
        assert 0 < r.stats.tokens < 10
        clock = np.cumsum([0.0] + r.stats.latency_ms[:-1])
        assert (clock < deadline).all() and r.stats.clock_ms >= deadline


def test_deadline_on_dense_lanes_and_evicted_rows(parts):
    """Dense lanes cancel like paged ones, and an evicted request waiting
    for re-admission is cancelled from the queue."""
    _, t = _deps(parts, fault=CHAOS)
    ref, _ = _batched(ContinuousBatchScheduler, t, 0, n_tokens=10,
                      deadline_ms=400.0)
    eng = BatchedHybridEngine(deployment=t, batch_size=4,
                              edge_batch_size=2, macro_k=4, paged=False)
    sched = ContinuousBatchScheduler(eng)
    for p in PROMPTS:
        sched.submit(p, 10, deadline_ms=400.0)
    _assert_same(ref, sched.run())
    # an evicted request past its deadline leaves from the queue
    eng = BatchedHybridEngine(deployment=t, batch_size=2, edge_batch_size=1,
                              macro_k=0)
    assert eng.add_requests([(PROMPTS[0], 10, True, 0, None, None, None,
                              50.0)]) == [True]
    eng.step()
    lane = eng.cloud_lane
    with torch.inference_mode():
        lane._evict(0)
        (rid, _, st), = lane._cancel_expired()
    assert rid == 0 and st.cancelled and not lane._evictq
    assert eng.health_stats()["cancellations"] == 1
    _drained(eng)


def test_deadline_releases_adapter_pins(parts):
    """A cancelled adapter request drops its slot pin: the bank serves a
    fresh adapter request at once."""
    _, t = _deps(parts, adapter_slots=1)
    slm = parts[1][0]
    sched = ContinuousBatchScheduler.from_deployment(
        t, batch_size=2, edge_batch_size=1, macro_k=2)
    sched.engine.adapters.register("u0", LORA.init_adapter(
        slm, 5, rank=2, r_max=t.adapter_rank))
    sched.submit(PROMPTS[0], 8, adapter_id="u0",
                 deadline_ms=JITTERY_EDGE * 2 + 1.0)
    (r,) = sched.run()
    assert r.status is ResponseStatus.CANCELLED and 0 < r.stats.tokens < 8
    assert sched.engine.adapter_stats()["pinned"] == 0
    sched.submit(PROMPTS[0], 2, adapter_id="u0")
    (r2,) = sched.run()
    assert r2.status is ResponseStatus.OK and r2.stats.tokens == 2


def test_watchdog_message_has_health(parts):
    """A run that stops making progress raises the wedge post-mortem,
    with the health counters in it."""
    _, t = _deps(parts)
    sched = ContinuousBatchScheduler.from_deployment(
        t, batch_size=2, edge_batch_size=1, macro_k=2)
    sched.watchdog_iters = 4
    sched.engine.add_requests = lambda reqs: [False] * len(reqs)
    sched.submit(PROMPTS[0], 4)
    with pytest.raises(RuntimeError) as e:
        sched.run()
    msg = str(e.value)
    assert "wedged" in msg and "pending rids: [0]" in msg
    assert "slots free" in msg and f"health: {ZERO_HEALTH}" in msg


def test_serve_fault_flags_on_cpu(capsys):
    """``serve --fault-rate --outage --fault-seed --deadline-ms`` cancels
    every demo request and prints a ``link health`` line; the batched
    run at K = 8 and 0 and the sequential one print the same
    per-request lines (queue waits aside)."""
    import re

    from repro_torch.launch import serve

    flags = ["--fault-rate", "0.25", "--outage", "10:3", "--fault-seed",
             "3", "--deadline-ms", "400"]

    def lines(argv):
        res = serve.main(["--local", "--device", "cpu"] + flags + argv)
        out = capsys.readouterr().out.splitlines()
        assert any(ln.startswith("link health: {") for ln in out)
        return res, [re.sub(r" wait=\d+ms", "", ln) for ln in out
                     if ln.startswith("[")]
    res, batched = lines(["--batch", "4"])
    assert len(batched) == 4 and all(r.cancelled for r in res)
    assert lines(["--batch", "4", "--macro-k", "0"])[1] == batched
    assert lines([])[1] == batched
