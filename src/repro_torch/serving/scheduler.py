"""Request schedulers — the port of ``Scheduler``,
``ContinuousBatchScheduler``, ``Request``, ``Response``,
``ResponseStatus`` and ``summarize`` from ``repro/serving/scheduler.py``.

``Scheduler`` serves one request at a time, private prompts first (they
never wait on the network path).  ``ContinuousBatchScheduler`` packs
requests into the ``BatchedHybridEngine`` lanes and refills freed rows
as sequences finish.  ``Response.wall_seconds`` is measured from
``Request.submitted_at`` and includes the queue wait, broken out as
``Response.queue_wait_seconds``.
"""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.serving.adapters import UnknownAdapter
from repro_torch.serving.deployment import ServingDeployment
from repro_torch.serving.engine import (BatchedHybridEngine, GenStats,
                                        HybridEngine)


class ResponseStatus(enum.Enum):
    """Request outcome; severity order REJECTED > CANCELLED > TRUNCATED
    > OK."""
    OK = "ok"
    TRUNCATED = "truncated"
    REJECTED = "rejected"
    CANCELLED = "cancelled"


@dataclass
class Request:
    rid: int
    prompt: str
    max_new_tokens: int = 16
    submitted_at: float = 0.0
    greedy: bool = True
    seed: Optional[int] = None       # sampling-key override (else rid)
    prefix: Optional[str] = None     # shared preamble (COW-shared paged)
    adapter_id: Optional[Any] = None  # per-user adapter (slot-cached)
    deadline_ms: Optional[float] = None  # simulated-clock decode budget


@dataclass
class Response:
    rid: int
    text: str
    stats: GenStats
    wall_seconds: float              # submit -> finish (incl. queue wait)
    queue_wait_seconds: float = 0.0  # submit -> start of service
    error: Optional[str] = None      # hard admission reject (never ran)
    truncated: bool = False          # prompt clipped to fit the cache
    cancelled: bool = False          # deadline hit; ``text`` is partial

    @property
    def status(self) -> ResponseStatus:
        if self.error is not None:
            return ResponseStatus.REJECTED
        if self.cancelled:
            return ResponseStatus.CANCELLED
        if self.truncated:
            return ResponseStatus.TRUNCATED
        return ResponseStatus.OK

    @property
    def degraded_tokens(self) -> int:
        return self.stats.degraded_tokens

    @property
    def cloud_lost(self) -> int:
        return self.stats.cloud_lost


class Scheduler:
    """FIFO scheduler; private traffic is split from cloud-eligible
    traffic so a network stall never blocks on-device requests."""

    def __init__(self, engine: HybridEngine):
        self.engine = engine
        self.queue: List[Request] = []
        self._next = 0

    @classmethod
    def from_deployment(cls, deployment: ServingDeployment,
                        **engine_kw) -> "Scheduler":
        return cls(HybridEngine(deployment=deployment, **engine_kw))

    def submit(self, prompt: str, max_new_tokens: int = 16,
               greedy: bool = True, seed: Optional[int] = None,
               prefix: Optional[str] = None,
               adapter_id: Optional[Any] = None,
               deadline_ms: Optional[float] = None) -> int:
        """Queue a request; ``seed`` replaces its rid in the sampling key
        of a ``greedy=False`` request; ``prefix`` is a shared preamble,
        served as prefix + prompt."""
        rid = self._next
        self._next += 1
        self.queue.append(Request(rid, prompt, max_new_tokens, time.time(),
                                  greedy, seed, prefix, adapter_id,
                                  deadline_ms))
        return rid

    def run(self) -> List[Response]:
        """Serve the queue one request at a time, private ones first;
        detection and generation see prefix + prompt."""
        private, public = [], []
        for r in self.queue:
            (private if self.engine.detector.detect(
                (r.prefix or "") + r.prompt) else public).append(r)
        self.queue = []
        out = []
        for r in private + public:
            t0 = time.time()
            try:
                text, stats = self.engine.generate(
                    (r.prefix or "") + r.prompt, r.max_new_tokens,
                    greedy=r.greedy, rid=r.rid,
                    sample_key_id=r.seed, adapter_id=r.adapter_id,
                    deadline_ms=r.deadline_ms)
            except UnknownAdapter as e:
                # a hard reject, as the batched scheduler's pop_rejected
                out.append(Response(
                    r.rid, "", GenStats(),
                    wall_seconds=time.time() - r.submitted_at,
                    queue_wait_seconds=t0 - r.submitted_at, error=str(e)))
                continue
            out.append(Response(r.rid, text, stats,
                                wall_seconds=time.time() - r.submitted_at,
                                queue_wait_seconds=t0 - r.submitted_at,
                                truncated=stats.truncated,
                                cancelled=stats.cancelled))
        return sorted(out, key=lambda x: x.rid)


class ContinuousBatchScheduler:
    """Continuous batching: cloud-eligible requests share a hybrid decode
    batch, private requests an SLM-only batch; freed batch rows are
    refilled from the queue as sequences finish.  Each boundary
    dispatches the lanes' macro steps (K tokens per occupied row, one
    host sync per lane at collect), admits one burst into the free rows
    while they run (one packed prefill per lane, queued behind them on
    the device stream) and then collects; with ``macro_k=0`` the
    dispatch is a no-op and the collect decodes one token per row."""

    def __init__(self, engine: BatchedHybridEngine,
                 watchdog_iters: int = 5000):
        self.engine = engine
        self.queue: List[Request] = []
        self._next = 0
        # no-progress bound for run(): after this many consecutive
        # boundaries with no admission, rejection or completion the loop
        # raises a diagnostic instead of hanging
        self.watchdog_iters = watchdog_iters

    @classmethod
    def from_deployment(cls, deployment: ServingDeployment,
                        **engine_kw) -> "ContinuousBatchScheduler":
        """Build the continuous-batching engine on a deployment."""
        return cls(BatchedHybridEngine(deployment=deployment, **engine_kw))

    def submit(self, prompt: str, max_new_tokens: int = 16,
               greedy: bool = True, seed: Optional[int] = None,
               prefix: Optional[str] = None,
               adapter_id: Optional[Any] = None,
               deadline_ms: Optional[float] = None) -> int:
        rid = self._next
        self._next += 1
        self.queue.append(Request(rid, prompt, max_new_tokens, time.time(),
                                  greedy, seed, prefix, adapter_id,
                                  deadline_ms))
        return rid

    def _wedge_diagnostics(self, pending: List[Request]) -> str:
        """What a post-mortem needs when the loop stops making progress:
        who waits, lane and pool occupancy, and the fault and breaker
        counters."""
        eng = self.engine
        lines = [f"pending rids: {[r.rid for r in pending]}",
                 f"active rows: {eng.active_count()}"]
        for name, lane in (("cloud", eng.cloud_lane),
                           ("edge", eng.edge_lane)):
            pools = [f"{pager.alloc.free_pages}/{pager.alloc.num_pages}"
                     for pager in (lane.pager_s, lane.pager_l)
                     if pager is not None]
            lines.append(f"{name} lane: {len(lane.free_slots())}/"
                         f"{lane.batch} slots free, "
                         f"evictq={len(lane._evictq)}, "
                         f"free pages={pools or 'dense'}")
        lines.append(f"growth: {eng.growth_stats()}")
        if eng.adapter_stats():
            lines.append(f"adapters: {eng.adapter_stats()}")
        lines.append(f"health: {eng.health_stats()}")
        return "; ".join(lines)

    def run(self) -> List[Response]:
        pending = list(self.queue)
        self.queue = []
        submitted_at = {r.rid: r.submitted_at for r in pending}
        admitted_at: Dict[int, float] = {}
        out: List[Response] = []
        stalled = 0
        while pending or self.engine.active_count():
            progressed = False
            self.engine.dispatch_step()
            # fill freed slots as ONE admission burst per boundary (FIFO
            # per lane: a soft-refused request holds back later arrivals
            # bound for the same lane)
            if pending:
                flags = self.engine.add_requests(
                    [(r.prompt, r.max_new_tokens, r.greedy, r.rid, r.seed,
                      r.prefix, r.adapter_id, r.deadline_ms)
                     for r in pending])
                now = time.time()
                # hard rejects error out instead of spinning in the queue
                rejected = dict(self.engine.pop_rejected())
                still: List[Request] = []
                for r, ok in zip(pending, flags):
                    if ok:
                        admitted_at[r.rid] = now
                        progressed = True
                    elif r.rid in rejected:
                        out.append(Response(
                            r.rid, "", GenStats(),
                            wall_seconds=now - r.submitted_at,
                            queue_wait_seconds=now - r.submitted_at,
                            error=rejected[r.rid]))
                        progressed = True
                    else:
                        still.append(r)
                pending = still
            for rid, text, stats in self.engine.collect_step():
                now = time.time()
                out.append(Response(
                    rid, text, stats,
                    wall_seconds=now - submitted_at[rid],
                    queue_wait_seconds=(admitted_at[rid]
                                        - submitted_at[rid]),
                    truncated=stats.truncated,
                    cancelled=stats.cancelled))
                progressed = True
            # watchdog: a bounded run of boundaries that admit, reject
            # and complete nothing is normal; an unbounded one is a wedge
            if progressed:
                stalled = 0
            else:
                stalled += 1
                if stalled >= self.watchdog_iters:
                    raise RuntimeError(
                        "ContinuousBatchScheduler wedged: "
                        f"{stalled} boundaries with no progress — "
                        + self._wedge_diagnostics(pending))
        return sorted(out, key=lambda x: x.rid)


def summarize(responses: List[Response]) -> Dict[str, float]:
    lat = [r.stats.mean_latency_ms for r in responses if r.stats.latency_ms]
    waits = [r.queue_wait_seconds for r in responses]
    drafted = sum(r.stats.spec_drafted for r in responses)
    accepted = sum(r.stats.spec_accepted for r in responses)
    all_lat = [x for r in responses for x in r.stats.latency_ms]
    return {
        "requests": len(responses),
        "private_frac": float(np.mean([r.stats.private for r in responses])),
        "cloud_token_frac": float(np.mean(
            [r.stats.cloud_tokens / max(1, r.stats.tokens)
             for r in responses])),
        "fallback_token_frac": float(np.mean(
            [r.stats.fallback_tokens / max(1, r.stats.tokens)
             for r in responses])),
        "mean_token_latency_ms": float(np.mean(lat)) if lat else 0.0,
        "p95_token_latency_ms": float(np.percentile(all_lat, 95))
        if lat else 0.0,
        "p99_token_latency_ms": float(np.percentile(all_lat, 99))
        if lat else 0.0,
        "cloud_calls_per_token": float(np.mean(
            [r.stats.cloud_calls / max(1, r.stats.tokens)
             for r in responses])),
        "cloud_used_frac": float(np.mean(
            [r.stats.cloud_calls / max(1, r.stats.tokens)
             for r in responses])),
        "accept_rate": float(accepted / max(1, drafted)),
        "degraded_token_frac": float(np.mean(
            [r.stats.degraded_tokens / max(1, r.stats.tokens)
             for r in responses])),
        "cancelled": int(sum(bool(r.cancelled) for r in responses)),
        "mean_queue_wait_s": float(np.mean(waits)) if waits else 0.0,
        "p95_queue_wait_s": float(np.percentile(waits, 95))
        if waits else 0.0,
    }
