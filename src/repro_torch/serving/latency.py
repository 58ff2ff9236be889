"""Network / device latency and fault weather for the serving simulation
— the port of ``LatencyModel``, ``FaultModel``, ``breaker_step`` and
``breaker_transition_device`` in ``repro/serving/latency.py``.

Per-token cloud-logit arrival is RTT/2 each way plus cloud compute, with
Gaussian jitter.  Counter-based draws are keyed by ``(seed, rid, step)``
through the numpy threefry of ``core/prng.py``, which reproduces the
reference's ``jax.random`` keys and bits, so the port sees the same
per-(request, token) network weather as the JAX package, bit for bit.
Every engine of the reference draws its weather under ``jax.jit``, so
the arrival is computed as XLA compiles ``base + jitter * normal``
(``prng.normal_affine``).  The "device"
names mirror the reference's batched entry points; here they run in
numpy on the host (a handful of scalars per request).

``FaultModel`` turns the link from slow into lossy or down with the same
keying: token (rid, step)'s reply is LOST iff the uniform draw of the
key fold_in(fold_in(key(seed), rid), step) is below ``loss_rate``, and
the link is in an OUTAGE at every step where (step + offset) % period <
len, a seeded phase shared by every row.  The per-row circuit breaker
flips a row that failed ``breaker_n`` times in a row to SLM-only
(degraded) decode for ``breaker_m`` steps, then probes the cloud once.
``breaker_step`` is its scalar recurrence (the host mirror) and
``breaker_transition_device`` the same recurrence on (B,) tensors, the
update the macro step's graph and the speculative burst carry.
"""
from __future__ import annotations

import random
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import prng


@dataclass
class LatencyModel:
    rtt_ms: float = 50.0
    jitter_ms: float = 5.0
    cloud_compute_ms: float = 20.0
    edge_compute_ms: float = 65.0        # Jetson Orin NX (paper Fig. 16)
    seed: int = 0

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def cloud_logits_arrival_ms(self) -> float:
        """Time until the cloud LLM's logits are available at the edge
        (stateful stream — the rid-less legacy path)."""
        jitter = self._rng.gauss(0.0, self.jitter_ms)
        return max(0.0, self.rtt_ms + self.cloud_compute_ms + jitter)

    def arrival_device(self, rids, steps) -> np.ndarray:
        """Vectorised counter-based arrival draw: row i draws its jitter
        from the key fold_in(fold_in(key(seed), rids[i]), steps[i]).
        Returns (B,) float32 arrival times in ms."""
        rids = np.asarray(rids, np.int32)
        steps = np.asarray(steps, np.int32)
        k = prng.fold_in(prng.fold_in(prng.key(self.seed), rids), steps)
        base = np.float32(self.rtt_ms + self.cloud_compute_ms)
        return np.maximum(np.float32(0.0),
                          prng.normal_affine(k, self.jitter_ms, base))

    def token_latency_device(self, timeout_ms: float, rids, steps):
        """Batched Sec. IV-D decision: (lat_ms (B,) float32, cloud_used
        (B,) bool), regimes as ``token_latency_ms``."""
        arrival = self.arrival_device(rids, steps)
        edge = np.float32(self.edge_compute_ms)
        timeout = np.float32(timeout_ms)
        lat = np.where(arrival <= edge, edge,
                       np.where(arrival <= timeout, arrival,
                                np.maximum(edge, timeout)))
        return lat.astype(np.float32), arrival <= timeout

    def arrival_ms_at(self, rid: int, step: int) -> float:
        """The float32 arrival for one (rid, step), as a Python float."""
        return float(self.arrival_device([rid], [step])[0])

    def token_latency_ms(self, timeout_ms: float, rid: int | None = None,
                         step: int = 0) -> tuple[float, bool]:
        """Per-token end-to-end latency under parallel edge/cloud decode
        with the Sec. IV-D fallback.  Returns (latency_ms, cloud_used).
        Thresholds and returned constants are float32-quantised so the
        decisions and the recorded latencies match
        ``token_latency_device``."""
        edge = float(np.float32(self.edge_compute_ms))
        timeout = float(np.float32(timeout_ms))
        if rid is None:
            arrival = self.cloud_logits_arrival_ms()
        else:
            arrival = self.arrival_ms_at(rid, step)
        if arrival <= edge:
            return edge, True                            # fully masked
        if arrival <= timeout:
            return arrival, True                         # bounded wait
        return max(edge, timeout), False                 # fallback


@dataclass
class FaultModel:
    """Counter-based cloud-link fault weather and circuit-breaker policy.

    LOSS: token (rid, step) draws u uniform on [0, 1) from the key
    fold_in(fold_in(key(seed), rid), step); its cloud reply is dropped
    iff u < loss_rate (float32).  OUTAGE: with ``outage_period`` and
    ``outage_len`` > 0 the link is down at every step where (step +
    offset) % period < len, ``offset`` drawn once from ``seed``.
    BREAKER: ``breaker_n`` consecutive injected failures (lost or
    outage, never a plain timeout) flip a row to SLM-only decode for
    ``breaker_m`` steps, then one probe token re-attempts the cloud: a
    failed probe re-trips at once, a good one recovers the row."""
    loss_rate: float = 0.0
    outage_period: int = 0
    outage_len: int = 0
    seed: int = 0
    breaker_n: int = 3
    breaker_m: int = 4

    def __post_init__(self):
        if self.outage_period > 0 and self.outage_len > 0:
            self._offset = random.Random(self.seed).randrange(
                self.outage_period)
        else:
            self._offset = 0

    @property
    def offset(self) -> int:
        return self._offset

    def lost_device(self, rids, steps) -> np.ndarray:
        """(B,) bool per-token loss draws, keyed as ``LatencyModel.
        arrival_device`` keys its jitter, from the fault seed."""
        rids = np.asarray(rids, np.int32)
        steps = np.asarray(steps, np.int32)
        if self.loss_rate <= 0.0:
            return np.zeros(rids.shape, bool)
        k = prng.fold_in(prng.fold_in(prng.key(self.seed), rids), steps)
        return prng.uniform(k, 0.0, 1.0) < np.float32(self.loss_rate)

    def outage_device(self, steps) -> np.ndarray:
        """(B,) bool: True where the step falls in an outage window."""
        steps = np.asarray(steps, np.int32)
        if self.outage_period <= 0 or self.outage_len <= 0:
            return np.zeros(steps.shape, bool)
        phase = (steps + np.int32(self._offset)) % np.int32(
            self.outage_period)
        return phase < np.int32(self.outage_len)

    def faults_device(self, rids, steps):
        """(lost (B,) bool, outage (B,) bool) for a batch of tokens."""
        return self.lost_device(rids, steps), self.outage_device(steps)

    def lost_at(self, rid: int, step: int) -> bool:
        """``lost_device`` for one token."""
        return bool(self.lost_device([rid], [step])[0])

    def outage_at(self, step: int) -> bool:
        """The outage schedule at one step."""
        if self.outage_period <= 0 or self.outage_len <= 0:
            return False
        return (step + self._offset) % self.outage_period < self.outage_len


def breaker_step(fails: int, cooldown: int, active: bool, raw_fail: bool,
                 n: int, m: int):
    """The circuit breaker's scalar recurrence (the host mirror).

    State: ``fails`` (consecutive injected failures, held at n while the
    breaker is open so a failed probe re-trips at once) and
    ``cooldown`` (degraded steps left; > 0 decodes SLM-only).  Returns
    (fails', cooldown', degraded, attempt, fail, trip, recover).
    ``raw_fail`` is the injected fault alone (lost or outage), never a
    plain timeout; inactive rows are frozen."""
    degraded = active and cooldown > 0
    attempt = active and not degraded
    fail = attempt and raw_fail
    succ = attempt and not raw_fail
    f1 = fails + 1 if fail else (0 if succ else fails)
    trip = fail and f1 >= n
    recover = succ and fails >= n
    new_fails = n if trip else f1
    new_cooldown = m if trip else (cooldown - 1 if degraded else cooldown)
    return new_fails, new_cooldown, degraded, attempt, fail, trip, recover


def breaker_transition_device(fails: torch.Tensor, cooldown: torch.Tensor,
                              active: torch.Tensor, raw_fail: torch.Tensor,
                              n: int, m: int):
    """``breaker_step`` on (B,) int32 / bool tensors, term for term."""
    degraded = active & (cooldown > 0)
    attempt = active & ~degraded
    fail = attempt & raw_fail
    succ = attempt & ~raw_fail
    f1 = torch.where(fail, fails + 1, torch.where(succ, 0, fails))
    trip = fail & (f1 >= n)
    recover = succ & (fails >= n)
    new_fails = torch.where(trip, n, f1).to(fails.dtype)
    new_cooldown = torch.where(trip, m, torch.where(
        degraded, cooldown - 1, cooldown)).to(cooldown.dtype)
    return new_fails, new_cooldown, degraded, attempt, fail, trip, recover
