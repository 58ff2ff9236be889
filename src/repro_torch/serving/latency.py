"""Network / device latency model for the serving simulation — the port
of ``LatencyModel`` in ``repro/serving/latency.py``.

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
"""
from __future__ import annotations

import random
from dataclasses import dataclass

import numpy as np

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
