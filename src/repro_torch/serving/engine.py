"""Hybrid LLM-SLM serving engine — the sequential path of
``repro/serving/engine.py`` (``HybridEngine.generate``).

Pipeline per request (paper Fig. 8):
  1. Privacy detector (Alg. 2): sensitive -> SLM-only, never leaves the
     device.
  2. Prefill of the SLM and, for cloud-eligible prompts, the LLM.
  3. Token loop: both models decode; their logits are fused per
     Eq. 14-15 (K1); if the cloud misses the timeout the fusion weight
     is forced to w = 1 (Sec. IV-D fallback).

The port serves greedy decoding without router, adapters or fault
injection; keyed sampling, the batched engines and the fault path are
later slices.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.privacy import PrivacyDetector
from repro_torch.data import tokenizer as TOK
from repro_torch.serving.deployment import ServingDeployment


@dataclass
class GenStats:
    tokens: int = 0
    cloud_tokens: int = 0
    fallback_tokens: int = 0
    private: bool = False
    latency_ms: List[float] = field(default_factory=list)
    fusion_w: List[float] = field(default_factory=list)
    # the prompt was cut to fit the context budget
    truncated: bool = False
    degraded_tokens: int = 0
    cloud_lost: int = 0
    # cloud DISPATCHES (one per cloud-eligible token on this path)
    cloud_calls: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    # cancelled at a token boundary because the simulated clock passed
    # the request's deadline — the text is partial
    cancelled: bool = False
    # running simulated decode clock (sum of latency_ms)
    clock_ms: float = 0.0

    @property
    def mean_latency_ms(self) -> float:
        return float(np.mean(self.latency_ms)) if self.latency_ms else 0.0

    def push_latency(self, lat_ms: float):
        self.latency_ms.append(lat_ms)
        self.clock_ms += lat_ms


@dataclass
class _Slot:
    """Host-side bookkeeping for one request being decoded (the batched
    engine of a later slice keeps one per lane row)."""
    stats: GenStats
    out_ids: List[int] = field(default_factory=list)


class HybridEngine:
    """Floe inference engine pairing an edge SLM with a cloud LLM."""

    def __init__(self, deployment: ServingDeployment):
        if deployment.llm is None or deployment.mlp is None:
            raise ValueError("HybridEngine needs a hybrid deployment (llm + "
                             "alignment mlp)")
        self.dep = deployment
        self.slm_params = deployment.slm_params
        self.llm_params = deployment.llm_params
        self.detector = PrivacyDetector()
        self.latency = deployment.latency
        self.timeout_ms = deployment.timeout_ms
        self.max_seq = deployment.max_seq

    @torch.inference_mode()
    def generate(self, prompt: str, max_new_tokens: int = 16,
                 greedy: bool = True, rid: Optional[int] = None,
                 deadline_ms: Optional[float] = None
                 ) -> Tuple[str, GenStats]:
        """``rid``, when given, keys the latency draws per (request,
        token), order-independently; without it they come from the
        latency model's stateful stream.  ``deadline_ms`` bounds the
        simulated decode clock: token t is emitted iff the clock after
        token t-1 is still under it."""
        if not greedy:
            raise NotImplementedError("sampling: later slice")
        dep = self.dep
        stats = GenStats()
        stats.private = self.detector.detect(prompt)

        raw = TOK.encode(prompt + " ")
        cap = self.max_seq - max_new_tokens - 1
        stats.truncated = len(raw) > cap
        toks = dep.tokens(raw[:cap])
        s_logits, s_cache = dep.slm_prefill(self.slm_params, toks)
        use_cloud = not stats.private
        if use_cloud:
            l_logits, l_cache = dep.llm_prefill(self.llm_params, toks)

        sl = s_logits[:, 0]
        ll = l_logits[:, 0] if use_cloud else None
        lat_row = ok_row = None
        if use_cloud and rid is not None:
            lat_row, ok_row = dep.lat_request(rid, np.arange(max_new_tokens))
        slot = _Slot(stats)
        for _ in range(max_new_tokens):
            if deadline_ms is not None and stats.clock_ms >= deadline_ms:
                stats.cancelled = True
                break
            step = len(slot.out_ids)
            if use_cloud:
                if lat_row is not None:
                    lat_ms, arrived = float(lat_row[step]), bool(ok_row[step])
                else:        # rid-less path: stateful host stream
                    lat_ms, arrived = self.latency.token_latency_ms(
                        self.timeout_ms, rid=rid, step=step)
                p_out, w = dep.fuse(sl, ll, arrived)
                stats.cloud_tokens += int(arrived)
                stats.fallback_tokens += int(not arrived)
                stats.cloud_calls += 1
            else:
                lat_ms = self.latency.edge_compute_ms
                p_out = torch.softmax(sl.float(), dim=-1)
                w = torch.ones(1)
            stats.push_latency(float(lat_ms))
            stats.fusion_w.append(float(w[0]))

            nxt = int(torch.argmax(p_out[0]))
            slot.out_ids.append(nxt)
            stats.tokens += 1
            if nxt == TOK.EOS:
                break
            t = dep.tokens([nxt])
            s_logits, s_cache = dep.slm_decode(self.slm_params, s_cache, t)
            sl = s_logits[:, 0]
            if use_cloud:
                l_logits, l_cache = dep.llm_decode(self.llm_params, l_cache,
                                                   t)
                ll = l_logits[:, 0]
        return TOK.decode(slot.out_ids), stats
