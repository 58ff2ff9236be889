"""Federated server (paper Fig. 6 stage ④ + Sec. III-C) — the port of
``repro/federated/server.py``.

Collects client LoRA modules, embeds them with E(φ), clusters with
silhouette-selected k-means, aggregates per cluster (Eq. 4 / Eq. 5), and
publishes (expert bank, router metadata) for the inference phase.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import aggregator as AGG
from repro_torch.core import lora as LORA
from repro_torch.core.router import ExpertMeta, Router, expert_embedding
from repro_torch.federated.client import ClientUpdate


@dataclass
class ServerState:
    experts: List[Dict[str, Any]] = field(default_factory=list)
    expert_tasks: List[List[str]] = field(default_factory=list)
    global_adapter: Optional[Dict[str, Any]] = None
    history: List[Dict] = field(default_factory=list)


class FloeServer:
    def __init__(self, beta: float = 0.5, async_mode: bool = False,
                 seed: int = 0):
        self.state = ServerState()
        self.beta = beta
        self.async_mode = async_mode
        self.seed = seed

    # ------------------------------------------------------------ round
    def aggregate_round(self, updates: List[ClientUpdate]) -> ServerState:
        if not updates:
            return self.state
        adapters = [u.adapter for u in updates]
        embs = AGG.encode_modules([u.adapter for u in updates],
                                  [u.task_samples for u in updates])
        staleness = [u.staleness for u in updates] if self.async_mode else None
        res = AGG.aggregate_clustered(adapters, embs, staleness=staleness,
                                      beta=self.beta, seed=self.seed)
        # collect per-cluster public task samples for Γ(φ) (Eq. 9)
        tasks: List[List[str]] = [[] for _ in range(res.num_clusters)]
        remap = {}
        uniq = sorted(set(res.labels.tolist()))
        for new_j, old_j in enumerate(uniq):
            remap[old_j] = new_j
        for u, lbl in zip(updates, res.labels):
            tasks[remap[int(lbl)]].extend(u.task_samples)
        self.state.experts = res.experts
        self.state.expert_tasks = tasks
        self.state.global_adapter = LORA.average_adapters(adapters)
        self.state.history.append({
            "clients": len(updates),
            "clusters": res.num_clusters,
            "silhouette": res.silhouette,
            "mean_rank": float(np.mean([u.rank for u in updates])),
            "mean_loss": float(np.mean([u.local_loss for u in updates])),
        })
        return self.state

    # ---------------------------------------------------------- publish
    def expert_bank(self) -> Dict[str, Any]:
        """The published bank: the experts stacked on the expert axis,
        which the serving deployment takes as its ``expert_bank``."""
        if not self.state.experts:
            raise RuntimeError("no aggregation round has run")
        return LORA.stack_adapters(self.state.experts)

    def router(self, temperature: float = 0.1) -> Router:
        metas = [
            ExpertMeta(name=f"expert-{j}",
                       embedding=expert_embedding(samples or ["generic task"]),
                       bank_index=j)
            for j, samples in enumerate(self.state.expert_tasks)
        ]
        # name experts by their dominant sample word for interpretability
        for m, samples in zip(metas, self.state.expert_tasks):
            if samples:
                m.name = samples[0].split(":")[0].split()[0]
        return Router(metas, temperature)
