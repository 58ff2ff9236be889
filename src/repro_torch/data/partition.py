"""Non-IID data partitioning across federated clients — the port's copy
of ``repro/data/partition.py``.

LDA/Dirichlet partition (paper Sec. II-B2: α ∈ {0.5, 0.3, 0.1} for
Non-IID levels 1-3): each client's task mixture is drawn from
Dirichlet(α) over the task set; smaller α -> more skewed clients.
"""
from __future__ import annotations

import random
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.data.tasks import Example, sample_task


def dirichlet_task_mixtures(num_clients: int, tasks: Sequence[str],
                            alpha: float, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return rng.dirichlet([alpha] * len(tasks), size=num_clients)


def partition_clients(num_clients: int, tasks: Sequence[str],
                      examples_per_client: int, alpha: float = 0.3,
                      seed: int = 0) -> List[List[Example]]:
    """Per-client datasets with Dirichlet task skew."""
    mix = dirichlet_task_mixtures(num_clients, tasks, alpha, seed)
    out = []
    for ci in range(num_clients):
        rng = random.Random(seed * 7_919 + ci)
        nrng = np.random.RandomState(seed * 31 + ci)
        picks = nrng.choice(len(tasks), size=examples_per_client, p=mix[ci])
        out.append([sample_task(tasks[t], rng) for t in picks])
    return out


def dominant_task(dataset: List[Example]) -> str:
    counts: Dict[str, int] = {}
    for ex in dataset:
        counts[ex.task] = counts.get(ex.task, 0) + 1
    return max(counts, key=counts.get)
