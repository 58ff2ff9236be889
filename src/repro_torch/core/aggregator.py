"""Task-specific router/aggregator — paper Sec. III-C; the port's copy of
``repro/core/aggregator.py`` (host-side numpy over the port's adapters).

Server side of a federated round: embed every uploaded LoRA module with
the domain-conditioned encoder E(φ) (Eq. 3 context), k-means cluster the
embeddings with the number of clusters M chosen per round by silhouette
score, average parameters within each cluster (Eq. 4), optionally with
staleness-aware exponential decay weights (Eq. 5) for asynchronous
cluster-wise updates.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import embedding as EMB
from repro_torch.core import lora as LORA


# ---------------------------------------------------------------------------
# E(φ): domain-conditioned encoder of an uploaded LoRA module
# ---------------------------------------------------------------------------


def encode_module(adapter: Dict[str, Any],
                  task_sample_texts: Optional[Sequence[str]] = None,
                  param_dim: int = 64) -> np.ndarray:
    """E(φ): [adaptation-semantics ; fine-tuning-dynamics] embedding.

    The semantics half comes from the client's *non-private representative*
    task description/samples (what the paper's encoder conditions on);
    the dynamics half is a fixed random projection of the parameter update
    itself (captures what the adapter actually learned)."""
    return encode_modules([adapter], [task_sample_texts], param_dim)[0]


def encode_modules(adapters: Sequence[Dict[str, Any]],
                   task_sample_texts: Sequence[Optional[Sequence[str]]],
                   param_dim: int = 64) -> np.ndarray:
    """``encode_module`` of each (adapter, texts) pair, stacked (N, D):
    the dynamics halves come from one pass of the random projection
    (``LORA.adapter_vectors``), each equal to ``encode_module``'s bit for
    bit."""
    dyns = LORA.adapter_vectors(list(adapters), dim=param_dim)
    out = []
    for dyn, texts in zip(dyns, task_sample_texts):
        sem = EMB.centroid(texts) if texts else np.zeros(EMB.DIM,
                                                         np.float32)
        v = np.concatenate([sem, dyn])
        n = np.linalg.norm(v)
        out.append(v / n if n > 0 else v)
    return np.stack(out)


def similarity(e_i: np.ndarray, e_j: np.ndarray) -> float:
    """Eq. 3: s_ij = cos(E(φ_i), E(φ_j))."""
    return float(EMB.cosine(e_i, e_j))


# ---------------------------------------------------------------------------
# k-means + silhouette (numpy; N is tens of clients, not millions)
# ---------------------------------------------------------------------------


def kmeans(x: np.ndarray, k: int, iters: int = 50,
           seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    n = x.shape[0]
    rng = np.random.RandomState(seed)
    # k-means++ seeding
    centers = [x[rng.randint(n)]]
    for _ in range(1, k):
        d2 = np.min(
            [((x - c) ** 2).sum(1) for c in centers], axis=0)
        p = d2 / max(d2.sum(), 1e-12)
        centers.append(x[rng.choice(n, p=p)])
    c = np.stack(centers)
    labels = np.zeros(n, np.int64)
    for _ in range(iters):
        d = ((x[:, None, :] - c[None]) ** 2).sum(-1)
        new = d.argmin(1)
        if (new == labels).all():
            break
        labels = new
        for j in range(k):
            pts = x[labels == j]
            if len(pts):
                c[j] = pts.mean(0)
    return labels, c


def silhouette_score(x: np.ndarray, labels: np.ndarray) -> float:
    n = x.shape[0]
    uniq = np.unique(labels)
    if len(uniq) < 2 or n <= len(uniq):
        return -1.0
    d = np.sqrt(((x[:, None, :] - x[None]) ** 2).sum(-1))
    s = np.zeros(n)
    for i in range(n):
        same = labels == labels[i]
        same[i] = False
        a = d[i, same].mean() if same.any() else 0.0
        b = math.inf
        for j in uniq:
            if j == labels[i]:
                continue
            other = labels == j
            if other.any():
                b = min(b, d[i, other].mean())
        s[i] = 0.0 if max(a, b) == 0 else (b - a) / max(a, b)
    return float(s.mean())


def cluster_modules(embeddings: np.ndarray,
                    k_range: Optional[Sequence[int]] = None,
                    seed: int = 0) -> Tuple[np.ndarray, int, float]:
    """Choose M per round by silhouette (Sec. III-C).  Returns
    (labels, M, score)."""
    n = embeddings.shape[0]
    if n == 1:
        return np.zeros(1, np.int64), 1, 1.0
    k_range = k_range or range(2, min(n, 9))
    best = (None, 1, -2.0)
    for k in k_range:
        labels, _ = kmeans(embeddings, k, seed=seed)
        sc = silhouette_score(embeddings, labels)
        if sc > best[2]:
            best = (labels, k, sc)
    if best[0] is None:
        return np.zeros(n, np.int64), 1, -1.0
    return best


# ---------------------------------------------------------------------------
# Aggregation (Eq. 4 sync / Eq. 5 async staleness-aware)
# ---------------------------------------------------------------------------


@dataclass
class ClusterResult:
    experts: List[Dict[str, Any]]            # aggregated LoRA per cluster
    labels: np.ndarray
    num_clusters: int
    silhouette: float


def aggregate_clustered(adapters: List[Dict[str, Any]],
                        embeddings: np.ndarray,
                        k_range: Optional[Sequence[int]] = None,
                        staleness: Optional[Sequence[float]] = None,
                        beta: float = 0.5,
                        seed: int = 0) -> ClusterResult:
    """Full server step: cluster by E(φ), aggregate per cluster.

    staleness[i] = τ_i (time lag of client i); None -> synchronous Eq. 4.
    """
    labels, m, sc = cluster_modules(embeddings, k_range, seed)
    experts = []
    for j in range(m):
        idx = [i for i in range(len(adapters)) if labels[i] == j]
        if not idx:
            continue
        members = [adapters[i] for i in idx]
        if staleness is None:
            agg = LORA.average_adapters(members)                 # Eq. 4
        else:
            w = [math.exp(-beta * staleness[i]) for i in idx]    # Eq. 5
            agg = LORA.average_adapters(members, w)
        experts.append(agg)
    return ClusterResult(experts, labels, len(experts), sc)


def async_update_cluster(current: Dict[str, Any], incoming: Dict[str, Any],
                         staleness: float, beta: float = 0.5
                         ) -> Dict[str, Any]:
    """Cluster-wise asynchronous update (Sec. III-C): fold one late client
    into its cluster center with exp(-β τ) influence."""
    w = math.exp(-beta * staleness)
    return LORA.average_adapters([current, incoming], [1.0, w])
