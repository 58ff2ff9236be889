"""Prompt-wise parameter-free MoE router — the port's copy of
``repro/core/router.py`` (paper Sec. IV-B, Eq. 8-11).

No trainable gate: each expert LoRA module carries a domain embedding
Γ(φ) (Eq. 9, the centroid of k public representative samples); at
inference the router embeds the prompt, takes cosine similarities
(Eq. 10) and a softmax (Eq. 11) to give the gate weights ω that the
model's merged-LoRA delta consumes (Eq. 8).  Host-side numpy, as in the
reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from repro_torch.core import embedding as E


@dataclass
class ExpertMeta:
    """A router-visible expert: its domain embedding and bank position."""
    name: str
    embedding: np.ndarray            # Γ(φ), Eq. 9
    bank_index: int                  # position in the stacked LoRA bank


def expert_embedding(representative_samples: Sequence[str]) -> np.ndarray:
    """Eq. 9: Γ(φ) = mean of the embeddings of k public samples."""
    return E.centroid(representative_samples)


class Router:
    def __init__(self, experts: List[ExpertMeta], temperature: float = 0.1):
        if not experts:
            raise ValueError("router needs at least one expert")
        self.experts = experts
        self.embs = np.stack([e.embedding for e in experts])
        self.temperature = temperature

    def gate_weights(self, prompt: str) -> np.ndarray:
        """ω = softmax(cos(Γ(x), Γ(φ_j)) / T), Eq. 10-11: (E,) float32
        ordered by bank_index."""
        g = E.embed_text(prompt)
        sims = self.embs @ g                         # embeddings unit-norm
        z = sims / self.temperature
        z = z - z.max()
        w = np.exp(z)
        w = w / w.sum()
        out = np.zeros(len(self.experts), np.float32)
        for e, wi in zip(self.experts, w):
            out[e.bank_index] = wi
        return out

    def gate_weights_batch(self, prompts: Sequence[str]) -> np.ndarray:
        return np.stack([self.gate_weights(p) for p in prompts])

    def top1(self, prompt: str) -> ExpertMeta:
        g = E.embed_text(prompt)
        return self.experts[int(np.argmax(self.embs @ g))]

    def add_expert(self, meta: ExpertMeta) -> None:
        """Plug-and-play expert addition (Sec. IV-B): no retraining."""
        self.experts.append(meta)
        self.embs = np.stack([e.embedding for e in self.experts])

    def remove_expert(self, name: str) -> None:
        self.experts = [e for e in self.experts if e.name != name]
        self.embs = np.stack([e.embedding for e in self.experts])
