"""Deterministic sentence encoder Γ — the port's copy of ``repro/core/embedding.py`` (BGE stand-in).

The paper uses BGE [60] to embed prompts (router, Eq. 10), expert domains
(Eq. 9) and privacy centroids (Alg. 2).  On this box we cannot ship BGE
weights, so Γ is a *hashed bag-of-features* encoder: signed feature
hashing of word unigrams/bigrams + character trigrams, log-scaled and
L2-normalised.  It is deterministic across processes (hashlib, not
Python's salted ``hash``), captures lexical/task similarity well enough
to reproduce the paper's routing/clustering *behaviours*, and runs in
microseconds (the paper's sub-ms budget).
"""
from __future__ import annotations

import hashlib
import re
from typing import Iterable, List

import numpy as np

DIM = 256
_token_re = re.compile(r"[a-z0-9]+")


def _h(feature: str) -> int:
    return int.from_bytes(hashlib.md5(feature.encode()).digest()[:8], "little")


def _features(text: str) -> List[str]:
    text = text.lower()
    words = _token_re.findall(text)
    feats = [f"w:{w}" for w in words]
    feats += [f"b:{a}_{b}" for a, b in zip(words, words[1:])]
    compact = " ".join(words)
    feats += [f"c:{compact[i:i+3]}" for i in range(len(compact) - 2)]
    return feats


def embed_text(text: str, dim: int = DIM) -> np.ndarray:
    """Γ(x): deterministic unit-norm embedding of a prompt."""
    v = np.zeros(dim, np.float32)
    for f in _features(text):
        h = _h(f)
        idx = h % dim
        sign = 1.0 if (h >> 63) & 1 else -1.0
        v[idx] += sign
    v = np.sign(v) * np.log1p(np.abs(v))
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def embed_texts(texts: Iterable[str], dim: int = DIM) -> np.ndarray:
    return np.stack([embed_text(t, dim) for t in texts])


def centroid(texts: Iterable[str], dim: int = DIM) -> np.ndarray:
    """Mean of embeddings, renormalised — Eq. 9 (expert/domain centroid)."""
    m = embed_texts(texts, dim).mean(0)
    n = np.linalg.norm(m)
    return m / n if n > 0 else m


def cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a / (np.linalg.norm(a, axis=-1, keepdims=True) + 1e-9)
    b = b / (np.linalg.norm(b, axis=-1, keepdims=True) + 1e-9)
    return a @ b.T if a.ndim == b.ndim == 2 else (a * b).sum(-1)
