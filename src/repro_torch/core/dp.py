"""Configurable local differential privacy (paper Sec. III-B, DP-SGD) —
the port of ``repro/core/dp.py``.

g̃ = clip(g, C) + N(0, σ²C²I) — standard DP-SGD [67], applied to the
client's LoRA update before upload.  Trees are nested dicts of tensors
(leaves in the reference's sorted-key order, ``core/tree.py``).  The
noise is drawn on the host with the port's numpy threefry
(``core/prng.py``), one split key per leaf, as ``jax.random.normal``
draws it, so a key gives the reference's noise bit for bit; it is then
copied to the leaf's device.  A moments-style accountant approximation
is provided for budget reporting.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core import tree as T


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of their f32 sums of squares, the
    leaves added one after the other as the reference adds them."""
    total = None
    for x in T.leaves(tree):
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(tree, clip: float):
    n = global_norm(tree)
    scale = torch.clamp(clip / torch.clamp(n, min=1e-12), max=1.0)
    return T.map_tree(lambda x: (x * scale).to(x.dtype), tree), n


def noise(key: prng.Key, shapes, std: float):
    """The f32 noise ``std * jax.random.normal(k_i, shape_i)`` for each
    shape, k_i the i-th key of ``split(key, len(shapes))``, as host
    arrays."""
    keys = prng.split(key, max(1, len(shapes)))
    return [np.float32(std) * prng.normal(prng.key_at(keys, i), shape)
            for i, shape in enumerate(shapes)]


def privatize(tree, key: prng.Key, clip: float, noise_multiplier: float):
    """Clip to C and add N(0, (σC)² I) — returns (noised_tree,
    pre_clip_norm).  ``key`` is a ``core/prng`` key."""
    clipped, n = clip_by_global_norm(tree, clip)
    leaves = T.leaves(clipped)
    draws = noise(key, [tuple(x.shape) for x in leaves],
                  noise_multiplier * clip)
    noised = [(x.float() + torch.from_numpy(z).to(x.device)).to(x.dtype)
              for x, z in zip(leaves, draws)]
    return T.unflatten(clipped, noised), n


def epsilon_estimate(noise_multiplier: float, steps: int,
                     sampling_rate: float = 1.0,
                     delta: float = 1e-5) -> float:
    """Strong-composition style estimate (reporting only, not a proof):
    ε ≈ q·sqrt(2·T·ln(1/δ)) / σ."""
    if noise_multiplier <= 0:
        return math.inf
    return sampling_rate * math.sqrt(2.0 * steps * math.log(1.0 / delta)) \
        / noise_multiplier
