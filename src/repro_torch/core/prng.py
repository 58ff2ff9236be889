"""Counter-based threefry-2x32 in numpy, reproducing ``jax.random``.

The reference keys its network weather by
``fold_in(fold_in(key(seed), rid), step)`` and draws one scalar
``jax.random.normal`` per (request, token)
(``repro/serving/latency.py:72-98``).  This module rebuilds those bits
without JAX, vectorised over arrays of (rid, step), following jax
0.9.0 with ``jax_threefry_partitionable`` on (its default):

* ``key(seed)``: the raw key is (seed >> 32, seed & 0xFFFFFFFF) — for a
  32-bit seed, (0, seed).
* ``fold_in(key, d)``: ``threefry2x32(key, (0, uint32(d)))``, both output
  words forming the new key.
* scalar random bits: ``threefry2x32(key, (0, 0))``, the two output
  words xor-ed (the partitionable iota of shape () is zero).
* ``uniform``: the top 23 bits as the mantissa of a float in [1, 2),
  minus 1, scaled into [lo, hi) and clamped at lo.
* ``normal``: ``sqrt(2) * erf_inv(u)`` with u uniform on
  (nextafter(-1, 0), 1), ``erf_inv`` being XLA's single-precision
  polynomial (M. Giles, "Approximating the erfinv function").

The threefry bits, keys and uniforms are bit-exact.  ``erf_inv`` takes
``log1p`` from numpy, which is correctly rounded, where XLA's CPU
``log1p`` is a polynomial of its own; so about one normal in twenty
differs from JAX's in the last one to three ulps (see
``tests/test_torch_prng.py``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

Key = Tuple[np.ndarray, np.ndarray]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32 = np.float32


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1, x2) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block function (20 rounds) on uint32 arrays."""
    k1 = np.asarray(k1, np.uint32)
    k2 = np.asarray(k2, np.uint32)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = np.asarray(x1, np.uint32) + ks[0]
        x1_ = np.asarray(x2, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1_
                x1_ = _rotl(x1_, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1_ = x1_ + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1_


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` for a seed that fits in 32 bits."""
    return np.uint32(0), np.uint32(seed & 0xFFFFFFFF)


def fold_in(k: Key, data) -> Key:
    """``jax.random.fold_in`` vectorised over ``data`` (int32 values are
    reinterpreted as uint32, as JAX does)."""
    d = np.asarray(data).astype(np.int64).astype(np.uint32)
    return threefry2x32(k[0], k[1], np.zeros_like(d), d)


def bits32(k: Key) -> np.ndarray:
    """``jax.random.bits(k, (), uint32)`` for each key."""
    b1, b2 = threefry2x32(k[0], k[1], np.zeros_like(k[0]),
                          np.zeros_like(k[0]))
    return b1 ^ b2


def uniform(k: Key, lo, hi) -> np.ndarray:
    """Scalar ``jax.random.uniform(k, (), float32, lo, hi)`` per key."""
    lo, hi = _F32(lo), _F32(hi)
    fb = (bits32(k) >> np.uint32(32 - 23)) | np.array(1.0, _F32).view(
        np.uint32)
    floats = fb.view(_F32) - _F32(1.0)
    return np.maximum(lo, floats * (hi - lo) + lo)


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """Single-precision inverse error function, XLA's polynomial."""
    x = np.asarray(x, _F32)
    w = -np.log1p(-x * x)
    lt = w < _F32(5.0)
    w = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3.0)).astype(_F32)
    p = np.where(lt, _F32(_ERFINV_LT5[0]), _F32(_ERFINV_GE5[0])).astype(_F32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = (np.where(lt, _F32(a), _F32(b)).astype(_F32) + p * w).astype(_F32)
    out = p * x
    with np.errstate(over="ignore"):
        edge = x * np.finfo(_F32).max
    return np.where(np.abs(x) == _F32(1.0), edge, out).astype(_F32)


def normal(k: Key) -> np.ndarray:
    """Scalar ``jax.random.normal(k)`` (float32) per key."""
    lo = np.nextafter(_F32(-1.0), _F32(0.0), dtype=_F32)
    u = uniform(k, lo, _F32(1.0))
    return (_F32(np.sqrt(2)) * erf_inv(u)).astype(_F32)
