"""Counter-based threefry-2x32 in numpy, reproducing ``jax.random``.

The reference keys its network weather by
``fold_in(fold_in(key(seed), rid), step)`` and draws one scalar
``jax.random.normal`` per (request, token)
(``repro/serving/latency.py:72-98``); it keys its sampling the same
way and draws one Gumbel vector over the vocabulary per (request,
token) (``repro/kernels/logit_fusion/ops.py:117-125``).  This module
rebuilds those bits without JAX, vectorised over arrays of (rid,
step), following jax 0.9.0 with ``jax_threefry_partitionable`` on (its
default):

* ``key(seed)``: the raw key is (seed >> 32, seed & 0xFFFFFFFF) — for a
  32-bit seed, (0, seed).
* ``fold_in(key, d)``: ``threefry2x32(key, (0, uint32(d)))``, both output
  words forming the new key.
* ``split(key, n)``: key j of the n is ``threefry2x32(key, (0, j))`` (the
  partitionable split counts over a 2x32 iota), which is
  ``fold_in(key, j)``.
* scalar random bits: ``threefry2x32(key, (0, 0))``, the two output
  words xor-ed (the partitionable iota of shape () is zero).
* random bits over a shape (``jax.random.bits``, the threefry PRNG's
  ``threefry_random_bits`` with partitionable counters): element j of
  the flattened shape is ``threefry2x32(key, (0, j))`` with the two
  output words xor-ed (``iota_2x32_shape`` gives the high and low words
  of j, and j < 2**32 here).
* ``uniform``: the top 23 bits as the mantissa of a float in [1, 2),
  minus 1, scaled into [lo, hi) and clamped at lo.
* ``gumbel`` (``jax.random._gumbel``, mode "low", the default):
  ``-log(-log(u))`` with u uniform on [tiny, 1), both logs XLA's.
* ``normal`` (scalar, or over a shape): ``sqrt(2) * erf_inv(u)`` with u
  uniform on
  (nextafter(-1, 0), 1), ``erf_inv`` being XLA's single-precision
  polynomial (M. Giles, "Approximating the erfinv function").

Every step is bit-exact against ``jax.random`` on the CPU, the normals
included: ``erf_inv`` is computed as XLA's CPU code computes it, with
fused multiply-adds where LLVM contracts them and XLA's own ``log1p``
(the Cephes rational branch for |a| < sqrt(2) - 1, else ``log(1 + a)``
through XLA's Cephes-derived CPU ``log``).  An f32 fused multiply-add
is emulated as ``float32(float64(a) * float64(b) + float64(c))``: the
product of two f32 values is exact in f64, and a check over every f32
input of ``log1p`` in (-1, 0] and every uniform ``erf_inv`` can be
given found no double-rounding case.  XLA's CPU code reads subnormal
inputs as zero, and so does this one.
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


def split(k: Key, n: int = 2) -> Key:
    """``jax.random.split(k, n)`` of one key: the n keys as two (n,)
    word arrays; key j is ``(out[0][j], out[1][j])``."""
    return fold_in(k, np.arange(n, dtype=np.int64))


def key_at(keys: Key, j: int) -> Key:
    """Key j of a ``split``."""
    return keys[0][j], keys[1][j]


def bits32(k: Key) -> np.ndarray:
    """``jax.random.bits(k, (), uint32)`` for each key."""
    b1, b2 = threefry2x32(k[0], k[1], np.zeros_like(k[0]),
                          np.zeros_like(k[0]))
    return b1 ^ b2


def random_bits(k: Key, shape) -> np.ndarray:
    """``jax.random.bits(k, shape, uint32)`` for each key of a batch of
    keys: the result has the keys' shape followed by ``shape``."""
    shape = tuple(int(n) for n in np.atleast_1d(shape))
    n = int(np.prod(shape))
    if n >= 2 ** 32:
        raise ValueError("random_bits: at most 2**32 - 1 values a key")
    k1 = np.asarray(k[0], np.uint32)[..., None]
    k2 = np.asarray(k[1], np.uint32)[..., None]
    j = np.arange(n, dtype=np.uint32)
    b1, b2 = threefry2x32(k1, k2, np.zeros_like(j), j)
    return (b1 ^ b2).reshape(k1.shape[:-1] + shape)


def _bits_to_uniform(bits, lo, hi) -> np.ndarray:
    lo, hi = _F32(lo), _F32(hi)
    fb = (bits >> np.uint32(32 - 23)) | np.array(1.0, _F32).view(
        np.uint32)
    floats = fb.view(_F32) - _F32(1.0)
    return np.maximum(lo, floats * (hi - lo) + lo)


def uniform(k: Key, lo, hi) -> np.ndarray:
    """Scalar ``jax.random.uniform(k, (), float32, lo, hi)`` per key."""
    return _bits_to_uniform(bits32(k), lo, hi)


def uniform_array(k: Key, shape, lo, hi) -> np.ndarray:
    """``jax.random.uniform(k, shape, float32, lo, hi)`` for each key of
    a batch of keys (shaped as ``random_bits``)."""
    return _bits_to_uniform(random_bits(k, shape), lo, hi)


def gumbel(k: Key, shape) -> np.ndarray:
    """``jax.random.gumbel(k, shape)`` (float32, mode "low") for each key
    of a batch of keys: ``-log(-log(u))``, u uniform on [tiny, 1)."""
    u = uniform_array(k, shape, np.finfo(_F32).tiny, 1.0)
    return -log(-log(u))


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# log1p's rational branch (Cephes, as XLA's elemental EmitLog1p has it),
# highest degree first
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
# XLA's CPU f32 log (Cephes, via Eigen's plog)
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c with one rounding (see the module note)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def _mul(a, b) -> np.ndarray:
    return (np.asarray(a, _F32) * np.asarray(b, _F32)).astype(_F32)


def _daz(x: np.ndarray) -> np.ndarray:
    """XLA's CPU code runs with denormals-are-zero: a subnormal input
    reads as a zero of its sign."""
    return np.where(np.abs(x) < np.finfo(_F32).tiny, x * _F32(0.0), x)


def log(x) -> np.ndarray:
    """XLA's CPU float32 ``log``: frexp into [sqrt(1/2), sqrt(2)), a
    degree-8 polynomial in three fused-multiply-add chains, and the
    exponent added back as e * (q1 + q2)."""
    x = _daz(np.asarray(x, _F32))
    m, e = np.frexp(np.maximum(x, np.finfo(_F32).tiny))
    m, e = m.astype(_F32), e.astype(_F32)
    small = m < _F32(0.707106781186547524)
    e = (e - small.astype(_F32)).astype(_F32)
    r = ((m - _F32(1.0)) + np.where(small, m, _F32(0.0))).astype(_F32)
    r2 = _mul(r, r)
    r3 = _mul(r2, r)
    p = [_F32(c) for c in _LOG_P]
    y = _fma(_fma(p[0], r, p[1]), r, p[2])
    y1 = _fma(_fma(p[3], r, p[4]), r, p[5])
    y2 = _fma(_fma(p[6], r, p[7]), r, p[8])
    y = _fma(_fma(y, r3, y1), r3, y2)
    y = _fma(y, r3, _mul(_F32(_LOG_Q1), e))
    out = (_fma(_F32(-0.5), r2, r) + y).astype(_F32)
    out = _fma(_F32(_LOG_Q2), e, out)
    with np.errstate(invalid="ignore"):
        out = np.where(x < 0, _F32(np.nan), out)
    return np.where(x == 0, _F32(-np.inf),
                    np.where(np.isposinf(x), x, out)).astype(_F32)


def log1p(a) -> np.ndarray:
    """XLA's ``log1p``: for |a| < sqrt(2) - 1 the Cephes rational
    approximation (fused-multiply-add Horner steps), else
    ``log(1 + a)``."""
    a = _daz(np.asarray(a, _F32))
    num = np.zeros_like(a)
    den = np.zeros_like(a)
    for c in _LOG1P_NUM:
        num = _fma(num, a, _F32(c))
    for c in _LOG1P_DEN:
        den = _fma(den, a, _F32(c))
    with np.errstate(all="ignore"):
        ratio = (num.astype(np.float64) / den).astype(_F32)
    a2 = _mul(a, a)
    tail = _fma(_F32(-0.5), a2, _mul(_mul(a, a2), ratio))
    small = (a + tail).astype(_F32)
    with np.errstate(all="ignore"):
        large = log((a + _F32(1.0)).astype(_F32))
    return np.where(np.abs(a) < _F32(0.41421356237309504880), small,
                    large).astype(_F32)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """Single-precision inverse error function, as XLA's CPU code
    computes it (its polynomial, its ``log1p``, fused Horner steps)."""
    x = np.asarray(x, _F32)
    w = -log1p(-_mul(x, x))
    lt = w < _F32(5.0)
    w = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3.0)).astype(_F32)
    p = np.where(lt, _F32(_ERFINV_LT5[0]), _F32(_ERFINV_GE5[0])).astype(_F32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, _F32(a), _F32(b)))
    out = _mul(p, x)
    with np.errstate(over="ignore"):
        edge = x * np.finfo(_F32).max
    return np.where(np.abs(x) == _F32(1.0), edge, out).astype(_F32)


def _erf_inv_uniform(k: Key, shape=None) -> np.ndarray:
    lo = np.nextafter(_F32(-1.0), _F32(0.0), dtype=_F32)
    u = uniform(k, lo, _F32(1.0)) if shape is None \
        else uniform_array(k, shape, lo, _F32(1.0))
    return erf_inv(u)


# values of one key's large draw computed at a time: the element-wise
# steps (threefry, erf_inv's float64 fused steps) then run on arrays that
# stay in the CPU's caches; each value is the same whatever the chunk
_CHUNK = 1 << 16


def normal(k: Key, shape=None) -> np.ndarray:
    """``jax.random.normal(k)`` (float32): a scalar per key, or with
    ``shape`` ``jax.random.normal(k, shape)`` for each key (shaped as
    ``random_bits``).  One key's draw of more than _CHUNK values is
    computed a chunk of counters at a time."""
    n = 0 if shape is None else int(np.prod(shape))
    if np.ndim(k[0]) or n <= _CHUNK:
        return (_F32(np.sqrt(2)) * _erf_inv_uniform(k, shape)).astype(_F32)
    if n >= 2 ** 32:
        raise ValueError("random_bits: at most 2**32 - 1 values a key")
    lo = np.nextafter(_F32(-1.0), _F32(0.0), dtype=_F32)
    k1, k2 = np.uint32(k[0]), np.uint32(k[1])
    out = np.empty(n, _F32)
    for i in range(0, n, _CHUNK):
        j = np.arange(i, min(n, i + _CHUNK), dtype=np.uint32)
        b1, b2 = threefry2x32(k1, k2, np.zeros_like(j), j)
        u = _bits_to_uniform(b1 ^ b2, lo, _F32(1.0))
        out[i:i + j.size] = (_F32(np.sqrt(2)) * erf_inv(u)).astype(_F32)
    return out.reshape(tuple(int(d) for d in np.atleast_1d(shape)))


def normal_affine(k: Key, scale, offset) -> np.ndarray:
    """``offset + scale * jax.random.normal(k)`` in float32 as XLA
    compiles it under ``jax.jit``: the simplifier folds ``scale *
    sqrt(2)`` into one float32 constant and LLVM contracts the add into
    a fused multiply-add, fma(f32(scale * sqrt(2)), erf_inv(u), offset).
    (Evaluated op by op, outside ``jit``, the same expression rounds
    differently in a few percent of draws.)"""
    c = _F32(_F32(scale) * _F32(np.sqrt(2)))
    return _fma(c, _erf_inv_uniform(k), _F32(offset))
