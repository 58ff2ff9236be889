"""K7: keyed sampling from the fused distribution, with the greedy
argmax beside it.

``sample_fused`` launches the CUDA kernel of ``csrc/sample_fused.cu``
on a CUDA tensor and runs ``sample_fused_plain`` on a CPU tensor.  The
reference has no Pallas kernel here: it samples in jnp
(``repro/kernels/logit_fusion/ops.py::_categorical_rows``), row i
drawing ``jax.random.categorical(fold_in(fold_in(key(seed),
key_ids[i]), steps[i]), log(max(p_i, 1e-9)))``.  Both versions give that
draw bit for bit: the Gumbel noise is jax's (threefry-2x32 over the
partitionable counters, ``-log(-log(u))``) and every ``log`` is XLA's
CPU one (``core/prng.py``), so the drawn ids and the perturbed scores
of the kernel equal the plain version's and, on the same probabilities,
the reference's.

Contract: probs (B, V) float32, greedy (B,) bool or None (every row
draws), key_ids and steps (B,) integers (taken modulo 2**32, as JAX
reads int32 fold-in data), seed a Python int (``jax.random.key(seed)``
keeps its low 32 bits) -> (B,) int64 ids: the first index of the max of
p on greedy rows, the drawn id elsewhere.  ``scores=True`` also returns
the (B, V) float32 perturbed scores ``log(max(p, 1e-9)) + gumbel``
(tests and the chip smoke test only).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.kernels import build
from repro_torch.kernels.logit_fusion.kernel import sm_count

_CTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint,
           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p, ctypes.c_void_p)
THREADS = 256
MIN_CHUNK = 4 * THREADS
CLIP = np.float32(1e-9)


def _host(a) -> np.ndarray:
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def sample_fused_plain(probs: torch.Tensor, greedy, key_ids, steps,
                       seed: int, scores: bool = False):
    """The kernel's function on the host, in numpy (``core/prng.py``):
    the ids (and scores) as tensors on ``probs``' device."""
    p = probs.detach().to("cpu", torch.float32).numpy()
    k = prng.fold_in(prng.fold_in(prng.key(int(seed)), _host(key_ids)),
                     _host(steps))
    s = (prng.log(np.maximum(p, CLIP))
         + prng.gumbel(k, p.shape[1])).astype(np.float32)
    ids = np.argmax(s, axis=1)
    if greedy is not None:
        ids = np.where(_host(greedy).astype(bool), np.argmax(p, axis=1),
                       ids)
    out = torch.from_numpy(ids.astype(np.int64)).to(probs.device)
    if scores:
        return out, torch.from_numpy(s).to(probs.device)
    return out


def sample_layout(b: int, v: int, sms: int):
    """(chunks, chunk length) of the kernel's split of a row, from B, V
    and the card's SM count alone: B x chunks near four CTAs an SM, a
    chunk at least MIN_CHUNK values."""
    want = max(1, -(-4 * sms // b))
    chunk = max(MIN_CHUNK, -(-v // want))
    return -(-v // chunk), chunk


@functools.cache
def _lib():
    lib = build.load("sample_fused")
    lib.sample_fused.argtypes = _CTYPES
    lib.sample_fused.restype = ctypes.c_int
    return lib


def _row_ints(t: torch.Tensor, b: int, dev, what: str) -> torch.Tensor:
    if not isinstance(t, torch.Tensor) or t.device != dev \
            or t.shape != (b,):
        raise ValueError(f"sample_fused: {what} must be a (B,) tensor on "
                         f"{dev}")
    if t.dtype == torch.int32:
        return t.contiguous()
    if t.dtype != torch.int64:
        raise TypeError(f"sample_fused: {what} must be integers, got "
                        f"{t.dtype}")
    return t.to(torch.int32)


def sample_fused(probs: torch.Tensor, greedy, key_ids, steps, seed: int,
                 scores: bool = False):
    """probs (B, V) f32, greedy (B,) bool or None, key_ids and steps (B,)
    int -> (B,) int64 ids (and the (B, V) scores with ``scores=True``)."""
    if probs.device.type == "cpu":
        return sample_fused_plain(probs, greedy, key_ids, steps, seed,
                                  scores)
    if probs.device.type != "cuda":
        raise ValueError(f"sample_fused: unsupported device {probs.device}")
    if probs.dim() != 2 or probs.dtype != torch.float32 \
            or not probs.is_contiguous():
        raise ValueError(f"sample_fused: probs must be a contiguous (B, V) "
                         f"float32 tensor, got {tuple(probs.shape)} "
                         f"{probs.dtype}")
    b, v = probs.shape
    dev = probs.device
    key_ids = _row_ints(key_ids, b, dev, "key_ids")
    steps = _row_ints(steps, b, dev, "steps")
    if greedy is not None:
        if not isinstance(greedy, torch.Tensor) or greedy.device != dev \
                or greedy.shape != (b,):
            raise ValueError(f"sample_fused: greedy must be a (B,) tensor "
                             f"on {dev}")
        greedy = greedy.contiguous() if greedy.dtype == torch.bool \
            else greedy.bool()
    chunks, chunk = sample_layout(b, v, sm_count(dev.index))
    hi, lo = (int(w) for w in prng.key(int(seed)))
    out = torch.empty((b,), dtype=torch.int64, device=dev)
    part = torch.empty((b, chunks, 4), dtype=torch.int32, device=dev)
    sc = (torch.empty((b, v), dtype=torch.float32, device=dev) if scores
          else None)
    rc = _lib().sample_fused(
        probs.data_ptr(), b, v, key_ids.data_ptr(), steps.data_ptr(),
        None if greedy is None else greedy.data_ptr(), hi, lo,
        None if sc is None else sc.data_ptr(), part.data_ptr(), chunks,
        chunk, out.data_ptr(), torch._C._cuda_getCurrentRawStream(dev.index))
    build.check(rc, "sample_fused")
    sample_fused.launches += 1
    if scores:
        return out, sc
    return out


sample_fused.launches = 0
