"""K1: fused logit-level LLM-SLM fusion (Eq. 15 + Sec. IV-D mask).

``fuse_logits`` launches the CUDA kernel of ``csrc/fuse_logits.cu`` on a
CUDA tensor and runs ``fuse_logits_plain`` on a CPU tensor.  It replaces
the Pallas kernel ``repro/kernels/logit_fusion/kernel.py::fuse_logits``
with the same contract: (B, V) f32 or bf16 logits, w (B,), optional
arrived (B,) bool -> (B, V) f32 fused probabilities, w forced to 1 on
rows that did not arrive.  Like the Pallas wrapper, w is rounded to the
logits' dtype before use (the CUDA kernel rounds it itself).

The CUDA kernel splits each row over ``splitv_layout(B, V, SMs)`` chunks, a
stats pass and a write pass over one (chunks, B) grid;
``fuse_logits_splitv_model`` is that order of sums in plain PyTorch,
for the tests.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

_CTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
           ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
           ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_ENTRY = {torch.float32: "fuse_logits_f32", torch.bfloat16: "fuse_logits_bf16"}
CHUNK_ALIGN = 8            # values in 16 bytes of bf16
MAX_CHUNK = 256 * 32       # the kernel's threads x values a thread


def fuse_logits_plain(slm_logits: torch.Tensor, llm_logits: torch.Tensor,
                      w: torch.Tensor,
                      arrived: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    p_s = torch.softmax(slm_logits.float(), dim=-1)
    p_l = torch.softmax(llm_logits.float(), dim=-1)
    w = w.to(slm_logits.dtype).float()
    if arrived is not None:
        w = torch.where(arrived.bool(), w, torch.ones_like(w))
    w = w[:, None]
    return w * p_s + (1.0 - w) * p_l


@functools.lru_cache(maxsize=64)
def splitv_layout(b: int, v: int, sms: int):
    """(chunks, chunk length) of the CUDA kernel's split of a row, from
    B, V and the card's SM count alone: a chunk a multiple of
    CHUNK_ALIGN values and at most MAX_CHUNK, short enough that B x
    chunks makes two waves of ``sms`` CTAs where V has the values for
    it."""
    want = max(-(-2 * sms // b), -(-v // MAX_CHUNK))
    chunk = max(CHUNK_ALIGN, v // want // CHUNK_ALIGN * CHUNK_ALIGN)
    return -(-v // chunk), chunk


def fuse_logits_splitv_model(slm_logits, llm_logits, w, arrived, chunks):
    """The CUDA kernel's order of sums in plain float32 PyTorch (for the
    tests; no serving path calls it): V cut into ``chunks`` chunks of a
    CHUNK_ALIGN multiple (fewer when that leaves the last ones empty),
    per chunk m = max and l = sum exp(x - m), then M = max m_c and L =
    sum l_c exp(m_c - M) added in ascending chunk order, and w exp(s -
    M_s) (1 / L_s) + (1 - w) exp(l - M_l) (1 / L_l)."""
    v = slm_logits.shape[1]
    step = -(-(-(-v // chunks)) // CHUNK_ALIGN) * CHUNK_ALIGN
    w = w.to(slm_logits.dtype).float()
    if arrived is not None:
        w = torch.where(arrived.bool(), w, torch.ones_like(w))
    factors = []
    for z in (slm_logits.float(), llm_logits.float()):
        cut = z.split(step, 1)
        ms = [c.amax(1) for c in cut]
        big = torch.stack(ms, 1).amax(1)
        total = torch.zeros_like(big)
        for c, m in zip(cut, ms):
            total = total + torch.exp(c - m[:, None]).sum(1) \
                * torch.exp(m - big)
        factors.append((torch.exp(z - big[:, None]), 1.0 / total))
    (e_s, inv_s), (e_l, inv_l) = factors
    return (w * inv_s)[:, None] * e_s + ((1.0 - w) * inv_l)[:, None] * e_l


@functools.cache
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _lib():
    lib = build.load("fuse_logits")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = _CTYPES
        fn.restype = ctypes.c_int
    return lib


def fuse_logits(slm_logits: torch.Tensor, llm_logits: torch.Tensor,
                w: torch.Tensor,
                arrived: Optional[torch.Tensor] = None) -> torch.Tensor:
    """slm/llm logits (B, V), w (B,), arrived (B,) bool or None ->
    fused probabilities (B, V) float32."""
    if slm_logits.device.type == "cpu":
        return fuse_logits_plain(slm_logits, llm_logits, w, arrived)
    if slm_logits.device.type != "cuda":
        raise ValueError(f"fuse_logits: unsupported device "
                         f"{slm_logits.device}")
    if slm_logits.dim() != 2 or llm_logits.shape != slm_logits.shape:
        raise ValueError(f"fuse_logits: logits must both be (B, V), got "
                         f"{tuple(slm_logits.shape)} and "
                         f"{tuple(llm_logits.shape)}")
    if slm_logits.dtype not in _ENTRY or llm_logits.dtype != slm_logits.dtype:
        raise TypeError(f"fuse_logits: logits must share float32 or "
                        f"bfloat16, got {slm_logits.dtype} and "
                        f"{llm_logits.dtype}")
    b, v = slm_logits.shape
    if w.shape != (b,) or (arrived is not None and arrived.shape != (b,)):
        raise ValueError("fuse_logits: w and arrived must be (B,)")
    # the kernel reads f32 w and a bool arrived; the serving path passes
    # those, so neither conversion launches there
    if w.dtype != torch.float32:
        w = w.float()
    if arrived is not None and arrived.dtype != torch.bool:
        arrived = arrived.bool()
    dev = slm_logits.device
    for t in (llm_logits, w) + ((arrived,) if arrived is not None else ()):
        if t.device != dev:
            raise ValueError("fuse_logits: all inputs must be on one device")
    if not (slm_logits.is_contiguous() and llm_logits.is_contiguous()):
        raise ValueError("fuse_logits: logits must be contiguous")
    chunks, chunk = splitv_layout(b, v, sm_count(dev.index))
    out = torch.empty((b, v), dtype=torch.float32, device=dev)
    part = torch.empty((b, chunks, 4), dtype=torch.float32, device=dev)
    fn = getattr(_lib(), _ENTRY[slm_logits.dtype])
    rc = fn(slm_logits.data_ptr(), llm_logits.data_ptr(), w.data_ptr(),
            w.stride(0), None if arrived is None else arrived.data_ptr(),
            0 if arrived is None else arrived.stride(0), part.data_ptr(),
            out.data_ptr(), b, v, chunks, chunk,
            torch._C._cuda_getCurrentRawStream(dev.index))
    build.check(rc, "fuse_logits")
    fuse_logits.launches += 1
    return out


fuse_logits.launches = 0
