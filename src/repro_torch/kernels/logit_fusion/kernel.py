"""K1: fused logit-level LLM-SLM fusion (Eq. 15 + Sec. IV-D mask).

``fuse_logits`` launches the CUDA kernel of ``csrc/fuse_logits.cu`` on a
CUDA tensor and runs ``fuse_logits_plain`` on a CPU tensor.  It replaces
the Pallas kernel ``repro/kernels/logit_fusion/kernel.py::fuse_logits``
with the same contract: (B, V) f32 or bf16 logits, w (B,), optional
arrived (B,) bool -> (B, V) f32 fused probabilities, w forced to 1 on
rows that did not arrive.  Like the Pallas wrapper, w is rounded to the
logits' dtype before use.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

_CTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p)
_ENTRY = {torch.float32: "fuse_logits_f32", torch.bfloat16: "fuse_logits_bf16"}


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
    dev = slm_logits.device
    for t in (llm_logits, w) + ((arrived,) if arrived is not None else ()):
        if t.device != dev:
            raise ValueError("fuse_logits: all inputs must be on one device")
    if not (slm_logits.is_contiguous() and llm_logits.is_contiguous()):
        raise ValueError("fuse_logits: logits must be contiguous")
    w32 = w.to(slm_logits.dtype).float().contiguous()
    a32 = (torch.ones(b, dtype=torch.int32, device=dev) if arrived is None
           else arrived.to(torch.int32).contiguous())
    out = torch.empty((b, v), dtype=torch.float32, device=dev)
    fn = getattr(_lib(), _ENTRY[slm_logits.dtype])
    rc = fn(slm_logits.data_ptr(), llm_logits.data_ptr(), w32.data_ptr(),
            a32.data_ptr(), out.data_ptr(), b, v,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "fuse_logits")
    fuse_logits.launches += 1
    return out


fuse_logits.launches = 0
