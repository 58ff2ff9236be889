"""K6: the Mamba-1 selective scan, the prefill scan of the SSM family.

``ssm_scan`` launches the CUDA kernel of ``csrc/ssm_scan.cu`` on a CUDA
tensor and runs ``ssm_scan_plain`` on a CPU tensor.  It replaces the
Pallas kernel ``repro/kernels/ssm_scan/kernel.py::ssm_scan``:
h_t = exp(dt_t·A) ⊙ h_{t−1} + (dt_t·x_t)·B_t from h_0 = 0, and
y_t = Σ_N C_t ⊙ h_t, with dt (B, S, di) float32, x (B, S, di), bm/cm
(B, S, N) and a (di, N) float32 -> (y (B, S, di) in x's dtype,
h_final (B, di, N) float32).

The CUDA kernel takes x, bm and cm (and returns y) in one type, bf16 or
f32, N in {8, 16}, and any S and di: the Pallas kernel's chunk
and block sizes are a TPU tiling detail.  dt and x must be contiguous.
bm and cm are passed in place with their batch and sequence strides
(unit stride over N), since the model hands over column slices of
``x_proj``'s output; no copy is made.  The kernel forms the decay as
exp2(dt · A log2 e) and sums y over lanes of four states each;
``ssm_scan_lanes_model`` is that arithmetic in plain PyTorch, for the
tests.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

STATES = (8, 16)           # falcon-mamba-7b and its reduced config
STATES_PER_LANE = 4
LOG2E = 1.4426950408889634
_CTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 4 + (
    ctypes.c_longlong,) * 4 + (ctypes.c_void_p,)


def ssm_scan_plain(dt, x, bm, cm, a):
    """The kernel's function in plain PyTorch: the step-by-step float32
    recurrence (the port of ``ssm_scan/ref.py``)."""
    b, s, di = x.shape
    h = torch.zeros((b, di, bm.shape[-1]), dtype=torch.float32,
                    device=x.device)
    a = a.float()
    ys = []
    for t in range(s):
        dt_t, x_t = dt[:, t].float(), x[:, t].float()
        da = torch.exp(dt_t[..., None] * a[None])
        h = da * h + (dt_t * x_t)[..., None] * bm[:, t, None, :].float()
        ys.append((h * cm[:, t, None, :].float()).sum(-1))
    return torch.stack(ys, 1).to(x.dtype), h


def ssm_scan_lanes_model(dt, x, bm, cm, a):
    """The CUDA kernel's order of operations in plain float32 PyTorch
    (for the tests; no serving path calls it), up to the rounding its
    fused multiply-adds save: the decay exp2(dt · a2) with a2 = A log2 e
    rounded once, h = decay · h + (dt · x) · B, then a partial P_q of
    h · C over each lane's STATES_PER_LANE consecutive states in state
    order, and y = (P0 + P2) + (P1 + P3) at N = 16, P0 + P1 at N = 8."""
    b, s, di = x.shape
    n = bm.shape[-1]
    h = torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
    a2 = a.float() * LOG2E
    ys = []
    for t in range(s):
        dt_t = dt[:, t].float()
        dx = dt_t * x[:, t].float()
        h = torch.exp2(dt_t[..., None] * a2) * h \
            + dx[..., None] * bm[:, t, None, :].float()
        hc = (h * cm[:, t, None, :].float()).unflatten(
            -1, (n // STATES_PER_LANE, STATES_PER_LANE))
        p = hc[..., 0]
        for j in range(1, STATES_PER_LANE):
            p = p + hc[..., j]
        y = p[..., 0] + p[..., 1] if n == 8 \
            else (p[..., 0] + p[..., 2]) + (p[..., 1] + p[..., 3])
        ys.append(y)
    return torch.stack(ys, 1).to(x.dtype), h


@functools.cache
def _lib():
    lib = build.load("ssm_scan")
    for fn in (lib.ssm_scan_f32, lib.ssm_scan_bf16):
        fn.argtypes = _CTYPES
        fn.restype = ctypes.c_int
    return lib


def ssm_scan(dt, x, bm, cm, a):
    """dt/x (B, S, di); bm/cm (B, S, N); a (di, N) -> (y (B, S, di) in
    x's dtype, h_final (B, di, N) float32)."""
    if x.dim() != 3 or dt.shape != x.shape or bm.dim() != 3 \
            or cm.shape != bm.shape or bm.shape[:2] != x.shape[:2] \
            or a.shape != (x.shape[2], bm.shape[2]) or x.shape[1] < 1:
        raise ValueError(f"ssm_scan: dt/x must be (B, S >= 1, di), bm/cm "
                         f"(B, S, N) and a (di, N); got dt "
                         f"{tuple(dt.shape)}, x {tuple(x.shape)}, bm "
                         f"{tuple(bm.shape)}, cm {tuple(cm.shape)}, a "
                         f"{tuple(a.shape)}")
    if x.device.type == "cpu":
        return ssm_scan_plain(dt, x, bm, cm, a)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan: unsupported device {x.device}")
    b, s, di = x.shape
    n = bm.shape[2]
    if n not in STATES:
        raise ValueError(f"ssm_scan: the CUDA kernel takes N in {STATES}, "
                         f"got {n}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"ssm_scan: dt and a must be float32, got "
                        f"{dt.dtype}/{a.dtype}")
    if x.dtype not in (torch.bfloat16, torch.float32) \
            or not (x.dtype == bm.dtype == cm.dtype):
        raise TypeError(f"ssm_scan: x, bm and cm must share bf16 or f32, "
                        f"got {x.dtype}/{bm.dtype}/{cm.dtype}")
    if any(t.device != x.device for t in (dt, bm, cm, a)):
        raise ValueError("ssm_scan: all inputs must be on one device")
    if not (dt.is_contiguous() and x.is_contiguous() and a.is_contiguous()):
        raise ValueError("ssm_scan: dt, x and a must be contiguous")
    if bm.stride(2) != 1 or cm.stride(2) != 1:
        raise ValueError("ssm_scan: bm and cm need unit stride over N")
    y = torch.empty_like(x)
    h = torch.empty((b, di, n), dtype=torch.float32, device=x.device)
    fn = _lib().ssm_scan_bf16 if x.dtype == torch.bfloat16 \
        else _lib().ssm_scan_f32
    rc = fn(dt.data_ptr(), x.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            a.data_ptr(), y.data_ptr(), h.data_ptr(), b, s, di, n,
            bm.stride(0), bm.stride(1), cm.stride(0), cm.stride(1),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "ssm_scan")
    ssm_scan.launches += 1
    return y, h


ssm_scan.launches = 0
