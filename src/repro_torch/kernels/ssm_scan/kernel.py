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

Training (``ssm_scan_train``, the ``SsmScanFn`` autograd function): the
forward is K6 with ``chunk_states=True``, which also returns the state
entering every chunk of CHUNK_STATE steps, (B, ceil(S / CHUNK_STATE),
di, N) float32 (written through the kernel's optional pointer; serving
calls pass it null and keep their bits); the backward is K10
(``ssm_scan_bwd``, ``csrc/ssm_scan_bwd.cu``, no Pallas original: the
reference differentiates its jnp chunked scan, ``repro/models/ssm.py:
81-109``), which recomputes each chunk's states from the saved one and
returns d(dt), dx, dB, dC and, when ``a`` takes a gradient, dA.
``ssm_scan_bwd_plain`` is the same recurrence written out backwards in
plain PyTorch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

STATES = (8, 16)           # falcon-mamba-7b and its reduced config
STATES_PER_LANE = 4
LOG2E = 1.4426950408889634
# steps between the states K6 saves for K10 (a multiple of K6's staged
# rows, 32 or 64)
CHUNK_STATE = 64
_CTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 5 + (
    ctypes.c_longlong,) * 4 + (ctypes.c_void_p,)
_BWD_CTYPES = (ctypes.c_void_p,) * 13 + (ctypes.c_int,) * 5 + (
    ctypes.c_longlong,) * 4 + (ctypes.c_void_p,)


def n_chunk_states(s: int) -> int:
    """Chunk states of an S-step scan: ceil(S / CHUNK_STATE)."""
    return -(-s // CHUNK_STATE)


def ssm_scan_plain(dt, x, bm, cm, a, chunk_states: bool = False):
    """The kernel's function in plain PyTorch: the step-by-step float32
    recurrence (the port of ``ssm_scan/ref.py``).  With ``chunk_states``
    also the state entering each chunk of CHUNK_STATE steps."""
    b, s, di = x.shape
    h = torch.zeros((b, di, bm.shape[-1]), dtype=torch.float32,
                    device=x.device)
    a = a.float()
    ys, hc = [], []
    for t in range(s):
        if chunk_states and t % CHUNK_STATE == 0:
            hc.append(h)
        dt_t, x_t = dt[:, t].float(), x[:, t].float()
        da = torch.exp(dt_t[..., None] * a[None])
        h = da * h + (dt_t * x_t)[..., None] * bm[:, t, None, :].float()
        ys.append((h * cm[:, t, None, :].float()).sum(-1))
    y = torch.stack(ys, 1).to(x.dtype)
    return (y, h, torch.stack(hc, 1)) if chunk_states else (y, h)


def ssm_scan_bwd_plain(dt, x, bm, cm, a, dy, need_da: bool = True):
    """K10's function in plain float32 PyTorch: the forward states, then
    g_t = dy_t C_t + a_{t+1} g_{t+1} backwards, with a_t = exp(dt_t A):
    dx_t = dt_t Σ_n g_t B_t, d(dt)_t = Σ_n a_t g_t A h_{t-1} + x_t Σ_n
    g_t B_t, dB_t = Σ_d g_t dt_t x_t, dC_t = Σ_d dy_t h_t, dA = Σ_{b,t}
    a_t g_t dt_t h_{t-1}.  Returns (d(dt) f32, dx in x's dtype, dB, dC in
    bm's and cm's, dA f32 or None)."""
    b, s, di = x.shape
    af = a.float()
    dtf, xf, dyf = dt.float(), x.float(), dy.float()
    bf, cf = bm.float(), cm.float()
    dec = torch.exp(dtf[..., None] * af)                  # (B, S, di, N)
    h = torch.zeros_like(dec[:, 0])
    hs = [h]                                              # h_{t-1}, h_t..
    for t in range(s):
        h = dec[:, t] * h + (dtf[:, t] * xf[:, t])[..., None]             * bf[:, t, None, :]
        hs.append(h)
    ddt, dx = torch.empty_like(dtf), torch.empty_like(xf)
    dbm, dcm = torch.empty_like(bf), torch.empty_like(cf)
    da = torch.zeros_like(af)
    carry = torch.zeros_like(h)
    for t in reversed(range(s)):
        g = dyf[:, t, :, None] * cf[:, t, None, :] + carry
        carry = dec[:, t] * g
        gb = (g * bf[:, t, None, :]).sum(-1)
        ddt[:, t] = (carry * af * hs[t]).sum(-1) + xf[:, t] * gb
        dx[:, t] = dtf[:, t] * gb
        dbm[:, t] = (g * (dtf[:, t] * xf[:, t])[..., None]).sum(1)
        dcm[:, t] = (dyf[:, t, :, None] * hs[t + 1]).sum(1)
        if need_da:
            da += (carry * dtf[:, t, :, None] * hs[t]).sum(0)
    return (ddt, dx.to(x.dtype), dbm.to(bm.dtype), dcm.to(cm.dtype),
            da if need_da else None)


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


@functools.cache
def _bwd_lib():
    lib = build.load("ssm_scan_bwd")
    for fn in (lib.ssm_scan_bwd_f32, lib.ssm_scan_bwd_bf16):
        fn.argtypes = _BWD_CTYPES
        fn.restype = ctypes.c_int
    lib.ssm_scan_bwd_scratch.argtypes = (ctypes.c_int,) * 5
    lib.ssm_scan_bwd_scratch.restype = ctypes.c_longlong
    return lib


def _check_cuda(name, dt, x, bm, cm, a):
    """Raise unless the CUDA kernels take these inputs (K6's contract)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    n = bm.shape[2]
    if n not in STATES:
        raise ValueError(f"{name}: the CUDA kernel takes N in {STATES}, "
                         f"got {n}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"{name}: dt and a must be float32, got "
                        f"{dt.dtype}/{a.dtype}")
    if x.dtype not in (torch.bfloat16, torch.float32) \
            or not (x.dtype == bm.dtype == cm.dtype):
        raise TypeError(f"{name}: x, bm and cm must share bf16 or f32, "
                        f"got {x.dtype}/{bm.dtype}/{cm.dtype}")
    if any(t.device != x.device for t in (dt, bm, cm, a)):
        raise ValueError(f"{name}: all inputs must be on one device")
    if not (dt.is_contiguous() and x.is_contiguous() and a.is_contiguous()):
        raise ValueError(f"{name}: dt, x and a must be contiguous")
    if bm.stride(2) != 1 or cm.stride(2) != 1:
        raise ValueError(f"{name}: bm and cm need unit stride over N")


def ssm_scan(dt, x, bm, cm, a, chunk_states: bool = False):
    """dt/x (B, S, di); bm/cm (B, S, N); a (di, N) -> (y (B, S, di) in
    x's dtype, h_final (B, di, N) float32), and with ``chunk_states`` the
    states entering each chunk, (B, n_chunk_states(S), di, N) float32."""
    if x.dim() != 3 or dt.shape != x.shape or bm.dim() != 3 \
            or cm.shape != bm.shape or bm.shape[:2] != x.shape[:2] \
            or a.shape != (x.shape[2], bm.shape[2]) or x.shape[1] < 1:
        raise ValueError(f"ssm_scan: dt/x must be (B, S >= 1, di), bm/cm "
                         f"(B, S, N) and a (di, N); got dt "
                         f"{tuple(dt.shape)}, x {tuple(x.shape)}, bm "
                         f"{tuple(bm.shape)}, cm {tuple(cm.shape)}, a "
                         f"{tuple(a.shape)}")
    if x.device.type == "cpu":
        return ssm_scan_plain(dt, x, bm, cm, a, chunk_states)
    _check_cuda("ssm_scan", dt, x, bm, cm, a)
    b, s, di = x.shape
    n = bm.shape[2]
    y = torch.empty_like(x)
    h = torch.empty((b, di, n), dtype=torch.float32, device=x.device)
    hc = torch.empty((b, n_chunk_states(s), di, n), dtype=torch.float32,
                     device=x.device) if chunk_states else None
    fn = _lib().ssm_scan_bf16 if x.dtype == torch.bfloat16 \
        else _lib().ssm_scan_f32
    rc = fn(dt.data_ptr(), x.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            a.data_ptr(), y.data_ptr(), h.data_ptr(),
            None if hc is None else hc.data_ptr(), CHUNK_STATE, b, s, di, n,
            bm.stride(0), bm.stride(1), cm.stride(0), cm.stride(1),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "ssm_scan")
    ssm_scan.launches += 1
    return (y, h, hc) if chunk_states else (y, h)


def ssm_scan_bwd(dt, x, bm, cm, a, dy, hc, need_da: bool = True):
    """K10: the gradients of ``ssm_scan``'s y from dy (B, S, di), given
    the forward's inputs and its chunk states ``hc`` (``chunk_states=
    True``): (d(dt) (B, S, di) f32, dx in x's dtype, dB and dC (B, S, N)
    contiguous in bm's dtype, dA (di, N) f32 or None without
    ``need_da``).  On CUDA it launches the kernels of
    ``csrc/ssm_scan_bwd.cu`` or raises; on the CPU it runs
    ``ssm_scan_bwd_plain``."""
    if dy.shape != x.shape:
        raise ValueError(f"ssm_scan_bwd: dy {tuple(dy.shape)} must match x "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return ssm_scan_bwd_plain(dt, x, bm, cm, a, dy, need_da)
    _check_cuda("ssm_scan_bwd", dt, x, bm, cm, a)
    b, s, di = x.shape
    n = bm.shape[2]
    if hc.shape != (b, n_chunk_states(s), di, n) \
            or hc.dtype != torch.float32 or not hc.is_contiguous() \
            or hc.device != x.device:
        raise ValueError(f"ssm_scan_bwd: chunk states {tuple(hc.shape)} "
                         f"{hc.dtype} do not fit the scan")
    dy = dy.to(x.dtype).contiguous()
    lib = _bwd_lib()
    scratch = torch.empty(lib.ssm_scan_bwd_scratch(b, s, di, n,
                                                   int(need_da)),
                          dtype=torch.float32, device=x.device)
    ddt = torch.empty_like(dt)
    dx = torch.empty_like(x)
    dbm = torch.empty((b, s, n), dtype=bm.dtype, device=x.device)
    dcm = torch.empty((b, s, n), dtype=cm.dtype, device=x.device)
    da = torch.empty_like(a) if need_da else None
    fn = lib.ssm_scan_bwd_bf16 if x.dtype == torch.bfloat16 \
        else lib.ssm_scan_bwd_f32
    rc = fn(dt.data_ptr(), x.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            a.data_ptr(), dy.data_ptr(), hc.data_ptr(), ddt.data_ptr(),
            dx.data_ptr(), dbm.data_ptr(), dcm.data_ptr(),
            None if da is None else da.data_ptr(), scratch.data_ptr(), b, s,
            di, n, CHUNK_STATE, bm.stride(0), bm.stride(1), cm.stride(0),
            cm.stride(1), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "ssm_scan_bwd")
    ssm_scan_bwd.launches += 1
    return ddt, dx, dbm, dcm, da


class SsmScanFn(torch.autograd.Function):
    """The selective scan's y with a gradient: K6 forward (saving its
    chunk states), K10 backward; with ``plain`` the plain versions of
    both, on any device (the yardstick of a step through the kernels)."""

    @staticmethod
    def forward(ctx, dt, x, bm, cm, a, plain):
        if plain:
            y, _ = ssm_scan_plain(dt, x, bm, cm, a)
            ctx.save_for_backward(dt, x, bm, cm, a)
        else:
            y, _, hc = ssm_scan(dt, x, bm, cm, a, chunk_states=True)
            ctx.save_for_backward(dt, x, bm, cm, a, hc)
        ctx.plain = plain
        return y

    @staticmethod
    def backward(ctx, dy):
        need_da = ctx.needs_input_grad[4]
        if ctx.plain:
            grads = ssm_scan_bwd_plain(*ctx.saved_tensors, dy, need_da)
        else:
            dt, x, bm, cm, a, hc = ctx.saved_tensors
            grads = ssm_scan_bwd(dt, x, bm, cm, a, dy, hc, need_da)
        return grads + (None,)


def ssm_scan_train(dt, x, bm, cm, a):
    """``ssm_scan``'s y (B, S, di), differentiable in every input through
    K6 and K10 (the plain versions on a CPU tensor)."""
    return SsmScanFn.apply(dt, x, bm, cm, a, False)


def ssm_scan_train_plain(dt, x, bm, cm, a):
    """``ssm_scan_train`` through the plain versions on any device."""
    return SsmScanFn.apply(dt, x, bm, cm, a, True)


ssm_scan.launches = 0
ssm_scan_bwd.launches = 0
