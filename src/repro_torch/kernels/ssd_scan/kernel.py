"""K11: the Mamba-2 / SSD scan, the prefill scan of zamba2's Mamba-2
layers.

``ssd_scan`` launches the CUDA kernel of ``csrc/ssd_scan.cu`` on a CUDA
tensor and runs ``ssd_scan_plain`` on a CPU tensor.  It has no Pallas
original: the reference computes the SSD scan in jnp as a loop over
256-step chunks (``repro/models/ssm.py:171-189`` ``_ssd_chunk``, driven
at ``:228-240``), and ``ssd_scan_plain`` is a direct port of that loop.
The function, per head h of P channels and N states:
h_t = exp(dt_t·a_h)·h_{t−1} + dt_t·x_t ⊗ B_t from h_0 = 0 and
y_t = h_t · C_t, with x (B, S, H, P), bm/cm (B, S, G, N) (head h reads
group h // (H / G)), dt (B, S, H) float32 and a (H,) float32 ->
(y (B, S, H, P) float32 without the D skip, h_final (B, H, P, N)
float32).

The CUDA kernel computes the recurrence step by step rather than the
chunk form; the two agree to f32 rounding.  It takes x, bm and cm in one
type, bf16 or f32, N in {8, 64} (zamba2-7b's state and its reduced
one), any S, H and P.  x, bm and cm are read in place with their batch
and sequence strides, since the model hands over column slices of the
causal conv's output: x needs a head stride of P and a unit stride over
P, bm and cm a group stride of N and a unit stride over N.  dt and a
must be contiguous.

Training (``ssd_scan_train``, the ``SsdScanFn`` autograd function): on
a CUDA tensor the forward is K11 with ``chunk_states=True``, which also
returns the state entering every chunk of CHUNK_STATE steps, (B,
ceil(S / CHUNK_STATE), H, P, N) float32 (written through the kernel's
optional pointer; serving calls pass it null and keep their bits); the
backward is K12 (``ssd_scan_bwd``, ``csrc/ssd_scan_bwd.cu``, no Pallas
original: the reference differentiates its jnp chunk loop), which
recomputes each chunk's states from the saved one and returns dx, dB,
dC, d(dt) and, when ``a`` takes a gradient, da.  On a CPU tensor
``ssd_scan_train`` differentiates ``ssd_scan_plain`` under autograd, and
``ssd_scan_bwd_plain`` is that gradient; ``ssd_scan_train_plain`` takes
that route on any device.  ``ssd_chunk_states_plain`` is the chunk
states' plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

STATES = (8, 64)            # zamba2-7b's state size and its reduced one
# the reference's mamba2_block default chunk
CHUNK = 256
# steps between the states K11 saves for K12
CHUNK_STATE = 64
_CTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 6 + (
    ctypes.c_longlong,) * 6 + (ctypes.c_void_p,)
_BWD_CTYPES = (ctypes.c_void_p,) * 13 + (ctypes.c_int,) * 6 + (
    ctypes.c_longlong,) * 6 + (ctypes.c_void_p,)


def n_chunk_states(s: int) -> int:
    """Chunk states of an S-step scan: ceil(S / CHUNK_STATE)."""
    return -(-s // CHUNK_STATE)


def _ssd_chunk(xh, bh, ch, logdec, dt, h0):
    """One SSD chunk, the reference's ``_ssd_chunk`` in torch: xh (B, c,
    H, P); bh/ch (B, c, H, N); logdec/dt (B, c, H); h0 (B, H, P, N).
    Returns (y (B, c, H, P), h_out)."""
    lcum = torch.cumsum(logdec, dim=1)                         # (B, c, H)
    # inter-chunk: the contribution of the incoming state
    y_inter = torch.einsum("bhpn,bchn,bch->bchp", h0, ch, torch.exp(lcum))
    # intra-chunk: the causal decay matrix form
    dmat = lcum[:, :, None, :] - lcum[:, None, :, :]           # (B, c, c, H)
    c = dmat.shape[1]
    cmask = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                  device=dmat.device))
    dmat = torch.where(cmask[None, :, :, None], dmat,
                       torch.full_like(dmat, -torch.inf))
    m = torch.einsum("bchn,bshn->bcsh", ch, bh) * torch.exp(dmat) \
        * dt[:, None, :, :]                                    # (B, c, c, H)
    y_intra = torch.einsum("bcsh,bshp->bchp", m, xh)
    # state update
    l_last = lcum[:, -1:, :]                                   # (B, 1, H)
    w = torch.exp(l_last - lcum) * dt                          # (B, c, H)
    h_out = h0 * torch.exp(l_last)[:, 0, :, None, None] + \
        torch.einsum("bch,bchp,bchn->bhpn", w, xh, bh)
    return y_inter + y_intra, h_out


def ssd_scan_plain(x, bm, cm, dt, a, chunk: int = CHUNK):
    """The scan in plain PyTorch: the reference's chunk loop over
    ``_ssd_chunk`` (chunk ``min(chunk, S)``, S a multiple of it), in
    float32 from h_0 = 0.  Differentiable under autograd."""
    b, s, nh, hp = x.shape
    g, n = bm.shape[2], bm.shape[3]
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"ssd_scan_plain: S = {s} is no multiple of its "
                         f"chunk {c}")
    xh = x.float()
    bh = bm.float().repeat_interleave(nh // g, dim=2)
    ch = cm.float().repeat_interleave(nh // g, dim=2)
    dtf = dt.float()
    logdec = dtf * a.float()
    h = torch.zeros((b, nh, hp, n), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(s // c):
        sl = slice(i * c, (i + 1) * c)
        y_c, h = _ssd_chunk(xh[:, sl], bh[:, sl], ch[:, sl], logdec[:, sl],
                            dtf[:, sl], h)
        ys.append(y_c)
    return torch.cat(ys, dim=1), h


def ssd_chunk_states_plain(x, bm, cm, dt, a):
    """The state entering each chunk of CHUNK_STATE steps, (B,
    n_chunk_states(S), H, P, N) float32: the reference's ``_ssd_chunk``
    run over chunks of CHUNK_STATE steps (the last one ragged) from h_0 =
    0, each chunk's incoming state kept."""
    b, s, nh, hp = x.shape
    g, n = bm.shape[2], bm.shape[3]
    xh = x.float()
    bh = bm.float().repeat_interleave(nh // g, dim=2)
    ch = cm.float().repeat_interleave(nh // g, dim=2)
    dtf = dt.float()
    logdec = dtf * a.float()
    h = torch.zeros((b, nh, hp, n), dtype=torch.float32, device=x.device)
    out = []
    for i in range(n_chunk_states(s)):
        out.append(h)
        sl = slice(i * CHUNK_STATE, (i + 1) * CHUNK_STATE)
        _, h = _ssd_chunk(xh[:, sl], bh[:, sl], ch[:, sl], logdec[:, sl],
                          dtf[:, sl], h)
    return torch.stack(out, 1)


def ssd_scan_bwd_plain(x, bm, cm, dt, a, dy, need_da: bool = True):
    """K12's function in plain PyTorch: the gradients of
    ``ssd_scan_plain``'s y from dy (B, S, H, P), by autograd through the
    reference's chunk loop (S keeps its chunk rule).  Returns (dx in x's
    dtype, dB and dC in bm's and cm's, d(dt) f32, da f32 or None without
    ``need_da``)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, bm, cm, dt)]
        if need_da:
            ins.append(a.detach().requires_grad_(True))
        y, _ = ssd_scan_plain(*ins[:4], ins[4] if need_da else a)
        grads = torch.autograd.grad(y, ins, dy.float())
    return tuple(grads) + (() if need_da else (None,))


@functools.cache
def _lib():
    lib = build.load("ssd_scan")
    for fn in (lib.ssd_scan_f32, lib.ssd_scan_bf16):
        fn.argtypes = _CTYPES
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_lib():
    lib = build.load("ssd_scan_bwd")
    for fn in (lib.ssd_scan_bwd_f32, lib.ssd_scan_bwd_bf16):
        fn.argtypes = _BWD_CTYPES
        fn.restype = ctypes.c_int
    lib.ssd_scan_bwd_scratch.argtypes = (ctypes.c_int,) * 6
    lib.ssd_scan_bwd_scratch.restype = ctypes.c_longlong
    return lib


def _check(x, bm, cm, dt, a):
    """Raise ``ValueError`` unless the shapes fit: x (B, S >= 1, H, P),
    bm/cm (B, S, G, N) with G dividing H, dt (B, S, H), a (H,)."""
    if x.dim() != 4 or bm.dim() != 4 or cm.shape != bm.shape \
            or bm.shape[:2] != x.shape[:2] or dt.shape != x.shape[:3] \
            or a.shape != (x.shape[2],) or x.shape[1] < 1 \
            or x.shape[2] % bm.shape[2]:
        raise ValueError(f"ssd_scan: x must be (B, S >= 1, H, P), bm/cm "
                         f"(B, S, G, N) with G dividing H, dt (B, S, H) and "
                         f"a (H,); got x {tuple(x.shape)}, bm "
                         f"{tuple(bm.shape)}, cm {tuple(cm.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}")


def _check_cuda(x, bm, cm, dt, a):
    """Raise unless the CUDA kernel takes these inputs."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    if any(t.device != x.device for t in (bm, cm, dt, a)):
        raise ValueError("ssd_scan: all inputs must be on one device")
    n = bm.shape[3]
    if n not in STATES:
        raise ValueError(f"ssd_scan: the CUDA kernel takes N in {STATES}, "
                         f"got {n}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dt and a must be float32, got "
                        f"{dt.dtype}/{a.dtype}")
    if x.dtype not in (torch.bfloat16, torch.float32) \
            or not (x.dtype == bm.dtype == cm.dtype):
        raise TypeError(f"ssd_scan: x, bm and cm must share bf16 or f32, "
                        f"got {x.dtype}/{bm.dtype}/{cm.dtype}")
    if not (dt.is_contiguous() and a.is_contiguous()):
        raise ValueError("ssd_scan: dt and a must be contiguous")
    h, p, g = x.shape[2], x.shape[3], bm.shape[2]
    if x.stride(3) != 1 or (h > 1 and x.stride(2) != p):
        raise ValueError(f"ssd_scan: x needs a unit stride over P and a head "
                         f"stride of P, got strides {x.stride()}")
    for name, t in (("bm", bm), ("cm", cm)):
        if t.stride(3) != 1 or (g > 1 and t.stride(2) != n):
            raise ValueError(f"ssd_scan: {name} needs a unit stride over N "
                             f"and a group stride of N, got {t.stride()}")


def ssd_scan(x, bm, cm, dt, a, chunk_states: bool = False):
    """x (B, S, H, P); bm/cm (B, S, G, N); dt (B, S, H) f32; a (H,) f32
    -> (y (B, S, H, P) f32, h_final (B, H, P, N) f32), and with
    ``chunk_states`` the states entering each chunk, (B,
    n_chunk_states(S), H, P, N) f32.  On CUDA it launches K11 or raises;
    on the CPU it runs the plain versions."""
    _check(x, bm, cm, dt, a)
    if x.device.type == "cpu":
        y, h = ssd_scan_plain(x, bm, cm, dt, a)
        return (y, h, ssd_chunk_states_plain(x, bm, cm, dt, a)) \
            if chunk_states else (y, h)
    _check_cuda(x, bm, cm, dt, a)
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    hf = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    hc = torch.empty((b, n_chunk_states(s), h, p, n), dtype=torch.float32,
                     device=x.device) if chunk_states else None
    fn = _lib().ssd_scan_bf16 if x.dtype == torch.bfloat16 \
        else _lib().ssd_scan_f32
    rc = fn(x.data_ptr(), bm.data_ptr(), cm.data_ptr(), dt.data_ptr(),
            a.data_ptr(), y.data_ptr(), hf.data_ptr(),
            None if hc is None else hc.data_ptr(), b, s, h, p, g, n,
            x.stride(0), x.stride(1), bm.stride(0), bm.stride(1),
            cm.stride(0), cm.stride(1),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "ssd_scan")
    ssd_scan.launches += 1
    return (y, hf, hc) if chunk_states else (y, hf)


def ssd_scan_bwd(x, bm, cm, dt, a, dy, hc, need_da: bool = True):
    """K12: the gradients of ``ssd_scan``'s y from dy (B, S, H, P), given
    the forward's inputs and its chunk states ``hc`` (``chunk_states=
    True``): (dx (B, S, H, P) contiguous in x's dtype, dB and dC (B, S, G,
    N) contiguous in bm's dtype, d(dt) (B, S, H) f32, da (H,) f32 or None
    without ``need_da``).  On CUDA it launches the kernels of
    ``csrc/ssd_scan_bwd.cu`` or raises; on the CPU it runs
    ``ssd_scan_bwd_plain``."""
    _check(x, bm, cm, dt, a)
    if dy.shape != x.shape:
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} must match x "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return ssd_scan_bwd_plain(x, bm, cm, dt, a, dy, need_da)
    _check_cuda(x, bm, cm, dt, a)
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    if hc is None or hc.shape != (b, n_chunk_states(s), h, p, n) \
            or hc.dtype != torch.float32 or not hc.is_contiguous() \
            or hc.device != x.device:
        raise ValueError(f"ssd_scan_bwd: chunk states "
                         f"{None if hc is None else tuple(hc.shape)} do not "
                         f"fit the scan")
    dy = dy.float().contiguous()
    lib = _bwd_lib()
    scratch = torch.empty(lib.ssd_scan_bwd_scratch(b, s, h, p, n,
                                                   int(need_da)),
                          dtype=torch.float32, device=x.device)
    dx = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    dbm = torch.empty((b, s, g, n), dtype=bm.dtype, device=x.device)
    dcm = torch.empty((b, s, g, n), dtype=cm.dtype, device=x.device)
    ddt = torch.empty((b, s, h), dtype=torch.float32, device=x.device)
    da = torch.empty_like(a) if need_da else None
    fn = lib.ssd_scan_bwd_bf16 if x.dtype == torch.bfloat16 \
        else lib.ssd_scan_bwd_f32
    rc = fn(x.data_ptr(), bm.data_ptr(), cm.data_ptr(), dt.data_ptr(),
            a.data_ptr(), dy.data_ptr(), hc.data_ptr(), dx.data_ptr(),
            dbm.data_ptr(), dcm.data_ptr(), ddt.data_ptr(),
            None if da is None else da.data_ptr(), scratch.data_ptr(), b, s,
            h, p, g, n, x.stride(0), x.stride(1),
            bm.stride(0), bm.stride(1), cm.stride(0), cm.stride(1),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    return dx, dbm, dcm, ddt, da


class SsdScanFn(torch.autograd.Function):
    """The SSD scan's y with a gradient: K11 forward (saving its chunk
    states), K12 backward."""

    @staticmethod
    def forward(ctx, x, bm, cm, dt, a):
        y, _, hc = ssd_scan(x, bm, cm, dt, a, chunk_states=True)
        ctx.save_for_backward(x, bm, cm, dt, a, hc)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, bm, cm, dt, a, hc = ctx.saved_tensors
        return ssd_scan_bwd(x, bm, cm, dt, a, dy, hc, ctx.needs_input_grad[4])


def ssd_scan_train(x, bm, cm, dt, a):
    """``ssd_scan``'s y (B, S, H, P) f32, differentiable in every input:
    through ``ssd_scan_plain`` under autograd on a CPU tensor, through K11
    and K12 on a CUDA tensor."""
    _check(x, bm, cm, dt, a)
    if x.device.type == "cpu":
        return ssd_scan_train_plain(x, bm, cm, dt, a)
    return SsdScanFn.apply(x, bm, cm, dt, a)


def ssd_scan_train_plain(x, bm, cm, dt, a):
    """``ssd_scan_train`` through ``ssd_scan_plain`` under autograd, on any
    device."""
    _check(x, bm, cm, dt, a)
    return ssd_scan_plain(x, bm, cm, dt, a)[0]


ssd_scan.launches = 0
ssd_scan_bwd.launches = 0
