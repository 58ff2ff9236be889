"""K5 and K4: merged multi-LoRA deltas (paper Eq. 8).

``moe_lora_delta`` (K5) replaces the Pallas kernel
``repro/kernels/moe_lora/kernel.py::moe_lora_delta``:
out[t] = Σ_j g[t // rows_per_gate, j] · (x[t] A_jᵀ) B_jᵀ, the dense
gated sum over an E-expert bank (router gates, or one-hot adapter gate
rows).  ``moe_lora_delta_slots`` (K4) replaces
``moe_lora_delta_slots``: out[t] = (x[t] A_sᵀ) B_sᵀ for the row's slot
s = slots[t // rows_per_slot], an exact 0 where s < 0, and s >= E
clamped onto E - 1 as the Pallas kernel's index map clips it.

Shapes: x (T, k), A (E, r, k), B (E, n, r), gates (G, E) with
T = G · rows_per_gate (one gate row per request shared by its S prompt
positions; G = 1 for global gates), slots (T // rows_per_slot,) int32.
The result is float32, the reference einsum path's type; the caller
rounds it to the activation dtype.

On a CUDA tensor each wrapper launches the kernel of
``csrc/moe_lora.cu`` (x bf16, k % 8 == 0, r % 4 == 0, bank and gates
f32) or raises; on a CPU tensor it runs the plain version beside
it.  At decode (T < 64, and every K4 call) both kernels run one design
(k split over CTAs, the parts added in a fixed order) with one
accumulation order over k and r, so K5 on one-hot gate rows equals K4
bit for bit, and a call repeats bit for bit.  At an
admission prefill (T >= 64) K5 runs two register-tiled f32 GEMMs and
skips an expert whose gate is exactly 0 in a tile of rows that share
one gate row, which leaves the result bit-identical to a bank without
that expert.

Training (``moe_lora_delta_train``, the ``MoeLoraDeltaFn`` autograd
function): K5 forward, K9 backward (``moe_lora_delta_bwd``,
``csrc/moe_lora_bwd.cu``, no Pallas original: the reference
differentiates its einsum ``lora_delta``, ``repro/models/layers.py:
182-196``), giving dx in x's dtype and dA, dB in f32; the gates take no
gradient.  K4 has no backward.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_CTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)
_MAX_BANK = 384                          # E * r, the CUDA kernel's limit


def moe_lora_delta_plain(x, a, b, gates, rows_per_gate: int = 1):
    """K5's function in plain PyTorch (the port of ``moe_lora/ref.py``):
    two float32 einsums, each gate row repeated over its rows."""
    g = gates.float().repeat_interleave(rows_per_gate, dim=0)
    u = torch.einsum("tk,erk->ter", x.float(), a.float()) * g[:, :, None]
    return torch.einsum("ter,enr->tn", u, b.float())


def moe_lora_delta_bwd_plain(x, a, b, gates, dy, rows_per_gate: int = 1):
    """K9's function in plain PyTorch, float32: with u~ = g (x A^T) and
    v~ = g (dy B), dB = sum_t dy u~^T, dA = sum_t v~ x^T, dx = sum_j v~_j
    A_j.  Returns (dx in x's dtype, dA, dB)."""
    g = gates.float().repeat_interleave(rows_per_gate, dim=0)[:, :, None]
    xf, af, bf, dyf = x.float(), a.float(), b.float(), dy.float()
    ut = torch.einsum("tk,erk->ter", xf, af) * g
    vt = torch.einsum("tn,enr->ter", dyf, bf) * g
    db = torch.einsum("tn,ter->enr", dyf, ut)
    da = torch.einsum("ter,tk->erk", vt, xf)
    dx = torch.einsum("ter,erk->tk", vt, af)
    return dx.to(x.dtype), da, db


def moe_lora_delta_slots_plain(x, a, b, slots, rows_per_slot: int = 1):
    """K4's function in plain PyTorch: gather each row's expert (slot
    clamped into [0, E - 1]), two float32 einsums, exact zeros for rows
    whose slot is negative."""
    s = slots.long().repeat_interleave(rows_per_slot)
    idx = s.clamp(0, a.shape[0] - 1)
    u = torch.einsum("tk,trk->tr", x.float(), a.float()[idx])
    y = torch.einsum("tr,tnr->tn", u, b.float()[idx])
    return torch.where((s >= 0)[:, None], y, torch.zeros_like(y))


@functools.cache
def _lib():
    lib = build.load("moe_lora")
    for fn in (lib.moe_lora_delta_f32, lib.moe_lora_delta_slots_f32):
        fn.argtypes = _CTYPES
        fn.restype = ctypes.c_int
    lib.moe_lora_delta_scratch.argtypes = (ctypes.c_int,) * 4
    lib.moe_lora_delta_scratch.restype = ctypes.c_longlong
    lib.moe_lora_delta_slots_scratch.argtypes = (ctypes.c_int,) * 3
    lib.moe_lora_delta_slots_scratch.restype = ctypes.c_longlong
    return lib


@functools.cache
def _bwd_lib():
    lib = build.load("moe_lora_bwd")
    lib.moe_lora_delta_bwd_f32.argtypes = (ctypes.c_void_p,) * 9 + (
        ctypes.c_int,) * 6 + (ctypes.c_void_p,)
    lib.moe_lora_delta_bwd_f32.restype = ctypes.c_int
    lib.moe_lora_delta_bwd_scratch.argtypes = (ctypes.c_int,) * 5
    lib.moe_lora_delta_bwd_scratch.restype = ctypes.c_longlong
    return lib


def _static(what, x_shape, a_shape, b_shape, sel_shape, sel_dtype,
            sel_dtypes, rows_per):
    """Validate the common contract from shapes; returns (T, k, n, r,
    E)."""
    if len(x_shape) != 2 or len(a_shape) != 3 or len(b_shape) != 3:
        raise ValueError(f"{what}: x must be (T, k), A (E, r, k) and B "
                         f"(E, n, r)")
    t, k = x_shape
    e, r, ka = a_shape
    if ka != k or b_shape[0] != e or b_shape[2] != r:
        raise ValueError(f"{what}: mismatched shapes x {tuple(x_shape)}, "
                         f"A {tuple(a_shape)}, B {tuple(b_shape)}")
    if rows_per < 1 or sel_shape[0] * rows_per != t:
        raise ValueError(f"{what}: {sel_shape[0]} selector rows x "
                         f"{rows_per} rows each do not cover T={t}")
    if sel_dtype not in sel_dtypes:
        raise TypeError(f"{what}: selector dtype {sel_dtype}")
    return t, k, b_shape[1], r, e


_GATE_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
_SLOT_DTYPES = (torch.int32, torch.int64)


def _check_selector(slots_kernel, sel_shape, e):
    if slots_kernel and len(sel_shape) != 1:
        raise ValueError("moe_lora_delta_slots: slots must be 1-D")
    if not slots_kernel and (len(sel_shape) != 2 or sel_shape[1] != e):
        raise ValueError(f"moe_lora_delta: gates {tuple(sel_shape)} must "
                         f"be (G, {e})")


@functools.lru_cache(maxsize=256)
def _cuda_layout(slots_kernel, x_shape, a_shape, b_shape, sel_shape,
                 dtypes, rows_per):
    """Everything the CUDA kernels check from shapes and dtypes alone
    (cached: a serving loop repeats them).  Returns the C entry point,
    the launch's integer arguments and the floats of its scratch."""
    what = "moe_lora_delta_slots" if slots_kernel else "moe_lora_delta"
    x_dt, a_dt, b_dt, sel_dt = dtypes
    t, k, n, r, e = _static(what, x_shape, a_shape, b_shape, sel_shape,
                            sel_dt,
                            _SLOT_DTYPES if slots_kernel else _GATE_DTYPES,
                            rows_per)
    _check_selector(slots_kernel, sel_shape, e)
    if slots_kernel and sel_dt != torch.int32:
        raise TypeError("moe_lora_delta_slots: the CUDA kernel takes int32 "
                        "slots")
    if not slots_kernel and sel_dt != torch.float32:
        raise TypeError("moe_lora_delta: the CUDA kernel takes f32 gates")
    if x_dt != torch.bfloat16 or a_dt != torch.float32 \
            or b_dt != torch.float32:
        raise TypeError(f"{what}: the CUDA kernel takes x bf16 and an f32 "
                        f"bank, got {x_dt}/{a_dt}/{b_dt}")
    if k % 8 or r % 4 or e * r > _MAX_BANK:
        raise ValueError(f"{what}: the CUDA kernel takes k % 8 == 0, "
                         f"r % 4 == 0 and E * r <= {_MAX_BANK}; got k={k}, "
                         f"r={r}, E={e}")
    lib = _lib()
    n_scratch = (lib.moe_lora_delta_slots_scratch(t, k, r) if slots_kernel
                 else lib.moe_lora_delta_scratch(t, k, r, e))
    entry = (lib.moe_lora_delta_slots_f32 if slots_kernel
             else lib.moe_lora_delta_f32)
    return entry, (t, k, n, r, e, rows_per), n_scratch


def _launch(fn, x, a, b, sel, rows_per):
    """Check the per-call facts (device, contiguity, 16-byte alignment),
    allocate the output and the scratch and launch fn.  The host's share
    of a decode call is most of its time, so this path stays short."""
    entry, dims, n_scratch = _cuda_layout(
        fn is moe_lora_delta_slots, x.shape, a.shape, b.shape, sel.shape,
        (x.dtype, a.dtype, b.dtype, sel.dtype), rows_per)
    dev = x.get_device()
    if not a.get_device() == b.get_device() == sel.get_device() == dev:
        raise ValueError(f"{fn.__name__}: all inputs must be on one "
                         f"device")
    ptrs = (x.data_ptr(), a.data_ptr(), b.data_ptr(), sel.data_ptr())
    if (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) % 16 or not (
            x.is_contiguous() and a.is_contiguous() and b.is_contiguous()
            and sel.is_contiguous()):
        raise ValueError(f"{fn.__name__}: inputs must be contiguous and "
                         "16-byte aligned")
    out = torch.empty(dims[0], dims[2], dtype=torch.float32,
                      device=x.device)
    u = torch.empty(n_scratch, dtype=torch.float32, device=x.device)
    rc = entry(*ptrs, u.data_ptr(), out.data_ptr(), *dims,
               torch._C._cuda_getCurrentRawStream(dev))
    if rc:
        build.check(rc, fn.__name__)
    fn.launches += 1
    return out


def moe_lora_delta(x, a, b, gates, rows_per_gate: int = 1):
    """K5: x (T, k); A (E, r, k); B (E, n, r); gates (G, E) float with
    T = G · rows_per_gate -> (T, n) float32."""
    if x.is_cuda:
        return _launch(moe_lora_delta, x, a, b, gates, rows_per_gate)
    _, _, _, _, e = _static("moe_lora_delta", x.shape, a.shape, b.shape,
                            gates.shape, gates.dtype, _GATE_DTYPES,
                            rows_per_gate)
    _check_selector(False, gates.shape, e)
    if x.device.type != "cpu":
        raise ValueError(f"moe_lora_delta: unsupported device {x.device}")
    return moe_lora_delta_plain(x, a, b, gates, rows_per_gate)


def moe_lora_delta_slots(x, a, b, slots, rows_per_slot: int = 1):
    """K4: x (T, k); A (E, r, k); B (E, n, r); slots (T // rows_per_slot,)
    int32 (negative = no adapter) -> (T, n) float32."""
    if x.is_cuda:
        return _launch(moe_lora_delta_slots, x, a, b, slots,
                       rows_per_slot)
    _, _, _, _, e = _static("moe_lora_delta_slots", x.shape, a.shape,
                            b.shape, slots.shape, slots.dtype, _SLOT_DTYPES,
                            rows_per_slot)
    _check_selector(True, slots.shape, e)
    if x.device.type != "cpu":
        raise ValueError(f"moe_lora_delta_slots: unsupported device "
                         f"{x.device}")
    return moe_lora_delta_slots_plain(x, a, b, slots, rows_per_slot)


moe_lora_delta.launches = 0
moe_lora_delta_slots.launches = 0


def moe_lora_delta_bwd(x, a, b, gates, dy, rows_per_gate: int = 1):
    """K9: the gradients (dx, dA, dB) of K5's function for dy = dL/dout
    (T, n) f32.  On CUDA it launches the kernel of ``csrc/moe_lora_bwd.cu``
    (K5's contract: x bf16, an f32 bank and gates, E * r <= 384, r % 4
    == 0; every input contiguous) or raises; on the CPU it runs
    ``moe_lora_delta_bwd_plain``."""
    t, k, n, r, e = _static("moe_lora_delta_bwd", x.shape, a.shape, b.shape,
                            gates.shape, gates.dtype, _GATE_DTYPES,
                            rows_per_gate)
    _check_selector(False, gates.shape, e)
    if dy.shape != (t, n):
        raise ValueError(f"moe_lora_delta_bwd: dy {tuple(dy.shape)} must be "
                         f"({t}, {n})")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"moe_lora_delta_bwd: unsupported device "
                             f"{x.device}")
        return moe_lora_delta_bwd_plain(x, a, b, gates, dy, rows_per_gate)
    if x.dtype != torch.bfloat16 or any(
            z.dtype != torch.float32 for z in (a, b, gates, dy)):
        raise TypeError("moe_lora_delta_bwd: the CUDA kernel takes x bf16 "
                        "and an f32 bank, gates and dy")
    if e * r > _MAX_BANK or r % 4:
        raise ValueError(f"moe_lora_delta_bwd: E * r = {e * r} must be <= "
                         f"{_MAX_BANK} and r = {r} a multiple of 4")
    ts = (x, a, b, gates, dy)
    if any(z.device != x.device for z in ts) \
            or not all(z.is_contiguous() for z in ts):
        raise ValueError("moe_lora_delta_bwd: inputs must be contiguous on "
                         "one device")
    lib = _bwd_lib()
    scratch = torch.empty(lib.moe_lora_delta_bwd_scratch(t, k, n, r, e),
                          dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    da = torch.empty_like(a)
    db = torch.empty_like(b)
    rc = lib.moe_lora_delta_bwd_f32(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), gates.data_ptr(),
        dy.data_ptr(), scratch.data_ptr(), dx.data_ptr(), da.data_ptr(),
        db.data_ptr(), t, k, n, r, e, rows_per_gate,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "moe_lora_delta_bwd")
    moe_lora_delta_bwd.launches += 1
    return dx, da, db


class MoeLoraDeltaFn(torch.autograd.Function):
    """The gated multi-LoRA delta with a gradient for x, A and B: K5
    forward, K9 backward."""

    @staticmethod
    def forward(ctx, x, a, b, gates, rows_per_gate):
        ctx.save_for_backward(x, a, b, gates)
        ctx.rows_per_gate = rows_per_gate
        return moe_lora_delta(x, a, b, gates, rows_per_gate)

    @staticmethod
    def backward(ctx, dy):
        x, a, b, gates = ctx.saved_tensors
        dx, da, db = moe_lora_delta_bwd(x, a, b, gates, dy.contiguous(),
                                        ctx.rows_per_gate)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, da if need[1] else None,
                db if need[2] else None, None, None)


def moe_lora_delta_train(x, a, b, gates, rows_per_gate: int = 1):
    """K5's function, differentiable in x, A and B through K5 and K9.
    Gates that require a gradient raise: the router's gates are fixed."""
    if gates.requires_grad:
        raise ValueError("moe_lora_delta_train: the gates take no gradient")
    return MoeLoraDeltaFn.apply(x, a, b, gates, rows_per_gate)


moe_lora_delta_bwd.launches = 0
