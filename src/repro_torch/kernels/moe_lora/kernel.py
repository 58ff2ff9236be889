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
it.  At decode (T < 64) both kernels share one accumulation order over
k and r, so K5 on one-hot gate rows equals K4 bit for bit.  At an
admission prefill (T >= 64) K5 runs two register-tiled f32 GEMMs and
skips an expert whose gate is exactly 0 in a tile of rows that share
one gate row, which leaves the result bit-identical to a bank without
that expert.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_CTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)
_MAX_SMEM_FLOATS = 48 * 1024 // 4        # 32 rows x E x r, decode up pass
_UP_ROWS = 32


def moe_lora_delta_plain(x, a, b, gates, rows_per_gate: int = 1):
    """K5's function in plain PyTorch (the port of ``moe_lora/ref.py``):
    two float32 einsums, each gate row repeated over its rows."""
    g = gates.float().repeat_interleave(rows_per_gate, dim=0)
    u = torch.einsum("tk,erk->ter", x.float(), a.float()) * g[:, :, None]
    return torch.einsum("ter,enr->tn", u, b.float())


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
    return lib


def _check(what, x, a, b, sel, sel_dtypes, rows_per):
    """Validate the common contract; returns (T, k, n, r, E)."""
    if x.dim() != 2 or a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"{what}: x must be (T, k), A (E, r, k) and B "
                         f"(E, n, r)")
    t, k = x.shape
    e, r, ka = a.shape
    if ka != k or b.shape[0] != e or b.shape[2] != r:
        raise ValueError(f"{what}: mismatched shapes x {tuple(x.shape)}, "
                         f"A {tuple(a.shape)}, B {tuple(b.shape)}")
    if rows_per < 1 or sel.shape[0] * rows_per != t:
        raise ValueError(f"{what}: {sel.shape[0]} selector rows x "
                         f"{rows_per} rows each do not cover T={t}")
    if sel.dtype not in sel_dtypes:
        raise TypeError(f"{what}: selector dtype {sel.dtype}")
    return t, k, b.shape[1], r, e


def _check_cuda(what, x, a, b, sel, k, r, e):
    if x.dtype != torch.bfloat16 or a.dtype != torch.float32 \
            or b.dtype != torch.float32:
        raise TypeError(f"{what}: the CUDA kernel takes x bf16 and an f32 "
                        f"bank, got {x.dtype}/{a.dtype}/{b.dtype}")
    if k % 8 or r % 4 or _UP_ROWS * e * r > _MAX_SMEM_FLOATS:
        raise ValueError(f"{what}: the CUDA kernel takes k % 8 == 0, "
                         f"r % 4 == 0 and E * r <= "
                         f"{_MAX_SMEM_FLOATS // _UP_ROWS}; got k={k}, "
                         f"r={r}, E={e}")
    for t in (a, b, sel):
        if t.device != x.device:
            raise ValueError(f"{what}: all inputs must be on one device")
    for t in (x, a, b, sel):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: inputs must be contiguous and "
                             "16-byte aligned")


def moe_lora_delta(x, a, b, gates, rows_per_gate: int = 1):
    """K5: x (T, k); A (E, r, k); B (E, n, r); gates (G, E) float with
    T = G · rows_per_gate -> (T, n) float32."""
    t, k, n, r, e = _check("moe_lora_delta", x, a, b, gates,
                           (torch.float32, torch.bfloat16, torch.float16,
                            torch.float64), rows_per_gate)
    if gates.dim() != 2 or gates.shape[1] != e:
        raise ValueError(f"moe_lora_delta: gates {tuple(gates.shape)} must "
                         f"be (G, {e})")
    if x.device.type == "cpu":
        return moe_lora_delta_plain(x, a, b, gates, rows_per_gate)
    if x.device.type != "cuda":
        raise ValueError(f"moe_lora_delta: unsupported device {x.device}")
    if gates.dtype != torch.float32:
        raise TypeError("moe_lora_delta: the CUDA kernel takes f32 gates")
    _check_cuda("moe_lora_delta", x, a, b, gates, k, r, e)
    lib = _lib()
    u = torch.empty(lib.moe_lora_delta_scratch(t, k, r, e),
                    dtype=torch.float32, device=x.device)
    out = torch.empty((t, n), dtype=torch.float32, device=x.device)
    rc = lib.moe_lora_delta_f32(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), gates.data_ptr(),
        u.data_ptr(), out.data_ptr(), t, k, n, r, e, rows_per_gate,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "moe_lora_delta")
    moe_lora_delta.launches += 1
    return out


def moe_lora_delta_slots(x, a, b, slots, rows_per_slot: int = 1):
    """K4: x (T, k); A (E, r, k); B (E, n, r); slots (T // rows_per_slot,)
    int32 (negative = no adapter) -> (T, n) float32."""
    t, k, n, r, e = _check("moe_lora_delta_slots", x, a, b, slots,
                           (torch.int32, torch.int64), rows_per_slot)
    if slots.dim() != 1:
        raise ValueError("moe_lora_delta_slots: slots must be 1-D")
    if x.device.type == "cpu":
        return moe_lora_delta_slots_plain(x, a, b, slots, rows_per_slot)
    if x.device.type != "cuda":
        raise ValueError(f"moe_lora_delta_slots: unsupported device "
                         f"{x.device}")
    if slots.dtype != torch.int32:
        raise TypeError("moe_lora_delta_slots: the CUDA kernel takes int32 "
                        "slots")
    _check_cuda("moe_lora_delta_slots", x, a, b, slots, k, r, e)
    u = torch.empty((t, r), dtype=torch.float32, device=x.device)
    out = torch.empty((t, n), dtype=torch.float32, device=x.device)
    rc = _lib().moe_lora_delta_slots_f32(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), slots.data_ptr(),
        u.data_ptr(), out.data_ptr(), t, k, n, r, e, rows_per_slot,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "moe_lora_delta_slots")
    moe_lora_delta_slots.launches += 1
    return out


moe_lora_delta.launches = 0
moe_lora_delta_slots.launches = 0
