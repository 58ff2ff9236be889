#!/usr/bin/env python3
"""Time the port's redesigned kernels of one checkout at the serving
and training shapes, so that two checkouts can be compared on one card
in turns.

    python3 src/repro_torch/kernels/time_kernels.py [--src DIR]
        [--label NAME]
        [--kernels k1,k2,k3,k4,k5,k5adm,k6,k9,k8w,k10,k11,k3d112,k12,
                   k8d112]
        [--profile]

``--src`` is the ``src`` directory of the checkout to time (this
script's own checkout by default); its ``repro_torch`` is imported and
builds its kernels into that checkout's ``build/``.  ``--kernels``
picks the groups (all by default):

  k1     K1 logit fusion at B = 1, 4 and 8, V = 256,000 f32, rows
         arrived / missed alternately (``k1_inputs``, which
         chip_smoke.py uses too);
  k2     K2 paged decode attention at both full-width geometries (SLM
         H=8 KV=1, LLM H=KV=16; B=8, hd 256, 16-slot pages, nb 128, a
         1,024-page pool): rows at K2_POSITIONS plain and with a 512-slot
         window on ring tables, and the batched run's tail (4 short rows,
         4 parked);
  k3     K3 prefill flash attention at the burst and single-request
         shapes;
  k4     K4 slot-gather LoRA delta at T = 8 over the four (k, n) LoRA
         targets of the 2b SLM, E = 4, r = 16, slots with repeats and
         adapter-free rows;
  k5     K5 gated LoRA delta at T = 8, soft gates (one one-hot and one
         zero row), the same shapes;
  k5adm  K5 at the admission burst (8 x 1,552 rows, soft and one-hot
         gate rows);
  k6     K6 Mamba-1 selective scan at S = 1,536 and 27, falcon-mamba-7b's
         d_inner 8,192 and N 16, bf16 x, B and C strided slices of an
         x_proj-like (1, S, 288) output (``ssm_inputs``, which
         chip_smoke.py uses too);
  k9     K9 LoRA-delta backward at T = 160 (a client step's 4 x 40
         tokens) over the same shapes, E = 1 with a ones gate (a client
         step) and E = 4 with soft gates on 4 gate rows;
  k8w    K8 attention backward in its windowed mode at the gemma3 SLM's
         H 4 / KV 1 / head_dim 256, window 512, (B, S) = (1, 2,048) and
         (8, 640), on (B, H, S, D) views of (B, S, H, D) tensors, its
         LSE from K3 windowed;
  k10    K10 selective-scan backward at falcon-mamba's d_inner 8,192 and
         N 16, (B, S) = (4, 40), (2, 256) and (1, 1,536), from K6's
         chunk states (``ssm_inputs``), dA included; beside each, K6
         with and without its chunk-state output;
  k11    K11 SSD scan at zamba2-7b's width (112 heads of 64, N 64, one
         group), S = 1,536 and 27, x, B and C bf16 column slices of a
         conv-like (1, S, 7,296) output (``ssd_inputs``, which
         chip_smoke.py uses too);
  k3d112 K3 at zamba2-7b's shared block, H = KV = 32, head_dim 112, B =
         1, S = 1,536 and 27, causal and with its 4,096 window, on (B, H,
         S, D) views of (B, S, H, D) tensors;
  k12    K12 SSD-scan backward at zamba2-7b's width (``ssd_inputs``, dy
         f32), (B, S) = (4, 40), (1, 512), (1, 1,536) and (2, 203), from
         K11's chunk states; beside each, K11 with and without them;
  k8d112 K8 attention backward at zamba2-7b's shared block (H = KV = 32,
         head_dim 112, its window of 4,096), (B, S) = (4, 40) and (1,
         1,536), its LSE from K3 windowed.

Every input is made on the card from fixed seeds, so two checkouts time
the same tensors.  Prints one JSON line: the card's name and power
limit, the ptxas report of the kernels built, and per case the kernel's
ms (CUDA events, the mean over a run of back-to-back calls after a
warm-up, which for a microsecond-scale kernel is the host's dispatch),
for K1, K2, K4, K5 and K6 also ``graph_ms`` (the calls replayed from a
CUDA graph: device time and launch gaps), its error against the plain
version and whether a second call returns the same bits.  ``--profile``
adds, per case, the device time of each CUDA kernel the call launches
(``torch.profiler``), which splits K1's stats and write passes, K2's
split and combine passes, K4/K5's down and up passes and K9's proj,
gate, outer and dx passes.  Compare
two checkouts as A, B, B, A in one call.  Needs a CUDA card; exits 2
without one.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

K3_SHAPES = [(8, 16, 16, 1552), (8, 8, 1, 1552), (1, 16, 16, 2048),
             (1, 16, 16, 31)]
# (k, n) of the SLM's LoRA targets: q and o, k and v, mlp_in, mlp_out
LORA_SHAPES = [(2048, 2048), (2048, 256), (2048, 32768), (16384, 2048)]
ADMIT_ROWS, ADMIT_REQUESTS = 1552, 8
HOT_SLOTS = [0, 3, -1, 1, 2, -1, 0, 3]
K4_SLOTS = [0, 1, 2, 3, -1, 0, 2, -1]
FREED_POS = 1 << 30
NO_PAGE = 1 << 20
K2_POSITIONS = [0, 15, 16, 700, 1541, 2047, FREED_POS, 1541]
K2_TAIL_POSITIONS = [40, 47, 52, 63] + [FREED_POS] * 4
GROUPS = ("k1", "k2", "k3", "k4", "k5", "k5adm", "k6", "k9", "k8w", "k10",
          "k11", "k3d112", "k12", "k8d112")
K8W_SHAPES = [(1, 2048), (8, 640)]
GEMMA3_WINDOW = 512
K10_SHAPES = [(4, 40), (2, 256), (1, 1536)]
TRAIN_ROWS = 160
K1_ARRIVED = [True, False, True, False] * 2
SSM_DI, SSM_N, SSM_DT_RANK = 8192, 16, 256
# zamba2-7b: SSD heads, head dim, state; shared block heads, head dim
SSD_H, SSD_P, SSD_N = 112, 64, 64
Z_HEADS, Z_HD, Z_WINDOW = 32, 112, 4096
SSD_SHAPES = (1536, 27)
K12_SHAPES = [(4, 40), (1, 512), (1, 1536), (2, 203)]
K8D_SHAPES = [(4, 40), (1, 1536)]


def time_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def row_rel_err(out, ref):
    out, ref = out.float(), ref.float()
    return ((out - ref).abs().amax(-1) / ref.abs().amax(-1)).max().item()


def kernel_split(torch, fn):
    """Device ms per call of each CUDA kernel fn launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us > 0:
            split[ev.key[:60]] = us / 3e3
    return split


def paged_case(torch, g, h, kvh, window, positions, n_pool=1024, hd=256):
    """Random bf16 pages and block tables as the allocator builds them
    (the same construction as chip_smoke.py's)."""
    dev, ps, b = torch.device("cuda"), 16, len(positions)
    nb = window // ps if window else 2048 // ps
    q = torch.randn(b, h, hd, device=dev, generator=g).bfloat16()
    pk = torch.randn(n_pool, ps, kvh, hd, device=dev, generator=g).bfloat16()
    pv = torch.randn(n_pool, ps, kvh, hd, device=dev, generator=g).bfloat16()
    free = torch.randperm(n_pool, device=dev, generator=g).tolist()
    table = torch.full((b, nb), NO_PAGE, dtype=torch.int32)
    for i, p in enumerate(positions):
        if p < FREED_POS:
            n = window // ps if window else p // ps + 1
            table[i, :n] = torch.tensor([free.pop() for _ in range(n)])
    pos = torch.tensor(positions, dtype=torch.int32)
    return q, pk, pv, table.to(dev), pos.to(dev)


def graph_ms(torch, fn, calls=20, replays=10):
    """ms per call of fn replayed from a CUDA graph of ``calls`` calls:
    device time and launch gaps without the host's per-call dispatch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def case(torch, fn, iters, profile, graph=False, **info):
    """Time fn (which returns the output, a tensor or a tuple of them)
    back to back and, with ``graph``, replayed from a CUDA graph; a
    second call must give the same bits."""
    first = fn()
    again = fn()
    torch.cuda.synchronize()
    pairs = zip(first, again) if isinstance(first, tuple) \
        else [(first, again)]
    info.update(repeat_equal=all(bool(torch.equal(a, b)) for a, b in pairs),
                ms=time_ms(torch, fn, iters))
    if graph:
        info["graph_ms"] = graph_ms(torch, fn)
    if profile:
        info["kernels_ms"] = kernel_split(torch, fn)
    return first, info


def k1_inputs(torch, g, b):
    """K1's inputs at the serving paths' shape, as chip_smoke.py checks
    them too: (b, 256,000) f32 logits of spread 3, w uniform, rows
    arrived and missed alternately."""
    dev = torch.device("cuda")
    sl = 3 * torch.randn(b, 256_000, device=dev, generator=g)
    ll = 3 * torch.randn(b, 256_000, device=dev, generator=g)
    w = torch.rand(b, device=dev, generator=g)
    arrived = torch.tensor(K1_ARRIVED[:b], device=dev)
    return sl, ll, w, arrived


def time_k1(torch, profile):
    from repro_torch.kernels.logit_fusion import kernel as K1
    out = []
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for b in (1, 4, 8):
        sl, ll, w, arrived = k1_inputs(torch, g, b)
        res, info = case(torch, lambda: K1.fuse_logits(sl, ll, w, arrived),
                         200, profile, graph=True, B=b, V=256_000)
        ref = K1.fuse_logits_plain(sl, ll, w, arrived)
        info["rel_err"] = ((res - ref).abs() / ref.abs()).max().item()
        out.append(info)
        print(f"K1 {info}", file=sys.stderr)
    return out


def ssm_inputs(torch, g, s, b=1):
    """One falcon-mamba prefill scan's inputs on the card (``b`` rows of
    S steps), as chip_smoke.py checks them too: dt a softplus (f32), x
    bf16, B and C bf16 column slices of an x_proj-like output (b, S,
    dt_rank + 2 N) as the model hands them over, A = -exp(A_log)
    (f32)."""
    dev = torch.device("cuda")
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, SSM_DI, device=dev, generator=g) - 1.0)
    x = torch.randn(b, s, SSM_DI, device=dev, generator=g).bfloat16()
    xdbc = torch.randn(b, s, SSM_DT_RANK + 2 * SSM_N, device=dev,
                       generator=g).bfloat16()
    bm = xdbc[..., SSM_DT_RANK:SSM_DT_RANK + SSM_N]
    cm = xdbc[..., SSM_DT_RANK + SSM_N:]
    a = -torch.exp(0.5 * torch.randn(SSM_DI, SSM_N, device=dev,
                                     generator=g))
    return dt, x, bm, cm, a


def time_k6(torch, profile):
    from repro_torch.kernels.ssm_scan import kernel as K6
    out = []
    g = torch.Generator(device="cuda").manual_seed(6)
    for s in (1536, 27):
        args = ssm_inputs(torch, g, s)
        (y, h), info = case(torch, lambda: K6.ssm_scan(*args),
                            50 if s > 512 else 200, profile, graph=True,
                            S=s)
        ry, rh = K6.ssm_scan_plain(*args)
        info.update(row_rel_err=row_rel_err(y, ry),
                    h_rel_err=((h - rh).abs().max() / rh.abs().max()).item())
        out.append(info)
        print(f"K6 {info}", file=sys.stderr)
        del args
    return out


def ssd_inputs(torch, g, s, b=1):
    """One zamba2 prefill SSD scan's inputs on the card, as chip_smoke.py
    checks them too: x (b, S, 112, 64), B and C (b, S, 1, 64) bf16 column
    slices of a conv-like (b, S, 7,296) output as the model hands them
    over (silu of normals), dt a softplus (f32), a = -exp(.) (f32)."""
    dev = torch.device("cuda")
    di = SSD_H * SSD_P
    conv = torch.nn.functional.silu(torch.randn(
        b, s, di + 2 * SSD_N, device=dev, generator=g)).bfloat16()
    x = conv[..., :di].unflatten(-1, (SSD_H, SSD_P))
    bm = conv[..., di:di + SSD_N].unflatten(-1, (1, SSD_N))
    cm = conv[..., di + SSD_N:].unflatten(-1, (1, SSD_N))
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, SSD_H, device=dev, generator=g) - 1.0)
    a = -torch.exp(0.5 * torch.randn(SSD_H, device=dev, generator=g))
    return x, bm, cm, dt, a


def time_k11(torch, profile):
    from repro_torch.kernels.ssd_scan import kernel as K11
    out = []
    g = torch.Generator(device="cuda").manual_seed(11)
    for s in SSD_SHAPES:
        args = ssd_inputs(torch, g, s)
        (y, h), info = case(torch, lambda: K11.ssd_scan(*args),
                            50 if s > 512 else 200, profile, graph=True,
                            S=s)
        ry, rh = K11.ssd_scan_plain(*args)
        info.update(row_rel_err=row_rel_err(y, ry),
                    h_rel_err=((h - rh).abs().max() / rh.abs().max()).item())
        out.append(info)
        print(f"K11 {info}", file=sys.stderr)
        del args
    return out


def k3d112_inputs(torch, g, s, b=1):
    """q, k, v (b, 32, S, 112) bf16 as (B, H, S, D) views of (B, S, H, D)
    projections, as zamba2's shared block hands them to K3."""
    return tuple(torch.randn(b, s, Z_HEADS, Z_HD, device="cuda",
                             generator=g).bfloat16().transpose(1, 2)
                 for _ in range(3))


def time_k3d112(torch, profile):
    from repro_torch.kernels.flash_attention import kernel as K3
    out = []
    g = torch.Generator(device="cuda").manual_seed(112)
    for s in SSD_SHAPES:
        q, k, v = k3d112_inputs(torch, g, s)
        for window in (0, Z_WINDOW):
            res, info = case(torch, lambda: K3.flash_attention(
                q, k, v, window=window), 50 if s > 512 else 200, profile,
                S=s, window=window)
            info["row_rel_err"] = row_rel_err(res, K3.flash_attention_plain(
                q, k, v, window=window))
            out.append(info)
            print(f"K3 d112 {info}", file=sys.stderr)
        del q, k, v
    return out


def time_k2(torch, profile):
    from repro_torch.kernels.paged_attention import kernel as K2
    out = []
    g = torch.Generator(device="cuda").manual_seed(2)
    runs = [(m, h, kvh, w, K2_POSITIONS)
            for m, h, kvh in (("slm", 8, 1), ("llm", 16, 16))
            for w in (0, 512)]
    runs += [(m, h, kvh, 0, K2_TAIL_POSITIONS)
             for m, h, kvh in (("slm", 8, 1), ("llm", 16, 16))]
    for model, h, kvh, window, positions in runs:
        args = paged_case(torch, g, h, kvh, window, positions)
        res, info = case(
            torch, lambda: K2.paged_decode_attention(*args, window=window),
            200, profile, graph=True, model=model, window=window,
            pos="tail" if positions is K2_TAIL_POSITIONS else "K2_POSITIONS")
        ref = K2.paged_decode_attention_plain(*args, window=window)
        live = [i for i, p in enumerate(positions) if p < FREED_POS]
        parked = [i for i, p in enumerate(positions) if p >= FREED_POS]
        info.update(row_rel_err=row_rel_err(res[live], ref[live]),
                    parked_zero=not res[parked].any().item())
        out.append(info)
        print(f"K2 {info}", file=sys.stderr)
        del args
    return out


def time_k3(torch, profile):
    from repro_torch.kernels.flash_attention import kernel as K3
    out = []
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for b, h, kvh, s in K3_SHAPES:
        q, k, v = (torch.randn(b, n, s, 256, device=dev, generator=g)
                   .bfloat16() for n in (h, kvh, kvh))
        res, info = case(torch, lambda: K3.flash_attention(q, k, v),
                         20 if s > 512 else 200, profile, B=b, H=h, KVH=kvh,
                         S=s)
        info["row_rel_err"] = row_rel_err(res,
                                          K3.flash_attention_plain(q, k, v))
        out.append(info)
        print(f"K3 {info}", file=sys.stderr)
        del q, k, v, res
    return out


def lora_bank(torch, t, k, n, seed):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(t, k, device=dev, generator=g).bfloat16()
    a = torch.randn(4, 16, k, device=dev, generator=g) / k ** 0.5
    b = torch.randn(4, n, 16, device=dev, generator=g)
    return g, x, a, b


def time_k4(torch, profile):
    from repro_torch.kernels.moe_lora import kernel as KL
    out = []
    slots = torch.tensor(K4_SLOTS, dtype=torch.int32, device="cuda")
    live = slots >= 0
    for k, n in LORA_SHAPES:
        _, x, a, b = lora_bank(torch, 8, k, n, k + n)
        res, info = case(
            torch, lambda: KL.moe_lora_delta_slots(x, a, b, slots), 200,
            profile, graph=True, T=8, k=k, n=n)
        ref = KL.moe_lora_delta_slots_plain(x, a, b, slots)
        info.update(row_rel_err=row_rel_err(res[live], ref[live]),
                    dead_rows_zero=not res[~live].any().item())
        out.append(info)
        print(f"K4 {info}", file=sys.stderr)
    return out


def time_k5(torch, profile):
    from repro_torch.kernels.moe_lora import kernel as KL
    out = []
    for k, n in LORA_SHAPES:
        g, x, a, b = lora_bank(torch, 8, k, n, k + n)
        gates = torch.rand(8, 4, device="cuda", generator=g)
        gates[1] = torch.eye(4, device="cuda")[2]
        gates[5] = 0.0
        res, info = case(torch, lambda: KL.moe_lora_delta(x, a, b, gates),
                         200, profile, graph=True, T=8, k=k, n=n,
                         gates="soft")
        ref = KL.moe_lora_delta_plain(x, a, b, gates)
        rows = [i for i in range(8) if i != 5]
        info.update(row_rel_err=row_rel_err(res[rows], ref[rows]),
                    zero_row_zero=not res[5].any().item())
        out.append(info)
        print(f"K5 {info}", file=sys.stderr)
    return out


def time_k5adm(torch, profile):
    from repro_torch.kernels.moe_lora import kernel as KL
    out = []
    dev = torch.device("cuda")
    t = ADMIT_ROWS * ADMIT_REQUESTS
    for gates_kind in ("soft", "one-hot"):
        for k, n in LORA_SHAPES:
            g, x, a, b = lora_bank(torch, t, k, n, k + n)
            if gates_kind == "soft":
                gates = torch.rand(ADMIT_REQUESTS, 4, device=dev,
                                   generator=g)
            else:
                gates = torch.zeros(ADMIT_REQUESTS, 4, device=dev)
                for i, sl in enumerate(HOT_SLOTS):
                    if sl >= 0:
                        gates[i, sl] = 1.0
            res, info = case(
                torch, lambda: KL.moe_lora_delta(
                    x, a, b, gates, rows_per_gate=ADMIT_ROWS),
                10, profile, k=k, n=n, gates=gates_kind)
            ref = KL.moe_lora_delta_plain(x, a, b, gates,
                                          rows_per_gate=ADMIT_ROWS)
            live = gates.ne(0).any(1).repeat_interleave(ADMIT_ROWS)
            info.update(row_rel_err=row_rel_err(res[live], ref[live]),
                        dead_rows_zero=not res[~live].any().item())
            out.append(info)
            print(f"K5 admission {info}", file=sys.stderr)
            del x, a, b, res, ref
            torch.cuda.empty_cache()
    return out


def time_k9(torch, profile):
    from repro_torch.kernels.moe_lora import kernel as KL
    out = []
    for e in (1, 4):
        for k, n in LORA_SHAPES:
            g, x, a, b = lora_bank(torch, TRAIN_ROWS, k, n, k + n)
            a, b = a[:e].contiguous(), b[:e].contiguous()
            gates = torch.ones(1, 1, device="cuda") if e == 1 else \
                torch.softmax(torch.randn(4, 4, device="cuda", generator=g),
                              -1)
            rpg = TRAIN_ROWS // gates.shape[0]
            dy = torch.randn(TRAIN_ROWS, n, device="cuda", generator=g)
            res, info = case(torch, lambda: KL.moe_lora_delta_bwd(
                x, a, b, gates, dy, rpg), 50, profile, T=TRAIN_ROWS, k=k,
                n=n, E=e)
            ref = KL.moe_lora_delta_bwd_plain(x, a, b, gates, dy, rpg)
            info["rel_err_dx_da_db"] = [
                ((u.float() - w.float()).abs().max()
                 / w.float().abs().max()).item() for u, w in zip(res, ref)]
            out.append(info)
            print(f"K9 {info}", file=sys.stderr)
    return out


def k8w_inputs(torch, g, b, s, h=4, kvh=1, d=256):
    """K8's windowed inputs: bf16 q, k, v, dO as (B, N, S, D) views of
    (B, S, N, D) tensors (the model's layout)."""
    q, k, v = (torch.randn(b, s, n, d, device="cuda", generator=g)
               .bfloat16().transpose(1, 2) for n in (h, kvh, kvh))
    do = torch.randn(b, s, h, d, device="cuda",
                     generator=g).bfloat16().transpose(1, 2)
    return q, k, v, do


def time_k8w(torch, profile):
    from repro_torch.kernels.flash_attention import kernel as K3
    out = []
    g = torch.Generator(device="cuda").manual_seed(8)
    w = GEMMA3_WINDOW
    for b, s in K8W_SHAPES:
        q, k, v, do = k8w_inputs(torch, g, b, s)
        o, lse = K3.flash_attention(q, k, v, window=w, return_lse=True)
        res, info = case(torch, lambda: K3.flash_attention_bwd(
            q, k, v, o, do, lse, window=w), 20 if s > 1024 else 50,
            profile, B=b, S=s, H=4, KVH=1, D=256, window=w)
        ref = K3.flash_attention_bwd_plain(q, k, v, o, do, lse, window=w)
        info["rel_err_dq_dk_dv"] = [
            ((x.float() - y.float()).abs().max()
             / y.float().abs().max()).item() for x, y in zip(res, ref)]
        out.append(info)
        print(f"K8 windowed {info}", file=sys.stderr)
    return out


def time_k10(torch, profile):
    from repro_torch.kernels.ssm_scan import kernel as K6
    out = []
    g = torch.Generator(device="cuda").manual_seed(10)
    for b, s in K10_SHAPES:
        dt, x, bm, cm, a = ssm_inputs(torch, g, s, b)
        dy = torch.randn(b, s, SSM_DI, device="cuda",
                         generator=g).bfloat16()
        _, _, hc = K6.ssm_scan(dt, x, bm, cm, a, chunk_states=True)
        res, info = case(torch, lambda: K6.ssm_scan_bwd(
            dt, x, bm, cm, a, dy, hc), 20 if s > 512 else 50, profile,
            B=b, S=s, di=SSM_DI, N=SSM_N)
        ref = K6.ssm_scan_bwd_plain(dt, x, bm, cm, a, dy)
        info["rel_err_ddt_dx_db_dc_da"] = [
            ((u.float() - w.float()).abs().max()
             / w.float().abs().max()).item() for u, w in zip(res, ref)]
        info["k6_ms"] = time_ms(torch, lambda: K6.ssm_scan(
            dt, x, bm, cm, a), 50)
        info["k6_chunk_states_ms"] = time_ms(torch, lambda: K6.ssm_scan(
            dt, x, bm, cm, a, chunk_states=True), 50)
        out.append(info)
        print(f"K10 {info}", file=sys.stderr)
        del dt, x, bm, cm, a, dy, hc, res, ref
    return out


def rel_errs(got, ref):
    """max|got - ref| / max|ref| of each pair of tensors (the absolute
    error where ref is all zeros)."""
    out = []
    for u, w in zip(got, ref):
        err = (u.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        out.append(err / scale if scale else err)
    return out


def time_k12(torch, profile):
    from repro_torch.kernels.ssd_scan import kernel as K11
    out = []
    g = torch.Generator(device="cuda").manual_seed(12)
    for b, s in K12_SHAPES:
        x, bm, cm, dt, a = ssd_inputs(torch, g, s, b)
        dy = torch.randn(b, s, SSD_H, SSD_P, device="cuda", generator=g)
        _, _, hc = K11.ssd_scan(x, bm, cm, dt, a, chunk_states=True)
        res, info = case(torch, lambda: K11.ssd_scan_bwd(
            x, bm, cm, dt, a, dy, hc), 20 if s > 512 else 50, profile,
            graph=b * s <= 512, B=b, S=s)
        info["rel_err_dx_db_dc_ddt_da"] = rel_errs(
            res, K11.ssd_scan_bwd_plain(x, bm, cm, dt, a, dy))
        hc_ref = K11.ssd_chunk_states_plain(x, bm, cm, dt, a)
        info["chunk_states_rel_err"] = rel_errs([hc], [hc_ref])[0]
        info["k11_ms"] = time_ms(torch, lambda: K11.ssd_scan(
            x, bm, cm, dt, a), 20)
        info["k11_chunk_states_ms"] = time_ms(torch, lambda: K11.ssd_scan(
            x, bm, cm, dt, a, chunk_states=True), 20)
        out.append(info)
        print(f"K12 {info}", file=sys.stderr)
        del x, bm, cm, dt, a, dy, hc, res
    return out


def time_k8d112(torch, profile):
    from repro_torch.kernels.flash_attention import kernel as K3
    out = []
    g = torch.Generator(device="cuda").manual_seed(81)
    for b, s in K8D_SHAPES:
        q, k, v = k3d112_inputs(torch, g, s, b)
        do = torch.randn(b, s, Z_HEADS, Z_HD, device="cuda",
                         generator=g).bfloat16().transpose(1, 2)
        o, lse = K3.flash_attention(q, k, v, window=Z_WINDOW,
                                    return_lse=True)
        res, info = case(torch, lambda: K3.flash_attention_bwd(
            q, k, v, o, do, lse, window=Z_WINDOW), 20 if s > 512 else 100,
            profile, B=b, S=s, H=Z_HEADS, D=Z_HD, window=Z_WINDOW)
        info["rel_err_dq_dk_dv"] = rel_errs(res, K3.flash_attention_bwd_plain(
            q, k, v, o, do, lse, window=Z_WINDOW))
        info["lse_max_abs_err"] = (lse - K3.attention_lse_plain(
            q, k, window=Z_WINDOW)).abs().max().item()
        out.append(info)
        print(f"K8 d112 {info}", file=sys.stderr)
        del q, k, v, do, o, lse, res
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    ap.add_argument("--kernels", default=",".join(GROUPS))
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    groups = args.kernels.split(",")
    if set(groups) - set(GROUPS):
        ap.error(f"--kernels takes {','.join(GROUPS)}")
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    sources = {"k1": "fuse_logits", "k2": "paged_attention",
               "k3": "flash_attention", "k4": "moe_lora", "k5": "moe_lora",
               "k5adm": "moe_lora", "k6": "ssm_scan", "k9": "moe_lora_bwd",
               "k8w": "flash_attention_bwd", "k10": "ssm_scan_bwd",
               "k11": "ssd_scan", "k3d112": "flash_attention",
               "k12": "ssd_scan_bwd", "k8d112": "flash_attention_bwd"}
    needs = {"k8w": ("flash_attention",), "k10": ("ssm_scan",),
             "k12": ("ssd_scan",), "k8d112": ("flash_attention",)}
    report = build.build_all(sorted(
        {sources[g] for g in groups}
        | {n for g in groups for n in needs.get(g, ())}))
    ptxas = {name: [ln.strip() for ln in r["ptxas"].splitlines()
                    if "Used" in ln or "spill" in ln or "Compiling" in ln]
             for name, r in report.items()}
    res = dict(label=args.label, src=args.src, card=card, ptxas=ptxas)
    timers = {"k1": time_k1, "k2": time_k2, "k3": time_k3, "k4": time_k4,
              "k5": time_k5, "k5adm": time_k5adm, "k6": time_k6,
              "k9": time_k9, "k8w": time_k8w, "k10": time_k10,
              "k11": time_k11, "k3d112": time_k3d112, "k12": time_k12,
              "k8d112": time_k8d112}
    for name in groups:
        res[name] = timers[name](torch, args.profile)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
