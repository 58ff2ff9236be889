#!/usr/bin/env python3
"""Time K3 (prefill flash attention) and K5 (gated multi-LoRA delta) of
one checkout at the serving shapes, so that two checkouts can be
compared on one card in turns.

    python3 src/repro_torch/kernels/time_k3_k5.py [--src DIR] [--label NAME]
                                                  [--profile]

``--src`` is the ``src`` directory of the checkout to time (this
script's own checkout by default); its ``repro_torch`` is imported and
builds its two kernels into that checkout's ``build/``.  Every input is
made on the card from fixed seeds, so two checkouts time the same
tensors.  Prints one JSON line: the card's name and power limit, the
ptxas report of the two kernels, and per case the kernel's ms (CUDA
events, the mean over a run after a warm-up) and its per-row error
against the plain version.  ``--profile`` adds, per K5 case, the device
time of each CUDA kernel K5 launches (``torch.profiler``), which splits
K5's down and up passes.  Compare two checkouts as A, B, B, A in one
call.  Needs a CUDA card; exits 2 without one.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

K3_SHAPES = [(8, 16, 16, 1552), (8, 8, 1, 1552), (1, 16, 16, 2048),
             (1, 16, 16, 31)]
# (k, n) of the SLM's LoRA targets: q and o, k and v, mlp_in, mlp_out
K5_SHAPES = [(2048, 2048), (2048, 256), (2048, 32768), (16384, 2048)]
ADMIT_ROWS, ADMIT_REQUESTS = 1552, 8
HOT_SLOTS = [0, 3, -1, 1, 2, -1, 0, 3]


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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("time_k3_k5: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.moe_lora import kernel as KL

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    report = build.build_all(["flash_attention", "moe_lora"])
    ptxas = {name: [ln.strip() for ln in r["ptxas"].splitlines()
                    if "Used" in ln or "spill" in ln or "Compiling" in ln]
             for name, r in report.items()}
    dev = torch.device("cuda")
    res = dict(label=args.label, src=args.src, card=card, ptxas=ptxas,
               k3=[], k5=[])
    g = torch.Generator(device=dev).manual_seed(0)
    for b, h, kvh, s in K3_SHAPES:
        q, k, v = (torch.randn(b, n, s, 256, device=dev, generator=g)
                   .bfloat16() for n in (h, kvh, kvh))
        out = K3.flash_attention(q, k, v)
        torch.cuda.synchronize()
        err = row_rel_err(out, K3.flash_attention_plain(q, k, v))
        res["k3"].append(dict(
            B=b, H=h, KVH=kvh, S=s, row_rel_err=err,
            ms=time_ms(torch, lambda: K3.flash_attention(q, k, v),
                       20 if s > 512 else 200)))
        print(f"K3 {res['k3'][-1]}", file=sys.stderr)
        del q, k, v, out
    t = ADMIT_ROWS * ADMIT_REQUESTS
    for gates_kind in ("soft", "one-hot"):
        for k, n in K5_SHAPES:
            g = torch.Generator(device=dev).manual_seed(k + n)
            x = torch.randn(t, k, device=dev, generator=g).bfloat16()
            a = torch.randn(4, 16, k, device=dev, generator=g) / k ** 0.5
            b = torch.randn(4, n, 16, device=dev, generator=g)
            if gates_kind == "soft":
                gates = torch.rand(ADMIT_REQUESTS, 4, device=dev,
                                   generator=g)
            else:
                gates = torch.zeros(ADMIT_REQUESTS, 4, device=dev)
                for i, sl in enumerate(HOT_SLOTS):
                    if sl >= 0:
                        gates[i, sl] = 1.0

            def run():
                return KL.moe_lora_delta(x, a, b, gates,
                                         rows_per_gate=ADMIT_ROWS)
            out = run()
            torch.cuda.synchronize()
            ref = KL.moe_lora_delta_plain(x, a, b, gates,
                                          rows_per_gate=ADMIT_ROWS)
            live = gates.ne(0).any(1).repeat_interleave(ADMIT_ROWS)
            case = dict(k=k, n=n, gates=gates_kind,
                        row_rel_err=row_rel_err(out[live], ref[live]),
                        dead_rows_zero=not out[~live].any().item(),
                        ms=time_ms(torch, run, 10))
            if args.profile:
                case["kernels_ms"] = kernel_split(torch, run)
            res["k5"].append(case)
            print(f"K5 {case}", file=sys.stderr)
            del x, a, b, out, ref
            torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
