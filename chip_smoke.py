#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:
  1. device   the card's name and power limit;
  2. build    every CUDA kernel of the serving path, from ``csrc/``;
  3. kernels  each kernel against its plain PyTorch version on the card
              at the main path's shapes, timed with CUDA events beside
              its bound and (where one exists) a library call;
  4. check    the reduced 2b pair in bf16 on the card against the same
              parameters in f32 on the CPU (the port's plain path);
  5. cli      ``python -m repro_torch.launch.serve --local`` as a user
              runs it on the card (the reduced pair, bf16);
  6. serve    the full-width 2b pair (floe-slm-2b + floe-llm-7b, bf16,
              random weights from a seed) through ServingDeployment and
              Scheduler.from_deployment: the four demo prompts of the
              serving launcher plus a ~1,500-byte one, 16 greedy tokens
              each, with every kernel's launch count read around the run;
              then a torch.profiler breakdown of one more request.
Then it prints the ``{"kernels": [...]}`` line, the nvidia-smi line and,
last, ``{"ok": true, "device": {...}}``.  Without a card it exits 2.
"""
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12         # dense tensor-core peak
F32_FLOP_PER_S = 67e12           # outside the tensor cores
# K1: every f32 probability against its own |ref| (the softmax sums are
# reduced in another order).
K1_RTOL = 1e-5
# K3: per query row, max|out - ref| / max|ref|.  Two bf16 roundings of
# the output (one ulp is 2**-7 of a value) plus P rounded to bf16 before
# P V, where the plain version keeps f32.
K3_ROW_RTOL = 2 ** -6
# Reduced pair, bf16 on the card vs f32 on the CPU: logits relative to
# max|ref|, and the Eq. 14 fusion weights absolute.
LOGITS_TOL = 1e-2
FUSION_W_TOL = 1e-4
LONG_PROMPT = ("explain how rainbows form when sunlight passes through "
               "falling raindrops and why the colors always appear in the "
               "same order across the sky. ") * 11


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def time_ms(torch, fn, iters: int) -> float:
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


def rel_err(out, ref) -> float:
    """max over elements of |out - ref| / |ref|."""
    return ((out.float() - ref.float()).abs() / ref.float().abs()).max().item()


def row_rel_err(out, ref) -> float:
    """max over rows (the last axis) of max|out - ref| / max|ref|."""
    out, ref = out.float(), ref.float()
    return ((out - ref).abs().amax(-1) / ref.abs().amax(-1)).max().item()


def bound(nbytes: float, flops: float, flop_rate: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels(torch, long_len: int):
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.logit_fusion import kernel as K1
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    k1_cases = []
    for b in (1, 4):
        sl = 3 * torch.randn(b, 256_000, device=dev, generator=g)
        ll = 3 * torch.randn(b, 256_000, device=dev, generator=g)
        w = torch.rand(b, device=dev, generator=g)
        arrived = torch.tensor([True, False, True, False][:b], device=dev)
        out = K1.fuse_logits(sl, ll, w, arrived)
        torch.cuda.synchronize()
        ref = K1.fuse_logits_plain(sl, ll, w, arrived)
        nbytes = 3 * b * 256_000 * 4 + b * 8
        bms, by = bound(nbytes, 12 * b * 256_000, F32_FLOP_PER_S)
        k1_cases.append(dict(
            shape=[b, 256_000], dtype="float32",
            max_abs_err=(out - ref).abs().max().item(),
            max_rel_err=rel_err(out, ref),
            ms=time_ms(torch, lambda: K1.fuse_logits(sl, ll, w, arrived), 50),
            plain_ms=time_ms(torch, lambda: K1.fuse_logits_plain(
                sl, ll, w, arrived), 20),
            library_ms=None, bound_ms=bms, bound_by=by))
        print(f"K1 fuse_logits B={b}: {k1_cases[-1]}")

    k3_cases = []
    shapes = [(8, 1, s, 0) for s in (31, long_len, 2048)] + \
             [(16, 16, s, 0) for s in (31, long_len, 2048)] + \
             [(16, 16, 2048, 512)]
    for h, kvh, s, window in shapes:
        d = 256
        q = torch.randn(1, h, s, d, device=dev, generator=g).bfloat16()
        k = torch.randn(1, kvh, s, d, device=dev, generator=g).bfloat16()
        v = torch.randn(1, kvh, s, d, device=dev, generator=g).bfloat16()
        out = K3.flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        ref = K3.flash_attention_plain(q, k, v, window=window)
        if window:
            mask = K3.attention_mask(s, True, window, dev)

            def lib():
                return F.scaled_dot_product_attention(q, k, v,
                                                      attn_mask=mask)
        else:
            def lib():
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=kvh != h)
        visible = sum(min(i + 1, window or s) for i in range(s))
        nbytes = 2 * (2 * h * s * d + 2 * kvh * s * d)
        bms, by = bound(nbytes, 4 * d * h * visible, BF16_FLOP_PER_S)
        iters = 20 if s > 512 else 200
        k3_cases.append(dict(
            shape=dict(B=1, H=h, KVH=kvh, S=s, D=d, window=window),
            dtype="bfloat16",
            max_abs_err=(out.float() - ref.float()).abs().max().item(),
            max_rel_err=row_rel_err(out, ref),
            ms=time_ms(torch, lambda: K3.flash_attention(
                q, k, v, window=window), iters),
            plain_ms=time_ms(torch, lambda: K3.flash_attention_plain(
                q, k, v, window=window), max(5, iters // 10)),
            library_ms=time_ms(torch, lib, iters),
            library_max_rel_err=row_rel_err(lib(), ref),
            bound_ms=bms, bound_by=by))
        print(f"K3 flash_attention: {k3_cases[-1]}")
        del q, k, v, out, ref
    bad = [c for c in k1_cases if not c["max_rel_err"] <= K1_RTOL] + \
          [c for c in k3_cases if not c["max_rel_err"] <= K3_ROW_RTOL]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    return k1_cases, k3_cases


def phase_check(torch):
    """Reduced 2b pair: bf16 on the card (K1, K3) vs f32 on the CPU."""
    from repro_torch import bridge
    from repro_torch.configs.floe_pair import pair_configs
    from repro_torch.core import fusion as FUS
    from repro_torch.data import tokenizer as TOK
    from repro_torch.models.model import LM
    from repro_torch.serving.deployment import ServingDeployment
    from repro_torch.serving.engine import HybridEngine

    # one set of f32 parameters, made on the CPU and cast for the card
    cfgs = pair_configs("2b")                  # reduced, float32
    base = [bridge.to_numpy(LM(c, device="cpu").init(i))
            for i, c in enumerate(cfgs)]
    mlp = FUS.init_alignment(2, cfgs[0].vocab_size, device="cpu")
    deps = {}
    for dev, dtype in (("cpu", "float32"), ("cuda", "bfloat16")):
        slm, llm = (LM(dataclasses.replace(c, dtype=dtype), device=dev)
                    for c in cfgs)
        sp, lp = (bridge.from_numpy(p, device=dev,
                                    dtype=getattr(torch, dtype))
                  for p in base)
        deps[dev] = ServingDeployment(slm, sp, llm, lp, mlp, max_seq=96,
                                      device=dev)
    prompt = "translate to french: water ->"
    worst = 0.0
    for name in ("slm", "llm"):
        logits = {}
        for dev, dep in deps.items():
            lm, params = getattr(dep, name), getattr(dep, f"{name}_params")
            toks = dep.tokens(TOK.encode(prompt + " "))
            lg, cache = lm.prefill(params, toks, dep.max_seq)
            steps = [lg]
            for t in (40, 41, 42, 43):
                lg, cache = lm.decode_step(params, cache, dep.tokens([t]))
                steps.append(lg)
            logits[dev] = torch.cat(steps, 1).float().cpu()
        ref = logits["cpu"]
        rel = ((logits["cuda"] - ref).abs().max() / ref.abs().max()).item()
        print(f"check {name}: prefill+4 decode logits, bf16 card vs f32 "
              f"cpu, max|diff|/max|ref| = {rel:.3e}")
        worst = max(worst, rel)
    runs = {dev: HybridEngine(dep).generate(prompt, 6, rid=0)[1]
            for dev, dep in deps.items()}
    dw = max(abs(a - b) for a, b in zip(runs["cuda"].fusion_w,
                                        runs["cpu"].fusion_w))
    print(f"check engine: latency_ms equal="
          f"{runs['cuda'].latency_ms == runs['cpu'].latency_ms}, "
          f"max |fusion_w diff| = {dw:.3e}")
    if not (worst <= LOGITS_TOL and dw <= FUSION_W_TOL
            and runs["cuda"].latency_ms == runs["cpu"].latency_ms):
        raise SystemExit("reduced-pair check failed")


def phase_cli():
    """The serving launcher's ``--local`` run, on its default device."""
    from repro_torch.launch import serve
    res = serve.main(["--local"])
    for r in res:
        if r.stats.tokens == 0 or (r.stats.private and r.stats.cloud_tokens):
            raise SystemExit(f"serve --local: bad request {r.rid}: {r.stats}")
    if sum(r.stats.private for r in res) != 2:
        raise SystemExit("serve --local: the detector missed a private prompt")


def phase_serve(torch):
    from repro_torch.configs.floe_pair import pair_configs
    from repro_torch.core import fusion as FUS
    from repro_torch.data import tokenizer as TOK
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.logit_fusion import kernel as K1
    from repro_torch.launch.serve import DEMO_PROMPTS
    from repro_torch.models.model import LM
    from repro_torch.serving.deployment import ServingDeployment
    from repro_torch.serving.scheduler import Scheduler, summarize

    scfg, lcfg = pair_configs("2b", reduced=False)
    t0 = time.perf_counter()
    slm, llm = LM(scfg), LM(lcfg)
    dep = ServingDeployment(slm, slm.init(0), llm, llm.init(1),
                            FUS.init_alignment(2, scfg.vocab_size),
                            max_seq=2048)
    torch.cuda.synchronize()
    print(f"serve: full-width pair initialised on the card in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    sched = Scheduler.from_deployment(dep)
    prompts = list(DEMO_PROMPTS) + [LONG_PROMPT]
    for p in prompts:
        sched.submit(p, max_new_tokens=16)
    kernels = (K1.fuse_logits, K3.flash_attention)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}

    for r in res:
        print(f"[{r.rid}] {r.status.value} private={r.stats.private} "
              f"cloud={r.stats.cloud_tokens}/{r.stats.tokens} "
              f"lat={r.stats.mean_latency_ms:.0f}ms  {r.text!r}")
    print(summarize(res))
    tokens = sum(r.stats.tokens for r in res)
    print(f"serve: {tokens} tokens in {wall:.3f} s = {tokens / wall:.2f} "
          f"tokens/s (5 requests, sequential, prefill included); peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {launches}; long prompt "
          f"{len(TOK.encode(LONG_PROMPT + ' '))} tokens")

    private = {1, 3}
    for r in res:
        if (r.rid in private) != r.stats.private:
            raise SystemExit(f"privacy detector disagrees on rid {r.rid}")
        if r.stats.private and r.stats.cloud_tokens:
            raise SystemExit(f"private rid {r.rid} used the cloud")
        w = r.stats.fusion_w
        if r.stats.tokens == 0 or not all(0.0 <= x <= 1.0 for x in w) \
                or not all(math.isfinite(x) for x in r.stats.latency_ms):
            raise SystemExit(f"bad output on rid {r.rid}: {r.stats}")
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel of the path never launched: {launches}")
    toks = dep.tokens(TOK.encode(DEMO_PROMPTS[0] + " "))
    for lm, params in ((slm, dep.slm_params), (llm, dep.llm_params)):
        logits, _ = lm.prefill(params, toks, 64)
        if logits.shape != (1, 1, 256_000) or \
                not torch.isfinite(logits).all():
            raise SystemExit(f"{lm.cfg.name}: bad prefill logits")
    trace(torch, sched.engine)
    return launches


def trace(torch, engine):
    """Device time by kernel and the device's busy share over one
    cloud-eligible request (16 tokens), from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import DEMO_PROMPTS

    def one():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate(DEMO_PROMPTS[2], 16, rid=99)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    wall_ms = one()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_ms = one()
    # device kernels only: an operator's row repeats its kernels' time
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"trace: one cloud request of 16 tokens: {wall_ms:.2f} ms "
          f"untraced, {traced_ms:.2f} ms traced; device busy {busy:.2f} ms "
          f"= {100 * busy / wall_ms:.1f}% of the untraced wall; "
          f"{sum(r[1] for r in rows)} kernel launches")
    for ms, n, key in rows[:12]:
        print(f"  {ms:9.3f} ms  {n:6d} x  {key[:100]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.data import tokenizer as TOK

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = smi()
    print(f"device: {name} ({torch.cuda.device_count()} visible); "
          f"nvidia-smi: {card}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    report = build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(report)}")
    for k, r in report.items():
        used = [ln.strip() for ln in r["ptxas"].splitlines() if "Used" in ln]
        print(f"  {k}: {r['seconds']:.2f} s; {used}")

    long_len = len(TOK.encode(LONG_PROMPT + " "))
    k1_cases, k3_cases = phase_kernels(torch, long_len)
    phase_check(torch)
    phase_cli()
    launches = phase_serve(torch)

    k1, k3 = k1_cases[-1], k3_cases[-2]       # (4, V) f32; H=16, S=2048
    kernels = [
        dict(name="fuse_logits", route="cuda",
             source="src/repro_torch/kernels/csrc/fuse_logits.cu",
             replaces="src/repro/kernels/logit_fusion/kernel.py:45",
             launches=launches["fuse_logits"],
             max_abs_err=max(c["max_abs_err"] for c in k1_cases),
             max_rel_err=max(c["max_rel_err"] for c in k1_cases),
             rel_tol=K1_RTOL, shape=k1["shape"], ms=k1["ms"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None, cases=k1_cases),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:80",
             launches=launches["flash_attention"],
             max_abs_err=max(c["max_abs_err"] for c in k3_cases),
             max_rel_err=max(c["max_rel_err"] for c in k3_cases),
             rel_tol=K3_ROW_RTOL, shape=k3["shape"], ms=k3["ms"],
             plain_ms=k3["plain_ms"], bound_ms=k3["bound_ms"],
             bound_by=k3["bound_by"], library_ms=k3["library_ms"],
             cases=k3_cases),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
