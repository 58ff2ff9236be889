#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:
  1. device   the card's name and power limit;
  2. build    every CUDA kernel of the serving paths, from ``csrc/``, one
              ``nvcc`` per source, all started together;
  3. kernels  each kernel (K1 fusion, K2 paged decode attention, K3
              prefill flash attention) against its plain PyTorch version
              on the card at the main paths' shapes, timed with CUDA
              events beside its bound and (where one exists) a library
              call;
  4. check    the reduced 2b pair in bf16 on the card against the same
              parameters in f32 on the CPU (the port's plain path): the
              sequential prefill/decode and engine, paged decode of a
              ragged batch of three, and the batched engine;
  5. cli      ``python -m repro_torch.launch.serve --local`` as a user
              runs it on the card (the reduced pair, bf16), sequential
              and ``--batch 4 --macro-k 0``;
  6. serve    the full-width 2b pair (floe-slm-2b + floe-llm-7b, bf16,
              random weights from a seed) through ServingDeployment and
              Scheduler.from_deployment: the four demo prompts of the
              serving launcher plus a 1,542-token one, 16 greedy tokens
              each, with every kernel's launch count read around the run;
              then a torch.profiler breakdown of one more request;
  7. serve_batched  the same deployment through
              ContinuousBatchScheduler on paged lanes (8 rows, macro_k=0,
              lazy pages): 20 requests, 16 cloud-eligible (the long
              prompt twice) and 4 private, 16 greedy tokens each but 40
              for four cloud requests (one lazily reserved decode page
              covers 15 decode writes, so only longer budgets grow
              pages); every launch count read around the run, K2's held
              to the decode layer-steps; then a torch.profiler breakdown
              of one full boundary step and one tail step (a few short
              rows among parked ones).
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
# K2: per (row, head), max|out - ref| / max|ref| over head_dim: one bf16
# rounding of the output plus f32 sums in another order.  Parked rows
# are excluded: their output is never read.
K2_ROW_RTOL = 2 ** -6
FREED_POS = 1 << 30
NO_PAGE = 1 << 20
K2_POSITIONS = [0, 15, 16, 700, 1541, 2047, FREED_POS, 1541]
# the tail of a batched run: a few short live rows among parked ones
K2_TAIL_POSITIONS = [40, 47, 52, 63] + [FREED_POS] * 4
LONG_PROMPT = ("explain how rainbows form when sunlight passes through "
               "falling raindrops and why the colors always appear in the "
               "same order across the sky. ") * 11
# serve_batched traffic: (prompt, max_new_tokens); 16 cloud-eligible, the
# long prompt twice, and 4 private (rids 2, 7, 12, 17)
BATCHED_REQUESTS = [
    (LONG_PROMPT, 16), ("what is the capital of france", 16),
    ("my ssn is 123-45-6789, fill the benefits form", 16),
    ("summarize the plot of hamlet in one line", 40),
    ("math: compute 12 plus 7 =", 16), ("translate to french: water ->", 16),
    ("list three colors that mix into brown", 16),
    ("my doctor said my blood pressure is 140 over 90", 16),
    ("write a haiku about the sea at night", 40),
    (LONG_PROMPT, 16), ("sort ascending: 40 12 77 31 ->", 16),
    ("name the largest planet in the solar system", 16),
    ("my credit card number is 4111 1111 1111 1111", 16),
    ("explain photosynthesis to a ten year old", 40),
    ("give two synonyms for quick", 16),
    ("what does a compiler do, in one sentence", 16),
    ("how many legs does a spider have", 16),
    ("call me at 555-123-4567 about my diagnosis", 16),
    ("describe the water cycle step by step", 40),
    ("translate to german: good morning ->", 16),
]


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


def paged_case(torch, g, h, kvh, window, positions, n_pool=1024, hd=256):
    """Random bf16 pages and block tables as the allocator builds them: a
    live plain row maps the pages its position needs (NO_PAGE past
    that), a ring row a full ring of window / 16 pages, a parked row
    nothing."""
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


def phase_k2(torch):
    """K2 at both full-width geometries (B=8, hd 256, 16-slot pages,
    nb 128, a 1,024-page pool): rows at K2_POSITIONS (one parked), plain
    and window=512 on a ring-local table, then the batched run's tail
    (K2_TAIL_POSITIONS, half the rows parked), plain."""
    from repro_torch.kernels.paged_attention import kernel as K2

    g = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    runs = [(m, h, kvh, w, K2_POSITIONS)
            for m, h, kvh in (("slm", 8, 1), ("llm", 16, 16))
            for w in (0, 512)]
    runs += [(m, h, kvh, 0, K2_TAIL_POSITIONS)
             for m, h, kvh in (("slm", 8, 1), ("llm", 16, 16))]
    for model, h, kvh, window, positions in runs:
        args = paged_case(torch, g, h, kvh, window, positions)
        out = K2.paged_decode_attention(*args, window=window)
        torch.cuda.synchronize()
        ref = K2.paged_decode_attention_plain(*args, window=window)
        live = [i for i, p in enumerate(positions) if p < FREED_POS]
        parked = [i for i, p in enumerate(positions) if p >= FREED_POS]
        if out[parked].any():
            raise SystemExit("K2 wrote a non-zero parked row")
        # bytes: each live row's mapped pages of K and V once, q and
        # the output; ops: 2 * 2 * H * hd per live slot (QK and PV)
        need = [min(p + 1, window) if window else p + 1
                for p in positions if p < FREED_POS]
        pages, slots = sum(-(-n // 16) for n in need), sum(need)
        nbytes = pages * 16 * kvh * 256 * 2 * 2 + 2 * 8 * h * 256 * 2
        bms, by = bound(nbytes, 4 * h * 256 * slots, BF16_FLOP_PER_S)
        cases.append(dict(
            shape=dict(model=model, B=8, H=h, KV=kvh, hd=256, ps=16,
                       nb=args[3].shape[1], pool=1024, window=window,
                       pos=positions),
            dtype="bfloat16",
            max_abs_err=(out[live].float() - ref[live].float()
                         ).abs().max().item(),
            max_rel_err=row_rel_err(out[live], ref[live]),
            ms=time_ms(torch, lambda: K2.paged_decode_attention(
                *args, window=window), 100),
            plain_ms=time_ms(torch, lambda: K2.paged_decode_attention_plain(
                *args, window=window), 10),
            library_ms=None, bound_ms=bms, bound_by=by,
            live_pages=pages))
        print(f"K2 paged_decode_attention: {cases[-1]}")
        del args, out, ref
    bad = [c for c in cases if not c["max_rel_err"] <= K2_ROW_RTOL]
    if bad:
        raise SystemExit(f"K2 disagrees with its plain version: {bad}")
    return cases


def phase_kernels(torch, long_len: int):
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.logit_fusion import kernel as K1
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    k1_cases = []
    for b in (1, 4, 8):
        sl = 3 * torch.randn(b, 256_000, device=dev, generator=g)
        ll = 3 * torch.randn(b, 256_000, device=dev, generator=g)
        w = torch.rand(b, device=dev, generator=g)
        arrived = torch.tensor([True, False, True, False] * 2,
                               device=dev)[:b]
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
    shapes = [(1, 8, 1, s, 0) for s in (31, long_len, 2048)] + \
             [(1, 16, 16, s, 0) for s in (31, long_len, 2048)] + \
             [(1, 16, 16, 2048, 512), (8, 8, 1, 1552, 0),
              (8, 16, 16, 1552, 0)]
    for bsz, h, kvh, s, window in shapes:
        d = 256
        q = torch.randn(bsz, h, s, d, device=dev, generator=g).bfloat16()
        k = torch.randn(bsz, kvh, s, d, device=dev, generator=g).bfloat16()
        v = torch.randn(bsz, kvh, s, d, device=dev, generator=g).bfloat16()
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
        visible = bsz * sum(min(i + 1, window or s) for i in range(s))
        nbytes = 2 * bsz * (2 * h * s * d + 2 * kvh * s * d)
        bms, by = bound(nbytes, 4 * d * h * visible, BF16_FLOP_PER_S)
        iters = 20 if s > 512 else 200
        k3_cases.append(dict(
            shape=dict(B=bsz, H=h, KVH=kvh, S=s, D=d, window=window),
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
    check_paged(torch, deps)


def paged_logits(torch, dep, lm, params, prompts, forced):
    """Packed prefill of ``prompts`` straight into pool pages (every row
    mapped eagerly), then one paged decode step per forced token:
    (B, 1 + len(forced), V) float32 logits on the host."""
    import numpy as np
    from repro_torch.data import tokenizer as TOK

    ids = [TOK.encode(p + " ") for p in prompts]
    b, nb = len(ids), dep.paged_geometry(lm)["nb"]
    cache = dep.init_paged_lane_cache(lm, b, b * nb)
    tables = np.arange(b * nb, dtype=np.int32).reshape(b, nb)
    lens = np.array([len(x) for x in ids], np.int32)
    toks = np.zeros((b, -(-int(lens.max()) // 16) * 16), np.int64)
    for i, x in enumerate(ids):
        toks[i, :len(x)] = x
    rows = list(range(b))
    logits = lm.prefill_packed(
        params, torch.as_tensor(toks, device=dep.device), lens, dep.max_seq,
        dep.page_writer(cache, rows, tables))
    dep.finish_paged_insert(cache, rows, lens, tables)
    steps = [logits]
    for t in forced:
        logits, cache = lm.decode_step(params, cache, torch.full(
            (b, 1), t, dtype=torch.int64, device=dep.device))
        steps.append(logits)
    return torch.cat(steps, 1).float().cpu()


def check_paged(torch, deps):
    """Paged decode (K2 on the card) of a ragged batch of three with
    forced tokens, then the batched engine, bf16 card vs f32 CPU."""
    from repro_torch.launch.serve import DEMO_PROMPTS
    from repro_torch.serving.scheduler import ContinuousBatchScheduler

    prompts = ["translate to french: water ->", "math: compute 12 plus 7 =",
               "explain how rainbows form when sunlight passes through rain"]
    worst = 0.0
    for name in ("slm", "llm"):
        logits = {dev: paged_logits(torch, dep, getattr(dep, name),
                                    getattr(dep, f"{name}_params"), prompts,
                                    range(40, 48))
                  for dev, dep in deps.items()}
        ref = logits["cpu"]
        rel = ((logits["cuda"] - ref).abs().max() / ref.abs().max()).item()
        print(f"check paged {name}: packed prefill (B=3, ragged) + 8 paged "
              f"decode steps, bf16 card vs f32 cpu, max|diff|/max|ref| = "
              f"{rel:.3e}")
        worst = max(worst, rel)
    res = {}
    for dev, dep in deps.items():
        sched = ContinuousBatchScheduler.from_deployment(dep, batch_size=4,
                                                         macro_k=0)
        for p in DEMO_PROMPTS:
            sched.submit(p, 6)
        res[dev] = sched.run()
    lat_eq = all(a.stats.latency_ms == b.stats.latency_ms
                 for a, b in zip(res["cuda"], res["cpu"]))
    dw = max(abs(x - y) for a, b in zip(res["cuda"], res["cpu"])
             for x, y in zip(a.stats.fusion_w, b.stats.fusion_w))
    print(f"check batched engine: latency_ms equal={lat_eq}, max "
          f"|fusion_w diff| = {dw:.3e}")
    if not (worst <= LOGITS_TOL and lat_eq and dw <= FUSION_W_TOL):
        raise SystemExit("reduced-pair paged check failed")


def phase_cli():
    """The serving launcher's ``--local`` run, on its default device,
    sequential and batched."""
    from repro_torch.launch import serve
    for argv in (["--local"], ["--local", "--batch", "4", "--macro-k", "0"]):
        res = serve.main(argv)
        for r in res:
            if r.stats.tokens == 0 or (r.stats.private
                                       and r.stats.cloud_tokens):
                raise SystemExit(f"serve {argv}: bad request {r.rid}: "
                                 f"{r.stats}")
        if sum(r.stats.private for r in res) != 2:
            raise SystemExit(f"serve {argv}: the detector missed a private "
                             "prompt")


def full_pair(torch):
    """The full-width 2b pair on the card, bf16, random weights from
    seeds 0/1/2, max_seq 2048 — one deployment for both serve phases."""
    from repro_torch.configs.floe_pair import pair_configs
    from repro_torch.core import fusion as FUS
    from repro_torch.models.model import LM
    from repro_torch.serving.deployment import ServingDeployment

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
    return dep


def phase_serve(torch, dep):
    from repro_torch.data import tokenizer as TOK
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.logit_fusion import kernel as K1
    from repro_torch.launch.serve import DEMO_PROMPTS
    from repro_torch.serving.scheduler import Scheduler, summarize

    slm, llm = dep.slm, dep.llm
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


def phase_serve_batched(torch, dep):
    """Continuous batching of the full-width pair on paged lanes."""
    from repro_torch.kernels.flash_attention import kernel as K3
    from repro_torch.kernels.logit_fusion import kernel as K1
    from repro_torch.kernels.paged_attention import kernel as K2
    from repro_torch.serving.scheduler import (ContinuousBatchScheduler,
                                               summarize)

    sched = ContinuousBatchScheduler.from_deployment(
        dep, batch_size=8, macro_k=0, lazy_pages=True)
    eng = sched.engine
    for p, n in BATCHED_REQUESTS:
        sched.submit(p, max_new_tokens=n)
    # count the lanes' decode dispatches: K2 must launch once per decode
    # layer of every one of them
    calls = {"slm": 0, "llm": 0}

    def counted(name, fn):
        def run(*a):
            calls[name] += 1
            return fn(*a)
        return run
    dep.slm_decode = counted("slm", dep.slm_decode)
    dep.llm_decode = counted("llm", dep.llm_decode)
    kernels = (K1.fuse_logits, K2.paged_decode_attention, K3.flash_attention)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    del dep.slm_decode, dep.llm_decode          # back to the methods

    for r in res:
        print(f"[{r.rid}] {r.status.value} private={r.stats.private} "
              f"cloud={r.stats.cloud_tokens}/{r.stats.tokens} "
              f"lat={r.stats.mean_latency_ms:.0f}ms "
              f"wait={r.queue_wait_seconds * 1e3:.0f}ms  {r.text!r}")
    print(summarize(res))
    tokens = sum(r.stats.tokens for r in res)
    layer_steps = (calls["slm"] * dep.slm.cfg.num_layers
                   + calls["llm"] * dep.llm.cfg.num_layers)
    print(f"serve_batched: {tokens} tokens in {wall:.3f} s = "
          f"{tokens / wall:.2f} tokens/s ({len(res)} requests, batch 8, "
          f"macro_k=0, prefill included); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; KV pool "
          f"{eng.kv_pool_bytes()} B; growth {eng.growth_stats()}; "
          f"launches {launches}; decode dispatches {calls} = "
          f"{layer_steps} decode layer-steps")

    private = {i for i, (p, _) in enumerate(BATCHED_REQUESTS)
               if eng.detector.detect(p)}
    if len(private) != 4 or {r.rid for r in res if r.stats.private} \
            != private:
        raise SystemExit(f"privacy split is wrong: {private}")
    for r, (_, n) in zip(res, BATCHED_REQUESTS):
        if r.stats.private and (r.stats.cloud_tokens or r.stats.cloud_calls):
            raise SystemExit(f"private rid {r.rid} used the cloud")
        w = r.stats.fusion_w
        if r.error or r.stats.tokens == 0 or r.stats.tokens > n \
                or not all(0.0 <= x <= 1.0 for x in w) \
                or not all(math.isfinite(x) for x in r.stats.latency_ms):
            raise SystemExit(f"bad output on rid {r.rid}: {r.stats}")
    if eng.growth_stats()["grown_pages"] <= 0:
        raise SystemExit("lazy growth never fired")
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel of the path never launched: {launches}")
    if launches["paged_decode_attention"] != layer_steps:
        raise SystemExit(f"K2 launched {launches['paged_decode_attention']} "
                         f"times for {layer_steps} decode layer-steps")
    if eng.resident_kv_bytes() != 0:
        raise SystemExit("pages leaked after the run")
    trace_batched(torch, eng)
    return launches


def profile_rows(torch, prof):
    """Device-kernel rows (ms, count, name) of a profile, largest first:
    an operator's row repeats its kernels' time, so only kernels."""
    from torch.autograd import DeviceType
    return sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)


def trace_batched(torch, eng):
    """Device time by kernel and the device's busy share over two batched
    boundary steps: 8 cloud rows (the long prompt among them) and 4
    private rows decoding one token each, then the tail of a run — 3
    short cloud rows among the parked rows of the drained lane."""
    reqs = [(p, 40) for p, _ in BATCHED_REQUESTS]
    cloud = [r for r in reqs if not eng.detector.detect(r[0])][:8]
    private = [r for r in reqs if eng.detector.detect(r[0])]
    flags = eng.add_requests([(p, n, True, 500 + i)
                              for i, (p, n) in enumerate(cloud + private)])
    if not all(flags):
        raise SystemExit("trace: a request was not admitted")
    profile_step(torch, eng, "one boundary step (8 cloud + 4 private rows)")
    while eng.active_count():
        eng.step()
    tail = [(p, 40, True, 600 + i) for i, (p, _) in enumerate(cloud[1:4])]
    if not all(eng.add_requests(tail)):
        raise SystemExit("trace: a tail request was not admitted")
    profile_step(torch, eng, "one tail step (3 short cloud rows, 5 parked)")
    while eng.active_count():
        eng.step()


def profile_step(torch, eng, what: str):
    """Three warm-up steps, then one boundary step timed untraced and one
    under torch.profiler: wall, device busy share, K2's device time and
    the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        eng.step()

    def one():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    wall_ms = one()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_ms = one()
    rows = profile_rows(torch, prof)
    busy = sum(r[0] for r in rows)
    k2 = [r for r in rows if "paged_decode" in r[2]]
    print(f"trace_batched: {what}: {wall_ms:.2f} ms untraced, "
          f"{traced_ms:.2f} ms traced; device busy {busy:.2f} ms = "
          f"{100 * busy / wall_ms:.1f}% of the untraced wall; K2 "
          f"{sum(r[0] for r in k2):.3f} ms over {sum(r[1] for r in k2)} "
          f"launches; {sum(r[1] for r in rows)} kernel launches")
    for ms, n, key in rows[:12]:
        print(f"  {ms:9.3f} ms  {n:6d} x  {key[:100]}")


def trace(torch, engine):
    """Device time by kernel and the device's busy share over one
    cloud-eligible request (16 tokens), from ``torch.profiler``."""
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
    rows = profile_rows(torch, prof)
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
    k2_cases = phase_k2(torch)
    phase_check(torch)
    phase_cli()
    dep = full_pair(torch)
    seq_launches = phase_serve(torch, dep)
    launches = phase_serve_batched(torch, dep)
    by_path = {name: {"serve": seq_launches.get(name, 0),
                      "serve_batched": launches[name]}
               for name in launches}

    # (8, V) f32; H=16, S=2048, B=1; LLM B=8, plain table
    k1, k3, k2 = k1_cases[-1], k3_cases[5], k2_cases[2]
    kernels = [
        dict(name="fuse_logits", route="cuda",
             source="src/repro_torch/kernels/csrc/fuse_logits.cu",
             replaces="src/repro/kernels/logit_fusion/kernel.py:45",
             launches=launches["fuse_logits"],
             launches_by_path=by_path["fuse_logits"],
             max_abs_err=max(c["max_abs_err"] for c in k1_cases),
             max_rel_err=max(c["max_rel_err"] for c in k1_cases),
             rel_tol=K1_RTOL, shape=k1["shape"], ms=k1["ms"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None, cases=k1_cases),
        dict(name="paged_decode_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention/kernel.py:132",
             launches=launches["paged_decode_attention"],
             launches_by_path=by_path["paged_decode_attention"],
             max_abs_err=max(c["max_abs_err"] for c in k2_cases),
             max_rel_err=max(c["max_rel_err"] for c in k2_cases),
             rel_tol=K2_ROW_RTOL, shape=k2["shape"], ms=k2["ms"],
             plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None, cases=k2_cases),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:80",
             launches=launches["flash_attention"],
             launches_by_path=by_path["flash_attention"],
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
