"""Serving launcher — the port of ``repro/launch/serve.py --local``.

    PYTHONPATH=src python -m repro_torch.launch.serve --local [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --local --batch 4 \
        [--macro-k 8] [--page-size 16] [--no-lazy-pages] [--device cpu] \
        [--dense | --pool-pages N] [--max-ctx N] [--chunk-width W]
    PYTHONPATH=src python -m repro_torch.launch.serve --local --batch 4 \
        --adapters 3 --adapter-slots 2 [--adapter-rank 4]
    PYTHONPATH=src python -m repro_torch.launch.serve --local \
        [--batch 4] --sample [--sample-seed 3]
    PYTHONPATH=src python -m repro_torch.launch.serve --local --batch 4 \
        [--spec-k 4] [--fault-rate 0.25] [--outage 10:3] [--fault-seed 3] \
        [--deadline-ms 400]

serves the four demo prompts on a reduced pair (``--pair 2b``, the
default, or ``--pair gemma3``, whose SLM keeps ring caches on its
sliding-window layers), printing one line per request and the summary,
as the reference does.  ``--batch``
0 or 1 is the sequential engine; ``--batch N>1`` builds the
continuous-batching scheduler on paged lanes (``--dense``: dense
stacked lane caches, the bit-exact parity oracle) and prints the
``lane KV: paged, pool capacity ...`` (or ``dense``) line;
``--pool-pages N`` gives each lane model a pool of N pages (0, the
default, sizes it for the dense worst case), so rows park, and a
wedged lane evicts and re-admits, when it runs short.  ``--adapters N
--adapter-slots E`` registers N per-user adapters (``user{j}``, rank
``--adapter-rank``) over an E-slot bank, spreads the demo requests over
them with one adapter-free row, and prints the cache's stats; fewer
slots than adapters exercises eviction.  ``--sample`` decodes every
request by keyed sampling from the fused distribution (K7), keyed from
``--sample-seed`` (default 0) and the request's rid.  A batched run
decodes ``--macro-k`` tokens a lane per dispatch (default 8, as in the
reference; a CUDA graph per lane on the card), and ``--macro-k 0``
takes the per-token step; both print the same per-request lines.  On
CUDA ``--page-size`` must be 16, the page size of the paged decode
kernel.  ``--max-ctx N`` (page-aligned, >= max_seq) widens the paged
context, so a prompt longer than the dense row streams through chunked
prefill up to N tokens; ``--chunk-width W`` (page-aligned, <= max_seq)
is the width of the chunks.  ``--spec-k K`` (batched only) decodes the
cloud lane in speculative bursts of K drafted tokens a cloud
round-trip; the summary's ``cloud_calls_per_token`` drops and
``accept_rate`` rises while the texts stay those of ``--spec-k 0``.
``--fault-rate R`` drops each cloud reply with probability R (a draw
keyed by (rid, step)), ``--outage P:L`` takes the link down for L of
every P decode steps, ``--fault-seed`` seeds both, and ``--deadline-ms
D`` cancels a request whose simulated clock reaches D ms; with any of
them the run ends with a ``link health:`` line.  It runs on CUDA unless
``--device cpu`` is given; on CUDA the pair is served in bfloat16 (the
attention kernels take bfloat16), on the CPU in the configs' float32.
The reference's mesh and dry-run flags belong to later slices and are
refused.
"""
import argparse
import dataclasses
import sys

LATER_SLICE_FLAGS = (
    "--arch", "--shape", "--multi-pod", "--mesh-devices", "--rules",
    "--model-parallel")

DEMO_PROMPTS = (
    "math: compute 12 plus 7 =",
    "my ssn is 123-45-6789, fill the benefits form",
    "translate to french: water ->",
    "my doctor said my blood pressure is 140 over 90",
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--local", action="store_true")
    ap.add_argument("--rtt-ms", type=float, default=50.0)
    ap.add_argument("--timeout-ms", type=float, default=200.0)
    ap.add_argument("--batch", type=int, default=0,
                    help="decode-batch width; >1 uses the continuous-"
                         "batching engine on paged lanes")
    ap.add_argument("--macro-k", type=int, default=8,
                    help="tokens a lane decodes per dispatch with one "
                         "host sync (0 = the per-token step)")
    ap.add_argument("--dense", action="store_true",
                    help="dense stacked lane caches (the paged=False "
                         "bit-exact oracle); default serves paged KV")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="page-pool capacity per lane model (0 = size "
                         "for the dense worst case, batch * max_seq)")
    ap.add_argument("--no-lazy-pages", action="store_true")
    ap.add_argument("--max-ctx", type=int, default=0,
                    help="paged context ceiling in tokens (>= max_seq, "
                         "page-aligned); prompts longer than the dense "
                         "row stream through chunked prefill up to "
                         "this length (0 = max_seq, no long prompts)")
    ap.add_argument("--chunk-width", type=int, default=0,
                    help="dense-buffer width for chunked long-prompt "
                         "prefill (page-aligned, <= max_seq; "
                         "0 = max_seq)")
    ap.add_argument("--pair", default="2b", choices=("2b", "gemma3"),
                    help="the FLOE_PAIRS model pair to serve")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--adapters", type=int, default=0,
                    help="register N per-user LoRA adapters and spread the "
                         "demo requests over them (one adapter-free row "
                         "stays in the mix); requires --adapter-slots")
    ap.add_argument("--adapter-slots", type=int, default=0,
                    help="resident adapter-cache capacity E (0 = no "
                         "adapter serving; E < --adapters evicts)")
    ap.add_argument("--adapter-rank", type=int, default=4,
                    help="LoRA rank of the demo adapters and their bank")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decode window: the SLM drafts K "
                         "tokens, one LLM verify scores them and rejected "
                         "drafts roll back (0 = off; needs --batch > 1)")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="per-token cloud-reply loss probability, drawn "
                         "per (rid, step) (0 = the fault-free path)")
    ap.add_argument("--outage", default="",
                    help="periodic cloud-link outages as PERIOD:LEN in "
                         "decode steps, e.g. 32:8 (empty = none)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the fault weather (loss draws and the "
                         "outage phase)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request decode deadline in simulated ms; "
                         "an expired request is cancelled with its "
                         "partial text (0 = none)")
    ap.add_argument("--sample", action="store_true",
                    help="non-greedy decoding (per-request PRNG keys)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="root seed of the per-request sampling keys")
    args, rest = ap.parse_known_args(argv)
    for arg in rest:
        flag = arg.split("=", 1)[0]
        if flag in LATER_SLICE_FLAGS:
            ap.error(f"{flag}: later slice")
        ap.error(f"unrecognized argument {arg}")
    if not args.local:
        ap.error("only --local serving is ported; the dry-run lowering is "
                 "a later slice")
    if args.adapters and not args.adapter_slots:
        ap.error("--adapters requires --adapter-slots > 0 (the resident "
                 "device-bank capacity)")
    if args.spec_k and args.batch <= 1:
        ap.error("--spec-k requires --batch > 1 (the draft/verify burst "
                 "runs on the batched cloud lane)")

    from repro_torch import resolve_device
    from repro_torch.configs.floe_pair import needs_ring_cache, pair_configs
    from repro_torch.core import fusion as FUS
    from repro_torch.core import lora as LORA
    from repro_torch.kernels.paged_attention.kernel import PAGE_SIZE
    from repro_torch.models.model import LM
    from repro_torch.serving.deployment import ServingDeployment
    from repro_torch.serving.latency import FaultModel, LatencyModel
    from repro_torch.serving.scheduler import (ContinuousBatchScheduler,
                                               Scheduler, summarize)

    device = resolve_device(args.device)
    if device.type == "cuda" and args.page_size != PAGE_SIZE:
        ap.error(f"--page-size {args.page_size}: the paged decode kernel "
                 f"on CUDA takes {PAGE_SIZE}")
    slm_cfg, llm_cfg = pair_configs(args.pair)
    if device.type == "cuda":
        slm_cfg, llm_cfg = (dataclasses.replace(c, dtype="bfloat16")
                            for c in (slm_cfg, llm_cfg))
    fault = None
    if args.fault_rate > 0.0 or args.outage:
        period, olen = ((int(x) for x in args.outage.split(":"))
                        if args.outage else (0, 0))
        fault = FaultModel(loss_rate=args.fault_rate, outage_period=period,
                           outage_len=olen, seed=args.fault_seed)
        print(f"fault weather: loss_rate={args.fault_rate} "
              f"outage={args.outage or 'none'} seed={args.fault_seed}")
    slm = LM(slm_cfg, device=device, ring_cache=needs_ring_cache(slm_cfg))
    llm = LM(llm_cfg, device=device)
    dep = ServingDeployment(
        slm, slm.init(0), llm, llm.init(1),
        FUS.init_alignment(2, slm_cfg.vocab_size, device=device),
        latency=LatencyModel(rtt_ms=args.rtt_ms),
        timeout_ms=args.timeout_ms, sample_seed=args.sample_seed,
        page_size=args.page_size, max_ctx=args.max_ctx or None,
        adapter_slots=args.adapter_slots, adapter_rank=args.adapter_rank,
        fault=fault, device=device)
    if args.batch > 1:
        sched = ContinuousBatchScheduler.from_deployment(
            dep, batch_size=args.batch, macro_k=args.macro_k,
            spec_k=args.spec_k, paged=not args.dense,
            lazy_pages=not args.no_lazy_pages,
            pool_pages=args.pool_pages or None,
            chunk_width=args.chunk_width or None)
        print(f"lane KV: {'dense' if args.dense else 'paged'}, pool "
              f"capacity {sched.engine.kv_pool_bytes()}B")
    else:
        sched = Scheduler.from_deployment(dep)
    aids = []
    if args.adapters:
        for j in range(args.adapters):
            sched.engine.adapters.register(f"user{j}", LORA.init_adapter(
                slm, 100 + j, rank=args.adapter_rank,
                r_max=dep.adapter_rank))
        print(f"adapters: {args.adapters} registered over "
              f"{args.adapter_slots} resident slots "
              f"(rank {args.adapter_rank})")
        # round-robin user ids, one adapter-free row in the mix
        aids = [f"user{j % args.adapters}" for j in range(3)] + [None]
    for i, prompt in enumerate(DEMO_PROMPTS):
        sched.submit(prompt, max_new_tokens=8, greedy=not args.sample,
                     adapter_id=aids[i] if aids else None,
                     deadline_ms=args.deadline_ms or None)
    res = sched.run()
    for r in res:
        print(f"[{r.rid}] {r.status.value} private={r.stats.private} "
              f"cloud={r.stats.cloud_tokens}/{r.stats.tokens} "
              f"degraded={r.degraded_tokens} lost={r.cloud_lost} "
              f"lat={r.stats.mean_latency_ms:.0f}ms "
              f"wait={r.queue_wait_seconds * 1e3:.0f}ms  {r.text!r}")
    print(summarize(res))
    if fault is not None or args.deadline_ms:
        print(f"link health: {sched.engine.health_stats()}")
    if args.adapters:
        print(f"adapter cache: {sched.engine.adapter_stats()}")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
