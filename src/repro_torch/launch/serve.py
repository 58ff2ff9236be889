"""Serving launcher — the port of ``repro/launch/serve.py --local``.

    PYTHONPATH=src python -m repro_torch.launch.serve --local [--device cpu]

serves the four demo prompts through the sequential hybrid engine on the
reduced ``2b`` pair, printing one line per request and the summary, as
the reference does.  It runs on CUDA unless ``--device cpu`` is given;
on CUDA the pair is served in bfloat16 (the flash-attention kernel takes
bfloat16), on the CPU in the configs' float32.
``--batch`` takes 0 or 1 (both the sequential engine); the reference's
other flags belong to later slices and are refused.
"""
import argparse
import dataclasses
import sys

LATER_SLICE_FLAGS = (
    "--arch", "--shape", "--multi-pod", "--mesh-devices", "--rules",
    "--model-parallel", "--macro-k", "--spec-k", "--dense", "--page-size",
    "--pool-pages", "--no-lazy-pages", "--max-ctx", "--chunk-width",
    "--fault-rate", "--outage", "--fault-seed", "--deadline-ms", "--sample",
    "--sample-seed", "--adapters", "--adapter-slots", "--adapter-rank")

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
                    help="0 or 1: the sequential engine (continuous "
                         "batching is a later slice)")
    ap.add_argument("--pair", default="2b",
                    help="2b (the gemma3 pair is a later slice)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args, rest = ap.parse_known_args(argv)
    for arg in rest:
        flag = arg.split("=", 1)[0]
        if flag in LATER_SLICE_FLAGS:
            ap.error(f"{flag}: later slice")
        ap.error(f"unrecognized argument {arg}")
    if args.batch > 1:
        ap.error("--batch > 1 (continuous batching): later slice")
    if args.pair != "2b":
        ap.error(f"--pair {args.pair}: later slice")
    if not args.local:
        ap.error("only --local serving is ported; the dry-run lowering is "
                 "a later slice")

    from repro_torch import resolve_device
    from repro_torch.configs.floe_pair import pair_configs
    from repro_torch.core import fusion as FUS
    from repro_torch.models.model import LM
    from repro_torch.serving.deployment import ServingDeployment
    from repro_torch.serving.latency import LatencyModel
    from repro_torch.serving.scheduler import Scheduler, summarize

    device = resolve_device(args.device)
    slm_cfg, llm_cfg = pair_configs(args.pair)
    if device.type == "cuda":
        slm_cfg, llm_cfg = (dataclasses.replace(c, dtype="bfloat16")
                            for c in (slm_cfg, llm_cfg))
    slm, llm = LM(slm_cfg, device=device), LM(llm_cfg, device=device)
    dep = ServingDeployment(
        slm, slm.init(0), llm, llm.init(1),
        FUS.init_alignment(2, slm_cfg.vocab_size, device=device),
        latency=LatencyModel(rtt_ms=args.rtt_ms),
        timeout_ms=args.timeout_ms, device=device)
    sched = Scheduler.from_deployment(dep)
    for prompt in DEMO_PROMPTS:
        sched.submit(prompt, max_new_tokens=8)
    res = sched.run()
    for r in res:
        print(f"[{r.rid}] {r.status.value} private={r.stats.private} "
              f"cloud={r.stats.cloud_tokens}/{r.stats.tokens} "
              f"degraded={r.degraded_tokens} lost={r.cloud_lost} "
              f"lat={r.stats.mean_latency_ms:.0f}ms "
              f"wait={r.queue_wait_seconds * 1e3:.0f}ms  {r.text!r}")
    print(summarize(res))
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
