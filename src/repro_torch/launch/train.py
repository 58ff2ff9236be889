"""Training launcher of the port.

    python -m repro_torch.launch.train --local [--device cpu]

``--local`` runs end-to-end federated fine-tuning (``run_simulation``) on
the reduced config of ``--arch`` (the dense floe-slm-2b, the grouped
floe-slm-gemma3, the Mamba-1 falcon-mamba-7b or the zamba2-7b hybrid)
and prints the reference's per-round lines: on the card unless
``--device cpu``.  The
parameters are the reference launcher's, ``lm.init(jax.random.key(0))``
bit for bit (``LM.init_keyed``), so on the CPU the lines are the
reference's within float32 rounding.  Without ``--local`` the
reference lowers the train step onto a production mesh; that mode is
Queue 1 item 10 (multi-GPU placement) of the port and raises here.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="floe-slm-2b")
    ap.add_argument("--local", action="store_true")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--clients", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if not args.local:
        raise NotImplementedError(
            "the production-mesh train step: Queue 1 item 10 (multi-GPU "
            "placement and dry-run accounting) of the port; run --local")
    from repro_torch.configs import get_config
    from repro_torch.federated.simulation import SimConfig, run_simulation
    from repro_torch.models.model import LM
    cfg = get_config(args.arch).reduced()
    lm = LM(cfg, device=args.device)
    params = lm.init_keyed(0)
    sim = SimConfig(num_clients=args.clients, rounds=args.rounds)
    res = run_simulation(lm, params, sim)
    for i, h in enumerate(res.server.state.history):
        print(f"round {i}: {h}")
    print(f"experts: {res.server.state.history[-1]['clusters']}, "
          f"dropped: {res.dropped_per_round}")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
