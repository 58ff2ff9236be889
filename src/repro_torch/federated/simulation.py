"""End-to-end federated fine-tuning simulation — the port of
``repro/federated/simulation.py`` (paper Sec. V testbed:
1 server + heterogeneous Jetson fleet, background workloads injected).

Drives rounds of: broadcast -> Algorithm-1 rank selection -> local LoRA
training -> (optional DP) -> upload -> clustered aggregation -> publish
expert bank + router.  Also implements the paper's baselines:

  SLM-Local   — each client fine-tunes alone, no aggregation
  SLM-FedAvg  — single global LoRA, uniform averaging (Eq. 4, M=1)
  Floe        — clustered aggregation + parameter-free router (full paper)
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core import lora as LORA
from repro_torch.core import prng
from repro_torch.core import rank_select as RS
from repro_torch.data.partition import partition_clients
from repro_torch.data.tasks import TASKS
from repro_torch.federated.client import (ClientState, ClientUpdate,
                                          LocalTrainer)
from repro_torch.federated.server import FloeServer


@dataclass
class SimConfig:
    num_clients: int = 8
    examples_per_client: int = 64
    alpha: float = 0.1                    # non-IID level 3
    rounds: int = 2
    local_steps: int = 8
    seq_len: int = 48
    batch_size: int = 8
    lr: float = 5e-3
    deadline: float = 1e9                 # round deadline T (Alg. 1)
    dp_clip: Optional[float] = None
    dp_noise: float = 0.0
    async_mode: bool = False
    beta: float = 0.5
    tasks: Sequence[str] = tuple(TASKS)
    seed: int = 0


@dataclass
class SimResult:
    server: FloeServer
    clients: List[ClientState]
    updates_per_round: List[List[ClientUpdate]]
    dropped_per_round: List[int]


def make_fleet(sim: SimConfig) -> List[ClientState]:
    """Heterogeneous fleet: mixed Jetson classes + random background load."""
    rng = random.Random(sim.seed)
    datasets = partition_clients(sim.num_clients, list(sim.tasks),
                                 sim.examples_per_client, sim.alpha, sim.seed)
    fleet = []
    for cid in range(sim.num_clients):
        dev = RS.DEVICE_CLASSES[cid % len(RS.DEVICE_CLASSES)]
        fleet.append(ClientState(cid, dev, datasets[cid],
                                 background_load=rng.uniform(0.0, 0.5)))
    return fleet


def run_simulation(lm, params, sim: SimConfig,
                   fleet: Optional[List[ClientState]] = None) -> SimResult:
    fleet = fleet or make_fleet(sim)
    trainer = LocalTrainer(lm, sim.seq_len, sim.batch_size, sim.lr,
                           sim.local_steps, sim.dp_clip, sim.dp_noise)
    lut = RS.build_lut(lm.cfg, tokens_per_step=sim.seq_len * sim.batch_size)
    server = FloeServer(beta=sim.beta, async_mode=sim.async_mode,
                        seed=sim.seed)

    base = LORA.init_adapter_keyed(lm, prng.key(sim.seed),
                                   rank=lm.cfg.lora_rank_max)
    rng = random.Random(sim.seed)
    all_updates, dropped = [], []
    for rnd in range(sim.rounds):
        init = server.state.global_adapter or base
        updates: List[ClientUpdate] = []
        n_drop = 0
        for client in fleet:
            # fresh runtime variance each round (paper Fig. 4 observation 2)
            client.background_load = rng.uniform(0.0, 0.6)
            upd = trainer.run_round(client, params, init, lut, sim.deadline,
                                    round_seed=sim.seed * 100 + rnd)
            if upd is None:
                n_drop += 1
                continue
            if sim.async_mode:
                upd.staleness = rng.expovariate(2.0)
            updates.append(upd)
        server.aggregate_round(updates)
        all_updates.append(updates)
        dropped.append(n_drop)
    return SimResult(server, fleet, all_updates, dropped)


# ---------------------------------------------------------------------------
# Baseline variants (Table III columns)
# ---------------------------------------------------------------------------


def run_local_only(lm, params, sim: SimConfig,
                   fleet: Optional[List[ClientState]] = None
                   ) -> List[Dict[str, Any]]:
    """SLM-Local: independent fine-tuning, no server."""
    fleet = fleet or make_fleet(sim)
    trainer = LocalTrainer(lm, sim.seq_len, sim.batch_size, sim.lr,
                           sim.local_steps * sim.rounds)
    lut = RS.build_lut(lm.cfg, tokens_per_step=sim.seq_len * sim.batch_size)
    base = LORA.init_adapter_keyed(lm, prng.key(sim.seed),
                                   rank=lm.cfg.lora_rank_max)
    out = []
    for client in fleet:
        upd = trainer.run_round(client, params, base, lut, sim.deadline,
                                round_seed=sim.seed)
        out.append(upd.adapter if upd else None)
    return out


def run_fedavg(lm, params, sim: SimConfig,
               fleet: Optional[List[ClientState]] = None) -> Dict[str, Any]:
    """SLM-FedAvg: uniform averaging of all client adapters (M=1)."""
    fleet = fleet or make_fleet(sim)
    trainer = LocalTrainer(lm, sim.seq_len, sim.batch_size, sim.lr,
                           sim.local_steps)
    lut = RS.build_lut(lm.cfg, tokens_per_step=sim.seq_len * sim.batch_size)
    global_a = LORA.init_adapter_keyed(lm, prng.key(sim.seed),
                                       rank=lm.cfg.lora_rank_max)
    for rnd in range(sim.rounds):
        ups = []
        for client in fleet:
            upd = trainer.run_round(client, params, global_a, lut,
                                    sim.deadline, sim.seed * 100 + rnd)
            if upd:
                ups.append(upd.adapter)
        if ups:
            global_a = LORA.average_adapters(ups)
    return global_a
