"""Federated edge client (paper Fig. 6 stages ②-③) — the port of
``repro/federated/client.py``.

Each client: selects its LoRA rank with Algorithm 1 under its device's
memory budget + the round deadline (heterogeneity adaptation), trains the
adapter on its private shard for E local steps with the frozen SLM base,
optionally privatises the update (DP-SGD), and uploads (adapter, public
task metadata, wall-time).  Seeds are the reference's: batches from
``round_seed * 1_000 + cid``, DP keys from ``round_seed * 77 + cid``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.core import lora as LORA
from repro_torch.core import prng
from repro_torch.core import rank_select as RS
from repro_torch.data import pipeline as PIPE
from repro_torch.data.partition import dominant_task
from repro_torch.data.tasks import Example, TASK_DOMAINS
from repro_torch.training import optimizer as OPT
from repro_torch.training import train_step as TS


@dataclass
class ClientState:
    cid: int
    device: RS.DeviceProfile
    dataset: List[Example]
    background_load: float = 0.0          # runtime variance
    rank: Optional[int] = None

    @property
    def task(self) -> str:
        return dominant_task(self.dataset)

    def public_samples(self) -> List[str]:
        # non-private representative samples (Eq. 9): generic templates of
        # the client's dominant task, NOT its private examples
        return TASK_DOMAINS[self.task]


@dataclass
class ClientUpdate:
    cid: int
    adapter: Dict[str, Any]
    rank: int
    task_samples: List[str]
    train_seconds: float                  # simulated (LUT) wall time
    local_loss: float
    staleness: float = 0.0


class LocalTrainer:
    """Holds the LoRA step for one (lm, lr) and runs client rounds on the
    model's device."""

    def __init__(self, lm, seq_len: int = 48, batch_size: int = 8,
                 lr: float = 5e-3, local_steps: int = 10,
                 dp_clip: Optional[float] = None, dp_noise: float = 0.0):
        self.lm = lm
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.local_steps = local_steps
        self.dp_clip = dp_clip
        self.dp_noise = dp_noise
        self.opt = OPT.adamw(OPT.constant_schedule(lr))
        self.step_fn = TS.make_lora_train_step(
            lm, self.opt, dp_clip=dp_clip, dp_noise=dp_noise)

    def batches(self, client: ClientState, round_seed: int):
        """The numpy batches ``run_round`` trains ``client`` on in round
        ``round_seed``, in order."""
        return PIPE.batches(client.dataset, self.batch_size, self.seq_len,
                            seed=round_seed * 1_000 + client.cid)

    def run_round(self, client: ClientState, params, init_adapter,
                  lut: RS.LUT, deadline: float, round_seed: int,
                  ranks: Sequence[int] = RS.DEFAULT_RANKS
                  ) -> Optional[ClientUpdate]:
        # --- Algorithm 1: heterogeneity-aware rank selection -------------
        avail = client.device.memory_gb * 1e9 * (1 - client.background_load)
        rank = RS.select_rank(ranks, avail, deadline, lut, client.device.name)
        if rank is None:
            return None                    # cannot participate this round
        client.rank = rank

        # re-mask the broadcast adapter to this client's rank (Q_r)
        adapter = _apply_rank(init_adapter, rank)
        bank = LORA.single_expert_bank(adapter)
        opt_state = self.opt.init(
            {k: v for k, v in bank.items() if not k.startswith("_")})
        gates = torch.ones((1,), dtype=torch.float32, device=self.lm.device)

        it = self.batches(client, round_seed)
        loss = 0.0
        key = prng.key(round_seed * 77 + client.cid)
        for _ in range(self.local_steps):
            batch = PIPE.to_torch(next(it), self.lm.device)
            keys = prng.split(key)
            key, sk = prng.key_at(keys, 0), prng.key_at(keys, 1)
            bank, opt_state, l = self.step_fn(params, bank, opt_state, batch,
                                              gates, sk)
            loss = float(l)

        trained = LORA.adapter_of(bank, 0)
        trained["_rank"] = torch.tensor(rank, dtype=torch.int32)
        sim_time = lut.predict_latency(client.device.name, rank) \
            * self.local_steps / max(0.05, 1 - client.background_load)
        return ClientUpdate(client.cid, trained, rank,
                            client.public_samples(), sim_time, loss)


def _apply_rank(adapter: Dict[str, Any], rank: int) -> Dict[str, Any]:
    """Zero ranks >= rank in A and B (compression operator Q_r)."""
    def mask_leaf(t, r_ax):
        m = (torch.arange(t.shape[r_ax], device=t.device) < rank).to(t.dtype)
        shape = [1] * t.dim()
        shape[r_ax] = t.shape[r_ax]
        return t * m.reshape(shape)
    out = {}
    for stack, targets in adapter.items():
        if stack.startswith("_"):
            continue
        out[stack] = {
            tgt: {"A": mask_leaf(ab["A"], ab["A"].dim() - 2),
                  "B": mask_leaf(ab["B"], ab["B"].dim() - 1)}
            for tgt, ab in targets.items()
        }
    out["_rank"] = torch.tensor(rank, dtype=torch.int32)
    return out
