"""Batching pipeline: Example -> (tokens, loss_mask) training batches —
the port of ``repro/data/pipeline.py``.

Loss is computed on the answer span only (instruction tuning,
Stanford-Alpaca format per Sec. V-A5 — here prompt+answer with the
prompt masked out).  Batches are numpy arrays, bit for bit the
reference's; the caller moves them to its device.
"""
from __future__ import annotations

import random
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

from repro_torch.data import tokenizer as TOK
from repro_torch.data.tasks import Example


def encode_example(ex: Example, seq_len: int) -> Dict[str, np.ndarray]:
    p = TOK.encode(ex.prompt + " ", bos=True)
    a = TOK.encode(ex.answer, bos=False, eos=True)
    ids = (p + a)[:seq_len + 1]
    tokens = np.full(seq_len + 1, TOK.PAD, np.int32)
    tokens[: len(ids)] = ids
    mask = np.zeros(seq_len + 1, np.float32)
    mask[len(p): len(ids)] = 1.0          # answer tokens only
    return {"tokens": tokens, "mask": mask}


def make_batch(examples: Sequence[Example], seq_len: int
               ) -> Dict[str, np.ndarray]:
    enc = [encode_example(e, seq_len) for e in examples]
    tokens = np.stack([e["tokens"] for e in enc])
    mask = np.stack([e["mask"] for e in enc])
    return {
        "tokens": tokens[:, :-1],
        "targets": tokens[:, 1:],
        "mask": mask[:, 1:],
    }


def batches(dataset: List[Example], batch_size: int, seq_len: int,
            seed: int = 0, epochs: int = 10_000) -> Iterator[Dict]:
    rng = random.Random(seed)
    for _ in range(epochs):
        data = list(dataset)
        rng.shuffle(data)
        for i in range(0, len(data) - batch_size + 1, batch_size):
            yield make_batch(data[i:i + batch_size], seq_len)


def to_torch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch on ``device``: integer ids as int64 (torch indexes
    with them), the mask as float32."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device, dtype=torch.int64 if v.dtype.kind == "i" else torch.float32)
        for k, v in batch.items()}


@torch.no_grad()
def eval_accuracy(lm, params, dataset: Sequence[Example], seq_len: int,
                  lora=None, gates=None, batch_size: int = 16,
                  per_token: bool = False) -> float:
    """Greedy answer accuracy under teacher forcing.

    per_token=False: exact match of the whole answer span per example;
    per_token=True: fraction of correct answer tokens (smoother metric).
    """
    hits = total = 0
    for i in range(0, len(dataset), batch_size):
        b = make_batch(dataset[i:i + batch_size], seq_len)
        tokens = to_torch({"tokens": b["tokens"]}, lm.device)
        logits, _ = lm.train_logits(params, tokens, lora=lora, gates=gates)
        pred = logits.argmax(-1).cpu().numpy()
        m = b["mask"] > 0
        for j in range(pred.shape[0]):
            mj = m[j]
            if mj.sum() == 0:
                continue
            if per_token:
                total += int(mj.sum())
                hits += int((pred[j][mj] == b["targets"][j][mj]).sum())
            else:
                total += 1
                hits += int((pred[j][mj] == b["targets"][j][mj]).all())
    return hits / max(1, total)
