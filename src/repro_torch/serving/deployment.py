"""ServingDeployment — the single-device, fault-free, adapter-free subset
of ``repro/serving/deployment.py``.

One object owns the models, their parameters on the device and the
entry points the sequential engine calls: B=1 prefill and one-token
decode of each model, the Eq. 14-15 fusion step (through K1), and a
request's counter-based network weather.  Meshes, paging, macro-steps
and speculation are later slices.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import fusion as FUS
from repro_torch.serving.latency import LatencyModel


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class ServingDeployment:
    """Models, parameters and entry points of one hybrid deployment.

    ``device`` defaults to CUDA; pass ``device="cpu"`` to run the plain
    PyTorch path.  Parameters are moved onto the device once, here."""

    def __init__(self, slm, slm_params, llm=None, llm_params=None,
                 alignment_mlp: Optional[Dict[str, Any]] = None,
                 latency: Optional[LatencyModel] = None,
                 timeout_ms: float = 200.0, max_seq: int = 96,
                 block_b: int = 4, device=None):
        self.device = resolve_device(device)
        for lm in (slm, llm):
            if lm is not None and lm.device != self.device:
                raise ValueError(f"{lm.cfg.name} lives on {lm.device}, the "
                                 f"deployment on {self.device}")
        self.slm, self.llm = slm, llm
        self.slm_params = _to_device(slm_params, self.device)
        self.llm_params = (_to_device(llm_params, self.device)
                           if llm_params is not None else None)
        self.mlp = (_to_device(alignment_mlp, self.device)
                    if alignment_mlp is not None else None)
        self.latency = latency or LatencyModel()
        self.timeout_ms = timeout_ms
        self.max_seq = max_seq
        self.block_b = block_b

    def tokens(self, ids) -> torch.Tensor:
        """(1, S) int64 token tensor on the deployment's device."""
        return torch.tensor([list(ids)], dtype=torch.int64,
                            device=self.device)

    def slm_prefill(self, params, toks):
        return self.slm.prefill(params, toks, self.max_seq)

    def llm_prefill(self, params, toks):
        return self.llm.prefill(params, toks, self.max_seq)

    def slm_decode(self, params, cache, toks):
        return self.slm.decode_step(params, cache, toks)

    def llm_decode(self, params, cache, toks):
        return self.llm.decode_step(params, cache, toks)

    def fuse(self, sl: torch.Tensor, ll: torch.Tensor, arrived: bool):
        """Eq. 14-15 on (B, V) logits, Eq. 15 through K1; ``arrived``
        applies to every row.  Returns (P_out (B, V), w (B,))."""
        mask = torch.full((sl.shape[0],), bool(arrived), device=sl.device)
        return FUS.fused_distribution_kernel(self.mlp, sl, ll, mask,
                                             block_b=self.block_b)

    def lat_request(self, rid: int, steps):
        """A whole request's network weather in one vectorised draw:
        (lat_ms (n,) float32, cloud_used (n,) bool) numpy arrays."""
        steps = np.asarray(steps, np.int32)
        return self.latency.token_latency_device(
            self.timeout_ms, np.full_like(steps, rid), steps)
