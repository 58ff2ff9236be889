"""Serving entry point of the fusion kernel — the port of
``fused_probs_masked`` in ``repro/kernels/logit_fusion/ops.py``.

It pads a ragged decode batch up to a ``block_b`` multiple (padded rows
carry arrived=False and are sliced away) and threads the per-row
Sec. IV-D ``arrived`` mask into the kernel, so the kernel sees the same
(B, V) shapes as the Pallas one does.  ``cloud_arrival_mask`` builds
that mask (the port of the reference's function of the same name).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.logit_fusion.kernel import fuse_logits


def fused_probs_masked(slm_logits: torch.Tensor, llm_logits: torch.Tensor,
                       w: torch.Tensor, arrived: torch.Tensor,
                       block_b: int = 4) -> torch.Tensor:
    """slm/llm logits (B, V) for any B >= 1; w (B,); arrived (B,) bool."""
    b = slm_logits.shape[0]
    bp = -(-b // block_b) * block_b
    pad = bp - b
    arrived = arrived.bool()
    if pad:
        slm_logits = F.pad(slm_logits, (0, 0, 0, pad))
        llm_logits = F.pad(llm_logits, (0, 0, 0, pad))
        w = F.pad(w.float(), (0, pad), value=1.0)
        arrived = F.pad(arrived, (0, pad), value=False)
    out = fuse_logits(slm_logits, llm_logits, w, arrived)
    return out[:b]


def cloud_arrival_mask(ok, active):
    """The Sec. IV-D fallback mask: a row's cloud logits take part in the
    fusion iff the reply arrived within the timeout AND the row is
    active.  Elementwise boolean algebra on numpy arrays or tensors
    alike.  The reference's fault terms (lost reply, outage, breaker)
    come with the fault slice."""
    return ok & active
