"""Serving entry point of the fusion kernel — the port of
``fused_probs_masked`` in ``repro/kernels/logit_fusion/ops.py``.

It pads a ragged decode batch up to a ``block_b`` multiple (padded rows
carry arrived=False and are sliced away) and threads the per-row
Sec. IV-D ``arrived`` mask into the kernel, so the kernel sees the same
(B, V) shapes as the Pallas one does.  ``cloud_arrival_mask`` builds
that mask (the port of the reference's function of the same name).
``sample_fused`` and ``select_sample_fused`` are the reference's keyed
sampling ops of the same names, through K7 (``sample.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.logit_fusion.kernel import fuse_logits
from repro_torch.kernels.logit_fusion.sample import sample_fused as _k7


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


def sample_fused(probs: torch.Tensor, rids, steps,
                 seed: int = 0) -> torch.Tensor:
    """Batched sampling from the fused distribution: row i draws with key
    fold_in(fold_in(key(seed), rids[i]), steps[i]), the sequential
    engine's per-(request, token) key, so batched and sequential serving
    see the same samples.  probs (B, V) f32; rids, steps (B,) int tensors
    on probs' device.  Returns (B,) int64 ids."""
    return _k7(probs, None, rids, steps, seed)


def select_sample_fused(probs: torch.Tensor, greedy, rids, steps,
                        seed: int = 0, sample: bool = True) -> torch.Tensor:
    """The macro step's next-token epilogue: per row the greedy argmax or
    ``sample_fused``'s draw, selected by the (B,) bool ``greedy`` mask,
    in one launch.  ``sample=False`` takes the argmax alone and draws
    nothing, so all-greedy lanes never pay for the (B, V) draw.  Returns
    (B,) int64 ids."""
    if not sample:
        return torch.argmax(probs, dim=-1)
    return _k7(probs, greedy, rids, steps, seed)
