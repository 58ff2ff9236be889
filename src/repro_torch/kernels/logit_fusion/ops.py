"""Serving entry point of the fusion kernel — the port of
``fused_probs_masked`` in ``repro/kernels/logit_fusion/ops.py``.

It pads a ragged decode batch up to a ``block_b`` multiple (padded rows
carry arrived=False and are sliced away) and threads the per-row
Sec. IV-D ``arrived`` mask into the kernel, so the kernel sees the same
(B, V) shapes as the Pallas one does.  ``cloud_arrival_mask`` builds
that mask, with the fault terms of a lossy link (the port of the
reference's function of the same name).  ``accept_prefix`` is the
speculative burst's accept epilogue in elementwise torch ops (the
reference computes it in jnp), with its sequential host oracle
``accept_prefix_ref`` beside it.  ``sample_fused`` and
``select_sample_fused`` are the reference's keyed sampling ops of the
same names, through K7 (``sample.py``).
"""
from __future__ import annotations

import numpy as np
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


def cloud_arrival_mask(ok, active, lost=None, outage=None, degraded=None):
    """The Sec. IV-D fallback mask on a fault-injected link: a row's
    cloud logits take part in the fusion iff the reply arrived within
    the timeout AND the row is active AND the reply was not lost AND the
    link is not in an outage AND the row's breaker does not hold it
    SLM-only.  Elementwise boolean algebra on numpy arrays or tensors
    alike; ``None`` terms are skipped, so with none the mask is
    literally ``ok & active``."""
    m = ok & active
    if lost is not None:
        m = m & ~lost
    if outage is not None:
        m = m & ~outage
    if degraded is not None:
        m = m & ~degraded
    return m


def accept_prefix(draft: torch.Tensor, sel: torch.Tensor,
                  steps: torch.Tensor, max_new: torch.Tensor,
                  active: torch.Tensor, eos: int):
    """Accept epilogue of a speculative burst: the longest draft prefix
    the fused choices agree with, capped by EOS and the row's budget.

    draft, sel: (k, B) int — the SLM's greedy drafts and the fused
    distribution's choices at the k positions; steps, max_new: (B,)
    int emitted so far and budget; active: (B,) bool.  Returns (n_emit,
    c_sel, done_now, correction), each (B,): tokens emitted this burst
    (sel[:n_emit]; 0 on inactive rows), the length of the agreeing
    prefix, whether the row finished (EOS or budget), and whether its
    last emitted token diverged from the draft (its SLM then decodes
    sel[n_emit - 1] once after the rollback).  Elementwise, so it runs
    inside a CUDA graph; ``accept_prefix_ref`` is its plain version."""
    k = draft.shape[0]
    match = (sel == draft).to(torch.int32)
    c_sel = torch.cumprod(match, dim=0).sum(0).to(torch.int32)
    n_raw = torch.clamp(c_sel + 1, max=k)
    idx = torch.arange(k, dtype=torch.int32, device=sel.device)[:, None]
    is_eos = (sel == eos) & (idx < n_raw[None, :])
    eos_pos = torch.where(is_eos, idx, k).amin(0)
    n1 = torch.minimum(n_raw, eos_pos + 1)
    rem = (max_new - steps).to(torch.int32)
    n_emit = torch.clamp(torch.minimum(n1, rem), min=1)
    last = sel.gather(0, (n_emit - 1).long()[None, :])[0]
    done_now = active & ((last == eos) | (steps + n_emit >= max_new))
    correction = active & ~done_now & (n_emit == c_sel + 1)
    n_emit = torch.where(active, n_emit, 0).to(torch.int32)
    return n_emit, c_sel, done_now, correction


def accept_prefix_ref(draft, sel, steps, max_new, active, eos: int):
    """Sequential host oracle of ``accept_prefix`` (the reference's
    ``ref.accept_prefix_ref``): walk each row's k positions in order,
    accepting while the fused choice matches the draft, stopping at EOS,
    the budget or the first divergence (which still emits)."""
    draft, sel = np.asarray(draft), np.asarray(sel)
    steps, max_new = np.asarray(steps), np.asarray(max_new)
    active = np.asarray(active, bool)
    k, b = draft.shape
    n_emit = np.zeros((b,), np.int32)
    c_sel = np.zeros((b,), np.int32)
    done_now = np.zeros((b,), bool)
    correction = np.zeros((b,), bool)
    for j in range(b):
        i = 0
        while i < k and sel[i, j] == draft[i, j]:
            i += 1
        c_sel[j] = i
        if not active[j]:
            continue
        n = 0
        diverged = False
        for i in range(k):
            n += 1
            if sel[i, j] == eos or steps[j] + n >= max_new[j]:
                done_now[j] = True
                break
            if sel[i, j] != draft[i, j]:
                diverged = True
                break
        n_emit[j] = n
        correction[j] = diverged and not done_now[j]
    return n_emit, c_sel, done_now, correction


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
