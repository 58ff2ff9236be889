"""PyTorch/CUDA port of the Floe hybrid LLM-SLM serving stack.

Mirrors ``repro`` (the JAX/Pallas reference) module for module and never
imports it, nor ``jax``.  The serving entry points (``LM``,
``ServingDeployment``, ``Scheduler.from_deployment``, ``launch/serve.py``)
run on CUDA unless the caller passes ``device="cpu"``; without a card and
without that request they raise instead of quietly running on the CPU.
On a CUDA tensor every kernel wrapper launches its hand-written Hopper
kernel or raises; the plain PyTorch version beside it runs only for
tensors that lie on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU
    only when asked for explicitly.  Raises when CUDA is wanted but no
    card is visible."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def to_device(array, device) -> torch.Tensor:
    """A host array (or list) as a tensor on ``device``.  On CUDA it is
    staged in pinned memory and copied without blocking, so the host
    does not wait for the work queued on the stream: a pageable copy
    would synchronise with it."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
