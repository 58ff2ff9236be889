"""Checkpointing: tree <-> .npz with path-keyed arrays — the port of
``repro/training/checkpoint.py``, in its key layout, so a file written
by either package restores in the other.

Handles params, optimizer state, LoRA banks — any tree of tensors (or
arrays) plus scalar leaves.  Keys encode the tree path (dict keys sorted,
list items ``#i``, ``None`` as ``@none``); restore rebuilds against a
reference structure (so shapes are validated) and returns tensors in
its dtypes on its devices.  numpy has no bfloat16: a bfloat16 leaf is
written widened to float32 (exact), and a bfloat16 array the reference
wrote (2-byte void to numpy) is read back through its bit patterns.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

Tree = Any
_SEP = "||"


def _array(node) -> np.ndarray:
    if isinstance(node, torch.Tensor):
        t = node.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(node)


def _paths(tree) -> Dict[str, np.ndarray]:
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(prefix + [str(k)], node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(prefix + [f"#{i}"], v)
        elif node is None:
            flat[_SEP.join(prefix + ["@none"])] = np.zeros(0)
        else:
            flat[_SEP.join(prefix)] = _array(node)
    walk([], tree)
    return flat


def save(path: str, tree: Tree) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_paths(tree))


def _tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:   # bfloat16 bits
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def restore(path: str, like: Tree) -> Tree:
    """Load arrays and rebuild with the structure of ``like``: each leaf a
    tensor of the like-leaf's dtype, on its device when it is a tensor."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        stored = {k: data[k] for k in data.files}

    def build(prefix, node):
        if isinstance(node, dict):
            return {k: build(prefix + [str(k)], node[k])
                    for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            vals = [build(prefix + [f"#{i}"], v) for i, v in enumerate(node)]
            return type(node)(vals)
        if node is None:
            return None
        key = _SEP.join(prefix)
        arr = _tensor(stored[key])
        ref = node if isinstance(node, torch.Tensor) \
            else torch.as_tensor(np.asarray(node))
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: stored shape {tuple(arr.shape)}, "
                             f"expected {tuple(ref.shape)}")
        return arr.to(ref.device, ref.dtype)

    return build([], like)
