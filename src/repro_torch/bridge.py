"""Bridge between the JAX package's parameter trees and the port's.

A JAX tree (``LM.param_specs`` layout with stacked ``layers`` leaves, or
the ``fusion.alignment_spec`` dict), handed over as numpy arrays, maps
leaf for leaf onto the port's nested dicts of tensors: same keys, same
shapes.  ``to_numpy`` is the reverse, for comparison.  bfloat16 leaves
(numpy's ``ml_dtypes`` bfloat16) travel as their 16-bit patterns, so
both directions are exact; ``to_numpy`` widens bfloat16 to float32,
which is exact too.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import tree as T


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def from_numpy(tree: Any, device="cpu", dtype=None) -> Any:
    """Nested dict of numpy arrays -> nested dict of tensors on
    ``device`` (cast to ``dtype`` when given)."""
    return T.map_tree(lambda a: _tensor(a, device, dtype), tree)


def to_numpy(tree: Any) -> Any:
    """Nested dict of tensors -> nested dict of numpy arrays on the host
    (bfloat16 widened to float32)."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            t = x.detach().cpu()
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return x
    return T.map_tree(leaf, tree)
