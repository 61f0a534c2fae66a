"""Weight bridge between the JAX package's parameters and the port's.

The JAX ``repro.models.lm.init`` pytree (``embed``, ``final_ln``, optional
``lm_head``, ``blocks`` with every leaf stacked on a leading L axis) and the
port's parameters have the same nesting and leaf names, so the bridge maps
leaf for leaf. It takes the tree as numpy arrays (``jax.tree.map(np.asarray,
params)`` on the JAX side): this module imports no JAX. A bfloat16 leaf
(numpy dtype ``bfloat16`` from ml_dtypes) is reinterpreted bit for bit as
``torch.bfloat16``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import lm


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.array(a)          # a private, writable copy (JAX buffers are not)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree_to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    return _leaf_to_torch(tree, device)


def from_numpy(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """JAX parameter tree (numpy leaves) -> the port's parameters on
    ``device``, with the load-time derived weights added."""
    return lm.prepare_params(_tree_to_torch(tree, torch.device(device)))


def to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameters -> the JAX tree layout as float32/int numpy
    arrays (bfloat16 widens exactly), without the derived weights."""
    def conv(tree, path=()):
        if isinstance(tree, dict):
            return {k: conv(v, path + (k,)) for k, v in tree.items()
                    if path + (k,) != ("blocks", "ffn", "wu_t")}
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return conv(params)
