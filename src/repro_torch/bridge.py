"""Weight bridge between the JAX package's parameters and the port's.

The JAX ``repro.models.lm.init`` pytree (``embed``, ``final_ln``, optional
``lm_head``, ``blocks`` with every leaf stacked on a leading L axis) and the
port's parameters have the same nesting and leaf names, so the bridge maps
leaf for leaf. It takes the tree as numpy arrays (``jax.tree.map(np.asarray,
params)`` on the JAX side): this module imports no JAX. A bfloat16 leaf
(numpy dtype ``bfloat16`` from ml_dtypes) is reinterpreted bit for bit as
``torch.bfloat16``.

The trainable tree is the JAX tree: the derived ``blocks.ffn.wu_t`` is
added by ``from_numpy`` and dropped by ``to_numpy`` and ``lm.trainable``.
The AdamW state (``step``, ``m``, ``v``) crosses the same way
(``opt_state_from_numpy`` / ``opt_state_to_numpy``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.optim import adamw


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


def _tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameters -> the JAX tree layout as float32/int numpy
    arrays (bfloat16 widens exactly), without the derived weights."""
    return _tree_to_numpy(lm.trainable(params))


def opt_state_from_numpy(state, device="cpu") -> adamw.AdamWState:
    """JAX ``AdamWState(step, m, v)`` with numpy leaves -> the port's."""
    step, m, v = state
    dev = torch.device(device)
    return adamw.AdamWState(
        torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=dev),
        _tree_to_torch(m, dev), _tree_to_torch(v, dev))


def opt_state_to_numpy(state: adamw.AdamWState):
    """The port's AdamW state -> (step, m, v) as numpy, the JAX layout."""
    return (np.asarray(int(state.step), np.int32),
            _tree_to_numpy(state.m), _tree_to_numpy(state.v))
