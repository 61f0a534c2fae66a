"""Weight bridge between the JAX package's parameters and the port's.

The JAX ``repro.models.lm.init`` pytree (``embed``, ``final_ln``, optional
``lm_head``, ``blocks`` with every leaf stacked on a leading L axis) and the
port's parameters have the same nesting and leaf names, so the bridge maps
leaf for leaf. It takes the tree as numpy arrays (``jax.tree.map(np.asarray,
params)`` on the JAX side): this module imports no JAX. A bfloat16 leaf
(numpy dtype ``bfloat16`` from ml_dtypes) is reinterpreted bit for bit as
``torch.bfloat16``.

The trainable tree is the JAX tree: the derived ``wu_t`` beside every
gated FFN's ``wu`` (``lm.prepare_params``: ``blocks.ffn``, a MoE block's
experts, zamba2's ``shared_attn.ffn``, vision's self and cross blocks) is
added by ``from_numpy`` and dropped by ``to_numpy`` and ``lm.trainable``.
The AdamW state (``step``, ``m``, ``v``) crosses the same way
(``opt_state_from_numpy`` / ``opt_state_to_numpy``). ``shard_params``
cuts the whole tree into one rank's shards for tensor-parallel serving;
``shard_train_state`` cuts the trainable tree and its AdamW state onto a
training mesh (``lm.train_specs``, FSDP included), and ``gather_tree``
puts a sharded tree back together on every rank.
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


def shard_params(params: Dict[str, Any], cfg, mesh, backend,
                 draft=None) -> Dict[str, Any]:
    """The whole parameter tree -> this rank's shards on a 1-D ``model``
    mesh (tensor-parallel serving): each leaf cut by
    ``sharding.make_param_specs(..., fsdp=False)``, the FFN's hidden dim
    by ``backend.ffn_sizes`` (whole TwELL tiles when ``backend`` or the
    ``draft`` backend packs or skips tiles), then the derived ``wu_t``
    made again from the shard. Every rank builds the whole tree and keeps
    its slice."""
    import re

    from repro_torch.distributed import sharding
    full = lm.trainable(params)
    specs = sharding.make_param_specs(full, cfg, mesh, fsdp=False)
    sizes = backend.ffn_sizes(cfg, sharding.tp_size(mesh), draft)

    def cut(tree, spec, path=""):
        if isinstance(tree, dict):
            return {k: cut(v, spec[k], f"{path}/{k}") for k, v in tree.items()}
        ffn = re.search(r"(^|/)ffn/w[ugd]$", path) is not None
        return sharding.shard_tensor(tree, spec, mesh,
                                     sizes=sizes if ffn else None)
    return lm.prepare_params(cut(full, specs))


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


def shard_train_state(params: Dict[str, Any], state, cfg, mesh,
                      device="cpu"):
    """A JAX parameter tree and ``AdamWState`` (numpy leaves, the
    trainable tree) -> this rank's shards on the training ``mesh``: every
    leaf, and ``m`` and ``v`` alike, cut by ``lm.train_specs`` (JAX's
    ``AdamWState(P(), pspecs, pspecs)``)."""
    from repro_torch.distributed import sharding
    specs = lm.train_specs(cfg, mesh)
    full = lm.trainable(from_numpy(params, device))
    opt = opt_state_from_numpy(state, device)
    return (sharding.shard_tree(full, specs, mesh),
            adamw.AdamWState(opt.step, sharding.shard_tree(opt.m, specs, mesh),
                             sharding.shard_tree(opt.v, specs, mesh)))


def gather_tree(tree: Any, specs: Any, mesh) -> Any:
    """A tree of this rank's shards (nested dicts, tuples, NamedTuples)
    -> the whole leaves on every rank: each sharded dim all-gathered over
    its axes (``specs`` one spec a leaf, as ``make_param_specs`` gives)."""
    from repro_torch.distributed import collectives
    from repro_torch.tree import leaves, leaves_like, unflatten

    def whole(t, spec):
        for dim, entry in enumerate(spec):
            if entry is not None:
                axes = entry if isinstance(entry, tuple) else (entry,)
                t = collectives.all_gather_dim(t, mesh.axis(*axes), dim)
        return t
    return unflatten(tree, [whole(t, sp) for t, sp in
                            zip(leaves(tree), leaves_like(specs, tree))])
