"""Mesh construction (ports ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
process group. A single pod is (data=16, model=16) = 256 ranks; multi-pod
adds an outer pure-DP ``pod`` axis (2 pods = 512 ranks). A rank is a
process joined to the default process group (``distributed/ranks.py``);
the mesh is a ``sharding.Mesh`` over that world: NCCL on the card (one
card a rank), gloo on the CPU, whichever the group was joined with.
"""
from __future__ import annotations

from typing import Sequence

import torch.distributed as dist

from repro_torch import device as device_mod
from repro_torch.distributed import sharding


def make_train_mesh(shape: Sequence[int], axes: Sequence[str],
                    device=None) -> sharding.Mesh:
    """A mesh of ``shape`` over ``axes`` (a subset of ``("pod", "data",
    "model")`` in that order) from an already joined process group of
    ``prod(shape)`` ranks: NCCL for ``device`` the card (None), gloo for
    the CPU. No fallback: no group, another world size or another
    backend raises."""
    dev = device_mod.resolve(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {tuple(shape)} mesh needs {n} processes joined to one "
            f"process group (repro_torch.distributed.ranks)")
    if dist.get_backend() != backend:
        raise ValueError(f"a {dev.type} mesh runs on {backend}; the process "
                         f"group is {dist.get_backend()}")
    return sharding.Mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    if multi_pod:
        shape, axes = (2, 16, 16), ("pod", "data", "model")
    else:
        shape, axes = (16, 16), ("data", "model")
    n = 1
    for s in shape:
        n *= s
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"need {n} devices, have {have} — start one process a rank, "
            "joined to one process group (repro_torch.distributed.ranks)")
    return make_train_mesh(shape, axes, device)


def make_debug_mesh(shape=(2, 2), axes=("data", "model")):
    """A small CPU mesh for the tests: gloo ranks, one a mesh position."""
    return make_train_mesh(shape, axes, "cpu")
