"""Production mesh construction (ports ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
process group. A single pod is (data=16, model=16) = 256 ranks; multi-pod
adds an outer pure-DP ``pod`` axis (2 pods = 512 ranks). A rank is a
process joined to the default process group (``distributed/ranks.py``);
the mesh is a ``DeviceMesh`` over the first ranks of that world.
"""
from __future__ import annotations

import torch.distributed as dist


def _mesh(device_type: str, shape, axes):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
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
    return _mesh("cuda", shape, axes)


def make_debug_mesh(shape=(2, 2), axes=("data", "model")):
    """A small CPU mesh for the tests: gloo ranks, one a mesh position."""
    return _mesh("cpu", shape, axes)
