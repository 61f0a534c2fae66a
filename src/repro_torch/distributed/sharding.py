"""Sharding rule engine: a partition spec for every parameter, cache and
batch from path-based rules with divisibility-checked fallbacks.

Ports ``repro/distributed/sharding.py`` on ``torch.distributed``. The rules
are the JAX package's, leaf for leaf (``tests/test_torch_sharding.py``
holds them against it on all 12 configs):

- TP over the ``model`` axis: attention heads, the FFN's hidden dim,
  vocab, experts (EP when the expert count divides the axis);
- FSDP over ``data``: after TP, the largest still-unsharded dim that the
  data size divides;
- ``pod`` is an outer pure-DP axis;
- the fallbacks are explicit: a head count that does not divide the model
  axis leaves attention unsharded by it; a decode KV cache whose kv-head
  count does not divide shards its sequence dim instead (flash-decoding,
  ``collectives.flash_decode_attention``); a paged pool only ever splits
  its kv-head axis.

A spec is a plain tuple, one entry a dim: an axis name, a tuple of names
or None (``tuple(PartitionSpec)`` on the JAX side). A mesh is what the
rules read of it (``mesh_dim_names``, ``shape``): a
``torch.distributed.device_mesh.DeviceMesh`` (serving's 1-D model mesh),
a ``Mesh`` (training's, up to three axes, with a process group for every
set of its axes), or ``AbstractMesh`` without processes, for the rules
alone. Tensor-parallel serving applies the specs with ``fsdp=False``
(``bridge.shard_params``); training applies them whole, FSDP included, to
the parameters and to AdamW's ``m`` and ``v`` (``shard_tree``,
``bridge.shard_train_state``).

The port's collectives are explicit (``collectives.py``), so the JAX
package's GSPMD helpers have no counterpart: ``current_mesh``,
``shard_act``, ``named``, ``replicated`` and ``serving_jit_shardings``.
Where JAX constrains an activation, the port's layer runs the collective
itself, on the ``ModelGroup`` its caller passes (serving), or on the
``Mesh`` the train step passes down (training).
"""
from __future__ import annotations

import dataclasses
import itertools
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import device as device_mod

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes without processes or devices (JAX's
    ``AbstractMesh``): what the rules read of a ``DeviceMesh``."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def dp_axes_of(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def dp_spec(mesh):
    axes = dp_axes_of(mesh)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def tp_size(mesh) -> int:
    return mesh_axes(mesh).get("model", 1)


def data_size(mesh) -> int:
    return mesh_axes(mesh).get("data", 1)


# --------------------------------------------------------------------------- #
# parameter rules
# --------------------------------------------------------------------------- #

def param_spec(path: str, shape: Tuple[int, ...], cfg, mesh,
               fsdp: bool = True) -> Spec:
    tp = tp_size(mesh)
    dsz = data_size(mesh)
    spec: list = [None] * len(shape)

    def put(dim: int, axis: str) -> bool:
        if dim < 0:
            dim += len(shape)
        if spec[dim] is None and shape[dim] % {"model": tp}.get(axis, 1) == 0:
            spec[dim] = axis
            return True
        return False

    heads_ok = cfg.num_heads % tp == 0
    kv_ok = cfg.num_kv_heads % tp == 0 if cfg.num_kv_heads else False
    ep = cfg.num_experts > 0 and cfg.num_experts % tp == 0

    if re.search(r"(embed|lm_head)$", path):
        put(-2, "model")                                   # vocab-sharded
    elif re.search(r"experts.*w[ug]$", path):
        # the expert dim is -3 of (..., E, D, F): layer stacking prepends
        # dims, so never index from the left
        put(-3, "model") if ep else put(-1, "model")       # EP else expert TP
    elif re.search(r"experts.*wd$", path):
        put(-3, "model") if ep else put(-2, "model")
    elif re.search(r"router$", path):
        pass                                               # small, replicated
    elif re.search(r"attn.*w[q]$", path) or re.search(r"(^|/)w[rg]$", path):
        if heads_ok:
            put(-1, "model")
    elif re.search(r"attn.*w[kv]$", path):
        if kv_ok:
            put(-1, "model")
    elif re.search(r"attn.*wo$", path):
        if heads_ok:
            put(-2, "model")
    elif re.search(r"(ffn|shared_ffn|cm).*(wu|wg)$", path) or \
            re.search(r"wu$", path):
        put(-1, "model")
    elif re.search(r"(ffn|shared_ffn|cm).*wd$", path) or re.search(r"wd$", path):
        put(-2, "model")
    elif re.search(r"out_proj$", path):
        put(-2, "model")                                   # mamba2 d_inner rows
    elif re.search(r"(^|/)(wk|wv|wo)$", path):             # rwkv time-mix
        if heads_ok:
            put(-1 if not path.endswith("wo") else -2, "model")
    # everything else (norms, conv, lora, biases, mix coeffs): replicated

    if fsdp and dsz > 1:
        # ZeRO-3: shard the largest remaining dim divisible by the data size
        cands = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in cands:
            if spec[i] is None and shape[i] % dsz == 0 and shape[i] >= dsz:
                spec[i] = "data"
                break
    return tuple(spec)


def _map_paths(tree, fn, prefix: str = ""):
    """``fn(path, leaf)`` over a nested dict, paths joined by ``/`` (the
    keys of JAX's ``tree_flatten_with_path`` on the same tree)."""
    if isinstance(tree, dict):
        return {k: _map_paths(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def make_param_specs(params: Any, cfg, mesh, fsdp: bool = True) -> Any:
    """params: a nested dict of tensors (meta tensors will do)."""
    return _map_paths(params, lambda p, leaf: param_spec(
        p, tuple(leaf.shape), cfg, mesh, fsdp))


# --------------------------------------------------------------------------- #
# cache rules (decode)
# --------------------------------------------------------------------------- #

def cache_spec(path: str, shape: Tuple[int, ...], cfg, mesh) -> Spec:
    """KV / SSM caches. Layout conventions (leading layer-stack dim):
    k,v: (L, B, S, Hkv, hd); state: (L, B, H, hd, N); conv: (L, B, W, C);
    wkv: (L, B, H, hd, hd); shift: (L, B, D); xk/xv: (L, B, P, Hkv, hd);
    paged serving pools kpool/vpool: (L, NB, BS, Hkv, hd)."""
    tp = tp_size(mesh)
    dsz = data_size(mesh)
    dp = dp_spec(mesh)
    spec: list = [None] * len(shape)
    if re.search(r"(^|/)[kv]pool$", path) and len(shape) == 5:
        # paged pool: ONLY the kv-head axis may split. Dim 1 is the physical
        # block id of a host-side free list, so it stays whole on every
        # rank; dim 2 is the offset inside a block, not a sequence.
        if cfg.num_kv_heads % tp == 0:
            spec[3] = "model"
        return tuple(spec)
    if len(shape) >= 2 and shape[1] % max(dsz, 1) == 0 and dsz > 1:
        spec[1] = dp                                        # batch over data(+pod)
    if re.search(r"(^|/)(k|v|xk|xv)$", path) and len(shape) == 5:
        if cfg.num_kv_heads % tp == 0:
            spec[3] = "model"                               # kv heads
        elif shape[2] % tp == 0:
            spec[2] = "model"                               # seq (flash-decoding)
    elif re.search(r"(state|wkv)$", path) and len(shape) == 5:
        if shape[2] % tp == 0:
            spec[2] = "model"                               # ssm heads
    return tuple(spec)


def make_cache_specs(cache: Any, cfg, mesh) -> Any:
    return _map_paths(cache, lambda p, leaf: cache_spec(
        p, tuple(leaf.shape), cfg, mesh))


def batch_spec(ndim: int, mesh, batch_size: int = 0) -> Spec:
    """Leading-dim DP sharding; falls back toward fewer axes (then
    replication) when the batch does not divide."""
    axes = dp_axes_of(mesh)
    sizes = mesh_axes(mesh)
    while axes:
        total = 1
        for a in axes:
            total *= sizes[a]
        if batch_size == 0 or batch_size % total == 0:
            dp = axes if len(axes) > 1 else axes[0]
            return (dp,) + (None,) * (ndim - 1)
        axes = axes[1:]
    return (None,) * ndim


# --------------------------------------------------------------------------- #
# serving (tensor-parallel engine)
# --------------------------------------------------------------------------- #

def make_serving_mesh(tp: int, device=None):
    """A 1-D ``("model",)`` mesh of ``tp`` ranks: NCCL on the card (one
    card a rank), gloo on the CPU.

    Each rank is a process that has joined a ``tp``-rank process group
    first (``ranks.join``, ``ranks.spawn``; the serve CLI's ``--tp`` spawns
    them). There is no fallback: no group, a world of another size or
    another backend raises, and so does ``tp`` beyond the visible
    cards."""
    dev = device_mod.resolve(device)
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if dev.type == "cuda" and tp > torch.cuda.device_count():
        raise ValueError(
            f"tp={tp} exceeds the {torch.cuda.device_count()} visible "
            f"devices (one rank a card)")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        raise RuntimeError(
            f"tp={tp} needs {tp} processes joined to one process group "
            f"(repro_torch.distributed.ranks; the serve CLI's --tp starts "
            f"them)")
    if dist.get_world_size() != tp:
        raise ValueError(f"tp={tp} but the process group has "
                         f"{dist.get_world_size()} ranks")
    if dist.get_backend() != backend:
        raise ValueError(f"a {dev.type} mesh runs on {backend}; the process "
                         f"group is {dist.get_backend()}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, (tp,), mesh_dim_names=("model",))


def make_paged_pool_shardings(cfg, mesh, num_blocks: int,
                              block_size: int) -> Dict[str, Spec]:
    """The serving engine's paged KV pools' specs, by the same
    ``cache_spec`` rules the decode caches use (kpool/vpool split the
    kv-head axis over ``model``; the block axis stays whole)."""
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {name: cache_spec(name, shape, cfg, mesh)
            for name in ("kpool", "vpool")}


def ffn_split(d_ff: int, tp: int, tile: int = 0) -> Tuple[int, ...]:
    """Each rank's share of the FFN's hidden dim: ``d_ff / tp`` each with
    ``tile`` 0 (JAX's even split); else whole tiles of ``tile`` columns,
    as evenly as possible, the first ranks one tile more. The TwELL and
    tile-skip kernels pack and skip per tile, so a tile split between two
    ranks would change what an overflowing tile keeps."""
    if not tile:
        if d_ff % tp:
            raise ValueError(f"d_ff={d_ff} not divisible by tp={tp}")
        return (d_ff // tp,) * tp
    tiles = d_ff // tile
    if tiles * tile != d_ff or tiles < tp:
        raise ValueError(f"d_ff={d_ff} holds {tiles} whole tiles of {tile}; "
                         f"tp={tp} needs at least one a rank")
    q, r = divmod(tiles, tp)
    return tuple((q + (i < r)) * tile for i in range(tp))


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """Each leaf of a nested dict cut by its spec (``make_param_specs``'s
    tree) to this rank's slice."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return shard_tensor(tree, specs, mesh)


def _coord(mesh, axes: Sequence[str], coords: Optional[Dict[str, int]]
           ) -> Tuple[int, int]:
    """(this rank's index, the count) over ``axes``, the first axis
    major."""
    sizes = mesh_axes(mesh)
    idx, n = 0, 1
    for a in axes:
        c = coords[a] if coords is not None else mesh.get_local_rank(a)
        idx, n = idx * sizes[a] + c, n * sizes[a]
    return idx, n


def shard_tensor(t: torch.Tensor, spec: Spec, mesh,
                 sizes: Optional[Sequence[int]] = None,
                 coords: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """This rank's slice of ``t`` under ``spec``: an even split of each
    sharded dim (``sizes``, one a rank, replaces it for the dims on the
    ``model`` axis alone: the FFN's whole-tile split). ``coords`` gives the
    rank's index on each axis (default: the mesh's, for this process).
    Contiguous; the tensor itself when nothing is split."""
    out = t
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx, n = _coord(mesh, axes, coords)
        if sizes is not None and axes == ("model",):
            if len(sizes) != n or sum(sizes) != t.shape[dim]:
                raise ValueError(f"sizes {tuple(sizes)} do not split dim "
                                 f"{dim} ({t.shape[dim]}) over {n} ranks")
            start, length = sum(sizes[:idx]), sizes[idx]
        else:
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} ({t.shape[dim]}) does not split "
                                 f"over {n} ranks")
            length = t.shape[dim] // n
            start = idx * length
        out = out.narrow(dim, start, length)
    return out.contiguous()


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One or more mesh axes as a collective sees them: their process
    group, this rank's index over them (the first axis major) and the
    count."""

    group: Any
    rank: int
    size: int


class Mesh:
    """A training mesh of up to three axes (``pod``, ``data``, ``model``
    in any subset, that order) over the ranks of the default process
    group, rank-major as ``jax.make_mesh`` lays out its devices: rank r
    sits at the coordinates of r in the row-major grid of ``shape``.

    Every rank makes a process group for every nonempty set of the axes
    (``dist.new_group``, in the same order on every rank), so a
    collective over any of them (``axis``) needs no private
    ``DeviceMesh`` API. ``mesh_dim_names``, ``shape``,
    ``get_local_rank`` and ``get_group`` are ``DeviceMesh``'s, so the
    rules and ``shard_tensor`` take it as they take one. Build it with
    ``launch/mesh.py:make_train_mesh``."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        if not dist.is_initialized():
            raise RuntimeError(
                "a mesh needs its ranks: one process a rank, joined to one "
                "process group (repro_torch.distributed.ranks)")
        if len(shape) != len(axes) or len(set(axes)) != len(axes) or \
                [a for a in ("pod", "data", "model") if a in axes] != \
                list(axes):
            raise ValueError(f"axes {tuple(axes)} of shape {tuple(shape)}: "
                             f"a subset of ('pod', 'data', 'model') in "
                             f"that order, one size each")
        n = 1
        for sz in shape:
            n *= sz
        if dist.get_world_size() != n:
            raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks; the "
                             f"process group has {dist.get_world_size()}")
        self.shape = tuple(int(sz) for sz in shape)
        self.mesh_dim_names = tuple(axes)
        self.device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        rank, self.coords = dist.get_rank(), {}
        for a, sz in reversed(list(zip(axes, self.shape))):
            rank, self.coords[a] = divmod(rank, sz)
        grid = list(itertools.product(*(range(sz) for sz in self.shape)))
        self._axes: Dict[Tuple[str, ...], AxisGroup] = {}
        for k in range(1, len(axes) + 1):
            for sub in itertools.combinations(axes, k):
                own = None
                rest = [a for a in axes if a not in sub]
                for fixed in itertools.product(*(
                        range(self.size(a)) for a in rest)):
                    at = dict(zip(rest, fixed))
                    members = [r for r, c in enumerate(grid)
                               if all(c[axes.index(a)] == v
                                      for a, v in at.items())]
                    pg = dist.new_group(members)
                    if all(self.coords[a] == v for a, v in at.items()):
                        own = pg
                idx, cnt = 0, 1
                for a in sub:
                    idx, cnt = idx * self.size(a) + self.coords[a], \
                        cnt * self.size(a)
                self._axes[sub] = AxisGroup(own, idx, cnt)

    def size(self, axis: str) -> int:
        return mesh_axes(self).get(axis, 1)

    def get_local_rank(self, axis: str) -> int:
        return self.coords[axis]

    def get_group(self, axis: str):
        return self._axes[(axis,)].group

    def axis(self, *axes: str) -> Optional[AxisGroup]:
        """The group over ``axes`` (those of the mesh among them, in mesh
        order); None when none is on the mesh."""
        sub = tuple(a for a in self.mesh_dim_names if a in axes)
        return self._axes[sub] if sub else None

    @property
    def dp(self) -> Optional[AxisGroup]:
        """The data-parallel axes, ``pod`` and ``data``."""
        return self.axis("pod", "data")

    def model(self, d_ff: int) -> Optional["ModelGroup"]:
        """The ``model`` axis as training's layers take it (an even split
        of ``d_ff``, collectives with a backward); None off the mesh."""
        ax = self.axis("model")
        if ax is None:
            return None
        return ModelGroup(group=ax.group, rank=ax.rank, size=ax.size,
                          d_ff=d_ff, ffn_sizes=ffn_split(d_ff, ax.size),
                          train=True)


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """The ``model`` axis as a layer sees it: its process group, this
    rank's index and the count, and the FFN's split (``ffn_sizes``, one a
    rank, over ``d_ff`` columns). Passed explicitly down the serving entry
    points (``lm.paged_*``, ``_paged_scan``, ``_block_apply``) to the
    layers that run the collectives. With ``train`` (``Mesh.model``) the
    layers run training's collectives, which have a backward
    (``collectives.copy_in``, ``reduce_out``, ``gather_last``), in place
    of serving's in-place ones."""

    group: Any
    rank: int
    size: int
    d_ff: int
    ffn_sizes: Tuple[int, ...]
    train: bool = False        # training's collectives, with a backward

    @property
    def ffn_start(self) -> int:
        """The first FFN column this rank holds."""
        return sum(self.ffn_sizes[:self.rank])

    @classmethod
    def of(cls, mesh, d_ff: int, ffn_sizes: Sequence[int]) -> "ModelGroup":
        return cls(group=mesh.get_group("model"),
                   rank=mesh.get_local_rank("model"),
                   size=tp_size(mesh), d_ff=d_ff,
                   ffn_sizes=tuple(ffn_sizes))
