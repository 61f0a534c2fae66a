"""The port's sharding rules (``repro_torch/distributed/sharding.py``)
against the JAX package's, leaf for leaf, with no process group: every
parameter of all 12 full configs (JAX's shapes from ``jax.eval_shape``,
the port's tree from a meta init with the same paths), the cache layouts
of ``cache_spec``'s docstring and ``batch_spec``, on six meshes, FSDP on
and off; ``validate_mesh``'s refusals against JAX's, plus the port's
whole-tile one; the FFN's whole-tile split; ``shard_tensor``; the mesh
constructors' refusals."""
import dataclasses

import jax
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import AxisType

from repro.configs import ALL_ARCHS
from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jsh
from repro.models import lm as jlm
from repro.serving.backends import get_backend as jax_backend
from repro_torch.configs import get_config
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import AbstractMesh
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm
from repro_torch.serving.backends import get_backend, make_draft_pair

MESHES = [((2,), ("model",)), ((4,), ("model",)), ((8,), ("model",)),
          ((16,), ("model",)), ((2, 4), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]


def _meshes():
    for sizes, names in MESHES:
        yield (JaxAbstractMesh(sizes, names,
                               axis_types=(AxisType.Auto,) * len(sizes)),
               AbstractMesh(sizes, names))


def _flat_jax(tree):
    """path -> leaf of a JAX pytree whose leaves are PartitionSpecs or
    ShapeDtypeStructs."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _norm(spec):
    """A JAX PartitionSpec entry list as the port writes it (a length-1
    axis tuple and its name are the same entry)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_match_jax(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    shapes = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg))
    jax_shapes = {p: tuple(s.shape) for p, s in _flat_jax(shapes).items()}
    port_tree = lm.trainable(lm.init(tcfg, device="meta"))
    assert {p: tuple(t.shape) for p, t in _flat(port_tree).items()} == \
        jax_shapes, "the port's parameter tree differs from JAX's"
    for jmesh, tmesh in _meshes():
        for fsdp in (True, False):
            want = _flat_jax(jsh.make_param_specs(shapes, jcfg, jmesh, fsdp))
            got = _flat(sharding.make_param_specs(port_tree, tcfg, tmesh,
                                                  fsdp))
            assert got == {p: _norm(s) for p, s in want.items()}, \
                (arch, tmesh, fsdp)


def _cache_layouts(cfg):
    """Every layout of cache_spec's docstring at this config's sizes, at a
    batch that the data axes divide and at one that they do not."""
    L, hkv, hd = cfg.num_layers, max(cfg.num_kv_heads, 1), \
        cfg.resolved_head_dim
    h = max(cfg.num_heads, 1)
    for b in (8, 3):
        for s in (4096, 7):
            yield "k", (L, b, s, hkv, hd)
            yield "blocks/v", (L, b, s, hkv, hd)
            yield "xk", (L, b, s, hkv, hd)
            yield "xv", (L, b, 1500, hkv, hd)
        yield "state", (L, b, h, hd, 16)
        yield "wkv", (L, b, h, 64, 64)
        yield "conv", (L, b, 3, 4096)
        yield "shift_tm", (L, b, cfg.d_model)
    yield "kpool", (L, 129, 16, hkv, hd)
    yield "vpool", (L, 129, 16, hkv, hd)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_and_batch_specs_match_jax(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    for jmesh, tmesh in _meshes():
        for path, shape in _cache_layouts(tcfg):
            assert sharding.cache_spec(path, shape, tcfg, tmesh) == _norm(
                jsh.cache_spec(path, shape, jcfg, jmesh)), \
                (arch, path, shape, tmesh)
        for ndim in (1, 2, 3):
            for batch in (0, 1, 2, 4, 6, 8):
                assert sharding.batch_spec(ndim, tmesh, batch) == _norm(
                    jsh.batch_spec(ndim, jmesh, batch)), (ndim, batch, tmesh)
        pools = sharding.make_paged_pool_shardings(tcfg, tmesh, 17, 16)
        assert set(pools) == {"kpool", "vpool"}
        assert pools["kpool"][1] is None and pools["kpool"][2] is None


def test_make_cache_specs_match_jax():
    """``make_cache_specs`` over a nested cache tree, path for path, at
    every mesh (deepseek-67b: 8 kv heads, so tp 16 takes the sequence)."""
    jcfg, tcfg = jax_get_config("deepseek-67b"), get_config("deepseek-67b")
    layouts = {"layer": {p.split("/")[-1]: shape for p, shape in
                         _cache_layouts(tcfg)}}
    jtree = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, "float32"),
                         layouts, is_leaf=lambda x: isinstance(x, tuple))
    ttree = {"layer": {k: torch.empty(v, device="meta")
                       for k, v in layouts["layer"].items()}}
    for jmesh, tmesh in _meshes():
        want = _flat_jax(jsh.make_cache_specs(jtree, jcfg, jmesh))
        got = _flat(sharding.make_cache_specs(ttree, tcfg, tmesh))
        assert got == {p: _norm(s) for p, s in want.items()}, tmesh


def test_engine_refuses_other_families_under_tp():
    """At tp > 1 the engine serves the dense family only; a window-free
    MoE config is refused, naming ROADMAP.md's queue."""
    import dataclasses as dc
    from repro_torch.serving import ServingEngine
    cfg = dc.replace(get_config("mixtral-8x22b").reduced(), window=0)
    params = lm.init(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ServingEngine(params, cfg, backend="dense", device="cpu",
                      mesh=AbstractMesh((2,), ("model",)))


@pytest.mark.parametrize("tp", [2, 3, 4])
def test_validate_mesh_refuses_what_jax_refuses(tp):
    """The port refuses what JAX refuses (kv heads, heads, d_ff, padded
    vocab not divisible), each backend, at the reduced config and at one
    variant per refusal; and JAX's message."""
    base = get_config("paper-0.5b").reduced()
    jbase = jax_get_config("paper-0.5b").reduced()
    variants = [{}, {"num_kv_heads": 3}, {"num_heads": 6, "num_kv_heads": 6},
                {"d_ff": 96}, {"vocab_size": 250, "vocab_pad_multiple": 1}]
    jm = JaxAbstractMesh((tp,), ("model",), axis_types=(AxisType.Auto,))
    tm = AbstractMesh((tp,), ("model",))
    for over in variants:
        tcfg = dataclasses.replace(base, **over)
        jcfg = dataclasses.replace(jbase, **over)
        for name in ("dense", "gather", "tile_skip"):
            try:
                jax_backend(name).validate_mesh(jcfg, jm)
                jax_err = None
            except ValueError as e:
                jax_err = str(e)
            if jax_err is not None:
                with pytest.raises(ValueError) as got:
                    get_backend(name).validate_mesh(tcfg, tm)
                assert str(got.value) == jax_err
            elif name == "dense":
                get_backend(name).validate_mesh(tcfg, tm)


def test_validate_mesh_refuses_a_tile_split():
    """A rank holds whole TwELL tiles whenever a path packs or skips tiles
    (the backend's, or the drafts'): the reduced config's one tile of 128
    is refused at tp 2 for gather and tile_skip, and for dense when its
    drafts tile-skip; dense alone splits evenly, as JAX does. With 4
    tiles of 32 every backend serves at tp 2 and 4."""
    cfg = get_config("paper-0.5b").reduced()
    tm = AbstractMesh((2,), ("model",))
    for name in ("gather", "tile_skip"):
        with pytest.raises(ValueError, match="whole tiles"):
            get_backend(name).validate_mesh(cfg, tm)
    drafts = make_draft_pair("dense", "tile_skip", 0.05).draft
    with pytest.raises(ValueError, match="whole tiles"):
        get_backend("dense").validate_mesh(cfg, tm, drafts)
    get_backend("dense").validate_mesh(cfg, tm)
    assert get_backend("dense").ffn_sizes(cfg, 2) == (64, 64)
    cfg4 = dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, twell_tile=32))
    for tp in (2, 4):
        for name in ("dense", "gather", "tile_skip"):
            get_backend(name).validate_mesh(
                cfg4, AbstractMesh((tp,), ("model",)), drafts)
    with pytest.raises(ValueError, match="whole tiles"):       # 4 < 8
        get_backend("gather").validate_mesh(
            dataclasses.replace(cfg4, num_heads=8, num_kv_heads=8),
            AbstractMesh((8,), ("model",)))


def test_ffn_split_whole_tiles():
    """The whole-tile split of the full configs' d_ff (tiles of 256)."""
    t = 256
    assert sharding.ffn_split(5632, 2, t) == (2816, 2816)        # 11/11
    assert sharding.ffn_split(5632, 4, t) == (1536, 1536, 1280, 1280)
    assert sharding.ffn_split(22016, 8, t) == (2816,) * 6 + (2560,) * 2
    assert sharding.ffn_split(53248, 8, t) == (6656,) * 8           # 26
    assert sharding.ffn_split(5632, 4) == (1408,) * 4               # even
    assert sum(sharding.ffn_split(5632, 3, t)) == 5632
    with pytest.raises(ValueError, match="whole tiles"):
        sharding.ffn_split(128, 2, 128)
    with pytest.raises(ValueError, match="not divisible"):
        sharding.ffn_split(100, 3)


def test_shard_tensor_slices():
    """A rank's slice: even over one axis, mixed-radix over a tuple of
    axes (the first major, as JAX's), the whole-tile sizes on the model
    axis, and the tensor itself when nothing splits."""
    t = torch.arange(4 * 12).reshape(4, 12)
    m = AbstractMesh((2, 3), ("data", "model"))
    got = sharding.shard_tensor(t, (None, "model"), m,
                                coords={"data": 1, "model": 2})
    assert torch.equal(got, t[:, 8:12]) and got.is_contiguous()
    got = sharding.shard_tensor(t, (("data", "model"), None),
                                AbstractMesh((2, 2), ("data", "model")),
                                coords={"data": 1, "model": 0})
    assert torch.equal(got, t[2:3])
    got = sharding.shard_tensor(t, (None, "model"), m, sizes=(6, 4, 2),
                                coords={"data": 0, "model": 1})
    assert torch.equal(got, t[:, 6:10])
    assert sharding.shard_tensor(t, (None, None), m) is t
    with pytest.raises(ValueError, match="split"):
        sharding.shard_tensor(t, (None, "model"), m, sizes=(6, 6),
                              coords={"data": 0, "model": 0})


def test_mesh_constructors_refuse_without_ranks():
    """JAX's message when the world is smaller than the production mesh;
    a serving mesh above one rank needs its processes (no process group
    here: a silent one-rank mesh would be a fallback)."""
    with pytest.raises(RuntimeError, match="need 256 devices, have 1"):
        mesh_mod.make_production_mesh()
    with pytest.raises(RuntimeError, match="need 512 devices, have 1"):
        mesh_mod.make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="processes"):
        sharding.make_serving_mesh(2, "cpu")
    with pytest.raises(ValueError, match="tp must be >= 1"):
        sharding.make_serving_mesh(0, "cpu")
