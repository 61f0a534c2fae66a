"""Tensor-parallel serving in the port on the CPU: ranks are spawned
processes joined over gloo (one torch thread each), every rank holding its
shard of the weights and KV pools (``bridge.shard_params``,
``PagedKVCache(mesh=)``).

- Against JAX: port tp 2 on the workload of
  ``tests/test_tp_serving.py:95-160`` (gather, spec k 2 with tile-skip
  drafts at threshold 0.05, chunked prefill of 8, the prefix cache, a
  copy-on-write hit) gives the greedy tokens of JAX's unsharded engine on
  the same config and weights: reduced paper-0.5b with 4 TwELL tiles of
  32 on both sides (the default reduced config has one tile, which the
  port refuses to split), C 1 as the port's other JAX parity tests run
  gather (no tile overflows).
- Against the port's tp 1 (which the other tests hold against JAX):
  dense and tile_skip at tp 2 and dense at tp 4 with the workload's
  drafts, a seeded stochastic run, the telemetry summary and the
  pipelined engine (resolved through ``flush()``) at tp 2, on the C 4
  config (8 slots a tile: tiles overflow on ``lm.init`` weights, and a
  rank holds whole tiles, so each keeps the same columns).
- The sharded copy-on-write equals the unsharded one.
- ``flash_decode_attention`` at 2 and 4 ranks against JAX's
  ``collectives.flash_decode_attention`` (8 host devices in one JAX
  subprocess, as ``tests/test_distributed.py:190`` runs it), f32 within
  1e-5.
- Every rank returns the same outputs.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import torch_tp_ranks as ranks_mod
from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.serving import ServingEngine as JaxEngine
from repro.serving import SpecConfig as JaxSpec
from repro_torch.distributed import ranks

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _jax_cfg(c):
    import dataclasses
    cfg = jax_get_config("paper-0.5b").reduced()
    return dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, twell_tile=32, twell_c=c))


@pytest.fixture(scope="module")
def jax_params():
    jp = jlm.init(jax.random.PRNGKey(0), _jax_cfg(1))
    return jp, jax.tree_util.tree_map(np.asarray, jp)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    cfg = ranks_mod.get_config("paper-0.5b").reduced()
    shape = (cfg.num_layers, 10, 4, cfg.num_kv_heads, cfg.resolved_head_dim)
    cow = {n: rng.standard_normal(shape).astype(np.float32)
           for n in ("kpool", "vpool")}
    b, s, h, hd = 2, 64, 4, 16
    flash = tuple(rng.standard_normal(sh).astype(np.float32)
                  for sh in ((b, 1, h, hd), (b, s, h, hd), (b, s, h, hd)))
    return cow, flash + (40,)


@pytest.fixture(scope="module")
def tp2(jax_params, inputs):
    return ranks.spawn(ranks_mod.rank_tp2, 2,
                       (jax_params[1], inputs[0], inputs[1]), device="cpu")


@pytest.fixture(scope="module")
def tp4(inputs):
    return ranks.spawn(ranks_mod.rank_tp4, 4, (inputs[1],), device="cpu")


@pytest.fixture(scope="module")
def tp1(jax_params):
    return ranks_mod.serving_suite(None, jax_params[1])


def test_ranks_agree(tp2, tp4):
    for outs in (tp2, tp4):
        for o in outs[1:]:
            for k in outs[0]:
                if k in ("cow", "calls", "debug_mesh"):
                    continue     # a rank's own heads, counts, coordinates
                np.testing.assert_equal(o[k], outs[0][k], err_msg=k)


def test_tp2_gather_spec_prefix_cache_equals_jax(tp2, jax_params):
    """JAX's unsharded engine, same config, weights and workload: the port
    at tp 2 gives its greedy tokens exactly, and runs what JAX's test
    asserts ran (COW, spec, prefix-cache hits)."""
    jp, _ = jax_params
    eng = JaxEngine(jp, _jax_cfg(1), backend="gather",
                    spec=JaxSpec(k=2, draft_backend="tile_skip",
                                 draft_threshold=0.05),
                    **ranks_mod.ENGINE)
    handles, pending, step = {}, ranks_mod.workload(256), 0
    while pending or eng.has_unfinished():
        while pending and pending[0][0] <= step:
            _, p, mt = pending.pop(0)
            h = eng.submit(p, max_tokens=mt)
            handles[h.rid] = h
        eng.step()
        step += 1
    want = {r: h.result().token_ids for r, h in handles.items()}
    got = tp2[0]["jax_gather"]
    assert got["tokens"] == want
    assert got["cow"] >= 1, "fully-cached prompt never hit COW"
    assert got["drafted"] > 0, "spec never ran"
    assert got["cached"] > 0, "prefix cache never hit"
    assert tp2[0]["calls"]["all_reduce"] > 0 and \
        tp2[0]["calls"]["all_gather"] > 0


@pytest.mark.parametrize("run", ["dense", "tile_skip", "sampled",
                                 "telemetry", "pipelined", "jax_gather"])
def test_tp2_equals_tp1(tp2, tp1, run):
    """Each tp 2 run gives the port's tp 1 tokens (greedy, and the seeded
    stochastic run), with the same copy-on-write, drafts and cache hits;
    the telemetry summary's sparsity probe, FLOPs and counters equal tp
    1's; the pipelined engine's tokens resolve through ``flush()``."""
    got, want = tp2[0][run], tp1[run]
    assert got == want
    assert got["drafted"] > 0 and got["cached"] > 0
    # the pipelined run makes no copy-on-write on this workload, at tp 1
    # either (its steps admit and commit one step apart)
    assert got["cow"] >= (run != "pipelined")


def test_tp2_shim_equals_handle_api(tp2, tp1):
    assert tp2[0]["shim"] == tp1["shim"]


def test_tp_label(tp2, tp1):
    """``build_info``'s ``tp`` label is the mesh's size (JAX's
    ``mesh.devices.size``)."""
    assert [ln.replace('tp="2"', 'tp="1"') for ln in tp2[0]["tp_label"]] \
        == tp1["tp_label"]
    assert 'tp="2"' in tp2[0]["tp_label"][0]


def test_tp4_dense_equals_tp1(tp4, tp1):
    assert tp4[0]["dense"] == tp1["dense"]
    assert tp4[0]["debug_mesh"][0] == {"data": 2, "model": 2}
    assert sorted(o["debug_mesh"][1:] for o in tp4) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_sharded_cow_copy_matches_unsharded(tp2, inputs):
    """Each rank's pools after the COW sequence are its kv heads of the
    unsharded pools after the same sequence: the copy runs on each rank's
    own pool, the tables and hashes are the same on every rank."""
    want = ranks_mod.cow_pools(None, inputs[0])
    for r, o in enumerate(tp2):
        for n, pool in o["cow"].items():
            h = pool.shape[3]
            np.testing.assert_array_equal(
                pool, want[n][:, :, :, r * h:(r + 1) * h])


_JAX_FLASH = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.distributed.collectives import flash_decode_attention
d = np.load(sys.argv[1])
q, k, v, length = d["q"], d["k"], d["v"], int(d["length"])
out = {}
for tp in (2, 4):
    mesh = jax.make_mesh((tp,), ("model",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:tp])
    with jax.set_mesh(mesh):
        sh = NamedSharding(mesh, P(None, "model", None, None))
        out[f"tp{tp}"] = np.asarray(jax.jit(
            lambda q, k, v: flash_decode_attention(q, k, v, length, mesh))(
            q, jax.device_put(k, sh), jax.device_put(v, sh)))
np.savez(sys.argv[2], **out)
"""


def test_flash_decode_attention_matches_jax(tp2, tp4, inputs, tmp_path):
    q, k, v, length = inputs[1]
    np.savez(tmp_path / "in.npz", q=q, k=k, v=v, length=length)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", _JAX_FLASH,
                        str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    want = np.load(tmp_path / "out.npz")
    for tp, outs in ((2, tp2), (4, tp4)):
        for o in outs:
            np.testing.assert_allclose(o["flash"], want[f"tp{tp}"],
                                       rtol=1e-5, atol=1e-5)
