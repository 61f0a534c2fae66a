"""Training on a mesh in the port on the CPU: ranks are spawned processes
joined over gloo (one torch thread each), every rank holding its shards
of the parameters and of AdamW's m and v (``lm.train_specs``, FSDP on
``data``, TP on ``model``, DP on ``pod``) and its rows of the batch.

- The train step on (pod 2, data 2, model 2) and on (data 2, model 2)
  with microbatch 4, dense and hybrid FFN, on
  ``tests/test_distributed.py:46-47``'s config and one 8 x 32 batch from
  a numpy seed, against JAX's unsharded ``make_train_step`` on the same
  weights: every gathered gradient within rtol 1e-4, atol 1e-6, the
  metrics within 1e-5 relative, the parameters after the step where
  |g| > 1e-6 (AdamW's first step divides g by |g| + eps), then 3 more
  steps and a falling loss. The gate keeps 48 of its 128 columns, so
  that the hybrid format neither overflows in JAX nor on a rank (each
  rank packs its own d_ff shard) and uses its backup rows.
- ``moe_apply_sorted`` on a (data 2, model 4) mesh against JAX's (8 host
  devices in one JAX subprocess, as ``tests/test_distributed.py:68-94``
  runs it): capacity 8.0 (no drops) and 1.25 (drops), the
  ``REPRO_MOE_MANUAL_GATHER`` switch off and on, expert parallelism (4
  experts) and expert TP (3 experts); y, every aux entry and
  ``moe_drop_frac``.
- ``compressed_psum`` over ``pod`` on (2, 2, 2): the replicated case of
  ``tests/test_distributed.py:97-119`` against JAX's, and per-pod inputs
  against the numpy formula (the reduced mean is what was sent, and
  over the pods red + err keeps g + e).
- A checkpoint saved from (data 2, model 2) restores onto (model 4) and
  onto one unsharded process with equal leaves, and JAX's manager reads
  it.
- Every rank returns the same metrics.

Two spawn sessions: one of 8 ranks, one of 4.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from repro import training as jtraining
from repro.checkpoint.ckpt import CheckpointManager as JaxManager
from repro.config import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_get_config
from repro.core.sparsity import l1_schedule
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.distributed import ranks
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.tree import tree_map

ROOT = os.path.join(os.path.dirname(__file__), "..")
ALIVE = 48                # gate columns kept of d_ff 128
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
METRIC_RTOL = 1e-5


def _jax_cfg(impl):
    cfg = jax_get_config("paper-0.5b").reduced(d_model=64, d_ff=128,
                                               num_layers=2, num_heads=4,
                                               head_dim=16)
    return dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, ffn_impl=impl))


def _jax_tcfg(microbatch=0):
    t = R.train_tcfg(microbatch)
    return JaxTrainConfig(learning_rate=t.learning_rate,
                          warmup_steps=t.warmup_steps,
                          total_steps=t.total_steps, microbatch=microbatch)


@pytest.fixture(scope="module")
def state():
    """JAX's initial parameters (the gate's columns past ALIVE zeroed),
    its AdamW state and the batch, as numpy."""
    params = jax.tree_util.tree_map(
        np.array, jlm.init(jax.random.PRNGKey(0), _jax_cfg("dense")))
    params["blocks"]["ffn"]["wg"][..., ALIVE:] = 0
    opt = jadamw.init(jax.tree_util.tree_map(jnp.asarray, params))
    opt = (np.asarray(opt.step), jax.tree_util.tree_map(np.asarray, opt.m),
           jax.tree_util.tree_map(np.asarray, opt.v))
    rng = np.random.RandomState(0)
    vocab = _jax_cfg("dense").vocab_size
    batch = {"tokens": rng.randint(0, vocab, (8, 32)).astype(np.int32),
             "labels": rng.randint(0, vocab, (8, 32)).astype(np.int32)}
    return params, opt, batch


@pytest.fixture(scope="module")
def moe_state(state):
    """The reduced mixtral-8x22b (4 experts, top 2, window 32: causal at
    S 32) from JAX's init, its AdamW state, and the dense runs' batch."""
    params = jax.tree_util.tree_map(
        np.array, jlm.init(jax.random.PRNGKey(1), _jax_moe_cfg()))
    opt = jadamw.init(jax.tree_util.tree_map(jnp.asarray, params))
    opt = (np.asarray(opt.step), jax.tree_util.tree_map(np.asarray, opt.m),
           jax.tree_util.tree_map(np.asarray, opt.v))
    return params, opt, state[2]


def _jax_moe_cfg():
    return jax_get_config("mixtral-8x22b").reduced()


@pytest.fixture(scope="module")
def moe_inputs():
    """Each MoE case's (params, x) from a numpy seed: a router of std 0.5
    and x (4, 32, 32) of mean 1 (routing skewed enough to drop at capacity
    1.25: 2-29% of a shard's choices), experts of std 0.02."""
    out = []
    for e, cap, manual in R.MOE_CASES:
        cfg = R.moe_config(e, cap)
        rng = np.random.RandomState(100 + e)
        d, f = cfg.d_model, cfg.d_ff
        p = {"router": (0.5 * rng.standard_normal((d, e))).astype(np.float32),
             "experts": {
                 "wu": (0.02 * rng.standard_normal((e, d, f))).astype(
                     np.float32),
                 "wd": (0.02 * rng.standard_normal((e, f, d))).astype(
                     np.float32),
                 "wg": (0.02 * rng.standard_normal((e, d, f))).astype(
                     np.float32)}}
        x = rng.standard_normal((4, 32, d)) + 1.0
        out.append((p, x.astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def grads_in():
    rng = np.random.RandomState(7)
    g = {"w": rng.standard_normal((16, 8)).astype(np.float32)}
    per_pod = {"w": (rng.standard_normal((2, 16, 8)).astype(np.float32),
                     (0.01 * rng.standard_normal((2, 16, 8))).astype(
                         np.float32))}
    return g, per_pod


_JAX_MESH = """
import dataclasses, os, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models import moe
from repro.optim.compress import compressed_psum, init_error_state
from repro import training
from repro.config import TrainConfig
from repro.distributed.sharding import batch_spec, make_param_specs, named
from repro.models import lm
from repro.optim import adamw
with open(sys.argv[1], "rb") as f:
    cases, inputs, g, (params, _, batch), tc = pickle.load(f)
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for (e, cap, manual), (p, x) in zip(cases, inputs):
    cfg = dataclasses.replace(get_config("mixtral-8x22b").reduced(
        d_model=32, d_ff=64, num_experts=e, top_k=2), capacity_factor=cap)
    os.environ["REPRO_MOE_MANUAL_GATHER"] = "1" if manual else "0"
    with jax.set_mesh(mesh):
        ps = jax.device_put(jax.tree.map(jnp.asarray, p),
                            NamedSharding(mesh, P()))
        xs = jax.device_put(jnp.asarray(x),
                            NamedSharding(mesh, P("data", None, None)))
        y, aux = jax.jit(lambda p, x: moe.moe_apply_sorted(
            p, x, cfg, cfg.sparsity, True, mesh, ("data",)))(ps, xs)
    out[(e, cap, manual)] = {"y": np.asarray(y), "aux": {
        k: np.asarray(v) for k, v in aux.items()}}
pod = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                    axis_types=(AxisType.Auto,) * 3)
gj = jax.tree.map(jnp.asarray, g)
with jax.set_mesh(pod):
    red, err = jax.jit(lambda g, e: compressed_psum(
        g, e, pod, axis="pod", method="int8"))(gj, init_error_state(gj))
out["compress"] = (jax.tree.map(np.asarray, red),
                   jax.tree.map(np.asarray, err))
cfg = get_config("mixtral-8x22b").reduced()
with jax.set_mesh(pod):
    pspecs = make_param_specs(jax.eval_shape(lambda: params), cfg, pod)
    ps = jax.device_put(jax.tree.map(jnp.asarray, params), named(pod, pspecs))
    opt = jax.device_put(adamw.init(ps), named(
        pod, adamw.AdamWState(P(), pspecs, pspecs)))
    bs = {k: jax.device_put(jnp.asarray(v), named(pod, batch_spec(
        v.ndim, pod, v.shape[0]))) for k, v in batch.items()}
    grads = jax.jit(jax.grad(lambda p, b: lm.loss_fn(
        p, b, cfg, cfg.sparsity.l1_coeff)[0]))(ps, bs)
    p1, _, m = jax.jit(training.make_train_step(cfg, TrainConfig(**tc)))(
        ps, opt, bs)
out["moe_train"] = {"grads": jax.tree.map(np.asarray, grads),
                    "metrics": {k: float(v) for k, v in m.items()},
                    "params": jax.tree.map(np.asarray, p1)}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def jax_mesh(moe_inputs, grads_in, moe_state, tmp_path_factory):
    """JAX on 8 host devices, in a subprocess started first and read when
    a test needs it: the sorted MoE cases, the compressed psum, and the
    reduced mixtral's gradients and train step sharded on (pod 2, data 2,
    model 2), where its MoE blocks take the sorted dispatch."""
    d = tmp_path_factory.mktemp("jax_mesh")
    t = R.train_tcfg()
    tc = {"learning_rate": t.learning_rate, "warmup_steps": t.warmup_steps,
          "total_steps": t.total_steps}
    with open(d / "in.pkl", "wb") as f:
        pickle.dump((R.MOE_CASES, moe_inputs, grads_in[0], moe_state, tc), f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen([sys.executable, "-c", _JAX_MESH,
                             str(d / "in.pkl"), str(d / "out.pkl")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)

    def result():
        if proc.returncode is None:
            _, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-3000:]
        with open(d / "out.pkl", "rb") as f:
            return pickle.load(f)
    return result


@pytest.fixture(scope="module")
def rank8(state, moe_state, moe_inputs, grads_in, jax_mesh):
    return ranks.spawn(R.rank_8, 8, (state, moe_state, R.MOE_CASES,
                                     moe_inputs, *grads_in), device="cpu")


def tiny_state(state):
    """``R.tiny_config``'s JAX initial state and the dense runs' batch."""
    params = jax.tree_util.tree_map(np.array, jlm.init(
        jax.random.PRNGKey(2), _jax_tiny_cfg()))
    opt = jadamw.init(jax.tree_util.tree_map(jnp.asarray, params))
    return (params, (np.asarray(opt.step),
                     jax.tree_util.tree_map(np.asarray, opt.m),
                     jax.tree_util.tree_map(np.asarray, opt.v)), state[2])


def _jax_tiny_cfg():
    return jax_get_config("paper-0.5b").reduced(
        d_model=4, num_heads=1, num_kv_heads=1, head_dim=4, d_ff=8,
        num_layers=4)


@pytest.fixture(scope="module")
def rank4(state, moe_state, tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("mesh_ckpt")
    out = ranks.spawn(R.rank_4, 4, (*state, moe_state, tiny_state(state),
                                    str(ckpt)), device="cpu")
    return out, ckpt


_REFS = {}


def jax_reference(state, impl, microbatch):
    """JAX's unsharded step on the state: its gradients before the clip
    (the microbatches' mean, as ``repro/training.py:52-68`` sums them),
    its metrics, the parameters after it, and R.STEPS losses."""
    key = (impl, microbatch)
    if key in _REFS:
        return _REFS[key]
    cfg, tcfg = _jax_cfg(impl), _jax_tcfg(microbatch)
    params = jax.tree_util.tree_map(jnp.asarray, state[0])
    batch = {k: jnp.asarray(v) for k, v in state[2].items()}
    l1c = l1_schedule(jnp.int32(0), cfg.sparsity.l1_coeff, 0, 0)
    grad = jax.jit(jax.grad(lambda p, b: jlm.loss_fn(p, b, cfg, l1c)[0]))
    if microbatch:
        n = batch["tokens"].shape[0] // microbatch
        gs = [grad(params, {k: v[i * microbatch:(i + 1) * microbatch]
                            for k, v in batch.items()}) for i in range(n)]
        grads = jax.tree_util.tree_map(lambda *g: sum(g) / n, *gs)
    else:
        grads = grad(params, batch)
    step = jax.jit(jtraining.make_train_step(cfg, tcfg))
    p1, o1, m = step(params, jadamw.init(params), batch)
    out = {"grads": jax.tree_util.tree_map(np.asarray, grads),
           "metrics": {k: float(v) for k, v in m.items()},
           "params": jax.tree_util.tree_map(np.asarray, p1),
           "losses": [float(m["loss"])]}
    for _ in range(R.STEPS - 1):
        p1, o1, m = step(p1, o1, batch)
        out["losses"].append(float(m["loss"]))
    _REFS[key] = out
    return out


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree, np.float64)


def _check_run(got, want):
    for (name, g), (_, w) in zip(_leaves(got["grads"]),
                                 _leaves(want["grads"])):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"gradient {name}")
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=METRIC_RTOL,
                                   atol=0, err_msg=f"metric {k}")
    for (name, p), (_, w), (_, g) in zip(_leaves(got["params"]),
                                         _leaves(want["params"]),
                                         _leaves(want["grads"])):
        big = np.abs(g) > 1e-6
        np.testing.assert_allclose(p[big], w[big], rtol=1e-4, atol=1e-6,
                                   err_msg=f"parameter {name}")
    assert got["losses"][-1] < got["losses"][0], got["losses"]
    if "losses" in want:
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)


@pytest.mark.parametrize("impl", ["dense", "hybrid"])
def test_pod_mesh_step_matches_jax_unsharded(rank8, state, impl):
    _check_run(rank8[0]["train"][impl], jax_reference(state, impl, 0))


@pytest.mark.parametrize("impl", ["dense", "hybrid"])
def test_data_model_microbatch_step_matches_jax_unsharded(rank4, state,
                                                          impl):
    _check_run(rank4[0][0]["train"][impl], jax_reference(state, impl, 4))


def test_moe_pod_mesh_step_matches_jax_sharded(rank8, jax_mesh):
    """The moe family on (pod 2, data 2, model 2): expert parallelism
    over ``model``, the sorted dispatch per (pod, data) shard, against
    JAX's step sharded on the same mesh (its balance loss and capacity
    are per shard too, so an unsharded step is not the reference)."""
    _check_run(rank8[0]["moe_train"], jax_mesh()["moe_train"])


def test_hybrid_format_used_without_overflow(rank8, rank4):
    """Each rank packed its own d_ff shard: no backup overflowed, and
    rows went to the backup on some rank."""
    for outs in (rank8, rank4[0]):
        runs = [o["train"]["hybrid"] for o in outs]
        assert not any(r["overflow"] for r in runs)
        assert sum(r["backup_rows"] for r in runs) > 0


def test_every_rank_returns_the_same_metrics(rank8, rank4):
    for outs in (rank8, rank4[0]):
        for impl in ("dense", "hybrid"):
            first = outs[0]["train"][impl]
            for o in outs[1:]:
                assert o["train"][impl]["metrics"] == first["metrics"]
                assert o["train"][impl]["losses"] == first["losses"]


def _moe_ids():
    return [f"e{e}-cap{cap}-{'manual' if m else 'default'}"
            for e, cap, m in R.MOE_CASES]


@pytest.mark.parametrize("case", R.MOE_CASES, ids=_moe_ids())
def test_moe_sorted_matches_jax(rank8, jax_mesh, case):
    want = jax_mesh()[case]
    for o in rank8:
        got = o["moe"][case]
        np.testing.assert_allclose(got["y"], want["y"], rtol=1e-5,
                                   atol=1e-6)
        assert set(got["aux"]) == set(want["aux"])
        for k, w in want["aux"].items():
            np.testing.assert_allclose(np.asarray(got["aux"][k], np.float64),
                                       np.asarray(w, np.float64), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    drop = float(want["aux"]["moe_drop_frac"])
    assert (drop > 0) == (case[1] == 1.25), drop


def test_moe_switch_gives_the_same_numbers(rank8, rank4):
    """The sorted dispatch's y, and the reduced mixtral's gradients on
    (data 2, model 2) through the layer loop, with the switch off and on
    (the experts gathered by the layer loop, or by each dispatch)."""
    for e in (4, 3):
        for cap in (8.0, 1.25):
            a, b = (rank8[0]["moe"][(e, cap, m)] for m in (False, True))
            np.testing.assert_array_equal(a["y"], b["y"])
    off, on = rank4[0][0]["switch"]
    for (name, a), (_, b) in zip(_leaves(off), _leaves(on)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9, err_msg=name)
    assert np.abs(next(_leaves(off["blocks"]["moe"]["experts"]))[1]).max() > 0


def test_remat_full_on_the_mesh_equals_none(rank4):
    """Under remat full each layer's FSDP gathers run again in the
    backward: the gradients equal remat none's (the microbatched dense
    run's) bit for bit."""
    none = rank4[0][0]["train"]["dense"]["grads"]
    full = rank4[0][0]["remat_full"]
    for (name, a), (_, b) in zip(_leaves(none), _leaves(full)):
        np.testing.assert_array_equal(a, b, err_msg=name)


def _jax_grads(cfg, state):
    params = jax.tree_util.tree_map(jnp.asarray, state[0])
    batch = {k: jnp.asarray(v) for k, v in state[2].items()}
    return jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(
        lambda p, b: jlm.loss_fn(p, b, cfg, cfg.sparsity.l1_coeff)[0]))(
            params, batch))


def _check_grads(got, want):
    for (name, g), (_, w) in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"gradient {name}")


def test_layer_dim_fsdp_matches_jax_unsharded(rank4, state):
    """Every stacked leaf of the tiny config has FSDP on its layer dim:
    each layer is sent by the rank that holds it, its gradient reduced
    back to that rank (and one head stays whole on both model ranks)."""
    _check_grads(rank4[0][0]["tiny"], _jax_grads(_jax_tiny_cfg(),
                                                 tiny_state(state)))


def test_moe_on_the_model_axis_alone_matches_jax_unsharded(rank4,
                                                           moe_state):
    """On (model 4) there are no dp axes: the MoE blocks take the one-hot
    dispatch, JAX's drop-free semantics, with one expert a rank."""
    _check_grads(rank4[0][0]["moe_model4"], _jax_grads(_jax_moe_cfg(),
                                                       moe_state))


def test_train_step_refuses_rows_the_dp_ranks_do_not_split(rank4):
    assert "3 rows do not split over the 2 data-parallel ranks" in \
        rank4[0][0]["refused"]


def test_compressed_psum_replicated_matches_jax(rank8, jax_mesh, grads_in):
    want_red, want_err = jax_mesh()["compress"]
    g = grads_in[0]["w"]
    scale = float(np.abs(g).max()) / 127.0
    for o in rank8:
        red, err = o["compress"]["replicated"]
        np.testing.assert_allclose(red["w"], want_red["w"], rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(err["w"], want_err["w"], rtol=1e-6,
                                   atol=1e-7)
        assert np.abs(red["w"] - g).max() <= scale * 0.51 + 1e-6
        np.testing.assert_allclose(red["w"] + err["w"], g, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_compressed_psum_per_pod_inputs(rank8, grads_in, method):
    """Each pod its own g and error: the result is the mean of what the
    pods sent (numpy's int8 or top-k of g + e), and the error feedback
    keeps the sum: mean over pods of red + err == mean of g + e."""
    g, e = grads_in[1]["w"]
    gf = g + e
    if method == "int8":
        scale = np.abs(gf).max(axis=(1, 2), keepdims=True) / np.float32(
            127.0) + np.float32(1e-12)
        sent = np.clip(np.round(gf / scale), -127, 127) * scale
    else:
        k = max(1, int(gf[0].size * 0.1))
        thresh = -np.sort(-np.abs(gf.reshape(2, -1)), axis=1)[:, k - 1]
        sent = gf * (np.abs(gf) >= thresh[:, None, None])
    for o in rank8:
        pod = o["pod"]
        red, err = o["compress"][method]
        np.testing.assert_allclose(red["w"], sent.mean(0), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(err["w"], gf[pod] - sent[pod], rtol=1e-5,
                                   atol=1e-6)
    errs = np.stack([o["compress"][method][1]["w"]
                     for o in rank8 if o["data"] == 0 and o["model"] == 0])
    np.testing.assert_allclose(red["w"] + errs.mean(0), gf.mean(0),
                               rtol=1e-5, atol=1e-6)


def _state_like(cfg):
    """The unsharded trainable tree and AdamW state (zeros), as restore
    takes it."""
    p = lm.trainable(lm.init(cfg, device="cpu"))
    return tree_map(torch.zeros_like, (p, adamw.init(p)))


def _assert_state_equal(got, want):
    for (n, a), (_, b) in zip(_leaves(got[0]), _leaves(want[0])):
        np.testing.assert_array_equal(a, b, err_msg=n)
    np.testing.assert_array_equal(got[1][0], want[1][0])
    for part in (1, 2):
        for (n, a), (_, b) in zip(_leaves(got[1][part]),
                                  _leaves(want[1][part])):
            np.testing.assert_array_equal(a, b, err_msg=n)


def test_checkpoint_restores_onto_another_mesh_and_none(rank4):
    outs, ckpt = rank4
    saved = outs[0]["saved"]
    assert int(saved[1][0]) == R.STEPS
    for o in outs:
        _assert_state_equal(o["saved"], saved)
        _assert_state_equal(o["restored_model4"], saved)
        assert o["extra"] == {"steps": R.STEPS}
    mgr = CheckpointManager(str(ckpt))
    step, got, extra = mgr.restore_latest(_state_like(
        R.train_config("dense")))
    assert step == R.STEPS and extra == {"steps": R.STEPS}
    _assert_state_equal((bridge.to_numpy(got[0]),
                         bridge.opt_state_to_numpy(got[1])), saved)


def test_jax_manager_reads_the_mesh_checkpoint(rank4):
    outs, ckpt = rank4
    saved = outs[0]["saved"]
    params = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), saved[0])
    like = (params, jadamw.AdamWState(
        jax.ShapeDtypeStruct((), jnp.int32), params, params))
    tree, extra = JaxManager(str(ckpt)).restore(R.STEPS, like)
    got = (jax.tree_util.tree_map(np.asarray, tree[0]),
           (np.asarray(tree[1].step),
            jax.tree_util.tree_map(np.asarray, tree[1].m),
            jax.tree_util.tree_map(np.asarray, tree[1].v)))
    _assert_state_equal(got, saved)
    assert extra == {"steps": R.STEPS}
