"""Dead-neuron tracking and targeted reinitialization (Eq. 6; Sec. 4.3
statistics) in the port against the JAX package, the threefry ``split`` and
``normal`` they draw with against ``jax.random`` of the installed jax, and
the train CLI's ``--dead-reinit`` against the JAX trainer's.

Tolerances: keys and random bits exact; float32 normals within 2 ulp of
jax's and bfloat16 normals exact (the port computes XLA's erf_inv
polynomial over XLA's log1p with the same FMAs; XLA's CPU ``sqrt``, used
only for |u| above about 0.9966, is an estimate refined once and can differ
from ``torch.sqrt`` in the last bit); the counts exact, the means
(``nnz_mean``, ``active_frac``, ``l1``) within 1e-6 relative and
``dead_fraction`` = 1 - mean within 2 ulps of 1 (XLA may divide by a count
as a product with its reciprocal); ``targeted_reinit`` within 4 float32
ulps of the largest weight (XLA folds lam * sigma * sqrt(2) into one
constant and contracts the blend into an FMA, roundings the port makes in
the written order); the CLI's losses 1e-4 relative, as
tests/test_torch_train.py holds a resumed run.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.lax import special as lax_special

from repro.core import sparsity as jsparsity
from repro.launch import train as jtrain_cli
from repro_torch import random as prng
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import sparsity
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.models import lm
from repro_torch.optim import adamw

SEEDS = (0, 1, 1234, -5)


def _ulps(a, b):
    """Distance in float32 ulps between two float32 arrays."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_equals_jax(seed):
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    for num in (1, 2, 5, 28):
        np.testing.assert_array_equal(prng.split(key, num).numpy(),
                                      np.asarray(jax.random.split(jkey, num)))
    a, b = prng.split(key)
    ja, jb = jax.random.split(jkey)
    np.testing.assert_array_equal(prng.split(b, 3).numpy(),
                                  np.asarray(jax.random.split(jb, 3)))
    np.testing.assert_array_equal(prng.fold_in(a, 7).numpy(),
                                  np.asarray(jax.random.fold_in(ja, 7)))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_equals_jax(seed):
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    for shape in ((7,), (256, 1000)):
        got = prng.normal(key, shape).numpy()
        want = np.asarray(jax.random.normal(jkey, shape))
        assert got.dtype == want.dtype == np.float32
        assert _ulps(got, want).max() <= 2
        got = prng.normal(key, shape, torch.bfloat16).float().numpy()
        want = np.asarray(jax.random.normal(jkey, shape, jnp.bfloat16))
        np.testing.assert_array_equal(got, want.astype(np.float32))
        got = prng.uniform(key, shape, -1.0, 1.0, torch.bfloat16)
        want = jax.random.uniform(jkey, shape, jnp.bfloat16, -1.0, 1.0)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want).astype(np.float32))


def test_log1p_and_erf_inv_equal_xla():
    rng = np.random.RandomState(0)
    u = np.concatenate([rng.uniform(-1, 1, 200_000),
                        [0.0, 1e-30, -1e-8, 0.41, -0.42, 0.99999994]]
                       ).astype(np.float32)
    x = (u * -u).astype(np.float32)
    np.testing.assert_array_equal(prng.log1p(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.jit(jnp.log1p)(x)))
    got = prng.erf_inv(torch.from_numpy(u)).numpy()
    want = np.asarray(jax.jit(lax_special.erf_inv)(u))
    inner = np.abs(u) < 0.996
    np.testing.assert_array_equal(got[inner], want[inner])
    assert _ulps(got, want).max() <= 1
    edge = prng.erf_inv(torch.tensor([1.0, -1.0])).numpy()
    np.testing.assert_array_equal(edge, [np.inf, -np.inf])


def _sparse_h(seed, shape=(64, 96), p=0.8):
    rng = np.random.RandomState(seed)
    h = rng.randn(*shape).astype(np.float32)
    h[rng.rand(*shape) < p] = 0
    return h


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_statistics_equal_jax(seed):
    h = _sparse_h(seed)
    h[:, :5] = 0                                    # dead columns
    got = sparsity.layer_stats(torch.from_numpy(h))
    want = jsparsity.layer_stats(jnp.asarray(h))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == getattr(torch, str(want[k].dtype)), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)
    assert int(got["nnz_max"]) == int(want["nnz_max"])
    np.testing.assert_array_equal(
        sparsity.position_nnz(torch.from_numpy(h), 4, 16).numpy(),
        np.asarray(jsparsity.position_nnz(jnp.asarray(h), 4, 16)))
    ever = np.random.RandomState(seed + 9).rand(96) < 0.1
    mask = sparsity.update_dead_mask(torch.from_numpy(ever),
                                     torch.from_numpy(h.reshape(4, 16, 96)))
    jmask = jsparsity.update_dead_mask(jnp.asarray(ever),
                                       jnp.asarray(h.reshape(4, 16, 96)))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert not mask[:5].numpy().any() or ever[:5].any()
    np.testing.assert_allclose(
        sparsity.dead_fraction(mask).numpy(),
        np.asarray(jsparsity.dead_fraction(jmask)), rtol=0,
        atol=2 * np.spacing(np.float32(1)))


@pytest.mark.parametrize("seed", SEEDS)
def test_targeted_reinit_matches_jax(seed):
    rng = np.random.RandomState(seed % 7)
    w = (0.02 * rng.randn(128, 512)).astype(np.float32)
    dead = rng.rand(512) < 0.3
    got = sparsity.targeted_reinit(prng.PRNGKey(seed), torch.from_numpy(w),
                                   torch.from_numpy(dead)).numpy()
    want = np.asarray(jax.jit(jsparsity.targeted_reinit)(
        jax.random.PRNGKey(seed), jnp.asarray(w), jnp.asarray(dead)))
    np.testing.assert_array_equal(got[:, ~dead], w[:, ~dead])
    assert (got[:, dead] != w[:, dead]).mean() > 0.99
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=4 * np.spacing(np.abs(w).max()))


def _cli(mod, tmp, *extra, arch="paper-0.5b", steps=2):
    args = ["--arch", arch, "--reduced", "--steps", str(steps), "--batch",
            "2", "--seq", "32", "--ckpt-dir", str(tmp), "--log-every",
            "100", *extra]
    return mod.main(args + (["--device", "cpu"] if mod is train_cli else []))


def _template(cfg):
    params = lm.trainable(lm.init(cfg, device="cpu"))
    return (params, adamw.init(params),
            torch.zeros((cfg.num_layers, cfg.d_ff), dtype=torch.bool))


def test_cli_dead_reinit_matches_jax(tmp_path):
    """Both trainers resume from one step-0 checkpoint (the CLI's reduced
    paper-0.5b, 3/4 of every layer's gate columns zeroed: dead, relu(x @ 0)
    never fires) and take steps 0-2 with ``--dead-reinit``. The losses
    agree (steps 1 and 2 after reinitializations), the dead columns were
    reinitialized on both sides, and the final W_g agree."""
    cfg = get_config("paper-0.5b").reduced(d_model=128, d_ff=512,
                                           num_layers=4)
    tree = _template(cfg)
    dead = torch.from_numpy(np.random.RandomState(0).rand(512) < 0.75)
    tree[0]["blocks"]["ffn"]["wg"][:, :, dead] = 0
    extra = {"data": SyntheticLM(cfg.vocab_size, 2, 32, seed=0).state(),
             "arch": cfg.name}
    for d in ("jax", "port"):
        CheckpointManager(str(tmp_path / d), async_save=False).save(
            0, tree, extra=extra)
    want = _cli(jtrain_cli, tmp_path / "jax", "--dead-reinit", steps=3)
    got = _cli(train_cli, tmp_path / "port", "--dead-reinit", steps=3)
    assert [h["step"] for h in got] == [h["step"] for h in want] == [0, 1, 2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        np.testing.assert_allclose(g["ce"], w["ce"], rtol=1e-4)
    finals = [CheckpointManager(str(tmp_path / d), async_save=False)
              .restore(3, _template(cfg))[0][0]["blocks"]["ffn"]["wg"]
              for d in ("jax", "port")]
    for w in finals:
        assert (w[:, :, dead] != 0).float().mean() > 0.99
    d = (finals[0] - finals[1]).abs()
    assert d.max() <= 2e-3 and (d > 1e-5).float().mean() <= 1e-4


def test_cli_dead_reinit_is_a_no_op_without_a_gate(tmp_path):
    """olmo-1b's FFN is not gated: there is no W_g to reinitialize, so the
    run equals the one without the flag."""
    a = _cli(train_cli, tmp_path / "a", arch="olmo-1b", steps=3)
    b = _cli(train_cli, tmp_path / "b", "--dead-reinit", arch="olmo-1b",
             steps=3)
    assert [h["loss"] for h in a] == [h["loss"] for h in b]


def test_cli_run_log_with_dead_reinit(tmp_path):
    """``--reduced --device cpu --dead-reinit --run-log``: the port's run
    log holds the JAX trainer's record kinds and field names (``torch_
    version`` in place of ``jax_version``) and its FLOPs accounting."""
    logs = {}
    for mod, name, extra in ((jtrain_cli, "jax", ()),
                             (train_cli, "port", ("--dead-reinit",))):
        path = tmp_path / f"{name}.jsonl"
        _cli(mod, tmp_path / name, *extra, "--run-log", str(path))
        logs[name] = [json.loads(line) for line in open(path)]
    kinds = [[r["kind"] for r in logs[n]] for n in ("jax", "port")]
    assert kinds[0] == kinds[1] == ["meta", "step", "step", "event"]
    for rj, rp in zip(logs["jax"], logs["port"]):
        keys = set(rj) - {"jax_version"} | ({"torch_version"}
                                             if "jax_version" in rj else set())
        assert set(rp) == keys, rj["kind"]
        if rj["kind"] == "step":
            assert len(rp["nnz_per_layer"]) == 4
            np.testing.assert_allclose(rp["model_dense_flops"],
                                       rj["model_dense_flops"], rtol=1e-12)
    assert logs["port"][-1]["event"] == "done"
    assert logs["port"][0]["torch_version"] == torch.__version__
