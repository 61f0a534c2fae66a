"""The port's training path against the JAX package on the same weights
and batches: ``lm.loss_fn`` (metrics and every parameter gradient) for the
dense and hybrid FFN, three ``make_train_step`` steps (parameters and
metrics; one case microbatched), AdamW, its schedule and clipping, the
synthetic data stream, a JAX-written checkpoint resumed by the port's
trainer, and the port's train CLI (loss falls, resume is deterministic).

Weights come from ``repro.models.lm.init`` through ``bridge.from_numpy``;
all but ALIVE of each layer's 128 gate columns are zeroed on both sides,
so most rows of the hybrid format fit its ELL width (32) and a few go to
the dense backup, without overflowing it (the paper's regime).

Tolerances (float32): loss and metrics 1e-5 relative; gradients 2e-4
(rtol and atol), as tests/test_kernels.py -- the frameworks sum in
different orders; parameters after three AdamW steps 1e-5 absolute: an
Adam step moves a weight by about lr * g / |g|, so a gradient entry near
zero can turn the step of one weight by up to 2 * lr (1e-3 here) and the
test allows that for 1 in 1e4 weights, no more.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import training as jtraining
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch import train as jtrain_cli
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch import training
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.data.pipeline import MemmapTokens, SyntheticLM, make_iterator
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.tree import leaves_with_path

GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
ALIVE = 48


def _cfgs(ffn_impl):
    out = []
    for base in (jax_get_config("paper-0.5b"), get_config("paper-0.5b")):
        c = base.reduced()
        out.append(dataclasses.replace(c, sparsity=dataclasses.replace(
            c.sparsity, ffn_impl=ffn_impl, l1_coeff=1e-2)))
    return out


@pytest.fixture(scope="module")
def weights():
    """(JAX params, numpy tree) with ALIVE gate columns per layer."""
    jcfg, _ = _cfgs("dense")
    tree = jax.tree_util.tree_map(np.array,
                                  jlm.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(0)
    wg = tree["blocks"]["ffn"]["wg"]
    for layer in wg:
        layer[:, rng.permutation(layer.shape[1])[ALIVE:]] = 0
    return jax.tree_util.tree_map(jnp.asarray, tree), tree


def _batch(cfg, b=2, s=32, step=0):
    return JSyntheticLM(cfg.vocab_size, b, s, seed=0, step=step).__next__()


def _tbatch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


def _flat(tree):
    return {p: np.asarray(v) for p, v in leaves_with_path(tree)}


def _jflat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("impl", ["dense", "hybrid"])
def test_loss_and_gradients_match_jax(weights, impl):
    jparams, tree = weights
    jcfg, cfg = _cfgs(impl)
    nb = _batch(jcfg)
    (jloss, (jmetrics, jaux)), jgrads = jax.value_and_grad(
        jlm.loss_fn, has_aux=True)(jparams, {k: jnp.asarray(v) for k, v in
                                             nb.items()}, jcfg)
    params = lm.trainable(bridge.from_numpy(tree))
    live = jax.tree_util.tree_map(lambda t: t.requires_grad_(True), params)
    ops.HybridOverflowLog.reset()
    loss, (metrics, aux) = lm.loss_fn(live, _tbatch(nb), cfg)
    names = [p for p, _ in leaves_with_path(live)]
    grads = torch.autograd.grad(loss, [t for _, t in leaves_with_path(live)])
    if impl == "hybrid":      # both sides of the format hold rows
        ew = jcfg.sparsity.ell_width
        assert (aux["nnz_max"] > ew).any() and (aux["nnz_mean"] < ew).all()
        assert not ops.HybridOverflowLog.seen()
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(jmetrics[k]), rtol=1e-5, err_msg=k)
    for k in ("l1", "nnz_mean", "nnz_max", "neuron_active", "tile_frac",
              "ffn_present", "moe_balance"):
        np.testing.assert_allclose(np.asarray(aux[k].detach()),
                                   np.asarray(jaux[k]), rtol=1e-5,
                                   err_msg=k)
    jg = _jflat(jgrads)
    assert sorted(names) == sorted(jg)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), jg[name], **GRAD_TOL,
                                   err_msg=name)


def _close_params(got, want, lr):
    """All but 1 in 1e4 weights within 1e-5; those within 2 * lr."""
    for name, a in got.items():
        b = want[name]
        d = np.abs(a - b)
        assert d.max() <= 2 * lr + 1e-6, name
        assert (d > 1e-5).mean() <= 1e-4, (name, (d > 1e-5).sum())


@pytest.mark.parametrize("impl,microbatch", [("dense", 0), ("hybrid", 0),
                                             ("hybrid", 2)])
def test_three_train_steps_match_jax(weights, impl, microbatch):
    jparams, tree = weights
    jcfg, cfg = _cfgs(impl)
    kw = dict(learning_rate=1e-3, total_steps=10, warmup_steps=2,
              microbatch=microbatch)
    jstep = jax.jit(jtraining.make_train_step(jcfg, JTrainConfig(**kw)))
    step = training.make_train_step(cfg, TrainConfig(**kw))
    jopt = jadamw.init(jparams)
    params = lm.trainable(bridge.from_numpy(tree))
    opt = adamw.init(params)
    for i in range(3):
        nb = _batch(jcfg, b=4, step=i)
        jparams, jopt, jm = jstep(jparams, jopt,
                                  {k: jnp.asarray(v) for k, v in nb.items()})
        params, opt, m = step(params, opt, _tbatch(nb))
        assert set(m) == set(jm)
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {i} {k}")
    assert int(opt.step) == int(jopt.step) == 3
    _close_params(_flat(params), _jflat(jparams), 1e-3)
    _close_params(_flat(opt.m), _jflat(jopt.m), 1e-3)


def test_adamw_schedule_and_clipping_match_jax():
    rng = np.random.RandomState(3)
    tree = {"a": rng.randn(5, 3).astype(np.float32),
            "b": {"c": rng.randn(7).astype(np.float32)}}
    grads = {"a": rng.randn(5, 3).astype(np.float32) * 3,
             "b": {"c": rng.randn(7).astype(np.float32)}}
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    jg = jax.tree_util.tree_map(jnp.asarray, grads)
    tt = jax.tree_util.tree_map(torch.from_numpy, tree)
    tg = jax.tree_util.tree_map(torch.from_numpy, grads)
    np.testing.assert_allclose(float(adamw.global_norm(tg)),
                               float(jadamw.global_norm(jg)), rtol=1e-6)
    cg, gn = adamw.clip_by_global_norm(tg, 1.0)
    jcg, jgn = jadamw.clip_by_global_norm(jg, 1.0)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
    for s in (0, 3, 10, 55, 100):
        np.testing.assert_allclose(
            float(adamw.cosine_schedule(torch.tensor(s), 1e-3, 10, 100)),
            float(jadamw.cosine_schedule(jnp.int32(s), 1e-3, 10, 100)),
            rtol=1e-6)
    st, jst = adamw.init(tt), jadamw.init(jt)
    for _ in range(3):
        tt, st = adamw.update(tt, cg, st, lr=1e-2)
        jt, jst = jadamw.update(jt, jcg, jst, lr=1e-2)
    for name, a in _flat(tt).items():
        np.testing.assert_allclose(a, _jflat(jt)[name], rtol=1e-6, atol=1e-7)
    back = bridge.opt_state_from_numpy(
        jax.tree_util.tree_map(np.array, tuple(jst)))
    assert int(back.step) == 3
    for name, a in _flat(back.m).items():
        np.testing.assert_allclose(a, _flat(st.m)[name], rtol=1e-6)
    step_np, m_np, _ = bridge.opt_state_to_numpy(back)
    assert int(step_np) == 3 and set(m_np) == {"a", "b"}


@pytest.mark.parametrize("step", [0, 5])
def test_synthetic_batches_bit_identical(step):
    want = JSyntheticLM(256, 3, 40, seed=7, step=step).__next__()
    got = SyntheticLM(256, 3, 40, seed=7, step=step).__next__()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    it = make_iterator(SyntheticLM(256, 3, 40, seed=7).state())
    assert isinstance(it, SyntheticLM)


def test_memmap_tokens_resume(tmp_path):
    from repro_torch.data.pipeline import write_token_file
    path = str(tmp_path / "toks.bin")
    write_token_file(path, np.arange(10_000) % 251)
    it = MemmapTokens(path, batch=4, seq=32)
    b = next(it)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    st = it.state()
    np.testing.assert_array_equal(next(it)["tokens"],
                                  next(make_iterator(st))["tokens"])


def _cli(mod, tmp, *extra, steps=6):
    args = ["--arch", "paper-0.5b", "--reduced", "--steps", str(steps),
            "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp),
            "--log-every", "100", *extra]
    return mod.main(args + (["--device", "cpu"] if mod is train_cli else []))


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX trainer checkpoints at step 3 (--halt-at); the port's trainer
    resumes from that directory and takes steps 3-5. Its losses equal the
    JAX trainer's uninterrupted run's (same weights, optimizer state and
    data position)."""
    full = _cli(jtrain_cli, tmp_path / "full")
    _cli(jtrain_cli, tmp_path / "x", "--halt-at", "3", "--ckpt-every", "3")
    mgr = CheckpointManager(str(tmp_path / "x"), async_save=False)
    assert mgr.latest_step() == 3
    with open(tmp_path / "x" / "step_3" / "manifest.json") as f:
        assert json.load(f)["names"][0] == "0/blocks/attn/wk"
    rest = _cli(train_cli, tmp_path / "x")
    assert [h["step"] for h in rest] == [3, 4, 5]
    for got, want in zip(rest, full[3:]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["ce"], want["ce"], rtol=1e-4)


def test_checkpoint_round_trip_keeps_bf16_bits(tmp_path):
    """The port writes the JAX layout (a bf16 leaf as its V2 bit pattern)
    and reads it back exactly; rotation keeps the newest two."""
    tree = ({"w": torch.randn(3, 4).bfloat16(), "b": torch.arange(5.0)},
            adamw.init({"w": torch.zeros(2)}))
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for s in (1, 2, 3):
        mgr.save(s, tree, extra={"s": s})
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    back, extra = mgr.restore(3, tree)
    assert extra == {"s": 3}
    assert back[0]["w"].dtype == torch.bfloat16
    assert torch.equal(back[0]["w"], tree[0]["w"])
    assert torch.equal(back[0]["b"], tree[0]["b"])
    assert isinstance(back[1], adamw.AdamWState)
    z = np.load(tmp_path / "step_3" / "arrays.npz")
    assert z["1"].dtype.str == "|V2"           # leaf order: b, w, step, m, v


def test_cli_loss_decreases(tmp_path):
    hist = _cli(train_cli, tmp_path / "ck", steps=25)
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.5


def test_cli_resume_is_deterministic(tmp_path):
    """20 steps straight vs 10 + halt + resume 10: identical metrics."""
    a = _cli(train_cli, tmp_path / "a", steps=20)
    _cli(train_cli, tmp_path / "b", "--halt-at", "10", "--ckpt-every", "10",
         steps=20)
    b2 = _cli(train_cli, tmp_path / "b", steps=20)
    assert b2[0]["step"] == 10
    np.testing.assert_allclose(a[-1]["loss"], b2[-1]["loss"], rtol=1e-6)
    np.testing.assert_allclose(a[-1]["ce"], b2[-1]["ce"], rtol=1e-6)


def test_cli_hybrid_runs_and_needs_a_card_by_default(tmp_path, monkeypatch):
    hist = _cli(train_cli, tmp_path / "h", "--ffn-impl", "hybrid", steps=3)
    assert all(np.isfinite(h["loss"]) for h in hist)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--reduced", "--steps", "1", "--ckpt-dir",
                        str(tmp_path / "none")])
