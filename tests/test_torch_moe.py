"""The port's MoE family (``repro_torch/models/moe.py``, the ``swa`` and
``local_chunk`` attention kinds, mixtral-8x22b and llama4-scout-17b-a16e)
against the JAX package on the same weights, at ``.reduced()`` scale in
float32 (4 experts, top 2 for mixtral and top 1 for llama4, window and
chunk 32): ``moe_apply_onehot``'s y and every aux entry under the dense,
gather and hybrid FFNs; the hybrid forward and every gradient against JAX
autodiff; ``_banded``; one train step; the static loop's greedy tokens
within the first window; teacher-forced decode against ``lm.forward`` past
the window and the chunk (where the port departs from JAX's decode, whose
ring and chunk caches are wrong there); the engine on a window-free
mixtral against ``repro.serving.ServingEngine``; the bridge's round trip
of the expert leaves.

Weights come from ``repro.models.lm.init`` through ``bridge.from_numpy``.
For the hybrid FFN all but ALIVE of each expert's 128 gate columns are
zeroed on both sides, so rows lie on both sides of the format (ELL width
32) without overflowing the backup.

Tolerances (float32, the frameworks sum in different orders): outputs,
logits and aux 2e-4 (rtol and atol), gradients 2e-4, as
tests/test_torch_train.py; train-step metrics 1e-5 relative and
parameters after the step 1e-5 absolute for all but 1 in 1e4 weights
(an Adam step of a near-zero gradient may turn); greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import training as jtraining
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_get_config
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.optim import adamw as jadamw
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge, training
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import layers, lm, moe
from repro_torch.optim import adamw
from repro_torch.serving import ServingEngine
from repro_torch.tree import leaves_with_path

TOL = dict(rtol=2e-4, atol=2e-4)
ALIVE = 48
ARCHS = ("mixtral-8x22b", "llama4-scout-17b-a16e")
IMPLS = ("dense", "gather", "hybrid")


def _cfgs(arch, ffn_impl="dense", **kw):
    """(JAX config, port config), reduced; C = 1 for gather (no tile
    overflows its slots at this width)."""
    out = []
    for base in (jax_get_config(arch), get_config(arch)):
        c = base.reduced(**kw)
        out.append(dataclasses.replace(c, sparsity=dataclasses.replace(
            c.sparsity, ffn_impl=ffn_impl, l1_coeff=1e-2,
            twell_c=1 if ffn_impl == "gather" else c.sparsity.twell_c)))
    return out


_WEIGHTS = {}


def _weights(arch, **kw):
    """(JAX params, the port's, numpy tree) of the reduced ``arch`` with
    ALIVE gate columns per expert."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _WEIGHTS:
        jcfg, _ = _cfgs(arch, **kw)
        tree = jax.tree_util.tree_map(np.array, jax.jit(
            lambda k: jlm.init(k, jcfg))(jax.random.PRNGKey(0)))
        rng = np.random.RandomState(0)
        for layer in tree["blocks"]["moe"]["experts"]["wg"]:
            for expert in layer:
                expert[:, rng.permutation(expert.shape[1])[ALIVE:]] = 0
        _WEIGHTS[key] = (jax.tree_util.tree_map(jnp.asarray, tree),
                         bridge.from_numpy(tree), tree)
    return _WEIGHTS[key]


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_onehot_matches_jax(arch, impl):
    """Layer 0's MoE block on 24 tokens: y and every aux entry."""
    jcfg, cfg = _cfgs(arch, impl)
    jparams, tparams, _ = _weights(arch)
    x = np.random.RandomState(1).randn(2, 12, cfg.d_model).astype(
        np.float32)
    jy, jaux = jax.jit(lambda p, xx: jmoe.moe_apply_onehot(
        p, xx, jcfg, jcfg.sparsity, jcfg.gated))(
            _layer0(jparams["blocks"]["moe"]), jnp.asarray(x))
    ops.HybridOverflowLog.reset()
    y, aux = moe.moe_apply_onehot(_layer0(tparams["blocks"]["moe"]),
                                  torch.from_numpy(x), cfg, cfg.sparsity,
                                  cfg.gated)
    assert not ops.HybridOverflowLog.seen()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    assert set(aux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(np.asarray(aux[k].detach()),
                                   np.asarray(jaux[k]), **TOL, err_msg=k)
    assert float(aux["moe_balance"]) > 0
    # the probe the serving engine asks for, and nothing
    _, probe = moe.moe_apply_onehot(_layer0(tparams["blocks"]["moe"]),
                                    torch.from_numpy(x), cfg, cfg.sparsity,
                                    cfg.gated, collect_aux="probe")
    assert set(probe) == {"nnz_mean", "tile_frac"}
    np.testing.assert_allclose(float(probe["nnz_mean"]),
                               float(jaux["nnz_mean"]), rtol=1e-5)
    assert moe.moe_apply(_layer0(tparams["blocks"]["moe"]),
                         torch.from_numpy(x), cfg, cfg.sparsity, cfg.gated,
                         collect_aux=False)[1] is None


def _jflat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _batch(vocab, b=2, s=64, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("arch", ARCHS)
def test_hybrid_forward_and_gradients_match_jax(arch):
    """``lm.loss_fn`` over 2 x 64 tokens (two windows, two chunks: the
    banded attention) under the hybrid FFN: metrics, the stacked aux and
    every parameter's gradient (router and experts included) against
    ``jax.value_and_grad``."""
    jcfg, cfg = _cfgs(arch, "hybrid")
    jparams, _, tree = _weights(arch)
    nb = _batch(cfg.vocab_size)
    (jloss, (jmetrics, jaux)), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, b, jcfg), has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in nb.items()})
    params = lm.trainable(bridge.from_numpy(tree))
    live = jax.tree_util.tree_map(lambda t: t.requires_grad_(True), params)
    ops.HybridOverflowLog.reset()
    loss, (metrics, aux) = lm.loss_fn(
        live, {k: torch.from_numpy(v) for k, v in nb.items()}, cfg)
    names = [p for p, _ in leaves_with_path(live)]
    grads = torch.autograd.grad(loss, [t for _, t in leaves_with_path(live)])
    ew = cfg.sparsity.ell_width
    assert (aux["nnz_max"] > ew).any() and (aux["nnz_mean"] < ew).all()
    assert not ops.HybridOverflowLog.seen()
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(jmetrics[k]), rtol=1e-5, err_msg=k)
    assert set(aux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(np.asarray(aux[k].detach()),
                                   np.asarray(jaux[k]), **TOL, err_msg=k)
    jg = _jflat(jgrads)
    assert sorted(names) == sorted(jg)
    assert "blocks/moe/router" in jg
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), jg[name], **TOL, err_msg=name)


@pytest.mark.parametrize("kind", ["swa", "local_chunk"])
def test_banded_matches_jax(kind):
    """``_banded`` on 3 chunks of 16 keys, 4 heads of 8, with the window
    mask (swa: lookback 1) and without (local_chunk: lookback 0)."""
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(2, 48, 4, 8).astype(np.float32) for _ in range(3))
    kw = dict(band_chunk=16, lookback=1, window=16) if kind == "swa" else \
        dict(band_chunk=16, lookback=0)
    want = jax.jit(lambda *a: jlayers._banded(*a, 0.35, **kw))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = layers._banded(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), 0.35, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="multiple"):
        layers._banded(*(torch.from_numpy(a[:, :40]) for a in (q, k, v)),
                       0.35, **kw)


def _close_params(got, want, lr):
    """All but 1 in 1e4 weights within 1e-5; those within 2 * lr."""
    for name, a in got.items():
        d = np.abs(a - want[name])
        assert d.max() <= 2 * lr + 1e-6, name
        assert (d > 1e-5).mean() <= 1e-4, (name, (d > 1e-5).sum())


def test_train_step_matches_jax():
    """One ``make_train_step`` step of reduced mixtral with the hybrid FFN
    (bf16 AdamW moments, as the config keeps them): metrics and every
    parameter against ``repro.training``'s."""
    arch = "mixtral-8x22b"
    jcfg, cfg = _cfgs(arch, "hybrid")
    jparams, _, tree = _weights(arch)
    kw = dict(learning_rate=1e-3, total_steps=10, warmup_steps=2)
    jstep = jax.jit(jtraining.make_train_step(jcfg, JTrainConfig(**kw)))
    step = training.make_train_step(cfg, TrainConfig(**kw))
    jopt = jadamw.init(jparams, jnp.dtype(jcfg.opt_state_dtype))
    params = lm.trainable(bridge.from_numpy(tree))
    opt = adamw.init(params, torch.bfloat16)
    nb = _batch(cfg.vocab_size, b=2, s=32, seed=3)
    jparams, jopt, jm = jstep(jparams, jopt,
                              {k: jnp.asarray(v) for k, v in nb.items()})
    params, opt, m = step(params, opt,
                          {k: torch.from_numpy(v) for k, v in nb.items()})
    assert set(m) == set(jm) and "moe_balance" in m
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _close_params({p: np.asarray(v.detach()) for p, v in
                   leaves_with_path(params)}, _jflat(jparams), 1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_static_loop_greedy_tokens_match_jax_within_the_window(arch):
    """``launch/serve.py:generate`` on 3 prompts of 12 tokens and 12 new
    ones (24 of the window's and the chunk's 32 positions, where JAX's
    decode is right) under the gather FFN: the same greedy tokens."""
    jcfg, cfg = _cfgs(arch, "gather")
    jparams, tparams, _ = _weights(arch)
    prompt = np.random.RandomState(4).randint(0, cfg.vocab_size, (3, 12))
    want = jserve.generate(jparams, jcfg, jnp.asarray(prompt, jnp.int32),
                           12, cache_len=25)
    got = serve.generate(tparams, cfg, torch.from_numpy(prompt), 12, 25)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _decode_logits(step, params, cache, toks):
    out = []
    for i in range(toks.shape[1]):
        lg, cache = step(params, cache, toks[:, i:i + 1])
        out.append(np.asarray(lg)[:, 0])
    return np.stack(out, axis=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_follows_the_forward_past_the_window(arch):
    """Teacher-forced ``decode_step`` over 80 tokens (2.5 windows or
    chunks of 32; the cache sized for all of them, so the ring wraps and
    the chunk restarts twice) against JAX ``lm.forward`` on the same
    tokens at every position. JAX's own decode matches its forward only
    within the first window: the reference's ring mask and chunk cache
    (``repro/models/layers.py:343,351``, ``lm.py:419-420``) are where the
    port departs."""
    jcfg, cfg = _cfgs(arch, "gather")
    jparams, tparams, _ = _weights(arch)
    toks = np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 96))
    fwd, _ = jax.jit(lambda p, t: jlm.forward(p, {"tokens": t}, jcfg))(
        jparams, jnp.asarray(toks, jnp.int32))
    fwd = np.asarray(fwd)[:, :80]
    toks = toks[:, :80]
    with torch.no_grad():
        got = _decode_logits(
            lambda p, c, t: lm.decode_step(p, c, torch.from_numpy(t), cfg),
            tparams, lm.init_cache(cfg, 2, 80, device="cpu"), toks)
    assert lm.init_cache(cfg, 2, 80, device="cpu")["k"].shape[2] == 32
    np.testing.assert_allclose(got, fwd, **TOL)
    jdec = jax.jit(lambda p, c, t: jlm.decode_step(p, c, t, jcfg))
    theirs = _decode_logits(jdec, jparams, jlm.init_cache(jcfg, 2, 80),
                            jnp.asarray(toks, jnp.int32))
    err = np.abs(theirs - fwd).max(axis=(0, 2))
    assert err[:32].max() < 2e-4 and err[32:].min() > 1e-2, err


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_refuses_a_cache_shorter_than_the_window(arch):
    """A cache of 16 slots for a window or chunk of 32 holds 16 tokens;
    the 17th raises "cache full" (its ring slot would overwrite a key still
    inside the window) instead of decoding wrong logits."""
    _, cfg = _cfgs(arch)
    _, tparams, _ = _weights(arch)
    cache = lm.init_cache(cfg, 1, 16, device="cpu")
    assert cache["k"].shape[2] == 16
    tok = torch.zeros((1, 1), dtype=torch.int64)
    with torch.no_grad():
        for _ in range(16):
            _, cache = lm.decode_step(tparams, cache, tok, cfg)
        with pytest.raises(ValueError, match="cache full"):
            lm.decode_step(tparams, cache, tok, cfg)


def test_engine_on_window_free_mixtral_matches_jax_engine():
    """The port's ServingEngine on reduced mixtral without its window (the
    paged engine takes the MoE family, as JAX's does) against
    ``repro.serving.ServingEngine``: the same greedy tokens and per-step
    logits, gather FFN, chunked prefill and a shared prefix."""
    jcfg, cfg = _cfgs("mixtral-8x22b", "gather", window=0)
    jparams, tparams, _ = _weights("mixtral-8x22b", window=0)
    kw = dict(backend="gather", max_batch=3, max_seq_len=40, block_size=4,
              prefill_chunk=8, record_logits=True)
    prompts = [list(range(3, 12)), list(range(3, 8)) + [40, 41],
               [7, 9, 11, 200]]
    want = JaxEngine(jparams, jcfg, **kw).generate(prompts, max_tokens=6)
    eng = ServingEngine(tparams, cfg, device="cpu", **kw)
    outs = eng.generate(prompts, max_tokens=6)
    assert [o.token_ids for o in outs] == [o.token_ids for o in want]
    for o, w in zip(outs, want):
        for got, ref in zip(o.logits, w.logits):
            np.testing.assert_allclose(got, ref, **TOL)
    assert eng.kv.num_available == eng.kv.num_blocks - 1
    with pytest.raises(NotImplementedError, match="windowed"):
        ServingEngine(tparams, _cfgs("mixtral-8x22b")[1], device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_the_expert_leaves(dtype):
    """The stacked (L, E, ...) expert leaves and the (L, D, E) router go
    through ``bridge.from_numpy`` / ``to_numpy`` bit for bit; ``wu_t`` is
    derived for every expert and dropped again."""
    jcfg, _ = _cfgs("llama4-scout-17b-a16e", dtype=dtype, param_dtype=dtype)
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jlm.init(k, jcfg))(jax.random.PRNGKey(1)))
    params = bridge.from_numpy(tree)
    experts = params["blocks"]["moe"]["experts"]
    assert experts["wg"].shape == (2, 4, jcfg.d_model, jcfg.d_ff)
    assert params["blocks"]["moe"]["router"].shape == (2, jcfg.d_model, 4)
    assert torch.equal(experts["wu_t"], experts["wu"].transpose(-1, -2))
    back = bridge.to_numpy(params)
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_j, flat_b):
        np.testing.assert_array_equal(b, np.asarray(a, np.float32),
                                      err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_jax_packages(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(get_config(arch).reduced()) == \
        dataclasses.asdict(jax_get_config(arch).reduced())
