"""The remaining dense configs in the port -- phi3-mini-3.8b (head dim 96,
an untied head over a padded vocabulary), deepseek-67b (64 query heads over
8 KV heads, bf16 AdamW moments) and llama3-405b (128 over 8, bf16 moments)
-- against the JAX package on the same weights, at ``.reduced()`` scale
keeping each config's trait: phi3 ``head_dim=24`` (rope over a half of 12,
not a power of two, as 96's half is 48) and a vocabulary of 250 padded to
256; deepseek ``num_heads=8, num_kv_heads=1`` (8 query heads a KV head);
llama3 ``num_heads=16, num_kv_heads=1`` (16, the decode kernel's widest
group). Each config equals JAX's field for field; ``lm.forward``'s logits
and aux statistics (dense and gather FFNs), ``loss_fn`` and every gradient
and one train step under the hybrid FFN with the config's moment dtype
match JAX; the engine's greedy tokens and logits under ``gather`` equal
``repro.serving.ServingEngine``'s; rope at head dim 96 and the paged pools
at the full configs' KV heads; the bridge's round trip.

Weights come from ``repro.models.lm.init`` through ``bridge.from_numpy``.
For the hybrid FFN all but ALIVE of each layer's 128 gate columns are
zeroed on both sides, so rows lie on both sides of the format (ELL width
32) without overflowing the backup; the gather cases take ``twell_c = 1``
(a slot for every column), as tests/test_torch_engine.py does.

Tolerances (float32, the frameworks sum in different orders): logits, aux
and gradients 2e-4 (rtol and atol), as tests/test_torch_train.py; metrics
1e-5 relative; parameters after the step 1e-5 absolute for all but 1 in
1e4 weights, those within 2 lr (an Adam step of a near-zero gradient may
turn), as tests/test_torch_moe.py; greedy tokens equal.
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
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge, training
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import layers, lm
from repro_torch.optim import adamw
from repro_torch.serving import ServingEngine
from repro_torch.tree import leaves_with_path

TOL = dict(rtol=2e-4, atol=2e-4)
ALIVE = 52
# arch -> the reduced config's overrides that keep its trait
TRAITS = {"phi3-mini-3.8b": dict(head_dim=24, vocab_size=250),
          "deepseek-67b": dict(num_heads=8, num_kv_heads=1),
          "llama3-405b": dict(num_heads=16, num_kv_heads=1)}
ARCHS = tuple(TRAITS)


def _cfgs(arch, ffn_impl="dense"):
    """(JAX config, port config), reduced with the arch's trait; C = 1 for
    gather."""
    out = []
    for base in (jax_get_config(arch), get_config(arch)):
        c = base.reduced(**TRAITS[arch])
        out.append(dataclasses.replace(c, sparsity=dataclasses.replace(
            c.sparsity, ffn_impl=ffn_impl, l1_coeff=1e-2,
            twell_c=1 if ffn_impl == "gather" else c.sparsity.twell_c)))
    return out


_WEIGHTS = {}


def _weights(arch):
    """(JAX params, the port's, numpy tree) of the reduced ``arch`` with
    ALIVE gate columns a layer."""
    if arch not in _WEIGHTS:
        jcfg, _ = _cfgs(arch)
        tree = jax.tree_util.tree_map(np.array, jax.jit(
            lambda k: jlm.init(k, jcfg))(jax.random.PRNGKey(0)))
        rng = np.random.RandomState(0)
        for w in tree["blocks"]["ffn"]["wg"]:
            w[:, rng.permutation(w.shape[1])[ALIVE:]] = 0
        _WEIGHTS[arch] = (jax.tree_util.tree_map(jnp.asarray, tree),
                          bridge.from_numpy(tree), tree)
    return _WEIGHTS[arch]


def _jflat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _batch(vocab, b=2, s=32, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_jax_packages(arch):
    """Field for field, full and reduced (plain and with the trait); the
    traits the reduced configs keep."""
    for kw in ({}, TRAITS[arch]):
        assert dataclasses.asdict(get_config(arch).reduced(**kw)) == \
            dataclasses.asdict(jax_get_config(arch).reduced(**kw))
    full = get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jax_get_config(arch))
    assert full.family == "dense" and full.gated and not full.window
    _, cfg = _cfgs(arch)
    if arch == "phi3-mini-3.8b":
        assert (full.resolved_head_dim, full.padded_vocab) == (96, 32128)
        assert not full.tied_embeddings and cfg.padded_vocab == 256
    else:
        group = {"deepseek-67b": 8, "llama3-405b": 16}[arch]
        assert full.num_heads // full.num_kv_heads == group
        assert cfg.num_heads // cfg.num_kv_heads == group
        assert full.opt_state_dtype == cfg.opt_state_dtype == "bfloat16"


@pytest.mark.parametrize("impl", ["dense", "gather"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_jax(arch, impl):
    """``lm.forward`` over 2 x 24 tokens: the logits over the padded
    vocabulary and every aux statistic."""
    jcfg, cfg = _cfgs(arch, impl)
    jparams, tparams, _ = _weights(arch)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 24))
    jl, jaux = jax.jit(lambda p, t: jlm.forward(p, {"tokens": t}, jcfg))(
        jparams, jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        tl, aux = lm.forward(tparams, {"tokens": torch.from_numpy(toks)},
                             cfg)
    assert tl.shape == (2, 24, cfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert set(aux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(np.asarray(aux[k]), np.asarray(jaux[k]),
                                   **TOL, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_hybrid_gradients_match_jax(arch):
    """``lm.loss_fn`` over 2 x 32 tokens under the hybrid FFN: metrics, the
    stacked aux and every parameter's gradient against
    ``jax.value_and_grad``; rows on both sides of the format."""
    jcfg, cfg = _cfgs(arch, "hybrid")
    jparams, _, tree = _weights(arch)
    nb = _batch(cfg.vocab_size)
    (_, (jmetrics, jaux)), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, b, jcfg), has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in nb.items()})
    live = jax.tree_util.tree_map(lambda t: t.requires_grad_(True),
                                  lm.trainable(bridge.from_numpy(tree)))
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
    for k in jaux:
        np.testing.assert_allclose(np.asarray(aux[k].detach()),
                                   np.asarray(jaux[k]), **TOL, err_msg=k)
    jg = _jflat(jgrads)
    assert sorted(names) == sorted(jg)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), jg[name], **TOL, err_msg=name)


def _close_params(got, want, lr):
    """All but 1 in 1e4 weights within 1e-5; those within 2 * lr."""
    for name, a in got.items():
        d = np.abs(a - want[name])
        assert d.max() <= 2 * lr + 1e-6, name
        assert (d > 1e-5).mean() <= 1e-4, (name, (d > 1e-5).sum())


@pytest.mark.parametrize("arch", ARCHS)
def test_hybrid_train_step_matches_jax(arch):
    """One ``make_train_step`` step with the hybrid FFN and the config's
    AdamW moment dtype (bf16 for deepseek and llama3, f32 for phi3):
    metrics, every parameter and both moments against
    ``repro.training``'s."""
    jcfg, cfg = _cfgs(arch, "hybrid")
    jparams, _, tree = _weights(arch)
    kw = dict(learning_rate=1e-3, total_steps=10, warmup_steps=2)
    jstep = jax.jit(jtraining.make_train_step(jcfg, JTrainConfig(**kw)))
    step = training.make_train_step(cfg, TrainConfig(**kw))
    moments = getattr(torch, cfg.opt_state_dtype)
    jopt = jadamw.init(jparams, jnp.dtype(jcfg.opt_state_dtype))
    params = lm.trainable(bridge.from_numpy(tree))
    opt = adamw.init(params, moments)
    nb = _batch(cfg.vocab_size, s=32, seed=3)
    jparams, jopt, jm = jstep(jparams, jopt,
                              {k: jnp.asarray(v) for k, v in nb.items()})
    params, opt, m = step(params, opt,
                          {k: torch.from_numpy(v) for k, v in nb.items()})
    assert set(m) == set(jm)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _close_params({p: np.asarray(v.detach()) for p, v in
                   leaves_with_path(params)}, _jflat(jparams), 1e-3)
    # the first moment, 0.1 g after one step: the gradients' 2e-4 as 2e-5,
    # and one rounding of the moment's dtype (bf16: 2^-8 relative)
    mom = dict(leaves_with_path(opt.m))
    assert all(t.dtype == moments for t in mom.values())
    jmom = _jflat(jopt.m)
    for name, t in mom.items():
        np.testing.assert_allclose(t.float().numpy(),
                                   jmom[name].astype(np.float32),
                                   rtol=1e-2, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_match_jax_engine(arch):
    """The port's ServingEngine against ``repro.serving.ServingEngine``
    under ``gather``: the same greedy tokens and per-step logits, chunked
    prefill, two prompts sharing a prefix, and a clean pool."""
    jcfg, cfg = _cfgs(arch, "gather")
    jparams, tparams, _ = _weights(arch)
    kw = dict(backend="gather", max_batch=3, max_seq_len=40, block_size=4,
              prefill_chunk=8, record_logits=True)
    prompts = [list(range(3, 14)), list(range(3, 9)) + [40, 41],
               [7, 9, 11, 200]]
    want = JaxEngine(jparams, jcfg, **kw).generate(prompts, max_tokens=6)
    eng = ServingEngine(tparams, cfg, device="cpu", **kw)
    outs = eng.generate(prompts, max_tokens=6)
    assert [o.token_ids for o in outs] == [o.token_ids for o in want]
    for o, w in zip(outs, want):
        for got, ref in zip(o.logits, w.logits):
            np.testing.assert_allclose(got, ref, **TOL)
    assert eng.kv.num_available == eng.kv.num_blocks - 1


def test_rope_at_head_dim_96_matches_jax():
    """Rope at phi3-mini's head dim 96 (a half of 48) and theta, and at
    llama3-405b's theta over positions past 8192."""
    rng = np.random.RandomState(2)
    for hd, theta, pos in ((96, 1e4, np.arange(40)),
                           (128, 5e5, 8190 + np.arange(6))):
        x = rng.randn(2, pos.size, 3, hd).astype(np.float32)
        p = np.broadcast_to(pos, (2, pos.size)).astype(np.int32)
        want = jlayers.rope(jnp.asarray(x), jnp.asarray(p), theta)
        got = layers.rope(torch.from_numpy(x), torch.from_numpy(p.copy()),
                          theta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_pools_at_the_full_configs_kv_heads(arch):
    """The engine's KV pools at the full configs' KV heads and head dims
    (one layer, two blocks of 16): the JAX package's shapes, bf16."""
    full = dataclasses.replace(get_config(arch), num_layers=1)
    jfull = dataclasses.replace(jax_get_config(arch), num_layers=1)
    pools = lm.init_paged_cache(full, 2, 16, device="cpu")
    jpools = jlm.init_paged_cache(jfull, 2, 16)
    want = {"phi3-mini-3.8b": (32, 96), "deepseek-67b": (8, 128),
            "llama3-405b": (8, 128)}[arch]
    for k, v in jpools.items():
        assert tuple(pools[k].shape) == tuple(v.shape) == (1, 2, 16, *want)
        assert pools[k].dtype == torch.bfloat16


def test_bridge_round_trips_llama3():
    """llama3-405b's reduced leaves (GQA 16/1, untied head) through
    ``bridge.from_numpy`` / ``to_numpy`` bit for bit, in bf16; ``wu_t`` is
    derived and dropped again."""
    jcfg, _ = _cfgs("llama3-405b")
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16",
                               param_dtype="bfloat16")
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jlm.init(k, jcfg))(jax.random.PRNGKey(1)))
    params = bridge.from_numpy(tree)
    ffn = params["blocks"]["ffn"]
    assert torch.equal(ffn["wu_t"], ffn["wu"].transpose(-1, -2))
    assert "lm_head" in params and params["embed"].dtype == torch.bfloat16
    back = bridge.to_numpy(params)
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_j, flat_b):
        np.testing.assert_array_equal(b, np.asarray(a, np.float32),
                                      err_msg=str(path))
