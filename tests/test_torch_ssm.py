"""The port's attention-free families (``repro_torch/models/mamba2.py`` and
``rwkv6.py``; zamba2-1.2b, family ``hybrid``, and rwkv6-7b, family
``ssm``) against the JAX package on the same weights, at ``.reduced()``
scale in float32: ``mamba2_apply`` (one chunk and two, with padding) and
its gradients, ``mamba2_decode`` with its caches, ``timemix_apply`` on the
per-token and the chunked WKV and its gradients, ``channelmix_apply``
under the dense and gather FFNs, ``lm.loss_fn`` with every aux entry and
every gradient under the dense and hybrid FFNs, one train step,
teacher-forced ``decode_step`` against JAX's and against the port's own
``forward``, the static loop's greedy tokens, the bridge's round trip, the
parameter and cache dtypes, and the paged engine's refusal.

Weights come from ``repro.models.lm.init`` through ``bridge.from_numpy``,
with all but ALIVE of the FFN's pattern columns zeroed (rwkv6's channel
mix W_u, zamba2's shared block's W_g), so the hybrid FFN puts rows on both
sides of the format (ELL width 32) without overflowing the backup; the
gather cases take ``twell_c = 1`` (a slot for every column), as
tests/test_torch_moe.py does.

Tolerances (float32, the frameworks sum in different orders): modules
1e-4 (rtol and atol), logits, aux and gradients 2e-4, as
tests/test_torch_train.py; train-step metrics 1e-5 relative and parameters
after the step 1e-5 absolute for all but 1 in 1e4 weights (an Adam step of
a near-zero gradient may turn); greedy tokens equal.
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
from repro.models import lm as jlm
from repro.models import mamba2 as jmamba2
from repro.models import rwkv6 as jrwkv6
from repro.optim import adamw as jadamw
from repro_torch import bridge, training
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import lm, mamba2, rwkv6
from repro_torch.optim import adamw
from repro_torch.serving import ServingEngine
from repro_torch.tree import leaves_with_path

MOD_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=2e-4, atol=2e-4)
ALIVE = 52
ARCHS = ("zamba2-1.2b", "rwkv6-7b")
# the leaves the JAX package keeps in float32 in a bfloat16 model
F32_LEAVES = {"zamba2-1.2b": ("a_log", "d_skip", "dt_bias"),
              "rwkv6-7b": ("u", "w0")}


def _cfgs(arch, ffn_impl="dense", **kw):
    """(JAX config, port config), reduced; C = 1 for gather."""
    out = []
    for base in (jax_get_config(arch), get_config(arch)):
        c = base.reduced(**kw)
        out.append(dataclasses.replace(c, sparsity=dataclasses.replace(
            c.sparsity, ffn_impl=ffn_impl, l1_coeff=1e-2,
            twell_c=1 if ffn_impl == "gather" else c.sparsity.twell_c)))
    return out


def _pattern_weights(tree):
    """The (…, D, N) weights whose columns the FFN's pattern follows."""
    if "shared_attn" in tree:
        return [tree["shared_attn"]["ffn"]["wg"]]
    return list(tree["blocks"]["cm"]["wu"])


_WEIGHTS = {}


def _weights(arch, alive=ALIVE, **kw):
    """(JAX params, the port's, numpy tree) of the reduced ``arch`` with
    ``alive`` pattern columns a layer."""
    key = (arch, alive, tuple(sorted(kw.items())))
    if key not in _WEIGHTS:
        jcfg, _ = _cfgs(arch, **kw)
        tree = jax.tree_util.tree_map(np.array, jax.jit(
            lambda k: jlm.init(k, jcfg))(jax.random.PRNGKey(0)))
        rng = np.random.RandomState(0)
        for w in _pattern_weights(tree):
            w[:, rng.permutation(w.shape[1])[alive:]] = 0
        _WEIGHTS[key] = (jax.tree_util.tree_map(jnp.asarray, tree),
                         bridge.from_numpy(tree), tree)
    return _WEIGHTS[key]


def _jflat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _tflat(tree):
    return {p: np.asarray(v.detach()) for p, v in leaves_with_path(tree)}


def _close(got, want, tol, what=""):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **tol,
                                   err_msg=f"{what} {k}")


def _grads_both(jfn, tfn, jparams, tparams, x, gy):
    """(output, d params, d x) of sum(f(params, x) * gy) on both sides."""
    jy, (jgp, jgx) = jax.jit(lambda p, xx: (
        jfn(p, xx), jax.grad(lambda p_, x_: jnp.sum(jfn(p_, x_) * gy),
                             argnums=(0, 1))(p, xx)))(jparams, jnp.asarray(x))
    live = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tfn(live, xt)
    grads = torch.autograd.grad((y * torch.from_numpy(gy)).sum(),
                                [xt] + list(live.values()))
    got = {"y": y.detach().numpy(), "x": grads[0].numpy(),
           **{k: g.numpy() for k, g in zip(live, grads[1:])}}
    want = {"y": np.asarray(jy), "x": np.asarray(jgx),
            **{k: np.asarray(v) for k, v in jgp.items()}}
    return got, want


@pytest.mark.parametrize("s", [12, 300])
def test_mamba2_apply_matches_jax(s):
    """Layer 0's Mamba2 block on 2 x S tokens (S 12: one padded chunk of
    256; S 300: two, the second padded): y and the gradients of x and
    every leaf of the block, all finite (the decay is masked before its
    exp)."""
    jcfg, cfg = _cfgs("zamba2-1.2b")
    _, _, tree = _weights("zamba2-1.2b")
    p = {k: v[0] for k, v in tree["blocks"]["mamba"].items()}
    rng = np.random.RandomState(1)
    x = rng.randn(2, s, cfg.d_model).astype(np.float32)
    gy = rng.randn(2, s, cfg.d_model).astype(np.float32)
    got, want = _grads_both(
        lambda pp, xx: jmamba2.mamba2_apply(pp, xx, jcfg),
        lambda pp, xx: mamba2.mamba2_apply(pp, xx, cfg),
        {k: jnp.asarray(v) for k, v in p.items()},
        {k: torch.from_numpy(v) for k, v in p.items()}, x, gy)
    assert all(np.isfinite(v).all() for v in got.values())
    _close(got, want, MOD_TOL, f"S={s}")


def test_mamba2_decode_matches_jax():
    """One decode step of layer 0's Mamba2 block from a random cache: y,
    the SSM state and the conv window; the cache's shapes and dtypes as
    JAX's ``mamba2_cache_init`` in a bfloat16 model."""
    jcfg, cfg = _cfgs("zamba2-1.2b")
    _, _, tree = _weights("zamba2-1.2b")
    p = {k: v[0] for k, v in tree["blocks"]["mamba"].items()}
    jc = jmamba2.mamba2_cache_init(jcfg, 3, jnp.bfloat16)
    tc = mamba2.mamba2_cache_init(cfg, 3, torch.bfloat16, "cpu")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jc.items()} == \
        {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in tc.items()}
    rng = np.random.RandomState(2)
    x = rng.randn(3, 1, cfg.d_model).astype(np.float32)
    cache = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in tc.items()}
    jy, jnew = jax.jit(lambda pp, xx, cc: jmamba2.mamba2_decode(
        pp, xx, jcfg, cc))({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x),
                           {k: jnp.asarray(v) for k, v in cache.items()})
    y, new = mamba2.mamba2_decode(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        cfg, {k: torch.from_numpy(v) for k, v in cache.items()})
    _close({"y": y.numpy(), **{k: v.numpy() for k, v in new.items()}},
           {"y": np.asarray(jy), **{k: np.asarray(v)
                                    for k, v in jnew.items()}}, MOD_TOL)


@pytest.mark.parametrize("chunk,w0", [(0, -6.0), (0, -1.0), (32, -6.0),
                                      (32, -1.0)])
def test_timemix_matches_jax(chunk, w0):
    """``timemix_apply`` at S 128 on the per-token scan (rwkv_chunk 0) and
    the chunked WKV (32: four chunks), at the slow base decay w0 = -6 and
    the strong -1 (the clips bite), from a random carried state at w0 -1:
    y, the gradients of x and every leaf, the final WKV state and shift."""
    jcfg, cfg = _cfgs("rwkv6-7b", rwkv_chunk=chunk)
    _, _, tree = _weights("rwkv6-7b")
    p = {k: v[0] for k, v in tree["blocks"]["tm"].items()}
    p["w0"] = np.full_like(p["w0"], w0)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 128, cfg.d_model).astype(np.float32)
    gy = rng.randn(*x.shape).astype(np.float32)
    h, hd = rwkv6.rwkv_dims(cfg)
    st = None if w0 == -6.0 else {
        "wkv": rng.randn(2, h, hd, hd).astype(np.float32),
        "shift": rng.randn(2, cfg.d_model).astype(np.float32)}
    jst = None if st is None else {k: jnp.asarray(v) for k, v in st.items()}
    tst = None if st is None else {k: torch.from_numpy(v)
                                   for k, v in st.items()}
    got, want = _grads_both(
        lambda pp, xx: jrwkv6.timemix_apply(pp, xx, jcfg, jst)[0],
        lambda pp, xx: rwkv6.timemix_apply(pp, xx, cfg, tst)[0],
        {k: jnp.asarray(v) for k, v in p.items()},
        {k: torch.from_numpy(v) for k, v in p.items()}, x, gy)
    _close(got, want, MOD_TOL, f"chunk {chunk}, w0 {w0}")
    _, jnew = jax.jit(lambda pp, xx: jrwkv6.timemix_apply(pp, xx, jcfg,
                                                          jst))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    with torch.no_grad():
        _, new = rwkv6.timemix_apply(
            {k: torch.from_numpy(v) for k, v in p.items()},
            torch.from_numpy(x), cfg, tst)
    _close({k: v.numpy() for k, v in new.items()},
           {k: np.asarray(v) for k, v in jnew.items()}, MOD_TOL)


@pytest.mark.parametrize("impl", ["dense", "gather"])
def test_channelmix_matches_jax(impl):
    """Layer 0's channel mix on 2 x 12 tokens after a carried shift, under
    the dense FFN and the gather one (relu^2 packed by K1's plain version,
    projected by K6's): y, the new shift and every aux entry."""
    jcfg, cfg = _cfgs("rwkv6-7b", impl)
    _, _, tree = _weights("rwkv6-7b")
    p = {k: v[0] for k, v in tree["blocks"]["cm"].items()}
    rng = np.random.RandomState(4)
    x = rng.randn(2, 12, cfg.d_model).astype(np.float32)
    shift = rng.randn(2, cfg.d_model).astype(np.float32)
    jy, jst, jaux = jax.jit(lambda pp, xx, sh: jrwkv6.channelmix_apply(
        pp, xx, jcfg, jcfg.sparsity, {"shift": sh}))(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
            jnp.asarray(shift))
    ops.OverflowLog.reset()
    y, st, aux = rwkv6.channelmix_apply(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        cfg, cfg.sparsity, {"shift": torch.from_numpy(shift)},
        collect_aux=True)
    assert not ops.OverflowLog.seen()
    _close({"y": y.numpy(), "shift": st["shift"].numpy(),
            **{k: np.asarray(v) for k, v in aux.items()}},
           {"y": np.asarray(jy), "shift": np.asarray(jst["shift"]),
            **{k: np.asarray(v) for k, v in jaux.items()}}, TOL, impl)


def _batch(vocab, b=2, s=64, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# rwkv6 at S 64 with a WKV chunk of 32 (the chunked path, two chunks)
_LM_KW = {"zamba2-1.2b": {}, "rwkv6-7b": {"rwkv_chunk": 32}}


@pytest.mark.parametrize("impl", ["dense", "hybrid"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_gradients_match_jax(arch, impl):
    """``lm.loss_fn`` over 2 x 64 tokens: the metrics, every stacked aux
    entry (zamba2's layers without the shared block: zeros with
    ``ffn_present`` 0) and every parameter's gradient against
    ``jax.value_and_grad``; under the hybrid FFN rows on both sides of the
    format and no overflow."""
    jcfg, cfg = _cfgs(arch, impl, **_LM_KW[arch])
    jparams, _, tree = _weights(arch)
    nb = _batch(cfg.vocab_size)
    (_, (jmetrics, jaux)), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, b, jcfg), has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in nb.items()})
    params = lm.trainable(bridge.from_numpy(tree))
    live = jax.tree_util.tree_map(lambda t: t.requires_grad_(True), params)
    ops.HybridOverflowLog.reset()
    loss, (metrics, aux) = lm.loss_fn(
        live, {k: torch.from_numpy(v) for k, v in nb.items()}, cfg)
    names = [p for p, _ in leaves_with_path(live)]
    grads = torch.autograd.grad(loss, [t for _, t in leaves_with_path(live)])
    if impl == "hybrid":
        ell_rows, backup_rows = ops.HybridOverflowLog.rows()
        assert ell_rows > 0 and backup_rows > 0
        assert not ops.HybridOverflowLog.seen()
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(jmetrics[k]), rtol=1e-5, err_msg=k)
    _close({k: np.asarray(v.detach()) for k, v in aux.items()},
           {k: np.asarray(v) for k, v in jaux.items()}, TOL, "aux")
    want_present = [float(i % 2 == 1) for i in range(cfg.num_layers)] \
        if arch == "zamba2-1.2b" else [1.0] * cfg.num_layers
    assert aux["ffn_present"].tolist() == want_present
    _close(dict(zip(names, (g.numpy() for g in grads))), _jflat(jgrads), TOL,
           "grad")


def _close_params(got, want, lr):
    """All but 1 in 1e4 weights within 1e-5; those within 2 * lr."""
    assert sorted(got) == sorted(want)
    for name, a in got.items():
        d = np.abs(a - want[name])
        assert d.max() <= 2 * lr + 1e-6, name
        assert (d > 1e-5).mean() <= 1e-4, (name, (d > 1e-5).sum())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One ``make_train_step`` step with the hybrid FFN: metrics and every
    parameter (the float32 leaves and rwkv6's ``mix`` among them) against
    ``repro.training``'s."""
    jcfg, cfg = _cfgs(arch, "hybrid", **_LM_KW[arch])
    jparams, _, tree = _weights(arch)
    kw = dict(learning_rate=1e-3, total_steps=10, warmup_steps=2)
    jstep = jax.jit(jtraining.make_train_step(jcfg, JTrainConfig(**kw)))
    step = training.make_train_step(cfg, TrainConfig(**kw))
    jopt = jadamw.init(jparams, jnp.dtype(jcfg.opt_state_dtype))
    params = lm.trainable(bridge.from_numpy(tree))
    opt = adamw.init(params)
    nb = _batch(cfg.vocab_size, s=64, seed=3)
    jparams, jopt, jm = jstep(jparams, jopt,
                              {k: jnp.asarray(v) for k, v in nb.items()})
    params, opt, m = step(params, opt,
                          {k: torch.from_numpy(v) for k, v in nb.items()})
    assert set(m) == set(jm)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _close_params(_tflat(params), _jflat(jparams), 1e-3)


def _decode_logits(step, params, cache, toks):
    out = []
    for i in range(toks.shape[1]):
        lg, cache = step(params, cache, toks[:, i:i + 1])
        out.append(np.asarray(lg)[:, 0])
    return np.stack(out, axis=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax_and_the_forward(arch):
    """12 tokens teacher-forced through ``decode_step`` (gather FFN: K1 +
    K2 in zamba2's shared block, K1 + K6 in rwkv6's channel mix, their
    plain versions) against JAX's ``decode_step`` and against the port's
    ``forward`` on the same tokens, at every position; the cache's shapes
    and dtypes as JAX's ``init_cache``."""
    jcfg, cfg = _cfgs(arch, "gather")
    jparams, tparams, _ = _weights(arch)
    toks = np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 12))
    cache = lm.init_cache(cfg, 2, 12, device="cpu")
    jcache = jlm.init_cache(jcfg, 2, 12)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in cache.items() if k != "pos"} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jcache.items()
         if k != "pos"}
    ops.OverflowLog.reset()
    with torch.no_grad():
        got = _decode_logits(
            lambda p, c, t: lm.decode_step(p, c, torch.from_numpy(t), cfg),
            tparams, cache, toks)
        fwd, _ = lm.forward(tparams, {"tokens": torch.from_numpy(toks)}, cfg)
    assert not ops.OverflowLog.seen()
    want = _decode_logits(jax.jit(lambda p, c, t: jlm.decode_step(
        p, c, t, jcfg)), jparams, jcache, jnp.asarray(toks, jnp.int32))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, fwd.numpy(), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_static_loop_greedy_tokens_match_jax(arch):
    """``launch/serve.py:generate`` on 3 prompts of 10 tokens and 12 new
    ones under the gather FFN: the same greedy tokens as JAX's."""
    jcfg, cfg = _cfgs(arch, "gather")
    jparams, tparams, _ = _weights(arch)
    prompt = np.random.RandomState(6).randint(0, cfg.vocab_size, (3, 10))
    want = jserve.generate(jparams, jcfg, jnp.asarray(prompt, jnp.int32),
                           12, cache_len=23)
    got = serve.generate(tparams, cfg, torch.from_numpy(prompt), 12, 23)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trips_and_keeps_dtypes(arch, dtype):
    """``bridge.from_numpy`` / ``to_numpy`` on JAX's tree bit for bit, in
    JAX's leaf order; ``wu_t`` derived on zamba2's ``shared_attn.ffn``
    only and dropped again; the float32 leaves stay float32 in a bfloat16
    tree; ``lm.init``'s own tree has JAX's leaves, shapes and dtypes."""
    jcfg, cfg = _cfgs(arch, dtype=dtype, param_dtype=dtype)
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jlm.init(k, jcfg))(jax.random.PRNGKey(1)))
    params = bridge.from_numpy(tree)
    if arch == "zamba2-1.2b":
        ffn = params["shared_attn"]["ffn"]
        assert torch.equal(ffn["wu_t"], ffn["wu"].t())
    flat = dict(leaves_with_path(params))
    assert [k for k in flat if k.endswith("wu_t")] == \
        (["shared_attn/ffn/wu_t"] if arch == "zamba2-1.2b" else [])
    for name in F32_LEAVES[arch]:
        leaf = [v for k, v in flat.items() if k.endswith("/" + name)]
        assert len(leaf) == 1 and leaf[0].dtype == torch.float32, name
    back = bridge.to_numpy(params)
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_j, flat_b):
        np.testing.assert_array_equal(b, np.asarray(a, np.float32),
                                      err_msg=str(path))
    own = lm.trainable(lm.init(cfg, device="cpu"))
    shapes = jax.eval_shape(lambda k: jlm.init(k, jcfg),
                            jax.random.PRNGKey(0))
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in leaves_with_path(own)} == \
        {"/".join(str(q.key) for q in path): (tuple(v.shape), str(v.dtype))
         for path, v in jax.tree_util.tree_leaves_with_path(shapes)}


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_refuses(arch):
    """Neither family has paged KV: ``init_paged_cache`` and the engine
    refuse them, as the JAX package's do."""
    _, cfg = _cfgs(arch)
    _, tparams, _ = _weights(arch)
    with pytest.raises(NotImplementedError, match="dense/moe"):
        lm.init_paged_cache(cfg, 4, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="dense/moe"):
        ServingEngine(tparams, cfg, device="cpu")
    assert not serve.uses_engine(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_jax_packages(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(get_config(arch).reduced()) == \
        dataclasses.asdict(jax_get_config(arch).reduced())


def test_bf16_gap_to_float32_grows_as_in_jax():
    """rwkv6 at d_model 128 (2 heads of 64, d_ff 448), 2 and 16 layers,
    the same bf16 weights (JAX's ``lm.init``) run by each package in
    bfloat16 and widened to float32: the training forward's logits over
    64 tokens. In float32 the port equals JAX (2e-4); in bfloat16 each
    package's distance to its own float32 grows with depth (the port's
    more than 3-fold from 2 to 16 layers), the port's no larger than 1.5x
    JAX's at either depth: the bf16 paths' distance from float32 at
    rwkv6's served depth on the card is the reference's behaviour too, not
    the port's alone."""
    kw = dict(d_model=128, d_ff=448, rwkv_head_dim=64, num_heads=2,
              vocab_size=512, dtype="bfloat16", param_dtype="bfloat16")
    jcfg16 = jax_get_config("rwkv6-7b").reduced(num_layers=16, **kw)
    full = jax.jit(lambda k: jlm.init(k, jcfg16))(jax.random.PRNGKey(0))
    gaps = {}
    for layers in (2, 16):
        jcfg = dataclasses.replace(jcfg16, num_layers=layers)
        cfg = get_config("rwkv6-7b").reduced(num_layers=layers, **kw)
        tree = {**full, "blocks": jax.tree_util.tree_map(
            lambda a: a[:layers], full["blocks"])}
        trees = {"bfloat16": jax.tree_util.tree_map(np.asarray, tree),
                 "float32": jax.tree_util.tree_map(
                     lambda a: np.asarray(a.astype(jnp.float32)), tree)}
        toks = np.random.RandomState(7).randint(0, 512, (1, 64))
        out = {}
        for dt, t in trees.items():
            jc = dataclasses.replace(jcfg, dtype=dt, param_dtype=dt)
            lg, _ = jax.jit(lambda p, x: jlm.forward(p, {"tokens": x}, jc))(
                jax.tree_util.tree_map(jnp.asarray, t),
                jnp.asarray(toks, jnp.int32))
            out["jax", dt] = np.asarray(lg.astype(jnp.float32))
            with torch.no_grad():
                lg, _ = lm.forward(
                    bridge.from_numpy(t), {"tokens": torch.from_numpy(toks)},
                    dataclasses.replace(cfg, dtype=dt, param_dtype=dt))
            out["port", dt] = lg.float().numpy()
        np.testing.assert_allclose(out["port", "float32"],
                                   out["jax", "float32"], **TOL)
        gaps[layers] = {
            pkg: float(np.abs(out[pkg, "bfloat16"] -
                              out[pkg, "float32"]).max())
            for pkg in ("jax", "port")}
    assert gaps[16]["jax"] > gaps[2]["jax"], gaps
    assert gaps[16]["port"] > 3 * gaps[2]["port"], gaps
    for layers, g in gaps.items():
        assert g["port"] <= 1.5 * g["jax"], (layers, g)
