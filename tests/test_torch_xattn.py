"""The port's cross-attention families (the ``audio`` and ``vlm`` branches
of ``repro_torch/models/lm.py``, the ``cross`` and ``bidir`` attention
kinds; whisper-large-v3 and llama-3.2-vision-11b) against the JAX package
on the same weights, at ``.reduced()`` scale in float32: whisper with 2
encoder and 2 decoder layers, vision with 4 layers (2 super-blocks of a
self and a cross block) over 2 KV heads of 4 (GQA, as the config's 32/8).
Checked: ``attention`` of kind cross (K/V from ``kv_x``, and from a
cache's ``xk``/``xv``) and bidir with their gradients, ``_chunked_bidir``
at small chunks; ``encode_frames`` and ``prefill_cross_cache``;
``lm.loss_fn`` with every aux entry and every gradient under the dense
and hybrid FFNs and every ``remat`` mode (and whisper's ``2level``
regrouping at 4 + 4 layers against remat none); one train step;
teacher-forced ``decode_step`` against JAX's and against the port's own
``forward``; the static loop from a prefilled cache against JAX's greedy
decode; an empty encoder cache; the bridge's round trip; the paged
engine's refusal.

Weights come from ``repro.models.lm.init`` through ``bridge.from_numpy``
with every cross block's ``gate_attn`` and ``gate_ffn`` set nonzero and
different per block in both packages (at ``init``'s zeros, tanh(0) = 0
and the cross path would add nothing), and all but ALIVE of each FFN's
pattern columns zeroed (whisper's W_u, vision's W_g), so the hybrid FFN
puts rows on both sides of the format (ELL width 32) without overflowing
the backup; the gather cases take ``twell_c = 1`` (a slot a column).
Frames and patches come from a numpy seed.

Tolerances (float32, the frameworks sum in different orders): modules
1e-4 (rtol and atol), logits, aux and gradients 2e-4, as
tests/test_torch_ssm.py; train-step metrics 1e-5 relative and parameters
after the step 1e-5 absolute for all but 1 in 1e4 weights (an Adam step
of a near-zero gradient may turn); greedy tokens equal.
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
from repro_torch import bridge, training
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.paged_decode_attention import masked_sdpa
from repro_torch.launch import serve
from repro_torch.models import layers, lm
from repro_torch.optim import adamw
from repro_torch.serving import ServingEngine
from repro_torch.tree import leaves_with_path

MOD_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=2e-4, atol=2e-4)
ALIVE = 48
ARCHS = ("whisper-large-v3", "llama-3.2-vision-11b")
KW = {"whisper-large-v3": {},
      "llama-3.2-vision-11b": {"num_layers": 4, "num_kv_heads": 2}}
FRAMES = 24                  # whisper's encoder length in these tests


def _cfgs(arch, ffn_impl="dense", **kw):
    """(JAX config, port config), reduced with KW[arch]; C = 1 for
    gather."""
    out = []
    for base in (jax_get_config(arch), get_config(arch)):
        c = base.reduced(**{**KW[arch], **kw})
        out.append(dataclasses.replace(c, sparsity=dataclasses.replace(
            c.sparsity, ffn_impl=ffn_impl, l1_coeff=1e-2,
            twell_c=1 if ffn_impl == "gather" else c.sparsity.twell_c)))
    return out


def _pattern_weights(tree):
    """The (…, D, N) weights whose columns the FFN's pattern follows."""
    if "enc_blocks" in tree:
        return list(tree["enc_blocks"]["ffn"]["wu"]) + \
            list(tree["dec_blocks"]["ffn"]["wu"])
    return [w for ws in tree["blocks"]["selfs"]["ffn"]["wg"] for w in ws] + \
        list(tree["blocks"]["cross"]["ffn"]["wg"])


def _set_gates(tree):
    """Every cross block's gates nonzero and different per block."""
    if "blocks" in tree and "cross" in tree["blocks"]:
        cross = tree["blocks"]["cross"]
        nb = cross["gate_attn"].shape[0]
        cross["gate_attn"][:] = np.linspace(0.6, -0.9, nb)
        cross["gate_ffn"][:] = np.linspace(-0.7, 1.1, nb)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's tensors are tiny: one intra-op thread a process, so
    that pytest-xdist's workers do not crowd the cores with threads that
    wait on each other (the count is restored after the file)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_WEIGHTS = {}


def _weights(arch, **kw):
    """(JAX params, the port's, numpy tree) of the reduced ``arch``,
    gates set, ALIVE pattern columns a layer."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _WEIGHTS:
        jcfg, _ = _cfgs(arch, **kw)
        tree = jax.tree_util.tree_map(np.array, jax.jit(
            lambda k: jlm.init(k, jcfg))(jax.random.PRNGKey(0)))
        _set_gates(tree)
        rng = np.random.RandomState(0)
        for w in _pattern_weights(tree):
            w[:, rng.permutation(w.shape[1])[ALIVE:]] = 0
        _WEIGHTS[key] = (jax.tree_util.tree_map(jnp.asarray, tree),
                         bridge.from_numpy(tree), tree)
    return _WEIGHTS[key]


def _extras(cfg, b, seed=0, frames=FRAMES):
    """The batch extra of ``cfg``'s family: frames (B, FRAMES, D) or
    patches (B, num_image_tokens, D), numpy float32."""
    rng = np.random.RandomState(100 + seed)
    if cfg.family == "audio":
        return {"frames": rng.randn(b, frames, cfg.d_model)
                .astype(np.float32)}
    return {"patches": rng.randn(b, cfg.num_image_tokens, cfg.d_model)
            .astype(np.float32)}


def _batch(cfg, b=2, s=32, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            **_extras(cfg, b, seed)}


def _j(nb):
    return {k: jnp.asarray(v) for k, v in nb.items()}


def _t(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


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


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_jax_packages(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(get_config(arch).reduced()) == \
        dataclasses.asdict(jax_get_config(arch).reduced())


# kind, S of x, S of kv_x (None: self-attention), whether K/V come from a
# cache's xk/xv
ATTN_CASES = [("cross", 6, 10, False), ("cross", 1, 10, True),
              ("cross", 1, 0, True), ("bidir", 12, None, False)]


@pytest.mark.parametrize("kind,s,sk,cached", ATTN_CASES)
def test_attention_kinds_match_jax(kind, s, sk, cached):
    """Layer 0's attention of ``kind`` on vision's reduced GQA heads: y
    and the gradients of x (and of kv_x) and of every weight; a cross
    decode token against precomputed xk/xv (10 keys, and none: zeros)."""
    jcfg, cfg = _cfgs("llama-3.2-vision-11b")
    _, _, tree = _weights("llama-3.2-vision-11b")
    p = {k: v[0] for k, v in tree["blocks"]["cross"]["attn"].items()}
    rng = np.random.RandomState(1)
    x = rng.randn(2, s, cfg.d_model).astype(np.float32)
    kv = None if sk is None else rng.randn(2, sk, cfg.d_model).astype(
        np.float32)
    gy = rng.randn(2, s, cfg.d_model).astype(np.float32)
    pos = np.arange(s)
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim

    def jfn(pp, xx, kk):
        cache = None
        if cached:
            cache = {"xk": (kk @ pp["wk"]).reshape(2, sk, hkv, hd),
                     "xv": (kk @ pp["wv"]).reshape(2, sk, hkv, hd)}
        return jlayers.attention(pp, xx, jcfg, positions=jnp.asarray(pos),
                                 kind=kind, kv_x=None if cached else kk,
                                 cache=cache)[0]

    def tfn(pp, xx, kk):
        cache = None
        if cached:
            cache = {"xk": (kk @ pp["wk"]).reshape(2, sk, hkv, hd),
                     "xv": (kk @ pp["wv"]).reshape(2, sk, hkv, hd)}
        return layers.attention(pp, xx, cfg, positions=torch.from_numpy(pos),
                                kind=kind, kv_x=None if cached else kk,
                                cache=cache)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    args = (0, 1) if kv is None else (0, 1, 2)
    jy, jg = jax.jit(lambda pp, xx, kk: (jfn(pp, xx, kk), jax.grad(
        lambda *a: jnp.sum(jfn(*a) * gy), argnums=args)(pp, xx, kk)))(
            jp, jnp.asarray(x), None if kv is None else jnp.asarray(kv))
    live = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    kt = None if kv is None else torch.from_numpy(kv).requires_grad_(True)
    y = tfn(live, xt, kt)
    ins = [xt] + ([] if kt is None else [kt]) + list(live.values())
    grads = torch.autograd.grad((y * torch.from_numpy(gy)).sum(), ins,
                                allow_unused=True)
    got = {"y": y.detach().numpy(), "x": grads[0].numpy()}
    want = {"y": np.asarray(jy), "x": np.asarray(jg[1])}
    if kt is not None:
        got["kv_x"], want["kv_x"] = grads[1].numpy(), np.asarray(jg[2])
    for (name, g) in zip(live, grads[len(ins) - len(live):]):
        got[name] = np.zeros_like(p[name]) if g is None else g.numpy()
        want[name] = np.asarray(jg[0][name])
    _close(got, want, MOD_TOL, f"{kind} S={s} Sk={sk} cached={cached}")
    if sk == 0:
        np.testing.assert_array_equal(got["y"], 0.0)


@pytest.mark.parametrize("q_chunk,kv_chunk", [(4, 8), (8, 4), (16, 16)])
def test_chunked_bidir_matches_jax(q_chunk, kv_chunk):
    """``_chunked_bidir`` on (2, 16, 4, 16) q, k, v at small chunks
    against JAX's and against unmasked attention."""
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(2, 16, 4, 16).astype(np.float32) for _ in range(3))
    want = np.asarray(jax.jit(lambda a, b, c: jlayers._chunked_bidir(
        a, b, c, 0.25, q_chunk, kv_chunk))(q, k, v))
    got = layers._chunked_bidir(*map(torch.from_numpy, (q, k, v)), 0.25,
                                q_chunk, kv_chunk).numpy()
    np.testing.assert_allclose(got, want, **MOD_TOL)
    plain = masked_sdpa(*map(torch.from_numpy, (q, k, v)), None,
                        0.25).numpy()
    np.testing.assert_allclose(got, plain, **MOD_TOL)


_JAX_CROSS = {}


def _jax_cross(arch):
    """JAX's zero cache of 2 x 8 slots (the caches' shapes and dtypes),
    then its ``prefill_cross_cache`` over ``_extras(cfg, 2)`` (and, for
    whisper, its ``encode_frames``): one compile a family."""
    if arch not in _JAX_CROSS:
        jcfg, cfg = _cfgs(arch)
        jparams, _, _ = _weights(arch)
        ex = _extras(cfg, 2)
        enc_len = FRAMES if cfg.family == "audio" else 0
        jc = jlm.init_cache(jcfg, 2, 8, enc_len=enc_len,
                            num_patches=cfg.num_image_tokens)
        shapes = {k: (tuple(v.shape), str(v.dtype)) for k, v in jc.items()
                  if k != "pos"}
        jc = jax.jit(lambda p, c, b: jlm.prefill_cross_cache(p, c, b, jcfg))(
            jparams, jc, _j(ex))
        want = {k: np.asarray(jc[k]) for k in ("xk", "xv")}
        if cfg.family == "audio":
            want["enc"] = np.asarray(jax.jit(
                lambda p, f: jlm.encode_frames(p, f, jcfg))(
                    jparams, jnp.asarray(ex["frames"])))
        _JAX_CROSS[arch] = (shapes, want)
    return _JAX_CROSS[arch]


def _port_cross(arch, cfg):
    """The port's counterpart of ``_jax_cross`` under ``cfg``."""
    _, tparams, _ = _weights(arch)
    ex = _extras(cfg, 2)
    tc = lm.init_cache(cfg, 2, 8, device="cpu",
                       enc_len=FRAMES if cfg.family == "audio" else 0,
                       num_patches=cfg.num_image_tokens)
    shapes = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
              for k, v in tc.items() if k != "pos"}
    with torch.no_grad():
        tc = lm.prefill_cross_cache(tparams, tc, _t(ex), cfg)
        got = {k: tc[k].numpy() for k in ("xk", "xv")}
        if cfg.family == "audio":
            got["enc"] = lm.encode_frames(
                tparams, torch.from_numpy(ex["frames"]), cfg).numpy()
    return shapes, got


@pytest.mark.parametrize("arch", ARCHS)
def test_encode_frames_and_cross_cache_match_jax(arch):
    """``prefill_cross_cache`` on a zero cache (whisper: ``encode_frames``
    over 2 x FRAMES frames, then every decoder layer's ``xattn``; vision:
    the raw patches through every cross block's ``attn``), the caches'
    shapes and dtypes as JAX's ``init_cache`` gives them."""
    _, cfg = _cfgs(arch)
    jshapes, want = _jax_cross(arch)
    shapes, got = _port_cross(arch, cfg)
    assert shapes == jshapes
    _close(got, want, MOD_TOL, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_inputs_take_the_param_dtype_as_jax(arch):
    """A config whose ``dtype`` (bfloat16) differs from its
    ``param_dtype`` (float32): JAX casts the frames and patches to
    ``_dtype(cfg)``, which is the param dtype, and reads ``cfg.dtype``
    nowhere in the model, so its caches and encoder output are the float32
    config's. The port's, under the mixed config, equal them."""
    _, cfg = _cfgs(arch)
    mixed = dataclasses.replace(cfg, dtype="bfloat16",
                                param_dtype="float32")
    jshapes, want = _jax_cross(arch)
    shapes, got = _port_cross(arch, mixed)
    assert shapes == jshapes
    assert {v.dtype for v in got.values()} == {np.dtype(np.float32)}
    _close(got, want, MOD_TOL, arch)


_JAX_LOSS = {}


def _jax_loss(arch):
    """JAX's (metrics, aux, grads) of ``loss_fn`` on ``_batch`` under the
    dense FFN, remat none: one compile a family. The hybrid FFN computes
    the dense FFN's values in another format (its rows on both sides of
    it, none overflowing), and JAX's recomputation changes no value, so
    the port's every FFN and remat mode is held against this reference
    (tests/test_torch_remat.py holds each mode against JAX's same mode for
    the dense family, tests/test_torch_ssm.py the hybrid FFN against JAX's
    hybrid FFN)."""
    if arch not in _JAX_LOSS:
        jcfg, cfg = _cfgs(arch)
        jparams, _, _ = _weights(arch)
        (_, (jmetrics, jaux)), jgrads = jax.jit(jax.value_and_grad(
            lambda p, b: jlm.loss_fn(p, b, jcfg), has_aux=True))(
                jparams, _j(_batch(cfg)))
        _JAX_LOSS[arch] = (
            {k: float(v) for k, v in jmetrics.items()},
            {k: np.asarray(v) for k, v in jaux.items()}, _jflat(jgrads))
    return _JAX_LOSS[arch]


def _port_loss(tree, nb, cfg):
    """The port's (metrics, aux, named gradients) of ``loss_fn``."""
    params = lm.trainable(bridge.from_numpy(tree))
    live = jax.tree_util.tree_map(lambda t: t.requires_grad_(True), params)
    loss, (metrics, aux) = lm.loss_fn(live, _t(nb), cfg)
    named = list(leaves_with_path(live))
    grads = torch.autograd.grad(loss, [t for _, t in named])
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {k: np.asarray(v.detach()) for k, v in aux.items()},
            {n: g.numpy() for (n, _), g in zip(named, grads)})


@pytest.mark.parametrize("remat", ["none", "full", "dots", "2level"])
@pytest.mark.parametrize("impl", ["dense", "hybrid"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_gradients_match_jax(arch, impl, remat):
    """``lm.loss_fn`` over 2 x 32 tokens with the frames or patches under
    each remat mode: the metrics, every stacked aux entry (whisper: the
    encoder's layers, then the decoder's; vision: a super-block's self
    block, then its cross block) and every parameter's gradient, the
    gates' among them, against ``jax.value_and_grad``; under the hybrid
    FFN rows on both sides of the format and no overflow."""
    _, cfg = _cfgs(arch, impl, remat=remat)
    _, _, tree = _weights(arch)
    jmetrics, jaux, jgrads = _jax_loss(arch)
    ops.HybridOverflowLog.reset()
    metrics, aux, grads = _port_loss(tree, _batch(cfg), cfg)
    if impl == "hybrid":
        ell_rows, backup_rows = ops.HybridOverflowLog.rows()
        assert ell_rows > 0 and backup_rows > 0
        assert not ops.HybridOverflowLog.seen()
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=1e-5,
                                   err_msg=k)
    _close(aux, jaux, TOL, "aux")
    layers_ = cfg.num_layers + cfg.encoder_layers
    assert aux["ffn_present"].tolist() == [1.0] * layers_
    _close(grads, jgrads, TOL, "grad")
    if cfg.family == "vlm":
        assert np.abs(grads["blocks/cross/gate_attn"]).min() > 0
        assert np.abs(grads["blocks/cross/gate_ffn"]).min() > 0


@pytest.mark.parametrize("remat", ["full", "2level"])
def test_whisper_regrouped_stacks_equal_none(remat):
    """whisper at 4 + 4 layers, where ``2level`` regroups both stacks (the
    decoder's checkpointed groups close over the encoder's output): loss,
    aux and every gradient under the hybrid FFN equal remat none's bit
    for bit (the ported JAX reference is checked at 2 + 2 above)."""
    kw = {"num_layers": 4, "encoder_layers": 4}
    _, base = _cfgs("whisper-large-v3", "hybrid", **kw)
    tree_ = bridge.to_numpy(lm.init(base, device="cpu", seed=0))
    rng = np.random.RandomState(0)
    for w in _pattern_weights(tree_):
        w[:, rng.permutation(w.shape[1])[ALIVE:]] = 0
    nb = _batch(base)
    want = _port_loss(tree_, nb, base)
    got = _port_loss(tree_, nb, dataclasses.replace(base, remat=remat))
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _close_params(got, want, lr):
    """All but 1 in 1e4 weights within 1e-5; those within 2 * lr."""
    assert sorted(got) == sorted(want)
    for name, a in got.items():
        d = np.abs(a - want[name])
        assert d.max() <= 2 * lr + 1e-6, name
        assert (d > 1e-5).mean() <= 1e-4, (name, (d > 1e-5).sum())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One ``make_train_step`` step with the hybrid FFN on a batch that
    carries the frames or patches: metrics and every parameter against
    ``repro.training``'s."""
    jcfg, cfg = _cfgs(arch, "hybrid")
    jparams, _, tree = _weights(arch)
    kw = dict(learning_rate=1e-3, total_steps=10, warmup_steps=2)
    jstep = jax.jit(jtraining.make_train_step(jcfg, JTrainConfig(**kw)))
    step = training.make_train_step(cfg, TrainConfig(**kw))
    jopt = jadamw.init(jparams, jnp.dtype(jcfg.opt_state_dtype))
    params = lm.trainable(bridge.from_numpy(tree))
    opt = adamw.init(params)
    nb = _batch(cfg, seed=3)
    jparams, jopt, jm = jstep(jparams, jopt, _j(nb))
    params, opt, m = step(params, opt, _t(nb))
    assert set(m) == set(jm)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _close_params(_tflat(params), _jflat(jparams), 1e-3)


_JAX_DECODE = {}


def _jax_decode(arch):
    """JAX's jitted ``decode_step`` of ``arch`` under the gather FFN, one
    a family (a cache shape compiles once)."""
    if arch not in _JAX_DECODE:
        jcfg, _ = _cfgs(arch, "gather")
        _JAX_DECODE[arch] = jax.jit(
            lambda p, c, t: jlm.decode_step(p, c, t, jcfg))
    return _JAX_DECODE[arch]


def _decode_logits(step, params, cache, toks):
    out = []
    for i in range(toks.shape[1]):
        lg, cache = step(params, cache, toks[:, i:i + 1])
        out.append(np.asarray(lg)[:, 0])
    return np.stack(out, axis=1)


def _caches(arch, jcfg, cfg, jparams, tparams, ex, b, s):
    """Both packages' decode caches with the cross K/V filled."""
    enc_len = ex["frames"].shape[1] if "frames" in ex else 0
    jc = jlm.prefill_cross_cache(jparams, jlm.init_cache(
        jcfg, b, s, enc_len=enc_len, num_patches=cfg.num_image_tokens),
        _j(ex), jcfg)
    with torch.no_grad():
        tc = lm.prefill_cross_cache(tparams, lm.init_cache(
            cfg, b, s, device="cpu", enc_len=enc_len,
            num_patches=cfg.num_image_tokens), _t(ex), cfg)
    return jc, tc


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax_and_the_forward(arch):
    """12 tokens teacher-forced through ``decode_step`` from a prefilled
    cross cache (gather FFN: K1 + K6 in whisper's decoder, K1 + K2 in
    vision's self and cross blocks, their plain versions) against JAX's
    ``decode_step`` and against the port's ``forward`` on the same tokens
    and extras, at every position."""
    jcfg, cfg = _cfgs(arch, "gather")
    jparams, tparams, _ = _weights(arch)
    toks = np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 12))
    ex = _extras(cfg, 2, seed=5)
    jc, tc = _caches(arch, jcfg, cfg, jparams, tparams, ex, 2, 12)
    ops.OverflowLog.reset()
    with torch.no_grad():
        got = _decode_logits(
            lambda p, c, t: lm.decode_step(p, c, torch.from_numpy(t), cfg),
            tparams, tc, toks)
        fwd, _ = lm.forward(tparams, {"tokens": torch.from_numpy(toks),
                                      **_t(ex)}, cfg)
    assert not ops.OverflowLog.seen()
    want = _decode_logits(_jax_decode(arch), jparams, jc,
                          jnp.asarray(toks, jnp.int32))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, fwd.numpy(), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_static_loop_from_a_prefilled_cache_matches_jax(arch):
    """``launch/serve.py:generate`` started from a prefilled cross cache
    (``cache=``), 2 prompts of 4 tokens and 7 new under the gather FFN:
    the greedy tokens of JAX's ``decode_step`` from its own prefilled
    cache (the decode test's shapes: one compile)."""
    jcfg, cfg = _cfgs(arch, "gather")
    jparams, tparams, _ = _weights(arch)
    prompt = np.random.RandomState(6).randint(0, cfg.vocab_size, (2, 4))
    ex = _extras(cfg, 2, seed=6)
    jc, tc = _caches(arch, jcfg, cfg, jparams, tparams, ex, 2, 12)
    got = serve.generate(tparams, cfg, torch.from_numpy(prompt), 7, 12,
                         cache=tc)
    step = _jax_decode(arch)
    toks = jnp.asarray(prompt, jnp.int32)
    for i in range(4):
        lg, jc = step(jparams, jc, toks[:, i:i + 1])
    out = [toks]
    for _ in range(7):
        nxt = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
        out.append(nxt)
        lg, jc = step(jparams, jc, nxt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jnp.concatenate(out, axis=1)))


@pytest.mark.parametrize("arch", ARCHS)
def test_empty_cross_cache_matches_jax(arch):
    """The caches the serve CLI decodes with (no extras, as JAX's CLI):
    whisper's encoder cache of length 0 (cross-attention adds zeros, no
    NaN), vision's num_image_tokens zero slots: 6 decode steps' logits
    finite and equal to JAX's."""
    jcfg, cfg = _cfgs(arch, "gather")
    jparams, tparams, _ = _weights(arch)
    toks = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, 6))
    jc = jlm.init_cache(jcfg, 2, 12, num_patches=cfg.num_image_tokens)
    tc = lm.init_cache(cfg, 2, 12, device="cpu",
                       num_patches=cfg.num_image_tokens)
    assert tc["xk"].shape[2] == (0 if cfg.family == "audio"
                                 else cfg.num_image_tokens)
    with torch.no_grad():
        got = _decode_logits(
            lambda p, c, t: lm.decode_step(p, c, torch.from_numpy(t), cfg),
            tparams, tc, toks)
    want = _decode_logits(_jax_decode(arch), jparams, jc,
                          jnp.asarray(toks, jnp.int32))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trips(arch, dtype):
    """``bridge.from_numpy`` / ``to_numpy`` on a tree of JAX's leaves,
    shapes and dtypes under ``dtype`` (``_weights``' values, gates set,
    each leaf cast to the dtype ``jax.eval_shape`` of ``jlm.init`` gives
    it) bit for bit, in JAX's leaf order, the (nb,) gates included;
    ``wu_t`` derived on vision's self and cross FFNs only and dropped
    again; ``lm.init``'s own tree has JAX's leaves, shapes and dtypes."""
    jcfg, cfg = _cfgs(arch, dtype=dtype, param_dtype=dtype)
    shapes = jax.eval_shape(lambda k: jlm.init(k, jcfg),
                            jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda v, sd: v.astype(sd.dtype),
                                  _weights(arch)[2], shapes)
    params = bridge.from_numpy(tree)
    flat = dict(leaves_with_path(params))
    if cfg.family == "vlm":
        assert sorted(k for k in flat if k.endswith("wu_t")) == \
            ["blocks/cross/ffn/wu_t", "blocks/selfs/ffn/wu_t"]
        for ffn in (params["blocks"]["selfs"]["ffn"],
                    params["blocks"]["cross"]["ffn"]):
            assert torch.equal(ffn["wu_t"], ffn["wu"].transpose(-1, -2))
        assert flat["blocks/cross/gate_attn"].shape == (2,)
    else:
        assert not [k for k in flat if k.endswith("wu_t")]
    back = bridge.to_numpy(params)
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_j, flat_b):
        np.testing.assert_array_equal(b, np.asarray(a, np.float32),
                                      err_msg=str(path))
    own = lm.trainable(lm.init(cfg, device="cpu"))
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in leaves_with_path(own)} == \
        {"/".join(str(q.key) for q in path): (tuple(v.shape), str(v.dtype))
         for path, v in jax.tree_util.tree_leaves_with_path(shapes)}


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_refuses(arch):
    """Neither family has paged KV: ``init_paged_cache`` and the engine
    refuse them, as the JAX package's do, and the serve CLI routes them
    to the static loop."""
    _, cfg = _cfgs(arch)
    _, tparams, _ = _weights(arch)
    with pytest.raises(NotImplementedError, match="dense/moe"):
        lm.init_paged_cache(cfg, 4, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="dense/moe"):
        ServingEngine(tparams, cfg, device="cpu")
    assert not serve.uses_engine(cfg)
