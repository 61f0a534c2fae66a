"""olmo-1b (non-gated FFN, non-parametric LayerNorm, head dim 128) in the
PyTorch port against repro.models.lm and repro.serving.ServingEngine on
the same weights (bridged from the JAX parameters), on the reduced config:
the norms, the non-gated TwELL FFN (K1 + K6) with its aux statistics, the
paged prefill / chunk-append / decode logits, the engine's greedy tokens on
the workloads of tests/test_serving.py and tests/test_prefix_cache.py, the
weight bridge with the empty norm dicts, and the training loss.

The TwELL serving cases take ``twell_c = 1`` (a slot for every column), as
tests/test_torch_engine.py does: random weights fire about half of every
tile's columns, which would overflow T/C = 16 slots.

Tolerances: float32 2e-4 (rtol and atol) and bfloat16 2e-2, as
tests/test_kernels.py; the two frameworks sum in different orders, nothing
else differs. Loss and training metrics 1e-5 relative, gradients 2e-4, as
tests/test_torch_train.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import sparse_ffn as jffn
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serving import ServingEngine as JaxEngine
from repro.serving import finished_outputs as jax_finished
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import sparse_ffn
from repro_torch.kernels import ops
from repro_torch.models import layers, lm
from repro_torch.serving import ServingEngine, finished_outputs
from repro_torch.tree import leaves_with_path

TOL = dict(rtol=2e-4, atol=2e-4)
BS = 4
ALIVE = 32          # W_u columns alive per layer in the training cases


def _cfgs(ffn_impl="dense", twell_c=1, **kw):
    """(JAX config, port config): reduced olmo-1b with ``ffn_impl``."""
    out = []
    for base in (jax_get_config("olmo-1b"), get_config("olmo-1b")):
        c = base.reduced(**kw)
        out.append(dataclasses.replace(c, sparsity=dataclasses.replace(
            c.sparsity, ffn_impl=ffn_impl, twell_c=twell_c)))
    return out


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


_MODELS = {}


def _model(d_ff=128):
    """(JAX params, port params on the CPU) of reduced olmo-1b."""
    if d_ff not in _MODELS:
        jcfg, _ = _cfgs(d_ff=d_ff)
        jp = jlm.init(jax.random.PRNGKey(0), jcfg)
        _MODELS[d_ff] = (jp, bridge.from_numpy(_np_tree(jp)))
    return _MODELS[d_ff]


def _structure(tree):
    """Nested key structure of a tree; leaves as None."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return None


# --------------------------------------------------------------------------- #
# config, bridge, norms
# --------------------------------------------------------------------------- #

def test_config_and_reduced_tree_layout():
    cfg = get_config("olmo-1b")
    assert (cfg.norm, cfg.gated, cfg.num_layers, cfg.resolved_head_dim,
            cfg.d_ff, cfg.padded_vocab) == ("nonparametric_ln", False, 16,
                                            128, 8192, 50304)
    params = lm.init(cfg.reduced(), device="cpu")
    assert _structure(params) == {
        "blocks": {"attn": {"wq": None, "wk": None, "wv": None, "wo": None},
                   "ffn": {"wu": None, "wd": None}, "ln1": {}, "ln2": {}},
        "embed": None, "final_ln": {}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_keeps_the_empty_norms(dtype):
    jcfg, _ = _cfgs(dtype=dtype, param_dtype=dtype)
    tree = _np_tree(jlm.init(jax.random.PRNGKey(1), jcfg))
    params = bridge.from_numpy(tree)
    assert _structure(params) == _structure(tree)       # no wu_t: not gated
    back = bridge.to_numpy(params)
    assert _structure(back) == _structure(tree)
    assert back["final_ln"] == {} and back["blocks"]["ln1"] == {}
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_j, flat_b):
        np.testing.assert_array_equal(b, np.asarray(a, np.float32),
                                      err_msg=str(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparametric_ln"])
def test_norm_apply_matches_jax(kind, dtype):
    rng = np.random.RandomState(3)
    x = (rng.randn(3, 5, 64) * 2 + 0.5).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.randn(64)).astype(np.float32),
         "bias": (0.1 * rng.randn(64)).astype(np.float32)}
    jp = jlayers.norm_init(kind, 64, jnp.float32)
    tp = layers.norm_init(kind, 64, torch.float32, "cpu")
    assert set(tp) == set(jp)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else \
        (jnp.float32, torch.float32)
    want = jlayers.norm_apply(kind, {k: jnp.asarray(p[k], jd) for k in jp},
                              jnp.asarray(x, jd))
    got = layers.norm_apply(kind, {k: torch.from_numpy(p[k]).to(td)
                                   for k in tp}, torch.from_numpy(x).to(td))
    assert got.dtype == td
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# --------------------------------------------------------------------------- #
# the non-gated FFN
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("impl,n,tile,c", [
    ("gather", 256, 128, 4),          # two tiles, no overflow
    ("gather", 512, 256, 8),
    ("gather", 256, 128, 16),         # T/C = 8: tiles overflow, clipped
    ("dense", 256, 128, 4),
])
def test_nongated_ffn_and_aux_match_jax(impl, n, tile, c):
    """sparse_ffn.apply(gated=False, collect_aux=True): y and every aux
    key of the JAX package's, with a dead tile and an all-zero row."""
    jcfg, tcfg = _cfgs(ffn_impl=impl)
    scfg = [dataclasses.replace(cf.sparsity, twell_tile=tile, twell_c=c)
            for cf in (jcfg, tcfg)]
    rng = np.random.RandomState(2)
    p = {"wu": (rng.randn(64, n) * 0.3).astype(np.float32),
         "wd": (rng.randn(n, 64) * 0.3).astype(np.float32)}
    p["wu"][:, tile:2 * tile] = 0                 # a tile dead for all rows
    p["wu"][:, rng.rand(n) < 0.85] = 0            # sparse rows elsewhere
    x = rng.randn(6, 64).astype(np.float32)
    x[3] = 0                                      # a row with no slot
    jy, jaux = jffn.apply({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), scfg[0], False)
    ops.OverflowLog.reset()
    ty, taux = sparse_ffn.apply({k: torch.from_numpy(v) for k, v in
                                 p.items()}, torch.from_numpy(x), scfg[1],
                                False, collect_aux=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]),
                                   err_msg=k, **TOL)
    if impl == "gather":
        fired = (np.maximum(x @ p["wu"], 0) > 0).reshape(6, n // tile, tile)
        assert bool((fired.sum(-1) > tile // c).any()) == (c == 16)
        assert ops.OverflowLog.seen() == (c == 16)
        assert float(taux["tile_frac"]) < 1.0
    ops.OverflowLog.reset()
    _, none = sparse_ffn.apply({k: torch.from_numpy(v) for k, v in
                                p.items()}, torch.from_numpy(x), scfg[1],
                               False)
    assert none is None


# --------------------------------------------------------------------------- #
# the paged model
# --------------------------------------------------------------------------- #

def _pools_np(pools):
    return {k: np.asarray(v) for k, v in pools.items()}


@pytest.mark.parametrize("d_ff", [128, 512])
@pytest.mark.parametrize("impl", ["dense", "gather"])
def test_paged_prefill_chunk_append_and_decode_match_jax(impl, d_ff):
    """Prefill, a chunk appended to history and 3 decode steps: logits and
    KV pools. d_ff 512 gives the down projection two tiles of 256."""
    jparams, tparams = _model(d_ff)
    jcfg, tcfg = _cfgs(ffn_impl=impl, d_ff=d_ff)
    assert tcfg.d_ff // tcfg.sparsity.twell_tile == {128: 1, 512: 2}[d_ff]
    rng = np.random.RandomState(0)
    lens, steps, width = [7, 3], 3, 5
    jpools = jlm.init_paged_cache(jcfg, 1 + 2 * width, BS)
    tpools = lm.init_paged_cache(tcfg, 1 + 2 * width, BS, device="cpu")
    bt = np.arange(1, 1 + 2 * width, dtype=np.int32).reshape(2, width)
    prompts = [rng.randint(0, jcfg.vocab_size, n) for n in lens]

    def both_prefill(chunk, start, num_new):
        nonlocal jpools
        jl, jpools = jlm.paged_prefill(
            jparams, jpools, jnp.asarray(bt), jnp.asarray(chunk),
            jnp.asarray(num_new), jcfg, start_lens=jnp.asarray(start))
        tl, _ = lm.paged_prefill(
            tparams, tpools, torch.from_numpy(bt), torch.from_numpy(chunk),
            torch.from_numpy(num_new), tcfg,
            start_lens=torch.from_numpy(start))
        return np.asarray(jl), tl.numpy()

    ops.OverflowLog.reset()
    c1 = np.zeros((2, 4), np.int32)
    c1[0] = prompts[0][:4]
    c1[1, :3] = prompts[1]
    jl, tl = both_prefill(c1, np.zeros(2, np.int32),
                          np.asarray([4, 3], np.int32))
    np.testing.assert_allclose(tl[0], jl[0], **TOL)
    np.testing.assert_allclose(tl[1, :3], jl[1, :3], **TOL)
    c2 = np.zeros((2, 4), np.int32)
    c2[0, :3] = prompts[0][4:]
    jl, tl = both_prefill(c2, np.asarray([4, 3], np.int32),
                          np.asarray([3, 0], np.int32))
    np.testing.assert_allclose(tl[0, :3], jl[0, :3], **TOL)
    seq = np.asarray(lens, np.int32)
    tok = np.asarray([[int(jl[0, 2].argmax())], [int(jl[1, 0].argmax())]],
                     np.int32)
    for _ in range(steps):
        jd, jpools = jlm.paged_decode_step(
            jparams, jpools, jnp.asarray(bt), jnp.asarray(seq),
            jnp.asarray(tok), jcfg)
        td, _ = lm.paged_decode_step(
            tparams, tpools, torch.from_numpy(bt), torch.from_numpy(seq),
            torch.from_numpy(tok), tcfg)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
        tok = np.array(jd[:, -1].argmax(-1), np.int32)[:, None]
        seq = seq + 1
    for k, v in _pools_np(jpools).items():
        np.testing.assert_allclose(tpools[k].numpy(), v, **TOL)
    assert not ops.OverflowLog.seen()


@pytest.mark.parametrize("impl", ["dense", "gather"])
def test_last_only_head_and_sparsity_probe_match_jax(impl):
    jparams, tparams = _model()
    jcfg, tcfg = _cfgs(ffn_impl=impl)
    rng = np.random.RandomState(1)
    toks = rng.randint(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    num_new = np.asarray([8, 5], np.int32)
    bt = np.asarray([[1, 2], [3, 4]], np.int32)
    jl, jaux, _ = jlm.paged_prefill(
        jparams, jlm.init_paged_cache(jcfg, 5, BS), jnp.asarray(bt),
        jnp.asarray(toks), jnp.asarray(num_new), jcfg, last_only=True,
        collect_aux=True)
    tl, taux, _ = lm.paged_prefill(
        tparams, lm.init_paged_cache(tcfg, 5, BS, device="cpu"),
        torch.from_numpy(bt), torch.from_numpy(toks),
        torch.from_numpy(num_new), tcfg, last_only=True, collect_aux=True)
    assert tl.shape == (2, 1, jcfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k in ("nnz_mean", "tile_frac", "ffn_present"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]),
                                   **TOL)


# --------------------------------------------------------------------------- #
# the serving engine
# --------------------------------------------------------------------------- #

def _engines(backend, **kw):
    jp, tp = _model()
    jcfg, tcfg = _cfgs()
    kw.setdefault("block_size", BS)
    return (JaxEngine(jp, jcfg, backend=backend, **kw),
            ServingEngine(tp, tcfg, backend=backend, device="cpu", **kw))


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, n).tolist() for n in lens]


def _drain(engine, finished):
    outs = {}
    while engine.has_unfinished():
        for o in finished(engine.step()):
            outs[o.rid] = o
    return outs


@pytest.mark.parametrize("backend", ["dense", "gather"])
def test_engine_static_workload_tokens_identical(backend):
    """tests/test_serving.py:131 workload, per-step logits too."""
    je, te = _engines(backend, max_batch=4, max_seq_len=32,
                      record_logits=True)
    prompts = _prompts([5, 9, 7])
    want = je.generate(prompts, max_tokens=6)
    ops.OverflowLog.reset()
    outs = te.generate(prompts, max_tokens=6)
    assert not ops.OverflowLog.seen()
    assert [o.token_ids for o in outs] == [o.token_ids for o in want]
    for o, w in zip(outs, want):
        for got, ref in zip(o.logits, w.logits):
            np.testing.assert_allclose(got, ref, **TOL)
    te.kv.check_invariants()
    assert te.kv.num_available == te.kv.num_blocks - 1


@pytest.mark.parametrize("backend", ["dense", "gather"])
def test_engine_staggered_arrival_identical(backend):
    """tests/test_serving.py:182 workload: joins mid-flight."""
    results = []
    for eng, fin in zip(_engines(backend, max_batch=4, max_seq_len=32),
                        (jax_finished, finished_outputs)):
        prompts = _prompts([5, 8, 6, 11], seed=3)
        outs = {}
        for p in prompts[:2]:
            eng.add_request(p, max_tokens=5)
        for _ in range(2):
            for o in fin(eng.step()):
                outs[o.rid] = o
        for p in prompts[2:]:
            eng.add_request(p, max_tokens=5)
        outs.update(_drain(eng, fin))
        results.append(([outs[r].token_ids for r in range(4)],
                        [(s.decode_batch, s.prefills) for s in eng.stats]))
    assert results[1] == results[0]
    assert len({b for b, _ in results[1][1]}) > 1


@pytest.mark.parametrize("backend", ["dense", "gather"])
def test_engine_prefix_hit_and_cow_identical(backend):
    """tests/test_prefix_cache.py:164 (re-served prompts) and :208
    (copy-on-write on divergent suffixes) workloads on one engine pair."""
    res = []
    for eng, fin in zip(_engines(backend, max_batch=2, max_seq_len=32),
                        (jax_finished, finished_outputs)):
        prompts = _prompts([8, 11], seed=3)
        first = [o.token_ids for o in eng.generate(prompts, max_tokens=5)]
        second = eng.generate(prompts, max_tokens=5)
        prompt = _prompts([8], seed=9)[0]
        warm = eng.generate([prompt], max_tokens=6)[0].token_ids
        eng.add_request(prompt, max_tokens=6)
        eng.add_request(prompt, max_tokens=6)
        outs = _drain(eng, fin)
        res.append((first, [o.token_ids for o in second],
                    [o.cached_prefix_tokens for o in second], warm,
                    [outs[r].token_ids for r in sorted(outs)],
                    eng.kv.cow_count))
    assert res[1] == res[0]
    assert res[1][2] == [7, 8]
    assert res[1][5] >= 1


@pytest.mark.parametrize("backend", ["dense", "gather"])
def test_engine_chunked_prefill_staggered_identical(backend):
    """tests/test_prefix_cache.py:300 workload: 4-token chunks."""
    res = []
    for eng, fin in zip(_engines(backend, max_batch=4, max_seq_len=32,
                                 prefill_chunk=4, min_prefill_bucket=4),
                        (jax_finished, finished_outputs)):
        prompts = _prompts([11, 20, 7], seed=17)
        outs = {}
        eng.add_request(prompts[0], max_tokens=5)
        for _ in range(2):
            for o in fin(eng.step()):
                outs[o.rid] = o
        for p in prompts[1:]:
            eng.add_request(p, max_tokens=5)
        outs.update(_drain(eng, fin))
        res.append(([outs[r].token_ids for r in range(3)],
                    [s.prefill_tokens for s in eng.stats]))
    assert res[1] == res[0]
    assert sum(1 for t in res[1][1] if t) >= 5


def test_serve_cli_runs_olmo_on_the_cpu(capsys):
    from repro_torch.launch import serve
    outs = serve.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu",
                       "--backend", "dense"])
    assert len(outs) == 4 and all(len(o.token_ids) == 16 for o in outs)
    assert "tok/s" in capsys.readouterr().out


# --------------------------------------------------------------------------- #
# training loss
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("impl", ["dense", "hybrid"])
def test_loss_and_gradients_match_jax(impl):
    """lm.loss_fn through norm_apply and the non-gated FFN, ALIVE of each
    layer's 128 W_u columns alive: metrics, aux and every gradient."""
    jcfg, cfg = [dataclasses.replace(c, sparsity=dataclasses.replace(
        c.sparsity, l1_coeff=1e-2)) for c in _cfgs(ffn_impl=impl)]
    tree = jax.tree_util.tree_map(np.array,
                                  jlm.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(0)
    for layer in tree["blocks"]["ffn"]["wu"]:
        layer[:, rng.permutation(layer.shape[1])[ALIVE:]] = 0
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    nb = JSyntheticLM(jcfg.vocab_size, 2, 32, seed=0).__next__()
    (jloss, (jmetrics, jaux)), jgrads = jax.value_and_grad(
        jlm.loss_fn, has_aux=True)(jparams, {k: jnp.asarray(v) for k, v in
                                             nb.items()}, jcfg)
    live = jax.tree_util.tree_map(lambda t: t.requires_grad_(True),
                                  lm.trainable(bridge.from_numpy(tree)))
    ops.HybridOverflowLog.reset()
    loss, (metrics, aux) = lm.loss_fn(
        live, {k: torch.from_numpy(v) for k, v in nb.items()}, cfg)
    assert not ops.HybridOverflowLog.seen()
    named = list(leaves_with_path(live))
    grads = torch.autograd.grad(loss, [t for _, t in named])
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(jmetrics[k]), rtol=1e-5, err_msg=k)
    for k in ("l1", "nnz_mean", "nnz_max", "neuron_active", "tile_frac"):
        np.testing.assert_allclose(np.asarray(aux[k].detach()),
                                   np.asarray(jaux[k]), rtol=1e-5,
                                   err_msg=k)
    jg = {"/".join(str(k.key) for k in path): np.asarray(v)
          for path, v in jax.tree_util.tree_leaves_with_path(jgrads)}
    assert sorted(n for n, _ in named) == sorted(jg)
    for (name, _), g in zip(named, grads):
        np.testing.assert_allclose(g.numpy(), jg[name], rtol=2e-4,
                                   atol=2e-4, err_msg=name)
