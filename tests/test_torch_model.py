"""The PyTorch port's paged LM against repro.models.lm on the same weights
(bridged from the JAX parameters): prefill, chunk-append with history and
decode logits, KV pools, the sparsity probe, and the weight bridge itself.

Tolerance: float32 2e-4 (rtol and atol), as tests/test_kernels.py; the two
frameworks sum in different orders, nothing else differs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import lm

TOL = dict(rtol=2e-4, atol=2e-4)
BS = 4


def _cfgs(ffn_impl="dense", twell_c=1, **kw):
    """(JAX config, port config) for reduced paper-0.5b, as
    tests/test_serving.py:19-22 builds it."""
    out = []
    for base in (jax_get_config("paper-0.5b"), get_config("paper-0.5b")):
        c = base.reduced(**kw)
        out.append(dataclasses.replace(c, sparsity=dataclasses.replace(
            c.sparsity, ffn_impl=ffn_impl, twell_c=twell_c)))
    return out


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    return jparams, bridge.from_numpy(_np_tree(jparams))


def test_reduced_config_is_the_jax_packages():
    for name in ("paper-0.5b", "olmo-1b"):
        want = dataclasses.asdict(jax_get_config(name).reduced())
        assert dataclasses.asdict(get_config(name).reduced()) == want
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jax_get_config(name))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip(dtype):
    jcfg, _ = _cfgs(dtype=dtype, param_dtype=dtype)
    tree = _np_tree(jlm.init(jax.random.PRNGKey(1), jcfg))
    params = bridge.from_numpy(tree)
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    back = bridge.to_numpy(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    want_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    for (path, a), (_, b) in zip(flat_j, flat_b):
        np.testing.assert_array_equal(b, np.asarray(a, np.float32),
                                      err_msg=str(path))
    assert params["embed"].dtype == want_dtype
    ffn = params["blocks"]["ffn"]
    assert torch.equal(ffn["wu_t"], ffn["wu"].transpose(-1, -2))


def _pools_np(pools):
    return {k: np.asarray(v) for k, v in pools.items()}


@pytest.mark.parametrize("impl", ["dense", "gather"])
def test_paged_prefill_chunk_append_and_decode_match_jax(weights, impl):
    jparams, tparams = weights
    jcfg, tcfg = _cfgs(ffn_impl=impl)
    rng = np.random.RandomState(0)
    lens = [7, 3]
    steps = 3
    width = 5
    jpools = jlm.init_paged_cache(jcfg, 1 + 2 * width, BS)
    tpools = lm.init_paged_cache(tcfg, 1 + 2 * width, BS, device="cpu")
    bt = np.arange(1, 1 + 2 * width, dtype=np.int32).reshape(2, width)
    prompts = [rng.randint(0, jcfg.vocab_size, n) for n in lens]

    def both_prefill(chunk, start, num_new):
        nonlocal jpools
        toks = np.zeros((2, chunk.shape[1]), np.int32)
        toks[:] = chunk
        jl, jpools = jlm.paged_prefill(
            jparams, jpools, jnp.asarray(bt), jnp.asarray(toks),
            jnp.asarray(num_new), jcfg, start_lens=jnp.asarray(start))
        tl, _ = lm.paged_prefill(
            tparams, tpools, torch.from_numpy(bt), torch.from_numpy(toks),
            torch.from_numpy(num_new), tcfg,
            start_lens=torch.from_numpy(start))
        return np.asarray(jl), tl.numpy()

    # chunk 1: positions [0, 4) of both prompts (row 1 is 3 long: padded tail)
    c1 = np.zeros((2, 4), np.int32)
    c1[0] = prompts[0][:4]
    c1[1, :3] = prompts[1]
    jl, tl = both_prefill(c1, np.zeros(2, np.int32),
                          np.asarray([4, 3], np.int32))
    np.testing.assert_allclose(tl[0], jl[0], **TOL)
    np.testing.assert_allclose(tl[1, :3], jl[1, :3], **TOL)
    # chunk 2 appends to history: row 0 positions [4, 7), row 1 nothing new
    c2 = np.zeros((2, 4), np.int32)
    c2[0, :3] = prompts[0][4:]
    jl, tl = both_prefill(c2, np.asarray([4, 3], np.int32),
                          np.asarray([3, 0], np.int32))
    np.testing.assert_allclose(tl[0, :3], jl[0, :3], **TOL)
    for k, v in _pools_np(jpools).items():
        np.testing.assert_allclose(tpools[k].numpy(), v, **TOL)
    # decode: the JAX package's greedy tokens fed to both
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


@pytest.mark.parametrize("impl", ["dense", "gather"])
def test_last_only_head_and_sparsity_probe_match_jax(weights, impl):
    jparams, tparams = weights
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


def test_gather_aux_statistics_match_jax():
    """sparse_ffn.apply(collect_aux=True) builds the JAX aux dict."""
    from repro.core import sparse_ffn as jffn
    from repro_torch.core import sparse_ffn
    jcfg, tcfg = _cfgs(ffn_impl="gather")
    rng = np.random.RandomState(2)
    p = {k: (rng.randn(*s) * 0.3).astype(np.float32) for k, s in
         (("wg", (64, 128)), ("wu", (64, 128)), ("wd", (128, 64)))}
    x = rng.randn(6, 64).astype(np.float32)
    jy, jaux = jffn.apply({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), jcfg.sparsity, True)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tp["wu_t"] = tp["wu"].t().contiguous()
    ty, taux = sparse_ffn.apply(tp, torch.from_numpy(x), tcfg.sparsity, True,
                                collect_aux=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]),
                                   err_msg=k, **TOL)
    _, none = sparse_ffn.apply(tp, torch.from_numpy(x), tcfg.sparsity, True)
    assert none is None
