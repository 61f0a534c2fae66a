"""Recomputation (``cfg.remat``) in the port's training forward against the
JAX package's ``stacked_scan``, and the ``paper-1.5b`` config.

At ``.reduced()`` scale with 8 layers (so that ``2level`` splits them into
(4, 2) groups), float32, weights from ``repro.models.lm.init`` through
``bridge.py``; all but ALIVE of each layer's 128 gate columns are zeroed on
both sides, so the hybrid format holds rows in both its ELL and its dense
backup (as tests/test_torch_train.py does).

Tolerances: every mode's loss, aux and gradients are bitwise equal to the
port's own ``none`` (recomputation runs the same float32 ops on the same
inputs in the same order); against JAX's ``loss_fn`` under the same mode,
loss 1e-5 relative and gradients 2e-4 (rtol and atol), the tolerance of
tests/test_torch_train.py (the frameworks sum in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.tree import leaves_with_path, tree_map

GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
ALIVE = 48
LAYERS = 8
MODES = ("none", "full", "dots", "2level")


def _cfgs(impl, remat="none"):
    out = []
    for base in (jax_get_config("paper-0.5b"), get_config("paper-0.5b")):
        c = base.reduced(num_layers=LAYERS)
        out.append(dataclasses.replace(c, remat=remat, sparsity=dataclasses
                                       .replace(c.sparsity, ffn_impl=impl,
                                                l1_coeff=1e-2)))
    return out


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs("dense")
    tree = jax.tree_util.tree_map(np.array,
                                  jlm.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(0)
    for layer in tree["blocks"]["ffn"]["wg"]:
        layer[:, rng.permutation(layer.shape[1])[ALIVE:]] = 0
    return tree


@pytest.fixture(scope="module")
def batch():
    jcfg, _ = _cfgs("dense")
    return JSyntheticLM(jcfg.vocab_size, 2, 32, seed=0).__next__()


def _port_grads(tree, nb, cfg):
    live = tree_map(lambda t: t.requires_grad_(True),
                    lm.trainable(bridge.from_numpy(tree)))
    named = list(leaves_with_path(live))
    loss, (metrics, aux) = lm.loss_fn(
        live, {k: torch.from_numpy(v) for k, v in nb.items()}, cfg)
    grads = torch.autograd.grad(loss, [t for _, t in named])
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            {n: g for (n, _), g in zip(named, grads)})


@pytest.fixture(scope="module")
def port_none(weights, batch):
    return {impl: _port_grads(weights, batch, _cfgs(impl)[1])
            for impl in ("dense", "hybrid")}


@pytest.mark.parametrize("layers", range(1, 41))
def test_split_depth_matches_jax(layers):
    assert lm._split_depth(layers) == jlm._split_depth(layers)


def test_split_depth_groups():
    assert lm._split_depth(8) == (4, 2)
    assert lm._split_depth(28) == (7, 4)
    assert lm._split_depth(16) == (4, 4)


@pytest.mark.parametrize("mode", ["full", "dots", "2level"])
@pytest.mark.parametrize("impl", ["dense", "hybrid"])
def test_mode_is_bitwise_none(weights, batch, port_none, impl, mode):
    loss, aux, grads = _port_grads(weights, batch, _cfgs(impl, mode)[1])
    want_loss, want_aux, want = port_none[impl]
    assert torch.equal(loss, want_loss)
    for k in want_aux:
        assert torch.equal(aux[k], want_aux[k]), k
    assert grads.keys() == want.keys()
    for name, g in grads.items():
        assert torch.equal(g, want[name]), name


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("impl", ["dense", "hybrid"])
def test_mode_matches_jax(weights, batch, impl, mode):
    jcfg, cfg = _cfgs(impl, mode)
    jparams = jax.tree_util.tree_map(jnp.asarray, weights)
    (jloss, _), jgrads = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, _, grads = _port_grads(weights, batch, cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jg = {"/".join(str(k.key) for k in path): np.asarray(v)
          for path, v in jax.tree_util.tree_leaves_with_path(jgrads)}
    assert sorted(grads) == sorted(jg)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jg[name], **GRAD_TOL,
                                   err_msg=name)


def test_dots_saves_the_matrix_products(weights, batch, monkeypatch):
    """``dots`` keeps exactly the forward's products without batch
    dimensions: per layer q, k, v, o and the dense FFN's gate, up and down
    projections (7), and recomputes the rest."""
    saved = []
    policy = lm._dots_policy

    def spy(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and \
                out == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
            saved.append(op)
        return out
    monkeypatch.setattr(lm, "_dots_policy", spy)
    _port_grads(weights, batch, _cfgs("dense", "dots")[1])
    assert len(saved) == 7 * LAYERS
    assert set(saved) == {torch.ops.aten.mm.default}


def test_unknown_remat_raises(weights, batch):
    with pytest.raises(ValueError, match="remat"):
        _port_grads(weights, batch, _cfgs("dense", "everything")[1])


def test_paper_1p5b_config_equals_jax():
    got, want = get_config("paper-1.5b"), jax_get_config("paper-1.5b")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.num_layers, got.d_model, got.d_ff, got.remat) == \
        (28, 2048, 5632, "full")
    # the same parameter tree as paper-0.5b's, 28 layers deep
    jtree = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0),
                                            want.reduced(num_layers=3)))
    tree = lm.trainable(lm.init(got.reduced(num_layers=3), device="cpu"))
    jshapes = {"/".join(str(k.key) for k in p): tuple(v.shape)
               for p, v in jax.tree_util.tree_leaves_with_path(jtree)}
    assert {n: tuple(t.shape) for n, t in leaves_with_path(tree)} == jshapes
