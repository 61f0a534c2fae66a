"""The port's serve and train CLIs on zamba2-1.2b (hybrid) and rwkv6-7b
(ssm), in process, on the CPU at ``--reduced`` scale, against the JAX
package's: the serve CLI routes both to the static loop and its greedy
tokens equal JAX's ``generate`` on the same weights and prompts
(``--http`` and ``--disagg`` refuse the route); the train CLI, resumed
from one step-0 checkpoint as the JAX trainer is, takes the same hybrid
steps with ``--dead-reinit``, which stays a dense-family option on both
sides.

The serve case keeps ALIVE of every pattern column alive (rwkv6's channel
mix W_u, zamba2's shared W_g): the CLI's reduced geometry has 16 TwELL
slots a 128-column tile, which then never overflow. The train case zeroes
3/4 of them, so the hybrid rows fit the ELL width and the backup.

Tolerances: greedy tokens equal; losses and cross-entropies 1e-4
relative, as tests/test_torch_train.py holds a resumed run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import serve as jserve
from repro.launch import train as jtrain_cli
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import serve, train
from repro_torch.models import lm
from repro_torch.optim import adamw

ARCHS = ("zamba2-1.2b", "rwkv6-7b")
ALIVE = 16


def _pattern(tree):
    """The (..., D, N) weights whose columns the FFN's pattern follows."""
    if "shared_attn" in tree:
        return tree["shared_attn"]["ffn"]["wg"][None]
    return tree["blocks"]["cm"]["wu"]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_static_loop_matches_jax(arch, monkeypatch):
    """``--reduced --device cpu`` (gather FFN, 4 prompts of 32 tokens, 16
    greedy tokens) with JAX's ``lm.init`` weights in place of the port's:
    the CLI returns the static loop's tokens, equal to JAX's
    ``generate``'s on its prompts."""
    cfg = get_config(arch).reduced()
    jcfg = jax_get_config(arch).reduced()
    assert not serve.uses_engine(cfg)
    tree = jax.tree_util.tree_map(np.array, jax.jit(
        lambda k: jlm.init(k, jcfg))(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(0)
    for w in _pattern(tree):
        w[:, rng.permutation(w.shape[1])[ALIVE:]] = 0
    monkeypatch.setattr(lm, "init",
                        lambda *a, **k: bridge.from_numpy(tree))
    argv = ["--arch", arch, "--reduced", "--device", "cpu"]
    toks = serve.main(argv)
    assert isinstance(toks, torch.Tensor) and toks.shape == (4, 48)
    jcfg = dataclasses.replace(jcfg, sparsity=dataclasses.replace(
        jcfg.sparsity, ffn_impl="gather"))
    want = jserve.generate(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                           jnp.asarray(toks[:, :32].numpy(), jnp.int32), 16,
                           cache_len=49)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))
    for flag in (["--http", "--port", "0"], ["--disagg"]):
        with pytest.raises(SystemExit, match=f"{flag[0]} requires"):
            serve.main(argv + flag)


def _cli(mod, tmp, arch):
    args = ["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "32", "--ckpt-dir", str(tmp), "--log-every", "100",
            "--ffn-impl", "hybrid", "--dead-reinit"]
    return mod.main(args + (["--device", "cpu"] if mod is train else []))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_losses_match_jax(arch, tmp_path):
    """Both trainers resume from one step-0 checkpoint (the CLI's reduced
    config, width 128 and 4 layers, 3/4 of the pattern columns zeroed) and
    take steps 0-1 with the hybrid FFN and ``--dead-reinit``: the same
    losses."""
    cfg = get_config(arch).reduced(d_model=128, d_ff=512, num_layers=4)
    params = lm.trainable(lm.init(cfg, device="cpu"))
    dead = torch.from_numpy(np.random.RandomState(0).rand(512) < 0.75)
    if arch == "zamba2-1.2b":
        params["shared_attn"]["ffn"]["wg"][:, dead] = 0
    else:
        params["blocks"]["cm"]["wu"][:, :, dead] = 0
    tree = (params, adamw.init(params),
            torch.zeros((cfg.num_layers, cfg.d_ff), dtype=torch.bool))
    extra = {"data": SyntheticLM(cfg.vocab_size, 2, 32, seed=0).state(),
             "arch": cfg.name}
    for d in ("jax", "port"):
        CheckpointManager(str(tmp_path / d), async_save=False).save(
            0, tree, extra=extra)
    want = _cli(jtrain_cli, tmp_path / "jax", arch)
    got = _cli(train, tmp_path / "port", arch)
    assert [h["step"] for h in got] == [h["step"] for h in want] == [0, 1]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        np.testing.assert_allclose(g["ce"], w["ce"], rtol=1e-4)
