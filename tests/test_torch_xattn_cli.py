"""The port's serve and train CLIs on whisper-large-v3 (audio) and
llama-3.2-vision-11b (vlm), in process, on the CPU at ``--reduced``
scale, against the JAX package's: the serve CLI routes both to the static
loop and its greedy tokens equal JAX's ``generate`` on the same weights
and prompts (neither CLI passes frames or patches: whisper decodes with an
encoder cache of length 0, vision with ``num_image_tokens`` zero image
slots), and ``--http`` and ``--disagg`` refuse the route; the train CLI
refuses both families, whose forward reads ``frames`` / ``patches`` that
its synthetic data does not make, where the JAX trainer fails on the
missing key.

The serve case sets vision's cross-block gates nonzero and keeps ALIVE of
every pattern column alive (whisper's W_u, vision's W_g): the CLI's
reduced geometry has 16 TwELL slots a 128-column tile, which then never
overflow. Tolerance: greedy tokens equal.
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
from repro_torch.configs import get_config
from repro_torch.launch import serve, train
from repro_torch.models import lm

ARCHS = ("whisper-large-v3", "llama-3.2-vision-11b")
ALIVE = 16
EXTRA = {"whisper-large-v3": "frames", "llama-3.2-vision-11b": "patches"}


def _prepare(tree):
    """Gates nonzero (vision), all but ALIVE pattern columns zeroed."""
    if "enc_blocks" in tree:
        pattern = list(tree["enc_blocks"]["ffn"]["wu"]) + \
            list(tree["dec_blocks"]["ffn"]["wu"])
    else:
        cross = tree["blocks"]["cross"]
        cross["gate_attn"][:] = 0.8
        cross["gate_ffn"][:] = -0.6
        pattern = [w for ws in tree["blocks"]["selfs"]["ffn"]["wg"]
                   for w in ws] + list(cross["ffn"]["wg"])
    rng = np.random.RandomState(0)
    for w in pattern:
        w[:, rng.permutation(w.shape[1])[ALIVE:]] = 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_static_loop_matches_jax(arch, monkeypatch):
    """``--reduced --device cpu`` (gather FFN, 4 prompts of 32 tokens, 16
    greedy tokens) with JAX's ``lm.init`` weights in place of the port's:
    the CLI returns the static loop's tokens, equal to JAX's
    ``generate``'s on its prompts (no extras on either side)."""
    cfg = get_config(arch).reduced()
    jcfg = jax_get_config(arch).reduced()
    assert not serve.uses_engine(cfg)
    tree = jax.tree_util.tree_map(np.array, jax.jit(
        lambda k: jlm.init(k, jcfg))(jax.random.PRNGKey(0)))
    _prepare(tree)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_refuses_as_jax_fails(arch, tmp_path):
    """The JAX trainer fails at its first step on the batch's missing
    extra (KeyError); the port's trainer refuses the family up front,
    naming that extra, before it writes a checkpoint."""
    args = ["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "16", "--log-every", "100"]
    with pytest.raises(KeyError, match=EXTRA[arch]):
        jtrain_cli.main(args + ["--ckpt-dir", str(tmp_path / "jax")])
    with pytest.raises(SystemExit, match=EXTRA[arch]):
        train.main(args + ["--ckpt-dir", str(tmp_path / "port"),
                           "--device", "cpu"])
    assert not (tmp_path / "port").exists()
