"""The port's serve and train CLIs on the MoE configs, in process, on the
CPU at ``--reduced`` scale: the serve CLI routes mixtral-8x22b (sliding
window) and llama4-scout-17b-a16e (local chunks) to the static loop and a
window-free MoE config to the engine, as the JAX package's CLI does; the
train CLI trains both (the hybrid FFN, a run log with the router's balance
loss) and keeps ``--dead-reinit`` to the dense family, as JAX's does.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve, train

ARCHS = ("mixtral-8x22b", "llama4-scout-17b-a16e")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_routes_as_jax(arch, monkeypatch):
    """Both configs go to the static loop (the CLI returns its token
    tensor, prompts then greedy tokens); without the window or chunk the
    MoE family goes to the engine (its outputs); ``--http`` refuses the
    static route."""
    cfg = get_config(arch).reduced()
    assert not serve.uses_engine(cfg)
    assert serve.uses_engine(dataclasses.replace(cfg, window=0,
                                                 attn_chunk=0))
    assert not serve.uses_engine(dataclasses.replace(
        cfg, window=0, attn_chunk=0), static=True)
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "40", "--gen", "4"]
    toks = serve.main(argv)
    assert isinstance(toks, torch.Tensor) and toks.shape == (2, 44)
    with pytest.raises(SystemExit, match="--http requires"):
        serve.main(argv + ["--http", "--port", "0"])
    free = dataclasses.replace(cfg, window=0, attn_chunk=0)
    monkeypatch.setattr(serve, "get_config",
                        lambda name: dataclasses.replace(
                            get_config(name), window=0, attn_chunk=0))
    outs = serve.main(argv)
    assert [len(o.token_ids) for o in outs] == [4, 4]
    assert free.family == "moe"


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_moe(arch, tmp_path):
    """Three hybrid steps of the reduced config through the train CLI:
    finite losses, the balance loss in every step's metrics and in the run
    log's records; ``--dead-reinit`` runs and leaves the experts' gates
    alone (JAX reinitialises only a dense FFN's W_g)."""
    log = tmp_path / "run.jsonl"
    hist = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path / "ck"), "--steps", "3",
                       "--width", "64", "--layers", "2", "--seq", "64",
                       "--batch", "2", "--ffn-impl", "hybrid",
                       "--dead-reinit", "--run-log", str(log)])
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and h["moe_balance"] > 0
               for h in hist)
    steps = [json.loads(line) for line in log.read_text().splitlines()
             if json.loads(line).get("kind") == "step"]
    assert len(steps) == 3 and all(len(s["nnz_per_layer"]) == 2
                                   for s in steps)
