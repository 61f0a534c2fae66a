"""The port's serve and train CLIs on the remaining dense configs, in
process, on the CPU at ``--reduced`` scale: the serve CLI takes
phi3-mini-3.8b to the engine (the dense family without a window, as the
JAX package's CLI routes it), greedy under ``gather``, with its static-loop
check (``--check-static``, the default under ``--reduced``); the train CLI
trains deepseek-67b under the hybrid FFN with its bf16 AdamW moments (the
checkpoint holds them as bf16) and a run log.
"""
import json

import numpy as np

from repro_torch.configs import get_config
from repro_torch.launch import serve, train


def test_serve_cli_runs_phi3_through_the_engine(capsys):
    """Four greedy requests of 16 tokens through the engine's gather path
    (its outputs, not the static loop's token tensor), the static loop's
    check passing inside the CLI."""
    assert serve.uses_engine(get_config("phi3-mini-3.8b").reduced())
    outs = serve.main(["--arch", "phi3-mini-3.8b", "--reduced", "--device",
                       "cpu", "--backend", "gather"])
    assert len(outs) == 4 and all(len(o.token_ids) == 16 for o in outs)
    assert "tok/s" in capsys.readouterr().out


def test_train_cli_trains_deepseek_with_bf16_moments(tmp_path):
    """Three hybrid steps of reduced deepseek-67b (its bf16 moments kept):
    finite losses, a run log of three steps, and a checkpoint whose
    moments are bf16."""
    log = tmp_path / "run.jsonl"
    ck = tmp_path / "ck"
    hist = train.main(["--arch", "deepseek-67b", "--reduced", "--device",
                       "cpu", "--ckpt-dir", str(ck), "--steps", "3",
                       "--seq", "64", "--batch", "2", "--ffn-impl", "hybrid",
                       "--run-log", str(log)])
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    steps = [json.loads(line) for line in log.read_text().splitlines()
             if json.loads(line).get("kind") == "step"]
    assert len(steps) == 3
    # the checkpoint: parameters in float32, both moments bf16 bit patterns
    last = sorted(ck.glob("step_*"))[-1]
    names = json.loads((last / "manifest.json").read_text())["names"]
    arrays = np.load(last / "arrays.npz")
    def kinds(prefix):
        return {str(arrays[str(i)].dtype) for i, n in enumerate(names)
                if n.startswith(prefix)}
    assert kinds("1/.m/") == kinds("1/.v/") == {"|V2"}
    assert kinds("0/") == {"float32"}
