"""The dry-run command lines: ``python -m repro_torch.launch.dryrun`` on a
full-size cell, its refusal of ``--multi-pod``, and ``dryrun_all`` over
paper-0.5b's cells (``long_500k`` skipped, as JAX's; a second run skips
the cells already ok). Each cell runs in a subprocess, as ``dryrun_all``
runs them; no card, nothing allocated."""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import dryrun, dryrun_all

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(*args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, timeout=timeout, env=env)


def test_full_size_train_cell(tmp_path):
    out = tmp_path / "cell.json"
    r = _cli("repro_torch.launch.dryrun", "--arch", "paper-0.5b", "--shape",
             "train_4k", "--out", str(out))
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 1
    assert rec["param_count"] == 511739904
    assert rec["peak_bytes_per_device"] == (
        rec["argument_size_in_bytes"] + rec["output_size_in_bytes"] +
        rec["temp_size_in_bytes"] - rec["alias_size_in_bytes"])
    assert rec["dot_flops_per_device"] > 6 * rec["param_count"] * 256 * 4096
    assert rec["kernels"]["flash_attention"]["calls"] == 2 * 8   # + remat
    assert rec["bound"] == "exact"
    assert json.loads(r.stdout)["status"] == "ok"


def test_multi_pod_waits_for_the_mesh():
    r = _cli("repro_torch.launch.dryrun", "--arch", "paper-0.5b", "--shape",
             "train_4k", "--multi-pod", timeout=120)
    assert r.returncode != 0
    assert "ROADMAP.md queue 1 item 6.2" in r.stderr
    with pytest.raises(NotImplementedError, match="item 6.2"):
        dryrun.run_cell("paper-0.5b", "train_4k", multi_pod=True)


def test_dryrun_all_one_arch(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun_all, "RESULTS", tmp_path)
    assert dryrun_all.main(["--only", "paper-0.5b"]) == 0
    recs = {p.name: json.loads(p.read_text()) for p in tmp_path.iterdir()}
    assert sorted(recs) == [f"paper-0.5b__{s}__single.json"
                            for s in ("decode_32k", "prefill_32k",
                                      "train_4k")]
    assert all(r["status"] == "ok" for r in recs.values())
    train = recs["paper-0.5b__train_4k__single.json"]
    assert (train["remat"], train["microbatch"]) == ("2level", 16)
    assert "ok=3 fail=0 skipped=0" in capsys.readouterr().out
    assert dryrun_all.main(["--only", "paper-0.5b"]) == 0
    assert "ok=0 fail=0 skipped=3" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        dryrun_all.main(["--mesh", "multi"])
