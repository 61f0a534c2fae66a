"""The port's serve CLI (``repro_torch.launch.serve``) and its static
reference loop, on the CPU.

- ``generate`` (``lm.init_cache`` + ``lm.decode_step``, the monolithic
  cache) against JAX's ``repro.launch.serve.generate`` on the same bridged
  weights and prompts: greedy and seeded top-k sampling give identical
  tokens (threefry split + Gumbel bit for bit), for the dense and gather
  FFN; ``decode_step``'s logits within 1e-4.
- ``main`` in process: ``--check-static``, ``--trace-out``, ``--metrics``,
  ``--no-prefix-cache``, ``--scheduler priority``, ``--static``.
- One subprocess boot of ``--http --port 0 --torch-profile``: one
  streamed completion, then SIGINT, a clean exit (as tests/http_smoke.py
  does for JAX) and the engine thread's ops in the profiler's trace.
- The CLI's near-tie rule against chip_smoke.py's own copy.

Every socket call and the subprocess have timeouts.
"""
import dataclasses
import http.client
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro_torch import random as trandom
from repro_torch.launch import serve
from repro_torch.models import lm
from test_torch_engine import _model

ROOT = Path(__file__).resolve().parents[1]


def _cfgs(ffn_impl):
    jp, jcfg, tcfg, tp = _model()
    jcfg, tcfg = [dataclasses.replace(c, sparsity=dataclasses.replace(
        c.sparsity, ffn_impl=ffn_impl, twell_c=1)) for c in (jcfg, tcfg)]
    return jp, jcfg, tcfg, tp


def _prompt(b, p, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, p)).astype(
        np.int32)


def test_decode_step_logits_match_jax():
    jp, jcfg, tcfg, tp = _cfgs("dense")
    toks = _prompt(3, 6, seed=1)
    jc = jlm.init_cache(jcfg, 3, 8)
    tc = lm.init_cache(tcfg, 3, 8, device="cpu")
    worst = 0.0
    for i in range(toks.shape[1]):
        jl, jc = jlm.decode_step(jp, jc, jnp.asarray(toks[:, i:i + 1]), jcfg)
        tl, tc = lm.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]),
                                tcfg)
        worst = max(worst, float(np.abs(np.asarray(jl) -
                                        tl.numpy()).max()))
    assert worst <= 1e-4, worst
    assert tc["pos"] == int(jc["pos"]) == 6
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               atol=1e-5)
    with pytest.raises(ValueError, match="cache full"):
        for _ in range(3):
            lm.decode_step(tp, tc, torch.zeros((3, 1), dtype=torch.int64),
                           tcfg)


CASES = [("dense", True, 0, 1.0), ("gather", True, 0, 1.0),
         ("dense", False, 8, 0.8), ("gather", False, 0, 1.3)]


@pytest.mark.parametrize("ffn_impl,greedy,top_k,temperature", CASES,
                         ids=["dense-greedy", "gather-greedy",
                              "dense-top_k8", "gather-sampled"])
def test_static_generate_equals_jax(ffn_impl, greedy, top_k, temperature):
    jp, jcfg, tcfg, tp = _cfgs(ffn_impl)
    prompt = _prompt(3, 7, seed=2)
    want = np.asarray(jserve.generate(
        jp, jcfg, jnp.asarray(prompt), 6, cache_len=14, greedy=greedy,
        key=jax.random.PRNGKey(5), top_k=top_k, temperature=temperature))
    got = serve.generate(tp, tcfg, torch.from_numpy(prompt).long(), 6, 14,
                         greedy=greedy, key=trandom.PRNGKey(5), top_k=top_k,
                         temperature=temperature)
    np.testing.assert_array_equal(got.numpy(), want)
    if not greedy:       # the draws matter: another key samples otherwise
        other = serve.generate(tp, tcfg, torch.from_numpy(prompt).long(), 6,
                               14, greedy=False, key=trandom.PRNGKey(6),
                               top_k=top_k, temperature=temperature)
        assert not torch.equal(other, got)


def test_first_near_ties():
    lg = [torch.tensor([[0.0, 1.0, 5.0], [2.0, 2.05, 0.0]]),
          torch.tensor([[3.0, 3.0, 0.0], [0.0, 1.0, 9.0]])]
    assert serve.first_near_ties(lg, tol=0.1) == [1, 0]
    assert serve.first_near_ties(lg[:1], tol=0.01) == [1, 1]


def test_first_near_ties_is_chip_smokes_rule():
    """The CLI's near-tie rule equals chip_smoke.py's own copy, which its
    serving phases compare tokens by: random logits with ties planted at
    the tolerance's float32 boundary, just under and just over it."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    tol = np.float32(smoke.LOGIT_TOL)
    assert serve.LOGIT_TOL == smoke.LOGIT_TOL
    rng = np.random.RandomState(0)
    # every row's values 1 apart (no tie), then the top two planted: 0.125
    # less float32(0.1) is exact, so that gap is the tolerance itself
    lg = -1 - np.stack([np.stack([rng.permutation(13) for _ in range(9)])
                        for _ in range(6)]).astype(np.float32)
    for i, j, gap in [(0, 2, tol), (1, 0, np.nextafter(tol, np.float32(1))),
                      (2, 8, np.float32(0)), (3, 4, np.float32(0.2)),
                      (4, 5, np.nextafter(tol, np.float32(0))),
                      (4, 7, tol)]:
        lg[i, j, 3] = np.float32(0.125)
        lg[i, j, 7] = np.float32(0.125) - gap
    assert lg[0, 2, 3] - lg[0, 2, 7] == tol
    want = smoke.first_near_ties(torch, [
        types.SimpleNamespace(logits=list(row)) for row in lg])
    got = serve.first_near_ties([torch.from_numpy(lg[:, j])
                                 for j in range(lg.shape[1])])
    assert got == want
    assert want == [9, 9, 8, 9, 5, 9]


def test_cli_check_static_trace_metrics(tmp_path, capsys):
    trace = tmp_path / "serve.trace.json"
    outs = serve.main(["--reduced", "--device", "cpu", "--batch", "3",
                       "--prompt-len", "9", "--gen", "5", "--check-static",
                       "--trace-out", str(trace), "--block-size", "4",
                       "--prefill-chunk", "8", "--max-batch", "2",
                       "--pipeline", "--warmup"])
    out = capsys.readouterr().out
    assert "static-loop agreement: 100.00%" in out
    assert "phase ms/step" in out and "warmup:" in out
    assert len(outs) == 3 and all(len(o.token_ids) == 5 for o in outs)
    doc = json.loads(trace.read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"plan", "launch", "collect", "QUEUED", "PREFILL", "DECODE",
            "FINISH"} <= names


def test_cli_priority_no_prefix_cache_metrics_spec(capsys):
    outs = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4", "--metrics",
                       "--no-prefix-cache", "--scheduler", "priority",
                       "--spec-k", "2", "--check-static",
                       "--backend", "dense"])
    out = capsys.readouterr().out
    assert "static-loop agreement: 100.00%" in out
    assert "spec k=2" in out and "phase ms/step" in out
    assert "prefix cache" not in out
    assert [len(o.token_ids) for o in outs] == [4, 4]


def test_cli_static_mode(capsys):
    toks = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "5", "--gen", "3", "--static",
                       "--temperature", "0.7", "--top-k", "5"])
    assert tuple(toks.shape) == (2, 8)
    assert "[serve/static]" in capsys.readouterr().out


def _read_lines(stream, out):
    for line in stream:
        out.put(line)
    out.put(None)


def test_http_subprocess_boot_and_sigint(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
           "--device", "cpu", "--http", "--port", "0", "--prompt-len", "16",
           "--gen", "24", "--scheduler", "priority", "--max-batch", "2",
           "--torch-profile", str(tmp_path)]
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=_read_lines, args=(proc.stdout, lines),
                     daemon=True).start()
    seen = []
    try:
        port = None
        deadline = time.time() + 120
        while port is None:
            line = lines.get(timeout=max(1.0, deadline - time.time()))
            assert line is not None, f"server died early: {seen}"
            seen.append(line)
            if "listening on http://" in line:
                port = int(line.split("http://")[1].split()[0].rsplit(
                    ":", 1)[1])
        assert any("[serve/warmup]" in ln for ln in seen), seen
        base = f"http://127.0.0.1:{port}"
        assert json.load(urllib.request.urlopen(base + "/healthz",
                                                timeout=30))["ok"] is True
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v1/completions",
                     body=json.dumps({"prompt": list(range(1, 9)),
                                      "max_tokens": 6, "stream": True}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        toks = []
        while True:
            line = resp.fp.readline()
            assert line, "stream ended without [DONE]"
            if not line.startswith(b"data: "):
                continue
            payload = line.strip()[len(b"data: "):]
            if payload == b"[DONE]":
                break
            toks.extend(json.loads(payload)["choices"][0]["token_ids"])
        conn.close()
        assert len(toks) == 6
        metrics = urllib.request.urlopen(base + "/metrics",
                                         timeout=30).read().decode()
        assert "serving_tokens_generated_total 6" in metrics
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
    while True:
        line = lines.get(timeout=10)
        if line is None:
            break
        seen.append(line)
    out = "".join(seen)
    assert proc.returncode == 0, out[-2000:]
    assert "clean shutdown" in out, out[-2000:]
    # the engine thread held the profiler: the steps' ops are in its trace
    doc = json.loads((tmp_path / "torch_trace.json").read_text())
    assert any(e.get("cat") == "cpu_op" and e["name"].startswith("aten::")
               for e in doc["traceEvents"])
