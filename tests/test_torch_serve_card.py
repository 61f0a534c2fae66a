"""The port's serve CLI on the card, at paper-0.5b's full width and depth
(random weights from ``--seed``), each run a subprocess as a user starts it:

- ``--http --torch-profile DIR --trace-out PATH``: warmed up (every step
  program a CUDA graph), four concurrent completions (two over SSE), then
  SIGINT and a clean exit; the engine thread's profiler trace holds the
  card's kernels, the graph launches and the engine thread's ops, and the
  Chrome trace one track a request.
- the batch run with ``--pipeline --warmup --metrics --check-static
  --torch-profile DIR``, on the gather (TwELL) and dense FFN and on the
  reduced config: the engine's tokens against the static loop's up to
  each row's first near-tie (the CLI asserts it), the profiler's trace
  holding the card's kernels. The CLI's weights are ``lm.init``'s: at
  full width more of a gate tile is positive than TwELL's T/C slots hold
  (the live sparsity reads 1 - C/T), so the gather case runs with its
  tiles overflowing, the columns past the slots dropped (the CLI says
  so, and names it when the check fails).

Marked ``cuda``: each test skips without an NVIDIA card. Each prints one
JSON line of what it read. On the machine with the card, from the repo
root:

    PYTHONPATH=src python -m pytest -q -s -m cuda tests/test_torch_serve_card.py

Every socket call and subprocess has a timeout.
"""
import concurrent.futures as cf
import http.client
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
T = 120                  # seconds: every socket call's timeout
BOOT = 900               # seconds: build, weights and warmup of a CLI run
PROMPT, GEN, BATCH = 32, 16, 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def _cli(*args):
    return [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            "paper-0.5b", "--prompt-len", str(PROMPT), "--gen", str(GEN),
            "--batch", str(BATCH), *args]


def _read_lines(stream, out):
    for line in stream:
        out.put(line)
    out.put(None)


def _trace_counts(path):
    """Device kernels, CUDA graph launches and the host's ops of a
    torch.profiler Chrome trace, and its size in bytes."""
    doc = json.loads(path.read_text())
    ev = doc["traceEvents"]
    return {"kernels": sum(e.get("cat") == "kernel" for e in ev),
            "graph_launches": sum(e.get("cat") == "cuda_runtime" and
                                  e["name"] == "cudaGraphLaunch"
                                  for e in ev),
            "cpu_ops": sum(e.get("cat") == "cpu_op" for e in ev),
            "bytes": path.stat().st_size}


def _complete(port, prompt, stream):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=T)
    try:
        conn.request("POST", "/v1/completions",
                     body=json.dumps({"prompt": prompt, "max_tokens": GEN,
                                      "stream": stream}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200, resp.status
        if not stream:
            return json.load(resp)["choices"][0]["token_ids"]
        toks = []
        while True:
            line = resp.fp.readline()
            assert line, "stream ended without [DONE]"
            if not line.startswith(b"data: "):
                continue
            payload = line.strip()[len(b"data: "):]
            if payload == b"[DONE]":
                return toks
            toks.extend(json.loads(payload)["choices"][0]["token_ids"])
    finally:
        conn.close()


def test_cli_http_with_profile_on_card(card, tmp_path):
    prof, trace = tmp_path / "prof", tmp_path / "serve.trace.json"
    proc = subprocess.Popen(
        _cli("--http", "--port", "0", "--torch-profile", str(prof),
             "--trace-out", str(trace)),
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=_read_lines, args=(proc.stdout, lines),
                     daemon=True).start()
    seen, got = [], {}
    try:
        port, deadline = None, time.time() + BOOT
        while port is None:
            line = lines.get(timeout=max(1.0, deadline - time.time()))
            assert line is not None, f"server died early: {seen}"
            seen.append(line)
            if "listening on http://" in line:
                port = int(line.split("http://")[1].split()[0].rsplit(
                    ":", 1)[1])
        base = f"http://127.0.0.1:{port}"
        assert json.load(urllib.request.urlopen(base + "/healthz",
                                                timeout=T))["ok"] is True
        rng = np.random.RandomState(1)
        prompts = [rng.randint(0, 32000, PROMPT).tolist()
                   for _ in range(BATCH)]
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(BATCH) as pool:
            futs = [pool.submit(_complete, port, p, i % 2 == 1)
                    for i, p in enumerate(prompts)]
            toks = [f.result(timeout=T) for f in futs]
        got["wall_s"] = time.perf_counter() - t0
        assert [len(t) for t in toks] == [GEN] * BATCH
        metrics = urllib.request.urlopen(base + "/metrics",
                                         timeout=T).read().decode()
        assert f"serving_tokens_generated_total {BATCH * GEN}" in metrics
        stats = json.load(urllib.request.urlopen(base + "/v1/stats",
                                                 timeout=T))
        got["mean_ffn_sparsity"] = stats["sparsity"]["mean_ffn_sparsity"]
        got["jit_compiles"] = stats["telemetry"]["jit_compiles"]
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=T)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
    while True:
        line = lines.get(timeout=10)
        if line is None:
            break
        seen.append(line)
    out = "".join(seen)
    assert proc.returncode == 0, out[-3000:]
    assert "clean shutdown" in out, out[-3000:]
    counts = _trace_counts(prof / "torch_trace.json")
    assert counts["kernels"] > 0 and counts["graph_launches"] > 0 and \
        counts["cpu_ops"] > 0, counts
    doc = json.loads(trace.read_text())
    tracks = {e["tid"] for e in doc["traceEvents"]
              if e["ph"] != "M" and e["tid"] > 0}
    assert len(tracks) == BATCH, tracks
    print(json.dumps({"test": "cli_http_with_profile", **got,
                      "torch_trace": counts,
                      "cli": [ln.strip() for ln in seen
                              if ln.startswith("[serve")]}), flush=True)


@pytest.mark.parametrize("extra", [[], ["--backend", "dense"],
                                   ["--reduced"]],
                         ids=["gather", "dense", "reduced-gather"])
def test_cli_check_static_on_card(card, tmp_path, extra):
    prof = tmp_path / "prof"
    run = subprocess.run(
        _cli("--pipeline", "--warmup", "--metrics", "--check-static",
             "--torch-profile", str(prof), *extra),
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=BOOT)
    assert run.returncode == 0, run.stdout[-3000:]
    assert "static loop: equal up to the first near-tie in every row" in \
        run.stdout, run.stdout[-3000:]
    counts = _trace_counts(prof / "torch_trace.json")
    assert counts["kernels"] > 0, counts
    print(json.dumps({"test": "cli_check_static", "args": extra,
                      "torch_trace": counts,
                      "cli": [ln.strip() for ln in run.stdout.splitlines()
                              if ln.startswith("[serve")]}), flush=True)
