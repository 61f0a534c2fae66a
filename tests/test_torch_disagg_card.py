"""The serve CLI's ``--disagg --http`` on the card, at paper-0.5b's full width
and depth (random weights from ``--seed``), as a user starts it: a prefill
engine and a decode engine, each with its own KV pool and CUDA graphs,
behind one ``DisaggCoordinator`` and the HTTP server.

Warmed up (``--warmup``: both engines' programs captured), four
concurrent completions (two over SSE), a fifth stream dropped after two
chunks and cancelled; ``/v1/stats`` carries the ``roles`` section
(prefill, decode, the transfer buffer) with zero prefill tokens on the
decode engine; ``/metrics`` carries both roles' series and
``serving_kv_migrated_blocks_total`` above 0; SIGINT, a clean exit.

Marked ``cuda``: the test skips without an NVIDIA card. It prints one
JSON line of what it read. On the machine with the card, from the repo
root:

    PYTHONPATH=src python -m pytest -q -s -m cuda tests/test_torch_disagg_card.py

Every socket call and the subprocess have a timeout.
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
BOOT = 900               # seconds: build, weights and both engines' warmup
PROMPT, GEN, BATCH = 32, 200, 4
MAX_TOKENS = 16          # each completion's; GEN sizes the pools (and
DROPPED = 190            # leaves the dropped stream room to outlive its drop)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def _read_lines(stream, out):
    for line in stream:
        out.put(line)
    out.put(None)


def _post(port, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=T)
    conn.request("POST", "/v1/completions", body=json.dumps(payload),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200, resp.status
    return conn, resp


def _chunks(resp):
    """The token ids of each SSE chunk, up to [DONE]."""
    while True:
        line = resp.fp.readline()
        assert line, "stream ended without [DONE]"
        if not line.startswith(b"data: "):
            continue
        payload = line.strip()[len(b"data: "):]
        if payload == b"[DONE]":
            return
        yield json.loads(payload)["choices"][0]["token_ids"]


def _complete(port, prompt, stream):
    conn, resp = _post(port, {"prompt": prompt, "max_tokens": MAX_TOKENS,
                              "stream": stream})
    try:
        if not stream:
            return json.load(resp)["choices"][0]["token_ids"]
        return [t for chunk in _chunks(resp) for t in chunk]
    finally:
        conn.close()


def _json(base, path):
    return json.load(urllib.request.urlopen(base + path, timeout=T))


def test_cli_disagg_http_on_card(card):
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "paper-0.5b", "--disagg", "--http", "--warmup", "--port", "0",
         "--prompt-len", str(PROMPT), "--gen", str(GEN), "--batch",
         str(BATCH)],
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
        assert "disagg=prefill+decode" in seen[-1], seen[-1]
        base = f"http://127.0.0.1:{port}"
        assert _json(base, "/healthz")["ok"] is True
        rng = np.random.RandomState(1)
        prompts = [rng.randint(0, 32000, PROMPT).tolist()
                   for _ in range(BATCH)]
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(BATCH) as pool:
            futs = [pool.submit(_complete, port, p, i % 2 == 1)
                    for i, p in enumerate(prompts)]
            toks = [f.result(timeout=T) for f in futs]
        got["wall_s"] = time.perf_counter() - t0
        assert [len(t) for t in toks] == [MAX_TOKENS] * BATCH
        # a stream dropped after two chunks: the server cancels it
        conn, resp = _post(port, {"prompt": prompts[0][:8],
                                  "max_tokens": DROPPED, "stream": True})
        chunks = _chunks(resp)
        got["dropped_after"] = [len(next(chunks)), len(next(chunks))]
        resp.close()
        conn.close()
        deadline = time.time() + T
        while _json(base, "/v1/stats")["cancelled"] < 1:
            assert time.time() < deadline, "the dropped stream ran on"
            time.sleep(0.2)
        stats = _json(base, "/v1/stats")
        roles = stats["roles"]
        assert set(roles) == {"prefill", "decode", "transfer"}, roles
        assert roles["decode"]["prefill_tokens_total"] == 0
        assert roles["decode"]["migrated_blocks_total"] > 0
        assert roles["transfer"]["entries"] == 0
        assert stats["finished"] == BATCH and stats["cancelled"] == 1
        got["roles"] = roles
        got["jit_compiles"] = stats["telemetry"]["jit_compiles"]
        metrics = urllib.request.urlopen(base + "/metrics",
                                         timeout=T).read().decode()
        for role in ("prefill", "decode"):
            assert f'role="{role}"' in metrics, role
        migrated = [ln for ln in metrics.splitlines() if ln.startswith(
            'serving_kv_migrated_blocks_total{role="decode"}')]
        assert migrated and float(migrated[0].split()[-1]) > 0, migrated
        got["kv_migrated_blocks_total"] = float(migrated[0].split()[-1])
        got["role_series"] = sorted({ln.split("{")[0] for ln in
                                     metrics.splitlines()
                                     if 'role="' in ln})
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
    print(json.dumps({"test": "cli_disagg_http", **got,
                      "cli": [ln.strip() for ln in seen
                              if ln.startswith("[serve")]}), flush=True)
