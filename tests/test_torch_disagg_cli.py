"""The serve CLI's ``--disagg`` and ``--transfer-ttl`` (``repro_torch.launch.
serve``), on the CPU.

- In process: ``--disagg --check-static`` (the coordinator's greedy tokens
  against the static loop, as the JAX CLI checks them), zero prefill
  tokens on the decode engine; ``--disagg`` with speculation and seeded
  sampling gives the unified CLI's tokens; ``--disagg --pipeline`` exits
  with the JAX CLI's message.
- One subprocess boot of ``--disagg --http --port 0 --warmup``: concurrent
  completions (one over SSE), ``/v1/stats`` with its ``roles`` section,
  ``/metrics`` with both roles' series, then SIGINT and a clean exit.

Every socket call and the subprocess have timeouts.
"""
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]
T = 60                       # seconds: the limit of every HTTP call


def test_cli_disagg_check_static(capsys):
    outs = serve.main(["--reduced", "--device", "cpu", "--disagg",
                       "--batch", "3", "--prompt-len", "9", "--gen", "5",
                       "--check-static", "--block-size", "4",
                       "--prefill-chunk", "8", "--max-batch", "2",
                       "--transfer-ttl", "3", "--scheduler", "priority",
                       "--warmup"])
    out = capsys.readouterr().out
    assert "static-loop agreement: 100.00%" in out
    assert "decode-side prefill tokens 0" in out
    assert "warmup:" in out and "'decode': {" in out
    assert len(outs) == 3 and all(len(o.token_ids) == 5 for o in outs)
    assert {o.role for o in outs} == {"decode"}
    assert all(o.migrated_blocks > 0 for o in outs)


def test_cli_disagg_spec_sampled_equals_unified(capsys):
    args = ["--reduced", "--device", "cpu", "--batch", "3", "--prompt-len",
            "8", "--gen", "6", "--spec-k", "2", "--temperature", "0.8",
            "--top-k", "20", "--backend", "dense", "--metrics"]
    unified = serve.main(args)
    disagg = serve.main(args + ["--disagg"])
    out = capsys.readouterr().out
    assert [o.token_ids for o in disagg] == [o.token_ids for o in unified]
    assert out.count("spec k=2") == 2 and "disagg:" in out


def test_cli_disagg_refuses_pipeline():
    with pytest.raises(SystemExit, match="drop --pipeline"):
        serve.main(["--reduced", "--device", "cpu", "--disagg",
                    "--pipeline", "--batch", "1", "--gen", "2"])


def _read_lines(stream, out):
    for line in stream:
        out.put(line)
    out.put(None)


def _complete(port, payload):
    """One completion; the token ids (an SSE stream read to [DONE])."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=T)
    try:
        conn.request("POST", "/v1/completions", body=json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        if not payload.get("stream"):
            return json.loads(resp.read())["choices"][0]["token_ids"]
        toks = []
        while True:
            line = resp.fp.readline()
            assert line, "stream ended without [DONE]"
            if not line.startswith(b"data: "):
                continue
            body = line.strip()[len(b"data: "):]
            if body == b"[DONE]":
                return toks
            toks.extend(json.loads(body)["choices"][0]["token_ids"])
    finally:
        conn.close()


def test_cli_disagg_http_subprocess():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
           "--device", "cpu", "--disagg", "--http", "--port", "0",
           "--warmup", "--prompt-len", "16", "--gen", "24",
           "--max-batch", "2", "--transfer-ttl", "8"]
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
        assert "disagg=prefill+decode" in seen[-1]
        base = f"http://127.0.0.1:{port}"
        assert json.load(urllib.request.urlopen(base + "/healthz",
                                                timeout=T))["ok"] is True
        payloads = [{"prompt": list(range(1 + i, 9 + 2 * i)),
                     "max_tokens": 5 + i, "stream": i % 2 == 1}
                    for i in range(3)]
        with ThreadPoolExecutor(3) as pool:
            toks = list(pool.map(lambda p: _complete(port, p), payloads))
        assert [len(t) for t in toks] == [5, 6, 7]
        stats = json.load(urllib.request.urlopen(base + "/v1/stats",
                                                 timeout=T))
        roles = stats["roles"]
        assert set(roles) == {"prefill", "decode", "transfer"}
        assert roles["decode"]["prefill_tokens_total"] == 0
        assert roles["decode"]["migrated_blocks_total"] > 0
        assert roles["transfer"]["claimed_total"] == 3
        assert roles["transfer"]["ttl_steps"] == 8
        assert stats["finished"] == 3
        metrics = urllib.request.urlopen(base + "/metrics",
                                         timeout=T).read().decode()
        for role in ("prefill", "decode"):
            assert f'role="{role}"' in metrics
        migrated = [ln for ln in metrics.splitlines() if ln.startswith(
            'serving_kv_migrated_blocks_total{role="decode"}')]
        assert migrated and float(migrated[0].split()[-1]) > 0
        assert "serving_transfer_buffer_entries 0" in metrics
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
