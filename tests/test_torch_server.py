"""The port's HTTP front end (``repro_torch.serving.server.ServingServer``):
the cases of tests/test_http_server.py on the port's engine, on an
ephemeral port, in process: /v1/completions (JSON and SSE), cancel on
client disconnect, /v1/cancel, /healthz (503 until warmup ends), /v1/stats,
/metrics (503 without telemetry), clean shutdown. Completions are
token-identical to the JAX engine's greedy output on the same bridged
weights and prompts. Also what the JAX server lacks: an engine thread that
fails releases its waiters and surfaces through /healthz and ``check()``.

Every socket call has a timeout.
"""
import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro.serving import SamplingParams as JaxSampling
from repro.serving import ServingEngine as JaxEngine
from repro_torch.serving import SamplingParams, ServingEngine, torch_profiler
from repro_torch.serving.server import ServingServer
from test_torch_engine import _model

T = 60                       # seconds: every socket call's timeout


def _engine(**kw):
    _, _, tcfg, tp = _model()
    kw.setdefault("block_size", 4)
    return ServingEngine(tp, tcfg, device="cpu", **kw)


@pytest.fixture(scope="module")
def server():
    engine = _engine(max_batch=4, max_seq_len=64, scheduler="priority",
                     telemetry=True)
    srv = ServingServer(engine, port=0).start()
    _, _, cfg, _ = _model()
    yield srv, engine, cfg
    srv.shutdown()
    srv.check()


def _url(srv, path):
    return f"http://{srv.host}:{srv.port}{path}"


def _get(srv, path):
    return json.load(urllib.request.urlopen(_url(srv, path), timeout=T))


def _post(srv, path, payload):
    req = urllib.request.Request(
        _url(srv, path), data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return json.load(urllib.request.urlopen(req, timeout=T))


def _sse_tokens(resp):
    """Parse an SSE stream: ([chunk dicts], [token ids])."""
    chunks, toks = [], []
    while True:
        line = resp.fp.readline()
        assert line, "stream ended without [DONE]"
        line = line.strip()
        if not line.startswith(b"data: "):
            continue
        payload = line[len(b"data: "):]
        if payload == b"[DONE]":
            return chunks, toks
        c = json.loads(payload)
        chunks.append(c)
        toks.extend(c["choices"][0]["token_ids"])


def _stream(srv, payload):
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=T)
    conn.request("POST", "/v1/completions",
                 body=json.dumps({**payload, "stream": True}),
                 headers={"Content-Type": "application/json"})
    return conn, conn.getresponse()


def _until(pred, what, timeout=T):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def test_healthz_and_bad_requests(server):
    srv, engine, cfg = server
    assert _get(srv, "/healthz")["ok"] is True
    for bad in ({}, {"prompt": "text"}, {"prompt": []},
                {"prompt": [1.5, 2]}, {"prompt": [1], "max_tokens": "x"}):
        req = urllib.request.Request(
            _url(srv, "/v1/completions"), data=json.dumps(bad).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=T)
        assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(_url(srv, "/nope"), timeout=T)
    assert e.value.code == 404


def test_completions_match_the_jax_engine(server):
    """Non-streaming HTTP completions return exactly the JAX engine's greedy
    tokens for the same weights and prompts (three requests at once)."""
    srv, engine, cfg = server
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in (8, 13, 5)]
    jp, jcfg, _, _ = _model()
    ref = JaxEngine(jp, jcfg, block_size=4, max_batch=4,
                    max_seq_len=64).generate(prompts, sampling=JaxSampling(),
                                             max_tokens=6)
    import concurrent.futures as cf
    with cf.ThreadPoolExecutor(3) as pool:
        outs = list(pool.map(lambda p: _post(srv, "/v1/completions",
                                             {"prompt": p, "max_tokens": 6}),
                             prompts))
    for out, want, p in zip(outs, ref, prompts):
        assert out["object"] == "text_completion"
        assert out["choices"][0]["token_ids"] == want.token_ids
        assert out["choices"][0]["finish_reason"] == "length"
        assert out["usage"] == {"prompt_tokens": len(p),
                                "completion_tokens": 6}


def test_sse_stream_matches_non_stream(server):
    srv, engine, cfg = server
    prompt = np.random.RandomState(2).randint(0, cfg.vocab_size, 8).tolist()
    ref = _post(srv, "/v1/completions", {"prompt": prompt, "max_tokens": 6})
    conn, resp = _stream(srv, {"prompt": prompt, "max_tokens": 6})
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "text/event-stream"
    chunks, toks = _sse_tokens(resp)
    conn.close()
    assert toks == ref["choices"][0]["token_ids"]
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    assert all(c["choices"][0]["finish_reason"] is None
               for c in chunks[:-1])


def test_disconnect_mid_stream_cancels(server):
    """Dropping the SSE connection cancels the request on the engine: its
    KV blocks free and the cancelled counter advances."""
    srv, engine, cfg = server
    before = engine.cancelled_total
    prompt = np.random.RandomState(3).randint(0, cfg.vocab_size, 8).tolist()
    conn, resp = _stream(srv, {"prompt": prompt, "max_tokens": 48})
    resp.fp.readline()                  # first bytes, then vanish
    resp.close()
    conn.close()
    _until(lambda: engine.cancelled_total > before and not engine.running,
           "the disconnect to cancel")
    engine.kv.check_invariants()


def test_cancel_endpoint(server):
    srv, engine, cfg = server
    prompt = np.random.RandomState(4).randint(0, cfg.vocab_size, 8).tolist()
    h = engine.submit(prompt, sampling=SamplingParams(), max_tokens=48)
    assert _post(srv, "/v1/cancel", {"id": f"cmpl-{h.rid}"})["cancelled"]
    _until(lambda: h.finished, "the cancelled request")
    assert h.result().finish_reason == "cancelled"
    assert _post(srv, "/v1/cancel",
                 {"id": f"cmpl-{h.rid}"})["cancelled"] is False
    assert _post(srv, "/v1/cancel", {"id": "bogus"})["cancelled"] is False


def test_priority_and_sampling_fields_reach_engine(server):
    srv, engine, cfg = server
    prompt = np.random.RandomState(5).randint(0, cfg.vocab_size, 6).tolist()
    body = {"prompt": prompt, "max_tokens": 3, "priority": 1, "seed": 11,
            "temperature": 0.8, "top_k": 8}
    a = _post(srv, "/v1/completions", body)
    b = _post(srv, "/v1/completions", body)
    assert len(a["choices"][0]["token_ids"]) == 3
    assert a["choices"][0]["token_ids"] == b["choices"][0]["token_ids"]
    stats = _get(srv, "/v1/stats")
    assert stats["finished"] >= 2
    assert stats["kv"]["num_blocks"] == engine.kv.num_blocks


def test_metrics_exposition_and_stats(server):
    """GET /metrics returns the Prometheus text of the engine's registry
    (step phases, KV occupancy, prefix-cache traffic, latency histograms,
    per-layer FFN sparsity, FLOPs) and /v1/stats carries the rollups."""
    srv, engine, cfg = server
    prompt = np.random.RandomState(6).randint(0, cfg.vocab_size, 8).tolist()
    _post(srv, "/v1/completions", {"prompt": prompt, "max_tokens": 3})
    resp = urllib.request.urlopen(_url(srv, "/metrics"), timeout=T)
    assert resp.headers["Content-Type"].startswith("text/plain")
    text = resp.read().decode()
    assert "# TYPE serving_step_phase_seconds histogram" in text
    assert 'serving_step_phase_seconds_bucket{phase="decode",le="+Inf"}' \
        in text
    assert 'serving_kv_blocks{state="free"}' in text
    assert "# TYPE serving_prefix_tokens_total counter" in text
    assert 'serving_ttft_seconds_count{priority="0",role="unified"}' in text
    assert 'serving_ffn_sparsity{layer="0"}' in text
    assert f'serving_ffn_sparsity{{layer="{cfg.num_layers - 1}"}}' in text
    assert "# TYPE serving_effective_flops_total counter" in text
    assert 'attn_backend="plain"' in text
    for line in text.splitlines():
        if line.startswith("serving_requests_total") and "finished" in line:
            assert float(line.split()[-1]) == engine.finished_total
    stats = _get(srv, "/v1/stats")
    tm = stats["telemetry"]
    assert tm["steps"] == pytest.approx(engine._step_idx)
    assert "decode" in tm["phases_ms_mean"]
    assert tm["jit_compiles"]["decode"] >= 1
    sp = stats["sparsity"]
    assert 0.0 <= sp["mean_ffn_sparsity"] <= 1.0
    assert sp["flops_reduction"] is not None and sp["mfu"] >= 0.0
    full = tm["sparsity"]
    assert len(full["per_layer_sparsity"]) == cfg.num_layers
    assert full["dense_flops_total"] >= full["effective_flops_total"] > 0


def test_concurrent_clients_stress(server):
    """16 clients at once, more threads than cores, half over SSE, with a
    short interpreter switch interval: every completion has its tokens
    (equal to the same engine's in-process greedy output), the counters
    add up, and the pool is consistent after the drain."""
    import concurrent.futures as cf
    import sys
    srv, engine, cfg = server
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, cfg.vocab_size, rng.randint(3, 14)).tolist()
               for _ in range(16)]
    ref = _engine(max_batch=4, max_seq_len=64).generate(prompts,
                                                        max_tokens=5)
    tm = engine.telemetry.metrics
    tokens0, finished0 = tm.tokens_total.value(), engine.finished_total

    def call(i):
        if i % 2:
            conn, resp = _stream(srv, {"prompt": prompts[i],
                                       "max_tokens": 5})
            try:
                return _sse_tokens(resp)[1]
            finally:
                conn.close()
        return _post(srv, "/v1/completions", {
            "prompt": prompts[i], "max_tokens": 5})["choices"][0]["token_ids"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with cf.ThreadPoolExecutor(16) as pool:
            got = [f.result(timeout=T) for f in
                   [pool.submit(call, i) for i in range(16)]]
    finally:
        sys.setswitchinterval(interval)
    assert got == [o.token_ids for o in ref]
    _until(lambda: not engine.has_unfinished(), "the drain")
    assert engine.finished_total - finished0 == 16
    assert tm.tokens_total.value() - tokens0 == 80
    engine.kv.check_invariants()
    assert engine._reserved == 0
    srv.check()


def test_warmup_gates_healthz_then_serves_graph_free():
    """With warmup=True the engine thread makes every program before
    serving: /healthz answers 503 until then, 200 after, and serving makes
    no program."""
    engine = _engine(max_batch=2, max_seq_len=32, pipeline=True,
                     telemetry=True)
    gate = []
    real = engine.warmup

    def slow_warmup():
        while not gate:
            time.sleep(0.01)
        return real()
    engine.warmup = slow_warmup
    srv = ServingServer(engine, port=0, warmup=True).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(_url(srv, "/healthz"), timeout=T)
        assert e.value.code == 503
        assert json.load(e.value)["warming_up"] is True
        gate.append(1)
        assert srv.wait_ready(timeout=T)
        assert _get(srv, "/healthz")["ok"] is True
        made = dict(engine.programs.made)
        out = _post(srv, "/v1/completions", {"prompt": [1, 2, 3, 4, 5],
                                             "max_tokens": 4})
        assert len(out["choices"][0]["token_ids"]) == 4
        assert dict(engine.programs.made) == made
        assert _get(srv, "/v1/stats")["telemetry"]["warmup_seconds"] > 0
    finally:
        srv.shutdown()
    srv.check()


def test_engine_thread_failure_is_not_hidden():
    engine = _engine(max_batch=2, max_seq_len=32)

    def broken():
        raise ValueError("step failed")
    engine.step = broken
    srv = ServingServer(engine, port=0).start()
    try:
        req = urllib.request.Request(
            _url(srv, "/v1/completions"),
            data=json.dumps({"prompt": [1, 2, 3], "max_tokens": 2}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=T)
        assert e.value.code == 503
        assert "step failed" in json.load(e.value)["error"]
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(_url(srv, "/healthz"), timeout=T)
        assert e.value.code == 503
        assert not srv.wait_ready(timeout=1)
    finally:
        srv.shutdown()
    with pytest.raises(RuntimeError, match="engine thread failed"):
        srv.check()
    assert isinstance(srv.error, ValueError)


def test_metrics_503_when_disabled():
    engine = _engine(max_batch=2, max_seq_len=32)
    srv = ServingServer(engine, port=0).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(_url(srv, "/metrics"), timeout=T)
        assert e.value.code == 503
        stats = _get(srv, "/v1/stats")
        assert "telemetry" not in stats and "sparsity" not in stats
    finally:
        srv.shutdown()


def test_shutdown_is_clean():
    engine = _engine(max_batch=2, max_seq_len=32, pipeline=True)
    flushed_on = []
    real_flush = engine.flush

    def flush():
        flushed_on.append(threading.current_thread().name)
        return real_flush()
    engine.flush = flush
    srv = ServingServer(engine, port=0).start()
    _post(srv, "/v1/completions", {"prompt": list(range(1, 7)),
                                   "max_tokens": 2})
    srv.shutdown()
    for t in srv._threads:
        assert not t.is_alive()
    assert flushed_on == ["engine-loop"]      # the engine's own thread
    srv.check()
    assert engine._inflight is None
    engine.kv.check_invariants()
    with pytest.raises(Exception):
        urllib.request.urlopen(_url(srv, "/healthz"), timeout=2)


def test_shutdown_raises_while_the_engine_thread_runs():
    """A shutdown whose join times out (here: during a slow warmup) raises
    instead of flushing the engine beside its still-running thread; once
    the thread ends, shutdown completes and the flush ran on that
    thread."""
    engine = _engine(max_batch=2, max_seq_len=32, pipeline=True)
    gate, flushed_on = [], []
    real_warmup, real_flush = engine.warmup, engine.flush

    def slow_warmup():
        while not gate:
            time.sleep(0.01)
        return real_warmup()

    def flush():
        flushed_on.append(threading.current_thread().name)
        return real_flush()
    engine.warmup, engine.flush = slow_warmup, flush
    srv = ServingServer(engine, port=0, warmup=True).start()
    with pytest.raises(RuntimeError, match="still running"):
        srv.shutdown(timeout=0.2)
    assert flushed_on == []
    gate.append(1)
    srv.shutdown(timeout=T)
    assert flushed_on == ["engine-loop"]
    srv.check()


def test_profile_is_held_by_the_engine_thread(tmp_path):
    """``profile`` is entered on the engine thread, so torch.profiler
    records the ops of the steps (a profiler started on another thread
    records none of them) and writes its trace at shutdown."""
    entered_on = []

    def profile():
        entered_on.append(threading.current_thread().name)
        return torch_profiler(str(tmp_path), "cpu")
    engine = _engine(max_batch=2, max_seq_len=32)
    srv = ServingServer(engine, port=0, profile=profile).start()
    try:
        out = _post(srv, "/v1/completions", {"prompt": [1, 2, 3, 4, 5],
                                             "max_tokens": 3})
        assert len(out["choices"][0]["token_ids"]) == 3
    finally:
        srv.shutdown()
    srv.check()
    assert entered_on == ["engine-loop"]
    doc = json.loads((tmp_path / "torch_trace.json").read_text())
    ops = [e["name"] for e in doc["traceEvents"]
           if e.get("cat") == "cpu_op"]
    assert any(n.startswith("aten::") for n in ops), ops[:20]
