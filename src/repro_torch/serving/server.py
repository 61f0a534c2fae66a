"""OpenAI-style HTTP front end over the serving engine (stdlib only).

Ports ``repro/serving/server.py``: the same endpoints, bodies and SSE
framing. One engine thread drives ``engine.step()`` whenever work exists;
handler threads (``ThreadingHTTPServer``) talk to it exclusively through
the thread-safe handle API (``submit`` / ``RequestHandle`` / ``cancel``)
and a per-step condition variable the engine loop notifies, so no handler
ever polls a hot loop.

On the card every CUDA call is the engine thread's: ``warmup()`` (which
captures the step programs' CUDA graphs), each step's replays and host
copies, and the ``flush()`` that ends its loop at shutdown (``shutdown()``
raises if the thread is still running after its timeout, rather than
touch the engine beside it). A profiler (``profile``) is entered on that
thread too, since ``torch.profiler`` records the ops of the thread that
started it. Handler threads touch no CUDA: ``submit``
and ``cancel`` are host-only bookkeeping, and the engine names its device
on every tensor it makes, so nothing depends on a thread's current device
or stream. An exception in the engine thread is kept (``error``): waiting
handlers are released, ``/healthz`` answers 503 from then on, and
``check()`` raises it in the caller.

Endpoints:

  POST /v1/completions     {"prompt": [token ids], "max_tokens", "stream",
                            "temperature", "top_k", "top_p", "seed",
                            "priority", "eos_token_id"}
                           Non-streaming: one JSON body when finished.
                           ``"stream": true``: Server-Sent Events — one
                           ``data: {...}`` chunk per engine step that
                           committed tokens, a final chunk carrying
                           ``finish_reason``, then ``data: [DONE]``.
                           A client disconnect mid-stream cancels the
                           request (its KV blocks free on the next step).
  POST /v1/cancel          {"id": "cmpl-<rid>"} -> {"cancelled": bool}
  GET  /healthz            liveness + queue depths; 503 until the startup
                           warmup (when enabled) has made every program
  GET  /v1/stats           engine counters (finished/cancelled/preempted,
                           KV-pool picture) + a telemetry rollup (phase
                           timing means, cache hit rate, spec acceptance,
                           programs made) when the engine has telemetry;
                           behind ``--disagg`` a ``roles`` section adds the
                           per-role engine + transfer-buffer picture
  GET  /metrics            Prometheus text exposition of the engine's
                           metrics registry (step-phase histograms, KV
                           occupancy gauges, TTFT/ITL histograms, ...);
                           503 when the engine was built without telemetry

The repo has no tokenizer: prompts are token-id lists, and completions
return ``token_ids`` (an OpenAI-shaped envelope, not a drop-in clone).
"""
from __future__ import annotations

import contextlib
import json
import select
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, ContextManager, Optional

from repro_torch.serving.sampling import SamplingParams


def _completion_chunk(rid: int, tokens, finish_reason: Optional[str]):
    return {"id": f"cmpl-{rid}", "object": "text_completion.chunk",
            "choices": [{"index": 0, "token_ids": list(tokens),
                         "finish_reason": finish_reason}]}


class ServingServer:
    """HTTP server + engine-stepping thread over one ``ServingEngine``."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8000,
                 idle_wait_s: float = 0.05, warmup: bool = False,
                 profile: Optional[Callable[[], ContextManager]] = None):
        self.engine = engine
        self.idle_wait_s = idle_wait_s
        # entered by the engine thread around its serving loop (after the
        # warmup), e.g. ``lambda: torch_profiler(logdir, device)``
        self._profile = profile or contextlib.nullcontext
        self._work = threading.Event()        # submissions wake the loop
        self._stepped = threading.Condition() # notified after every step
        self._step_seq = 0                    # steps completed (under cond)
        self._stop = threading.Event()
        # readiness gate: with warmup=True the engine thread makes every
        # program of the bucket grid (on the card: captures its CUDA graphs)
        # before serving, and /healthz answers 503 until that finishes so
        # load balancers don't route to a cold process
        self._warmup = bool(warmup)
        self._ready = threading.Event()
        self.error: Optional[BaseException] = None   # the engine thread's
        if not self._warmup:
            self._ready.set()
        engine.on_new_work = self._work.set
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):   # quiet by default
                pass

            def _json(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    h = server.health()
                    self._json(200 if h["ok"] else 503, h)
                elif self.path == "/v1/stats":
                    self._json(200, server.stats())
                elif self.path == "/metrics":
                    self._metrics()
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def _metrics(self):
                tm = server.engine.telemetry
                if tm is None:
                    self._json(503, {"error": "telemetry disabled: build "
                                              "the engine with "
                                              "telemetry=True (the serve "
                                              "CLI's --http enables it "
                                              "unless --no-metrics)"})
                    return
                body = tm.registry.render_prometheus().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, json.JSONDecodeError) as e:
                    self._json(400, {"error": f"bad JSON: {e}"})
                    return
                if self.path == "/v1/completions":
                    self._completions(body)
                elif self.path == "/v1/cancel":
                    rid = str(body.get("id", "")).replace("cmpl-", "")
                    ok = rid.lstrip("-").isdigit() and \
                        server.engine.cancel(int(rid))
                    self._json(200, {"cancelled": bool(ok)})
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def _completions(self, body: dict) -> None:
                prompt = body.get("prompt")
                if not isinstance(prompt, list) or not prompt or \
                        not all(isinstance(t, int) for t in prompt):
                    self._json(400, {"error": "prompt must be a non-empty "
                                              "list of token ids (the repo "
                                              "ships no tokenizer)"})
                    return
                try:
                    seed = body.get("seed")
                    sp = SamplingParams(
                        temperature=float(body.get("temperature", 0.0)),
                        top_k=int(body.get("top_k", 0)),
                        top_p=float(body.get("top_p", 1.0)),
                        seed=None if seed is None else int(seed))
                    # handle-side event buffering (stream=True) is for
                    # callers that drain handle.events(); the SSE loop
                    # below reads new_tokens() deltas, so don't buffer
                    eos = body.get("eos_token_id")
                    handle = server.engine.submit(
                        prompt, sampling=sp,
                        max_tokens=int(body.get("max_tokens", 16)),
                        eos_token_id=None if eos is None else int(eos),
                        priority=int(body.get("priority", 0)))
                except (TypeError, ValueError) as e:
                    self._json(400, {"error": str(e)})
                    return
                if body.get("stream"):
                    self._stream(handle)
                    return
                server.wait_finished(handle)
                if not handle.finished:          # shutdown raced the request
                    self._json(503, {"error": "server shutting down"
                                     if server.error is None else
                                     f"engine failed: {server.error!r}"})
                    return
                out = handle.result()
                self._json(200, {
                    "id": f"cmpl-{out.rid}", "object": "text_completion",
                    "choices": [{"index": 0,
                                 "token_ids": out.token_ids,
                                 "finish_reason": out.finish_reason}],
                    "usage": {"prompt_tokens": len(out.prompt),
                              "completion_tokens": len(out.token_ids)},
                    "num_preemptions": out.num_preemptions})

            def _client_gone(self) -> bool:
                """True when the peer closed its end. A failed write only
                surfaces after the kernel send buffer drains — far too late
                for a fast engine — so peek the socket for EOF instead."""
                try:
                    r, _, _ = select.select([self.connection], [], [], 0)
                    if not r:
                        return False
                    return self.connection.recv(1, socket.MSG_PEEK) == b""
                except OSError:
                    return True

            def _stream(self, handle) -> None:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()
                try:
                    while True:
                        seen = server.step_token()   # before the state reads
                        if self._client_gone():
                            raise BrokenPipeError
                        # read `finished` BEFORE draining the delta: tokens
                        # commit before the terminal event publishes, so the
                        # opposite order could drop the final tokens when
                        # the engine finishes the request between the reads
                        done = handle.finished
                        delta = handle.new_tokens()
                        if delta or done:
                            chunk = _completion_chunk(
                                handle.rid, delta,
                                handle.finish_reason if done else None)
                            self.wfile.write(
                                b"data: " + json.dumps(chunk).encode()
                                + b"\n\n")
                            self.wfile.flush()
                        if done:
                            self.wfile.write(b"data: [DONE]\n\n")
                            self.wfile.flush()
                            return
                        if server._stop.is_set():
                            return       # shutdown: drop the stream mid-way
                        server.wait_step(seen, timeout=1.0)
                except OSError:          # BrokenPipe/ConnectionReset/EOF peek
                    # client went away mid-stream: abort the request so its
                    # KV blocks and batch slot go back to the pool
                    server.engine.cancel(handle)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]
        self._threads = []

    # ---- engine loop -------------------------------------------------------

    def _engine_loop(self) -> None:
        try:
            if self._warmup and not self._ready.is_set():
                self.engine.warmup()            # every program of the grid
                self._ready.set()
            with self._profile():
                while not self._stop.is_set():
                    if self.engine.has_unfinished():
                        self.engine.step()      # publishes handle state...
                        with self._stepped:     # ...BEFORE the notify
                            self._step_seq += 1
                            self._stepped.notify_all()
                    else:
                        self._work.wait(self.idle_wait_s)
                        self._work.clear()
            flush = getattr(self.engine, "flush", None)
            if flush is not None:
                flush()     # drain a pipelined in-flight step (no-op sync)
        except BaseException as e:
            # keep it for check() and /healthz, release every waiter (the
            # engine serves nothing more), then let the thread die loudly
            self.error = e
            self._stop.set()
            self._ready.set()
            raise
        finally:
            with self._stepped:                 # release any waiting handler
                self._stepped.notify_all()

    def step_token(self) -> int:
        """Current step sequence number; capture BEFORE reading handle
        state, then pass to ``wait_step`` — a step that lands between the
        read and the wait returns immediately instead of being missed."""
        with self._stepped:
            return self._step_seq

    def wait_step(self, seen: Optional[int] = None,
                  timeout: Optional[float] = None) -> None:
        """Block until a step newer than ``seen`` completes (or shutdown,
        or timeout). ``seen=None`` waits for the next step from now."""
        with self._stepped:
            if seen is None:
                seen = self._step_seq
            self._stepped.wait_for(
                lambda: self._step_seq != seen or self._stop.is_set(),
                timeout)

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until the warmup finishes (immediately true when the server
        was built with ``warmup=False``); False on timeout or when the
        engine thread failed."""
        return self._ready.wait(timeout) and self.error is None

    def check(self) -> None:
        """Raise the engine thread's exception, if it died of one."""
        if self.error is not None:
            raise RuntimeError("the engine thread failed") from self.error

    def wait_finished(self, handle, timeout_per_step: float = 1.0) -> None:
        """Block until the handle is terminal (or shutdown). Missed-notify
        free: the terminal check and the wait share the condition lock the
        engine loop notifies under."""
        with self._stepped:
            while not handle.finished and not self._stop.is_set():
                self._stepped.wait(timeout_per_step)

    # ---- lifecycle ---------------------------------------------------------

    def start(self) -> "ServingServer":
        self._threads = [
            threading.Thread(target=self._engine_loop, name="engine-loop",
                             daemon=True),
            threading.Thread(target=self.httpd.serve_forever,
                             name="http-serve", daemon=True),
        ]
        for t in self._threads:
            t.start()
        return self

    def shutdown(self, timeout: float = 60.0) -> None:
        """Stop accepting connections, stop the engine loop (which flushes
        the engine on its own thread), join both threads. In-flight
        requests are dropped with the process (callers stream or poll;
        there is no persistence to flush). Raises if a thread is still
        running after ``timeout`` seconds (a warmup on the card takes
        several)."""
        self._stop.set()
        self._work.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        for t in self._threads:
            t.join(timeout=timeout)
        alive = [t.name for t in self._threads if t.is_alive()]
        if alive:
            raise RuntimeError(f"threads {alive} still running {timeout} s "
                               f"after shutdown")

    # ---- introspection -----------------------------------------------------

    def health(self) -> dict:
        e = self.engine
        ready = self._ready.is_set() and self.error is None
        out = {"ok": ready,
               "running": len(e.running), "prefilling": len(e.prefilling),
               "waiting": len(e.scheduler), "steps": e._step_idx}
        if self.error is not None:
            out["error"] = repr(self.error)
        elif not ready:
            out["warming_up"] = True
        return out

    def stats(self) -> dict:
        e = self.engine
        out = {"steps": e._step_idx, "finished": e.finished_total,
               "cancelled": e.cancelled_total,
               "preempted": e.preempted_total,
               "running": len(e.running), "waiting": len(e.scheduler),
               "kv": {"num_blocks": e.kv.num_blocks,
                      "free": e.kv.num_free,
                      "evictable_cached": e.kv.num_evictable,
                      "reserved": e._reserved},
               "prefill_tokens_total": e.prefill_tokens_total,
               "cached_tokens_total": e.cached_tokens_total}
        role_stats = getattr(e, "role_stats", None)
        if role_stats is not None:
            # disaggregated front door: per-role engine + transfer-buffer view
            out["roles"] = role_stats()
        if e.telemetry is not None:
            out["telemetry"] = e.telemetry.summary()
            sp = out["telemetry"].get("sparsity")
            if sp is not None:
                # compact operator-facing rollup (the full per-layer detail
                # stays under telemetry.sparsity)
                out["sparsity"] = {
                    "mean_ffn_sparsity": sp["mean_ffn_sparsity"],
                    "mfu": sp["mfu"],
                    "flops_reduction": sp["flops_reduction"],
                    "tokens_per_joule_proxy": sp["tokens_per_joule_proxy"],
                }
        return out
