"""Per-request span tracing + whole-engine Chrome-trace step timelines.

Ports ``repro/serving/trace.py``; the spans, the recorder and the export
are the same plain Python, so a trace of either engine reads the same.

Span model (see docs/observability.md): every traced ``Request``
accumulates timestamped ``SpanEvent``s over its lifecycle —

    QUEUED --admit--> PREFILL --prompt done--> DECODE --EOS/len--> FINISH
      ^                                          |  |
      +--------- PREEMPT (instant) --------------+  +---------->  CANCEL

``QUEUED`` / ``PREFILL`` / ``DECODE`` are *duration* spans (begin/end);
``PREEMPT`` / ``SPEC`` / ``FINISH`` / ``CANCEL`` are *instants* (``SPEC``
carries ``drafted`` / ``accepted`` args per speculative step; a preempted
request re-opens ``QUEUED`` so resume produces a second
QUEUED→PREFILL→DECODE run). The completed list is surfaced on
``RequestOutput.spans``.

The ``TraceRecorder`` additionally keeps an engine-level timeline — one
span per timed step phase (decode / draft / verify / admission / prefill /
...; the pipelined engine adds plan / launch / collect plus an ``overlap``
span covering launch(N)→collect(N), i.e. the window where device compute
and host planning ran concurrently) — and renders everything as
Chrome-trace JSON (the ``traceEvents``
array format): load the file in ``chrome://tracing`` or https://ui.perfetto.dev
to see the whole-engine step timeline with one track per request. Event
storage is bounded (``max_events``), oldest dropped first, so a long-lived
server can trace forever and export the recent window.

``torch_profiler`` is the optional deep-dive hook: a context manager around
``torch.profiler.profile`` (the card's kernels too when the run is on the
card) writing a Chrome trace of the device timeline when the host-side
phase breakdown is not enough.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import torch

# Span names (request track). Duration spans:
SPAN_QUEUED = "QUEUED"
SPAN_PREFILL = "PREFILL"
SPAN_DECODE = "DECODE"
# Instants:
SPAN_PREEMPT = "PREEMPT"
SPAN_SPEC = "SPEC"
SPAN_FINISH = "FINISH"
SPAN_CANCEL = "CANCEL"


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One completed span (``t1 > t0``) or instant (``t1 == t0``)."""

    name: str
    t0: float                                  # perf_counter seconds
    t1: float
    args: Tuple[Tuple[str, float], ...] = ()   # small, hashable, JSON-able

    @property
    def instant(self) -> bool:
        return self.t1 == self.t0

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def arg(self, key: str):
        for k, v in self.args:
            if k == key:
                return v
        return None


class TraceRecorder:
    """Collects request spans + engine phase spans; exports Chrome trace.

    Request spans accumulate on the live ``Request`` (so they can be
    surfaced on its ``RequestOutput``); terminal requests hand their span
    list over via ``retire_request`` so the whole-engine export still
    covers them. Engine phase spans land directly here. Appends happen on
    the engine thread (under the engine lock); exports may run from any
    thread — both sides take the recorder lock.
    """

    def __init__(self, max_events: int = 200_000):
        self._lock = threading.Lock()
        self._phases: Deque[Tuple[str, float, float, int]] = \
            deque(maxlen=max_events)
        self._retired: Deque[Tuple[int, Tuple[SpanEvent, ...]]] = \
            deque(maxlen=max_events)
        self.t0 = time.perf_counter()          # export timebase

    def __len__(self) -> int:
        with self._lock:
            return len(self._phases) + sum(len(s) for _, s in self._retired)

    # ---- request track (span state lives on the request) -------------------

    def begin_span(self, req, name: str, **args) -> None:
        req.span_open = (name, time.perf_counter(),
                         tuple(sorted(args.items())))

    def end_span(self, req) -> None:
        """Close the request's open span, if any (cancel can land in any
        lifecycle state, so a missing open span is not an error)."""
        open_ = getattr(req, "span_open", None)
        if open_ is None:
            return
        name, t0, args = open_
        req.span_open = None
        ev = SpanEvent(name, t0, time.perf_counter(), args)
        # keep the list ordered by start time: instants recorded while this
        # span was open (e.g. SPEC inside DECODE) already sit at the tail
        spans = req.spans
        i = len(spans)
        while i > 0 and spans[i - 1].t0 > ev.t0:
            i -= 1
        spans.insert(i, ev)

    def instant(self, req, name: str, **args) -> None:
        t = time.perf_counter()
        req.spans.append(SpanEvent(name, t, t, tuple(sorted(args.items()))))

    def retire_request(self, req) -> None:
        """Keep a terminal request's spans for whole-engine export (the
        engine drops the request object itself)."""
        with self._lock:
            self._retired.append((req.rid, tuple(req.spans)))

    # ---- engine track ------------------------------------------------------

    def phase_span(self, name: str, t0: float, t1: float, step: int) -> None:
        with self._lock:
            self._phases.append((name, t0, t1, step))

    # ---- export ------------------------------------------------------------

    def to_chrome(self, live_requests=()) -> Dict:
        """The Chrome-trace dict (``{"traceEvents": [...]}``): engine phase
        spans on pid 0 / tid 0, each request on its own tid (rid + 1).
        Pass the engine's live requests to include still-running spans."""
        us = lambda t: (t - self.t0) * 1e6
        ev: List[Dict] = [
            {"ph": "M", "pid": 0, "tid": 0, "name": "thread_name",
             "args": {"name": "engine step phases"}},
        ]
        with self._lock:
            phases = list(self._phases)
            retired = list(self._retired)
        for name, t0, t1, step in phases:
            ev.append({"ph": "X", "pid": 0, "tid": 0, "name": name,
                       "ts": us(t0), "dur": (t1 - t0) * 1e6,
                       "args": {"step": step}})
        now = time.perf_counter()
        tracks = list(retired)
        for req in live_requests:
            spans = list(getattr(req, "spans", None) or ())
            open_ = getattr(req, "span_open", None)
            if open_ is not None:              # show in-flight state too
                name, t0, args = open_
                spans.append(SpanEvent(name, t0, now, args))
            if spans:
                tracks.append((req.rid, tuple(spans)))
        for rid, spans in tracks:
            tid = rid + 1
            ev.append({"ph": "M", "pid": 0, "tid": tid,
                       "name": "thread_name",
                       "args": {"name": f"request {rid}"}})
            for s in spans:
                args = dict(s.args)
                if s.instant:
                    ev.append({"ph": "i", "pid": 0, "tid": tid,
                               "name": s.name, "ts": us(s.t0), "s": "t",
                               "args": args})
                else:
                    ev.append({"ph": "X", "pid": 0, "tid": tid,
                               "name": s.name, "ts": us(s.t0),
                               "dur": s.dur * 1e6, "args": args})
        return {"traceEvents": ev, "displayTimeUnit": "ms"}

    def export(self, path: str, live_requests=()) -> None:
        """Write the Chrome-trace JSON (open in chrome://tracing)."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(live_requests), f)
            f.write("\n")


def span_names(spans) -> List[str]:
    """The ordered span/instant names of a request trace (test helper)."""
    return [s.name for s in spans]


@contextlib.contextmanager
def torch_profiler(logdir: Optional[str], device=None):
    """Optional ``torch.profiler`` session around a serving run: the host's
    ops and, when ``device`` is a CUDA device, the card's kernels and
    copies, written as a Chrome trace to ``logdir/torch_trace.json`` on
    exit (open it in ui.perfetto.dev). A no-op when ``logdir`` is falsy.
    A profiler that fails raises: a trace that was asked for is never
    silently missing."""
    if not logdir:
        yield None
        return
    import os

    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "torch_trace.json"))
