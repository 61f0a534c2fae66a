"""Serving metrics: a zero-dependency registry + the serving metric set.

Ports ``repro/serving/telemetry.py`` unchanged in its metric names, HELP
strings, label names and buckets, so docs/observability.md describes both
engines; the cost model is the port's ``observability.accounting`` (the
H100's peak and power limit).

Every serving layer (engine, scheduler, paged KV cache, speculative
drafter/verifier, FFN backends) publishes into one ``MetricsRegistry`` of
counters, gauges, and fixed-bucket histograms. The registry is:

  zero-dependency  — no prometheus_client; ``render_prometheus()`` emits
                     the Prometheus text exposition format (0.0.4) that
                     ``GET /metrics`` on the HTTP server returns verbatim.
  thread-safe      — one registry lock around every mutation/snapshot;
                     metric updates are host-side and low-rate (a handful
                     per engine step), so a coarse lock costs nothing.
  free when off    — ``MetricsRegistry(enabled=False)`` hands out shared
                     null-metric singletons whose methods are no-ops, and
                     the engine skips instrumentation entirely when built
                     without telemetry, so the disabled path adds only a
                     few ``is None`` checks per step.

``ServingMetrics`` declares the serving metric catalog (documented in
docs/observability.md) against a registry; ``Telemetry`` is the facade the
engine holds — metrics + the span/trace recorder from ``trace.py`` — with
the per-lifecycle hooks (``on_submit`` / ``on_admit`` / ``on_tokens`` /
``on_spec`` / ``phase`` / ``on_step`` / ...) the engine calls so
instrumentation stays out of the scheduling logic.
"""
from __future__ import annotations

import threading
import time
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.observability import accounting
from repro_torch.serving.trace import (SPAN_CANCEL, SPAN_DECODE,
                                       SPAN_FINISH, SPAN_PREEMPT,
                                       SPAN_PREFILL, SPAN_QUEUED, SPAN_SPEC,
                                       TraceRecorder)

# Latency buckets (seconds): sub-millisecond host phases through multi-second
# cold-compile steps. Prometheus convention: seconds, cumulative, +Inf last.
TIME_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
# Acceptance-rate buckets: fractions in [0, 1].
RATIO_BUCKETS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)

# Engine step phases (the ``phase`` label of serving_step_phase_seconds).
PHASE_CANCEL = "cancel"
PHASE_DECODE = "decode"
PHASE_DRAFT = "draft"
PHASE_VERIFY = "verify"
PHASE_SAMPLE = "sample"          # host-side spec acceptance / rejection
PHASE_ADMISSION = "admission"
PHASE_PREFILL = "prefill"
PHASE_HOST_SYNC = "host_sync"    # blocked on device results (StepStats.sync;
#                                  pipelined: RESIDUAL blocking at collect)
PHASE_STEP = "step"              # whole-step wall time
# Pipelined-engine phases (ServingEngine(pipeline=True) only): each step is
# plan (pure host: cancel/admission planning) -> collect (resolve the
# PREVIOUS launch, commit tokens) -> launch (dispatch, no blocking).
PHASE_PLAN = "plan"
PHASE_LAUNCH = "launch"
PHASE_COLLECT = "collect"
PHASE_OVERLAP = "overlap"        # previous launch -> its collect: wall time
#                                  device(N) ran concurrently with host work


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render bare, floats via repr."""
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _labels_str(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{v}"' for n, v in zip(names, values))
    return "{" + inner + "}"


class _Metric:
    """Base: one named family with a fixed label-name tuple; children hold
    per-label-value series created on first touch."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labelnames: Sequence[str] = ()):
        self.registry = registry
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._series: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(labels)}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def label_sets(self) -> List[Dict[str, str]]:
        """Every label combination this family has seen (sorted)."""
        with self.registry._lock:
            return [dict(zip(self.labelnames, k))
                    for k in sorted(self._series)]


class Counter(_Metric):
    """Monotonic counter. ``inc(value, **labels)``."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = self._key(labels)
        with self.registry._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        with self.registry._lock:
            return float(self._series.get(self._key(labels), 0.0))

    def _render(self) -> Iterable[str]:
        for key, v in sorted(self._series.items()):
            yield (f"{self.name}{_labels_str(self.labelnames, key)} "
                   f"{_fmt(v)}")


class Gauge(_Metric):
    """Point-in-time value. ``set(value, **labels)``."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self.registry._lock:
            self._series[key] = float(value)

    def inc(self, value: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self.registry._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        with self.registry._lock:
            return float(self._series.get(self._key(labels), 0.0))

    def _render(self) -> Iterable[str]:
        for key, v in sorted(self._series.items()):
            yield (f"{self.name}{_labels_str(self.labelnames, key)} "
                   f"{_fmt(v)}")


class Histogram(_Metric):
    """Fixed-bucket histogram: per-series bucket counts + sum + count.

    ``observe(value)`` costs one bisect + three adds under the registry
    lock. Buckets are upper bounds (cumulative on render, +Inf implicit).
    """

    kind = "histogram"

    def __init__(self, registry, name, help, labelnames=(),
                 buckets: Sequence[float] = TIME_BUCKETS):
        super().__init__(registry, name, help, labelnames)
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"{self.name}: buckets must be ascending")
        self.buckets = tuple(float(b) for b in buckets)

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self.registry._lock:
            s = self._series.get(key)
            if s is None:
                # [per-bucket counts..., overflow, sum, count]
                s = self._series[key] = [0] * (len(self.buckets) + 1) \
                    + [0.0, 0]
            s[bisect_left(self.buckets, value)] += 1
            s[-2] += float(value)
            s[-1] += 1

    def snapshot(self, **labels) -> Dict:
        """{"count", "sum", "buckets": {le: cumulative_count}} for one
        series (for /v1/stats summaries and tests)."""
        key = self._key(labels)
        with self.registry._lock:
            s = self._series.get(key)
            if s is None:
                return {"count": 0, "sum": 0.0, "buckets": {}}
            out, cum = {}, 0
            for b, c in zip(self.buckets, s):
                cum += c
                out[b] = cum
            return {"count": s[-1], "sum": s[-2], "buckets": out}

    def mean(self, **labels) -> Optional[float]:
        snap = self.snapshot(**labels)
        return snap["sum"] / snap["count"] if snap["count"] else None

    def _render(self) -> Iterable[str]:
        for key, s in sorted(self._series.items()):
            cum = 0
            for b, c in zip(self.buckets, s):
                cum += c
                lbls = _labels_str(self.labelnames + ("le",),
                                   key + (_fmt(b),))
                yield f"{self.name}_bucket{lbls} {cum}"
            lbls = _labels_str(self.labelnames + ("le",), key + ("+Inf",))
            yield f"{self.name}_bucket{lbls} {s[-1]}"
            yield f"{self.name}_sum{_labels_str(self.labelnames, key)} " \
                  f"{_fmt(s[-2])}"
            yield f"{self.name}_count{_labels_str(self.labelnames, key)} " \
                  f"{s[-1]}"


class _NullMetric:
    """Shared no-op stand-in handed out by a disabled registry."""

    def inc(self, *a, **k): pass
    def set(self, *a, **k): pass
    def observe(self, *a, **k): pass
    def value(self, **k): return 0.0
    def mean(self, **k): return None
    def snapshot(self, **k): return {"count": 0, "sum": 0.0, "buckets": {}}
    def label_sets(self): return []


_NULL = _NullMetric()


class MetricsRegistry:
    """Named metric families + Prometheus text rendering."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, cls, name, help, labelnames, **kw):
        if not self.enabled:
            return _NULL
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls or \
                        existing.labelnames != tuple(labelnames):
                    raise ValueError(f"metric {name!r} re-registered with a "
                                     "different type or labels")
                return existing
            m = cls(self, name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str,
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str,
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = TIME_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def render_prometheus(self) -> str:
        """The Prometheus text exposition (0.0.4) of every family, HELP and
        TYPE comments included; empty string when disabled."""
        if not self.enabled:
            return ""
        lines: List[str] = []
        with self._lock:
            families = list(self._metrics.values())
        for m in sorted(families, key=lambda m: m.name):
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            with self._lock:
                lines.extend(m._render())
        return "\n".join(lines) + "\n" if lines else ""


class ServingMetrics:
    """The serving metric catalog (see docs/observability.md) bound to one
    registry. Constructing against a disabled registry yields all-null
    metrics, so callers never branch."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        r = registry
        self.step_phase_seconds = r.histogram(
            "serving_step_phase_seconds",
            "Engine step time split by phase (admission / prefill / decode "
            "/ draft / verify / sample / host_sync / cancel / step; "
            "pipelined mode adds plan / launch / collect / overlap)",
            ("phase",))
        self.steps_total = r.counter(
            "serving_steps_total", "Engine step() iterations")
        self.requests_total = r.counter(
            "serving_requests_total",
            "Requests reaching a terminal state, by outcome and engine role "
            "(unified single-engine serving; prefill / decode under "
            "--disagg)",
            ("outcome", "role"))               # finished | cancelled
        self.submitted_total = r.counter(
            "serving_requests_submitted_total", "Requests submitted")
        self.preemptions_total = r.counter(
            "serving_preemptions_total",
            "Scheduler evictions of running requests (they re-queue)")
        self.tokens_total = r.counter(
            "serving_tokens_generated_total", "Output tokens committed")
        self.kv_blocks = r.gauge(
            "serving_kv_blocks",
            "Paged KV pool occupancy by block state "
            "(free / evictable / reserved / live / admissible)",
            ("state",))
        self.kv_events_total = r.counter(
            "serving_kv_events_total",
            "Paged KV pool events (cow = copy-on-write block copies, "
            "evict = cached blocks reclaimed under pressure)",
            ("event",))
        self.prefix_tokens_total = r.counter(
            "serving_prefix_tokens_total",
            "Prompt tokens at admission, by source (cached = served from "
            "the prefix cache, computed = prefilled); hit rate = "
            "cached / (cached + computed)",
            ("source",))
        self.spec_tokens_total = r.counter(
            "serving_spec_tokens_total",
            "Speculative tokens per verify outcome (drafted / accepted)",
            ("outcome",))
        self.spec_acceptance = r.histogram(
            "serving_spec_acceptance_ratio",
            "Per-request per-step draft acceptance rate",
            buckets=RATIO_BUCKETS)
        self.ttft_seconds = r.histogram(
            "serving_ttft_seconds",
            "Time to first token by priority tier and engine role (for the "
            "decode role this is arrival to first decode-engine token, i.e. "
            "it includes the migration wait)", ("priority", "role"))
        self.itl_seconds = r.histogram(
            "serving_itl_seconds",
            "Inter-token latency by priority tier and engine role (spec "
            "steps spread the gap over the tokens they commit)",
            ("priority", "role"))
        self.kv_migrated_blocks_total = r.counter(
            "serving_kv_migrated_blocks_total",
            "KV blocks materialized into an engine's pool from another "
            "engine's (disaggregated prefill->decode migration; dedup "
            "against the local prefix cache skips blocks, which do not "
            "count here)",
            ("role",))
        self.transfer_buffer_entries = r.gauge(
            "serving_transfer_buffer_entries",
            "Published-but-unclaimed KV transfer entries (disagg)")
        self.transfer_buffer_blocks = r.gauge(
            "serving_transfer_buffer_blocks",
            "Source-pool KV blocks pinned by unclaimed transfer entries "
            "(disagg)")
        self.transfer_expired_total = r.counter(
            "serving_transfer_expired_total",
            "Transfer entries dropped by TTL before a decode engine "
            "claimed them (their requests re-queue and re-prefill)")
        self.transfer_wait_seconds = r.histogram(
            "serving_transfer_wait_seconds",
            "Publish-to-claim wait of migrated KV entries (disagg)")
        self.jit_compiles_total = r.counter(
            "serving_jit_compiles_total",
            "Bucketed-shape JIT cache misses by entrypoint "
            "(decode / prefill / draft / verify)",
            ("entry",))
        self.warmup_seconds = r.gauge(
            "serving_warmup_seconds",
            "Startup precompile wall time over the full bucketed shape "
            "grid (0 until warmup runs); after warmup, steady-state "
            "serving should record zero serving_jit_compiles_total "
            "increments")
        self.warmup_shapes = r.gauge(
            "serving_warmup_shapes",
            "Bucketed (entrypoint, shape) combinations precompiled at "
            "startup")
        self.build_info = r.gauge(
            "serving_build_info",
            "Engine build configuration (value is always 1)",
            ("backend", "attn_backend", "scheduler", "spec_k", "tp"))
        self.ffn_sparsity = r.gauge(
            "serving_ffn_sparsity",
            "Per-layer FFN activation sparsity (1 - nnz/d_ff) from the most "
            "recent probed forward", ("layer",))
        self.tile_occupancy = r.histogram(
            "serving_tile_occupancy_ratio",
            "Per-probed-forward fraction of (row x tile) activation cells "
            "with any live neuron (what tile_skip cannot skip)",
            buckets=RATIO_BUCKETS)
        self.effective_flops_total = r.counter(
            "serving_effective_flops_total",
            "Model FLOPs under the analytic sparse cost model, summed over "
            "probed forwards")
        self.dense_flops_total = r.counter(
            "serving_dense_flops_total",
            "Dense-equivalent model FLOPs for the same probed forwards")
        self.mfu = r.gauge(
            "serving_mfu",
            "Live MFU estimate: dense-equivalent FLOPs of the last step "
            "over wall time x chips x peak")
        self.tokens_per_joule = r.gauge(
            "serving_tokens_per_joule_proxy",
            "Committed tokens per joule at chip TDP (an energy proxy, not "
            "a measurement)")


def _lat_key(label_set: Dict[str, str]) -> str:
    """ttft_s/itl_s summary key for one latency label set: the bare priority
    tier for unified (single-engine) serving — the historical key shape —
    and ``priority@role`` for disagg roles (a shared registry carries both
    roles' series, which must not collide)."""
    if label_set.get("role", "unified") == "unified":
        return label_set["priority"]
    return f'{label_set["priority"]}@{label_set["role"]}'


class Telemetry:
    """What the engine holds when observability is on: the metric catalog
    plus the span/trace recorder, behind lifecycle hooks.

    All hooks are cheap host-side bookkeeping; the engine only calls them
    when constructed with telemetry (``self.telemetry is not None``), so a
    telemetry-less engine pays nothing but the ``is None`` checks.
    """

    def __init__(self, *, metrics: bool = True, trace: bool = True,
                 registry: Optional[MetricsRegistry] = None,
                 max_trace_events: int = 200_000,
                 role: str = "unified"):
        self.role = role          # engine role stamped on per-role labels
        #                           (unified | prefill | decode); the disagg
        #                           coordinator builds one facade per engine
        #                           sharing a single registry
        self.registry = registry if registry is not None \
            else MetricsRegistry(enabled=metrics)
        self.metrics = ServingMetrics(self.registry)
        self.trace = TraceRecorder(max_events=max_trace_events) \
            if trace else None
        self._last_token_t: Dict[int, float] = {}   # rid -> last commit time
        self._kv_prev = {"cow": 0, "evict": 0}      # counter deltas
        self._compute: Optional[Dict] = None        # armed by attach_compute
        self._win_flops = 0.0                       # dense-equiv, this step
        self._win_tokens = 0                        # committed, this step
        self._sparsity_sum = 0.0                    # running mean numerator
        self._sparsity_n = 0

    # ---- request lifecycle -------------------------------------------------

    def on_submit(self, req) -> None:
        self.metrics.submitted_total.inc()
        if self.trace is not None:
            req.spans = []
            self.trace.begin_span(req, SPAN_QUEUED)

    def on_admit(self, req, cached_tokens: int, computed_tokens: int) -> None:
        self.metrics.prefix_tokens_total.inc(cached_tokens, source="cached")
        self.metrics.prefix_tokens_total.inc(computed_tokens,
                                             source="computed")
        if self.trace is not None and req.spans is not None:
            self.trace.end_span(req)                      # QUEUED
            self.trace.begin_span(req, SPAN_PREFILL,
                                  cached_prefix_tokens=cached_tokens)

    def on_running(self, req) -> None:
        if self.trace is not None and req.spans is not None:
            self.trace.end_span(req)                      # PREFILL
            self.trace.begin_span(req, SPAN_DECODE)

    def on_preempt(self, req) -> None:
        self.metrics.preemptions_total.inc()
        self._last_token_t.pop(req.rid, None)
        if self.trace is not None and req.spans is not None:
            self.trace.end_span(req)
            self.trace.instant(req, SPAN_PREEMPT)
            self.trace.begin_span(req, SPAN_QUEUED)       # re-queued

    def on_migrated(self, req, blocks: int) -> None:
        """A request's KV just materialized into this engine's pool from
        another engine (``blocks`` freshly filled; deduped blocks excluded).
        It enters decode directly — no admission/prefill hooks fire here."""
        self.metrics.kv_migrated_blocks_total.inc(blocks, role=self.role)
        if self.trace is not None:
            if req.spans is None:
                req.spans = []
            if req.span_open is not None:
                self.trace.end_span(req)            # QUEUED after a preempt
            self.trace.begin_span(req, SPAN_DECODE,
                                  migrated_blocks=blocks)

    def on_terminal(self, req, reason: str, cancelled: bool) -> None:
        self.metrics.requests_total.inc(
            outcome="cancelled" if cancelled else "finished",
            role=self.role)
        self._last_token_t.pop(req.rid, None)
        if self.trace is not None and req.spans is not None:
            self.trace.end_span(req)
            self.trace.instant(req,
                               SPAN_CANCEL if cancelled else SPAN_FINISH,
                               reason=reason)
            self.trace.retire_request(req)

    def on_tokens(self, req, n: int, now: Optional[float] = None) -> None:
        """``n`` tokens committed for ``req`` (spec steps commit several)."""
        if n <= 0:
            return
        now = time.perf_counter() if now is None else now
        self.metrics.tokens_total.inc(n)
        self._win_tokens += n
        tier = str(req.priority)
        last = self._last_token_t.get(req.rid)
        if last is None:
            self.metrics.ttft_seconds.observe(now - req.arrival_time,
                                              priority=tier, role=self.role)
            gap_tokens = n - 1
        else:
            gap_tokens = n
        if gap_tokens > 0 and last is not None:
            per_tok = (now - last) / gap_tokens
            for _ in range(gap_tokens):
                self.metrics.itl_seconds.observe(per_tok, priority=tier,
                                                 role=self.role)
        self._last_token_t[req.rid] = now

    # ---- disaggregation (coordinator-driven) -------------------------------

    def on_transfer_buffer(self, entries: int, blocks: int) -> None:
        """Point-in-time transfer-buffer occupancy (set each coordinator
        step): unclaimed entries and the source-pool blocks they pin."""
        self.metrics.transfer_buffer_entries.set(entries)
        self.metrics.transfer_buffer_blocks.set(blocks)

    def on_transfer_expired(self, entries: int) -> None:
        if entries:
            self.metrics.transfer_expired_total.inc(entries)

    def on_transfer_wait(self, wait_s: float) -> None:
        self.metrics.transfer_wait_seconds.observe(wait_s)

    def on_spec(self, req, drafted: int, accepted: int) -> None:
        self.metrics.spec_tokens_total.inc(drafted, outcome="drafted")
        self.metrics.spec_tokens_total.inc(accepted, outcome="accepted")
        if drafted:
            self.metrics.spec_acceptance.observe(accepted / drafted)
        if self.trace is not None and req.spans is not None:
            self.trace.instant(req, SPAN_SPEC, drafted=drafted,
                               accepted=accepted)

    # ---- sparsity / compute accounting -------------------------------------

    def attach_compute(self, cfg, n_params: int, chips: int = 1) -> None:
        """Arm the sparsity/compute cost model. The engine calls this once
        at build time when sparsity probing is enabled; ``on_ffn`` and the
        MFU/energy gauges stay inert until it does."""
        self._compute = {"cfg": cfg, "n_params": int(n_params),
                         "chips": int(chips)}

    def on_ffn(self, tokens: int, nnz_per_layer, tile_frac_per_layer=None,
               ffn_present=None, impl: Optional[str] = None) -> None:
        """Per-layer sparsity probe from one forward over ``tokens`` tokens
        (host-side floats/arrays; never traced values). Publishes the
        per-layer gauges, tile-occupancy histogram, and FLOPs counters.
        ``impl`` overrides the attached cfg's ffn_impl (the engine's
        backends reconfigure it per phase)."""
        if self._compute is None or tokens <= 0:
            return
        c = self._compute
        report = accounting.SparsityReport.build(
            c["cfg"], tokens, nnz_per_layer, impl=impl,
            tile_frac_per_layer=tile_frac_per_layer, ffn_present=ffn_present,
            n_params=c["n_params"], train=False, chips=c["chips"])
        m = self.metrics
        for lc in report.present_layers:
            m.ffn_sparsity.set(lc.sparsity, layer=str(lc.layer))
            m.tile_occupancy.observe(lc.tile_frac)
        m.effective_flops_total.inc(max(report.model_effective_flops, 0.0))
        m.dense_flops_total.inc(max(report.model_dense_flops, 0.0))
        self._win_flops += report.model_dense_flops
        self._sparsity_sum += report.mean_sparsity
        self._sparsity_n += 1

    # ---- engine step -------------------------------------------------------

    def phase(self, name: str, t0: float, t1: float, step: int) -> None:
        """One timed engine phase within one step."""
        self.metrics.step_phase_seconds.observe(t1 - t0, phase=name)
        if self.trace is not None:
            self.trace.phase_span(name, t0, t1, step)

    def on_compile(self, entry: str) -> None:
        self.metrics.jit_compiles_total.inc(entry=entry)

    def on_warmup(self, seconds: float, shapes: int) -> None:
        """Record a completed startup precompile pass (engine.warmup)."""
        self.metrics.warmup_seconds.set(seconds)
        self.metrics.warmup_shapes.set(shapes)

    def on_step(self, *, kv, reserved: int, wall_s: float,
                sync_s: float) -> None:
        """End-of-step rollup: whole-step + host-sync phase observations and
        the KV occupancy gauges (``kv`` is the engine's PagedKVCache)."""
        m = self.metrics
        m.steps_total.inc()
        m.step_phase_seconds.observe(wall_s, phase=PHASE_STEP)
        m.step_phase_seconds.observe(sync_s, phase=PHASE_HOST_SYNC)
        occ = kv.occupancy()
        m.kv_blocks.set(occ["free"], state="free")
        m.kv_blocks.set(occ["evictable"], state="evictable")
        m.kv_blocks.set(occ["live"], state="live")
        m.kv_blocks.set(reserved, state="reserved")
        m.kv_blocks.set(occ["free"] + occ["evictable"] - reserved,
                        state="admissible")
        for event, key in (("cow", "cow_total"), ("evict", "evict_total")):
            delta = occ[key] - self._kv_prev[event]
            if delta > 0:
                m.kv_events_total.inc(delta, event=event)
            self._kv_prev[event] = occ[key]
        if self._compute is not None:
            chips = self._compute["chips"]
            m.mfu.set(accounting.mfu(self._win_flops, wall_s, chips))
            m.tokens_per_joule.set(accounting.tokens_per_joule(
                self._win_tokens, wall_s, chips))
            self._win_flops, self._win_tokens = 0.0, 0

    # ---- summaries ---------------------------------------------------------

    def phase_ms_mean(self) -> Dict[str, float]:
        """Mean milliseconds per observed phase (for stats/bench output)."""
        out = {}
        for phase in (PHASE_CANCEL, PHASE_DECODE, PHASE_DRAFT, PHASE_VERIFY,
                      PHASE_SAMPLE, PHASE_ADMISSION, PHASE_PREFILL,
                      PHASE_HOST_SYNC, PHASE_STEP, PHASE_PLAN, PHASE_LAUNCH,
                      PHASE_COLLECT, PHASE_OVERLAP):
            mean = self.metrics.step_phase_seconds.mean(phase=phase)
            if mean is not None:
                out[phase] = mean * 1e3
        return out

    def summary(self) -> Dict:
        """Compact JSON-able rollup for /v1/stats and the benches."""
        m = self.metrics
        cached = m.prefix_tokens_total.value(source="cached")
        computed = m.prefix_tokens_total.value(source="computed")
        drafted = m.spec_tokens_total.value(outcome="drafted")
        accepted = m.spec_tokens_total.value(outcome="accepted")
        sparsity = None
        if self._compute is not None:
            dense = m.dense_flops_total.value()
            eff = m.effective_flops_total.value()
            sparsity = {
                "mean_ffn_sparsity":
                    self._sparsity_sum / self._sparsity_n
                    if self._sparsity_n else None,
                "per_layer_sparsity": {
                    ls["layer"]: m.ffn_sparsity.value(**ls)
                    for ls in m.ffn_sparsity.label_sets()},
                "tile_occupancy_hist": m.tile_occupancy.snapshot(),
                "effective_flops_total": eff,
                "dense_flops_total": dense,
                "flops_reduction": 1.0 - eff / dense if dense else None,
                "mfu": m.mfu.value(),
                "tokens_per_joule_proxy": m.tokens_per_joule.value(),
            }
        return {
            "sparsity": sparsity,
            "phases_ms_mean": self.phase_ms_mean(),
            "steps": m.steps_total.value(),
            "tokens_generated": m.tokens_total.value(),
            "prefix_cache_hit_rate":
                cached / (cached + computed) if cached + computed else None,
            "spec_acceptance_rate":
                accepted / drafted if drafted else None,
            "spec_acceptance_hist": m.spec_acceptance.snapshot(),
            "ttft_s": {_lat_key(ls): m.ttft_seconds.snapshot(**ls)
                       for ls in m.ttft_seconds.label_sets()},
            "itl_s": {_lat_key(ls): m.itl_seconds.snapshot(**ls)
                      for ls in m.itl_seconds.label_sets()},
            "jit_compiles": {
                e: m.jit_compiles_total.value(entry=e)
                for e in ("decode", "prefill", "draft", "verify")},
            "warmup_seconds": m.warmup_seconds.value(),
            "trace_events": 0 if self.trace is None else len(self.trace),
        }
