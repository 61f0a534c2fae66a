"""Continuous-batching serving engine on the TwELL sparse path (PyTorch).

  engine.py    — ``ServingEngine``: handle-and-event front door, prefix-
                 cache-aware admission under a ``Scheduler`` (with
                 preemption), chunked batched prefill, synchronous or
                 pipelined (plan/launch/collect) steps, ``warmup()``.
  pipeline.py  — bucketing (``bucket``, ``bucket_grid``), the launch
                 dataclasses and ``InFlightStep`` of the pipelined step,
                 ``start_host_copy`` into pinned memory.
  graphs.py    — ``Program``: one step entry at one bucket key, a CUDA
                 graph replayed every step on the card.
  scheduler.py — ``FCFSScheduler`` / ``PriorityScheduler`` policies.
  kv_cache.py  — ``PagedKVCache``: block pool on the device, host free-list
                 allocator, block tables, prefix cache with copy-on-write.
  request.py   — ``Request`` / ``RequestOutput`` / ``RequestHandle`` /
                 ``StepEvent`` and the request lifecycle.
  sampling.py  — ``SamplingParams`` and the threefry sampler, bit for bit
                 the JAX engine's (``fold_in`` key per request and token).
  backends.py  — ``ServingBackend``: dense | gather (TwELL) | tile_skip FFN
                 per phase; ``make_draft_pair`` for speculation.
  spec/        — self-speculative decoding: ``SpecConfig``, the draft loop,
                 the batched verify pass, acceptance and KV rollback.
  telemetry.py — zero-dependency metrics registry (counters / gauges /
                 fixed-bucket histograms, thread-safe, no-op when disabled),
                 the serving metric catalog of docs/observability.md and the
                 ``Telemetry`` facade of lifecycle hooks the engine calls.
  trace.py     — per-request lifecycle spans, the engine phase timeline,
                 Chrome-trace export; the ``torch_profiler`` hook.
  engine_spec.py — ``EngineSpec``: ``ServingEngine`` construction kwargs as
                 a frozen dataclass (the CLI builds its engine from one).
  server.py    — ``ServingServer``: OpenAI-style HTTP front end
                 (``/v1/completions`` with SSE streaming; client disconnect
                 cancels the request; ``/metrics``, ``/v1/stats``,
                 ``/healthz``) over one engine thread (imported from its
                 module, as in the JAX package).
  disagg/      — disaggregated prefill/decode serving: a prefill engine and
                 a decode engine with separate KV pools in one process,
                 bridged by a bounded refcount-holding ``TransferBuffer``
                 and a pluggable ``Transport`` (in-place copy on the
                 device; host bytes-roundtrip as the socket stand-in),
                 fronted by ``DisaggCoordinator``: the same handle/event
                 API, with migration a cross-engine preempt-resume.
"""
from repro_torch.serving.backends import (DraftPair, ServingBackend,
                                          get_backend, make_draft_pair)
from repro_torch.serving.disagg import (DisaggCoordinator,
                                        HostRoundtripTransport,
                                        InProcessTransport, TransferBuffer,
                                        Transport)
from repro_torch.serving.engine import ServingEngine, StepStats
from repro_torch.serving.engine_spec import EngineSpec
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.request import (EVENT_CANCEL, EVENT_FINISH,
                                         EVENT_PREEMPT, EVENT_TOKEN, Request,
                                         RequestHandle, RequestOutput,
                                         StepEvent, finished_outputs)
from repro_torch.serving.sampling import GREEDY, SamplingParams
from repro_torch.serving.scheduler import (FCFSScheduler, PriorityScheduler,
                                           Scheduler, get_scheduler)
from repro_torch.serving.spec import SpecConfig
from repro_torch.serving.telemetry import (Counter, Gauge, Histogram,
                                           MetricsRegistry, ServingMetrics,
                                           Telemetry)
from repro_torch.serving.trace import (SpanEvent, TraceRecorder, span_names,
                                       torch_profiler)

__all__ = [
    "ServingEngine", "StepStats", "PagedKVCache", "Request", "RequestOutput",
    "RequestHandle", "StepEvent", "finished_outputs",
    "EVENT_TOKEN", "EVENT_FINISH", "EVENT_PREEMPT", "EVENT_CANCEL",
    "Scheduler", "FCFSScheduler", "PriorityScheduler", "get_scheduler",
    "SamplingParams", "GREEDY", "ServingBackend", "get_backend",
    "SpecConfig", "DraftPair", "make_draft_pair",
    "Telemetry", "MetricsRegistry", "ServingMetrics", "Counter", "Gauge",
    "Histogram", "SpanEvent", "TraceRecorder", "span_names",
    "torch_profiler", "EngineSpec", "DisaggCoordinator", "TransferBuffer",
    "Transport", "InProcessTransport", "HostRoundtripTransport",
]
