"""Continuous-batching serving engine on the TwELL sparse path (PyTorch).

  engine.py    — ``ServingEngine``: handle-and-event front door, prefix-
                 cache-aware admission under a ``Scheduler`` (with
                 preemption), chunked batched prefill, synchronous steps.
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
"""
from repro_torch.serving.backends import (DraftPair, ServingBackend,
                                          get_backend, make_draft_pair)
from repro_torch.serving.engine import ServingEngine, StepStats
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.request import (EVENT_CANCEL, EVENT_FINISH,
                                         EVENT_PREEMPT, EVENT_TOKEN, Request,
                                         RequestHandle, RequestOutput,
                                         StepEvent, finished_outputs)
from repro_torch.serving.sampling import GREEDY, SamplingParams
from repro_torch.serving.scheduler import (FCFSScheduler, PriorityScheduler,
                                           Scheduler, get_scheduler)
from repro_torch.serving.spec import SpecConfig

__all__ = [
    "ServingEngine", "StepStats", "PagedKVCache", "Request", "RequestOutput",
    "RequestHandle", "StepEvent", "finished_outputs",
    "EVENT_TOKEN", "EVENT_FINISH", "EVENT_PREEMPT", "EVENT_CANCEL",
    "Scheduler", "FCFSScheduler", "PriorityScheduler", "get_scheduler",
    "SamplingParams", "GREEDY", "ServingBackend", "get_backend",
    "SpecConfig", "DraftPair", "make_draft_pair",
]
