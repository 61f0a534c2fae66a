"""EngineSpec: one declarative bundle of ServingEngine construction kwargs.

Ports ``repro/serving/engine_spec.py``. Every engine-building entry point
(the serve CLI, its HTTP path, a benchmark harness) builds its engine from
one ``EngineSpec`` instead of assembling the same long kwarg list by hand,
so a flag added in one place cannot drift from the others: build an engine
with ``spec.build(params, cfg)``, derive a variant with
``spec.replace(telemetry=tm)``.

The field set mirrors the port's ``ServingEngine.__init__`` keyword for
keyword (a test asserts they cannot drift): the JAX spec's fields without
``attn_backend`` (the port reads the paged KV through one path a device),
with ``device``. The device defaults to the card, as the engine's does;
``mesh`` (JAX ``engine_spec.py:45``) is a ``DeviceMesh`` from
``sharding.make_serving_mesh``, None unsharded. ``build`` forwards the
fields verbatim, so an ``EngineSpec`` never reinterprets a knob.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.spec import SpecConfig


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """ServingEngine construction kwargs as data (defaults match the engine
    ctor). ``scheduler`` should be a policy NAME when the spec builds more
    than one engine: a shared ``Scheduler`` instance would corrupt both
    engines' queues."""

    backend: str = "dense"
    block_size: int = 16
    num_blocks: Optional[int] = None
    max_batch: int = 8
    max_seq_len: int = 256
    min_prefill_bucket: int = 16
    seed: int = 0
    record_logits: bool = False
    spec: Optional[SpecConfig] = None
    prefix_cache: bool = True
    prefill_chunk: int = 64
    scheduler: Union[str, Any] = "fcfs"
    max_stats: Optional[int] = 4096
    telemetry: Any = False           # bool | Telemetry instance
    pipeline: bool = False
    warmup: bool = False
    role: str = "unified"
    device: Any = None               # None = the card
    mesh: Any = None                 # a 1-D "model" DeviceMesh; None = tp 1

    def replace(self, **changes) -> "EngineSpec":
        return dataclasses.replace(self, **changes)

    def kwargs(self) -> dict:
        """The ctor kwargs, field for field (no asdict: nested dataclasses
        like SpecConfig must pass through as objects, not dicts)."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def build(self, params, cfg) -> ServingEngine:
        return ServingEngine(params, cfg, **self.kwargs())
