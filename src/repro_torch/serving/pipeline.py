"""Plan/launch/collect step pipeline: shape bucketing and in-flight state.

Ports ``repro/serving/pipeline.py``. The pipelined engine
(``ServingEngine(pipeline=True)``) splits every step into three phases:

* **plan** — pure host work: cancel processing, admission, preemption
  planning and block allocation. Runs while the card still executes the
  previously launched step, so host scheduling comes off the critical path.
* **launch** — replay the step entries' programs (one CUDA graph per bucket
  key, ``serving/graphs.py``). The pools are updated in place; each
  launched output starts its device→host copy into pinned memory at once
  and nothing blocks.
* **collect** — one step later, wait for the launched copies (the only
  residual blocking, measured as ``StepStats.sync_ms``), commit tokens,
  emit events, and settle deferred cancels/preemptions.

The dataclasses below carry a launched phase's rows and unresolved host
copies from launch(N) to collect(N): they ARE the in-flight future. They
hold *references* to request objects on purpose: commit-time state
(sequence lengths, reservations) must be applied to the live requests.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.serving.request import Request

__all__ = [
    "DecodeLaunch", "HostCopy", "InFlightStep", "PrefillLaunch", "SpecLaunch",
    "bucket", "bucket_grid", "sequence_hash", "start_host_copies",
    "start_host_copy",
]


def bucket(n: int, lo: int, hi: int) -> int:
    """Round ``n`` up to a power-of-two multiple of ``lo``, capped at ``hi``
    — the shared bucketing rule for decode batch, prefill chunk and spec
    shapes. A finite bucket grid keeps the number of distinct programs
    small enough to make them all up front (see ``ServingEngine.warmup``)."""
    b = lo
    while b < n:
        b *= 2
    return min(b, hi)


def bucket_grid(lo: int, hi: int) -> List[int]:
    """Every padded size ``bucket(n, lo, hi)`` can produce for n in
    [1, hi], ascending. This is the exact set of shapes steady-state
    serving can request, so walking it at startup makes every program."""
    return sorted({bucket(n, lo, hi) for n in range(1, hi + 1)})


@dataclasses.dataclass
class HostCopy:
    """A launched output on its way to the host: ``host`` is filled once
    ``event`` (recorded after the copy on the launching stream) has
    completed; a CPU value's copy is done when made (``event`` None)."""

    host: torch.Tensor
    event: Optional[torch.cuda.Event]

    def wait(self) -> torch.Tensor:
        """Block until the copy landed; returns the host tensor."""
        if self.event is not None:
            self.event.synchronize()
        return self.host


def start_host_copies(*values: torch.Tensor) -> Tuple[HostCopy, ...]:
    """Kick off the device→host transfer of launched outputs without
    blocking: a ``non_blocking`` copy of each into a fresh pinned buffer,
    then ONE event recorded after them on the current stream (waiting for
    any of them waits for all, so a second output costs no second sync).
    By collect time the copies have typically landed, so the residual
    ``sync_ms`` shrinks to the tail of the transfer instead of the full
    device step. The copies are queued behind the replay that produced the
    values, so a later replay of the same program cannot overwrite them
    first. On CPU tensors they are plain copies."""
    if not values[0].is_cuda:
        return tuple(HostCopy(v.detach().clone(), None) for v in values)
    hosts = []
    for v in values:
        host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host.copy_(v, non_blocking=True)
        hosts.append(host)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(values[0].device))
    return tuple(HostCopy(h, event) for h in hosts)


def start_host_copy(value: torch.Tensor) -> HostCopy:
    """``start_host_copies`` of one output."""
    return start_host_copies(value)[0]


@dataclasses.dataclass
class DecodeLaunch:
    """One launched (unresolved) batched decode call."""
    rows: List[Request]
    batch: int                       # live rows (<= padded)
    padded: int
    next_toks: HostCopy              # (padded,) int64 sampled tokens
    logits: Optional[HostCopy]       # last-position logits (record_logits)
    ffn_aux: Optional[HostCopy] = None   # (3, L) float32 sparsity probe:
    #                                      nnz_mean, tile_frac, ffn_present
    #                                      (telemetry; next_toks's event)


@dataclasses.dataclass
class SpecLaunch:
    """One launched draft+verify pair. The verify token block is built on
    the card from the draft's output, so both replays go out back-to-back
    with no host readback in between."""
    rows: List[Request]
    batch: int
    padded: int
    k_effs: List[int]
    all_greedy: bool
    d_toks: HostCopy                 # (padded, k) int64
    d_logits: Optional[HostCopy]     # (padded, k, V); None if all greedy
    t_logits: HostCopy               # (padded, k+1, V) float32
    t_verify0: float                 # perf_counter at verify dispatch
    t_draft0: float = 0.0            # perf_counter at draft dispatch


@dataclasses.dataclass
class PrefillLaunch:
    """One launched chunked-prefill call over every in-flight prefill row."""
    rows: List[Request]
    chunk_lens: List[int]
    tok: HostCopy                    # (padded,) int64 next tokens
    logits: Optional[HostCopy]       # last valid position's logits
                                     # (record_logits)
    ffn_aux: Optional[HostCopy] = None   # (3, L) probe, as DecodeLaunch's


@dataclasses.dataclass
class InFlightStep:
    """Everything launch(N) dispatched, awaiting collect at step N+1 (or
    ``flush()``). While an InFlightStep exists the engine must not free or
    COW-copy any block its tables reference — cancels and preemptions on
    launched rows are deferred and settle at collect, right after the
    in-flight tokens commit."""
    decode: Optional[DecodeLaunch]
    spec: Optional[SpecLaunch]
    prefill: Optional[PrefillLaunch]
    t_launched: float                # perf_counter right after dispatch


def sequence_hash(tables: Sequence[Tuple[int, ...]]) -> int:
    """Order-sensitive fingerprint of a set of block tables (test helper
    for asserting launched tables stay untouched across a cancel)."""
    return hash(tuple(tuple(t) for t in tables))
