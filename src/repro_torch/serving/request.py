"""Request lifecycle for the serving engine: states, events, handles.

The engine's front door is handle-and-event shaped:

  ``engine.submit(prompt, ...) -> RequestHandle`` returns immediately; the
  handle exposes incremental state (``new_tokens()`` deltas, ``status``,
  spec/preemption stats) and ``cancel()``. Each ``engine.step()`` returns
  the ``StepEvent`` list for that iteration — TOKEN / FINISH / PREEMPT /
  CANCEL per affected row — instead of only terminal outputs, so callers
  can stream tokens as they commit.

Lifecycle (see docs/serving.md for the full diagram)::

    waiting --admit--> prefilling --prompt done--> running --EOS/len--> finished
       ^                   |                         |  |
       |                   +------- cancel ----------+  +--cancel--> cancelled
       +------------- preempted <---- preempt (scheduler policy) ----+

A PREEMPTED request keeps its committed ``output_tokens`` (streamed tokens
never regress) but loses its KV blocks; re-admission re-prefills
``prompt + output_tokens`` — through the prefix cache, any still-registered
full prompt blocks are shared rather than recomputed.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, List, Optional, Tuple

from repro_torch.serving.sampling import GREEDY, SamplingParams

WAITING = "waiting"
PREFILLING = "prefilling"
RUNNING = "running"
PREEMPTED = "preempted"          # evicted from the batch, queued for resume
FINISHED = "finished"
CANCELLED = "cancelled"

FINISH_EOS = "eos"
FINISH_LENGTH = "length"
FINISH_CANCELLED = "cancelled"

# StepEvent kinds
EVENT_TOKEN = "token"            # tokens committed to a request this step
EVENT_FINISH = "finish"          # terminal: EOS or length (output attached)
EVENT_PREEMPT = "preempt"        # request evicted and re-queued (will resume)
EVENT_CANCEL = "cancel"          # terminal: cancelled (partial output attached)


@dataclasses.dataclass
class Request:
    """One in-flight generation request (mutable engine-side state)."""

    rid: int
    prompt: List[int]
    max_tokens: int = 16
    sampling: SamplingParams = GREEDY
    eos_token_id: Optional[int] = None
    no_spec: bool = False                    # opt this request out of spec
    priority: int = 0                        # larger = more urgent (scheduler)
    arrival_time: float = dataclasses.field(default_factory=time.perf_counter)
    # ---- engine-managed state ----------------------------------------------
    status: str = WAITING
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    logits_trace: Optional[list] = None      # per-token logits (debug mode)
    base_key: Optional[Any] = None           # per-request threefry base key
    #                                          (int64 (2,) tensor, see
    #                                          sampling.request_base_key)
    reserved_blocks: int = 0                 # growth blocks admission promised
    prefill_pos: int = 0                     # next prefill position to compute
    prefill_target: Optional[List[int]] = None   # tokens this admission must
    #                                          prefill: prompt (+ committed
    #                                          outputs after a preemption)
    cached_prefix_tokens: int = 0            # prefill tokens reused from cache
    #                                          (latest admission)
    cow_spare: int = 0                       # reserved block for a potential
    #                                          copy-on-write at prefill time
    cancel_requested: bool = False           # processed at the next step()
    num_preemptions: int = 0                 # times evicted and resumed
    spans: Optional[List] = None             # completed SpanEvents (telemetry
    #                                          tracing on; see serving/trace.py)
    span_open: Optional[tuple] = None        # (name, t0, args) span in flight
    spec_drafted: int = 0                    # draft tokens proposed for me
    spec_accepted: int = 0                   # ... of which the verifier kept
    role: str = "unified"                    # engine role that owns the request
    #                                          (unified | prefill | decode)
    migrated_blocks: int = 0                 # KV blocks materialized into this
    #                                          engine's pool from a transfer
    transfer_wait_ms: float = 0.0            # publish->claim wait, cumulative
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    finish_reason: Optional[str] = None

    def __post_init__(self):
        if not self.prompt:
            raise ValueError("empty prompt")
        if self.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {self.max_tokens}")
        self.sampling.validate()
        self.prompt = [int(t) for t in self.prompt]

    @property
    def seq_len(self) -> int:
        """Tokens currently in the KV cache for this request."""
        return len(self.prompt) + len(self.output_tokens)

    @property
    def last_token(self) -> int:
        return self.output_tokens[-1] if self.output_tokens else self.prompt[-1]

    @property
    def done(self) -> bool:
        return self.status in (FINISHED, CANCELLED)

    def append(self, token: int, now: Optional[float] = None) -> Optional[str]:
        """Record one generated token; returns a finish reason or None."""
        if self.first_token_time is None:
            self.first_token_time = time.perf_counter() if now is None else now
        self.output_tokens.append(int(token))
        if self.eos_token_id is not None and int(token) == self.eos_token_id:
            return FINISH_EOS
        if len(self.output_tokens) >= self.max_tokens:
            return FINISH_LENGTH
        return None


@dataclasses.dataclass(frozen=True)
class RequestOutput:
    """Immutable result handed back when a request reaches a terminal state
    (finished or cancelled — ``finish_reason`` says which)."""

    rid: int
    prompt: List[int]
    token_ids: List[int]
    finish_reason: str
    arrival_time: float
    first_token_time: float
    finish_time: float
    priority: int = 0
    num_preemptions: int = 0         # times evicted mid-flight and resumed
    spec_drafted: int = 0            # speculative tokens drafted for me
    spec_accepted: int = 0           # ... of which the verifier accepted
    cached_prefix_tokens: int = 0    # prefill tokens served from the prefix
    #                                  cache (latest admission)
    role: str = "unified"            # engine role that produced the output
    migrated_blocks: int = 0         # KV blocks that arrived via migration
    transfer_wait_ms: float = 0.0    # publish->claim transfer wait, cumulative
    logits: Optional[list] = None    # per-token logits (engine debug mode)
    spans: Optional[tuple] = None    # lifecycle SpanEvents (telemetry tracing
    #                                  on: QUEUED/PREFILL/DECODE spans plus
    #                                  PREEMPT/SPEC/FINISH/CANCEL instants)

    @property
    def ttft(self) -> float:
        """Time to first token (seconds from arrival)."""
        return self.first_token_time - self.arrival_time

    @property
    def latency(self) -> float:
        return self.finish_time - self.arrival_time

    @property
    def acceptance_rate(self) -> Optional[float]:
        """Fraction of drafted tokens the verifier accepted (None when the
        request never went through a speculative step)."""
        if not self.spec_drafted:
            return None
        return self.spec_accepted / self.spec_drafted

    @classmethod
    def from_request(cls, req: Request) -> "RequestOutput":
        return cls(rid=req.rid, prompt=list(req.prompt),
                   token_ids=list(req.output_tokens),
                   finish_reason=req.finish_reason or FINISH_LENGTH,
                   arrival_time=req.arrival_time,
                   first_token_time=req.first_token_time or req.finish_time
                   or req.arrival_time,
                   finish_time=req.finish_time or req.arrival_time,
                   priority=req.priority,
                   num_preemptions=req.num_preemptions,
                   spec_drafted=req.spec_drafted,
                   spec_accepted=req.spec_accepted,
                   cached_prefix_tokens=req.cached_prefix_tokens,
                   role=req.role,
                   migrated_blocks=req.migrated_blocks,
                   transfer_wait_ms=req.transfer_wait_ms,
                   logits=(None if req.logits_trace is None
                           else list(req.logits_trace)),
                   spans=(None if req.spans is None else tuple(req.spans)))


@dataclasses.dataclass(frozen=True)
class StepEvent:
    """One per-request occurrence within one ``engine.step()``.

    kind:    EVENT_TOKEN | EVENT_FINISH | EVENT_PREEMPT | EVENT_CANCEL.
    tokens:  tokens committed by this event (TOKEN only; speculative steps
             commit up to k+1 at once).
    output:  the terminal ``RequestOutput`` (FINISH and CANCEL only).
    step:    the engine step index that produced the event.

    A request that commits tokens and finishes in the same step emits a
    TOKEN event followed by a FINISH event, so token consumers never need
    to special-case the terminal step.
    """

    kind: str
    rid: int
    step: int
    tokens: Tuple[int, ...] = ()
    output: Optional[RequestOutput] = None

    @property
    def terminal(self) -> bool:
        return self.kind in (EVENT_FINISH, EVENT_CANCEL)


def finished_outputs(events) -> List[RequestOutput]:
    """The terminal ``RequestOutput``s among ``events`` (finished AND
    cancelled — check ``finish_reason`` to tell them apart). Convenience for
    drain loops: ``for o in finished_outputs(engine.step()): ...``."""
    return [e.output for e in events if e.terminal]


class RequestHandle:
    """Client-side view of one submitted request.

    Returned by ``engine.submit``; usable from a different thread than the
    one driving ``engine.step()`` (the HTTP server does exactly that — the
    engine thread appends tokens, handler threads read deltas):

      ``new_tokens()``   tokens committed since the last call (delta cursor)
      ``tokens``         all committed output tokens so far
      ``status``         waiting | prefilling | running | preempted |
                         finished | cancelled
      ``events()``       drains the buffered StepEvents (``stream=True`` only)
      ``result()``       terminal RequestOutput (raises while in flight)
      ``cancel()``       ask the engine to abort this request

    Preemption never rolls back committed tokens, so ``new_tokens()`` deltas
    are append-only: a streaming client cannot observe a regression.
    """

    def __init__(self, engine, req: Request, stream: bool = False):
        self._engine = engine
        self._req = req
        self.rid = req.rid
        self.stream = stream
        self._cursor = 0
        self._events: Optional[Deque[StepEvent]] = deque() if stream else None
        self._output: Optional[RequestOutput] = None

    # ---- incremental state -------------------------------------------------

    @property
    def status(self) -> str:
        return self._req.status

    @property
    def finished(self) -> bool:
        """Terminal (finished or cancelled). True only once the terminal
        output is published to this handle — atomic with ``result()``, so
        another thread that observes ``finished`` can always call
        ``result()`` (the request's own status flips a moment earlier,
        mid-step, before events are dispatched)."""
        return self._output is not None

    @property
    def finish_reason(self) -> Optional[str]:
        return self._req.finish_reason

    @property
    def tokens(self) -> List[int]:
        """All output tokens committed so far (non-destructive)."""
        return list(self._req.output_tokens)

    def new_tokens(self) -> List[int]:
        """Tokens committed since the last ``new_tokens()`` call."""
        out = self._req.output_tokens
        delta = out[self._cursor:len(out)]
        self._cursor += len(delta)
        return [int(t) for t in delta]

    @property
    def num_preemptions(self) -> int:
        return self._req.num_preemptions

    @property
    def priority(self) -> int:
        return self._req.priority

    @property
    def spec_drafted(self) -> int:
        return self._req.spec_drafted

    @property
    def spec_accepted(self) -> int:
        return self._req.spec_accepted

    def events(self) -> List[StepEvent]:
        """Drain this request's buffered events (``stream=True`` handles
        only; non-streaming handles always return [])."""
        if self._events is None:
            return []
        out = []
        while self._events:
            out.append(self._events.popleft())
        return out

    # ---- terminal ----------------------------------------------------------

    def result(self) -> RequestOutput:
        """The terminal output. Raises RuntimeError while still in flight —
        drive ``engine.step()`` (or let the server's engine loop run) until
        ``finished``."""
        if self._output is None:
            raise RuntimeError(
                f"request {self.rid} is still {self.status}; step the engine "
                "until handle.finished before calling result()")
        return self._output

    def cancel(self) -> bool:
        """Ask the engine to abort this request (takes effect at the next
        ``step()``). Returns False if already terminal."""
        return self._engine.cancel(self)

    # ---- engine side -------------------------------------------------------

    def _on_event(self, ev: StepEvent) -> None:
        if self._events is not None:
            self._events.append(ev)
        if ev.terminal:
            self._output = ev.output

    def __repr__(self) -> str:
        return (f"RequestHandle(rid={self.rid}, status={self.status!r}, "
                f"tokens={len(self._req.output_tokens)})")
