"""DisaggCoordinator: the migration-aware front door over a prefill engine
and a decode engine living in one process.

Ports ``repro/serving/disagg/coordinator.py``. Disaggregated serving splits
the two phases with opposite resource shapes onto separate engines with
separate KV pools: prefill is compute-bound (long chunked matmuls, batch of
a few), decode is memory-bound (one token per row, batch of many).
Interleaving them in one engine makes each decode step's latency hostage to
whatever prefill chunk shares it; splitting them removes that interference,
at the price of moving each request's KV cache across pools mid-flight.

The move is deliberately NOT a new mechanism. A migrated request is a
preempt-resume whose KV arrives from elsewhere:

  1. The coordinator owns the canonical ``Request`` (coordinator rid,
     coordinator threefry ``base_key``). To prefill, it submits a CLONE to
     the prefill engine with ``outputs=`` its committed tokens and
     ``max_tokens=len(outputs)+1``: the clone admits like a preempt-resume,
     prefills ``prompt+outputs``, samples ONE token, and finishes by length.
  2. The engine's ``on_prefill_done`` hook fires after that token commits
     but before anything is freed: the coordinator appends the token to the
     canonical request and publishes the clone's block table into the
     ``TransferBuffer`` (pinning the blocks), then lets the clone finish.
  3. ``_claim`` hands the canonical request to
     ``decode_engine.admit_migrated``, which plans a prefix-cache-aware
     allocation (full prompt blocks already resident in the decode pool
     dedupe: their contents are the same by construction), and the
     ``Transport`` copies only the remaining blocks. The request enters
     RUNNING directly: zero prefill chunks ever run on the decode engine,
     and its first decode step writes position ``seq_len - 1``, where a
     preempt-resume would continue.

Token identity: per-token sampling keys are ``fold_in(base_key,
len(output_tokens))`` and depend on nothing else, so with the canonical
``base_key`` injected into both engines the disagg token stream equals a
single unified engine's, greedy or seeded-stochastic, through cancels,
preemptions, TTL expiries and re-prefills. The key is made from the
coordinator's master key (``sampling.PRNGKey(spec.seed)``) exactly as the
engine makes its own, and lives where the engine keeps its keys (the
host: the engine derives each step's keys there).

Failure containment: every KV pin has exactly one owner with a bounded
lifetime. Unclaimed transfers expire after ``transfer_ttl_steps`` and the
request re-queues (re-prefill costs work, never correctness); cancel works
at every stage: queued, mid-prefill (forwarded), mid-transfer (buffer entry
dropped, hold released), mid-decode (forwarded).

Scope: one process, one device, unsharded pools (a spec carrying a mesh is
rejected; the port's ``EngineSpec`` has no mesh field), synchronous engines
(``spec.pipeline`` rejected: ``withdraw`` must not race a launched step).
On the card both engines and the transport run on the caller's current
stream, so no copy can overtake a replay. The ``Transport`` ABC is the
socket/RDMA extension point.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.serving import sampling as sampling_mod
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.engine_spec import EngineSpec
from repro_torch.serving.request import (CANCELLED, EVENT_CANCEL,
                                         EVENT_FINISH, EVENT_PREEMPT,
                                         EVENT_TOKEN, FINISH_CANCELLED,
                                         FINISHED, PREEMPTED, WAITING,
                                         Request, RequestHandle,
                                         RequestOutput, StepEvent)
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Scheduler, get_scheduler
from repro_torch.serving.telemetry import Telemetry
from repro_torch.serving.disagg.transfer import (InProcessTransport,
                                                 TransferBuffer, Transport)

# canonical-request stages (the coordinator's own lifecycle; each maps onto
# engine-side states)
STAGE_QUEUED = "queued"        # waiting at the coordinator scheduler
STAGE_PREFILL = "prefill"      # clone in flight on the prefill engine
STAGE_TRANSFER = "transfer"    # published, waiting for a decode-side claim
STAGE_DECODE = "decode"        # running on the decode engine
STAGE_DONE = "done"            # terminal (finished or cancelled)


@dataclass
class _Slot:
    """Coordinator-side state for one canonical request."""

    req: Request
    handle: RequestHandle
    stage: str = STAGE_QUEUED
    prefill_rid: Optional[int] = None    # clone's rid while STAGE_PREFILL
    done_reason: Optional[str] = None    # set by the hook when the clone's
    #                                      one sampled token already ends the
    #                                      canonical request (EOS / length)


class DisaggCoordinator:
    """Front door over a prefill engine + decode engine pair.

    Implements the same handle/event API as ``ServingEngine``:
    ``submit() -> RequestHandle``, ``step() -> [StepEvent]``, ``cancel``,
    ``generate``, ``warmup``, ``has_unfinished``, so the HTTP server, its
    engine loop and the serve CLI drive it unchanged. Events carry
    canonical rids (assigned in submission order, matching what a single
    unified engine would assign).
    """

    pipeline = False       # the engines step synchronously (see the ctor)

    def __init__(self, params, cfg, *, spec: EngineSpec,
                 transfer_capacity: Optional[int] = None,
                 transfer_ttl_steps: Optional[int] = 64,
                 transport: Optional[Transport] = None):
        if getattr(spec, "mesh", None) is not None:
            raise NotImplementedError(
                "disaggregated serving requires unsharded KV pools; "
                "spec.mesh must be None (a sharded transport is future work)")
        if spec.pipeline:
            raise NotImplementedError(
                "disaggregated serving requires synchronous engines "
                "(withdraw() cannot race a launched step); spec.pipeline "
                "must be False")
        if isinstance(spec.scheduler, Scheduler):
            raise ValueError(
                "spec.scheduler must be a policy name ('fcfs'/'priority') "
                "for disagg: the coordinator and the prefill engine each "
                "need their own queue, not a shared instance")
        self.spec = spec
        self.role = "disagg"

        # one shared registry, one telemetry facade per engine role, so
        # /metrics shows both sides with role labels
        tm_prefill = tm_decode = None
        if spec.telemetry:
            if isinstance(spec.telemetry, Telemetry):
                reg = spec.telemetry.registry
                trace = spec.telemetry.trace is not None
            else:
                reg, trace = None, True
            tm_prefill = Telemetry(role="prefill", registry=reg, trace=trace)
            tm_decode = Telemetry(role="decode",
                                  registry=tm_prefill.registry, trace=trace)
        self._tm_prefill = tm_prefill
        self._tm_decode = tm_decode

        base = spec.replace(pipeline=False, warmup=False)
        self.prefill_engine: ServingEngine = base.replace(
            role="prefill", scheduler=spec.scheduler,
            telemetry=tm_prefill if tm_prefill is not None else False,
        ).build(params, cfg)
        self.decode_engine: ServingEngine = base.replace(
            role="decode", scheduler="fcfs",   # queue unused: admits bypass it
            telemetry=tm_decode if tm_decode is not None else False,
        ).build(params, cfg)
        self.prefill_engine.on_prefill_done = self._on_prefill_done

        capacity = transfer_capacity if transfer_capacity is not None \
            else max(2, spec.max_batch)
        self.buffer = TransferBuffer(self.prefill_engine.kv,
                                     max_entries=capacity,
                                     ttl_steps=transfer_ttl_steps)
        self.transport = transport if transport is not None \
            else InProcessTransport()

        self.scheduler = get_scheduler(spec.scheduler)
        self._master_key = sampling_mod.PRNGKey(spec.seed)
        self._next_rid = 0
        self._step_idx = 0
        self._lock = threading.RLock()
        self._slots: Dict[int, _Slot] = {}
        self._by_prefill_rid: Dict[int, int] = {}   # clone rid -> canonical
        self._in_prefill = 0
        self.submitted_total = 0
        self.finished_total = 0
        self.cancelled_total = 0
        self.preempted_total = 0        # withdrawn from decode + TTL expiries
        self.expired_total = 0          # ... of which TTL expiries
        self.warmup_seconds = 0.0
        self.warmup_report: List[Dict] = []
        self.on_new_work = None         # callable; fires when step() has work

    # ------------------------------------------------------------------ API

    def submit(self, prompt: Sequence[int], *,
               sampling: Optional[SamplingParams] = None,
               max_tokens: int = 16,
               eos_token_id: Optional[int] = None,
               no_spec: bool = False,
               priority: int = 0,
               stream: bool = False) -> RequestHandle:
        """Queue a request; returns its canonical ``RequestHandle``. Same
        contract as ``ServingEngine.submit`` (validation included): the
        request's prefill/transfer/decode journey is invisible to the
        caller beyond the ``role``/``migrated_blocks``/``transfer_wait_ms``
        fields of its output."""
        with self._lock:
            sp = sampling or SamplingParams()
            req = Request(rid=self._next_rid, prompt=list(map(int, prompt)),
                          max_tokens=max_tokens, sampling=sp,
                          eos_token_id=eos_token_id, no_spec=no_spec,
                          priority=priority)
            if len(req.prompt) + max_tokens > self.spec.max_seq_len:
                raise ValueError(
                    f"prompt ({len(req.prompt)}) + max_tokens ({max_tokens}) "
                    f"exceeds max_seq_len ({self.spec.max_seq_len})")
            kv = self.decode_engine.kv
            worst = kv.blocks_for(len(req.prompt) + max_tokens)
            if worst > kv.num_blocks - 1:
                raise ValueError(
                    f"request needs {worst} KV blocks but each pool only has "
                    f"{kv.num_blocks - 1}; it could never be admitted")
            # canonical PRNG identity: the same base key a unified engine
            # would derive for this rid, injected into both engines below
            req.base_key = sampling_mod.request_base_key(
                self._master_key, req.rid, sp.seed)
            self._next_rid += 1
            handle = RequestHandle(self, req, stream=stream)
            self._slots[req.rid] = _Slot(req=req, handle=handle)
            self.scheduler.add(req)
            self.submitted_total += 1
        self._wake()
        return handle

    def cancel(self, request: Union[RequestHandle, int]) -> bool:
        """Abort a canonical request at ANY stage: queued, mid-prefill,
        mid-transfer, or mid-decode. Takes effect at the next ``step()``.
        Returns False when unknown or already terminal."""
        rid = request.rid if isinstance(request, RequestHandle) \
            else int(request)
        slot = self._slots.get(rid)
        if slot is None or slot.stage == STAGE_DONE or slot.req.done:
            return False
        slot.req.cancel_requested = True
        self._wake()
        return True

    def has_unfinished(self) -> bool:
        return bool(len(self.scheduler) or len(self.buffer)
                    or self.prefill_engine.has_unfinished()
                    or self.decode_engine.has_unfinished())

    def step(self) -> List[StepEvent]:
        """One coordinator iteration: resolve cancels, expire stale
        transfers, pump the queue into the prefill engine, step it (the
        ``on_prefill_done`` hook publishes completed prefills into the
        transfer buffer mid-step), claim published transfers into the
        decode engine (preempting lower-priority decodes if the policy says
        so), step the decode engine, and return this iteration's canonical
        StepEvents (also dispatched to the handles)."""
        with self._lock:
            events: List[StepEvent] = []
            self._process_cancels(events)
            self._expire(events)
            self._pump()
            if self.prefill_engine.has_unfinished():
                self._translate_prefill(self.prefill_engine.step(), events)
            self._claim(events)
            if self.decode_engine.has_unfinished():
                self._translate_decode(self.decode_engine.step(), events)
            if self._tm_prefill is not None:
                self._tm_prefill.on_transfer_buffer(len(self.buffer),
                                                    self.buffer.blocks_pinned)
            self._step_idx += 1
            for ev in events:
                slot = self._slots.get(ev.rid)
                if slot is not None:
                    slot.handle._on_event(ev)
            return events

    def flush(self) -> List[StepEvent]:
        """The engines run pipeline=False, so there is never an in-flight
        launched step to drain; kept for engine-loop compatibility."""
        with self._lock:
            self.prefill_engine.flush()
            self.decode_engine.flush()
            return []

    def generate(self, prompts: Sequence[Sequence[int]], *,
                 sampling: Optional[SamplingParams] = None,
                 max_tokens: int = 16,
                 eos_token_id: Optional[int] = None) -> List[RequestOutput]:
        """Batch-synchronous shim, same as ``ServingEngine.generate``."""
        handles = [self.submit(p, sampling=sampling, max_tokens=max_tokens,
                               eos_token_id=eos_token_id) for p in prompts]
        while self.has_unfinished():
            self.step()
        return [h.result() for h in handles]

    def warmup(self) -> List[Dict]:
        """Make both engines' programs of the bucket grid (on the card:
        capture their CUDA graphs) plus the transport's first use;
        aggregates the per-program reports. The port's in-process copy has
        one form for every block count, so its row reads ``(1,
        max_blocks)`` where the JAX package's reads (its power-of-two
        buckets, max_blocks)."""
        t0 = time.perf_counter()
        report = []
        for tag, eng in (("prefill", self.prefill_engine),
                         ("decode", self.decode_engine)):
            for entry in eng.warmup():
                report.append({**entry, "role": tag})
        max_blocks = self.prefill_engine.kv.blocks_for(self.spec.max_seq_len)
        t_tx = time.perf_counter()
        shapes = self.transport.warmup(self.prefill_engine.kv,
                                       self.decode_engine.kv, max_blocks)
        if shapes:
            report.append({"entry": "transfer",
                           "shape": (shapes, max_blocks),
                           "seconds": time.perf_counter() - t_tx,
                           "role": "transfer"})
        self.warmup_seconds = time.perf_counter() - t0
        self.warmup_report = report
        return report

    # ---------------------------------------------------- server duck-typing

    @property
    def running(self):
        return self.decode_engine.running

    @property
    def prefilling(self):
        return self.prefill_engine.prefilling

    @property
    def kv(self):
        return self.decode_engine.kv

    @property
    def _reserved(self):
        return self.decode_engine._reserved

    @property
    def telemetry(self):
        return self._tm_decode

    @property
    def prefix_cache(self) -> bool:
        return self.decode_engine.prefix_cache

    @property
    def stats(self):
        return self.decode_engine.stats

    @property
    def draft_pair(self):
        return self.decode_engine.draft_pair

    @property
    def prompt_tokens_total(self) -> int:
        return (self.prefill_engine.prompt_tokens_total
                + self.decode_engine.prompt_tokens_total)

    @property
    def prefill_tokens_total(self) -> int:
        # decode-side contribution must stay 0: that IS the point
        return (self.prefill_engine.prefill_tokens_total
                + self.decode_engine.prefill_tokens_total)

    @property
    def cached_tokens_total(self) -> int:
        return (self.prefill_engine.cached_tokens_total
                + self.decode_engine.cached_tokens_total)

    @property
    def migrated_blocks_total(self) -> int:
        return self.decode_engine.migrated_blocks_total

    def programs_made(self) -> Dict[str, Dict[str, int]]:
        """Programs made by entry, per engine role (``programs.made``)."""
        return {"prefill": dict(self.prefill_engine.programs.made),
                "decode": dict(self.decode_engine.programs.made)}

    def role_stats(self) -> Dict[str, Dict]:
        """Per-role engine stats plus coordinator/transfer-buffer state,
        merged into ``/v1/stats`` by the HTTP server."""
        out = {}
        for tag, eng in (("prefill", self.prefill_engine),
                         ("decode", self.decode_engine)):
            out[tag] = {
                "steps": eng._step_idx,
                "running": len(eng.running),
                "prefilling": len(eng.prefilling),
                "finished": eng.finished_total,
                "cancelled": eng.cancelled_total,
                "preempted": eng.preempted_total,
                "prefill_tokens_total": eng.prefill_tokens_total,
                "cached_tokens_total": eng.cached_tokens_total,
                "migrated_blocks_total": eng.migrated_blocks_total,
                "kv": {"num_blocks": eng.kv.num_blocks,
                       "free": eng.kv.num_free,
                       "evictable_cached": eng.kv.num_evictable,
                       "reserved": eng._reserved},
            }
        out["transfer"] = {
            "entries": len(self.buffer),
            "blocks_pinned": self.buffer.blocks_pinned,
            "capacity": self.buffer.max_entries,
            "ttl_steps": self.buffer.ttl_steps,
            "published_total": self.buffer.published_total,
            "claimed_total": self.buffer.claimed_total,
            "cancelled_total": self.buffer.cancelled_total,
            "expired_total": self.buffer.expired_total,
        }
        return out

    def export_trace(self, path: str) -> None:
        """Decode-role Chrome-trace timeline (the two facades share a
        registry but keep separate trace recorders; decode carries the
        steady-state story)."""
        if self._tm_decode is None or self._tm_decode.trace is None:
            raise RuntimeError("coordinator was built without trace "
                               "telemetry; construct with telemetry=True "
                               "in the EngineSpec")
        with self._lock:
            live = [s.req for s in self._slots.values()
                    if s.stage != STAGE_DONE]
        self._tm_decode.trace.export(path, live_requests=live)

    # ------------------------------------------------------------ internals

    def _wake(self) -> None:
        if self.on_new_work is not None:
            self.on_new_work()

    def _on_prefill_done(self, clone: Request, reason: Optional[str]) -> None:
        """Prefill-engine hook: ``clone``'s whole prefill target is cached
        and its one sampled token committed, but nothing is freed yet.
        Commit the token to the canonical request and publish the clone's
        block table; the clone then finishes (by length) and its pool-side
        blocks stay pinned by the buffer hold until claim/cancel/expiry."""
        rid = self._by_prefill_rid.get(clone.rid)
        if rid is None:
            return
        slot = self._slots[rid]
        req = slot.req
        new_tok = clone.output_tokens[-1]
        creason = req.append(new_tok)
        req.role = self.prefill_engine.role
        if creason is not None:
            # the prefill-time token already ends the request (EOS, or this
            # resume pass was its last token): never enters the buffer
            slot.done_reason = creason
            return
        if req.cancel_requested:
            return      # resolved when the clone's FINISH translates
        entry = self.buffer.publish(rid, self.prefill_engine.kv.
                                    block_table(clone.rid),
                                    clone.seq_len - 1, self._step_idx)
        slot.stage = STAGE_TRANSFER
        assert entry.cached_tokens == req.seq_len - 1

    def _process_cancels(self, events: List[StepEvent]) -> None:
        for slot in list(self._slots.values()):
            req = slot.req
            if not req.cancel_requested or slot.stage == STAGE_DONE:
                continue
            if slot.stage == STAGE_QUEUED:
                self.scheduler.remove(req.rid)
                self._finish_canonical(slot, FINISH_CANCELLED, events)
            elif slot.stage == STAGE_PREFILL:
                # forwarded; resolves at this step's prefill translation
                self.prefill_engine.cancel(slot.prefill_rid)
            elif slot.stage == STAGE_TRANSFER:
                self.buffer.cancel(req.rid)
                self._finish_canonical(slot, FINISH_CANCELLED, events)
            elif slot.stage == STAGE_DECODE:
                # forwarded; resolves at this step's decode translation
                self.decode_engine.cancel(req.rid)

    def _expire(self, events: List[StepEvent]) -> None:
        expired = self.buffer.expire(self._step_idx)
        if not expired:
            return
        for entry in expired:
            slot = self._slots[entry.rid]
            req = slot.req
            # migration is a resume: drop the staged KV, re-queue, re-prefill
            req.status = PREEMPTED
            req.num_preemptions += 1
            slot.stage = STAGE_QUEUED
            self.scheduler.add(req)
            self.preempted_total += 1
            self.expired_total += 1
            events.append(StepEvent(kind=EVENT_PREEMPT, rid=req.rid,
                                    step=self._step_idx))
            if self._tm_prefill is not None:
                # metric only: the canonical request's trace spans are
                # engine-managed, and it is in no engine right now
                self._tm_prefill.metrics.preemptions_total.inc()
        if self._tm_prefill is not None:
            self._tm_prefill.on_transfer_expired(len(expired))

    def _pump(self) -> None:
        """Move queued canonical requests onto the prefill engine, gated so
        every prefill completion is guaranteed a buffer slot."""
        while (len(self.buffer) + self._in_prefill) < self.buffer.max_entries:
            req = self.scheduler.peek()
            if req is None:
                return
            clone = self.prefill_engine.submit(
                req.prompt, sampling=req.sampling,
                max_tokens=len(req.output_tokens) + 1,
                eos_token_id=req.eos_token_id, no_spec=req.no_spec,
                priority=req.priority, outputs=req.output_tokens,
                base_key=req.base_key)
            self.scheduler.take(req)
            slot = self._slots[req.rid]
            slot.stage = STAGE_PREFILL
            slot.prefill_rid = clone.rid
            self._by_prefill_rid[clone.rid] = req.rid
            self._in_prefill += 1
            req.status = WAITING

    def _translate_prefill(self, pevents: List[StepEvent],
                           events: List[StepEvent]) -> None:
        for ev in pevents:
            rid = self._by_prefill_rid.get(ev.rid)
            if rid is None:
                continue
            slot = self._slots[rid]
            if ev.kind == EVENT_TOKEN:
                # the hook already committed this token to the canonical
                # request; surface it under the canonical rid
                events.append(StepEvent(kind=EVENT_TOKEN, rid=rid,
                                        step=self._step_idx,
                                        tokens=ev.tokens))
            elif ev.kind in (EVENT_FINISH, EVENT_CANCEL):
                self._by_prefill_rid.pop(ev.rid, None)
                slot.prefill_rid = None
                self._in_prefill -= 1
                if ev.kind == EVENT_CANCEL:
                    self._finish_canonical(slot, FINISH_CANCELLED, events)
                elif slot.done_reason is not None:
                    reason, slot.done_reason = slot.done_reason, None
                    self._finish_canonical(slot, reason, events)
                elif slot.stage == STAGE_TRANSFER:
                    pass        # normal handoff: awaiting a decode claim
                elif slot.req.cancel_requested:
                    # cancel landed between this step's cancel sweep and the
                    # hook, which therefore skipped the publish
                    self._finish_canonical(slot, FINISH_CANCELLED, events)
            # EVENT_PREEMPT cannot occur: prefill-engine rows finish at
            # prefill completion and never sit in `running` to be victims

    def _claim(self, events: List[StepEvent]) -> None:
        """Admit published transfers into the decode engine, highest
        priority first, preempting lower-priority decodes when the policy
        allows. An entry that fits nowhere stays buffered (the TTL bounds
        how long)."""
        entries = sorted(self.buffer.entries(),
                         key=lambda e: (-self._slots[e.rid].req.priority,
                                        e.rid))
        for entry in entries:
            slot = self._slots[entry.rid]
            req = slot.req
            if req.cancel_requested:
                continue        # next step's cancel sweep drops the entry

            def migrate(dst_blocks, skip, _entry=entry):
                # matched prompt blocks dedupe decode-side; copy the rest
                self.transport.transfer(
                    self.prefill_engine.kv, self.decode_engine.kv,
                    list(_entry.blocks[skip:]), list(dst_blocks))

            while True:
                handle = self.decode_engine.admit_migrated(req, migrate)
                if handle is not None:
                    self.buffer.claim(entry.rid)
                    wait_s = time.perf_counter() - entry.published_t
                    req.transfer_wait_ms += wait_s * 1e3
                    slot.stage = STAGE_DECODE
                    if self._tm_decode is not None:
                        self._tm_decode.on_transfer_wait(wait_s)
                    break
                victim = self.scheduler.pick_victim(
                    req, self.decode_engine.running)
                if victim is None:
                    break       # stays buffered; retry next step
                wreq = self.decode_engine.withdraw(victim.rid)
                if wreq is None:
                    break
                # cross-engine preemption: back to the coordinator queue,
                # committed tokens intact; it will re-prefill + re-migrate
                vslot = self._slots[wreq.rid]
                vslot.stage = STAGE_QUEUED
                self.scheduler.add(wreq)
                self.preempted_total += 1
                events.append(StepEvent(kind=EVENT_PREEMPT, rid=wreq.rid,
                                        step=self._step_idx))

    def _translate_decode(self, devents: List[StepEvent],
                          events: List[StepEvent]) -> None:
        for ev in devents:
            slot = self._slots.get(ev.rid)
            if slot is None or slot.stage != STAGE_DECODE:
                continue
            if ev.kind == EVENT_TOKEN:
                events.append(StepEvent(kind=EVENT_TOKEN, rid=ev.rid,
                                        step=self._step_idx,
                                        tokens=ev.tokens))
            elif ev.kind == EVENT_FINISH:
                slot.stage = STAGE_DONE
                self.finished_total += 1
                events.append(StepEvent(kind=EVENT_FINISH, rid=ev.rid,
                                        step=self._step_idx,
                                        output=ev.output))
            elif ev.kind == EVENT_CANCEL:
                slot.stage = STAGE_DONE
                self.cancelled_total += 1
                events.append(StepEvent(kind=EVENT_CANCEL, rid=ev.rid,
                                        step=self._step_idx,
                                        output=ev.output))
            # EVENT_PREEMPT cannot occur: the decode engine's own queue is
            # always empty (admits bypass it), so its admission loop never
            # runs a preemption; cross-engine preemption uses withdraw()

    def _finish_canonical(self, slot: _Slot, reason: str,
                          events: List[StepEvent]) -> None:
        """Terminal transition driven by the coordinator itself (cancel at
        a non-decode stage, or the prefill-time token already finishing the
        request)."""
        req = slot.req
        req.finish_reason = reason
        req.finish_time = time.perf_counter()
        req.status = CANCELLED if reason == FINISH_CANCELLED else FINISHED
        slot.stage = STAGE_DONE
        kind = EVENT_CANCEL if reason == FINISH_CANCELLED else EVENT_FINISH
        if kind == EVENT_CANCEL:
            self.cancelled_total += 1
        else:
            self.finished_total += 1
        events.append(StepEvent(kind=kind, rid=req.rid, step=self._step_idx,
                                output=RequestOutput.from_request(req)))
