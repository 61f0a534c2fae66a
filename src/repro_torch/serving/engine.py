"""Continuous-batching serving engine over the paged KV cache.

Ports the synchronous step of ``repro/serving/engine.py``. The front door is
handle-and-event shaped: ``submit()`` returns a ``RequestHandle``
immediately and each ``step()`` returns that iteration's ``StepEvent``s
(TOKEN / FINISH / PREEMPT / CANCEL); ``generate()`` is the
batch-synchronous shim over the same path.

One ``step()``:

  0. cancel -- requests flagged by ``cancel()`` are aborted wherever they
     are; KV blocks are freed/parked, reservations returned.
  1. decode -- every running request advances one token through one
     ``lm.paged_decode_step`` call, the batch padded to a power-of-two
     bucket and the block table clamped to a bucketed width, so the padded
     shapes are those of the JAX engine. Greedy argmax or the threefry
     sampler on the device; the sampled row is the one host transfer.
     With ``spec=SpecConfig(...)``, every running request with at least two
     tokens of budget left (and no ``no_spec``) instead drafts k tokens
     through the draft backend, and ONE batched verify pass scores them;
     the host accepts a prefix plus one correction/bonus token per row and
     rolls the rejected scratch blocks back to the pool.
  2. admit -- the ``Scheduler`` names the next candidate; it joins once a
     batch slot and its worst-case KV blocks (prompt + max_tokens) are
     available, after matching the longest cached prefix. When it does not
     fit, the scheduler may name running victims to preempt.
  3. prefill -- every in-flight prefill advances by at most
     ``prefill_chunk`` tokens through ONE batched ``lm.paged_prefill`` call;
     a request whose prefill completes samples its first token from the
     same call and joins the next decode batch.

The FFN path per phase (dense | gather/TwELL | tile_skip) comes from the
``ServingBackend``. Stochastic sampling keys each token
``fold_in(base_key, len(output_tokens))`` as the JAX engine does, so a
seeded request gives the same tokens whatever its batch, its arrival order
or its preemptions. Not in this slice of the port: the pipelined step,
telemetry, tensor parallelism, disaggregation and ``warmup()`` (eager
PyTorch compiles nothing).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.config import ModelConfig
from repro_torch.models import lm
from repro_torch.serving import sampling as sampling_mod
from repro_torch.serving.backends import (DECODE, PREFILL, get_backend,
                                          make_draft_pair)
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.request import (CANCELLED, EVENT_CANCEL,
                                         EVENT_FINISH, EVENT_PREEMPT,
                                         EVENT_TOKEN, FINISH_CANCELLED,
                                         FINISHED, PREEMPTED, PREFILLING,
                                         RUNNING, Request, RequestHandle,
                                         RequestOutput, StepEvent)
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import (Scheduler, get_scheduler,
                                           plan_victims)
from repro_torch.serving.spec import (Drafter, SpecConfig, Verifier,
                                      rollback_after_verify)


@dataclasses.dataclass(frozen=True)
class StepStats:
    """Per-iteration batch composition."""

    step: int
    decode_batch: int        # live rows in this step's decode call
    padded_batch: int        # bucketed batch the call ran at
    prefills: int            # requests admitted this step
    finished: int            # FINISH events (EOS / length) this step
    running_after: int
    waiting_after: int
    free_blocks: int         # free + evictable blocks NET of reservations
    reserved_blocks: int = 0         # growth blocks promised to running reqs
    cached_blocks: int = 0           # evictable prefix-cache blocks (LRU)
    prefilling_after: int = 0        # requests mid-prefill after this step
    prefill_tokens: int = 0          # prompt tokens computed this step
    cached_prefix_tokens: int = 0    # prompt tokens served from cache (admits)
    cancelled: int = 0       # CANCEL events processed this step
    preempted: int = 0       # PREEMPT events this step
    wall_ms: float = 0.0     # host wall-clock for the whole step
    sync_ms: float = 0.0     # ... of which spent waiting on the device
    spec_batch: int = 0      # rows that ran draft->verify this step
    spec_drafted: int = 0    # draft tokens proposed this step
    spec_accepted: int = 0   # ... of which the verifier accepted
    draft_ms: float = 0.0    # wall time of the draft loop, to its tokens
    verify_ms: float = 0.0   # wall time of the verify pass, to its logits


def bucket(n: int, lo: int, hi: int) -> int:
    """Round ``n`` up to a power-of-two multiple of ``lo``, capped at ``hi``
    (``repro/serving/pipeline.py:bucket``)."""
    b = lo
    while b < n:
        b *= 2
    return min(b, hi)


class ServingEngine:
    """Continuous-batching engine serving one model on one set of weights."""

    def __init__(self, params, cfg: ModelConfig, *, backend="dense",
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 max_batch: int = 8, max_seq_len: int = 256,
                 min_prefill_bucket: int = 16, seed: int = 0,
                 record_logits: bool = False,
                 spec: Optional[SpecConfig] = None,
                 prefix_cache: bool = True, prefill_chunk: int = 64,
                 scheduler: Union[str, Scheduler] = "fcfs",
                 max_stats: Optional[int] = 4096, device=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_seq_len < 1:
            raise ValueError(f"max_seq_len must be >= 1, got {max_seq_len}")
        if prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.device = device_mod.resolve(device)
        self.backend = get_backend(backend)
        self.cfg = cfg
        self.cfg_prefill = self.backend.configure(cfg, PREFILL)
        self.cfg_decode = self.backend.configure(cfg, DECODE)
        self.params = lm.prepare_params(lm.params_to(params, self.device))
        self.spec = spec
        if spec is not None:
            spec.validate()
            self.draft_pair = make_draft_pair(self.backend, spec.draft_backend,
                                              spec.draft_threshold)
            self.drafter = Drafter(
                self.draft_pair.draft.configure(cfg, DECODE), spec.k)
            self.verifier = Verifier(self.cfg_decode)
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.min_prefill_bucket = min_prefill_bucket
        self.record_logits = record_logits
        self.prefix_cache = prefix_cache
        self.prefill_chunk = prefill_chunk
        if num_blocks is None:
            # enough for a full batch of worst-case requests, + null block
            num_blocks = 1 + max_batch * (-(-max_seq_len // block_size))
        self.kv = PagedKVCache(cfg, num_blocks, block_size,
                               device=self.device)
        self.table_width = -(-max_seq_len // block_size)
        self.scheduler: Scheduler = get_scheduler(scheduler)
        self.prefilling: List[Request] = []
        self.running: List[Request] = []
        self.stats: List[StepStats] = []
        self.prefill_tokens_total = 0      # prompt tokens actually computed
        self.cached_tokens_total = 0       # prompt tokens served from cache
        self.prompt_tokens_total = 0       # prompt tokens admitted overall
        self.finished_total = 0            # requests finished (EOS / length)
        self.cancelled_total = 0           # requests aborted via cancel()
        self.preempted_total = 0           # scheduler evictions (resumes)
        self.max_stats = max_stats         # keep only the newest N StepStats
        self._master_key = sampling_mod.PRNGKey(seed)
        self._next_rid = 0
        self._step_idx = 0
        self._reserved = 0            # growth blocks promised to running reqs
        self._sync_s = 0.0            # device-sync seconds within this step
        self._lock = threading.RLock()
        self._requests: Dict[int, Request] = {}    # every non-terminal rid
        self._handles: Dict[int, RequestHandle] = {}

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """Copy a device result to the host, attributing the wait to this
        step's ``sync_ms``."""
        t0 = time.perf_counter()
        out = t.cpu().numpy()
        self._sync_s += time.perf_counter() - t0
        return out

    # ------------------------------------------------------------------ API

    def submit(self, prompt: Sequence[int], *,
               sampling: Optional[SamplingParams] = None,
               max_tokens: int = 16,
               eos_token_id: Optional[int] = None,
               no_spec: bool = False,
               priority: int = 0,
               stream: bool = False) -> RequestHandle:
        """Queue a request; returns its ``RequestHandle`` immediately.
        Admission happens in ``step()`` under the scheduler policy.
        priority: larger = more urgent (the priority scheduler may preempt
        lower tiers; FCFS ignores it). stream: buffer this request's
        ``StepEvent``s on the handle. no_spec: decode this request one
        token at a time even in a speculating engine."""
        with self._lock:
            sp = sampling or SamplingParams()
            req = Request(rid=self._next_rid, prompt=list(map(int, prompt)),
                          max_tokens=max_tokens, sampling=sp,
                          eos_token_id=eos_token_id, no_spec=no_spec,
                          priority=priority)
            if len(req.prompt) + max_tokens > self.max_seq_len:
                raise ValueError(
                    f"prompt ({len(req.prompt)}) + max_tokens ({max_tokens}) "
                    f"exceeds max_seq_len ({self.max_seq_len})")
            worst = self.kv.blocks_for(len(req.prompt) + max_tokens)
            if worst > self.kv.num_blocks - 1:
                raise ValueError(
                    f"request needs {worst} KV blocks but the pool only has "
                    f"{self.kv.num_blocks - 1}; it could never be admitted")
            req.base_key = sampling_mod.request_base_key(
                self._master_key, req.rid, sp.seed)
            if self.record_logits:
                req.logits_trace = []
            self._next_rid += 1
            handle = RequestHandle(self, req, stream=stream)
            self._requests[req.rid] = req
            self._handles[req.rid] = handle
            self.scheduler.add(req)
        return handle

    def add_request(self, prompt: Sequence[int], *,
                    sampling: Optional[SamplingParams] = None,
                    max_tokens: int = 16,
                    eos_token_id: Optional[int] = None,
                    no_spec: bool = False) -> int:
        """Compat shim over ``submit()``: queue a request, return its id."""
        return self.submit(prompt, sampling=sampling, max_tokens=max_tokens,
                           eos_token_id=eos_token_id, no_spec=no_spec).rid

    def cancel(self, request: Union[RequestHandle, int]) -> bool:
        """Abort a request at the next ``step()``, wherever it is in its
        lifecycle. Returns False when it is unknown or already terminal.
        Lock-free: it only flags the request."""
        rid = request.rid if isinstance(request, RequestHandle) \
            else int(request)
        req = self._requests.get(rid)
        if req is None or req.done:
            return False
        req.cancel_requested = True
        return True

    def has_unfinished(self) -> bool:
        return bool(len(self.scheduler) or self.prefilling or self.running)

    def step(self) -> List[StepEvent]:
        """One engine iteration (cancel, decode or draft->verify, admit,
        prefill); returns this iteration's StepEvents in commit order, also
        dispatched to each request's handle."""
        with self._lock, torch.no_grad():
            t_step = time.perf_counter()
            self._sync_s = 0.0
            events: List[StepEvent] = self._process_cancels()
            decode_batch = padded = 0
            spec = {}
            if self.running:
                spec_rows = [r for r in self.running if self._can_spec(r)]
                normal_rows = [r for r in self.running
                               if not self._can_spec(r)]
                if normal_rows:
                    decode_batch, padded, evs = self._decode(normal_rows)
                    events.extend(evs)
                if spec_rows:
                    spec, evs = self._speculate(spec_rows)
                    events.extend(evs)
            admitted, cached_toks, evs = self._admit()
            events.extend(evs)
            pf_tokens, evs = self._prefill()
            events.extend(evs)
            return self._finalize_step(
                events, t_step=t_step, decode_batch=decode_batch,
                padded=padded, admitted=admitted, cached_toks=cached_toks,
                pf_tokens=pf_tokens, **spec)

    def generate(self, prompts: Sequence[Sequence[int]], *,
                 sampling: Optional[SamplingParams] = None,
                 max_tokens: int = 16,
                 eos_token_id: Optional[int] = None,
                 no_spec: bool = False) -> List[RequestOutput]:
        """Submit everything, drain the engine, return outputs in
        submission order."""
        handles = [self.submit(p, sampling=sampling, max_tokens=max_tokens,
                               eos_token_id=eos_token_id, no_spec=no_spec)
                   for p in prompts]
        while self.has_unfinished():
            self.step()
        return [h.result() for h in handles]

    # ------------------------------------------------------------ internals

    def _finalize_step(self, events: List[StepEvent], *, t_step: float,
                       decode_batch: int, padded: int, admitted: int,
                       cached_toks: int, pf_tokens: int, spec_batch: int = 0,
                       spec_drafted: int = 0, spec_accepted: int = 0,
                       draft_ms: float = 0.0, verify_ms: float = 0.0
                       ) -> List[StepEvent]:
        self._step_idx += 1
        self.stats.append(StepStats(
            step=self._step_idx, decode_batch=decode_batch,
            padded_batch=padded, prefills=admitted,
            finished=sum(1 for e in events if e.kind == EVENT_FINISH),
            running_after=len(self.running),
            waiting_after=len(self.scheduler),
            free_blocks=self.kv.num_available - self._reserved,
            reserved_blocks=self._reserved,
            cached_blocks=self.kv.num_evictable,
            prefilling_after=len(self.prefilling),
            prefill_tokens=pf_tokens, cached_prefix_tokens=cached_toks,
            cancelled=sum(1 for e in events if e.kind == EVENT_CANCEL),
            preempted=sum(1 for e in events if e.kind == EVENT_PREEMPT),
            wall_ms=(time.perf_counter() - t_step) * 1e3,
            sync_ms=self._sync_s * 1e3, spec_batch=spec_batch,
            spec_drafted=spec_drafted, spec_accepted=spec_accepted,
            draft_ms=draft_ms, verify_ms=verify_ms))
        if self.max_stats is not None and len(self.stats) >= 2 * self.max_stats:
            del self.stats[:-self.max_stats]     # amortized O(1) trim
        for ev in events:
            h = self._handles.get(ev.rid)
            if h is not None:
                h._on_event(ev)
                if ev.terminal:
                    self._handles.pop(ev.rid, None)
        return events

    def _finish(self, req: Request, reason: str) -> RequestOutput:
        """Terminal transition (EOS / length / cancel) from any live state."""
        if req.rid in self.kv:
            self.kv.free(req.rid)
        req.status = CANCELLED if reason == FINISH_CANCELLED else FINISHED
        req.finish_reason = reason
        req.finish_time = time.perf_counter()
        self._reserved -= req.reserved_blocks
        req.reserved_blocks = 0
        req.cow_spare = 0
        self.running = [r for r in self.running if r.rid != req.rid]
        self.prefilling = [r for r in self.prefilling if r.rid != req.rid]
        self._requests.pop(req.rid, None)
        return RequestOutput.from_request(req)

    def _terminal_event(self, req: Request, reason: str) -> StepEvent:
        out = self._finish(req, reason)
        kind = EVENT_CANCEL if reason == FINISH_CANCELLED else EVENT_FINISH
        if kind == EVENT_CANCEL:
            self.cancelled_total += 1
        else:
            self.finished_total += 1
        return StepEvent(kind=kind, rid=req.rid, step=self._step_idx,
                         output=out)

    def _process_cancels(self) -> List[StepEvent]:
        events: List[StepEvent] = []
        for req in [r for r in self.scheduler if r.cancel_requested]:
            self.scheduler.remove(req.rid)
            events.append(self._terminal_event(req, FINISH_CANCELLED))
        for req in [r for r in self.prefilling + self.running
                    if r.cancel_requested]:
            events.append(self._terminal_event(req, FINISH_CANCELLED))
        return events

    def _preempt(self, req: Request) -> StepEvent:
        """Evict a RUNNING request: free/park its KV, return its reservation
        and re-queue it with its committed tokens (resume re-prefills
        ``prompt + outputs``)."""
        self.kv.free(req.rid)
        self._reserved -= req.reserved_blocks
        req.reserved_blocks = 0
        self.running = [r for r in self.running if r.rid != req.rid]
        req.status = PREEMPTED
        req.num_preemptions += 1
        self.preempted_total += 1
        self.scheduler.add(req)
        return StepEvent(kind=EVENT_PREEMPT, rid=req.rid,
                         step=self._step_idx)

    def _sampling_rows(self, rows: List[Request], padded: int):
        """(temperatures, top_ks, top_ps) of a padded batch on the device;
        padded rows are greedy."""
        temps = np.zeros((padded,), np.float32)
        topks = np.zeros((padded,), np.int32)
        topps = np.ones((padded,), np.float32)
        for i, r in enumerate(rows):
            temps[i] = r.sampling.temperature
            topks[i] = r.sampling.top_k
            topps[i] = r.sampling.top_p
        return (self._to_device(temps), self._to_device(topks),
                self._to_device(topps))

    def _keys(self, rows: List[Request], padded: int, offset: int = 0,
              stream: Optional[int] = None) -> torch.Tensor:
        """(padded, 2) threefry keys of each row's output position
        ``len(output_tokens) + offset``: the decode stream, or a spec
        stream; padded rows get zeros. Computed on the host (a few hundred
        integer ops), then shipped."""
        keys = torch.zeros((padded, 2), dtype=torch.int64)
        base = torch.stack([r.base_key for r in rows])
        pos = torch.tensor([len(r.output_tokens) + offset for r in rows],
                           dtype=torch.int64)
        keys[:len(rows)] = sampling_mod.batch_keys(base, pos) \
            if stream is None else \
            sampling_mod.spec_batch_keys(base, pos, stream)
        return keys.to(self.device)

    def _sample(self, last: torch.Tensor, rows: List[Request], padded: int
                ) -> torch.Tensor:
        """Next token per row on the device: argmax for an all-greedy
        batch, else the per-row threefry sampler."""
        if all(r.sampling.greedy for r in rows):
            return torch.argmax(last, dim=-1)
        return sampling_mod.sample_tokens(
            last, self._keys(rows, padded), *self._sampling_rows(rows, padded))

    def _can_spec(self, req: Request) -> bool:
        """Speculate when >= 2 tokens of budget remain (accepting even one
        draft must leave room for the verifier's correction/bonus token)."""
        return (self.spec is not None and not req.no_spec
                and req.max_tokens - len(req.output_tokens) >= 2)

    def _speculate(self, rows: List[Request]):
        """Draft -> verify -> accept -> rollback for the speculating rows.

        Each row proposes ``k_eff = min(k, remaining - 1)`` tokens through
        the draft backend, then ONE batched trusted-backend pass scores
        them. The verify chunk is concatenated on the device from the
        draft's tokens; the draft tokens are fetched once, after the loop,
        which also times the draft. Returns (StepStats spec columns,
        events)."""
        b = len(rows)
        k = self.spec.k
        padded = bucket(b, 1, self.max_batch)
        # cover every scratch position up front: draft + verify write
        # positions seq_len-1 .. seq_len+k_eff-1, all inside the admission
        # reservation (k_eff <= remaining - 1)
        k_effs = []
        for r in rows:
            k_eff = min(k, r.max_tokens - len(r.output_tokens) - 1)
            k_effs.append(k_eff)
            need = self.kv.blocks_for(r.seq_len + k_eff)
            while len(self.kv.block_table(r.rid)) < need:
                self.kv.append_block(r.rid)
                r.reserved_blocks -= 1
                self._reserved -= 1
        bt = self._to_device(self.kv.table_array(
            [r.rid for r in rows], padded, self.table_width))
        sl0 = np.zeros((padded,), np.int32)
        tok0 = np.zeros((padded, 1), np.int32)
        dlen = np.zeros((padded,), np.int32)
        for i, r in enumerate(rows):
            sl0[i] = r.seq_len - 1
            tok0[i, 0] = r.last_token
            dlen[i] = k_effs[i]
        sl0_d, tok0_d = self._to_device(sl0), self._to_device(tok0)
        all_greedy = all(r.sampling.greedy for r in rows)
        if all_greedy:
            keys, samp = None, (None, None, None)
        else:
            keys = torch.stack([
                self._keys(rows, padded, j, sampling_mod.STREAM_DRAFT)
                for j in range(k)])
            samp = self._sampling_rows(rows, padded)
        t0 = time.perf_counter()
        d_toks, d_logits, _ = self.drafter.draft(
            self.params, self.kv.pools, bt, sl0_d, tok0_d,
            self._to_device(dlen), keys, *samp, greedy=all_greedy)
        d_toks_np = self._fetch(d_toks)
        t1 = time.perf_counter()
        num_new = dlen + (dlen > 0)            # k_eff + 1; 0 for padded rows
        t_logits, _ = self.verifier.verify(
            self.params, self.kv.pools, bt, sl0_d, self._to_device(num_new),
            torch.cat([tok0_d, d_toks.to(tok0_d.dtype)], dim=1))
        t_logits_np = self._fetch(t_logits)
        t2 = time.perf_counter()
        d_logits_np = None if all_greedy else self._fetch(d_logits.float())
        events: List[StepEvent] = []
        drafted_total = accepted_total = 0
        for i, r in enumerate(rows):
            k_eff = k_effs[i]
            emitted, n_acc = self.verifier.accept(
                r, k_eff, d_toks_np[i, :k_eff],
                None if d_logits_np is None else d_logits_np[i, :k_eff],
                t_logits_np[i, :k_eff + 1])
            r.spec_drafted += k_eff
            r.spec_accepted += n_acc
            drafted_total += k_eff
            accepted_total += n_acc
            reason = None
            committed = []
            for j, tok in enumerate(emitted):
                if r.logits_trace is not None:
                    r.logits_trace.append(t_logits_np[i, j])
                committed.append(int(tok))
                reason = r.append(int(tok))
                if reason:
                    break
            events.append(StepEvent(kind=EVENT_TOKEN, rid=r.rid,
                                    step=self._step_idx,
                                    tokens=tuple(committed)))
            if reason:
                events.append(self._terminal_event(r, reason))
            else:
                # rollback: blocks past the committed length (seq_len - 1
                # cached slots) return to the pool and the reservation
                freed = rollback_after_verify(self.kv, r.rid, r.seq_len - 1)
                r.reserved_blocks += freed
                self._reserved += freed
        return dict(spec_batch=b, spec_drafted=drafted_total,
                    spec_accepted=accepted_total, draft_ms=(t1 - t0) * 1e3,
                    verify_ms=(t2 - t1) * 1e3), events

    def _decode(self, batch: List[Request]):
        """One batched decode call; commits one token per row."""
        b = len(batch)
        padded = bucket(b, 1, self.max_batch)
        # the last sampled token is this step's input, written at position
        # seq_len - 1 (= cached token count)
        for r in batch:
            if (r.seq_len - 1) // self.kv.block_size >= \
                    len(self.kv.block_table(r.rid)):
                self.kv.append_block(r.rid)
                r.reserved_blocks -= 1
                self._reserved -= 1
        # clamp the table to the batch's live page span, bucketed: masked
        # columns contribute exactly 0, and the read tracks max(seq_lens)
        width = bucket(max(len(self.kv.block_table(r.rid)) for r in batch),
                       1, self.table_width)
        bt = self.kv.table_array([r.rid for r in batch], padded, width)
        sl = np.zeros((padded,), np.int32)
        toks = np.zeros((padded, 1), np.int32)
        for i, r in enumerate(batch):
            sl[i] = r.seq_len - 1
            toks[i, 0] = r.last_token
        logits, _ = lm.paged_decode_step(
            self.params, self.kv.pools, self._to_device(bt),
            self._to_device(sl), self._to_device(toks), self.cfg_decode)
        last = logits[:, -1]
        next_toks = self._fetch(self._sample(last, batch, padded))
        events: List[StepEvent] = []
        now = time.perf_counter()
        for i, r in enumerate(batch):
            if r.logits_trace is not None:
                r.logits_trace.append(last[i].float().cpu().numpy())
            reason = r.append(int(next_toks[i]), now)
            events.append(StepEvent(kind=EVENT_TOKEN, rid=r.rid,
                                    step=self._step_idx,
                                    tokens=(int(next_toks[i]),)))
            if reason:
                events.append(self._terminal_event(r, reason))
        return b, padded, events

    def _admit(self):
        """Admit queued requests under the scheduler policy while a batch
        slot and (prefix-cache-aware) worst-case block capacity exist; when
        the candidate does not fit, preempt the scheduler's victims if that
        makes it fit."""
        admitted = 0
        cached_tokens = 0
        events: List[StepEvent] = []
        while True:
            req = self.scheduler.peek()
            if req is None:
                break
            # a preempted request resumes by re-prefilling its prompt PLUS
            # its committed outputs; for a fresh request this is the prompt
            target = req.prompt + req.output_tokens
            tlen = len(target)
            total = self.kv.blocks_for(len(req.prompt) + req.max_tokens)
            if self.prefix_cache:
                matched, avail = self.kv.plan_admission(target)
            else:
                matched, avail = [], self.kv.num_available
            # a fully cached target recomputes its last position inside a
            # matched block, which may need a copy-on-write block: budget it
            spare = 1 if len(matched) * self.kv.block_size >= tlen else 0
            need = total - len(matched) + spare
            have_slot = len(self.running) + len(self.prefilling) \
                < self.max_batch
            if not have_slot or avail - self._reserved < need:
                plan = plan_victims(
                    self.scheduler, req, self.running, self.kv,
                    reserved=self._reserved, avail=avail, need=need,
                    other_slots=len(self.prefilling),
                    max_batch=self.max_batch)
                if plan is None:
                    break              # defer: preemption cannot help
                for victim in plan:
                    events.append(self._preempt(victim))
                continue               # capacity changed: re-plan admission
            self.scheduler.take(req)
            target_blocks = self.kv.blocks_for(tlen)
            if self.prefix_cache:
                hit = self.kv.commit_allocation(self.kv.plan_allocation(
                    req.rid, target, target_blocks, matched=matched))
            else:
                self.kv.allocate(req.rid, target_blocks)
                hit = 0
            # a fully cached target still recomputes its last position: the
            # engine needs that position's logits to sample the next token
            start = min(hit, tlen - 1)
            req.prefill_pos = start
            req.prefill_target = target
            req.cached_prefix_tokens = start
            cached_tokens += start
            self.cached_tokens_total += start
            self.prompt_tokens_total += tlen
            req.cow_spare = spare
            req.reserved_blocks = total - target_blocks + spare
            self._reserved += req.reserved_blocks
            req.status = PREFILLING
            self.prefilling.append(req)
            admitted += 1
        return admitted, cached_tokens, events

    def _prefill(self):
        """Advance every in-flight prefill by one chunk in ONE batched call;
        rows whose target completes commit their first token and join the
        decode batch. Returns (tokens computed, events)."""
        rows = list(self.prefilling)
        if not rows:
            return 0, []
        b = len(rows)
        padded_b = bucket(b, 1, self.max_batch)
        chunk_lens = [min(self.prefill_chunk,
                          len(r.prefill_target) - r.prefill_pos)
                      for r in rows]
        lo = min(self.min_prefill_bucket, self.prefill_chunk)
        padded_c = bucket(max(chunk_lens), lo, self.prefill_chunk)
        toks = np.zeros((padded_b, padded_c), np.int32)
        start = np.zeros((padded_b,), np.int32)
        num_new = np.zeros((padded_b,), np.int32)
        bs = self.kv.block_size
        for i, r in enumerate(rows):
            c = chunk_lens[i]
            s0 = r.prefill_pos
            # copy-on-write: a block this chunk writes into may be shared
            # with another live request
            for bi in range(s0 // bs, (s0 + c - 1) // bs + 1):
                self.kv.ensure_writable(r.rid, bi)
            if r.cow_spare:
                # the COW (or the certainty it is not needed) resolved:
                # release the admission-time spare either way
                r.reserved_blocks -= r.cow_spare
                self._reserved -= r.cow_spare
                r.cow_spare = 0
            toks[i, :c] = r.prefill_target[s0:s0 + c]
            start[i] = s0
            num_new[i] = c
        # table_array AFTER ensure_writable: COW swaps table entries
        bt = self.kv.table_array([r.rid for r in rows], padded_b,
                                 self.table_width)
        logits, _ = lm.paged_prefill(
            self.params, self.kv.pools, self._to_device(bt),
            self._to_device(toks), self._to_device(num_new), self.cfg_prefill,
            start_lens=self._to_device(start), last_only=True)
        last = logits[:, 0]
        # the token sampled at prefill completion is output position
        # len(output_tokens): 0 for a fresh request, the next committed
        # slot for a resumed one, so resume replays the same draw
        tok = self._fetch(self._sample(last, rows, padded_b))
        self.prefill_tokens_total += sum(chunk_lens)
        events: List[StepEvent] = []
        for i, r in enumerate(rows):
            r.prefill_pos += chunk_lens[i]
            if r.prefill_pos < len(r.prefill_target):
                continue                              # more chunks to go
            if self.prefix_cache:
                self.kv.register_prefix(r.rid, r.prompt)
            if r.logits_trace is not None:
                r.logits_trace.append(last[i].float().cpu().numpy())
            self.prefilling = [x for x in self.prefilling if x.rid != r.rid]
            r.status = RUNNING
            self.running.append(r)
            reason = r.append(int(tok[i]))
            events.append(StepEvent(kind=EVENT_TOKEN, rid=r.rid,
                                    step=self._step_idx,
                                    tokens=(int(tok[i]),)))
            if reason:
                events.append(self._terminal_event(r, reason))
        return sum(chunk_lens), events
