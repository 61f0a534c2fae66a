"""Continuous-batching serving engine over the paged KV cache.

Ports ``repro/serving/engine.py``. The front door is handle-and-event
shaped: ``submit()`` returns a ``RequestHandle`` immediately and each
``step()`` returns that iteration's ``StepEvent``s (TOKEN / FINISH /
PREEMPT / CANCEL); ``generate()`` is the batch-synchronous shim over the
same path.

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

Each step entry (decode, prefill, the draft loop, the verify) runs as one
program per bucket key, the port's form of the JAX engine's per-bucket
``jax.jit``: on the card a captured CUDA graph, replayed every step
(``serving/graphs.py``); on the CPU the eager entry under the same key.
``warmup()`` makes every program of the bucket grid up front.

With ``pipeline=True`` each step is plan -> collect -> launch
(``serving/pipeline.py``): host planning runs while the previously
launched step still executes on the card, its tokens commit one step
later, and this step's work is dispatched without blocking (resolved by
the next step, or by ``flush()``). Per-request token streams equal the
synchronous step's.

The FFN path per phase (dense | gather/TwELL | tile_skip) comes from the
``ServingBackend``. Stochastic sampling keys each token
``fold_in(base_key, len(output_tokens))`` as the JAX engine does, so a
seeded request gives the same tokens whatever its batch, its arrival order
or its preemptions.

Observability: ``ServingEngine(..., telemetry=True)`` (or a ``Telemetry``)
publishes per-phase step timings, lifecycle counters, KV-pool gauges,
TTFT/ITL histograms and per-request spans into a ``MetricsRegistry``
(Prometheus text via ``GET /metrics`` on the HTTP server), plus a
whole-engine step timeline exportable as Chrome-trace JSON
(``export_trace``). A graphed entry cannot time anything inside its
replay, so phase spans are host wall time around each entry's launch and
collect, as JAX's asynchronous dispatch gives too. With telemetry on, the
decode and prefill programs also compute a per-layer sparsity probe
(``nnz_mean``, ``tile_frac``, ``ffn_present``; captured in the same graph)
that reaches the host with the sampled tokens, behind the same event.
Without telemetry the engine pays only ``is None`` checks.

Disaggregation (``serving/disagg/``): ``submit(outputs=, base_key=)``
resumes a request with committed tokens under the coordinator's key,
``on_prefill_done`` fires after a prefill's first token commits and
before anything is freed, ``admit_migrated`` takes a request whose KV
another engine's pool holds straight into the decode batch, and
``withdraw`` hands a running request back to the coordinator.

Tensor parallelism: ``ServingEngine(..., mesh=make_serving_mesh(tp))``
(``distributed/sharding.py``) serves the dense family with the weights and
the KV pools split over a 1-D ``model`` mesh, one process a rank. Every
rank builds the engine on the whole weights (``bridge.shard_params`` keeps
its slice), runs the same host scheduler on the same submissions and makes
the same calls (SPMD); the step entries pass the model axis
(``sharding.ModelGroup``) down to the layers, whose collectives give every
rank the whole logits, so every rank samples the same tokens.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import bridge
from repro_torch import device as device_mod
from repro_torch.config import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.models import lm
from repro_torch.observability import accounting
from repro_torch.serving import sampling as sampling_mod
from repro_torch.serving.backends import (DECODE, PREFILL, get_backend,
                                          make_draft_pair)
from repro_torch.serving.graphs import Program, ProgramCache
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.pipeline import (DecodeLaunch, HostCopy,
                                          InFlightStep, PrefillLaunch,
                                          SpecLaunch, bucket, bucket_grid,
                                          start_host_copies, start_host_copy)
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
from repro_torch.serving.telemetry import (PHASE_ADMISSION, PHASE_CANCEL,
                                           PHASE_COLLECT, PHASE_DECODE,
                                           PHASE_DRAFT, PHASE_LAUNCH,
                                           PHASE_OVERLAP, PHASE_PLAN,
                                           PHASE_PREFILL, PHASE_SAMPLE,
                                           PHASE_VERIFY, Telemetry)

__all__ = ["ServingEngine", "StepStats", "bucket"]


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
    sync_ms: float = 0.0     # ... of which spent waiting on the device.
    #                          Pipelined mode: the RESIDUAL wait only, the
    #                          tail of the previous launch's host copies that
    #                          this step's plan work did not hide
    overlap_ms: float = 0.0  # pipelined mode only: wall time the previously
    #                          launched step ran concurrently with host work
    #                          (its launch -> collect span); 0.0 in
    #                          synchronous mode / nothing in flight
    spec_batch: int = 0      # rows that ran draft->verify this step
    spec_drafted: int = 0    # draft tokens proposed this step
    spec_accepted: int = 0   # ... of which the verifier accepted
    draft_ms: float = 0.0    # synchronous mode: wall time of the draft, to
    #                          its tokens on the host
    verify_ms: float = 0.0   # ... and of the verify pass, to its logits
    migrated_blocks: int = 0  # KV blocks materialized into this engine's pool
    #                           from another engine this step (disaggregation)
    role: str = "unified"    # engine role that produced this step
    #                          (unified | prefill | decode)


def _probe_stack(aux) -> torch.Tensor:
    """The per-layer sparsity probe as one (3, L) float32 tensor: rows
    nnz_mean, tile_frac, ffn_present."""
    return torch.stack([aux["nnz_mean"], aux["tile_frac"],
                        aux["ffn_present"]]).float()


def _pick(last: torch.Tensor, greedy: bool, samp) -> torch.Tensor:
    """Next token per row on the device: argmax for an all-greedy batch,
    else the per-row threefry sampler."""
    if greedy:
        return torch.argmax(last, dim=-1)
    return sampling_mod.sample_tokens(last, *samp)


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
                 max_stats: Optional[int] = 4096,
                 telemetry: Union[bool, Telemetry, None] = False,
                 pipeline: bool = False, warmup: bool = False,
                 role: str = "unified", device=None, mesh=None):
        self.role = role
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
        self.spec = spec
        if spec is not None:
            spec.validate()
            self.draft_pair = make_draft_pair(self.backend, spec.draft_backend,
                                              spec.draft_threshold)
        n_params = accounting.param_count(lm.trainable(params))
        self.mesh = mesh
        self.tp = 1 if mesh is None else sharding.tp_size(mesh)
        self.group: Optional[sharding.ModelGroup] = None
        if mesh is not None:
            if self.tp > 1 and cfg.family != "dense":
                raise NotImplementedError(
                    f"tensor-parallel serving takes the dense family; "
                    f"{cfg.family!r} under tp={self.tp} is queued in "
                    f"ROADMAP.md (the MoE engine under TP)")
            draft = self.draft_pair.draft if spec is not None else None
            self.backend.validate_mesh(cfg, mesh, draft)
            params = bridge.shard_params(lm.params_to(params, self.device),
                                         cfg, mesh, self.backend, draft)
            self.group = sharding.ModelGroup.of(
                mesh, cfg.d_ff, self.backend.ffn_sizes(cfg, self.tp, draft))
        self.params = lm.prepare_params(lm.params_to(params, self.device))
        if spec is not None:
            self.drafter = Drafter(
                self.draft_pair.draft.configure(cfg, DECODE), spec.k,
                group=self.group)
            self.verifier = Verifier(self.cfg_decode, group=self.group)
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
                               device=self.device, mesh=mesh)
        self.table_width = -(-max_seq_len // block_size)
        self.scheduler: Scheduler = get_scheduler(scheduler)
        # observability: metrics registry + span tracing (telemetry=True
        # builds a default Telemetry; pass an instance to share a registry
        # across engines; False/None = zero instrumentation on the hot path)
        if telemetry is True:
            telemetry = Telemetry()
        elif telemetry is False:
            telemetry = None
        self.telemetry: Optional[Telemetry] = telemetry
        if telemetry is not None:
            # attn_backend: the port's paged-KV read path, chosen by device
            telemetry.metrics.build_info.set(
                1, backend=self.backend.name,
                attn_backend="cuda" if self.device.type == "cuda"
                else "plain",
                scheduler=self.scheduler.name,
                spec_k=str(0 if spec is None else spec.k), tp=str(self.tp))
            # arm the sparsity/compute cost model: the decode/prefill
            # programs compute a per-layer (nnz, tile_frac) probe as extra
            # outputs (tokens are bit-identical with or without it); the
            # count is the whole trainable tree's, as JAX's (no derived
            # wu_t, every rank's shard)
            telemetry.attach_compute(cfg, n_params, chips=self.tp)
        self._probe = telemetry is not None
        self.prefilling: List[Request] = []
        self.running: List[Request] = []
        self.stats: List[StepStats] = []
        self.prefill_tokens_total = 0      # prompt tokens actually computed
        self.cached_tokens_total = 0       # prompt tokens served from cache
        self.prompt_tokens_total = 0       # prompt tokens admitted overall
        self.finished_total = 0            # requests finished (EOS / length)
        self.cancelled_total = 0           # requests aborted via cancel()
        self.preempted_total = 0           # scheduler evictions (resumes)
        self.migrated_blocks_total = 0     # KV blocks materialized into this
        #                                    pool from another engine (disagg)
        self._migrated_step = 0            # ... of which since the last step
        self.max_stats = max_stats         # keep only the newest N StepStats
        self.on_new_work = None            # optional callable: submit/cancel
        #                                    wake-up hook for a server loop
        self.on_prefill_done = None        # optional callable(req, reason):
        #                                    fires when a request's prefill
        #                                    target completes, AFTER its first
        #                                    sampled token commits but BEFORE
        #                                    any terminal transition frees its
        #                                    KV -- the disagg coordinator holds
        #                                    the blocks for transfer here
        self._master_key = sampling_mod.PRNGKey(seed)
        self._next_rid = 0
        self._step_idx = 0
        self._reserved = 0            # growth blocks promised to running reqs
        self._sync_s = 0.0            # device-sync seconds within this step
        self._lock = threading.RLock()
        self._requests: Dict[int, Request] = {}    # every non-terminal rid
        self._handles: Dict[int, RequestHandle] = {}
        # one program per (entry, bucket key); programs.made counts them,
        # and so does the telemetry's jit_compiles_total
        self.programs = ProgramCache(
            self.device, None if telemetry is None else telemetry.on_compile)
        # pipelined step loop (plan/launch/collect; see pipeline.py):
        # pipeline=False keeps the synchronous step as the numerics/latency
        # reference -- token streams are identical either way
        self.pipeline = bool(pipeline)
        self._inflight: Optional[InFlightStep] = None
        self._preempt_pending: List[Request] = []  # victims planned while a
        #                                            step was in flight; they
        #                                            preempt at collect
        self.warmup_seconds = 0.0
        self.warmup_report: List[Dict] = []        # per-program make timings
        if warmup:
            self.warmup()

    def _wait(self, copy: HostCopy) -> torch.Tensor:
        """A launched output on the host, attributing the wait to this
        step's ``sync_ms``."""
        t0 = time.perf_counter()
        out = copy.wait()
        self._sync_s += time.perf_counter() - t0
        return out

    def _wake(self) -> None:
        if self.on_new_work is not None:
            self.on_new_work()

    # ------------------------------------------------------------------ API

    def submit(self, prompt: Sequence[int], *,
               sampling: Optional[SamplingParams] = None,
               max_tokens: int = 16,
               eos_token_id: Optional[int] = None,
               no_spec: bool = False,
               priority: int = 0,
               stream: bool = False,
               outputs: Sequence[int] = (),
               base_key: Optional[torch.Tensor] = None) -> RequestHandle:
        """Queue a request; returns its ``RequestHandle`` immediately.
        Admission happens in ``step()`` under the scheduler policy.
        priority: larger = more urgent (the priority scheduler may preempt
        lower tiers; FCFS ignores it). stream: buffer this request's
        ``StepEvent``s on the handle. no_spec: decode this request one
        token at a time even in a speculating engine.

        outputs / base_key are the disaggregation coordinator's resume
        interface: ``outputs`` pre-commits already-generated tokens (the
        request admits exactly like a preempt-resume, prefilling
        ``prompt + outputs``; ``max_tokens`` still counts TOTAL outputs and
        must exceed ``len(outputs)``), and ``base_key`` replaces the
        per-request threefry base key, so a cross-engine request samples
        with the key of the coordinator rid it belongs to, not this
        engine's local rid."""
        with self._lock:
            sp = sampling or SamplingParams()
            if outputs and max_tokens <= len(outputs):
                raise ValueError(
                    f"max_tokens ({max_tokens}) must exceed pre-committed "
                    f"outputs ({len(outputs)})")
            req = Request(rid=self._next_rid, prompt=list(map(int, prompt)),
                          max_tokens=max_tokens, sampling=sp,
                          eos_token_id=eos_token_id, no_spec=no_spec,
                          priority=priority,
                          output_tokens=list(map(int, outputs)))
            req.role = self.role
            if len(req.prompt) + max_tokens > self.max_seq_len:
                raise ValueError(
                    f"prompt ({len(req.prompt)}) + max_tokens ({max_tokens}) "
                    f"exceeds max_seq_len ({self.max_seq_len})")
            worst = self.kv.blocks_for(len(req.prompt) + max_tokens)
            if worst > self.kv.num_blocks - 1:
                raise ValueError(
                    f"request needs {worst} KV blocks but the pool only has "
                    f"{self.kv.num_blocks - 1}; it could never be admitted")
            req.base_key = base_key if base_key is not None else \
                sampling_mod.request_base_key(
                    self._master_key, req.rid, sp.seed)
            if self.record_logits:
                req.logits_trace = []
            self._next_rid += 1
            handle = RequestHandle(self, req, stream=stream)
            self._requests[req.rid] = req
            self._handles[req.rid] = handle
            if self.telemetry is not None:
                self.telemetry.on_submit(req)
            self.scheduler.add(req)
        self._wake()
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
        Lock-free: it only flags the request (and wakes a server loop)."""
        rid = request.rid if isinstance(request, RequestHandle) \
            else int(request)
        req = self._requests.get(rid)
        if req is None or req.done:
            return False
        req.cancel_requested = True
        self._wake()
        return True

    def admit_migrated(self, req: Request,
                       migrate_fn) -> Optional[RequestHandle]:
        """Admit a request whose KV arrives from ANOTHER engine's pool
        (disaggregated serving): the decode-side half of a migration.

        ``req`` is a coordinator-owned ``Request`` carrying committed
        ``output_tokens``; this pool holds nothing of it yet. The method
        plans a prefix-cache-aware allocation for its ``seq_len - 1``
        cached positions (matched full prompt blocks dedupe against this
        pool's content-hash index: their K/V is the same by construction,
        so the transfer skips them), claims the remaining blocks fresh,
        and calls ``migrate_fn(fresh_blocks, skip_blocks)`` to fill them
        from the source pool. The request then joins the decode batch
        directly: ZERO prefill chunks run here, and its first decode writes
        position ``seq_len - 1``, where a preempt-resume would continue.
        Matched blocks are never written (the next write lands in a fresh
        or appended private block), so no copy-on-write is needed.

        Returns the engine-side ``RequestHandle``, or None when a batch
        slot or the worst-case block reservation is not free right now
        (the caller retries after capacity frees up)."""
        with self._lock:
            if req.rid in self._requests or req.rid in self.kv:
                raise ValueError(f"rid {req.rid} already live in this engine")
            cached = req.seq_len - 1
            plen = len(req.prompt)
            total = self.kv.blocks_for(plen + req.max_tokens)
            if plen + req.max_tokens > self.max_seq_len:
                raise ValueError(
                    f"prompt ({plen}) + max_tokens ({req.max_tokens}) "
                    f"exceeds max_seq_len ({self.max_seq_len})")
            if total > self.kv.num_blocks - 1:
                raise ValueError(
                    f"request needs {total} KV blocks but the pool only has "
                    f"{self.kv.num_blocks - 1}; it could never be admitted")
            n_blocks = self.kv.blocks_for(cached)
            if self.prefix_cache:
                matched, avail = self.kv.plan_admission(req.prompt)
            else:
                matched, avail = [], self.kv.num_available
            have_slot = len(self.running) + len(self.prefilling) \
                < self.max_batch
            if not have_slot or avail - self._reserved < total - len(matched):
                return None
            if self.prefix_cache:
                self.kv.commit_allocation(self.kv.plan_allocation(
                    req.rid, req.prompt, n_blocks, matched=matched))
            else:
                self.kv.allocate(req.rid, n_blocks)
            fresh = self.kv.block_table(req.rid)[len(matched):]
            if fresh:
                migrate_fn(fresh, len(matched))
            if self.prefix_cache:
                self.kv.register_prefix(req.rid, req.prompt)
            hit = len(matched) * self.kv.block_size
            req.cached_prefix_tokens = hit
            self.cached_tokens_total += hit
            self.prompt_tokens_total += plen
            req.migrated_blocks += len(fresh)
            self.migrated_blocks_total += len(fresh)
            self._migrated_step += len(fresh)
            req.reserved_blocks = total - n_blocks
            self._reserved += req.reserved_blocks
            req.cow_spare = 0
            req.status = RUNNING
            req.role = self.role
            handle = RequestHandle(self, req)
            self._requests[req.rid] = req
            self._handles[req.rid] = handle
            self.running.append(req)
            if self.telemetry is not None:
                self.telemetry.on_migrated(req, len(fresh))
        self._wake()
        return handle

    def withdraw(self, rid: int) -> Optional[Request]:
        """Remove a RUNNING request from this engine, freeing/parking its
        KV and returning the ``Request`` (committed outputs intact) to the
        caller instead of this engine's own queue: the disagg
        coordinator's cross-engine preemption. The withdrawn request
        re-queues at the coordinator, re-prefills on the prefill engine
        and migrates again, as an in-engine preempt-resume would. Returns
        None when the rid is unknown or not running."""
        with self._lock:
            if self._inflight is not None:
                raise RuntimeError(
                    "cannot withdraw with a launched step in flight; "
                    "flush() first (disagg engines run pipeline=False)")
            req = self._requests.get(rid)
            if req is None or req.status != RUNNING:
                return None
            self.kv.free(rid)
            self._reserved -= req.reserved_blocks
            req.reserved_blocks = 0
            req.cow_spare = 0
            self.running = [r for r in self.running if r.rid != rid]
            self._requests.pop(rid, None)
            self._handles.pop(rid, None)
            req.status = PREEMPTED
            req.num_preemptions += 1
            self.preempted_total += 1
            if self.telemetry is not None:
                self.telemetry.on_preempt(req)
            return req

    def has_unfinished(self) -> bool:
        return bool(len(self.scheduler) or self.prefilling or self.running
                    or self._inflight is not None)

    def step(self) -> List[StepEvent]:
        """One engine iteration (cancel, decode or draft->verify, admit,
        prefill); returns this iteration's StepEvents in commit order, also
        dispatched to each request's handle.

        With ``pipeline=True`` the same work is re-ordered into
        plan -> collect -> launch: host planning runs while the previously
        launched step is still executing, its tokens commit at collect, and
        this step's device work is dispatched without blocking (resolved by
        the NEXT step, or by ``flush()``). Per-request token streams are
        identical in both modes."""
        with self._lock, torch.no_grad():
            if self.pipeline:
                return self._step_pipelined()
            return self._step_sync()

    def _step_sync(self) -> List[StepEvent]:
        """The fully synchronous step: each phase launches AND collects
        before the next phase plans (the numerics/latency reference for the
        pipelined loop)."""
        tm = self.telemetry
        t_step = time.perf_counter()
        self._sync_s = 0.0
        events: List[StepEvent] = self._process_cancels()
        if tm is not None:
            tm.phase(PHASE_CANCEL, t_step, time.perf_counter(),
                     self._step_idx)
        decode_batch = padded = 0
        spec = {}
        if self.running:
            spec_rows = [r for r in self.running if self._can_spec(r)]
            normal_rows = [r for r in self.running if not self._can_spec(r)]
            if normal_rows:
                t0 = time.perf_counter()
                dl = self._launch_decode(normal_rows)
                decode_batch, padded = dl.batch, dl.padded
                events.extend(self._collect_decode(dl))
                if tm is not None:
                    tm.phase(PHASE_DECODE, t0, time.perf_counter(),
                             self._step_idx)
            if spec_rows:
                # draft / verify / sample sub-phases are timed inside
                spec, evs = self._collect_spec(
                    self._launch_spec(spec_rows, timed=True), timed=True)
                events.extend(evs)
        t0 = time.perf_counter()
        admitted, cached_toks, evs = self._admit()
        events.extend(evs)
        if tm is not None:
            tm.phase(PHASE_ADMISSION, t0, time.perf_counter(),
                     self._step_idx)
        t0 = time.perf_counter()
        pf_tokens = 0
        pl = self._launch_prefill()
        if pl is not None:
            pf_tokens = sum(pl.chunk_lens)
            events.extend(self._collect_prefill(pl))
            if tm is not None and pf_tokens:
                tm.phase(PHASE_PREFILL, t0, time.perf_counter(),
                         self._step_idx)
        return self._finalize_step(
            events, t_step=t_step, decode_batch=decode_batch, padded=padded,
            admitted=admitted, cached_toks=cached_toks, pf_tokens=pf_tokens,
            **spec)

    def _step_pipelined(self) -> List[StepEvent]:
        """plan(N+1) concurrent with device(N): host planning first, then
        resolve the previously launched step, then dispatch new device work
        without blocking on it.

        The external contract (per-request event/token streams) matches the
        synchronous path. StepStats attribution shifts by construction:
        decode/prefill columns describe THIS call's launch, the spec
        columns describe the collected (previous) launch, and terminal /
        preempt counts describe events committed by this call.

        Safety invariant: while a launched step is in flight, every
        prefilling/running row is part of it, and plan-phase work only
        claims free or refcount-zero blocks -- so cancels and preemptions of
        launched rows are DEFERRED and settle at collect, right after their
        in-flight tokens commit, and nothing the device is reading or
        writing is ever freed, COW-copied, or reallocated under it."""
        tm = self.telemetry
        t_step = time.perf_counter()
        self._sync_s = 0.0
        inflight = self._inflight
        # ---- plan: pure host work against committed state
        events = self._process_cancels(defer_inflight=inflight is not None)
        t0 = time.perf_counter()
        if tm is not None:
            tm.phase(PHASE_CANCEL, t_step, t0, self._step_idx)
        admitted, cached_toks, evs = self._admit(
            defer_preempt=inflight is not None)
        events.extend(evs)
        t_plan_end = time.perf_counter()
        if tm is not None:
            tm.phase(PHASE_ADMISSION, t0, t_plan_end, self._step_idx)
            tm.phase(PHASE_PLAN, t_step, t_plan_end, self._step_idx)
        # ---- collect: resolve the previous launch, commit its tokens
        overlap_ms = 0.0
        spec = {}
        if inflight is not None:
            self._inflight = None
            t_collect0 = time.perf_counter()
            overlap_ms = (t_collect0 - inflight.t_launched) * 1e3
            if tm is not None:
                tm.phase(PHASE_OVERLAP, inflight.t_launched, t_collect0,
                         self._step_idx)
            spec, evs = self._collect_inflight(inflight)
            events.extend(evs)
            if tm is not None:
                tm.phase(PHASE_COLLECT, t_collect0, time.perf_counter(),
                         self._step_idx)
        # ---- launch: dispatch on post-collect state; nothing blocks
        t_launch0 = time.perf_counter()
        decode_batch = padded = pf_tokens = 0
        dl = sl = None
        if self.running:
            spec_rows = [r for r in self.running if self._can_spec(r)]
            normal_rows = [r for r in self.running if not self._can_spec(r)]
            if normal_rows:
                dl = self._launch_decode(normal_rows)
                decode_batch, padded = dl.batch, dl.padded
            if spec_rows:
                sl = self._launch_spec(spec_rows, timed=False)
        pl = self._launch_prefill()
        if pl is not None:
            pf_tokens = sum(pl.chunk_lens)
        if dl is not None or sl is not None or pl is not None:
            self._inflight = InFlightStep(decode=dl, spec=sl, prefill=pl,
                                          t_launched=time.perf_counter())
        if tm is not None:
            tm.phase(PHASE_LAUNCH, t_launch0, time.perf_counter(),
                     self._step_idx)
        return self._finalize_step(
            events, t_step=t_step, decode_batch=decode_batch, padded=padded,
            admitted=admitted, cached_toks=cached_toks, pf_tokens=pf_tokens,
            overlap_ms=overlap_ms, **spec)

    def _collect_inflight(self, inflight: InFlightStep):
        """Commit everything ``inflight`` launched, then the preemptions
        planned while it ran. Returns (StepStats spec columns, events)."""
        events: List[StepEvent] = []
        spec = {}
        if inflight.decode is not None:
            events.extend(self._collect_decode(inflight.decode))
        if inflight.spec is not None:
            spec, evs = self._collect_spec(inflight.spec, timed=False)
            events.extend(evs)
        if inflight.prefill is not None:
            events.extend(self._collect_prefill(inflight.prefill))
        events.extend(self._flush_pending_preempts())
        return spec, events

    def flush(self) -> List[StepEvent]:
        """Drain the pipelined tail: resolve the in-flight launched step (if
        any) WITHOUT launching new work, commit its tokens, dispatch its
        events to the handles, and return them. A no-op (empty list) in
        synchronous mode or when nothing is in flight. ``generate()`` drains
        via ``has_unfinished()`` + ``step()``, which subsumes this; a
        long-lived caller calls it on shutdown so a launched step never
        outlives the process's clean exit."""
        with self._lock:
            inflight = self._inflight
            if inflight is None:
                return []
            self._inflight = None
            self._sync_s = 0.0
            _, events = self._collect_inflight(inflight)
            self._dispatch_events(events)
            return events

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
                       cached_toks: int, pf_tokens: int,
                       overlap_ms: float = 0.0, spec_batch: int = 0,
                       spec_drafted: int = 0, spec_accepted: int = 0,
                       draft_ms: float = 0.0, verify_ms: float = 0.0
                       ) -> List[StepEvent]:
        """Shared step epilogue: StepStats, telemetry rollup and handle
        dispatch, identical between the synchronous and pipelined loops."""
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
            sync_ms=self._sync_s * 1e3, overlap_ms=overlap_ms,
            spec_batch=spec_batch, spec_drafted=spec_drafted,
            spec_accepted=spec_accepted, draft_ms=draft_ms,
            verify_ms=verify_ms, migrated_blocks=self._migrated_step,
            role=self.role))
        self._migrated_step = 0
        if self.max_stats is not None and len(self.stats) >= 2 * self.max_stats:
            del self.stats[:-self.max_stats]     # amortized O(1) trim
        if self.telemetry is not None:
            self.telemetry.on_step(kv=self.kv, reserved=self._reserved,
                                   wall_s=time.perf_counter() - t_step,
                                   sync_s=self._sync_s)
        self._dispatch_events(events)
        return events

    def _dispatch_events(self, events: List[StepEvent]) -> None:
        for ev in events:
            h = self._handles.get(ev.rid)
            if h is not None:
                h._on_event(ev)
                if ev.terminal:
                    self._handles.pop(ev.rid, None)

    def export_trace(self, path: str) -> None:
        """Write the Chrome-trace JSON timeline (requires telemetry with
        tracing on; open the file in chrome://tracing or ui.perfetto.dev)."""
        if self.telemetry is None or self.telemetry.trace is None:
            raise RuntimeError("engine was built without trace telemetry; "
                               "construct with ServingEngine(..., "
                               "telemetry=True)")
        with self._lock:
            live = list(self._requests.values())
        self.telemetry.trace.export(path, live_requests=live)

    def _finish(self, req: Request, reason: str) -> RequestOutput:
        """Terminal transition (EOS / length / cancel) from any live state."""
        if req.rid in self.kv:
            self.kv.free(req.rid)
        req.status = CANCELLED if reason == FINISH_CANCELLED else FINISHED
        req.finish_reason = reason
        req.finish_time = time.perf_counter()
        if self.telemetry is not None:
            # before RequestOutput.from_request so the FINISH/CANCEL instant
            # lands on the spans the output snapshots
            self.telemetry.on_terminal(req, reason,
                                       cancelled=reason == FINISH_CANCELLED)
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

    def _process_cancels(self, defer_inflight: bool = False
                         ) -> List[StepEvent]:
        """Abort every request flagged since the last step, wherever it is:
        queued (no KV to release), or admitted (prefilling/running/spec --
        blocks freed or parked, reservation returned).

        defer_inflight: plan-phase mode with a launched step still
        executing. Queued cancels process immediately (no KV, not part of
        any launch); prefilling/running rows are ALL part of the in-flight
        step -- freeing their blocks now would mutate tables the device is
        still reading/writing -- so their flag stays set and collect
        resolves it right after their launched tokens commit."""
        events: List[StepEvent] = []
        for req in [r for r in self.scheduler if r.cancel_requested]:
            self.scheduler.remove(req.rid)
            events.append(self._terminal_event(req, FINISH_CANCELLED))
        if defer_inflight:
            return events
        for req in [r for r in self.prefilling + self.running
                    if r.cancel_requested]:
            events.append(self._terminal_event(req, FINISH_CANCELLED))
        return events

    def _deferred_cancel(self, req: Request) -> Optional[StepEvent]:
        """Pipelined collect: resolve a cancel flagged while this row's
        step was in flight (its just-launched token has already committed --
        cancellation never shortens the stream vs the synchronous path).
        Always None in synchronous mode, whose cancel timing -- flags
        processed at the NEXT step's cancel phase -- must stay untouched."""
        if self.pipeline and req.cancel_requested:
            return self._terminal_event(req, FINISH_CANCELLED)
        return None

    def _flush_pending_preempts(self) -> List[StepEvent]:
        """Apply preemptions planned while a step was in flight. Runs at
        collect, after the victims' launched tokens committed; a victim
        that reached a terminal state in the meantime (finished naturally,
        or cancelled) has nothing left to preempt."""
        events: List[StepEvent] = []
        pending, self._preempt_pending = self._preempt_pending, []
        for req in pending:
            if not req.done and any(r.rid == req.rid for r in self.running):
                events.append(self._preempt(req))
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
        if self.telemetry is not None:
            self.telemetry.on_preempt(req)
        self.scheduler.add(req)
        return StepEvent(kind=EVENT_PREEMPT, rid=req.rid,
                         step=self._step_idx)

    def _can_spec(self, req: Request) -> bool:
        """Speculate when >= 2 tokens of budget remain (accepting even one
        draft must leave room for the verifier's correction/bonus token)."""
        return (self.spec is not None and not req.no_spec
                and req.max_tokens - len(req.output_tokens) >= 2)

    def _publish_ffn(self, ffn_aux: Optional[HostCopy], tokens: int,
                     cfg_phase) -> None:
        """Hand a probed forward's per-layer (nnz, tile_frac, present) stack
        to the telemetry cost model. ``tokens`` is the REAL token count
        (padding rows count in the averaged stats, not in FLOPs credit).
        The probe shares the sampled tokens' event: its wait is free."""
        if ffn_aux is None or self.telemetry is None:
            return
        probe = self._wait(ffn_aux).numpy().astype(np.float64)
        self.telemetry.on_ffn(tokens, probe[0], tile_frac_per_layer=probe[1],
                              ffn_present=probe[2],
                              impl=cfg_phase.sparsity.ffn_impl)

    # ----------------------------------------------------------- programs
    # A program's entry closes over what it reads (weights, pools, config),
    # never over the engine: the engine holds its programs, and a cycle
    # through the entry would keep a dropped engine, its pools and its
    # graphs' memory alive until the garbage collector runs.

    def _samp_args(self, rows: List[Request], padded: int, keys: np.ndarray
                   ) -> List[np.ndarray]:
        """(keys, temperatures, top_ks, top_ps) of a padded batch; padded
        rows are greedy."""
        temps = np.zeros((padded,), np.float32)
        topks = np.zeros((padded,), np.int32)
        topps = np.ones((padded,), np.float32)
        for i, r in enumerate(rows):
            temps[i] = r.sampling.temperature
            topks[i] = r.sampling.top_k
            topps[i] = r.sampling.top_p
        return [keys, temps, topks, topps]

    def _keys(self, rows: List[Request], padded: int, offset: int = 0,
              stream: Optional[int] = None) -> np.ndarray:
        """(padded, 2) threefry keys of each row's output position
        ``len(output_tokens) + offset``: the decode stream, or a spec
        stream; padded rows get zeros. Computed on the host (a few hundred
        integer ops); the program copies them in with its other inputs."""
        keys = np.zeros((padded, 2), np.int64)
        base = torch.stack([r.base_key for r in rows])
        pos = torch.tensor([len(r.output_tokens) + offset for r in rows],
                           dtype=torch.int64)
        keys[:len(rows)] = (sampling_mod.batch_keys(base, pos)
                            if stream is None else
                            sampling_mod.spec_batch_keys(base, pos, stream)
                            ).numpy()
        return keys

    @staticmethod
    def _null_samp(padded: int, keys_shape) -> List[np.ndarray]:
        """Dummy sampling inputs: temps = top_p = 1 keep the sampling
        variant's math well-defined over the null block's garbage."""
        return [np.zeros(keys_shape, np.int64), np.ones((padded,), np.float32),
                np.zeros((padded,), np.int32), np.ones((padded,), np.float32)]

    def _jit_decode(self, padded: int, width: int, greedy: bool) -> Program:
        """The decode program at (padded batch, table width, greedy).
        ``width`` is the bucketed block-table width the step runs at, so a
        short-context step reads only its live page span; it is part of the
        key because the program's shapes are. Inputs (bt, sl, toks[, keys,
        temps, topks, topps]); outputs (tok, last-position logits[, the
        (3, L) sparsity probe when the engine has telemetry])."""
        params, pools, cfg = self.params, self.kv.pools, self.cfg_decode
        probe, group = self._probe, self.group

        def fn(bt, sl, toks, *samp):
            out = lm.paged_decode_step(params, pools, bt, sl, toks, cfg,
                                       collect_aux=probe, group=group)
            last = out[0][:, -1]
            tok = _pick(last, greedy, samp)
            return (tok, last, _probe_stack(out[1])) if probe else \
                (tok, last)

        def dummy():
            args = [np.zeros((padded, width), np.int32),
                    np.zeros((padded,), np.int32),
                    np.zeros((padded, 1), np.int32)]
            return args if greedy else args + self._null_samp(padded,
                                                              (padded, 2))
        return self.programs.get("decode", (padded, width, greedy), fn, dummy)

    def _jit_prefill(self, padded_b: int, padded_c: int, greedy: bool
                     ) -> Program:
        """The prefill program at (padded batch, padded chunk, greedy).
        Inputs (bt, toks, start, num_new[, keys, temps, topks, topps]);
        outputs (tok, last valid position's logits[, the probe])."""
        params, pools, cfg = self.params, self.kv.pools, self.cfg_prefill
        probe, group = self._probe, self.group

        def fn(bt, toks, start, num_new, *samp):
            # last_only: the head runs on each row's final valid hidden
            # state only -- never (B, C, V) over the whole chunk
            out = lm.paged_prefill(params, pools, bt, toks, num_new, cfg,
                                   start_lens=start, last_only=True,
                                   collect_aux=probe, group=group)
            last = out[0][:, 0]
            tok = _pick(last, greedy, samp)
            return (tok, last, _probe_stack(out[1])) if probe else \
                (tok, last)

        def dummy():
            args = [np.zeros((padded_b, self.table_width), np.int32),
                    np.zeros((padded_b, padded_c), np.int32),
                    np.zeros((padded_b,), np.int32),
                    np.zeros((padded_b,), np.int32)]
            return args if greedy else args + self._null_samp(padded_b,
                                                              (padded_b, 2))
        return self.programs.get("prefill", (padded_b, padded_c, greedy), fn,
                                 dummy)

    def _jit_draft(self, padded: int, greedy: bool) -> Program:
        """The whole k-step draft loop as one program at (padded batch,
        greedy). Inputs (bt, sl0, tok0, draft_len[, keys (k, padded, 2),
        temps, topks, topps]); outputs (draft tokens (padded, k), draft
        logits (padded, k, V))."""
        k = self.spec.k
        params, pools, drafter = self.params, self.kv.pools, self.drafter

        def fn(bt, sl0, tok0, dlen, *samp):
            keys, rest = (samp[0], samp[1:]) if samp else (None, (None,) * 3)
            toks, logits, _ = drafter.draft(params, pools, bt, sl0, tok0,
                                            dlen, keys, *rest, greedy=greedy)
            return toks, logits

        def dummy():
            args = [np.zeros((padded, self.table_width), np.int32),
                    np.zeros((padded,), np.int32),
                    np.zeros((padded, 1), np.int32),
                    np.zeros((padded,), np.int32)]
            return args if greedy else args + self._null_samp(padded,
                                                              (k, padded, 2))
        return self.programs.get("draft", (padded, greedy), fn, dummy)

    def _jit_verify(self, padded: int) -> Program:
        """The batched verify at (padded batch,). Inputs (bt, start,
        num_new, tok0 (padded, 1), drafts (padded, k)): the token block
        [tok0 | drafts] is built inside the program, from the draft
        program's output copied in on the card. Output: float32 logits
        (padded, k+1, V)."""
        k = self.spec.k
        params, pools, verifier = self.params, self.kv.pools, self.verifier

        def fn(bt, start, num_new, tok0, drafts):
            toks = torch.cat([tok0, drafts.to(tok0.dtype)], dim=1)
            logits, _ = verifier.verify(params, pools, bt, start, num_new,
                                        toks)
            return logits

        def dummy():
            return [np.zeros((padded, self.table_width), np.int32),
                    np.zeros((padded,), np.int32),
                    np.zeros((padded,), np.int32),
                    np.zeros((padded, 1), np.int32),
                    np.zeros((padded, k), np.int64)]
        return self.programs.get("verify", (padded,), fn, dummy)

    # ----------------------------------------------------- launch / collect

    def _grow(self, r: Request, need: int) -> None:
        """Append blocks until the request's table holds ``need``, each
        drawn from its admission reservation."""
        while len(self.kv.block_table(r.rid)) < need:
            self.kv.append_block(r.rid)
            r.reserved_blocks -= 1
            self._reserved -= 1

    def _launch_decode(self, batch: List[Request]) -> DecodeLaunch:
        """Replay one batched decode program; no blocking readback. The
        device->host copy of the sampled row starts immediately so collect
        pays only the residual transfer tail."""
        b = len(batch)
        padded = bucket(b, 1, self.max_batch)
        # the last sampled token is this step's input, written at position
        # seq_len - 1 (= cached token count)
        for r in batch:
            self._grow(r, (r.seq_len - 1) // self.kv.block_size + 1)
        # clamp the table to the batch's live page span, bucketed: masked
        # columns contribute exactly 0, and the read tracks max(seq_lens)
        width = bucket(max(len(self.kv.block_table(r.rid)) for r in batch),
                       1, self.table_width)
        args = [self.kv.table_array([r.rid for r in batch], padded, width),
                np.zeros((padded,), np.int32),
                np.zeros((padded, 1), np.int32)]
        for i, r in enumerate(batch):
            args[1][i] = r.seq_len - 1
            args[2][i, 0] = r.last_token
        greedy = all(r.sampling.greedy for r in batch)
        if not greedy:
            args += self._samp_args(batch, padded, self._keys(batch, padded))
        tok, last, *probe = self._jit_decode(padded, width, greedy)(*args)
        next_toks, *ffn_aux = start_host_copies(tok, *probe)
        return DecodeLaunch(
            rows=list(batch), batch=b, padded=padded, next_toks=next_toks,
            logits=start_host_copy(last) if self.record_logits else None,
            ffn_aux=ffn_aux[0] if ffn_aux else None)

    def _collect_decode(self, dl: DecodeLaunch) -> List[StepEvent]:
        """Resolve a launched decode: wait for the sampled row (counted as
        sync), then commit one token per row and settle deferred cancels."""
        next_toks = self._wait(dl.next_toks).numpy()
        logits = None if dl.logits is None else \
            self._wait(dl.logits).float().numpy()
        self._publish_ffn(dl.ffn_aux, dl.batch, self.cfg_decode)
        events: List[StepEvent] = []
        now = time.perf_counter()
        for i, r in enumerate(dl.rows):
            if r.logits_trace is not None:
                r.logits_trace.append(logits[i])
            reason = r.append(int(next_toks[i]), now)
            if self.telemetry is not None:
                self.telemetry.on_tokens(r, 1, now)
            events.append(StepEvent(kind=EVENT_TOKEN, rid=r.rid,
                                    step=self._step_idx,
                                    tokens=(int(next_toks[i]),)))
            if reason:
                events.append(self._terminal_event(r, reason))
            else:
                cancel_ev = self._deferred_cancel(r)
                if cancel_ev is not None:
                    events.append(cancel_ev)
        return events

    def _launch_spec(self, rows: List[Request], *, timed: bool) -> SpecLaunch:
        """Replay draft -> verify for the speculating rows.

        Each row proposes ``k_eff = min(k, remaining - 1)`` tokens through
        the draft backend, then ONE batched trusted-backend pass scores
        them. The verify token block is built ON THE CARD from the draft's
        output, so both replays go out back-to-back with no host readback
        between them -- in pipelined mode (``timed=False``) nothing here
        blocks at all; the synchronous path (``timed=True``) keeps its
        draft/verify timing by waiting for the draft's tokens before it
        replays the verify."""
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
            self._grow(r, self.kv.blocks_for(r.seq_len + k_eff))
        bt = self.kv.table_array([r.rid for r in rows], padded,
                                 self.table_width)
        sl0 = np.zeros((padded,), np.int32)
        tok0 = np.zeros((padded, 1), np.int32)
        dlen = np.zeros((padded,), np.int32)
        for i, r in enumerate(rows):
            sl0[i] = r.seq_len - 1
            tok0[i, 0] = r.last_token
            dlen[i] = k_effs[i]
        greedy = all(r.sampling.greedy for r in rows)
        dargs = [bt, sl0, tok0, dlen]
        if not greedy:
            keys = np.stack([self._keys(rows, padded, j,
                                        sampling_mod.STREAM_DRAFT)
                             for j in range(k)])
            dargs += self._samp_args(rows, padded, keys)
        t_draft0 = time.perf_counter()
        d_toks, d_logits = self._jit_draft(padded, greedy)(*dargs)
        d_copy = start_host_copy(d_toks)
        dl_copy = None if greedy else start_host_copy(d_logits)
        if timed:
            self._wait(d_copy)
            if self.telemetry is not None:
                self.telemetry.phase(PHASE_DRAFT, t_draft0,
                                     time.perf_counter(), self._step_idx)
        num_new = (dlen + (dlen > 0)).astype(np.int32)  # k_eff + 1; 0 padded
        t_verify0 = time.perf_counter()
        t_logits = self._jit_verify(padded)(bt, sl0, num_new, tok0, d_toks)
        return SpecLaunch(rows=list(rows), batch=b, padded=padded,
                          k_effs=k_effs, all_greedy=greedy, d_toks=d_copy,
                          d_logits=dl_copy,
                          t_logits=start_host_copy(t_logits),
                          t_verify0=t_verify0, t_draft0=t_draft0)

    def _collect_spec(self, sl: SpecLaunch, *, timed: bool):
        """Resolve a launched draft+verify pair: accept on the host, commit
        the accepted prefix + correction/bonus token per row (>= 1 token
        guaranteed), roll the block-table tail covering rejected scratch
        positions back to the pool, and settle deferred cancels. Returns
        (StepStats spec columns, events)."""
        tm = self.telemetry
        d_toks = self._wait(sl.d_toks).numpy()
        t_logits = self._wait(sl.t_logits).numpy()
        t_done = time.perf_counter()
        if timed and tm is not None:
            tm.phase(PHASE_VERIFY, sl.t_verify0, t_done, self._step_idx)
        d_logits = None if sl.all_greedy else \
            self._wait(sl.d_logits).float().numpy()
        events: List[StepEvent] = []
        drafted_total = accepted_total = 0
        t_sample = time.perf_counter()
        for i, r in enumerate(sl.rows):
            k_eff = sl.k_effs[i]
            emitted, n_acc = self.verifier.accept(
                r, k_eff, d_toks[i, :k_eff],
                None if d_logits is None else d_logits[i, :k_eff],
                t_logits[i, :k_eff + 1])
            r.spec_drafted += k_eff
            r.spec_accepted += n_acc
            drafted_total += k_eff
            accepted_total += n_acc
            reason = None
            committed = []
            for j, tok in enumerate(emitted):
                if r.logits_trace is not None:
                    r.logits_trace.append(t_logits[i, j])
                committed.append(int(tok))
                reason = r.append(int(tok))
                if reason:
                    break
            if tm is not None:
                tm.on_spec(r, k_eff, n_acc)
                tm.on_tokens(r, len(committed))
            events.append(StepEvent(kind=EVENT_TOKEN, rid=r.rid,
                                    step=self._step_idx,
                                    tokens=tuple(committed)))
            if reason:
                events.append(self._terminal_event(r, reason))
                continue
            cancel_ev = self._deferred_cancel(r)
            if cancel_ev is not None:
                # _finish freed the whole table, scratch tail included
                events.append(cancel_ev)
                continue
            # rollback: blocks past the committed length (seq_len - 1
            # cached slots) return to the pool and the reservation
            freed = rollback_after_verify(self.kv, r.rid, r.seq_len - 1)
            r.reserved_blocks += freed
            self._reserved += freed
        if tm is not None:
            # host-side acceptance / rejection sampling over the whole batch
            tm.phase(PHASE_SAMPLE, t_sample, time.perf_counter(),
                     self._step_idx)
        stats = dict(spec_batch=sl.batch, spec_drafted=drafted_total,
                     spec_accepted=accepted_total)
        if timed:
            stats.update(draft_ms=(sl.t_verify0 - sl.t_draft0) * 1e3,
                         verify_ms=(t_done - sl.t_verify0) * 1e3)
        return stats, events

    def _admit(self, defer_preempt: bool = False):
        """Admit queued requests under the scheduler policy while a batch
        slot and (prefix-cache-aware) worst-case block capacity exist; when
        the candidate does not fit, preempt the scheduler's victims if that
        makes it fit.

        defer_preempt: plan-phase mode with a launched step in flight.
        Victims must keep running until their launched tokens commit, so
        the planned set is parked in ``_preempt_pending`` (applied at
        collect) and the candidate re-tries on a later plan against the
        freed capacity. Block allocation itself is safe while in flight:
        ``plan_allocation``/``commit_allocation`` only claim free-list or
        refcount-zero LRU blocks, which no launched table references."""
        admitted = 0
        cached_tokens = 0
        events: List[StepEvent] = []
        while True:
            if self._preempt_pending:
                # a victim set is already planned but its blocks free only
                # at collect; admission state is stale until then
                break
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
                if defer_preempt:
                    self._preempt_pending.extend(plan)
                    break              # victims free at collect; re-plan then
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
            if self.telemetry is not None:
                self.telemetry.on_admit(req, start, tlen - start)
            req.cow_spare = spare
            req.reserved_blocks = total - target_blocks + spare
            self._reserved += req.reserved_blocks
            req.status = PREFILLING
            self.prefilling.append(req)
            admitted += 1
        return admitted, cached_tokens, events

    def _launch_prefill(self) -> Optional[PrefillLaunch]:
        """Advance every in-flight prefill by one chunk in ONE batched
        replay; rows whose target completes sample their first token from
        the same call. Returns None when nothing is prefilling; otherwise
        the launched (unresolved) call -- ``_collect_prefill`` commits it."""
        rows = list(self.prefilling)
        if not rows:
            return None
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
        args = [self.kv.table_array([r.rid for r in rows], padded_b,
                                    self.table_width), toks, start, num_new]
        greedy = all(r.sampling.greedy for r in rows)
        if not greedy:
            # the token sampled at prefill completion is output position
            # len(output_tokens): 0 for a fresh request, the next committed
            # slot for a resumed one, so resume replays the same draw
            args += self._samp_args(rows, padded_b, self._keys(rows,
                                                               padded_b))
        tok, last, *probe = self._jit_prefill(padded_b, padded_c,
                                              greedy)(*args)
        self.prefill_tokens_total += sum(chunk_lens)
        tok_copy, *ffn_aux = start_host_copies(tok, *probe)
        return PrefillLaunch(
            rows=rows, chunk_lens=chunk_lens, tok=tok_copy,
            logits=start_host_copy(last) if self.record_logits else None,
            ffn_aux=ffn_aux[0] if ffn_aux else None)

    def _collect_prefill(self, pl: PrefillLaunch) -> List[StepEvent]:
        """Resolve a launched prefill chunk: advance each row's position,
        settle deferred cancels, and for rows whose target completed commit
        the sampled token and move them to the decode batch (in pipelined
        mode that is THIS step's launch -- join-on-arrival keeps its
        one-step cadence, just phase-shifted with everything else)."""
        tok = self._wait(pl.tok).numpy()
        logits = None if pl.logits is None else \
            self._wait(pl.logits).float().numpy()
        self._publish_ffn(pl.ffn_aux, sum(pl.chunk_lens), self.cfg_prefill)
        events: List[StepEvent] = []
        for i, r in enumerate(pl.rows):
            r.prefill_pos += pl.chunk_lens[i]
            if r.prefill_pos < len(r.prefill_target):
                cancel_ev = self._deferred_cancel(r)
                if cancel_ev is not None:
                    events.append(cancel_ev)
                continue                              # more chunks to go
            if self.prefix_cache:
                self.kv.register_prefix(r.rid, r.prompt)
            if r.logits_trace is not None:
                r.logits_trace.append(logits[i])
            self.prefilling = [x for x in self.prefilling if x.rid != r.rid]
            r.status = RUNNING
            self.running.append(r)
            if self.telemetry is not None:
                self.telemetry.on_running(r)
            reason = r.append(int(tok[i]))
            if self.telemetry is not None:
                self.telemetry.on_tokens(r, 1)
            events.append(StepEvent(kind=EVENT_TOKEN, rid=r.rid,
                                    step=self._step_idx,
                                    tokens=(int(tok[i]),)))
            if self.on_prefill_done is not None:
                # disagg hook: the row's whole prefill target is cached and
                # its first token committed, but nothing is freed yet -- the
                # coordinator can still hold the blocks for transfer
                self.on_prefill_done(r, reason)
            if reason:
                events.append(self._terminal_event(r, reason))
            else:
                cancel_ev = self._deferred_cancel(r)
                if cancel_ev is not None:
                    events.append(cancel_ev)
        return events

    # ---------------------------------------------------------------- warmup

    def warmup(self) -> List[Dict]:
        """Make every program of the bucketed shape grid so steady-state
        serving never makes one: every decode (batch, table width) bucket,
        every (batch, chunk) prefill bucket pair, and -- with speculation
        on -- the draft/verify programs for the configured k, each in both
        the all-greedy and the sampling variant, in the JAX engine's order.
        Each program runs once more on its dummy arguments (all-null block
        tables, zero valid lengths: the writes all land in the discarded
        null block, and no allocator or request state is touched). Records
        each program's seconds in ``warmup_report``, the total in
        ``warmup_seconds``, and returns the report."""
        with self._lock, torch.no_grad():
            t_start = time.perf_counter()
            report: List[Dict] = []
            batches = bucket_grid(1, self.max_batch)
            lo = min(self.min_prefill_bucket, self.prefill_chunk)
            chunks = bucket_grid(lo, self.prefill_chunk)

            def timed(entry, shape, make):
                t0 = time.perf_counter()
                prog = make()
                prog(*prog.dummy)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                report.append({"entry": entry, "shape": shape,
                               "seconds": time.perf_counter() - t0})

            for padded in batches:
                for w in bucket_grid(1, self.table_width):
                    for greedy in (True, False):
                        timed("decode", (padded, w, greedy),
                              lambda: self._jit_decode(padded, w, greedy))
            for padded in batches:
                for chunk in chunks:
                    for greedy in (True, False):
                        timed("prefill", (padded, chunk, greedy),
                              lambda: self._jit_prefill(padded, chunk,
                                                        greedy))
            if self.spec is not None:
                for padded in batches:
                    for greedy in (True, False):
                        timed("draft", (padded, greedy),
                              lambda: self._jit_draft(padded, greedy))
                    timed("verify", (padded,),
                          lambda: self._jit_verify(padded))
            self.warmup_seconds = time.perf_counter() - t_start
            self.warmup_report = report
            if self.telemetry is not None:
                self.telemetry.on_warmup(self.warmup_seconds, len(report))
            return report
