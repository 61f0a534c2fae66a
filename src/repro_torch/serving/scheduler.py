"""Scheduling policy for the serving engine: admission order + preemption.

The engine owns the *mechanism* — reservation-style admission control,
chunked prefill, KV allocation/free, the preemption plumbing — and asks a
``Scheduler`` for the *policy*: which waiting request to admit next
(``peek``/``take``) and, when the admission candidate does not fit, whether
some running request should be evicted to make room (``pick_victim``).

Two policies ship:

  ``FCFSScheduler``      strict arrival order, never preempts. This is
                         byte-for-byte the pre-handle-API engine behavior
                         (admission defers under pressure), so greedy
                         outputs are identical to the old front door.
  ``PriorityScheduler``  admission in (priority desc, arrival asc) order;
                         under pool/slot pressure a *strictly lower*
                         priority RUNNING request is preempted: its KV
                         blocks are freed (registered full prompt blocks
                         park in the prefix cache's evictable LRU) and it
                         re-queues to resume later — re-admission re-prefills
                         ``prompt + committed outputs``, sharing any still-
                         cached prompt blocks nearly for free.

Preemption is cheap precisely because of the PR-3 prefix cache: eviction
converts a victim's full prompt blocks from "live" to "evictable cached",
and resume converts them back without recompute unless the pool reclaimed
them in between. The strict-inequality rule (victims must have lower
priority than the incoming request) makes preemption cycles impossible:
a resumed request can never preempt the request that preempted it.
"""
from __future__ import annotations

import abc
from collections import deque
from typing import Deque, Dict, Iterator, List, Optional, Sequence

from repro_torch.serving.request import Request


class Scheduler(abc.ABC):
    """Admission-order + preemption policy (the engine is the mechanism)."""

    name = "abstract"

    @abc.abstractmethod
    def add(self, req: Request) -> None:
        """Queue a request for admission (new submission or preempted)."""

    @abc.abstractmethod
    def peek(self) -> Optional[Request]:
        """The next admission candidate, or None when the queue is empty.
        Must not mutate the queue — the engine may defer the candidate."""

    @abc.abstractmethod
    def take(self, req: Request) -> None:
        """Remove ``req`` from the queue (the engine admitted it)."""

    @abc.abstractmethod
    def remove(self, rid: int) -> Optional[Request]:
        """Drop a queued request by id (cancellation); None if not queued."""

    @abc.abstractmethod
    def __len__(self) -> int: ...

    @abc.abstractmethod
    def __iter__(self) -> Iterator[Request]:
        """Iterate queued requests (no particular order; for bookkeeping —
        cancellation sweeps, ``has_unfinished``, debug introspection)."""

    def __bool__(self) -> bool:
        return len(self) > 0

    def pick_victim(self, incoming: Request,
                    running: Sequence[Request]) -> Optional[Request]:
        """A RUNNING request to preempt so ``incoming`` can make progress,
        or None to defer ``incoming`` instead (the default: no preemption).
        Called only when ``incoming`` currently fits neither the batch nor
        the KV pool; returning a victim re-triggers the admission check."""
        return None


class FCFSScheduler(Scheduler):
    """First-come-first-served, no preemption (the v1 engine policy)."""

    name = "fcfs"

    def __init__(self):
        self._q: Deque[Request] = deque()

    def add(self, req: Request) -> None:
        self._q.append(req)

    def peek(self) -> Optional[Request]:
        return self._q[0] if self._q else None

    def take(self, req: Request) -> None:
        if not self._q or self._q[0] is not req:
            raise ValueError(f"take() out of order: rid {req.rid} is not "
                             "the FCFS head")
        self._q.popleft()

    def remove(self, rid: int) -> Optional[Request]:
        for r in self._q:
            if r.rid == rid:
                self._q.remove(r)
                return r
        return None

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self) -> Iterator[Request]:
        return iter(list(self._q))


class PriorityScheduler(Scheduler):
    """Priority admission (larger ``priority`` first, FIFO within a tier)
    with preemption of strictly-lower-priority running requests.

    Victim choice: the lowest-priority running request, youngest first
    within that tier — older low-priority work has the most sunk decode
    cost, so it is preempted last (minimizes wasted progress; committed
    tokens are kept either way, only KV is recomputed on resume).
    """

    name = "priority"

    def __init__(self):
        self._q: List[Request] = []

    @staticmethod
    def _order(req: Request):
        # rid is the global submission sequence; a preempted request keeps
        # its original rid, so it resumes ahead of later same-tier arrivals
        return (-req.priority, req.rid)

    def add(self, req: Request) -> None:
        self._q.append(req)

    def peek(self) -> Optional[Request]:
        return min(self._q, key=self._order) if self._q else None

    def take(self, req: Request) -> None:
        self._q.remove(req)

    def remove(self, rid: int) -> Optional[Request]:
        for r in self._q:
            if r.rid == rid:
                self._q.remove(r)
                return r
        return None

    def pick_victim(self, incoming: Request,
                    running: Sequence[Request]) -> Optional[Request]:
        victims = [r for r in running if r.priority < incoming.priority]
        if not victims:
            return None
        return min(victims, key=lambda r: (r.priority, -r.rid))

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self) -> Iterator[Request]:
        return iter(list(self._q))


def plan_victims(scheduler: Scheduler, candidate: Request,
                 running: Sequence[Request], kv, *, reserved: int,
                 avail: int, need: int, other_slots: int,
                 max_batch: int) -> Optional[List[Request]]:
    """Plan the full preemption set that would let ``candidate`` fit, or
    None when even preempting every victim the policy offers cannot help
    (the engine then defers the candidate without wasting anyone's
    KV/progress).

    Pure planning — neither the scheduler queue nor the KV pool is
    mutated. A victim's table block only becomes available if no OTHER
    live request still references it (shared prefix blocks decref, they
    don't free), so the refcounts of the whole plan are simulated;
    growth reservations always return in full. The engine applies the
    plan immediately (synchronous step) or defers it to collect
    (pipelined step with device work in flight).
    """
    plan: List[Request] = []
    sim_running = list(running)
    sim_dec: Dict[int, int] = {}
    freeable = 0
    while True:
        victim = scheduler.pick_victim(candidate, sim_running)
        if victim is None:
            return None
        sim_running.remove(victim)
        plan.append(victim)
        for blk in kv.block_table(victim.rid):
            sim_dec[blk] = sim_dec.get(blk, 0) + 1
            if kv.ref_count(blk) == sim_dec[blk]:
                freeable += 1                # last reference: frees/parks
        freeable += victim.reserved_blocks
        slot_ok = len(sim_running) + other_slots < max_batch
        if slot_ok and avail + freeable - reserved >= need:
            return plan


_SCHEDULERS = {"fcfs": FCFSScheduler, "priority": PriorityScheduler}


def get_scheduler(policy) -> Scheduler:
    """Resolve a scheduler: an instance passes through, a name constructs
    one (``fcfs`` | ``priority``)."""
    if isinstance(policy, Scheduler):
        return policy
    try:
        return _SCHEDULERS[policy]()
    except KeyError:
        raise ValueError(f"unknown scheduler {policy!r}; "
                         f"available: {sorted(_SCHEDULERS)}") from None
