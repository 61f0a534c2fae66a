"""KV-block transfer between engine pools: buffer + transport.

Ports ``repro/serving/disagg/transfer.py``. Disaggregated serving moves a
request's cached KV from the prefill engine's paged pool into the decode
engine's. Two pieces live here:

``TransferBuffer``
    A bounded, request-id-keyed map of published-but-unclaimed transfers.
    Publishing pins the source blocks via ``PagedKVCache.hold`` under a
    synthetic negative owner id, so the prefill engine can finish (and
    ``free``) the request without the block contents being reallocated out
    from under the pending transfer. Claiming (or cancelling) releases the
    hold; a TTL sweep expires entries no decode engine claimed in time, so
    a stalled consumer can never leak prefill-pool blocks: the expired
    request re-queues and re-prefills (migration IS a resume, so nothing
    is lost but work).

``Transport``
    The copy mechanism, as an ABC so the in-process implementations can be
    swapped for a socket/RDMA transport later without touching the
    coordinator: ``transfer(src_kv, dst_kv, src_blocks, dst_blocks)`` moves
    whole blocks (every layer, both K and V pools) between pools.

      ``InProcessTransport``      on the pools' device, in place: one
                                  ``index_select`` of the source blocks and
                                  one ``index_copy_`` into the destination
                                  blocks per pool, on the current stream.
      ``HostRoundtripTransport``  device -> host ``bytes`` -> device. The
                                  bytes boundary is the payload a socket
                                  transport would ship; it proves the
                                  extension point and is the reference the
                                  in-process path is tested against.

Pools are updated in place and never rebound: the decode engine's CUDA
graphs hold the addresses of its pool tensors (``serving/graphs.py``). The
JAX package rebinds new pools (``swap_pools``) and pads the block ids to
power-of-two buckets to bound its compile count; eager index ops compile
nothing, so the port copies exactly the blocks asked for.

Ordering on the card: the engines replay their programs and the transport
copies on the caller's current stream, so the copy runs after the prefill
engine's last write to the source blocks and before the decode engine's
next replay, with no event between them.

Thread safety: the buffer has no lock of its own: every caller runs under
the coordinator's lock (publishes happen inside the prefill engine's
``step()``, which the coordinator drives).
"""
from __future__ import annotations

import abc
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serving.kv_cache import NULL_BLOCK, PagedKVCache


@dataclasses.dataclass(frozen=True)
class TransferEntry:
    """One published, not-yet-claimed KV migration."""

    rid: int                     # coordinator request id (the buffer key)
    hold_id: int                 # synthetic owner pinning the source blocks
    blocks: Tuple[int, ...]      # source block ids, table order
    cached_tokens: int           # KV positions the blocks hold (seq_len - 1)
    published_step: int          # coordinator step at publish (TTL base)
    published_t: float           # wall clock at publish (wait metrics)


class TransferBuffer:
    """Bounded rid-keyed buffer of pending KV transfers over one source
    pool. Holds (refcounts) the source blocks from publish until claim /
    cancel / TTL expiry."""

    def __init__(self, src_kv: PagedKVCache, *, max_entries: int = 8,
                 ttl_steps: Optional[int] = 64):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        if ttl_steps is not None and ttl_steps < 1:
            raise ValueError(f"ttl_steps must be >= 1, got {ttl_steps}")
        self.src_kv = src_kv
        self.max_entries = max_entries
        self.ttl_steps = ttl_steps
        self._entries: Dict[int, TransferEntry] = {}
        self.published_total = 0
        self.claimed_total = 0
        self.cancelled_total = 0
        self.expired_total = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, rid: int) -> bool:
        return rid in self._entries

    @property
    def full(self) -> bool:
        return len(self._entries) >= self.max_entries

    @property
    def blocks_pinned(self) -> int:
        """Source-pool blocks currently pinned by unclaimed entries."""
        return sum(len(e.blocks) for e in self._entries.values())

    def get(self, rid: int) -> Optional[TransferEntry]:
        return self._entries.get(rid)

    def entries(self) -> List[TransferEntry]:
        return list(self._entries.values())

    def publish(self, rid: int, blocks: Sequence[int], cached_tokens: int,
                step: int, now: Optional[float] = None) -> TransferEntry:
        """Pin ``blocks`` in the source pool and enter them under ``rid``.
        Must be called while the source request still owns its table (the
        engine's ``on_prefill_done`` hook guarantees that window)."""
        if self.full:
            raise RuntimeError(
                f"transfer buffer full ({self.max_entries} entries); the "
                "coordinator must gate prefill submissions on headroom")
        if rid in self._entries:
            raise ValueError(f"rid {rid} already has a pending transfer")
        hold_id = -(rid + 1)          # rids are >= 0, so never collides
        self.src_kv.hold(hold_id, blocks)
        entry = TransferEntry(
            rid=rid, hold_id=hold_id, blocks=tuple(int(b) for b in blocks),
            cached_tokens=int(cached_tokens), published_step=int(step),
            published_t=time.perf_counter() if now is None else now)
        self._entries[rid] = entry
        self.published_total += 1
        return entry

    def claim(self, rid: int) -> TransferEntry:
        """Remove ``rid``'s entry and release its hold. The caller must have
        copied the block contents out already (the coordinator runs the
        transport inside ``admit_migrated``, while the hold is live)."""
        entry = self._entries.pop(rid)
        self.src_kv.free(entry.hold_id)
        self.claimed_total += 1
        return entry

    def cancel(self, rid: int) -> bool:
        """Drop a pending transfer (request cancelled mid-transfer),
        releasing its hold. False when ``rid`` has no pending entry."""
        entry = self._entries.pop(rid, None)
        if entry is None:
            return False
        self.src_kv.free(entry.hold_id)
        self.cancelled_total += 1
        return True

    def expire(self, now_step: int) -> List[TransferEntry]:
        """Drop every entry unclaimed for ``ttl_steps`` coordinator steps,
        releasing the holds; returns the expired entries so the coordinator
        can re-queue their requests. No-op when TTL is disabled (None)."""
        if self.ttl_steps is None:
            return []
        expired = [e for e in self._entries.values()
                   if now_step - e.published_step >= self.ttl_steps]
        for e in expired:
            del self._entries[e.rid]
            self.src_kv.free(e.hold_id)
            self.expired_total += 1
        return expired


def _check_counts(src_blocks: Sequence[int],
                  dst_blocks: Sequence[int]) -> None:
    if len(src_blocks) != len(dst_blocks):
        raise ValueError(
            f"block count mismatch: {len(src_blocks)} src vs "
            f"{len(dst_blocks)} dst")


def _ids(device: torch.device, *blocks: Sequence[int]
         ) -> List[torch.Tensor]:
    """Block-id vectors on ``device`` from one host array in one copy:
    pinned and asynchronous on the card, so a transfer never waits on the
    stream (the caching host allocator keeps the pinned buffer until the
    copy has read it)."""
    host = torch.from_numpy(np.asarray(blocks, np.int64))
    if device.type == "cuda":
        host = host.pin_memory()
    return list(host.to(device, non_blocking=True))


class Transport(abc.ABC):
    """Block-content copy between two paged pools. Implementations move
    whole blocks (every layer, K and V) for the given id lists (equal
    length, positionally paired) into the destination's existing pool
    tensors. Pools must be unsharded and of one layout, dtype and device."""

    @abc.abstractmethod
    def transfer(self, src_kv: PagedKVCache, dst_kv: PagedKVCache,
                 src_blocks: Sequence[int],
                 dst_blocks: Sequence[int]) -> None:
        """Copy ``src_blocks[i] -> dst_blocks[i]`` contents."""

    def warmup(self, src_kv: PagedKVCache, dst_kv: PagedKVCache,
               max_blocks: int) -> int:
        """Make whatever ``transfer`` needs before its first use, for up to
        ``max_blocks`` per call; returns the forms made (0 by default)."""
        return 0


class InProcessTransport(Transport):
    """On-device copy in place: per pool one ``index_select`` of the source
    blocks and one ``index_copy_`` into the destination blocks (the JAX
    package's fused gather/scatter, ``pool.at[:, dst].set(src[:, src])``).
    Never through the host, and never a rebinding of ``dst_kv.pools``."""

    def transfer(self, src_kv, dst_kv, src_blocks, dst_blocks) -> None:
        _check_counts(src_blocks, dst_blocks)
        if not len(src_blocks):
            return
        device = next(iter(dst_kv.pools.values())).device
        src_ids, dst_ids = _ids(device, src_blocks, dst_blocks)
        for name, dst in dst_kv.pools.items():
            dst.index_copy_(1, dst_ids,
                            src_kv.pools[name].index_select(1, src_ids))

    def warmup(self, src_kv, dst_kv, max_blocks: int) -> int:
        """One copy of the null block onto the null block (never read):
        the copy has one form for every block count, so one call makes
        everything its first use would (the card's lazily loaded index
        kernels, the allocator's blocks)."""
        self.transfer(src_kv, dst_kv, [NULL_BLOCK], [NULL_BLOCK])
        return 1


class HostRoundtripTransport(Transport):
    """Copy via an explicit host ``bytes`` payload: the socket-transport
    stand-in. ``transfer`` serializes the source blocks as a wire transport
    would (the raw bytes of a contiguous buffer + shape + dtype name per
    pool: numpy has no bfloat16, so the bytes cross as uint8 and come back
    bit for bit), then deserializes into the destination. Slow by
    construction; it proves the ABC boundary carries everything a
    cross-process transport needs and is the reference for the in-process
    one."""

    def transfer(self, src_kv, dst_kv, src_blocks, dst_blocks) -> None:
        _check_counts(src_blocks, dst_blocks)
        if not len(src_blocks):
            return
        device = next(iter(src_kv.pools.values())).device
        src_ids, = _ids(device, src_blocks)
        payload = {}
        for name, pool in src_kv.pools.items():
            arr = pool.index_select(1, src_ids).cpu()
            payload[name] = (arr.view(torch.uint8).numpy().tobytes(),
                             tuple(arr.shape), str(arr.dtype))
        # -- everything below this line could run in another process --
        dst_ids, = _ids(device, dst_blocks)
        for name, pool in dst_kv.pools.items():
            buf, shape, dtype = payload[name]
            arr = torch.frombuffer(bytearray(buf), dtype=torch.uint8).view(
                getattr(torch, dtype.removeprefix("torch."))).view(shape)
            pool.index_copy_(1, dst_ids, arr.to(pool.device))
