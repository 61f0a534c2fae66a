"""One step entry at one bucket key: the port's form of a compiled program.

The JAX engine compiles each serving entry (decode, prefill, the draft
scan, the verify) once per bucket key with ``jax.jit`` and dispatches the
compiled program every step. The port's counterpart is a CUDA graph.
``Program`` holds one entry at one key: its static input buffers, its
static outputs and the captured graph. Each call copies the step's host
inputs into the static buffers (all of them packed in one pinned staging
buffer, so one copy) and replays the graph.

A program is made at the first use of its key, as ``jax.jit`` compiles at
the first call, or by ``ServingEngine.warmup()``:

1. the static inputs get the key's dummy arguments (JAX ``warmup()``'s:
   all-null block tables and zero lengths), so every K/V write of the next
   run lands in the null block and no live request's cache is touched;
2. the entry runs once eagerly on a side stream (one a device, which the
   capture uses too): that builds the kernels, caches their launch plans,
   sets their shared-memory attributes and makes ``ops.OverflowLog``'s
   flag, none of which may happen under capture;
3. the entry is captured with ``torch.cuda.graph`` into the engine's memory
   pool.

Kernel parameters are frozen at capture: pointers, and the TMA maps K1 and
K5 take by value. So weights, KV pools and the static buffers are never
reallocated (the model updates the pools in place). The launches a capture
counts (``build.count_launch`` runs on the host) are taken back out and
added once per replay, so ``ops.launch_counts()`` counts what ran.

All of an engine's programs share one memory pool, so a replay may reuse
memory where another program's outputs lie: a caller copies a replay's
outputs out (to the host, or into the next program's static input) before
it replays any other program of the engine. The engine does: every launch
starts its host copies right after its replay.

On a CPU engine a program is the eager entry itself, kept under the same
key in the same cache, so the CPU tests count programs as JAX counts its
compiles. There is no switch and no fallback: a capture or a replay that
fails raises.

Under tensor parallelism the entries run NCCL collectives, which the graph
captures too. NCCL cannot set up a communicator inside a capture; the
eager run that precedes each capture makes the entry's collectives first
(and ``ranks.join`` binds the group to its card, which sets the
communicator up at the join). The collectives a capture makes are counted
as its kernel launches are (``collectives.CALLS``, taken out at capture,
added per replay).
"""
from __future__ import annotations

import functools
from typing import (Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.distributed import collectives
from repro_torch.kernels import build

ENTRIES = ("decode", "prefill", "draft", "verify")
_ALIGN = 16                  # bytes between packed static inputs

Arg = Union[np.ndarray, torch.Tensor]


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The one stream every program's eager run and capture use on
    ``device``. cuBLAS keeps a workspace (32 MiB on an H100) for each
    stream it has run on, for the life of the process: a fresh stream a
    program, drawn from torch's pool of 32, left 1 GiB allocated."""
    return torch.cuda.Stream(device)


def _view(buf: torch.Tensor, offset: int, like: np.ndarray) -> torch.Tensor:
    """The (shape, dtype) of ``like`` over ``buf``'s bytes at ``offset``."""
    dtype = torch.from_numpy(like[:0].reshape(-1)).dtype
    return buf[offset:offset + like.nbytes].view(dtype).view(like.shape)


class Program:
    """One entry ``fn(*inputs) -> outputs`` at one bucket key.

    ``dummy`` gives the inputs' shapes and dtypes (numpy arrays) and the
    values of the run before capture. A call takes, for each input, a numpy
    array of that shape and dtype (copied from the host) or a tensor on the
    card (copied on the card), and returns the static outputs, valid until
    the next replay of any program of the engine."""

    def __init__(self, fn: Callable, dummy: Sequence[np.ndarray],
                 device: torch.device, pool=None):
        self.fn = fn
        self.dummy = [np.ascontiguousarray(a) for a in dummy]
        self.device = device
        self.launches: Dict[str, int] = {}
        self.graph = None
        if device.type != "cuda":
            return
        offsets, total = [], 0
        for a in self.dummy:
            offsets.append(total)
            total += -(-a.nbytes // _ALIGN) * _ALIGN
        self._host = torch.empty(max(total, _ALIGN), dtype=torch.uint8,
                                 pin_memory=True)
        self._dev = torch.empty(self._host.shape, dtype=torch.uint8,
                                device=device)
        self._host_np = [_view(self._host, o, a).numpy()
                         for o, a in zip(offsets, self.dummy)]
        self.inputs = [_view(self._dev, o, a)
                       for o, a in zip(offsets, self.dummy)]
        self._staged = torch.cuda.Event()
        self._stage(self.dummy)
        stream = torch.cuda.current_stream(device)
        side = _side_stream(device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            fn(*self.inputs)
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with build.captured_launches() as self.launches, \
                build.captured_launches(collectives.CALLS) as \
                self.collectives:
            with torch.cuda.graph(graph, pool=pool, stream=side,
                                  capture_error_mode="relaxed"):
                self.outputs = fn(*self.inputs)
        self.graph = graph

    def _stage(self, args: Sequence[Arg]) -> List[Tuple[int, torch.Tensor]]:
        """Copy the host arguments into the static inputs (one copy); return
        the device arguments to copy after it."""
        if len(args) != len(self.dummy):
            raise TypeError(f"program takes {len(self.dummy)} inputs, got "
                            f"{len(args)}")
        self._staged.synchronize()       # the last call's copy has read it
        on_card = []
        for i, a in enumerate(args):
            want = self.dummy[i]
            if a.shape != want.shape or (isinstance(a, np.ndarray) and
                                         a.dtype != want.dtype):
                raise ValueError(f"program input {i}: got {a.shape} "
                                 f"{a.dtype}, the key holds {want.shape} "
                                 f"{want.dtype}")
            if isinstance(a, torch.Tensor):
                on_card.append((i, a))
            else:
                self._host_np[i][...] = a
        self._dev.copy_(self._host, non_blocking=True)
        self._staged.record(torch.cuda.current_stream(self.device))
        return on_card

    def __call__(self, *args: Arg):
        if self.graph is None:
            return self.fn(*(torch.from_numpy(np.ascontiguousarray(a))
                             if isinstance(a, np.ndarray) else a
                             for a in args))
        for i, t in self._stage(args):
            self.inputs[i].copy_(t)
        self.graph.replay()
        build.add_launches(self.launches)
        build.add_launches(self.collectives, collectives.CALLS)
        return self.outputs


class ProgramCache:
    """One engine's programs by (entry, bucket key), in one graph memory
    pool on the card; ``made`` counts the programs made, by entry (the
    counterpart of the JAX engine's compile counter), and ``on_compile``
    (if set) is called with the entry each time one is made: the
    telemetry's ``jit_compiles_total``, counted where JAX counts a
    compile, since the bucket keys are the same."""

    def __init__(self, device: torch.device,
                 on_compile: Optional[Callable[[str], None]] = None):
        self.device = device
        self.on_compile = on_compile
        self.pool = torch.cuda.graph_pool_handle() \
            if device.type == "cuda" else None
        self.made: Dict[str, int] = {e: 0 for e in ENTRIES}
        self._programs: Dict[Tuple[str, tuple], Program] = {}

    def get(self, entry: str, key: tuple, fn: Callable,
            dummy: Callable[[], Sequence[np.ndarray]]) -> Program:
        """The program of ``entry`` at ``key``, made from ``fn`` and
        ``dummy()`` at the key's first use."""
        prog = self._programs.get((entry, key))
        if prog is None:
            prog = Program(fn, dummy(), self.device, self.pool)
            self._programs[(entry, key)] = prog
            self.made[entry] += 1
            if self.on_compile is not None:
                self.on_compile(entry)
        return prog
