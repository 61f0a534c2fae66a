"""One process a rank: join a process group, or spawn a group's ranks.

The port's tensor parallelism runs SPMD: every rank is a process that
builds the same engine on its own shard of the weights and makes the same
calls. ``spawn`` starts ``tp`` such processes (``torch.multiprocessing``,
start method ``spawn``), each joined to one process group through a file
store in a fresh temporary directory (no TCP rendezvous port), and returns
each rank's result. ``join`` is the per-process half: NCCL on the card
(rank ``r`` on card ``r``), gloo on the CPU (a spawned rank runs one
torch thread: the ranks share the host's cores).
Nothing falls back: the card's backend is NCCL or the join raises.
"""
from __future__ import annotations

import os
import pickle
import shutil
import sys
import tempfile
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

from repro_torch import device as device_mod


def rank_device(device: "str | torch.device", rank: int) -> torch.device:
    """Rank ``rank``'s device: its own card, or the CPU."""
    dev = torch.device(device)
    return torch.device("cuda", rank) if dev.type == "cuda" else dev


def join(rank: int, world: int, device, store_path: str) -> None:
    """Join a ``world``-rank process group as ``rank`` through the file
    store at ``store_path``: NCCL bound to the rank's card, or gloo on the
    CPU."""
    dev = torch.device(device)
    store = dist.FileStore(store_path, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", store=store, rank=rank,
                                world_size=world, device_id=dev)
    else:
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)


def _rank_main(rank: int, fn: Callable, world: int, device: str,
               workdir: str) -> None:
    dev = rank_device(device, rank)
    if dev.type == "cpu":
        torch.set_num_threads(1)     # the ranks share the host's cores
    with open(os.path.join(workdir, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    join(rank, world, dev, os.path.join(workdir, "store"))
    try:
        out = fn(rank, dev, *args)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
    # a finished rank leaves without the interpreter's teardown: torch's
    # registries still hold gloo devices whose threads raced the static
    # destructors there and aborted a rank now and then under load
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def in_one_rank(fn: Callable, device: device_mod.DeviceLike = None,
                args: Sequence[Any] = ()) -> Any:
    """``fn(0, device, *args)`` in this process as the one rank of a
    one-rank process group (a file store in a fresh temporary directory),
    left again afterwards. ``device`` None means the card."""
    dev = rank_device(device_mod.resolve(device), 0)
    workdir = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    try:
        join(0, 1, dev, os.path.join(workdir, "store"))
        try:
            return fn(0, dev, *args)
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def spawn(fn: Callable, world: int, args: Sequence[Any] = (),
          device: device_mod.DeviceLike = None) -> List[Any]:
    """``fn(rank, device, *args)`` in ``world`` spawned processes, each
    joined to one process group; returns the ranks' results in rank order.
    ``device`` None means the cards (rank ``r`` on card ``r``); the CPU
    only when asked for. ``fn`` and ``args`` are pickled (``fn`` by its
    import path, ``args`` to a file each rank reads); a rank that raises
    fails the whole call with its traceback."""
    device = device_mod.resolve(device).type
    if device == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"{world} ranks need {world} cards; "
                         f"{torch.cuda.device_count()} are visible")
    import torch.multiprocessing as mp
    workdir = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    try:
        # the arguments go through a file: a start argument larger than a
        # pipe's buffer would hold each process's start until the one
        # before it has imported its modules
        with open(os.path.join(workdir, "args.pkl"), "wb") as f:
            pickle.dump(tuple(args), f)
        mp.start_processes(_rank_main, args=(fn, world, device, workdir),
                           nprocs=world, join=True, start_method="spawn")
        outs = []
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        return outs
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
