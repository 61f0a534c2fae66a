"""Structured JSONL run logs for training (and any long-running driver);
ports ``repro/observability/runlog.py`` record for record.

One line per record, append-only, crash-tolerant (each line is flushed as
written, so a SIGKILL loses at most the line in flight). Three record
kinds:

  {"kind": "meta",  "schema_version": 1, "ts": ..., ...run fields...}
  {"kind": "step",  "ts": ..., "step": N, ...metrics...}
  {"kind": "event", "ts": ..., "event": "watchdog"|"resume"|..., ...}

``RunLogger`` replaces the bare ``print()`` path in ``launch/train.py``;
the console summary line survives as an option (``console=True`` echoes
events; the driver still prints its periodic step summary itself). The
reader (``read_runlog``) is what tests and notebooks consume.
"""
from __future__ import annotations

import json
import time
from typing import Dict, IO, Iterator, List, Optional

SCHEMA_VERSION = 1


def _jsonable(v):
    """Best-effort conversion of numpy/torch scalars and arrays."""
    if hasattr(v, "tolist"):
        return v.tolist()
    if hasattr(v, "item"):
        return v.item()
    return v


class RunLogger:
    """Append-only JSONL writer with a one-time meta header.

    >>> with RunLogger(path, meta={"arch": "paper-0.5b"}) as log:
    ...     log.step(0, loss=3.2, nnz_per_layer=[97.0, 80.2])
    ...     log.event("watchdog", message="step 7 took 3.1s", step=7)
    """

    def __init__(self, path: str, *, meta: Optional[Dict] = None,
                 console: bool = False):
        self.path = path
        self.console = console
        self._fh: Optional[IO] = open(path, "a")
        header = {"kind": "meta", "schema_version": SCHEMA_VERSION}
        header.update(meta or {})
        self._write(header)

    def _write(self, record: Dict) -> None:
        if self._fh is None:
            raise RuntimeError("RunLogger is closed")
        record = {k: _jsonable(v) for k, v in record.items()}
        record.setdefault("ts", time.time())
        self._fh.write(json.dumps(record, sort_keys=True) + "\n")
        self._fh.flush()

    def step(self, step: int, **fields) -> None:
        self._write({"kind": "step", "step": int(step), **fields})

    def event(self, event: str, message: str = "", **fields) -> None:
        """A discrete occurrence (watchdog trip, resume, SIGTERM checkpoint,
        run completion). Echoed to the console when ``console=True`` so the
        operator-facing log lines keep flowing from the same call site."""
        self._write({"kind": "event", "event": event, "message": message,
                     **fields})
        if self.console and message:
            print(f"[train] {message}", flush=True)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "RunLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def iter_runlog(path: str) -> Iterator[Dict]:
    """Yield records, skipping a torn final line from a crashed writer."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue


def read_runlog(path: str, kind: Optional[str] = None) -> List[Dict]:
    """All records (optionally filtered by ``kind``) as a list."""
    return [r for r in iter_runlog(path)
            if kind is None or r.get("kind") == kind]
