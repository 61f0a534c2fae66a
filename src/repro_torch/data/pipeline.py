"""Data pipeline: deterministic synthetic LM stream + memmap token dataset.

The PyTorch port's copy of ``repro/data/pipeline.py`` (numpy only), so the
batches are bit for bit the JAX package's and the port imports nothing of
it. The trainer moves each numpy batch to its device.

Both iterators are *stateful and resumable*: ``state()`` returns a small dict
that goes into every checkpoint, and ``from_state`` reconstructs the exact
stream position — a training run killed at step N and restored elsewhere
consumes identical batches from step N.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class SyntheticLM:
    """Markov-ish synthetic token stream with stable per-step PRNG.

    Produces (tokens, labels) with labels = next-token shift; the sequence has
    learnable local structure (token t+1 depends on t mod a small table) so
    training losses decrease meaningfully in integration tests.
    """

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 step: int = 0):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed, self.step = seed, step
        # the transition table defines the "language": FIXED across seeds so
        # different-seed iterators are held-out *samples*, not held-out
        # languages (seed only drives the sampling stream)
        rng = np.random.default_rng(0xC0FFEE ^ (vocab << 1))
        self._table = rng.integers(0, vocab, size=(vocab,), dtype=np.int64)

    def state(self) -> Dict:
        return {"kind": "synthetic", "vocab": self.vocab, "batch": self.batch,
                "seq": self.seq, "seed": self.seed, "step": self.step}

    @classmethod
    def from_state(cls, st: Dict) -> "SyntheticLM":
        return cls(st["vocab"], st["batch"], st["seq"], st["seed"], st["step"])

    def __next__(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, self.step))
        first = rng.integers(0, self.vocab, size=(self.batch, 1))
        noise = rng.random((self.batch, self.seq)) < 0.15
        toks = np.empty((self.batch, self.seq + 1), np.int64)
        toks[:, :1] = first
        for t in range(self.seq):
            nxt = self._table[toks[:, t]]
            rnd = rng.integers(0, self.vocab, size=(self.batch,))
            toks[:, t + 1] = np.where(noise[:, t], rnd, nxt)
        self.step += 1
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


class MemmapTokens:
    """Flat binary uint16/uint32 token file, packed into (B, S+1) windows with
    a deterministic epoch shuffle (strided congruential permutation — O(1)
    state, arbitrary seek)."""

    def __init__(self, path: str, batch: int, seq: int, dtype="uint16",
                 seed: int = 0, step: int = 0):
        self.path, self.batch, self.seq = path, batch, seq
        self.seed, self.step = seed, step
        self.dtype = dtype
        self._data = np.memmap(path, dtype=np.dtype(dtype), mode="r")
        self.n_windows = (len(self._data) - 1) // seq
        # odd multiplier coprime with n_windows for a full-cycle permutation
        self._mult = 2654435761 % self.n_windows
        while np.gcd(self._mult, self.n_windows) != 1:
            self._mult += 1

    def state(self) -> Dict:
        return {"kind": "memmap", "path": self.path, "batch": self.batch,
                "seq": self.seq, "dtype": self.dtype, "seed": self.seed,
                "step": self.step}

    @classmethod
    def from_state(cls, st: Dict) -> "MemmapTokens":
        return cls(st["path"], st["batch"], st["seq"], st["dtype"],
                   st["seed"], st["step"])

    def _window(self, i: int) -> np.ndarray:
        j = ((i + self.seed) * self._mult) % self.n_windows
        start = j * self.seq
        return np.asarray(self._data[start:start + self.seq + 1])

    def __next__(self) -> Dict[str, np.ndarray]:
        base = self.step * self.batch
        rows = [self._window((base + r) % self.n_windows)
                for r in range(self.batch)]
        toks = np.stack(rows).astype(np.int32)
        self.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_iterator(st: Dict):
    if st["kind"] == "synthetic":
        return SyntheticLM.from_state(st)
    if st["kind"] == "memmap":
        return MemmapTokens.from_state(st)
    raise ValueError(st["kind"])


def write_token_file(path: str, tokens: np.ndarray, dtype="uint16"):
    np.asarray(tokens, dtype=np.dtype(dtype)).tofile(path)
