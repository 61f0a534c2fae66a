"""Fault-tolerant checkpointing with the JAX package's on-disk layout.

``repro/checkpoint/ckpt.py`` writes ``step_N/arrays.npz`` (leaf ``i`` of
the flattened tree under key ``"i"``) and ``step_N/manifest.json`` (step,
leaf count, leaf path names, a JSON ``extra``); this manager writes and
reads the same files, flattening the tree in JAX's order
(``repro_torch.tree``), so a checkpoint the JAX trainer wrote restores in
the port and the other way round.

- **atomic**: writes land in ``step_N.tmp/`` and are renamed to
  ``step_N/`` after the manifest is fsynced;
- **async**: the device-to-host copy happens at ``save``; file IO runs in
  a background thread (one save in flight at a time);
- **rotating**: keeps the newest ``keep`` checkpoints.

A bfloat16 leaf is stored as the JAX package stores it: its 2-byte bit
pattern, which numpy saves as the opaque dtype ``V2``; reading one back
reinterprets the bits.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves_with_path, unflatten


def _to_host(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view("V2")
    return t.numpy()


def _from_host(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if a.dtype.kind == "V":          # a bfloat16 bit pattern
        if a.dtype.itemsize != 2:
            raise ValueError(f"unknown opaque dtype {a.dtype} in checkpoint")
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=like.device, dtype=like.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        """tree: nested dicts/tuples/NamedTuples of tensors or arrays;
        extra: JSON-serializable."""
        self.wait()                       # one in-flight save at a time
        flat = list(leaves_with_path(tree))
        host = [_to_host(x) for _, x in flat]
        manifest = {"step": int(step), "n_leaves": len(host),
                    "names": [name for name, _ in flat],
                    "extra": extra or {}}

        def _write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{str(i): a for i, a in enumerate(host)})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._rotate()

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _rotate(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any) -> Tuple[Any, Dict]:
        """like: a tree of tensors giving the structure, each leaf's dtype
        and device. Returns (tree, extra)."""
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = [leaf for _, leaf in leaves_with_path(like)]
        if len(flat) != manifest["n_leaves"]:
            raise ValueError(f"leaf count mismatch: checkpoint "
                             f"{manifest['n_leaves']} vs {len(flat)}")
        with np.load(os.path.join(d, "arrays.npz")) as z:
            host = [z[str(i)] for i in range(len(flat))]
        for name, a, leaf in zip(manifest["names"], host, flat):
            if a.shape != tuple(leaf.shape):
                raise ValueError(f"{name}: checkpoint shape {a.shape} vs "
                                 f"{tuple(leaf.shape)}")
        return (unflatten(like, [_from_host(a, leaf)
                                 for a, leaf in zip(host, flat)]),
                manifest["extra"])

    def restore_latest(self, like: Any
                       ) -> Optional[Tuple[int, Any, Dict]]:
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = self.restore(step, like)
        return step, tree, extra
