"""Architecture registry of the PyTorch port: only the configs it serves.

``get_config(name)`` accepts the public dashed id (e.g. ``paper-0.5b``), as
``repro.configs.get_config`` does; the modules here are copies of the JAX
package's, so both packages build the same ``ModelConfig``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config import ModelConfig

# public id -> module name
_REGISTRY: Dict[str, str] = {
    "paper-0.5b": "paper_0p5b",
    "olmo-1b": "olmo_1b",
}


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port serves "
                       f"{sorted(_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[name]}")
    return mod.CONFIG


def list_archs() -> List[str]:
    return list(_REGISTRY)
