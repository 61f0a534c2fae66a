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
    "paper-1.5b": "paper_1p5b",
    "olmo-1b": "olmo_1b",
    "mixtral-8x22b": "mixtral_8x22b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "deepseek-67b": "deepseek_67b",
    "llama3-405b": "llama3_405b",
    "zamba2-1.2b": "zamba2_1p2b",
    "rwkv6-7b": "rwkv6_7b",
    "whisper-large-v3": "whisper_large_v3",
    "llama-3.2-vision-11b": "llama_3p2_vision_11b",
}


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port serves "
                       f"{sorted(_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[name]}")
    return mod.CONFIG


def list_archs() -> List[str]:
    return list(_REGISTRY)
