"""Device selection for the port's entry points.

Entry points (``lm.init``, ``ServingEngine``, the serve CLI) run on the
CUDA card unless the caller asks for the CPU. There is no silent fallback:
asking for the card on a machine without one raises.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default — pass device='cpu' to run the plain PyTorch path")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig`` dtype string -> torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None
