"""FFN execution backends for the serving engine.

The paper's serving story is one flag: the same weights decode either
through the dense path or through the TwELL sparse path (pack in the gate
matmul, kernel K1, + fused up/down projection, kernel K2; Algorithms 1-2,
Eq. 3). A ``ServingBackend`` selects the FFN implementation per step kind:
``ServingEngine(..., backend="gather")`` vs ``backend="dense"``.
Ports ``DenseBackend`` and ``TwellGatherBackend`` of
``repro/serving/backends.py``.
"""
from __future__ import annotations

import dataclasses
from abc import ABC, abstractmethod
from typing import Dict, Type

from repro_torch.config import ModelConfig

PREFILL = "prefill"
DECODE = "decode"


class ServingBackend(ABC):
    """Selects the FFN execution path for each engine step."""

    name: str = "abstract"

    @abstractmethod
    def ffn_impl(self, mode: str) -> str:
        """The ``SparsityConfig.ffn_impl`` to run for ``mode``
        (``prefill`` | ``decode``)."""
        raise NotImplementedError

    def configure(self, cfg: ModelConfig, mode: str) -> ModelConfig:
        """A config whose FFN path is this backend's choice for ``mode``."""
        if mode not in (PREFILL, DECODE):
            raise ValueError(f"mode must be prefill|decode, got {mode!r}")
        return dataclasses.replace(
            cfg, sparsity=dataclasses.replace(cfg.sparsity,
                                              ffn_impl=self.ffn_impl(mode)))

    def describe(self) -> str:
        return (f"{self.name}: prefill={self.ffn_impl(PREFILL)} "
                f"decode={self.ffn_impl(DECODE)}")


class DenseBackend(ServingBackend):
    """Paper baseline: dense FFN math everywhere."""

    name = "dense"

    def ffn_impl(self, mode: str) -> str:
        return "dense"


class TwellGatherBackend(ServingBackend):
    """TwELL sparse path (Eq. 3 fused up+down from packed gate activations).

    Decode is the GEMV regime the format targets; prefill defaults to the
    same path, and ``prefill_impl="dense"`` gives the split of dense prefill
    and sparse decode."""

    name = "gather"

    def __init__(self, prefill_impl: str = "gather"):
        if prefill_impl not in ("gather", "dense"):
            raise ValueError(f"bad prefill_impl {prefill_impl!r}")
        self._prefill_impl = prefill_impl

    def ffn_impl(self, mode: str) -> str:
        return "gather" if mode == DECODE else self._prefill_impl


_REGISTRY: Dict[str, Type[ServingBackend]] = {
    cls.name: cls for cls in (DenseBackend, TwellGatherBackend)}


def get_backend(name_or_backend, **kwargs) -> ServingBackend:
    """Resolve a backend by name (or pass an instance through)."""
    if isinstance(name_or_backend, ServingBackend):
        return name_or_backend
    try:
        return _REGISTRY[name_or_backend](**kwargs)
    except KeyError:
        raise ValueError(f"unknown backend {name_or_backend!r}; "
                         f"have {sorted(_REGISTRY)}") from None
