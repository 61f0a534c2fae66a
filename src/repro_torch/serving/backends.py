"""FFN execution backends for the serving engine.

The paper's serving story is one flag: the same weights decode either
through the dense path or through the TwELL sparse path (pack in the gate
matmul, kernel K1, + fused up/down projection, kernel K2; Algorithms 1-2,
Eq. 3). A ``ServingBackend`` selects the FFN implementation per step kind:
``ServingEngine(..., backend="gather")`` vs ``backend="dense"``, or
``backend="tile_skip"`` (kernel K5). A ``DraftPair`` names the cheap draft
path and the trusted verify path of self-speculative decoding over one set
of weights. Ports ``DenseBackend``, ``TwellGatherBackend``,
``TileSkipBackend``, ``DraftPair`` and ``make_draft_pair`` of
``repro/serving/backends.py``, with ``validate_mesh`` (tensor-parallel
serving's refusals) and the FFN's split over the ranks (``ffn_sizes``).
"""
from __future__ import annotations

import dataclasses
from abc import ABC, abstractmethod
from typing import Dict, Type

from repro_torch.config import ModelConfig
from repro_torch.distributed import sharding

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

    def validate_mesh(self, cfg: ModelConfig, mesh, draft=None) -> None:
        """Reject model/mesh combinations tensor-parallel serving cannot
        shard, as the JAX backend does: the paged pool splits only its
        kv-head axis, wq/wo split by heads, the FFN by its hidden dim and
        the logits by vocab, so a count the model axis does not divide
        would replicate what TP exists to split. One refusal more than
        JAX's: when this backend or the ``draft`` backend packs or skips
        TwELL tiles (``gather``, ``tile_skip``), each rank holds whole
        tiles (``ffn_sizes``), so a d_ff of fewer tiles than ranks is
        refused."""
        tp = sharding.tp_size(mesh)
        if tp <= 1:
            return
        problems = []
        if cfg.num_kv_heads % tp:
            problems.append(f"num_kv_heads={cfg.num_kv_heads} (paged KV "
                            f"pool head axis)")
        if cfg.num_heads % tp:
            problems.append(f"num_heads={cfg.num_heads} (attention TP)")
        if cfg.d_ff % tp:
            problems.append(f"d_ff={cfg.d_ff} (FFN TP)")
        if cfg.padded_vocab % tp:
            problems.append(f"padded_vocab={cfg.padded_vocab} "
                            f"(vocab-sharded logits)")
        if problems:
            raise ValueError(
                f"backend {self.name!r} cannot serve under tp={tp}: "
                + "; ".join(problems) + " not divisible by the model axis")
        tile = cfg.sparsity.twell_tile
        if _tiles(self, draft) and cfg.d_ff // tile < tp:
            raise ValueError(
                f"backend {self.name!r} cannot serve under tp={tp}: d_ff="
                f"{cfg.d_ff} holds {cfg.d_ff // tile} TwELL tile(s) of "
                f"{tile} and a rank holds whole tiles (a tile split between "
                f"ranks would change which columns an overflowing tile "
                f"keeps)")

    def ffn_sizes(self, cfg: ModelConfig, tp: int, draft=None):
        """Each rank's share of d_ff: whole TwELL tiles when this backend
        or ``draft`` packs or skips tiles, else an even split (JAX's)."""
        tile = cfg.sparsity.twell_tile if _tiles(self, draft) else 0
        return sharding.ffn_split(cfg.d_ff, tp, tile)


def _tiles(*backends) -> bool:
    """Whether any of ``backends`` (None skipped) runs a per-tile FFN path
    in any phase."""
    return any(b.ffn_impl(mode) in ("gather", "tile_skip")
               for b in backends if b is not None
               for mode in (PREFILL, DECODE))


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


class TileSkipBackend(ServingBackend):
    """The gated FFN in kernel K5, skipping dead (row block x tile) cells.

    ``threshold > 0`` also drops gate tiles whose max |activation| is at
    most the threshold: approximate but much sparser, the cheap regime
    self-speculative decoding drafts with (the exact path then verifies).
    ``threshold == 0`` skips only all-zero tiles and equals dense math."""

    name = "tile_skip"

    def __init__(self, threshold: float = 0.0):
        if threshold < 0:
            raise ValueError(f"threshold must be >= 0, got {threshold}")
        self.threshold = threshold

    def ffn_impl(self, mode: str) -> str:
        return "tile_skip"

    def configure(self, cfg: ModelConfig, mode: str) -> ModelConfig:
        cfg = super().configure(cfg, mode)
        return dataclasses.replace(
            cfg, sparsity=dataclasses.replace(
                cfg.sparsity, tile_skip_threshold=self.threshold))

    def describe(self) -> str:
        return super().describe() + f" threshold={self.threshold}"


_REGISTRY: Dict[str, Type[ServingBackend]] = {
    cls.name: cls
    for cls in (DenseBackend, TwellGatherBackend, TileSkipBackend)}


def get_backend(name_or_backend, **kwargs) -> ServingBackend:
    """Resolve a backend by name (or pass an instance through)."""
    if isinstance(name_or_backend, ServingBackend):
        return name_or_backend
    try:
        return _REGISTRY[name_or_backend](**kwargs)
    except KeyError:
        raise ValueError(f"unknown backend {name_or_backend!r}; "
                         f"have {sorted(_REGISTRY)}") from None


@dataclasses.dataclass(frozen=True)
class DraftPair:
    """A draft/verify execution pair over ONE set of weights: ``draft`` is
    the cheap approximate path of the k-token draft loop, ``verify`` the
    trusted path whose output distribution the engine preserves."""

    draft: ServingBackend
    verify: ServingBackend

    def describe(self) -> str:
        return (f"draft[{self.draft.describe()}] -> "
                f"verify[{self.verify.describe()}]")


def make_draft_pair(verify_backend, draft_backend,
                    draft_threshold: float = 0.0) -> DraftPair:
    """Resolve a draft/verify pair. The threshold applies to tile_skip
    drafts only; a nonzero threshold on another draft backend is an error
    rather than a lossy knob silently ignored."""
    kwargs = {}
    if draft_threshold:
        if draft_backend != "tile_skip":
            raise ValueError(
                f"draft_threshold={draft_threshold} only applies to "
                f"tile_skip drafts; draft_backend={draft_backend!r} has no "
                f"lossy knob (set draft_threshold=0)")
        kwargs["threshold"] = draft_threshold
    return DraftPair(draft=get_backend(draft_backend, **kwargs),
                     verify=get_backend(verify_backend))
