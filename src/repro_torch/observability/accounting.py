"""Sparsity-and-compute accounting: the paper's quantitative lens as code
(ports ``repro/observability/accounting.py``).

Turns the per-layer sparsity statistics the model already produces
(``core/sparsity.layer_stats``, ``core/twell.nnz_per_row`` /
``tile_activity``, the FFN aux dict) into an analytic cost model per FFN
execution backend:

  dense      every (token x d_ff) neuron is computed; effective == dense.
  gather     TwELL/Eq. 3: the gate matmul is dense, the fused up+down
             projection touches only the nnz pattern — FLOPs and weight
             traffic scale with nnz, not d_ff.
  tile_skip  kernel K5 skips dead (row-block x hidden-tile) blocks; cost
             scales with the active-tile fraction.
  hybrid     training path: packed residuals cut *memory*, not matmul
             FLOPs — effective == dense on the FLOP axis.

From those per-layer costs the ``SparsityReport`` derives whole-model
effective vs dense-equivalent FLOPs per step, bytes moved, an MFU estimate
(model FLOPs per card / peak / wall) and a tokens-per-joule proxy, against
the roofline constants below: one NVIDIA H100 SXM (80GB HBM3), the card the
port runs on.

Everything is host-side ``float`` math over already-reduced statistics.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

# ---- roofline constants (NVIDIA H100 SXM 80GB HBM3, per card) -------------
PEAK_FLOPS = 989e12        # dense bf16 tensor-core peak [FLOP/s] (NVIDIA
#                            H100 data sheet, SXM, without sparsity)
HBM_BW = 3.35e12           # HBM3 bandwidth [B/s] (same data sheet)
LINK_BW = 900e9            # NVLink 4 bandwidth per card, both directions of
#                            its 18 links summed [B/s] (same data sheet)
CHIP_TDP_W = 700.0         # board power limit [W] as ``nvidia-smi
#                            --query-gpu=power.limit`` reports it on the
#                            H100 80GB HBM3 the port's chip runs used (its
#                            maximum) — tokens/J *proxy* only
H100_SMS = 132             # streaming multiprocessors (same data sheet, SXM);
#                            the launch plans' SM count in a dry run, whose
#                            tensors have no card to ask


def param_count(params) -> int:
    """Total parameter count of a params tree of tensors."""
    from repro_torch.tree import leaves
    return sum(int(t.numel()) for t in leaves(params))


def matmul_params(cfg, n_params: int) -> int:
    """Matmul-visible parameter count: drop the gather-only input embedding
    (untied archs) and inactive MoE experts — the JAX package's MODEL_FLOPS
    convention."""
    n = int(n_params)
    if not cfg.tied_embeddings:
        n -= cfg.padded_vocab * cfg.d_model
    if cfg.num_experts:
        per_expert = (3 if cfg.gated else 2) * cfg.d_model * cfg.d_ff
        n -= (cfg.num_experts - cfg.top_k) * per_expert * cfg.num_layers
    return n


def model_flops(cfg, n_params: int, tokens: int, *, train: bool = False
                ) -> float:
    """6*N*D (train) / 2*N*D (prefill/decode) dense-equivalent model FLOPs."""
    mult = 6 if train else 2
    return float(mult * matmul_params(cfg, n_params) * tokens)


def mfu(flops: float, seconds: float, chips: int = 1,
        peak: float = PEAK_FLOPS) -> float:
    """Model-FLOPs utilization: achieved model FLOP/s per chip over peak."""
    if seconds <= 0 or chips <= 0:
        return 0.0
    return flops / (seconds * chips * peak)


def tokens_per_joule(tokens: float, seconds: float, chips: int = 1,
                     tdp_w: float = CHIP_TDP_W) -> float:
    """Energy-efficiency *proxy*: tokens over (wall x chip TDP). Not a power
    measurement — a fixed-envelope normalization so runs are comparable."""
    if seconds <= 0:
        return 0.0
    return tokens / (seconds * chips * tdp_w)


# ---- per-layer FFN cost model ----------------------------------------------

_FLOPS_IMPLS = ("dense", "gather", "tile_skip", "hybrid")


@dataclasses.dataclass(frozen=True)
class LayerCost:
    """One FFN layer's accounting over ``tokens`` tokens."""

    layer: int
    nnz_mean: float            # mean non-zeros per token in h
    sparsity: float            # 1 - nnz_mean / d_ff
    tile_frac: float           # active-tile fraction (tile_skip granularity)
    dense_flops: float         # paper-faithful dense FFN FLOPs
    effective_flops: float     # FLOPs the backend actually executes
    dense_bytes: float         # weight bytes touched per token x tokens
    effective_bytes: float
    dead_frac: float = 0.0     # fraction of neurons that never fired

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def ffn_dense_flops_per_token(cfg) -> float:
    """2 * d_model * d_ff per matmul; gated FFNs run three (gate, up, down)."""
    n_mats = 3 if cfg.gated else 2
    return 2.0 * cfg.d_model * cfg.d_ff * n_mats


def ffn_effective_flops_per_token(cfg, impl: str, nnz: float,
                                  tile_frac: Optional[float] = None) -> float:
    """Analytic per-token FLOPs for one FFN layer under ``impl``.

    gather (Eq. 3): the gate/up activation producing the pattern is a dense
    matmul; the fused projection then does 2*d per nnz element on each of
    the up and down sides (gated) or the down side only (non-gated).
    tile_skip: the gate matmul is dense; up+down run only on active tiles.
    dense / hybrid: full cost (hybrid saves memory, not matmul FLOPs).
    """
    if impl not in _FLOPS_IMPLS:
        raise ValueError(f"unknown ffn_impl {impl!r}")
    d, dff = cfg.d_model, cfg.d_ff
    dense = ffn_dense_flops_per_token(cfg)
    if impl in ("dense", "hybrid"):
        return dense
    nnz = min(max(float(nnz), 0.0), float(dff))
    if impl == "gather":
        pattern_mats = 2 if cfg.gated else 1
        return 2.0 * d * dff + 2.0 * d * nnz * pattern_mats
    # tile_skip: non-gated configs take the dense path in
    # sparse_ffn._tile_skip_apply, so only the gated shape is block-sparse
    if not cfg.gated:
        return dense
    tf = (nnz / dff) if tile_frac is None else min(max(float(tile_frac),
                                                       0.0), 1.0)
    return 2.0 * d * dff + 4.0 * d * dff * tf


def ffn_bytes_per_token(cfg, impl: str, nnz: float,
                        tile_frac: Optional[float] = None,
                        dtype_bytes: Optional[int] = None) -> float:
    """Weight traffic per token (the memory-bound decode regime, where each
    token streams the weight rows it touches; activations are negligible).
    Dense counts all matmuls' weights; gather streams the gate/up weights
    plus only the nnz rows of the pattern-side weights; tile_skip streams
    the gate weights plus active tiles of up+down."""
    if dtype_bytes is None:
        from repro_torch.device import torch_dtype
        dtype_bytes = torch_dtype(cfg.param_dtype).itemsize
    d, dff = cfg.d_model, cfg.d_ff
    n_mats = 3 if cfg.gated else 2
    dense = float(n_mats * d * dff * dtype_bytes)
    if impl in ("dense", "hybrid"):
        return dense
    nnz = min(max(float(nnz), 0.0), float(dff))
    if impl == "gather":
        pattern_mats = 2 if cfg.gated else 1
        return (d * dff + pattern_mats * nnz * d) * dtype_bytes
    if not cfg.gated:
        return dense
    tf = (nnz / dff) if tile_frac is None else min(max(float(tile_frac),
                                                       0.0), 1.0)
    return (d * dff + 2.0 * tf * d * dff) * dtype_bytes


# ---- whole-model report -----------------------------------------------------

@dataclasses.dataclass
class SparsityReport:
    """Per-layer + whole-model sparsity/compute accounting for one step (or
    one batch of ``tokens`` tokens)."""

    impl: str
    tokens: int
    d_ff: int
    layers: List[LayerCost]
    model_dense_flops: Optional[float] = None     # 6/2 * N * tokens
    model_effective_flops: Optional[float] = None  # dense - ffn savings
    chips: int = 1

    @classmethod
    def build(cls, cfg, tokens: int, nnz_per_layer: Sequence[float], *,
              impl: Optional[str] = None,
              tile_frac_per_layer: Optional[Sequence[float]] = None,
              dead_frac_per_layer: Optional[Sequence[float]] = None,
              ffn_present: Optional[Sequence[float]] = None,
              n_params: Optional[int] = None, train: bool = False,
              chips: int = 1) -> "SparsityReport":
        impl = impl or cfg.sparsity.ffn_impl
        tokens = int(tokens)
        layers: List[LayerCost] = []
        for i, nnz in enumerate(nnz_per_layer):
            present = 1.0 if ffn_present is None else float(ffn_present[i])
            nnz = float(nnz)
            tf = None if tile_frac_per_layer is None \
                else float(tile_frac_per_layer[i])
            dense_pt = ffn_dense_flops_per_token(cfg) * present
            eff_pt = ffn_effective_flops_per_token(cfg, impl, nnz, tf) \
                * present
            eb_pt = ffn_bytes_per_token(cfg, impl, nnz, tf) * present
            db_pt = ffn_bytes_per_token(cfg, "dense", nnz) * present
            layers.append(LayerCost(
                layer=i, nnz_mean=nnz,
                sparsity=(1.0 - nnz / cfg.d_ff) * present,
                tile_frac=(nnz / cfg.d_ff if tf is None else tf) * present,
                dense_flops=dense_pt * tokens,
                effective_flops=eff_pt * tokens,
                dense_bytes=db_pt * tokens,
                effective_bytes=eb_pt * tokens,
                dead_frac=0.0 if dead_frac_per_layer is None
                else float(dead_frac_per_layer[i])))
        report = cls(impl=impl, tokens=tokens, d_ff=cfg.d_ff, layers=layers,
                     chips=chips)
        if n_params is not None:
            dense_total = model_flops(cfg, n_params, tokens, train=train)
            ffn_dense = sum(c.dense_flops for c in layers)
            ffn_eff = sum(c.effective_flops for c in layers)
            mult = 6 if train else 2
            # the FFN terms above are forward-pass costs; scale by the same
            # forward/backward multiple the model-FLOPs convention uses
            scale = mult / 2.0
            report.model_dense_flops = dense_total
            report.model_effective_flops = \
                dense_total - (ffn_dense - ffn_eff) * scale
        return report

    # ---- derived quantities -------------------------------------------------

    @property
    def present_layers(self) -> List[LayerCost]:
        return [c for c in self.layers if c.dense_flops > 0]

    @property
    def mean_sparsity(self) -> float:
        pres = self.present_layers
        if not pres:
            return 0.0
        return sum(c.sparsity for c in pres) / len(pres)

    @property
    def ffn_dense_flops(self) -> float:
        return sum(c.dense_flops for c in self.layers)

    @property
    def ffn_effective_flops(self) -> float:
        return sum(c.effective_flops for c in self.layers)

    def flops_reduction(self) -> float:
        """1 - effective/dense over the FFN stack (0 for dense/hybrid)."""
        dense = self.ffn_dense_flops
        if dense <= 0:
            return 0.0
        return 1.0 - self.ffn_effective_flops / dense

    def mfu_estimate(self, step_seconds: float,
                     peak: float = PEAK_FLOPS) -> Optional[float]:
        """MFU from dense-equivalent model FLOPs (the standard convention,
        so sparsity shows up as *speed*, not as an inflated utilization)."""
        if self.model_dense_flops is None:
            return None
        return mfu(self.model_dense_flops, step_seconds, self.chips, peak)

    def to_dict(self) -> Dict:
        return {
            "impl": self.impl, "tokens": self.tokens, "d_ff": self.d_ff,
            "chips": self.chips,
            "mean_sparsity": self.mean_sparsity,
            "ffn_dense_flops": self.ffn_dense_flops,
            "ffn_effective_flops": self.ffn_effective_flops,
            "flops_reduction": self.flops_reduction(),
            "model_dense_flops": self.model_dense_flops,
            "model_effective_flops": self.model_effective_flops,
            "layers": [c.to_dict() for c in self.layers],
        }


# ---- bridges from the existing sparsity primitives -------------------------

def stats_from_hidden(h) -> Dict[str, float]:
    """Host floats from ``core.sparsity.layer_stats`` on a dense (tokens, N)
    activation matrix."""
    from repro_torch.core.sparsity import layer_stats
    return {k: float(v) for k, v in layer_stats(h).items()}


def tile_occupancy_from_twell(tw, row_block: int = 8) -> Dict[str, float]:
    """Tile-level occupancy from a packed ``TwellActs``: the fraction of
    (row, tile) cells holding any non-zero, mean nnz per row, and the
    fraction of (row-block x tile) cells the tile-skip kernel would run."""
    from repro_torch.core.twell import nnz_per_row, tile_activity
    act = tile_activity(tw, row_block)
    return {
        "tile_frac": float((tw.nnz > 0).float().mean()),
        "nnz_per_row_mean": float(nnz_per_row(tw).float().mean()),
        "block_tile_frac": float((act > 0).float().mean()),
    }
