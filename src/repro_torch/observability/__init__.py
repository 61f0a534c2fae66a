"""Sparsity & compute observability: per-layer FLOPs/occupancy accounting
(``accounting``, with the H100's roofline constants) and structured JSONL
run logs (``runlog``); ports ``repro/observability``."""
from repro_torch.observability.accounting import (CHIP_TDP_W, HBM_BW,
                                                  LINK_BW, PEAK_FLOPS,
                                                  LayerCost, SparsityReport,
                                                  ffn_bytes_per_token,
                                                  ffn_dense_flops_per_token,
                                                  ffn_effective_flops_per_token,
                                                  matmul_params, mfu,
                                                  model_flops, param_count,
                                                  stats_from_hidden,
                                                  tile_occupancy_from_twell,
                                                  tokens_per_joule)
from repro_torch.observability.runlog import (SCHEMA_VERSION, RunLogger,
                                              iter_runlog, read_runlog)

__all__ = [
    "CHIP_TDP_W", "HBM_BW", "LINK_BW", "PEAK_FLOPS",
    "LayerCost", "SparsityReport",
    "ffn_bytes_per_token", "ffn_dense_flops_per_token",
    "ffn_effective_flops_per_token", "matmul_params", "mfu", "model_flops",
    "param_count", "stats_from_hidden", "tile_occupancy_from_twell",
    "tokens_per_joule",
    "SCHEMA_VERSION", "RunLogger", "iter_runlog", "read_runlog",
]
