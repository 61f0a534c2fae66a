"""Stand-ins for every input of a dry-run cell: meta tensors, shapes and
dtypes without data (ports ``repro/launch/specs.py``, whose
``ShapeDtypeStruct``s they replace). Nothing is allocated on any device.

The parameters follow the port's own tree (``lm.init``, so
``lm.prepare_params``): a gated FFN carries its ``wu_t`` beside ``wu``.
``lm.trainable`` gives the tree of JAX's ``abstract_params``, which the
optimizer state follows.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import device as device_mod
from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.optim import adamw


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device_mod.SHAPE_ONLY)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                with_labels: bool = True) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    dt = device_mod.torch_dtype(cfg.dtype)
    out = {"tokens": _meta((b, s), torch.int32)}
    if with_labels:
        out["labels"] = _meta((b, s), torch.int32)
    if cfg.family == "audio":
        out["frames"] = _meta((b, s, cfg.d_model), dt)
    if cfg.family == "vlm":
        out["patches"] = _meta((b, cfg.num_image_tokens, cfg.d_model), dt)
    return out


def cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The static decode cache of a decode cell (``lm.init_cache``)."""
    return lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                         device=device_mod.SHAPE_ONLY,
                         enc_len=shape.seq_len,
                         num_patches=cfg.num_image_tokens)


def decode_token_specs(cfg: ModelConfig, shape: ShapeConfig) -> torch.Tensor:
    return _meta((shape.global_batch, 1), torch.int32)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The whole input set of the cell's step function."""
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, shape, with_labels=True)}
    if shape.kind == "prefill":
        return {"batch": batch_specs(cfg, shape, with_labels=False)}
    if shape.kind == "decode":
        return {"cache": cache_specs(cfg, shape),
                "tokens": decode_token_specs(cfg, shape)}
    raise ValueError(shape.kind)


def abstract_params(cfg: ModelConfig) -> Dict[str, Any]:
    """The serving tree (``lm.init`` on the meta device: nothing drawn)."""
    return lm.init(cfg, device=device_mod.SHAPE_ONLY)


def abstract_opt_state(params: Dict[str, Any], cfg: ModelConfig
                       ) -> adamw.AdamWState:
    """AdamW's state over the trainable tree of ``params``."""
    return adamw.init(lm.trainable(params),
                      device_mod.torch_dtype(cfg.opt_state_dtype))
