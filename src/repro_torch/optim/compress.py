"""Error-feedback gradient compression for the cross-pod all-reduce (ports
``repro/optim/compress.py``).

Across pods the ``pod`` axis crosses the slow links; compressing the
gradient payload before that all-reduce is the classic remedy. Two
compressors, both with error feedback (the residual of what compression
dropped is carried and added back the next step):

- ``int8``  a per-leaf scale and int8 quantization;
- ``topk``  the largest-magnitude fraction ``topk_frac`` of each leaf.

Each rank compresses its own gradient; what it sent is all-reduced over
the ``pod`` group of a ``sharding.Mesh`` and divided by the pod count,
and its residual is its new error state. JAX runs the same under a
partial-manual ``shard_map`` over the pod axis, where every pod's input is
the replicated gradient. As in the JAX package, the train step does not
call it (``TrainConfig.grad_compression`` is unused there too).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.distributed import collectives
from repro_torch.tree import leaves, tree_map, unflatten


def _int8_compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _topk_mask(g: torch.Tensor, frac: float) -> torch.Tensor:
    flat = g.reshape(-1).abs()
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(flat, k).values[-1]
    return (g.abs() >= thresh).to(g.dtype)


def compressed_psum(grads: Any, errors: Any, mesh, axis: str = "pod",
                    method: str = "int8", topk_frac: float = 0.01
                    ) -> Tuple[Any, Any]:
    """All-reduce ``grads`` over ``axis`` of ``mesh`` with compression and
    error feedback. ``errors``: a tree like ``grads`` (float32) carrying
    the compression residual. Returns (reduced grads in their dtypes, new
    errors). With ``method`` "none", or without ``axis`` on the mesh,
    both pass through."""
    if method == "none" or axis not in mesh.mesh_dim_names:
        return grads, errors
    group = mesh.axis(axis)

    def leaf(g, e):
        gf = g.float() + e
        if method == "int8":
            sent = _int8_decompress(*_int8_compress(gf))
        else:
            sent = gf * _topk_mask(gf, topk_frac)
        red = collectives.psum(sent, group) / group.size
        return red.to(g.dtype), gf - sent

    out = [leaf(g, e) for g, e in zip(leaves(grads), leaves(errors))]
    return (unflatten(grads, [r for r, _ in out]),
            unflatten(errors, [e for _, e in out]))


def init_error_state(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)
