"""SparseFFN — the paper's FFN with its inference execution strategies.

Ports ``repro/core/sparse_ffn.py`` for serving (``SparsityConfig.ffn_impl``):

- ``dense``   paper-faithful math (Eq. 1 / Eq. 5) as plain ``torch.matmul``s,
              as the JAX package leaves it to XLA;
- ``gather``  Eq. 3 fused up+down projection from packed TwELL gate
              activations: kernel K1 packs the gate, kernel K2 projects
              (``kernels/ops.py``);
- ``tile_skip`` the gated FFN end to end in kernel K5, which skips the
              W_u/W_d work of dead (row block x tile) cells and, with
              ``tile_skip_threshold > 0``, drops tiles whose max gate
              activation is at most the threshold (the lossy path
              self-speculative decoding drafts with); non-gated FFNs take
              the dense path.

``apply`` returns ``(y, aux)``. JAX always builds the aux statistics and
lets XLA drop what ``jit`` does not use; eager PyTorch would compute them
all, and the ``gather`` aux gathers an (M, N/C, K) slice of ``W_u`` (about
740 MB per layer for a 256-row chunk at paper-0.5b width). So the aux dict
(``l1``, ``nnz_mean``, ``nnz_max``, ``neuron_active``, ``tile_frac``) is
built only when the caller passes ``collect_aux=True``; otherwise ``aux``
is None.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import SparsityConfig
from repro_torch.core import twell
from repro_torch.core.sparsity import activation, l1_loss


def init(d_model: int, d_ff: int, gated: bool, dtype: torch.dtype,
         generator: torch.Generator, device: torch.device,
         init_std: float = 0.02) -> Dict[str, torch.Tensor]:
    def r(shape):
        return (init_std * torch.randn(shape, generator=generator,
                                       device=device)).to(dtype)
    params = {"wu": r((d_model, d_ff)), "wd": r((d_ff, d_model))}
    if gated:
        params["wg"] = r((d_model, d_ff))
    return params


def _tile_frac(mask_n: torch.Tensor, tile: int) -> torch.Tensor:
    """Fraction of (row x tile) cells with any active neuron."""
    *lead, n = mask_n.shape
    tile = max(1, min(int(tile), n))
    nt = -(-n // tile)
    pad = nt * tile - n
    if pad:
        mask_n = torch.nn.functional.pad(mask_n, (0, pad))
    return mask_n.reshape(*lead, nt, tile).any(-1).float().mean()


def _aux_from_h(h: torch.Tensor, tile: int) -> Dict[str, torch.Tensor]:
    mask = h != 0
    nnz = mask.sum(dim=-1)
    return {
        "l1": l1_loss(h),
        "nnz_mean": nnz.float().mean(),
        "nnz_max": nnz.max().to(torch.int32),
        "neuron_active": mask.any(dim=0),
        "tile_frac": _tile_frac(mask, tile),
    }


def _dense_apply(params, x, scfg: SparsityConfig, gated: bool,
                 collect_aux: bool):
    act = activation(scfg.activation if scfg.enabled else "silu")
    if gated:
        h = (x @ params["wu"]) * act(x @ params["wg"])
    else:
        h = act(x @ params["wu"])
    y = h @ params["wd"]
    return y, (_aux_from_h(h, scfg.twell_tile) if collect_aux else None)


def _twell_apply(params, x, scfg: SparsityConfig, gated: bool,
                 collect_aux: bool):
    from repro_torch.kernels import ops
    if not gated:
        raise NotImplementedError(
            "the non-gated TwELL path needs twell_down_proj (TPU kernel K6), "
            "which the port has not reached yet")
    tw = ops.twell_gate_matmul(x, params["wg"], scfg.twell_tile,
                               scfg.twell_c, scfg.activation)
    y = ops.twell_fused_ffn(x, tw, params["wu_t"], params["wd"])
    if not collect_aux:
        return y, None
    # Eq. 2's L1 is over h = h_u * h_g: recover |h| on the pattern through
    # the same gathered h_u elements the fused kernel computes (Eq. 3)
    valid = twell.slot_valid(tw)
    hu_p = torch.einsum("mk,mck->mc", x, params["wu_t"][tw.indices.long()])
    h_abs = torch.where(valid, tw.values * hu_p,
                        torch.zeros_like(hu_p)).float().abs()
    nnz_rows = tw.nnz.sum(-1)
    active = torch.zeros((tw.n,), dtype=torch.int32, device=x.device)
    active = active.scatter_reduce(
        0, tw.indices.reshape(-1).long(),
        (tw.values.reshape(-1) != 0).to(torch.int32), "amax") > 0
    aux = {
        "l1": h_abs.sum() / (x.shape[0] * tw.n),
        "nnz_mean": nnz_rows.float().mean(),
        "nnz_max": nnz_rows.max().to(torch.int32),
        "neuron_active": active,
        "tile_frac": (tw.nnz > 0).float().mean(),
    }
    return y, aux


def _tile_skip_apply(params, x, scfg: SparsityConfig, gated: bool,
                     collect_aux: bool):
    from repro_torch.kernels import ops
    if not gated:
        return _dense_apply(params, x, scfg, gated, collect_aux)
    y, h = ops.tile_skip_ffn(x, params["wg"], params["wu"], params["wd"],
                             scfg.twell_tile, scfg.activation,
                             threshold=scfg.tile_skip_threshold)
    return y, (_aux_from_h(h, scfg.twell_tile) if collect_aux else None)


_IMPLS = {
    "dense": _dense_apply,
    "gather": _twell_apply,
    "tile_skip": _tile_skip_apply,
}


def apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
          scfg: SparsityConfig, gated: bool, collect_aux: bool = False
          ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: (..., d_model) -> (..., d_model), plus sparsity aux (or None)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    impl = scfg.ffn_impl if scfg.enabled else "dense"
    if impl not in _IMPLS:
        raise NotImplementedError(
            f"ffn_impl {impl!r} is not ported yet (port has {sorted(_IMPLS)})")
    y, aux = _IMPLS[impl](params, x2, scfg, gated, collect_aux)
    return y.reshape(*lead, -1), aux
