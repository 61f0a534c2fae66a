"""SparseFFN — the paper's FFN with its inference execution strategies.

Ports ``repro/core/sparse_ffn.py`` for serving (``SparsityConfig.ffn_impl``):

- ``dense``   paper-faithful math (Eq. 1 / Eq. 5) as plain ``torch.matmul``s,
              as the JAX package leaves it to XLA;
- ``gather``  Eq. 3 fused up+down projection from packed TwELL gate
              activations: kernel K1 packs the gate, kernel K2 projects
              (``kernels/ops.py``); a non-gated FFN (App. C.2) packs
              act(x @ W_u) with K1 and projects down with kernel K6;
- ``tile_skip`` the gated FFN end to end in kernel K5, which skips the
              W_u/W_d work of dead (row block x tile) cells and, with
              ``tile_skip_threshold > 0``, drops tiles whose max gate
              activation is at most the threshold (the lossy path
              self-speculative decoding drafts with); non-gated FFNs take
              the dense path.
- ``hybrid``  training (Sec. 3.4/3.5): a ``torch.autograd.Function`` whose
              saved tensors are the inputs and the *packed* activations
              (hybrid format, ``core/hybrid.py``), with the Eq. 4
              pattern-only backward and the L1 gradient injection; its
              products run through kernels K8 and K9 on the card. This is
              the peak-memory reduction of Table 1.

Training on a mesh (``apply``'s ``group`` a training ``ModelGroup``,
``dp`` the data-parallel axes; ``dense`` and ``hybrid``): ``W_g`` and
``W_u`` split by columns, ``W_d`` by rows, evenly, as JAX's
``param_spec`` splits them (``put(-1, "model")``). Each rank runs its
share (K8 and K9 on its d_ff shard for ``hybrid``), packing its own
columns; y's partial sums are reduced over the ranks
(``collectives.reduce_out``, after ``copy_in`` on x). The aux is JAX's
global statistics: the L1 term summed over the ranks by ``reduce_out``
and meaned over dp, ``nnz`` per row summed over the ranks (the serving
probe's (row, tile) cells for ``dense``), ``neuron_active`` concatenated
over the ranks and ORed over dp, ``tile_frac`` over the global tiles.

``apply`` returns ``(y, aux)``. JAX always builds the aux statistics and
lets XLA drop what ``jit`` does not use; eager PyTorch would compute them
all, and the gated ``gather`` aux gathers an (M, N/C, K) slice of ``W_u``
for its L1 (about 740 MB per layer for a 256-row chunk at paper-0.5b
width). So the caller asks for what it reads: ``collect_aux=True`` builds
the whole aux dict (``l1``, ``nnz_mean``, ``nnz_max``, ``neuron_active``,
``tile_frac``; training), ``collect_aux="probe"`` only ``nnz_mean`` and
``tile_frac`` (the serving engine's sparsity probe: a few reductions over
the pattern, no weight read), and ``False`` nothing (``aux`` is None).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch import device as device_mod
from repro_torch.config import SparsityConfig
from repro_torch.core import hybrid as hybrid_fmt
from repro_torch.core import twell
from repro_torch.core.sparsity import activation, activation_grad, l1_loss
from repro_torch.distributed import collectives


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


PROBE = "probe"                 # collect_aux: nnz_mean and tile_frac only


def _probe(cells: torch.Tensor, group) -> Dict[str, torch.Tensor]:
    """The serving probe from ``cells`` (rows, the FFN's tiles), each the
    count of active neurons of a (row, tile) cell over all d_ff columns:
    ``cells`` summed over the ranks first (none without a ``group``), then
    ``nnz_mean`` and ``tile_frac`` of the whole pattern."""
    collectives.all_reduce(cells, group)
    return {"nnz_mean": cells.sum(dim=-1).mean(),
            "tile_frac": (cells > 0).float().mean()}


def _ffn_span(group, n: int) -> Tuple[int, int]:
    """(this rank's first d_ff column, the whole d_ff): (0, n) unsharded."""
    return (0, n) if group is None else (group.ffn_start, group.d_ff)


def _mask_cells(mask: torch.Tensor, tile: int, group) -> torch.Tensor:
    """(rows, tiles of d_ff) float32 counts of this rank's active columns,
    each at its global tile: a tile that two ranks share gets a part from
    each."""
    start, d_ff = _ffn_span(group, mask.shape[-1])
    tile = max(1, min(int(tile), d_ff))
    cols = torch.arange(start, start + mask.shape[-1], device=mask.device)
    cells = torch.zeros((mask.shape[0], -(-d_ff // tile)),
                        dtype=torch.float32, device=mask.device)
    return cells.index_add_(1, cols // tile, mask.float())


def _aux_from_h(h: torch.Tensor, tile: int, collect_aux, group=None
                ) -> Optional[Dict[str, torch.Tensor]]:
    if not collect_aux:
        return None
    mask = h != 0
    if collect_aux == PROBE:
        return _probe(_mask_cells(mask, tile, group), group)
    nnz = mask.sum(dim=-1)
    return {
        "l1": l1_loss(h),
        "nnz_mean": nnz.float().mean(),
        "nnz_max": nnz.max().to(torch.int32),
        "neuron_active": mask.any(dim=0),
        "tile_frac": _tile_frac(mask, tile),
    }


def _dense_h(params, x, scfg: SparsityConfig, gated: bool) -> torch.Tensor:
    act = activation(scfg.activation if scfg.enabled else "silu")
    if gated:
        return (x @ params["wu"]) * act(x @ params["wg"])
    return act(x @ params["wu"])


def _dense_apply(params, x, scfg: SparsityConfig, gated: bool,
                 collect_aux: bool, group=None):
    h = _dense_h(params, x, scfg, gated)
    y = h @ params["wd"]
    return y, _aux_from_h(h, scfg.twell_tile, collect_aux, group)


def _twell_apply(params, x, scfg: SparsityConfig, gated: bool,
                 collect_aux: bool, group=None):
    from repro_torch.kernels import ops
    if gated:
        tw = ops.twell_gate_matmul(x, params["wg"], scfg.twell_tile,
                                   scfg.twell_c, scfg.activation)
        y = ops.twell_fused_ffn(x, tw, params["wu_t"], params["wd"])
    else:
        # App. C.2: the up projection produces the pattern (K1), the down
        # projection reads only its rows of W_d (K6)
        tw = ops.twell_gate_matmul(x, params["wu"], scfg.twell_tile,
                                   scfg.twell_c, scfg.activation)
        y = ops.twell_down_proj(tw, params["wd"])
    if not collect_aux:
        return y, None
    if collect_aux == PROBE:
        # whole tiles a rank (sharding.ffn_split): this rank's tile counts
        # go to its tiles' places in the (rows, tiles of d_ff) cells
        start, d_ff = _ffn_span(group, tw.n)
        t0, nt = start // scfg.twell_tile, tw.nnz.shape[-1]
        cells = torch.nn.functional.pad(
            tw.nnz.float(), (t0, d_ff // scfg.twell_tile - t0 - nt))
        return y, _probe(cells, group)
    nnz_rows = tw.nnz.sum(-1)
    if gated:
        # Eq. 2's L1 is over h = h_u * h_g: recover |h| on the pattern
        # through the same gathered h_u elements the fused kernel computes
        valid = twell.slot_valid(tw)
        hu_p = torch.einsum("mk,mck->mc", x,
                            params["wu_t"][tw.indices.long()])
        h_abs = torch.where(valid, tw.values * hu_p,
                            torch.zeros_like(hu_p)).float().abs()
    else:
        h_abs = tw.values.float().abs()
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
                     collect_aux: bool, group=None):
    from repro_torch.kernels import ops
    if not gated:
        return _dense_apply(params, x, scfg, gated, collect_aux, group)
    y, h = ops.tile_skip_ffn(x, params["wg"], params["wu"], params["wd"],
                             scfg.twell_tile, scfg.activation,
                             threshold=scfg.tile_skip_threshold)
    return y, _aux_from_h(h, scfg.twell_tile, collect_aux, group)


# --------------------------------------------------------------------------- #
# hybrid -- training autograd.Functions with packed saved tensors (Eq. 4)
# --------------------------------------------------------------------------- #

_WGRAD_CHUNK = 1 << 23          # elements of one (rows, columns) f32 chunk


def _scatter_wgrad(idx, gvals, x, dense_gvals, dense_map, n: int
                   ) -> torch.Tensor:
    """grad_W^T[n, k] = sum_m g[m, n] x[m, k] with g in hybrid layout ->
    (N, K) in x.dtype, summed in float32.

    ``repro/core/sparse_ffn.py:_scatter_wgrad`` forms an (M*E, K) product
    and scatter-adds it (8.6 GB at M = 8192, E = 128, K = 2048). Here only
    the columns some ELL slot holds get an ELL contribution: they are
    gathered once (one host sync), each chunk of rows scatters its slots
    into a (rows, those columns) float32 matrix of 32 MB at most and adds
    its product with the chunk's x. The backup side is a plain matmul on
    the gathered source rows. On tensors without data (a dry run) the
    columns are data the trace does not have: it takes all N, the
    capacity, the shape JAX's static ``_scatter_wgrad`` works on."""
    m, dev = idx.shape[0], x.device
    xf = x.float()
    ok = dense_map >= 0
    xd = torch.where(ok[:, None], xf[dense_map.clamp(min=0).long()],
                     torch.zeros((), device=dev))
    wn = dense_gvals.float().t() @ xd
    if device_mod.shape_only(idx):
        cols = torch.arange(n, device=dev)
    else:
        used = torch.zeros(n, dtype=torch.bool, device=dev)
        used[idx.reshape(-1).long()] = True
        cols = used.nonzero()[:, 0]
    pos = torch.zeros(n, dtype=torch.long, device=dev)
    pos[cols] = torch.arange(cols.numel(), device=dev)
    local = pos[idx.long()]
    ell = torch.zeros((cols.numel(), x.shape[1]), dtype=torch.float32,
                      device=dev)
    step = max(1, _WGRAD_CHUNK // cols.numel())
    for r0 in range(0, m, step):
        g = torch.zeros((min(step, m - r0), cols.numel()),
                        dtype=torch.float32, device=dev)
        g.scatter_add_(1, local[r0:r0 + step], gvals[r0:r0 + step].float())
        ell += g.t() @ xf[r0:r0 + step]
    wn[cols] += ell
    return wn.to(x.dtype)


def _packed_stats(h: hybrid_fmt.HybridActs):
    """(row_nnz, neuron_active) from the packed representation, float32."""
    active = torch.zeros((h.n,), dtype=torch.int32, device=h.row_nnz.device)
    active = active.scatter_reduce(
        0, h.ell_indices.reshape(-1).long(),
        (h.ell_values.reshape(-1) != 0).to(torch.int32), "amax") > 0
    active = active | (h.dense_rows != 0).any(0)
    return h.row_nnz.float(), active.float()


def _l1(h: hybrid_fmt.HybridActs, m: int) -> torch.Tensor:
    return (h.ell_values.float().abs().sum() +
            h.dense_rows.float().abs().sum()) / (m * h.n)


_PACKED = ("ell_values", "ell_indices", "row_nnz", "is_dense", "dense_rows",
           "dense_map")


def _save(ctx, tensors, *packs):
    """Save ``tensors`` and each HybridActs's six tensors; the packs share
    one pattern, so only the first's index tensors are kept."""
    flat = list(tensors) + [getattr(packs[0], f) for f in _PACKED]
    for p in packs[1:]:
        flat += [p.ell_values, p.dense_rows]
    ctx.save_for_backward(*flat)
    ctx.n_plain, ctx.n = len(tensors), packs[0].n


def _load(ctx):
    saved = ctx.saved_tensors
    plain, rest = saved[:ctx.n_plain], saved[ctx.n_plain:]
    first = hybrid_fmt.HybridActs(*rest[:6], overflow=None, n=ctx.n)
    packs = [first]
    for i in range(6, len(rest), 2):
        packs.append(first._replace(ell_values=rest[i],
                                    dense_rows=rest[i + 1]))
    return plain, packs


def _inject_l1(gh, h, gl1, m: int):
    """grad h on the pattern in float32, plus the L1 injection
    d|h|/dh = sign(h) scaled by gl1 / (M N)."""
    inj = gl1.float() / (m * h.n)
    return (gh.ell_values.float() + inj * torch.sign(h.ell_values).float(),
            gh.dense_rows.float() + inj * torch.sign(h.dense_rows).float())


class _HybridGated(torch.autograd.Function):
    """(x, W_g, W_u, W_d) -> (y, l1, row_nnz, neuron_active); the last two
    are statistics and carry no gradient."""

    @staticmethod
    def forward(ctx, x, wg, wu, wd, ell_width, num_dense_rows, act_name):
        hg_dense = activation(act_name)(x @ wg)
        hg = hybrid_fmt.pack(hg_dense, ell_width, num_dense_rows,
                             mask=hg_dense > 0)
        del hg_dense
        hu = hybrid_fmt.dense_to_hybrid_matmul(x, wu.t().contiguous(), hg)
        h = hybrid_fmt.elementwise(hg, hu.ell_values, hu.dense_rows,
                                   torch.mul)
        h = h._replace(dense_rows=torch.where(
            hg.dense_rows != 0, h.dense_rows,
            torch.zeros((), dtype=h.dense_rows.dtype, device=x.device)))
        y = hybrid_fmt.hybrid_to_dense_matmul(h, wd)
        row_nnz, active = _packed_stats(h)
        # saved: the inputs and the packed activations only (Table 1)
        _save(ctx, (x, wg, wu, wd), hg, hu, h)
        ctx.act_name = act_name
        ctx.mark_non_differentiable(row_nnz, active)
        return y, _l1(h, x.shape[0]), row_nnz, active

    @staticmethod
    def backward(ctx, gy, gl1, _nnz, _active):
        (x, wg, wu, wd), (hg, hu, h) = _load(ctx)
        m, n = x.shape[0], hg.n
        gy = gy.contiguous()
        # grad_h = grad_y @ W_d^T on the stored pattern: W_d^T's columns are
        # W_d's rows, so K9 reads W_d itself
        gh_e, gh_d = _inject_l1(hybrid_fmt.dense_to_hybrid_matmul(gy, wd, hg),
                                h, gl1, m)
        # Eq. 4 elementwise splits on the pattern, through the gate
        ghu = hg._replace(ell_values=gh_e * hg.ell_values,
                          dense_rows=gh_d * hg.dense_rows)
        ag_e = activation_grad(ctx.act_name, hg.ell_values)
        ag_d = activation_grad(ctx.act_name, hg.dense_rows)
        ghg = hg._replace(ell_values=gh_e * hu.ell_values * ag_e,
                          dense_rows=gh_d * hu.dense_rows * ag_d)
        # weight grads on the pattern (never a dense M x N product)
        gwd = _scatter_wgrad(h.ell_indices, h.ell_values, gy, h.dense_rows,
                             h.dense_map, n)
        gwu = _scatter_wgrad(hu.ell_indices, ghu.ell_values, x,
                             ghu.dense_rows, hu.dense_map, n).t()
        gwg = _scatter_wgrad(hg.ell_indices, ghg.ell_values, x,
                             ghg.dense_rows, hg.dense_map, n).t()
        # grad_x = grad_hu @ W_u^T + grad_g @ W_g^T (K8 reads W^T by rows)
        gx = hybrid_fmt.hybrid_to_dense_matmul(ghu, wu.t().contiguous()) + \
            hybrid_fmt.hybrid_to_dense_matmul(ghg, wg.t().contiguous())
        return (gx.to(x.dtype), gwg.contiguous().to(wg.dtype),
                gwu.contiguous().to(wu.dtype), gwd.to(wd.dtype),
                None, None, None)


class _HybridNongated(torch.autograd.Function):
    """(x, W_u, W_d) -> (y, l1, row_nnz, neuron_active)."""

    @staticmethod
    def forward(ctx, x, wu, wd, ell_width, num_dense_rows, act_name):
        h_dense = activation(act_name)(x @ wu)
        h = hybrid_fmt.pack(h_dense, ell_width, num_dense_rows,
                            mask=h_dense > 0)
        del h_dense
        y = hybrid_fmt.hybrid_to_dense_matmul(h, wd)
        row_nnz, active = _packed_stats(h)
        _save(ctx, (x, wu, wd), h)
        ctx.act_name = act_name
        ctx.mark_non_differentiable(row_nnz, active)
        return y, _l1(h, x.shape[0]), row_nnz, active

    @staticmethod
    def backward(ctx, gy, gl1, _nnz, _active):
        (x, wu, wd), (h,) = _load(ctx)
        m, n = x.shape[0], h.n
        gy = gy.contiguous()
        gh_e, gh_d = _inject_l1(hybrid_fmt.dense_to_hybrid_matmul(gy, wd, h),
                                h, gl1, m)
        gu = h._replace(
            ell_values=gh_e * activation_grad(ctx.act_name, h.ell_values),
            dense_rows=gh_d * activation_grad(ctx.act_name, h.dense_rows))
        gwd = _scatter_wgrad(h.ell_indices, h.ell_values, gy, h.dense_rows,
                             h.dense_map, n)
        gwu = _scatter_wgrad(h.ell_indices, gu.ell_values, x, gu.dense_rows,
                             h.dense_map, n).t()
        gx = hybrid_fmt.hybrid_to_dense_matmul(gu, wu.t().contiguous())
        return (gx.to(x.dtype), gwu.contiguous().to(wu.dtype),
                gwd.to(wd.dtype), None, None, None)


# --------------------------------------------------------------------------- #
# training: a rank's share of the FFN (all of it off a mesh) and the aux
# --------------------------------------------------------------------------- #

def train_shard(params, x, scfg: SparsityConfig, gated: bool, impl: str):
    """The training FFN over this rank's columns of d_ff (all of them off
    the model axis), with no collective: (y's partial sum, statistics:
    ``l1`` mean |h| over these columns, ``n`` their count, and ``mask``
    (rows, n) for ``dense`` or ``row_nnz``/``active`` for ``hybrid``).
    ``train_aux`` makes the aux of them."""
    if impl == "dense":
        h = _dense_h(params, x, scfg, gated)
        return h @ params["wd"], {"l1": l1_loss(h), "mask": h != 0,
                                  "n": h.shape[-1]}
    if impl != "hybrid":
        raise NotImplementedError(
            f"training on a mesh runs ffn_impl dense or hybrid, not {impl!r}")
    md = max(1, int(x.shape[0] * scfg.dense_backup_frac))
    if gated:
        y, l1, row_nnz, active = _HybridGated.apply(
            x, params["wg"], params["wu"], params["wd"], scfg.ell_width, md,
            scfg.activation)
    else:
        y, l1, row_nnz, active = _HybridNongated.apply(
            x, params["wu"], params["wd"], scfg.ell_width, md,
            scfg.activation)
    return y, {"l1": l1, "row_nnz": row_nnz, "active": active > 0,
               "n": params["wd"].shape[-2]}


def train_aux(st: Dict, scfg: SparsityConfig, group, dp
              ) -> Dict[str, torch.Tensor]:
    """``train_shard``'s statistics as JAX's aux over the whole FFN (its
    columns on every rank of ``group``, the model axis, or None) and the
    whole batch (its rows on every rank of ``dp``, or None)."""
    d_ff = st["n"] if group is None else group.d_ff
    l1 = collectives.pmean(collectives.reduce_out(
        st["l1"] * (st["n"] / d_ff), group), dp)
    if "mask" in st:
        cells = collectives.psum(
            _mask_cells(st["mask"], scfg.twell_tile, group), group)
        nnz, active = cells.sum(dim=-1), st["mask"].any(dim=0)
    else:
        nnz, active = collectives.psum(st["row_nnz"], group), st["active"]
    if group is not None:
        active = collectives.all_gather_last(active.to(torch.int32),
                                             group) > 0
    active = collectives.pany(active, dp)
    # the packed stats are per neuron, not per (row x tile): the hybrid
    # FFN reports the batch-level tile occupancy, as the JAX package does
    tile_frac = collectives.pmean((cells > 0).float().mean(), dp) \
        if "mask" in st else _tile_frac(active[None, :], scfg.twell_tile)
    return {"l1": l1,
            "nnz_mean": collectives.pmean(nnz.float().mean(), dp),
            "nnz_max": collectives.pmax(nnz.max().to(torch.int32), dp),
            "neuron_active": active, "tile_frac": tile_frac}


def _own_columns(params, group):
    """``param_spec`` splits ``W_g`` only where the heads divide the model
    axis (its ``w[rg]`` rule), ``W_u`` and ``W_d`` wherever d_ff does: a
    whole ``W_g`` beside split ones gives this rank its columns, entering
    through ``copy_in`` so that its gradient sums the ranks' columns."""
    n = params["wd"].shape[-2]
    return {k: collectives.copy_in(w, group).narrow(-1, group.ffn_start, n)
            if k in ("wu", "wg") and w.shape[-1] != n else w
            for k, w in params.items()}


def _train_apply(params, x, scfg, gated, impl, collect_aux, group=None,
                 dp=None):
    if group is not None:
        params = _own_columns(params, group)
    y, st = train_shard(params, collectives.copy_in(x, group), scfg, gated,
                        impl)
    y = collectives.reduce_out(y, group)
    return y, (train_aux(st, scfg, group, dp) if collect_aux else None)


def _hybrid_apply(params, x, scfg: SparsityConfig, gated: bool,
                  collect_aux: bool):
    return _train_apply(params, x, scfg, gated, "hybrid", collect_aux)


_IMPLS = {
    "dense": _dense_apply,
    "gather": _twell_apply,
    "tile_skip": _tile_skip_apply,
    "hybrid": _hybrid_apply,
}


def apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
          scfg: SparsityConfig, gated: bool,
          collect_aux: Union[bool, str] = False, group=None, dp=None
          ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: (..., d_model) -> (..., d_model), plus sparsity aux: the whole
    dict (``collect_aux=True``), ``nnz_mean`` and ``tile_frac`` only
    (``collect_aux="probe"``), or None.

    Under tensor parallelism (``group``, a ``sharding.ModelGroup``;
    serving only) the weights are this rank's share of the hidden dim, in
    Megatron's layout: ``wu``/``wg`` its columns, ``wd`` its rows. The
    kernels run on the shard and the partial y is summed over the ranks;
    the probe counts every rank's columns. A training group
    (``ModelGroup.train``) or ``dp`` (the data-parallel axes, an
    ``AxisGroup``) takes training's path on a mesh (``train_shard``,
    ``train_aux``): collectives with a backward and global statistics."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    impl = scfg.ffn_impl if scfg.enabled else "dense"
    if impl not in _IMPLS:
        raise NotImplementedError(
            f"ffn_impl {impl!r} is not ported yet (port has {sorted(_IMPLS)})")
    if group is not None and group.train or dp is not None:
        y, aux = _train_apply(params, x2, scfg, gated, impl,
                              bool(collect_aux), group, dp)
    elif group is None:
        y, aux = _IMPLS[impl](params, x2, scfg, gated, collect_aux)
    else:
        if impl == "hybrid" or collect_aux not in (False, PROBE):
            raise NotImplementedError(
                "a serving group runs the inference FFN with the probe; "
                "training takes a training group (sharding.Mesh.model)")
        y, aux = _IMPLS[impl](params, x2, scfg, gated, collect_aux, group)
        collectives.all_reduce(y, group)
    return y.reshape(*lead, -1), aux
