"""Train step builder: loss + grad + clip + AdamW, with the L1 warm-up
schedule and microbatch gradient accumulation, and the serve and prefill
steps the dry run traces (ports ``repro/training.py:17-100``).

``make_train_step(..., mesh=)`` is JAX's step jitted with parameter,
optimizer and batch shardings on a ``("pod", "data", "model")`` mesh or
any subset of it (``repro/launch/dryrun.py:66-85``): FSDP on ``data``,
TP on ``model``, pure DP on ``pod``. Every rank is a process holding its
shards of the parameters and of AdamW's ``m`` and ``v`` (``lm.train_specs``,
``bridge.shard_train_state``) and runs the same step on the whole batch,
of which ``lm.loss_fn`` takes its rows. The collectives are explicit
(``distributed/collectives.py``): no ``torch.compile``, and no
``DistributedDataParallel`` or FSDP wrapper choosing a layout of its own.
The gradients are meaned over the dp ranks: a ``data``-sharded leaf's
through FSDP's reduce-scatter (the gather's backward) and an all-reduce
over ``pod``, any other leaf's through an all-reduce over ``pod`` and
``data``; then the clip (``adamw.global_norm`` over the shards) and
AdamW on the shards. ``TrainConfig.grad_compression`` stays unused, as in
JAX's step (``optim/compress.py`` is not wired in there either).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import device as device_mod
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.core.sparsity import l1_schedule
from repro_torch.distributed import collectives
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.tree import leaves, tree_map, unflatten

TRAINABLE_IMPLS = ("dense", "hybrid")


def per_layer_stats(aux: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-layer (L,) sparsity trajectories from the stacked block aux."""
    return {
        "nnz_per_layer": aux["nnz_mean"].float(),
        "dead_frac_per_layer":
            1.0 - aux["neuron_active"].float().mean(-1),
        "tile_frac_per_layer": aux["tile_frac"].float(),
        "ffn_present_per_layer": aux["ffn_present"].float(),
    }


def _dp_mean_grads(grads, specs, mesh):
    """Each leaf's gradient meaned over the dp ranks, summed in float32
    and cast back: over ``pod`` where the leaf is ``data``-sharded (the
    gather's reduce-scatter summed over ``data``), else over ``pod`` and
    ``data``."""
    dp = mesh.dp
    if dp is None:
        return grads

    def mean(g, spec):
        axes = ("pod",) if "data" in spec else ("pod", "data")
        return (collectives.psum(g.float(), mesh.axis(*axes)) / dp.size
                ).to(g.dtype)
    return tree_map(mean, grads, specs)


def make_grad_fn(cfg: ModelConfig, tcfg: TrainConfig, mesh=None):
    """Returns grads(params, batch, l1_coeff) -> (grads, metrics, aux):
    the train step's gradients before the clip (microbatched, and meaned
    over the dp ranks on a ``mesh``), its metrics and the first
    microbatch's aux (see ``make_train_step``)."""
    impl = cfg.sparsity.ffn_impl if cfg.sparsity.enabled else "dense"
    if impl not in TRAINABLE_IMPLS:
        raise NotImplementedError(
            f"training runs ffn_impl {TRAINABLE_IMPLS}, not {impl!r}")
    specs = lm.train_specs(cfg, mesh) if mesh is not None else None
    ndp = mesh.dp.size if mesh is not None and mesh.dp is not None else 1

    def grads_of(params, batch, l1c):
        if batch["tokens"].shape[0] % ndp:
            raise ValueError(
                f"{batch['tokens'].shape[0]} rows do not split over the "
                f"{ndp} data-parallel ranks")
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(True),
                            params)
            loss, (metrics, aux) = lm.loss_fn(live, batch, cfg, l1c,
                                              mesh=mesh)
            grads = torch.autograd.grad(loss, leaves(live))
        detach = lambda t: t.detach()  # noqa: E731
        return (unflatten(params, list(grads)), tree_map(detach, metrics),
                tree_map(detach, aux))

    def grads(params, batch, l1c):
        rows = batch["tokens"].shape[0]
        if tcfg.microbatch and tcfg.microbatch < rows:
            if rows % tcfg.microbatch:
                raise ValueError(f"microbatch {tcfg.microbatch} does not "
                                 f"split {rows} rows")
            nmb = rows // tcfg.microbatch
            acc_dt = device_mod.torch_dtype(tcfg.grad_accum_dtype)
            g_acc = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dt),
                             params)
            m_acc = aux = None
            for i in range(nmb):
                sl = slice(i * tcfg.microbatch, (i + 1) * tcfg.microbatch)
                g, m, a = grads_of(params, {k: v[sl] for k, v in
                                            batch.items()}, l1c)
                g_acc = tree_map(lambda x, y: x + y.to(x.dtype), g_acc, g)
                if m_acc is None:
                    m_acc, aux = tree_map(torch.zeros_like, m), a
                m_acc = tree_map(torch.add, m_acc, m)
            g = tree_map(lambda g: (g / nmb).float(), g_acc)
            metrics = tree_map(lambda m: m / nmb, m_acc)
        else:
            g, metrics, aux = grads_of(params, batch, l1c)
        if mesh is not None:
            g = _dp_mean_grads(g, specs, mesh)
        return g, metrics, aux

    return grads


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    layer_stats: bool = False, mesh=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) on the trainable tree (``lm.trainable``) and a batch of
    int32 ``tokens``/``labels`` tensors. Microbatching sums the gradients
    of ``tcfg.microbatch``-row slices in ``tcfg.grad_accum_dtype`` and
    averages them and the metrics; the aux (and ``layer_stats``) come from
    the first microbatch. The FFN trains as ``dense`` or ``hybrid``; the
    inference impls have no backward.

    With ``mesh`` (a ``sharding.Mesh``) the trees are this rank's shards
    and the batch is the whole batch on every rank (see the module
    docstring); ``tcfg.microbatch`` counts global rows, as JAX's does:
    each rank takes ``microbatch / dp`` rows of each microbatch. A batch or
    microbatch that does not split evenly over the dp ranks is refused.
    The metrics are global and the same on every rank."""
    grads_fn = make_grad_fn(cfg, tcfg, mesh)
    specs = lm.train_specs(cfg, mesh) if mesh is not None else None

    def train_step(params, opt_state, batch):
        step = opt_state.step
        l1c = l1_schedule(step, cfg.sparsity.l1_coeff,
                          cfg.sparsity.l1_constant_steps,
                          cfg.sparsity.l1_warmup_steps)
        grads, metrics, aux = grads_fn(params, batch, l1c)
        grads, gnorm = adamw.clip_by_global_norm(grads, tcfg.max_grad_norm,
                                                 mesh, specs)
        lr = adamw.cosine_schedule(step, tcfg.learning_rate,
                                   tcfg.warmup_steps, tcfg.total_steps)
        params, opt_state = adamw.update(
            params, grads, opt_state, lr=lr, beta1=tcfg.beta1,
            beta2=tcfg.beta2, eps=tcfg.eps, weight_decay=tcfg.weight_decay)
        metrics = dict(metrics)
        metrics.update(grad_norm=gnorm, lr=lr, l1_coeff=l1c)
        if layer_stats:
            metrics.update(per_layer_stats(aux))
        return params, opt_state, metrics

    return train_step


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, cache, tokens) -> (logits, cache): one token a
    sequence through the monolithic cache (``lm.decode_step``)."""
    def serve_step(params, cache, tokens):
        return lm.decode_step(params, cache, tokens, cfg)
    return serve_step


def make_prefill_step(cfg: ModelConfig):
    """prefill_step(params, batch) -> logits of the training forward,
    which builds no FFN statistics (XLA drops them from JAX's)."""
    def prefill_step(params, batch):
        logits, _ = lm.forward(params, batch, cfg, collect_aux=False)
        return logits
    return prefill_step
