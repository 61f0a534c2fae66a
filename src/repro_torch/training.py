"""Train step builder: loss + grad + clip + AdamW, with the L1 warm-up
schedule and microbatch gradient accumulation (ports
``repro/training.py:17-87``)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import device as device_mod
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.core.sparsity import l1_schedule
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


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    layer_stats: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) on the trainable tree (``lm.trainable``) and a batch of
    int32 ``tokens``/``labels`` tensors. Microbatching sums the gradients
    of ``tcfg.microbatch``-row slices in ``tcfg.grad_accum_dtype`` and
    averages them and the metrics; the aux (and ``layer_stats``) come from
    the first microbatch. The FFN trains as ``dense`` or ``hybrid``; the
    inference impls have no backward."""
    impl = cfg.sparsity.ffn_impl if cfg.sparsity.enabled else "dense"
    if impl not in TRAINABLE_IMPLS:
        raise NotImplementedError(
            f"training runs ffn_impl {TRAINABLE_IMPLS}, not {impl!r}")

    def grads_of(params, batch, l1c):
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(True),
                            params)
            loss, (metrics, aux) = lm.loss_fn(live, batch, cfg, l1c)
            grads = torch.autograd.grad(loss, leaves(live))
        detach = lambda t: t.detach()  # noqa: E731
        return (unflatten(params, list(grads)), tree_map(detach, metrics),
                tree_map(detach, aux))

    def train_step(params, opt_state, batch):
        step = opt_state.step
        l1c = l1_schedule(step, cfg.sparsity.l1_coeff,
                          cfg.sparsity.l1_constant_steps,
                          cfg.sparsity.l1_warmup_steps)
        rows = batch["tokens"].shape[0]
        if tcfg.microbatch and tcfg.microbatch < rows:
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
            grads = tree_map(lambda g: (g / nmb).float(), g_acc)
            metrics = tree_map(lambda m: m / nmb, m_acc)
        else:
            grads, metrics, aux = grads_of(params, batch, l1c)

        grads, gnorm = adamw.clip_by_global_norm(grads, tcfg.max_grad_norm)
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
