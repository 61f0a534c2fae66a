"""What each rank of ``tests/test_torch_mesh_train.py`` runs: the port's
train step on a training mesh of gloo ranks, ``moe_apply_sorted`` on a
(data 2, model 4) mesh, ``compressed_psum`` over ``pod``, and a
checkpoint saved on one mesh and restored onto another. A module of its
own, without JAX, because spawned ranks import the function they run by
its module's name. Every result is numpy, gathered whole."""
import dataclasses
import os

import torch

from repro_torch import bridge, training
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.distributed import collectives, sharding
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm, moe
from repro_torch.optim import adamw, compress
from repro_torch.tree import tree_map

STEPS = 4


def train_config(impl: str):
    """``tests/test_distributed.py:46-47``'s config with the FFN as
    ``impl``."""
    cfg = get_config("paper-0.5b").reduced(d_model=64, d_ff=128,
                                           num_layers=2, num_heads=4,
                                           head_dim=16)
    return dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, ffn_impl=impl))


def train_tcfg(microbatch: int = 0) -> TrainConfig:
    """Peak learning rate from the first step, so that it moves the
    parameters."""
    return TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10,
                       microbatch=microbatch)


def moe_config(experts: int, capacity: float):
    """``tests/test_distributed.py:78-80``'s MoE config."""
    cfg = get_config("mixtral-8x22b").reduced(d_model=32, d_ff=64,
                                              num_experts=experts, top_k=2)
    return dataclasses.replace(cfg, capacity_factor=capacity)


MOE_CASES = [(e, cap, manual) for e in (4, 3) for cap in (8.0, 1.25)
             for manual in (False, True)]


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else t


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


def mesh_train(mesh, cfg, tcfg, params_np, opt_np, batch_np, steps=STEPS):
    """The step's gradients (gathered, before the clip), its metrics and
    the parameters after it (gathered), then ``steps`` - 1 more steps'
    losses."""
    specs = lm.train_specs(cfg, mesh)
    ops.HybridOverflowLog.reset()
    params, opt = bridge.shard_train_state(params_np, opt_np, cfg, mesh)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    grads, _, _ = training.make_grad_fn(cfg, tcfg, mesh)(
        params, batch, cfg.sparsity.l1_coeff)
    step = training.make_train_step(cfg, tcfg, mesh=mesh)
    p1, o1, m = step(params, opt, batch)
    out = {"grads": bridge.to_numpy(bridge.gather_tree(grads, specs, mesh)),
           "metrics": _metrics(m),
           "params": bridge.to_numpy(bridge.gather_tree(p1, specs, mesh)),
           "losses": [float(m["loss"])]}
    for _ in range(steps - 1):
        p1, o1, m = step(p1, o1, batch)
        out["losses"].append(float(m["loss"]))
    out["overflow"] = ops.HybridOverflowLog.seen()
    out["backup_rows"] = ops.HybridOverflowLog.rows()[1]
    return out, (p1, o1)


def sorted_moe(mesh, cases, inputs):
    """``moe_apply_sorted`` on ``mesh`` for each (experts, capacity,
    switch) case on its (params, x) (numpy, whole): y gathered, the
    aux."""
    out = {}
    specs_dp = mesh.axis("data")
    for (e, cap, manual), (p_np, x_np) in zip(cases, inputs):
        cfg = moe_config(e, cap)
        full = {"router": torch.from_numpy(p_np["router"]),
                "experts": {k: torch.from_numpy(v)
                            for k, v in p_np["experts"].items()}}
        specs = {n: sharding.param_spec(f"experts/{n}", tuple(w.shape), cfg,
                                        mesh)
                 for n, w in full["experts"].items()}
        experts = {}
        for n, w in full["experts"].items():
            spec = specs[n] if manual else tuple(
                a if a == "model" else None for a in specs[n])
            experts[n] = sharding.shard_tensor(w, spec, mesh)
        x = torch.from_numpy(x_np)
        xs = sharding.shard_tensor(x, ("data", None, None), mesh)
        os.environ["REPRO_MOE_MANUAL_GATHER"] = "1" if manual else "0"
        y, aux = moe.moe_apply_sorted(
            {"router": full["router"], "experts": experts}, xs, cfg,
            cfg.sparsity, True, mesh, ("data",))
        os.environ.pop("REPRO_MOE_MANUAL_GATHER")
        y = collectives.all_gather_dim(y.contiguous(), specs_dp, 0)
        out[(e, cap, manual)] = {"y": _np(y),
                                 "aux": {k: _np(v) for k, v in aux.items()}}
    return out


def compression(mesh, g_np, per_pod_np):
    """``compressed_psum`` over ``pod``: the replicated gradient with zero
    errors (int8), then each pod's own gradient and error (int8, topk)."""
    pod = mesh.get_local_rank("pod")
    g = {k: torch.from_numpy(v) for k, v in g_np.items()}
    red, err = compress.compressed_psum(g, compress.init_error_state(g),
                                        mesh, axis="pod", method="int8")
    out = {"replicated": (tree_map(_np, red), tree_map(_np, err))}
    gp = {k: torch.from_numpy(v[0][pod]) for k, v in per_pod_np.items()}
    ep = {k: torch.from_numpy(v[1][pod]) for k, v in per_pod_np.items()}
    for method in ("int8", "topk"):
        red, err = compress.compressed_psum(gp, ep, mesh, method=method,
                                            topk_frac=0.1)
        out[method] = (tree_map(_np, red), tree_map(_np, err))
    return out


def rank_8(rank, dev, state, moe_state, moe_cases, moe_inputs, g, per_pod):
    """The 8-rank session: the train step on (pod 2, data 2, model 2),
    dense and hybrid, and the reduced mixtral's; the sorted MoE on (data
    2, model 4); compression."""
    mesh = mesh_mod.make_debug_mesh((2, 2, 2), ("pod", "data", "model"))
    out = {"train": {}, **mesh.coords}
    for impl in ("dense", "hybrid"):
        out["train"][impl] = mesh_train(mesh, train_config(impl),
                                        train_tcfg(), *state)[0]
    out["moe_train"] = mesh_train(mesh, get_config("mixtral-8x22b").reduced(),
                                  train_tcfg(), *moe_state, steps=2)[0]
    moe_mesh = mesh_mod.make_debug_mesh((2, 4), ("data", "model"))
    out["moe"] = sorted_moe(moe_mesh, moe_cases, moe_inputs)
    out["compress"] = compression(mesh, g, per_pod)
    return out


def switch_grads(mesh, moe_state):
    """The reduced mixtral's gradients (gathered) on ``mesh`` with
    ``REPRO_MOE_MANUAL_GATHER`` off, then on (the layer loop then leaves
    the experts data-sharded and the dispatch gathers them)."""
    cfg = get_config("mixtral-8x22b").reduced()
    specs = lm.train_specs(cfg, mesh)
    params, _ = bridge.shard_train_state(moe_state[0], moe_state[1], cfg,
                                         mesh)
    batch = {k: torch.from_numpy(v) for k, v in moe_state[2].items()}
    out = []
    for flag in ("0", "1"):
        os.environ["REPRO_MOE_MANUAL_GATHER"] = flag
        grads, _, _ = training.make_grad_fn(cfg, train_tcfg(), mesh)(
            params, batch, cfg.sparsity.l1_coeff)
        out.append(bridge.to_numpy(bridge.gather_tree(grads, specs, mesh)))
    os.environ.pop("REPRO_MOE_MANUAL_GATHER")
    return out


def tiny_config():
    """A dense config whose every stacked leaf's largest dim is the layer
    dim (4 layers of width 4): FSDP on ``data`` splits the layer stack,
    so each layer comes from the rank that holds it
    (``collectives.from_owner``)."""
    return get_config("paper-0.5b").reduced(d_model=4, num_heads=1,
                                            num_kv_heads=1, head_dim=4,
                                            d_ff=8, num_layers=4)


def grads_on(mesh, cfg, params_np, opt_np, batch_np, tcfg=None):
    """``cfg``'s gradients (gathered) on ``mesh``."""
    params, _ = bridge.shard_train_state(params_np, opt_np, cfg, mesh)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    grads, _, _ = training.make_grad_fn(cfg, tcfg or train_tcfg(), mesh)(
        params, batch, cfg.sparsity.l1_coeff)
    return bridge.to_numpy(bridge.gather_tree(
        grads, lm.train_specs(cfg, mesh), mesh))


def rank_4(rank, dev, params, opt, batch, moe_state, tiny_state, ckpt_dir):
    """The 4-rank session: the train step on (data 2, model 2) with
    microbatch 4, dense and hybrid; the MoE switch's gradients; the dense
    gradients under remat full;
    the tiny config's layer-dim FSDP; a batch the dp ranks do not split;
    the dense run's state saved there, then restored onto (model 4),
    where the reduced mixtral also takes the one-hot dispatch."""
    mesh = mesh_mod.make_debug_mesh((2, 2), ("data", "model"))
    out = {"train": {}, "switch": switch_grads(mesh, moe_state),
           "remat_full": grads_on(mesh, dataclasses.replace(
               train_config("dense"), remat="full"), params, opt, batch,
               train_tcfg(4)),
           "tiny": grads_on(mesh, tiny_config(), *tiny_state)}
    odd = {k: torch.from_numpy(v[:3]) for k, v in batch.items()}
    try:
        training.make_train_step(train_config("dense"), train_tcfg(),
                                 mesh=mesh)(*bridge.shard_train_state(
                                     params, opt, train_config("dense"),
                                     mesh), odd)
    except ValueError as e:
        out["refused"] = str(e)
    for impl in ("dense", "hybrid"):
        res, state = mesh_train(mesh, train_config(impl), train_tcfg(4),
                                params, opt, batch)
        out["train"][impl] = res
        if impl == "dense":
            saved = state
    cfg = train_config("dense")
    specs = lm.train_specs(cfg, mesh)
    state_specs = (specs, adamw.AdamWState((), specs, specs))
    mgr = CheckpointManager(ckpt_dir, async_save=False)
    mgr.save(STEPS, saved, extra={"steps": STEPS}, mesh=mesh,
             specs=state_specs)
    torch.distributed.barrier()
    wide = mesh_mod.make_debug_mesh((4,), ("model",))
    wspecs = lm.train_specs(cfg, wide)
    wstate = (wspecs, adamw.AdamWState((), wspecs, wspecs))
    like = tree_map(torch.zeros_like, bridge.shard_train_state(
        *_whole(saved, state_specs, mesh), cfg, wide))
    _, got, extra = mgr.restore_latest(like, wide, wstate)
    out["restored_model4"] = _whole(got, wstate, wide)
    out["moe_model4"] = grads_on(wide, get_config("mixtral-8x22b").reduced(),
                                 *moe_state)
    out["saved"] = _whole(saved, state_specs, mesh)
    out["extra"] = extra
    return out


def _whole(state, specs, mesh):
    """(params, AdamWState) of shards -> numpy (params, (step, m, v))."""
    params, opt = bridge.gather_tree(state, specs, mesh)
    return bridge.to_numpy(params), bridge.opt_state_to_numpy(opt)
