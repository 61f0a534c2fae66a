"""Training launcher of the port, with fault tolerance (ports
``repro/launch/train.py``).

- auto-resume from the latest checkpoint in ``--ckpt-dir`` (params,
  optimizer, data-iterator state), in the JAX package's checkpoint layout:
  a directory the JAX trainer wrote resumes here;
- SIGTERM/SIGINT -> a final synchronous checkpoint and a clean exit;
- rotating async checkpoints every ``--ckpt-every`` steps;
- a step-time watchdog that warns when a step exceeds ``--watchdog-factor``
  times the trailing median;
- the paper's recipe: L1 schedule, per-layer sparsity stats, and with
  ``--dead-reinit`` targeted reinitialization (Eq. 6) of the gate columns
  that never fired in the step, after every step, with the JAX trainer's
  threefry keys (``repro_torch/random.py``); the hybrid FFN (``--ffn-impl
  hybrid``) trains through kernels K8/K9 and attention through K7 on the
  card;
- ``--run-log``: structured JSONL (meta, step and event records with the
  JAX trainer's fields, per-layer nnz and the FLOPs/MFU accounting of
  ``repro_torch/observability`` against the H100's peak);
- the cross-attention families (whisper-large-v3, llama-3.2-vision-11b)
  are refused up front: their forward reads ``frames`` / ``patches``,
  which the synthetic data does not make (the JAX trainer fails on the
  missing key); ``training.make_train_step`` trains them on batches that
  carry them;
- a full-size config recomputes each layer in the backward
  (``cfg.remat``, ``full`` by default), ``--reduced`` keeps every
  activation (``remat="none"``), as the JAX trainer does.

Usage (the card by default; ``--device cpu`` runs the plain versions):
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-0.5b \\
      --ffn-impl hybrid --steps 5 --batch 8 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-0.5b \\
      --reduced --device cpu --dead-reinit --run-log /tmp/run.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import statistics
import sys
import tempfile
import time

import torch

from repro_torch import device as device_mod
from repro_torch import random as prng
from repro_torch import training
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.core.sparsity import targeted_reinit
from repro_torch.data.pipeline import SyntheticLM, make_iterator
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.observability import RunLogger, SparsityReport, param_count
from repro_torch.optim import adamw

# the batch entry each cross-attention family's forward reads besides the
# tokens (``lm.forward``)
BATCH_EXTRAS = {"audio": "frames", "vlm": "patches"}


def _dead_reinit(params, batch, cfg, rkey):
    """Eq. 6 after a step: the new params' loss_fn on the same batch gives
    each layer's ``neuron_active``; every layer's W_g has its dead columns
    reinitialized with a key split from ``rkey``. Returns the next rkey. A
    non-gated config has no W_g: nothing changes."""
    with torch.no_grad():
        _, (_, aux) = lm.loss_fn(params, batch, cfg)
    rkey, sub = prng.split(rkey)
    ffn = params["blocks"]["ffn"]
    wg = ffn.get("wg")
    if wg is not None:
        dead = ~aux["neuron_active"]
        keys = prng.split(sub, wg.shape[0])
        ffn["wg"] = torch.stack([targeted_reinit(k, w, d)
                                 for k, w, d in zip(keys, wg, dead)])
    return rkey


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-0.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--l1", type=float, default=None)
    ap.add_argument("--ffn-impl", default=None, choices=("dense", "hybrid"))
    ap.add_argument("--dead-reinit", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--watchdog-factor", type=float, default=3.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--run-log", default=None,
                    help="append structured JSONL (meta/step/event records, "
                         "incl. per-layer nnz and FLOPs/MFU accounting) here")
    ap.add_argument("--halt-at", type=int, default=0,
                    help="simulate preemption: checkpoint+exit at this step "
                         "while keeping the --steps LR schedule")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)

    cfg = get_config(args.arch)
    if cfg.family in BATCH_EXTRAS:
        # SyntheticLM makes tokens and labels only; the JAX trainer fails
        # on the missing key at its first step
        raise SystemExit(
            f"{args.arch} ({cfg.family}) trains on batches with "
            f"{BATCH_EXTRAS[cfg.family]!r}, which this trainer's "
            f"SyntheticLM data does not make")
    if args.reduced:
        cfg = cfg.reduced(d_model=args.width, d_ff=args.width * 4,
                          num_layers=args.layers)
    sp = cfg.sparsity
    if args.l1 is not None:
        sp = dataclasses.replace(sp, l1_coeff=args.l1)
    if args.ffn_impl:
        sp = dataclasses.replace(sp, ffn_impl=args.ffn_impl)
    cfg = dataclasses.replace(cfg, sparsity=sp,
                              remat="none" if args.reduced else cfg.remat)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=min(50, args.steps // 10 + 1),
                       checkpoint_every=args.ckpt_every,
                       checkpoint_dir=args.ckpt_dir)

    params = lm.trainable(lm.init(cfg, device=dev, seed=tcfg.seed))
    opt_state = adamw.init(params, device_mod.torch_dtype(cfg.opt_state_dtype))
    data = SyntheticLM(cfg.vocab_size, args.batch, args.seq, seed=tcfg.seed)
    # kept for the JAX checkpoint layout (params, opt_state, ever_active)
    ever_active = torch.zeros((max(cfg.num_layers, 1), cfg.d_ff),
                              dtype=torch.bool, device=dev)

    n_params = param_count(params)
    tokens_per_step = args.batch * args.seq
    runlog = None
    if args.run_log:
        runlog = RunLogger(args.run_log, console=True, meta={
            "arch": cfg.name, "reduced": args.reduced,
            "d_model": cfg.d_model, "d_ff": cfg.d_ff,
            "num_layers": cfg.num_layers, "ffn_impl": cfg.sparsity.ffn_impl,
            "l1_coeff": cfg.sparsity.l1_coeff, "steps": args.steps,
            "batch": args.batch, "seq": args.seq, "n_params": n_params,
            "torch_version": torch.__version__})

    def _event(event, message, **fields):
        # events flow through the run log when enabled (which echoes the
        # console line itself); bare print otherwise
        if runlog is not None:
            runlog.event(event, message=message, **fields)
        else:
            print(f"[train] {message}", flush=True)

    mgr = CheckpointManager(args.ckpt_dir, keep=tcfg.keep_checkpoints)
    start_step = 0
    resumed = mgr.restore_latest((params, opt_state, ever_active))
    if resumed is not None:
        start_step, (params, opt_state, ever_active), extra = resumed
        data = make_iterator(extra["data"])
        _event("resume", f"resumed from step {start_step}", step=start_step)

    step_fn = training.make_train_step(cfg, tcfg,
                                       layer_stats=runlog is not None)

    stop = {"flag": False}

    def _sig(_s, _f):
        stop["flag"] = True
    old = {s: signal.signal(s, _sig) for s in (signal.SIGTERM, signal.SIGINT)}

    times = []
    history = []
    step = start_step - 1
    rkey = prng.PRNGKey(1234, device=dev)
    ops.HybridOverflowLog.reset()
    try:
        for step in range(start_step, args.steps):
            t0 = time.time()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in next(data).items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            # layer_stats adds (L,)-shaped trajectories; keep the returned
            # history scalar-only
            arrays = {k: v.cpu().numpy() for k, v in metrics.items()
                      if v.ndim}
            metrics = {k: float(v) for k, v in metrics.items() if not v.ndim}
            if args.dead_reinit and cfg.family == "dense":
                rkey = _dead_reinit(params, batch, cfg, rkey)
            dt = time.time() - t0
            times.append(dt)
            if len(times) > 20:
                times.pop(0)
            med = statistics.median(times)
            if dt > args.watchdog_factor * med and len(times) > 5:
                msg = (f"step {step} took {dt:.2f}s "
                       f"(median {med:.2f}s) — straggler suspected")
                print(f"[watchdog] {msg}", file=sys.stderr)
                if runlog is not None:
                    runlog.event("watchdog", step=step, step_time_s=dt,
                                 median_s=med, factor=args.watchdog_factor,
                                 detail=msg)
            if runlog is not None:
                report = SparsityReport.build(
                    cfg, tokens_per_step, arrays["nnz_per_layer"],
                    tile_frac_per_layer=arrays["tile_frac_per_layer"],
                    dead_frac_per_layer=arrays["dead_frac_per_layer"],
                    ffn_present=arrays["ffn_present_per_layer"],
                    n_params=n_params, train=True)
                runlog.step(
                    step, loss=metrics["loss"], ce=metrics["ce"],
                    l1=metrics["l1"], l1_coeff=metrics["l1_coeff"],
                    nnz_mean=metrics["nnz_mean"],
                    nnz_per_layer=arrays["nnz_per_layer"],
                    dead_frac_per_layer=arrays["dead_frac_per_layer"],
                    tile_frac_per_layer=arrays["tile_frac_per_layer"],
                    mean_sparsity=report.mean_sparsity,
                    ffn_effective_flops=report.ffn_effective_flops,
                    ffn_dense_flops=report.ffn_dense_flops,
                    model_effective_flops=report.model_effective_flops,
                    model_dense_flops=report.model_dense_flops,
                    flops_reduction=report.flops_reduction(),
                    step_time_s=dt,
                    tokens_per_s=tokens_per_step / max(dt, 1e-9),
                    mfu=report.mfu_estimate(dt))
            history.append({"step": step, **metrics})
            if step % args.log_every == 0:
                print(f"step {step:5d} loss {metrics['loss']:.4f} "
                      f"ce {metrics['ce']:.4f} nnz {metrics['nnz_mean']:.1f} "
                      f"l1 {metrics['l1']:.5f} {dt*1000:.0f}ms", flush=True)
                if ops.HybridOverflowLog.seen():
                    print("[train] hybrid backup overflowed: rows past the "
                          "dense backup were dropped (App. B.2.1)",
                          file=sys.stderr)
                    ops.HybridOverflowLog.reset()
            if args.halt_at and step + 1 >= args.halt_at:
                stop["flag"] = True
            if (step + 1) % tcfg.checkpoint_every == 0 or stop["flag"]:
                mgr.save(step + 1, (params, opt_state, ever_active),
                         extra={"data": data.state(), "arch": cfg.name})
            if stop["flag"]:
                _event("sigterm",
                       f"SIGTERM: checkpointed at step {step + 1}, exiting",
                       step=step + 1)
                break
        mgr.save(args.steps if not stop["flag"] else step + 1,
                 (params, opt_state, ever_active),
                 extra={"data": data.state(), "arch": cfg.name})
        mgr.wait()
    finally:
        for s, h in old.items():
            signal.signal(s, h)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f)
    if history:
        _event("done", f"done; final loss {history[-1]['loss']:.4f}",
               step=history[-1]["step"], loss=history[-1]["loss"])
    if runlog is not None:
        runlog.close()
    return history


if __name__ == "__main__":
    main()
