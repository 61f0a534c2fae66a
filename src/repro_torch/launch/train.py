"""Training launcher of the port, with fault tolerance (ports
``repro/launch/train.py``).

- auto-resume from the latest checkpoint in ``--ckpt-dir`` (params,
  optimizer, data-iterator state), in the JAX package's checkpoint layout:
  a directory the JAX trainer wrote resumes here;
- SIGTERM/SIGINT -> a final synchronous checkpoint and a clean exit;
- rotating async checkpoints every ``--ckpt-every`` steps;
- a step-time watchdog that warns when a step exceeds ``--watchdog-factor``
  times the trailing median;
- the paper's recipe: L1 schedule and per-layer sparsity stats; the hybrid
  FFN (``--ffn-impl hybrid``) trains through kernels K8/K9 and attention
  through K7 on the card.

Not ported yet: ``--dead-reinit`` (the JAX trainer draws its noise with
``jax.random.normal``) and ``--run-log`` (``repro/observability``).

Usage (the card by default; ``--device cpu`` runs the plain versions):
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-0.5b \\
      --ffn-impl hybrid --steps 5 --batch 8 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-0.5b \\
      --reduced --device cpu
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
from repro_torch import training
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM, make_iterator
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.optim import adamw


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
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--watchdog-factor", type=float, default=3.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--halt-at", type=int, default=0,
                    help="simulate preemption: checkpoint+exit at this step "
                         "while keeping the --steps LR schedule")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)

    cfg = get_config(args.arch)
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

    mgr = CheckpointManager(args.ckpt_dir, keep=tcfg.keep_checkpoints)
    start_step = 0
    resumed = mgr.restore_latest((params, opt_state, ever_active))
    if resumed is not None:
        start_step, (params, opt_state, ever_active), extra = resumed
        data = make_iterator(extra["data"])
        print(f"[train] resumed from step {start_step}", flush=True)

    step_fn = training.make_train_step(cfg, tcfg)

    stop = {"flag": False}

    def _sig(_s, _f):
        stop["flag"] = True
    old = {s: signal.signal(s, _sig) for s in (signal.SIGTERM, signal.SIGINT)}

    times = []
    history = []
    step = start_step - 1
    ops.HybridOverflowLog.reset()
    try:
        for step in range(start_step, args.steps):
            t0 = time.time()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in next(data).items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            times.append(dt)
            if len(times) > 20:
                times.pop(0)
            med = statistics.median(times)
            if dt > args.watchdog_factor * med and len(times) > 5:
                print(f"[watchdog] step {step} took {dt:.2f}s (median "
                      f"{med:.2f}s) — straggler suspected", file=sys.stderr)
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
                print(f"[train] SIGTERM: checkpointed at step {step + 1}, "
                      "exiting", flush=True)
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
        print(f"[train] done; final loss {history[-1]['loss']:.4f}",
              flush=True)
    return history


if __name__ == "__main__":
    main()
