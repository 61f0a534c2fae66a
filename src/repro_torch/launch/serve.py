"""Serving CLI of the PyTorch port: the continuous-batching engine over the
TwELL path, on the card unless ``--device cpu``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-0.5b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-0.5b \
      --reduced --device cpu --backend dense

Weights are random (``lm.init``, seed 0) and so are the 4 prompts of 32
token ids; 16 tokens each are generated. The run shows the path working
and prints tokens/s and TTFT.
On the card the model runs in bfloat16 (the kernels' type), also with
``--reduced``, whose config is float32.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.models import lm
from repro_torch.serving import ServingEngine


BATCH, PROMPT_LEN, GEN, SEED = 4, 32, 16, 0     # the JAX CLI's defaults


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain PyTorch path)")
    ap.add_argument("--backend", default="gather", choices=("gather", "dense"),
                    help="FFN path: gather (TwELL kernels) or dense")
    args = ap.parse_args(argv)

    dev = device_mod.resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if dev.type == "cuda":
        cfg = dataclasses.replace(cfg, dtype="bfloat16",
                                  param_dtype="bfloat16")
    params = lm.init(cfg, device=dev, seed=SEED)
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, cfg.vocab_size, PROMPT_LEN).tolist()
               for _ in range(BATCH)]
    engine = ServingEngine(params, cfg, backend=args.backend, max_batch=BATCH,
                           max_seq_len=PROMPT_LEN + GEN, device=dev)
    if dev.type == "cuda":     # compile the kernels before the clock starts
        print(f"[serve/torch] kernels built in {build.build_all():.1f}s")
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_tokens=GEN)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total_new = sum(len(o.token_ids) for o in outs)
    ttft = [o.ttft for o in outs]
    print(f"[serve/torch] {len(outs)} requests x {GEN} tokens in "
          f"{dt:.2f}s ({total_new / dt:.1f} tok/s, backend={args.backend}, "
          f"device={dev}, ttft mean {np.mean(ttft) * 1e3:.1f}ms)")
    print(np.asarray([o.token_ids for o in outs]))
    return outs


if __name__ == "__main__":
    main()
