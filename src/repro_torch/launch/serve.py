"""Serving CLI of the PyTorch port: the continuous-batching engine over the
TwELL path, on the card unless ``--device cpu``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-0.5b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-0.5b \
      --reduced --device cpu --backend dense
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
      --reduced --device cpu
  # self-speculative decoding (tile-skip drafts, TwELL verifies) with
  # seeded stochastic sampling
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --spec-k 2 --draft-threshold 0.3 --temperature 0.8 --top-k 50

Weights are random (``lm.init``, ``--seed``) and so are the 4 prompts of
32 token ids; 16 tokens each are generated. The run shows the path working
and prints tokens/s and TTFT, and the acceptance rate when speculating.
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
from repro_torch.serving import SamplingParams, ServingEngine, SpecConfig


BATCH, PROMPT_LEN, GEN, SEED = 4, 32, 16, 0     # the JAX CLI's defaults


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain PyTorch path)")
    ap.add_argument("--backend", default="gather",
                    choices=("gather", "dense", "tile_skip"),
                    help="FFN path: gather (TwELL kernels K1+K2, or K1+K6 "
                         "for a non-gated FFN), dense, or tile_skip (kernel "
                         "K5)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 = off)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft tokens per step "
                         "(0 = off)")
    ap.add_argument("--draft-backend", default="tile_skip",
                    help="spec draft path: tile_skip | gather | dense")
    ap.add_argument("--draft-threshold", type=float, default=0.0,
                    help="tile-skip gate threshold for the draft pass "
                         "(higher = sparser/cheaper draft, lower acceptance)")
    ap.add_argument("--seed", type=int, default=SEED,
                    help="weights, prompts and the engine's sampling key")
    args = ap.parse_args(argv)

    dev = device_mod.resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if dev.type == "cuda":
        cfg = dataclasses.replace(cfg, dtype="bfloat16",
                                  param_dtype="bfloat16")
    params = lm.init(cfg, device=dev, seed=args.seed)
    rng = np.random.RandomState(args.seed)
    prompts = [rng.randint(0, cfg.vocab_size, PROMPT_LEN).tolist()
               for _ in range(BATCH)]
    spec = None
    if args.spec_k:
        spec = SpecConfig(k=args.spec_k, draft_backend=args.draft_backend,
                          draft_threshold=args.draft_threshold)
    engine = ServingEngine(params, cfg, backend=args.backend, max_batch=BATCH,
                           max_seq_len=PROMPT_LEN + GEN, seed=args.seed,
                           spec=spec, device=dev)
    # no per-request seed: each request derives its key from the engine's
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p)
    if dev.type == "cuda":     # compile the kernels before the clock starts
        print(f"[serve/torch] kernels built in {build.build_all():.1f}s")
    t0 = time.perf_counter()
    outs = engine.generate(prompts, sampling=sp, max_tokens=GEN)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total_new = sum(len(o.token_ids) for o in outs)
    ttft = [o.ttft for o in outs]
    print(f"[serve/torch] {len(outs)} requests x {GEN} tokens in "
          f"{dt:.2f}s ({total_new / dt:.1f} tok/s, backend={args.backend}, "
          f"device={dev}, ttft mean {np.mean(ttft) * 1e3:.1f}ms)")
    if spec is not None:
        drafted = sum(o.spec_drafted for o in outs)
        accepted = sum(o.spec_accepted for o in outs)
        steps = len(engine.stats)
        print(f"[serve/torch] spec k={spec.k} "
              f"draft={engine.draft_pair.describe()} "
              f"acceptance={accepted}/{drafted} "
              f"({accepted / max(drafted, 1):.1%}), "
              f"{total_new / max(steps, 1):.2f} tok/step over {steps} steps")
    print(np.asarray([o.token_ids for o in outs]))
    return outs


if __name__ == "__main__":
    main()
