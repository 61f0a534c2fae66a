"""Serving CLI of the PyTorch port: the continuous-batching engine over the
TwELL path, on the card unless ``--device cpu``; also the HTTP server and
the static reference loop (``generate``) the engine is checked against.

Ports ``repro/launch/serve.py`` with every flag but the JAX package's
``--attn-backend`` (the port reads the paged KV through one path a
device: the CUDA kernels on the card, their plain versions on the CPU).
``--backend`` (alias ``--ffn-impl``) picks the FFN path;
``--torch-profile DIR`` stands for ``--jax-profile``; ``--device`` is the
port's own. ``--tp N`` serves on N ranks, one spawned process a rank
(NCCL, one card a rank; gloo with one torch thread a rank on the CPU),
each holding its shard of the weights and KV pools; rank 0 prints.
``--mesh`` runs the sharded path at ``--tp 1`` in this process.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-0.5b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-0.5b \\
      --reduced --device cpu --backend dense --batch 4 --prompt-len 32 \\
      --gen 16
  # self-speculative decoding (tile-skip drafts, TwELL verifies) with
  # seeded stochastic sampling
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --spec-k 2 --draft-threshold 0.3 --temperature 0.8 --top-k 50
  # the pipelined step (plan/launch/collect), every program made up front,
  # a Chrome trace of the run and the engine held against the static loop
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --pipeline --warmup --trace-out /tmp/serve.trace.json --check-static
  # the OpenAI-style HTTP server (pipelined, warmed, /metrics on); the
  # chosen port is printed; SIGINT shuts it down cleanly
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --http --port 0
  # disaggregated serving: a prefill engine and a decode engine, each with
  # its own KV pool, behind one DisaggCoordinator (synchronous engines)
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --disagg --transfer-ttl 64 --check-static
  # tensor-parallel serving: two gloo ranks on the CPU (the tokens equal
  # --tp 1's); on the card one rank a card, and --mesh runs the sharded
  # path on one card
  # (the reduced FFN is one TwELL tile, which a rank holds whole: gather
  # and tile-skip drafts refuse it at tp 2, so this runs dense)
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --tp 2 --backend dense --spec-k 2 --draft-backend dense
  PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-0.5b --mesh
  # the MoE configs: a sliding window (mixtral) or local chunks (llama4)
  # route to the static loop, as in the JAX package
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \\
      --reduced --device cpu --prompt-len 24 --gen 16
  # the attention-free families (rwkv6-7b: ssm; zamba2-1.2b: hybrid) and
  # the cross-attention ones (whisper-large-v3: audio, with an empty
  # encoder cache; llama-3.2-vision-11b: vlm, zero image slots, as the JAX
  # CLI serves them) go to the static loop too; --http and --disagg
  # refuse them
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch whisper-large-v3 --reduced --device cpu

Weights are random (``lm.init``, ``--seed``) and so are the ``--batch``
prompts of ``--prompt-len`` token ids (numpy, ``--seed``). The batch run
prints tokens/s and TTFT, the acceptance rate when speculating, the phase
means with telemetry on, and with ``--warmup`` the programs made (one CUDA
graph per step entry and bucket key on the card). A greedy run with
``--check-static`` (default with ``--reduced``) runs the static loop on
the same prompts and asserts the engine's tokens: equal on the CPU, as the
JAX CLI asserts; on the card (bf16, the engine's K3/K4 attention against
the loop's plain attention) equal up to each row's first position where
the static loop's top-2 logit margin is at most ``LOGIT_TOL``.
On the card the model runs in bfloat16 (the kernels' type), also with
``--reduced``, whose config is float32.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import random as trandom
from repro_torch.configs import get_config
from repro_torch.kernels import build, ops
from repro_torch.models import lm
from repro_torch.serving import sampling as sampling_mod

LOGIT_TOL = 0.1          # the card's near-tie margin (chip_smoke.py's too)


def generate(params, cfg, prompt: torch.Tensor, steps: int, cache_len: int,
             greedy: bool = True, key: Optional[torch.Tensor] = None,
             top_k: int = 0, temperature: float = 1.0,
             logits_out: Optional[List[torch.Tensor]] = None,
             extras: Optional[Dict[str, torch.Tensor]] = None,
             cache: Optional[Dict] = None) -> torch.Tensor:
    """Static reference loop: prompt (B, P) int -> tokens (B, P+steps).

    Fixed-shape batch, monolithic cache (``lm.init_cache`` /
    ``lm.decode_step``), prefill by teacher-forcing the prompt through
    decode. The trusted baseline the continuous-batching engine must
    reproduce token for token (greedy). Stochastic sampling threads ``key``
    through the loop as JAX's ``generate`` does: each step ``key, sub =
    split(key)``, then ``categorical(sub, logits / temperature)`` over the
    top-k, bit for bit ``jax.random``'s draws (threefry, Gumbel over
    ``uniform(minval=tiny)``). ``logits_out``, if given, receives each
    sampled step's float32 (B, V) logits.

    The cross-attention families' caches are sized as JAX's ``generate``
    sizes them: ``extras["frames"]`` (B, S_a, D) gives the encoder cache's
    length (0 without it), the image cache has ``cfg.num_image_tokens``
    slots; both stay zero. ``extras`` is kept for the signature of JAX's
    ``generate``; no caller in the port passes it (the CLI passes none, as
    JAX's does). ``cache``, if given, is the cache to start from instead:
    ``lm.init_cache`` filled by ``lm.prefill_cross_cache``, the way to
    serve real frames or patches through this loop."""
    b, p = prompt.shape
    if cache is None:
        enc_len = extras["frames"].shape[1] \
            if extras and "frames" in extras else 0
        cache = lm.init_cache(cfg, b, cache_len, device=prompt.device,
                              enc_len=enc_len,
                              num_patches=cfg.num_image_tokens)
    if key is None:
        key = trandom.PRNGKey(0, device=prompt.device)
    with torch.no_grad():
        logits = None
        for i in range(p):
            logits, cache = lm.decode_step(params, cache, prompt[:, i:i + 1],
                                           cfg)
        out = [prompt]
        for _ in range(steps):
            if logits_out is not None:
                logits_out.append(logits[:, -1].float())
            if greedy:
                nxt = torch.argmax(logits[:, -1:], dim=-1)
            else:
                key, sub = trandom.split(key)
                lg = logits[:, -1].float() / max(temperature, 1e-6)
                if top_k:
                    tk = min(top_k, lg.shape[-1])   # top_k > vocab = no-op
                    kth = torch.sort(lg, dim=-1, descending=True
                                     ).values[:, tk - 1, None]
                    lg = torch.where(lg >= kth, lg,
                                     torch.full((), float("-inf"),
                                                device=lg.device))
                nxt = torch.argmax(sampling_mod.gumbel(sub, lg.shape) + lg,
                                   dim=-1)[:, None]
            nxt = nxt.to(prompt.dtype)
            out.append(nxt)
            logits, cache = lm.decode_step(params, cache, nxt, cfg)
    return torch.cat(out, dim=1)


def uses_engine(cfg, static: bool = False) -> bool:
    """The serve CLI's route, as the JAX package's: the continuous-batching
    engine for the dense and MoE families without a sliding window or a
    local chunk (its paged pools hold neither), the static loop
    (``generate``) for everything else and with ``--static``."""
    return cfg.family in ("dense", "moe") and not cfg.window \
        and not cfg.attn_chunk and not static


def first_near_ties(logits: List[torch.Tensor], tol: float = LOGIT_TOL
                    ) -> List[int]:
    """Each row's first step whose logits' top-2 margin is at most ``tol``
    (the number of steps if none): past it, bf16 rounding that differs
    between two computations may pick either token."""
    steps = len(logits)
    if not steps:
        return []
    top2 = torch.stack([torch.topk(lg, 2, dim=-1).values
                        for lg in logits], dim=1).cpu()     # (B, steps, 2)
    # the margin's float32 value against tol as a double, as chip_smoke.py
    tie = (top2[..., 0] - top2[..., 1]).double() <= tol
    return [int(row.nonzero()[0]) if bool(row.any()) else steps
            for row in tie]


def main(argv=None, rank: Optional[int] = None):
    """The CLI. ``rank``: this process is that rank of a ``--tp`` world
    (``_serve_rank``, in a process ``ranks.spawn`` started)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain PyTorch path)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--backend", "--ffn-impl", dest="backend",
                    default="gather",
                    choices=("gather", "dense", "tile_skip"),
                    help="FFN path: gather (TwELL kernels K1+K2, or K1+K6 "
                         "for a non-gated FFN), dense, or tile_skip (kernel "
                         "K5)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged KV-cache block size (tokens)")
    ap.add_argument("--prefill-chunk", type=int, default=64,
                    help="max prompt tokens prefilled per engine step "
                         "(long prompts interleave with decode)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable shared-prefix KV reuse")
    ap.add_argument("--max-batch", type=int, default=0,
                    help="engine decode-batch cap (0 = --batch)")
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
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: shard params + paged KV "
                         "pools over a 1-D mesh of --tp ranks, one process "
                         "a rank (1 = unsharded; NCCL, one card a rank; "
                         "gloo ranks with --device cpu)")
    ap.add_argument("--mesh", action="store_true",
                    help="run the mesh-sharded engine path even at --tp 1 "
                         "(exercises the sharded code path on one device)")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated serving: a prefill engine and a "
                         "decode engine with separate KV pools in one "
                         "process, bridged by a KV-block transfer buffer "
                         "(requests migrate after prefill and decode "
                         "without prefill interference)")
    ap.add_argument("--transfer-ttl", type=int, default=64,
                    help="--disagg: steps an unclaimed KV transfer survives "
                         "before it expires and the request re-queues")
    ap.add_argument("--scheduler", default="fcfs",
                    help="admission policy: fcfs | priority (priority "
                         "preempts lower-priority running requests under "
                         "pool pressure; they resume via the prefix cache)")
    ap.add_argument("--http", action="store_true",
                    help="serve an OpenAI-style HTTP API "
                         "(/v1/completions with SSE streaming; client "
                         "disconnect cancels the request) instead of "
                         "running the one-shot batch demo")
    ap.add_argument("--metrics", dest="metrics", action="store_true",
                    default=None,
                    help="enable the telemetry subsystem (metrics registry "
                         "+ request tracing); default: on with --http "
                         "(serving GET /metrics), off for the batch demo")
    ap.add_argument("--no-metrics", dest="metrics", action="store_false",
                    help="disable telemetry even with --http "
                         "(GET /metrics then returns 503)")
    ap.add_argument("--pipeline", dest="pipeline", action="store_true",
                    default=None,
                    help="overlapped plan/launch/collect step pipeline: "
                         "host scheduling for step N+1 runs while the card "
                         "executes step N (token-identical to the "
                         "synchronous step); default: on with --http, off "
                         "for the batch demo")
    ap.add_argument("--no-pipeline", dest="pipeline", action="store_false",
                    help="force the synchronous reference step")
    ap.add_argument("--warmup", dest="warmup", action="store_true",
                    default=None,
                    help="make every step program of the bucket grid at "
                         "startup (on the card: capture its CUDA graphs) so "
                         "serving never makes one; with --http, /healthz "
                         "answers 503 until it finishes; default: on with "
                         "--http, off for the batch demo")
    ap.add_argument("--no-warmup", dest="warmup", action="store_false",
                    help="skip the startup warmup (each program is made at "
                         "the first use of its shape)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome-trace JSON of the run (engine step "
                         "phases + one track per request; open in "
                         "chrome://tracing or ui.perfetto.dev). Batch mode "
                         "exports after generation; --http exports at "
                         "shutdown. Implies --metrics.")
    ap.add_argument("--torch-profile", default=None, metavar="DIR",
                    help="also run torch.profiler over the generation / "
                         "serving window (the card's kernels on the card; "
                         "with --http on the engine thread, from the end "
                         "of the warmup to shutdown), writing "
                         "DIR/torch_trace.json (view in Perfetto)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="HTTP port (0 = pick a free port; the chosen one "
                         "is printed)")
    ap.add_argument("--seed", type=int, default=0,
                    help="weights, prompts and the sampling keys")
    ap.add_argument("--static", action="store_true",
                    help="use the fixed-shape reference loop instead of the "
                         "continuous-batching engine")
    ap.add_argument("--check-static", action="store_true",
                    help="greedy only: hold the engine's tokens against the "
                         "static loop's (default with --reduced)")
    args = ap.parse_args(argv)

    dev = device_mod.resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    sharded = args.tp > 1 or args.mesh
    if sharded:
        _check_tp(args, cfg, dev)
        from repro_torch.distributed import ranks
        if rank is None:
            if args.tp > 1:
                return ranks.spawn(_serve_rank, args.tp, (argv,),
                                   device=dev.type)[0]
            return ranks.in_one_rank(_serve_rank, dev.type, (argv,))
        dev = ranks.rank_device(dev.type, rank)
    if dev.type == "cuda":
        cfg = dataclasses.replace(cfg, dtype="bfloat16",
                                  param_dtype="bfloat16")
    # the static loop runs the backend's FFN (the engine configures its
    # own per phase from the same choice)
    cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, ffn_impl=args.backend))
    params = lm.init(cfg, device=dev, seed=args.seed)
    rng = np.random.RandomState(args.seed)
    prompts = [rng.randint(0, cfg.vocab_size, args.prompt_len).tolist()
               for _ in range(args.batch)]
    prompt = torch.tensor(prompts, dtype=torch.int64, device=dev)
    key = trandom.PRNGKey(args.seed, device=dev)
    if dev.type == "cuda":     # compile the kernels before the clock starts
        print(f"[serve/torch] kernels built in {build.build_all():.1f}s")

    from repro_torch.serving import (DisaggCoordinator, EngineSpec,
                                     SamplingParams, SpecConfig, Telemetry,
                                     torch_profiler)
    use_engine = uses_engine(cfg, args.static)
    if args.http and not use_engine:
        raise SystemExit("--http requires the continuous-batching engine "
                         "(dense/moe family without a window or local "
                         "chunk, no --static)")
    if args.disagg and not use_engine:
        raise SystemExit("--disagg requires the continuous-batching engine "
                         "(dense/moe family without a window or local "
                         "chunk, no --static)")
    cache_len = args.prompt_len + args.gen + 1
    if not use_engine:
        t0 = time.perf_counter()
        with torch_profiler(args.torch_profile, dev):
            toks = generate(params, cfg, prompt, args.gen, cache_len,
                            greedy=args.temperature <= 0, key=key,
                            top_k=args.top_k,
                            temperature=args.temperature or 1.0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        print(f"[serve/static] generated {tuple(toks.shape)} in {dt:.2f}s "
              f"({args.batch * args.gen / dt:.1f} tok/s, "
              f"backend={args.backend}, device={dev})")
        print(toks[:, :16].cpu().numpy())
        return toks

    spec = None
    if args.spec_k:
        spec = SpecConfig(k=args.spec_k, draft_backend=args.draft_backend,
                          draft_threshold=args.draft_threshold)
    # telemetry defaults: on when serving HTTP (scrapeable /metrics), off
    # for the one-shot batch demo; --metrics/--trace-out force it on
    use_telemetry = args.http if args.metrics is None else args.metrics
    if args.trace_out:
        use_telemetry = True
    telemetry = Telemetry(trace=bool(args.trace_out) or args.http) \
        if use_telemetry else None
    # pipeline/warmup default on for long-lived HTTP serving (throughput +
    # no program made behind /healthz), off for the one-shot demo
    use_pipeline = args.http if args.pipeline is None else args.pipeline
    use_warmup = args.http if args.warmup is None else args.warmup
    if args.disagg:
        if args.pipeline:
            raise SystemExit("--disagg runs synchronous engines (KV "
                             "withdraw cannot race a launched step); drop "
                             "--pipeline")
        use_pipeline = False
    mesh = None
    if sharded:
        from repro_torch.distributed.sharding import make_serving_mesh
        mesh = make_serving_mesh(args.tp, dev)
        print(f"[serve/engine] tensor-parallel mesh: tp={args.tp} "
              f"({'nccl' if dev.type == 'cuda' else 'gloo'}, one process "
              f"a rank)")
    espec = EngineSpec(
        backend=args.backend, block_size=args.block_size,
        max_batch=args.max_batch or args.batch,
        max_seq_len=args.prompt_len + args.gen, seed=args.seed, spec=spec,
        prefix_cache=not args.no_prefix_cache,
        prefill_chunk=args.prefill_chunk, scheduler=args.scheduler,
        telemetry=telemetry if telemetry is not None else False,
        pipeline=use_pipeline, device=dev, mesh=mesh)
    if args.disagg:
        engine = DisaggCoordinator(params, cfg, spec=espec,
                                   transfer_ttl_steps=args.transfer_ttl)
    else:
        engine = espec.build(params, cfg)

    if args.http:
        return _serve_http(args, engine, use_warmup, use_telemetry, dev)

    # no per-request seed: each request derives its key from the engine's
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p)
    if use_warmup:
        engine.warmup()
        print(f"[serve/torch] warmup: {len(engine.warmup_report)} programs "
              f"in {engine.warmup_seconds:.2f}s ({_programs(engine)})")
    ops.OverflowLog.reset()
    t0 = time.perf_counter()
    with torch_profiler(args.torch_profile, dev):
        outs = engine.generate(prompts, sampling=sp, max_tokens=args.gen)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total_new = sum(len(o.token_ids) for o in outs)
    ttft = [o.ttft for o in outs]
    print(f"[serve/torch] {len(outs)} requests x {args.gen} tokens in "
          f"{dt:.2f}s ({total_new / dt:.1f} tok/s, backend={args.backend}, "
          f"device={dev}, pipeline={use_pipeline}, "
          f"block_size={args.block_size}, "
          f"ttft mean {np.mean(ttft) * 1e3:.1f}ms, "
          f"programs {_programs(engine, total=True)})")
    if args.disagg:
        rs = engine.role_stats()
        print(f"[serve/torch] disagg: {engine.migrated_blocks_total} KV "
              f"blocks migrated, decode-side prefill tokens "
              f"{rs['decode']['prefill_tokens_total']}, transfers "
              f"{rs['transfer']['claimed_total']} claimed / "
              f"{rs['transfer']['expired_total']} expired")
    overflow = ops.OverflowLog.seen()
    if overflow:
        print("[serve/torch] a TwELL gate tile overflowed its T/C slots: "
              "its columns past them were dropped", file=sys.stderr)
    if engine.prefix_cache and engine.cached_tokens_total:
        print(f"[serve/torch] prefix cache: "
              f"{engine.cached_tokens_total}/{engine.prompt_tokens_total} "
              f"prompt tokens served from cache")
    if spec is not None:
        drafted = sum(o.spec_drafted for o in outs)
        accepted = sum(o.spec_accepted for o in outs)
        steps = len(engine.stats)
        print(f"[serve/torch] spec k={spec.k} "
              f"draft={engine.draft_pair.describe()} "
              f"acceptance={accepted}/{drafted} "
              f"({accepted / max(drafted, 1):.1%}), "
              f"{total_new / max(steps, 1):.2f} tok/step over {steps} steps")
    if engine.telemetry is not None:
        phases = engine.telemetry.phase_ms_mean()
        if phases:
            print("[serve/torch] phase ms/step: " + ", ".join(
                f"{k}={v:.2f}" for k, v in sorted(phases.items())))
    if args.trace_out:
        engine.export_trace(args.trace_out)
        print(f"[serve/torch] chrome trace -> {args.trace_out}")
    print(np.asarray([o.token_ids for o in outs]))

    if args.temperature <= 0 and (args.check_static or args.reduced) and \
            not rank:
        got = torch.tensor([o.token_ids for o in outs], dtype=torch.int64)
        logits: List[torch.Tensor] = []
        ref = generate(params, cfg, prompt, args.gen, cache_len,
                       logits_out=logits)[:, args.prompt_len:].cpu()
        agree = float((got == ref).float().mean())
        print(f"[serve/torch] static-loop agreement: {agree:.2%}")
        if dev.type == "cuda":
            ties = first_near_ties(logits)
            for row, n in enumerate(ties):
                assert torch.equal(got[row, :n], ref[row, :n]), \
                    f"row {row}: the engine diverged from the static loop " \
                    f"before its first near-tie ({n}); TwELL overflow " \
                    f"{'seen' if overflow else 'not seen'}"
            print(f"[serve/torch] static loop: equal up to the first "
                  f"near-tie in every row (ties at {ties})")
        else:
            assert agree == 1.0, \
                "continuous-batching engine diverged from the static loop"
    return outs


def _check_tp(args, cfg, dev) -> None:
    """``--tp``/``--mesh``'s refusals, before any rank starts: JAX's (the
    engine only, no --disagg), --http over more than one rank (not in the
    port yet), the card count, and the backends' (``validate_mesh``)."""
    if args.tp < 1:
        raise SystemExit(f"--tp must be >= 1, got {args.tp}")
    if not uses_engine(cfg, args.static):
        raise SystemExit("--tp/--mesh require the continuous-batching "
                         "engine (dense/moe family, no --static)")
    if args.disagg:
        raise SystemExit("--disagg requires unsharded KV pools; drop "
                         "--tp/--mesh")
    if args.http and args.tp > 1:
        raise SystemExit("--http under --tp > 1 is not in the port yet "
                         "(rank 0 would broadcast each step's submissions; "
                         "queued in ROADMAP.md); drop --http or --tp")
    if dev.type == "cuda" and args.tp > torch.cuda.device_count():
        raise SystemExit(f"--tp {args.tp} needs {args.tp} cards (one rank "
                         f"a card); {torch.cuda.device_count()} visible")
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.serving.backends import get_backend, make_draft_pair
    draft = make_draft_pair(args.backend, args.draft_backend,
                            args.draft_threshold).draft \
        if args.spec_k else None
    try:
        get_backend(args.backend).validate_mesh(
            cfg, AbstractMesh((args.tp,), ("model",)), draft)
    except ValueError as e:
        raise SystemExit(str(e)) from None


def _serve_rank(rank: int, dev, argv):
    """One rank of ``--tp``: the CLI on this rank's device and shard; only
    rank 0 prints."""
    import contextlib
    import os
    if rank == 0:
        return main(argv, rank=rank)
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        main(argv, rank=rank)
    return None


def _programs(engine, total: bool = False):
    """Programs made by entry (per engine role behind ``--disagg``), or
    their total."""
    made = engine.programs_made() if hasattr(engine, "programs_made") \
        else {"unified": dict(engine.programs.made)}
    if total:
        return sum(n for per in made.values() for n in per.values())
    return made if len(made) > 1 else made["unified"]


def _serve_http(args, engine, use_warmup: bool, use_telemetry: bool, dev):
    """Run ``engine`` behind the HTTP server until SIGINT/SIGTERM (or the
    engine thread fails), then shut down cleanly."""
    import signal

    from repro_torch.serving import torch_profiler
    from repro_torch.serving.server import ServingServer
    # the engine thread holds the profiler: it records its own thread's ops
    profile = (lambda: torch_profiler(args.torch_profile, dev)) \
        if args.torch_profile else None
    server = ServingServer(engine, host=args.host, port=args.port,
                           warmup=use_warmup, profile=profile)
    server.start()
    if use_warmup:
        if not server.wait_ready():
            server.shutdown()
            server.check()
        print(f"[serve/warmup] {len(engine.warmup_report)} programs in "
              f"{engine.warmup_seconds:.2f}s ({_programs(engine)}); "
              f"serving makes none", flush=True)
    stop = {"flag": False}

    def _sig(signum, frame):
        stop["flag"] = True
    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)
    print(f"[serve/http] listening on http://{server.host}:{server.port} "
          f"(backend={args.backend}, device={dev}, "
          f"scheduler={args.scheduler}, pipeline={engine.pipeline}"
          + (", disagg=prefill+decode" if args.disagg else "") +
          "; POST /v1/completions, GET /healthz"
          + (", GET /metrics" if use_telemetry else "") + ")", flush=True)
    try:
        while not stop["flag"] and server.error is None:
            time.sleep(0.1)
    except KeyboardInterrupt:
        pass
    server.shutdown()
    server.check()
    if args.trace_out:
        engine.export_trace(args.trace_out)
        print(f"[serve/http] chrome trace -> {args.trace_out}", flush=True)
    print("[serve/http] clean shutdown", flush=True)
    return None


if __name__ == "__main__":
    main()
