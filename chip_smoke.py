#!/usr/bin/env python3
"""Bring-up check of the PyTorch port on one NVIDIA card (H100).

Run from the repo root with no arguments: ``python3 chip_smoke.py``. It puts
``src`` on ``sys.path``, imports the port (``repro_torch``; never JAX or the
JAX package) and runs these phases, each printing one JSON line:

  1. device   -- ``nvidia-smi`` name and power limit, torch and CUDA versions
  2. build    -- compiles ``src/repro_torch/kernels/csrc/*.cu`` (one nvcc per
                 source, in parallel) into ``build/repro_torch/``; ptxas's
                 registers and spills, and any C75xx line (wgmma
                 serialised or fenced by the compiler, setmaxnreg ignored),
                 hybrid_matmul's listed even when there is none
  3. kernels  -- each hand-written kernel (K1 gate matmul + TwELL pack, K2
                 fused up/down projection, K3 paged decode attention, K4 paged
                 chunk attention, K5 tile-skip gated FFN, K6 non-gated TwELL
                 down projection, K7 causal flash attention, K8 and K9 the
                 ELL sides of the hybrid products) on the card at the main
                 paths' shapes in bfloat16, held against its plain PyTorch
                 version on the same inputs, then timed beside the plain
                 version, a library call and its bound (K1, K3, K5, K6, K8
                 and K9 also the host time of a call beside the library
                 call's); K1,
                 K3, K4, K5 and K7 also twice for the same bits, K1 at M 4,
                 20, 64 and 256 on paper-0.5b's W_g and at M 4 and 256 on
                 olmo-1b's N 8192, K2 at M 4, 256 and 20 and on a gate with
                 every column alive (a union near N), with its host time
                 beside the dense FFN's, K1 and K2 at the MoE experts'
                 shapes (K 5120, N 8192; K 6144, N 16384) at M 4 and 64,
                 at llama3-405b's FFN (K 16384, N 53248: K2 past K 8192)
                 at M 4 and 64 and at deepseek-67b's (K 8192, N 22016) at
                 M 4, K1 with relu^2 and K6 at rwkv6-7b's channel mix (K
                 4096, N 14336) and K1 + K2 at zamba2-1.2b's shared FFN
                 (K 2048, N 8192) at M 4, K1 and K6 at whisper-large-v3's
                 FFN (K 1280, N 5120) at M 4 and over the encoder's 6000
                 frame rows, K1 + K2 at llama-3.2-vision-11b's (K 4096,
                 N 14336) at M 4, K8 and K9 at rwkv6-7b's
                 training shape (K 4096, N 14336),
                 K6 at M 4 and 256 (with K1 + K6
                 beside the dense non-gated FFN) and on a pattern with every
                 column alive, with its union a row block and its launch
                 plan, K3 and K4 at hd 64 (MHA, GQA), at
                 olmo-1b's hd 128, phi3-mini's 32 heads of 96 and the
                 GQA groups of deepseek-67b (64/8) and llama3-405b
                 (128/8) at hd 128, and at tensor parallelism's per-rank
                 heads (TP_ATTN_SHARDS: paper-0.5b tp 2's 16/16 of 64,
                 one kv head of deepseek-67b and llama3-405b at tp 8, G
                 8 and 16), K1 + K2 at the per-rank FFN shards at M 4
                 (TP_FFN_SHARDS: paper-0.5b's whole-tile splits at tp 2
                 and 4, N 2816, 1536, 1280, with K5; deepseek-67b's at
                 tp 8, K 8192, N 2816 and 2560; llama3-405b's, K 16384,
                 N 6656), K5 at M 4 and 256 with its launch plan,
                 its two kernels' device times apart and its time without
                 programmatic dependent launch; K8 and K9 forward and
                 backward on the train phase's pattern and forward on a
                 pattern scattered over all N, with their host time a call
                 and the mean column union of a 128-row block (K8 also on
                 an f32 W, with a digest of its output's bits), K8 forward
                 and backward and K9 backward at olmo-1b's N 8192, K8
                 and K9 forward and backward at deepseek-67b's (K 8192, N
                 22016) and llama3-405b's (K 16384, N 53248), on the
                 wide union maps; K7 at
                 the train phase's batch with 32 heads of 64, one 4096-token
                 row, olmo-1b's 16 heads of 128, phi3-mini's 32 of 96 and
                 deepseek-67b's 64 of 128 and whisper-large-v3's 20 of 64
  4. serve    -- the port's ``ServingEngine`` serves paper-0.5b at full width
                 (gather/TwELL backend, paged KV, chunked prefill, prefix
                 cache; every step entry a CUDA graph, captured at the first
                 use of its bucket key, inside the timed run): 6 greedy
                 requests; the launch count of every kernel
                 of this path (K1-K4) over exactly this run must be above 0;
                 then a profiled rerun (phase "profile"), with the kernel
                 launches of 4 decode-only steps, each traced alone
  5. spec     -- the same weights and prompts through self-speculative
                 decoding (k = 4 tile-skip drafts, K5 + K3; one batched
                 TwELL verify, K1 + K2 + K4): every kernel's launch count
                 over the greedy run above 0, tokens equal to the
                 non-speculative run's up to its first near-tie, the pool
                 clean, and a seeded stochastic run twice with equal tokens
  5b. pipeline -- the serve phase's settings and prompts on engines made
                 with ``warmup=True`` (every program of the bucket grid
                 captured up front), synchronous then pipelined
                 (``pipeline=True``): no program made after the warmup,
                 K1-K4 launched (counted through the graphs' replays) over
                 exactly the pipelined run, no overflow, the prefix cache
                 hit, the pool clean after ``flush()``, tokens equal to the
                 serve phase's up to each request's first near-tie;
                 tokens/s, TTFT, decode step, sync and overlap times and a
                 profiled rerun of each; then a greedy speculative run
                 pipelined after warmup (tokens equal to the spec phase's up
                 to the first near-tie, its acceptance), and one replay of
                 each entry (decode, prefill, draft, verify) bitwise equal
                 to its eager model call from the same copy of the pools
  5b'. serve_tp -- tensor-parallel serving's code path on the one card:
                 a one-rank ``model`` mesh on NCCL (``make_serving_mesh(1)``,
                 joined through a file store in a temporary directory),
                 the weights cut by ``bridge.shard_params``, the pools by
                 ``PagedKVCache(mesh=)``, the layers' all_reduce and the
                 logits' all_gather captured in the CUDA graphs; the
                 pipeline phase's warmed pipelined gather run and its
                 speculative run on the sharded engine, tokens bitwise
                 equal to that phase's (on a mismatch: the first
                 differing token and its top-2 logit margin) and to the
                 serve and spec phases' up to their near-ties; K1-K5
                 launched; 2 L + 1 all_reduce and 1 all_gather captured
                 in every decode program; one decode program's graph
                 nodes by type (cuGraphGetNodes) beside the unsharded
                 one's, the gather's copy among them; the decode step
                 time beside the unsharded one
  5c. http    -- the serve phase's weights, prompts and engine settings
                 built through ``EngineSpec`` (pipelined, telemetry with
                 tracing on) behind ``ServingServer`` on 127.0.0.1, warmed
                 up by its engine thread: /healthz 200 after the warmup
                 and no program made after it; the 6 prompts sent at once
                 (3 plain, 3 over SSE), tokens equal to the pipeline
                 phase's up to each request's first near-tie; a 7th stream
                 dropped after 2 chunks ends cancelled; /metrics (tokens,
                 TTFT count, the plan/launch/collect/overlap phases) and
                 /v1/stats (FFN sparsity above 0.97, FLOPs reduction, MFU)
                 read back; the Chrome trace under ``build/`` with each
                 request's QUEUED, PREFILL, DECODE, FINISH or CANCEL; K1-K4
                 launched over exactly the HTTP traffic; the pool clean,
                 the server shut down; then tokens/s over HTTP, over a
                 window of seconds: HTTP_ROUNDS rounds of the wave each
                 way, interleaved (over HTTP; in process to the engine
                 thread with 6 waiting threads; with 1), each round's
                 tokens/s, decode step, sync and busy share, with their
                 spread; the same prompts in process on warmed engines
                 with telemetry on and off, pipelined and synchronous,
                 INPROCESS_ROUNDS rounds each (decode step, sync,
                 tokens/s, spread), each telemetry hook's host time, the
                 kernels of a graphed decode step with and without the
                 sparsity probe, and the static reference loop
                 (``launch/serve.py:generate``, K1 + K2, plain attention)
                 against the engine up to each request's first near-tie
  5d. disagg  -- the serve phase's model, prompts and engine settings behind
                 a ``DisaggCoordinator`` (a prefill and a decode engine,
                 each with its own KV pool and CUDA graphs): warmed, with
                 ``InProcessTransport``, tokens equal to a warmed unified
                 engine's up to each request's first near-tie, zero
                 prefill chunks on the decode engine, no program made
                 after the warmup, both pools clean, 83 blocks migrated
                 (the plan's count), K1-K4 launched; then each transport
                 unwarmed with every migration's blocks snapshot right
                 after its copy (destination equal to source, the two
                 transports' tokens and blocks equal bit for bit); the spec
                 phase's speculation on the decode engine (K5 launched,
                 tokens equal to the unified speculating engine's up to the
                 near-ties); churn (a cancel mid-transfer, a cancel
                 mid-decode, a TTL of DISAGG_TTL steps expiring entries
                 that re-prefill with the same tokens); each transport's
                 copy time a migration and a MiB, tokens/s, TTFT and the
                 decode step beside the unified engine's, peak memory with
                 two engines beside one
  6. serve_olmo -- olmo-1b (non-gated FFN, non-parametric LayerNorm, head
                 dim 128) at full width and depth through the same engine
                 settings and prompts, 98% of every layer's W_u columns
                 zeroed: K1 packs relu(x @ W_u), K6 projects down, K3/K4
                 attend; each launched over exactly this run, no overflow,
                 the prefix cache hit, the pool clean; then a profiled rerun
                 and the kernel launches of 4 decode-only steps
  6b. serve_moe -- mixtral-8x22b (1 layer) and llama4-scout-17b-a16e (2)
                 at full width (KEEP of every expert's gate
                 columns alive) through the serve CLI's static loop,
                 greedy: gather (K1 + K2 once an expert a layer a step,
                 counted exactly; K2 past K 4096) then dense, tokens
                 equal up to each request's first near-tie; mixtral's
                 prompts run past its 4096-token window (the decode ring
                 wraps) and its first layer's decode logits there are
                 held against ``lm.forward``'s in float32; each
                 config's first layer in bf16, the dense run's tokens
                 teacher-forced through decode under gather and under
                 dense, logits within MOE_GATHER_TOL at every generated
                 position (K1 + K2 checked inside the wrapped ring);
                 tokens/s and the step time
  6c. serve_dense -- phi3-mini-3.8b (8 of its 32 layers, head dim 96),
                 deepseek-67b and llama3-405b (2 layers each, GQA 64/8
                 and 128/8 at head dim 128, d_model 8192 and 16384) at
                 full width, KEEP of every layer's gate columns alive,
                 through the engine with the serve phase's settings,
                 warmed (CUDA graphs), on six prompts over each config's
                 vocabulary: the gather FFN (K1-K4 each launched, no
                 overflow, the prefix cache hit, a clean pool), then the
                 dense FFN on a fresh warmed engine, tokens equal up to
                 each request's first near-tie; two prompts' dense tokens
                 teacher-forced through the paged decode under gather
                 and under dense: on the first layer the two within
                 LOGIT_TOL beyond one bf16 step of the logit (0.125 at
                 llama3's largest) at every generated position; at the
                 served depth each within DENSE_SERVE's tolerance of the same
                 weights and tokens in float32 on the CPU, gather no
                 farther from it than dense by more than LOGIT_TOL;
                 tokens/s, decode step, TTFT
  6d. serve_ssm -- zamba2-1.2b (hybrid: Mamba2 layers and one shared
                 attention block after every 6th; 12 of 38 layers) and
                 rwkv6-7b (ssm: RWKV-6 time and channel mixes, affine
                 LayerNorm; 8 of 32 layers) at full width, KEEP of the FFN
                 pattern's columns alive, through the serve CLI's static
                 loop, greedy: gather (zamba2: K1 + K2 at each of the
                 shared block's 2 applications a step; rwkv6: K1 with
                 relu^2, then K6, in every layer a step; counted exactly),
                 then dense, no overflow, the dense run's tokens
                 teacher-forced through gather and dense (logits within
                 LOGIT_TOL on the first 6 / 2 layers) and at the served
                 depth through both and float32 (each path within
                 STATIC_SERVED_TOL of float32), tokens equal up to each
                 request's first near-tie (LOGIT_TOL, or twice the served
                 gather-to-dense gap), tokens/s and the step time; then
                 in float32 zamba2's first 6 layers and rwkv6's first 2,
                 SSM_RECUR_LEN tokens teacher-forced through decode, the
                 logits at every position held against ``lm.forward``'s
                 (the chunked SSD and WKV)
  6e. serve_xattn -- whisper-large-v3 (audio: 32 encoder and 32 decoder
                 layers, 4 x XATTN_FRAMES frames) and llama-3.2-vision-11b
                 (vlm: all 40 layers, 8 of them tanh-gated cross blocks
                 with nonzero gates, 4 x 1024 patches) at full width, KEEP
                 of the FFN pattern's columns alive: prefill_cross_cache
                 (whisper's encoder: K1, then K6, over 6000 frame rows)
                 and the serve CLI's static loop from that cache, greedy:
                 gather (K1 + K6 / K1 + K2 in every layer a step, counted
                 exactly) then dense, no overflow; the dense run's tokens
                 teacher-forced through gather and dense on the first
                 layers (within LOGIT_TOL) and at the served depth
                 through both and float32 (STATIC_SERVED_TOL), tokens equal
                 up to each request's first near-tie, the cross cache's
                 seconds, tokens/s, the step time and a traced step
  7. train    -- TRAIN_STEPS AdamW steps of paper-0.5b at full width and
                 depth through the port's ``make_train_step`` with the hybrid
                 FFN (K8 + K9) and K7 attention, 8 x 1024 SyntheticLM tokens
                 a step: K7-K9 each launched over exactly this run, no
                 hybrid overflow, rows on both sides of the format, finite
                 and falling loss; step time, tokens/s, peak memory and the
                 busy share of a profiled step, beside the same steps with
                 the dense FFN; then a float32 gradient check of one hybrid
                 FFN layer against autograd of the dense formula
  7m. train_mesh -- the train phase's hybrid run again (its weights,
                 batches, steps and TrainConfig) through the mesh train
                 step (``make_train_step(..., mesh=)``) on a one-rank NCCL
                 mesh (pod 1, data 1, model 1; ``launch/mesh.py``): K7, K8
                 and K9 launched, losses and grad norms within BF16_TOL of
                 the train phase's (expected bitwise; the largest
                 difference printed); then train_moe's full-width mixtral
                 layer (hybrid, TRAIN_ALIVE gate columns an expert) on
                 MESH_MOE_ROWS tokens through ``moe_apply_sorted`` at data
                 1: with a capacity at which nothing can drop against the
                 one-hot dispatch within BF16_TOL, and at the config's
                 capacity 1.25 with its ``moe_drop_frac``; the card, its
                 power limit and the phase's seconds
  7a. dryrun  -- the port's dry run (``launch/dryrun.py``, meta tensors,
                 each kernel its shape function, no card) of the train
                 phase's hybrid and dense steps: each predicted peak beside
                 the measured one less what earlier phases held, the dense
                 within DRYRUN_TOL; the predicted peaks of the trainings
                 that wait on memory (WAITING_TRAININGS). Phase 3 also
                 holds every kernel's output shapes and dtypes against its
                 shape function's on meta copies of its inputs
  7b. remat   -- the same model, hybrid FFN and batch: one loss and
                 gradient under each ``remat`` mode (none, dots, full,
                 2level) from the same weights, each bitwise equal to
                 none's, then REMAT_STEPS steps a mode (equal losses); the
                 peak of the gradient and of the steps, none > dots > full
                 asserted, and the step times
  7c. train_1p5b -- paper-1.5b at full width and all 28 layers, hybrid and
                 dense, each at remat none and full, P15_STEPS steps each
                 (TRAIN_BATCH rows unless dense at none does not fit:
                 then the largest batch it fits, for all four): peaks,
                 step times, tokens/s, the hybrid/dense peak ratio; hybrid
                 below dense at none asserted
  7d. train_olmo -- olmo-1b at full width and depth under its own remat
                 (full), hybrid (non-gated) then dense, OLMO_TRAIN_STEPS
                 steps each: K7 at head dim 128, K8 and K9 launched, rows on
                 both sides of the format, no overflow, a falling loss
  7e. train_moe -- mixtral-8x22b's full-width layer (2.91 B parameters),
                 hybrid then dense, MOE_TRAIN_STEPS steps each on
                 MOE_TRAIN_BATCH rows of TRAIN_SEQ tokens (within the
                 window: K7): K7, K8 and K9
                 launched, both sides of the hybrid format, no overflow,
                 a falling loss, step time and peak; then its MoE
                 block's hybrid gradients against the dense formula in
                 float32
  7f. train_dense -- phi3-mini-3.8b (8 layers, f32 moments: K7 at head
                 dim 96) and deepseek-67b (1 layer, bf16 moments: K8/K9
                 at N 22016 on the wide union maps) at full width under
                 remat full, hybrid then dense, DENSE_TRAIN_STEPS steps of
                 TRAIN_BATCH x TRAIN_SEQ tokens each: K7-K9 launched, both
                 sides of the hybrid format, no overflow, a falling loss,
                 step time, peak, MFU; then each config's FFN layer in
                 float32, hybrid gradients against the dense formula
  7g. train_ssm -- zamba2-1.2b (12 of 38 layers) and rwkv6-7b (8 of 32) at
                 full width under remat full, TRAIN_ALIVE of the pattern's
                 columns alive, hybrid then dense, STATIC_TRAIN_STEPS steps of
                 TRAIN_BATCH x TRAIN_SEQ tokens each: K8 and K9 (rwkv6
                 non-gated, relu^2) and K7 (zamba2's shared block)
                 launched, both sides of the hybrid format, no overflow, a
                 falling loss, step time, peak, MFU, a traced hybrid step;
                 then each config's FFN layer in float32, hybrid
                 gradients against the dense formula
  7h. train_xattn -- whisper-large-v3 (32 + 32 layers, the encoder over
                 TRAIN_BATCH x XATTN_FRAMES frames) and
                 llama-3.2-vision-11b (its first super-block: 4 self
                 blocks and a cross block, with the 128256-row embedding
                 and head, on TRAIN_BATCH / 2 rows) at full width under
                 remat full, hybrid then dense, STATIC_TRAIN_STEPS steps of
                 rows of TRAIN_SEQ tokens: K7, K8 and K9 launched, both
                 sides of the hybrid format, no overflow, a falling loss,
                 step time, peak, MFU, a traced hybrid step; then each
                 FFN layer in float32, hybrid gradients against the dense
                 formula
  8. check    -- the same weights in float32 on the CPU (plain versions)
                 against the card: prefill plus 4 decode steps of two prompts
                 through the gather path and one through tile_skip, logits
                 within a stated tolerance; the same for two prompts through
                 olmo-1b's first 2 layers (K1 + K6) and through
                 phi3-mini-3.8b's first 2 (head dim 96 through K1-K4);
                 rwkv6-7b's first 2 layers (affine LayerNorm, K1 + K6)
                 and zamba2-1.2b's first 6 (K1 + K2) through the static
                 loop's decode, prefill plus 4 steps; whisper-large-v3's
                 first 2 + 2 layers (K1 + K6, one request's frames) and
                 llama-3.2-vision-11b's first super-block (K1 + K2, one
                 request's patches), from prefilled cross caches, prefill
                 of XATTN_CHECK_PLEN tokens plus 4 steps;
                 and one training step
                 (2 layers, 1 x 256 tokens, hybrid) of paper-0.5b and of
                 olmo-1b (under its remat, full): loss and every gradient
                 leaf
  9. each phase's wall seconds and the script's total (``{"phase":
     "seconds", ...}``), the ``nvidia-smi`` line, the kernel table
     ``{"kernels": [...]}`` (launches summed over the serve,
     spec, pipelined, sharded (serve_tp), HTTP, disaggregated, olmo
     serve, MoE serve, dense
     configs' serve (gather), zamba2/rwkv6 serve (gather), whisper/vision
     serve (gather), hybrid train, mesh train (its steps and sorted
     dispatches), remat, paper-1.5b, olmo train, MoE
     train, dense configs' train, zamba2/rwkv6 train and whisper/vision
     train runs; a
     recomputed layer's kernels count again), then the
     last
     line ``{"ok": true, "device": {...}}``.

Any failure raises: the script exits non-zero and prints no last line. It
exits non-zero without a card and when the repo's ``src/`` is absent.
Random weights are made from a seed; nothing is downloaded.

For an A/B of kernel versions in one call, ``--src DIR --kernels
tile_skip_ffn`` (or any of twell_gate_matmul, twell_fused_ffn,
twell_down_proj, paged_decode_attention, paged_chunk_attention,
flash_attention, hybrid_to_dense, dense_to_hybrid, comma-separated)
runs only phases 1-3 for those kernels on the port under DIR (e.g. an
earlier version unpacked under ``build/``) and prints their table, without
the last line. ``--train-phases train`` (or any of train, train_mesh,
dryrun, remat,
train_1p5b, train_olmo, train_moe, train_dense, train_ssm, train_xattn
and check_train,
comma-separated) runs
phases 1-2 and those training phases (step times, peak memory), on the
port under ``--src`` if given, without the last line.
``--phases serve_moe`` and ``--train-phases train_moe`` run phases 1-2
and the MoE serving or training phase; ``--phases serve_dense`` and
``--train-phases train_dense`` the dense configs' (phi3-mini-3.8b,
deepseek-67b, llama3-405b); ``--phases serve_ssm`` and ``--train-phases
train_ssm`` the attention-free families' (zamba2-1.2b, rwkv6-7b);
``--phases serve_xattn`` and ``--train-phases train_xattn`` the
cross-attention families' (whisper-large-v3, llama-3.2-vision-11b).
``--phases serve_tp`` runs phases 1-2 and the serve_tp phase against the
unsharded runs it makes itself (no last line).
``--phases disagg`` runs phases 1-2 and the disaggregated serving phase on
the serve phase's model and prompts, with references it makes itself (a
unified engine's near-ties, a speculating engine's tokens; no last
line). ``--k1-plans`` runs phases 1-2 and then K1 at each of its timed
shapes under the launch plans around ``gate_plan``'s (cluster size, rows
a block, ring depth), each checked against the plain version and timed
beside the clusters the card holds at once; for tuning the plan (no last
line).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import json
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor-core peak
BF16_TOL = 2e-2                    # as tests/test_kernels.py for bf16
LOGIT_TOL = 0.1                    # card bf16 vs CPU f32 logits, see phase 5
SEED = 0
KEEP = 0.02                        # fraction of gate columns alive (and,
#                                    in a non-gated FFN, of W_u columns)
SPEC_K = 4                         # draft tokens per speculative step
DRAFT_THRESHOLD = 2.5              # tile-skip gate threshold of the drafts:
#                                    greedy acceptance 0.82 on these weights
TRAIN_ALIVE = 216                  # gate columns alive per layer (of 5632)
#                                    in the train phase: a row's gate fires
#                                    ~Bin(216, 1/2) = 108 +- 7 of them, so
#                                    most rows fit the ELL width 128 and
#                                    ~0.1-0.3% take the backup (M/8 rows)
TRAIN_BATCH, TRAIN_SEQ = 8, 1024   # tokens per training step: 8192
TRAIN_STEPS = 5
GRAD_TOL = 1e-3                    # float32 hybrid vs dense gradients
TRAIN_LOSS_TOL = 1e-2              # card bf16 vs CPU f32 train step, see
TRAIN_GRAD_TOL = 0.1               # check_train


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the directory holding repro_torch (default: this "
                         "checkout's src); another copy of the port, e.g. "
                         "an earlier version unpacked under build/, times "
                         "that version's kernels")
    ap.add_argument("--kernels", default=None,
                    help="comma-separated kernel names: run only the device, "
                         "build and kernels phases, for those kernels, and "
                         "print their table (no last line); for A/B timing")
    ap.add_argument("--train-phases", default=None,
                    help="comma-separated training phases (train, "
                         "train_mesh (runs train first), dryrun, remat, "
                         "train_1p5b, train_olmo, train_moe, train_dense, "
                         "train_ssm, train_xattn, check_train): "
                         "run only the device and build phases and those, "
                         "on the port under --src (no last line); for A/B "
                         "timing of the training step")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases (disagg, serve_tp, "
                         "serve_moe, "
                         "serve_dense, serve_ssm, serve_xattn): "
                         "run only the device and build phases "
                         "and those (disagg on the serve phase's model and "
                         "prompts), each comparing against references it "
                         "makes itself (no last line)")
    ap.add_argument("--wide-maps", action="store_true",
                    help="with --kernels: K8 and K9 plan every N on the "
                         "wide union maps (hybrid_matmul.NARROW_MAX_N set "
                         "to 0), for an A/B against the N-sized maps")
    ap.add_argument("--k1-plans", action="store_true",
                    help="run only the device and build phases and K1 at "
                         "each of K1_SHAPES under the launch plans around "
                         "gate_plan's (cluster size, rows a block, ring "
                         "depth), each checked and timed (no last line); "
                         "for tuning the plan")
    return ap.parse_args(argv)


START = time.perf_counter()


def main(argv=None) -> int:
    args = parse_args(argv)
    src = args.src.resolve()
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from the "
              "repo root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 plain versions
    torch.backends.cudnn.allow_tf32 = False         # run in full f32

    smi = phase_device(torch)
    CARD["smi"] = smi
    phase_build()
    if args.k1_plans:
        phase_k1_plans(torch)
        print(smi, flush=True)
        return 0
    if args.train_phases:
        names = args.train_phases.split(",")
        unknown = [n for n in names if n not in TRAIN_PHASES]
        if unknown:
            print(f"chip_smoke: unknown training phases {unknown}; "
                  f"choose from {sorted(TRAIN_PHASES)}", file=sys.stderr)
            return 2
        for name in names:
            TRAIN_PHASES[name](torch)
        print(smi, flush=True)
        return 0
    if args.phases:
        names = args.phases.split(",")
        unknown = [n for n in names if n not in SERVE_PHASES]
        if unknown:
            print(f"chip_smoke: unknown serving phases {unknown}; choose "
                  f"from {sorted(SERVE_PHASES)}", file=sys.stderr)
            return 2
        serve = None
        if {"disagg", "serve_tp"} & set(names):   # the others make their own
            cfg, params, prompts = model_and_prompts(torch)
            serve = {"cfg": cfg, "params": params, "prompts": prompts,
                     "new_tokens": 32}
        for name in names:
            SERVE_PHASES[name](torch, serve, None, smi)
        print(smi, flush=True)
        return 0
    if args.kernels is not None:
        if args.wide_maps:
            from repro_torch.kernels import hybrid_matmul
            hybrid_matmul.NARROW_MAX_N = 0
        kernels = phase_kernels(torch, args.kernels.split(","))
        k5_splits(torch)
        print(smi, flush=True)
        emit({"kernels": kernels, "src": str(src)})
        return 0
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(torch, *args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        print(f"chip_smoke: {name} took {seconds[name]} s", file=sys.stderr,
              flush=True)
        return out
    kernels = timed("kernels", phase_kernels)
    serve = timed("serve", phase_serve)
    spec = timed("spec", phase_spec, serve)
    pipe = timed("pipeline", phase_pipeline, serve, spec)
    serve_tp = timed("serve_tp", phase_serve_tp, serve, spec, pipe)
    http = timed("http", phase_http, serve, spec, pipe)
    disagg = timed("disagg", phase_disagg, serve, spec, smi)
    olmo = timed("serve_olmo", phase_serve_olmo, serve)
    serve_moe = timed("serve_moe", phase_serve_moe)
    serve_dense = timed("serve_dense", phase_serve_dense)
    serve_ssm = timed("serve_ssm", phase_serve_ssm)
    serve_xattn = timed("serve_xattn", phase_serve_xattn)
    train = timed("train", phase_train)
    train_mesh = timed("train_mesh", phase_train_mesh)
    timed("dryrun", phase_dryrun)
    remat = timed("remat", phase_remat)
    p15 = timed("train_1p5b", phase_train_1p5b)
    olmo_train = timed("train_olmo", phase_train_olmo)
    train_moe = timed("train_moe", phase_train_moe)
    train_dense = timed("train_dense", phase_train_dense)
    train_ssm = timed("train_ssm", phase_train_ssm)
    train_xattn = timed("train_xattn", phase_train_xattn)
    timed("check", phase_check, serve, olmo, serve_dense, serve_ssm,
          serve_xattn)
    timed("k5_splits", k5_splits)
    emit({"phase": "seconds", "seconds": seconds,
          "total": round(time.perf_counter() - START, 1)})
    for k in kernels:
        k["launches"] = sum(run["launches"].get(k["name"], 0) for run in
                            (serve, spec, pipe, serve_tp, http, disagg,
                             olmo,
                             serve_moe, serve_dense, serve_ssm,
                             serve_xattn, train, train_mesh, remat, p15,
                             olmo_train,
                             train_moe, train_dense, train_ssm,
                             train_xattn))
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# --------------------------------------------------------------------------- #
# 1-2. device and build
# --------------------------------------------------------------------------- #

def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return smi


def phase_build():
    from repro_torch.kernels import build
    secs = build.build_all()
    usage = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in build.BUILD_LOG.items()}
    # ptxas's C75xx lines: C7510-C7518 wgmma serialised, C7519 a
    # warpgroup.arrive injected, C7508 setmaxnreg ignored
    c75 = {name: [ln.strip() for ln in log.splitlines() if "C75" in ln]
           for name, log in build.BUILD_LOG.items()}
    emit({"phase": "build", "seconds": round(secs, 2),
          "sources": [p.name for p in build.sources()],
          "dir": str(build.BUILD_DIR), "ptxas": usage,
          "c75": {name: lines for name, lines in c75.items() if lines},
          "c75_hybrid_matmul": c75.get("hybrid_matmul", [])})


# --------------------------------------------------------------------------- #
# 3. kernels against their plain versions
# --------------------------------------------------------------------------- #

class Timer:
    """Mean device time of one call: CUDA events around each call, with the
    L2 cache flushed before every call (on the main path each of the 8
    layers reads its own weights and pages, so a call finds them cold) and
    the card held busy by a spin kernel while the host enqueues the call,
    so the events time the device work and not the Python in front of it."""

    SPIN_CYCLES = 20_000_000          # ~10 ms at the H100's 1.98 GHz

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8,
                                     device="cuda")

    def ms(self, fn, iters=10, warmup=2):
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            self.flush_buf.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / iters


def host_us(torch, fn, calls=40, repeats=5):
    """Host time of one call, in microseconds: the wrapper's checks, plan
    and launch, not the device work (the serving runs are host-bound).
    The median over ``repeats`` batches of the host clock around ``calls``
    calls issued back to back, after one warm call, each batch
    synchronised only after its clock stops: the card's host is shared,
    and one stall moves a single long batch's mean by tens of percent."""
    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        means.append((t1 - t0) / calls * 1e6)
    return statistics.median(means)


def bound_ms(nbytes, flops):
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def prefix_bytes(counts, elem):
    """Bytes a kernel must read of a packed operand whose segments (a
    tile's or a row's slots) hold ``counts`` valid slots of ``elem`` bytes
    at their start: each valid prefix in whole 32-byte sectors, the least
    a load from device memory moves. Slots past a prefix are never read."""
    return int(((counts.long().clamp(min=0) * elem + 31) // 32 * 32).sum())


def close_err(torch, got, want, mask=None):
    """max |got - want| and whether |got - want| <= tol + tol * |want|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ok = diff <= BF16_TOL + BF16_TOL * want.abs()
    if mask is not None:
        diff = diff[mask]
        ok = ok[mask]
    return float(diff.max()) if diff.numel() else 0.0, bool(ok.all())


def gate_inputs(torch, m, k, n, gen, scale=0.08):
    x = (torch.randn((m, k), generator=gen, device="cuda") * 0.5).bfloat16()
    alive = torch.rand((n,), generator=gen, device="cuda") < KEEP
    wg = (torch.randn((k, n), generator=gen, device="cuda") * scale
          * alive[None]).bfloat16()
    wu = (torch.randn((k, n), generator=gen, device="cuda") * scale
          ).bfloat16()
    wd = (torch.randn((n, k), generator=gen, device="cuda") * scale
          ).bfloat16()
    return x, wg, wu, wd


SHAPE_FNS = {   # kernel -> (module, its shape function)
    "twell_gate_matmul": ("twell_pack", "twell_gate_matmul_shape"),
    "twell_fused_ffn": ("sparse_ffn", "twell_fused_ffn_shape"),
    "twell_down_proj": ("sparse_ffn", "twell_down_proj_shape"),
    "tile_skip_ffn": ("sparse_ffn", "tile_skip_ffn_shape"),
    "paged_decode_attention": ("paged_decode_attention",
                               "paged_decode_attention_shape"),
    "paged_chunk_attention": ("paged_chunk_attention",
                              "paged_chunk_attention_shape"),
    "flash_attention": ("flash_attention", "flash_attention_shape"),
    "hybrid_to_dense": ("hybrid_matmul", "hybrid_to_dense_shape"),
    "dense_to_hybrid": ("hybrid_matmul", "dense_to_hybrid_shape"),
}
SHAPE_CHECKS = {}   # kernel -> calls whose outputs its shape function matched


def shape_agrees(torch, name, out, *args):
    """The kernel ``name``'s outputs ``out`` (a tensor or a tuple) against
    its shape function's on meta copies of ``args`` (what the dry run
    traces in its place): the same shapes and dtypes, or the phase fails.
    Counted in SHAPE_CHECKS."""
    import importlib
    from repro_torch.core import twell
    mod, fn = SHAPE_FNS[name]
    shape_fn = getattr(importlib.import_module(
        f"repro_torch.kernels.{mod}"), fn, None)
    if shape_fn is None:            # --src: a port from before the dry run
        return

    def meta(a):
        if isinstance(a, twell.TwellActs):
            return a._replace(**{f: getattr(a, f).to("meta") for f in
                                 ("values", "indices", "nnz", "overflow")
                                 if isinstance(getattr(a, f), torch.Tensor)})
        return a.to("meta") if isinstance(a, torch.Tensor) else a
    got = shape_fn(*map(meta, args))
    have = [(tuple(t.shape), t.dtype) for t in
            (got if isinstance(got, tuple) else (got,))]
    want = [(tuple(t.shape), t.dtype) for t in
            (out if isinstance(out, tuple) else (out,))]
    assert have == want, \
        f"{name}: the shape function gives {have}, the kernel {want}"
    SHAPE_CHECKS[name] = SHAPE_CHECKS.get(name, 0) + 1


def k1_agrees(torch, x, wg, t, c, case, act="relu"):
    """K1 on x, wg (``act``: relu, or relu^2 as rwkv6's channel mix) against
    the plain version: nnz and indices equal on the rows with no
    pre-activation near zero, values within BF16_TOL, and the same bits
    from run to run. Returns (max abs error, near-zero rows, the plain
    version's outputs)."""
    from repro_torch.kernels.twell_pack import (twell_gate_matmul_cuda,
                                                twell_gate_matmul_plain)
    v, i, z = twell_gate_matmul_cuda(x, wg, t, c, act)
    shape_agrees(torch, "twell_gate_matmul", (v, i, z), x, wg, t, c, act)
    pv, pi, pz = twell_gate_matmul_plain(x, wg, t, c, act)
    torch.cuda.synchronize()
    pre = x.float() @ wg.float()
    # a pre-activation within 1e-3 max|pre| of zero may round either way
    near = ((pre != 0) & (pre.abs() < 1e-3 * pre.abs().max())).any(-1)
    rows = ~near
    assert bool((z[rows] == pz[rows]).all()), f"K1 nnz mismatch ({case})"
    assert bool((i[rows] == pi[rows]).all()), f"K1 indices mismatch ({case})"
    assert int(z.max()) <= t // c, f"K1 geometry overflows ({case})"
    err, ok = close_err(torch, v[rows], pv[rows])
    assert ok, f"K1 values disagree with the plain version ({case}): {err}"
    v2, i2, z2 = twell_gate_matmul_cuda(x, wg, t, c, act)
    assert torch.equal(v, v2) and torch.equal(i, i2) and \
        torch.equal(z, z2), f"K1 is not run-to-run deterministic ({case})"
    return err, int(near.sum()), (pv, pi, pz)


def check_k1(torch, timer, m, n, gen, t=256, c=8, k=2048, scale=0.08,
             act="relu"):
    """K1 on a KEEP-masked gate weight (K 2048; N 5632 is paper-0.5b's W_g,
    8192 olmo-1b's W_u and zamba2-1.2b's shared W_g; K 5120 and 6144 the
    MoE experts'; K 4096, N 14336 with relu^2 rwkv6-7b's channel-mix W_u;
    the weights at std ``scale``), held by ``k1_agrees`` and timed.
    Returns the case and the inputs with the plain version's outputs."""
    from repro_torch.kernels.twell_pack import (twell_gate_matmul_cuda,
                                                twell_gate_matmul_plain)
    x, wg, wu, wd = gate_inputs(torch, m, k, n, gen, scale)
    err1, near, (pv, pi, pz) = k1_agrees(torch, x, wg, t, c,
                                         f"M={m}, K={k}, N={n}, {act}", act)
    # x and W read once, the packed values, indices and counts written
    out_bytes = m * n // c * (2 + 4) + m * n // t * 4
    b1, by1 = bound_ms(2 * (m * k + k * n) + out_bytes, 2 * m * k * n)
    k1 = {"ms": timer.ms(lambda: twell_gate_matmul_cuda(x, wg, t, c, act)),
          "plain_ms": timer.ms(lambda: twell_gate_matmul_plain(x, wg, t, c,
                                                               act),
                               iters=5),
          "library_ms": timer.ms(lambda: torch.matmul(x, wg)),
          "bound_ms": b1, "bound_by": by1, "max_abs_err": err1,
          "host_us": host_us(torch, lambda: twell_gate_matmul_cuda(
              x, wg, t, c, act)),
          "library_host_us": host_us(torch, lambda: torch.matmul(x, wg)),
          "near_zero_rows": near, "M": m, "K": k, "N": n, "act": act,
          "weight_std": scale}
    return k1, (x, wg, wu, wd, pv, pi, pz)


def check_k1_k2(torch, timer, m, gen):
    """K1 at (M, paper-0.5b's W_g), then K2 on the plain version's packed
    gate of the same inputs."""
    k1, (x, wg, wu, wd, pv, pi, pz) = check_k1(torch, timer, m, 5632, gen)
    return k1, check_k2(torch, timer, x, wg, wu, wd, pv, pi, pz)


def check_k2(torch, timer, x, wg, wu, wd, pv, pi, pz, pattern="alive"):
    """K2 on a packed gate (T 256, C 8; counts clipped to T/C as ops clips
    them) against the plain version, the same bits on a second call, timed
    beside the dense FFN (the library call), with the host time of a call,
    the columns the pattern names and the plan where the port has one."""
    from repro_torch.core import twell
    from repro_torch.kernels import sparse_ffn as sf
    from repro_torch.kernels.sparse_ffn import (twell_fused_ffn_cuda,
                                                twell_fused_ffn_plain)
    (m, k), n, t, c = x.shape, wd.shape[0], 256, 8
    tc = t // c
    wu_t = wu.t().contiguous()
    tw = twell.TwellActs(pv, pi, torch.clamp(pz, max=tc), (pz > tc).any(),
                         t, c, n)
    y = twell_fused_ffn_cuda(x, tw, wu_t, wd)
    shape_agrees(torch, "twell_fused_ffn", y, x, tw, wu_t, wd)
    py = twell_fused_ffn_plain(x, tw, wu_t, wd)
    torch.cuda.synchronize()
    err2, ok2 = close_err(torch, y, py)
    assert ok2, f"K2 disagrees with the plain version (M={m}, {pattern}): " \
        f"{err2}"
    assert torch.equal(y, twell_fused_ffn_cuda(x, tw, wu_t, wd)), \
        "K2 is not run-to-run deterministic"
    valid = twell.slot_valid(tw)
    slots = int(valid.sum())
    cols = int(torch.unique(tw.indices[valid]).numel())
    in_bytes = 2 * m * k + prefix_bytes(tw.nnz, 2) + \
        prefix_bytes(tw.nnz, 4) + m * n // t * 4
    b2, by2 = bound_ms(in_bytes + 2 * cols * k * 2 + 4 * m * k,
                       4 * k * slots)

    def k2():
        return twell_fused_ffn_cuda(x, tw, wu_t, wd)

    def dense_ffn():
        return torch.matmul(torch.matmul(x, wu) * torch.relu(
            torch.matmul(x, wg)), wd)
    plan = None
    if hasattr(sf, "fused_ffn_plan"):     # an earlier version has no plan
        p = sf.fused_ffn_plan(m, k, n, t, c, torch.cuda.get_device_properties(
            0).multi_processor_count)
        plan = {"width": p.width, "row_blocks": p.row_blocks, "ks": p.ks,
                "slices": p.slices, "ring": p.stages, "smem": p.smem,
                "split": p.split, "other_union_ms": None}
        if p.ks > 1:
            # the other way of building the union (each rank all the
            # block's rows, or the ranks split them): the same bits, timed
            default = sf.fused_ffn_plan
            sf.fused_ffn_plan = lambda *a, _p=dataclasses.replace(
                p, split=not p.split): _p
            try:
                assert torch.equal(y, k2()), "K2's union ways disagree"
                plan["other_union_ms"] = timer.ms(k2)
            finally:
                sf.fused_ffn_plan = default
    return {"ms": timer.ms(k2),
            "plain_ms": timer.ms(lambda: twell_fused_ffn_plain(
                x, tw, wu_t, wd), iters=5),
            "library_ms": timer.ms(dense_ffn),
            "host_us": host_us(torch, k2),
            "library_host_us": host_us(torch, dense_ffn),
            "bound_ms": b2, "bound_by": by2, "max_abs_err": err2,
            "active_slots_per_row": slots / m, "distinct_columns": cols,
            "overflow": bool(tw.overflow), "M": m, "K": k, "N": n,
            "pattern": pattern, "plan": plan}


def check_k2_scattered(torch, timer, m, gen):
    """K2 with every gate column alive (keep 1.0): each tile overflows its
    T/C slots (clipped, as ops clips them), so every row fills all N/C
    slots and a row block's union is near all of N. Reported, not held to
    the library time."""
    from repro_torch.kernels.twell_pack import twell_gate_matmul_plain
    x = (torch.randn((m, 2048), generator=gen, device="cuda") * 0.5).bfloat16()
    wg, wu, wd = ((torch.randn(shape, generator=gen, device="cuda") * 0.08)
                  .bfloat16() for shape in ((2048, 5632), (2048, 5632),
                                            (5632, 2048)))
    pv, pi, pz = twell_gate_matmul_plain(x, wg, 256, 8, "relu")
    return check_k2(torch, timer, x, wg, wu, wd, pv, pi, pz, "scattered")


def k2_cases(torch, timer, gen):
    """K2 at decode (M 4), the prefill step (256), the spec verify (20) and
    on the scattered gate (M 256); with K1's cases at the first three."""
    k1_4, k2_4 = check_k1_k2(torch, timer, 4, gen)
    k1_256, k2_256 = check_k1_k2(torch, timer, 256, gen)
    k1_20, k2_20 = check_k1_k2(torch, timer, 20, gen)
    return [k1_4, k1_256, k1_20], [k2_4, k2_256, k2_20,
                                   check_k2_scattered(torch, timer, 256, gen)]


# the MoE experts' FFNs past K 4096: llama4-scout-17b-a16e's (K 5120, N
# 8192) and mixtral-8x22b's (K 6144, N 16384), at decode and a 64-row chunk
WIDE_FFN_SHAPES = [(5120, 8192, 4), (5120, 8192, 64), (6144, 16384, 4),
                   (6144, 16384, 64)]


def k2_wide_cases(torch, timer, gen):
    """K1, then K2 on the plain version's packed gate, at each of
    WIDE_FFN_SHAPES (KEEP of the gate columns alive, as the experts of the
    serve_moe phase): K2's wide plans (a rank of 10 or 12 K stages, the
    ring landing in groups); no case on an earlier port without them."""
    from repro_torch.kernels import sparse_ffn as sf
    k1s, k2s = [], []
    if not hasattr(sf, "FUSED_FFN_WIDE_SLICES"):
        return k1s, k2s
    for k, n, m in WIDE_FFN_SHAPES:
        k1, inputs = check_k1(torch, timer, m, n, gen, k=k)
        k1s.append(k1)
        k2s.append(check_k2(torch, timer, *inputs))
    return k1s, k2s


# the dense configs' FFNs: llama3-405b's (K 16384, N 53248; K2 past K
# 8192, 16 slices a rank) at decode and a 64-row chunk, deepseek-67b's
# (K 8192, N 22016) at decode
DENSE_FFN_SHAPES = [(16384, 53248, 4), (16384, 53248, 64), (8192, 22016, 4)]


def k2_dense_cases(torch, timer, gen):
    """K1, then K2 on the plain version's packed gate, at each of
    DENSE_FFN_SHAPES (KEEP of the gate columns alive, as serve_dense's
    layers), the weights' std 0.08 scaled by sqrt(2048 / K): h of the
    magnitudes of the K-2048 cases (at 0.08 itself h's one bf16 rounding
    moves y by up to ~0.13 at K 16384, past BF16_TOL where y is near zero:
    ``tests/test_torch_cuda.py:test_fused_ffn_widest_k_matches_plain``
    holds it within that rounding's bound). No case on an earlier port
    without K2 past K 8192. Each shape's weights are freed before the
    next (llama3-405b's W_u, its transpose and W_d are 1.74 GB each)."""
    from repro_torch.kernels import sparse_ffn as sf
    k1s, k2s = [], []
    if not hasattr(sf, "FUSED_FFN_WIDEST_SLICES"):
        return k1s, k2s
    for k, n, m in DENSE_FFN_SHAPES:
        k1, inputs = check_k1(torch, timer, m, n, gen, k=k,
                              scale=0.08 * (2048 / k) ** 0.5)
        k1s.append(k1)
        k2s.append(check_k2(torch, timer, *inputs))
        del inputs
        gc.collect()
        torch.cuda.empty_cache()
    return k1s, k2s


def check_k6(torch, timer, m, gen, keep=KEEP, k=2048, n=8192, act="relu"):
    """K6 at olmo-1b's FFN shape (K 2048, N 8192, T 256, C 8; or rwkv6-7b's
    channel mix, K 4096, N 14336, act relu^2) with ``keep``
    of the W_u columns alive, on the pattern of act(x @ W_u) packed by the
    plain version (the same input for both; counts clipped to T/C as ops
    clips them), the same bits on a second call, timed beside the plain
    version and ``unpack(h) @ W_d`` (the library call), with the host time
    of a call, the union of each row block of the plan's width and the plan
    where the port has one (with a cluster, also the time without one:
    each block then builds its union and scatters h for all its rows
    alone); at KEEP also K1 + K6,
    the non-gated FFN as the serving path runs it, beside the dense
    relu(x @ W_u) @ W_d. keep 1.0 (every column alive): each tile overflows
    its T/C slots, so every row fills all N/C slots and a row block's union
    is near all of N; reported, not held to the library time."""
    from repro_torch.core import twell
    from repro_torch.core.sparsity import activation
    from repro_torch.kernels import sparse_ffn as sf
    from repro_torch.kernels.sparse_ffn import (twell_down_proj_cuda,
                                                twell_down_proj_plain)
    from repro_torch.kernels.twell_pack import (twell_gate_matmul_cuda,
                                                twell_gate_matmul_plain)
    t, c = 256, 8
    tc = t // c
    if keep == KEEP:
        # gate_inputs' KEEP-masked gate weight stands in for olmo's W_u (its
        # real W_u, dense, is dropped): relu(x @ wg) is then as sparse as
        # the up projection of the serve_olmo phase
        x, wg, _, wd = gate_inputs(torch, m, k, n, gen)
    else:
        x = (torch.randn((m, k), generator=gen, device="cuda") * 0.5
             ).bfloat16()
        wg, wd = ((torch.randn(shape, generator=gen, device="cuda") * 0.08)
                  .bfloat16() for shape in ((k, n), (n, k)))
    v, i, z = twell_gate_matmul_plain(x, wg, t, c, act)
    overflow = bool((z > tc).any())
    assert overflow == (keep == 1.0), f"K6 inputs overflow T/C (M={m})"
    z = torch.clamp(z, max=tc)
    args = (v, i, z, wd, t)
    case = f"M={m}, K={k}, N={n}, {act}, keep {keep}"
    y = twell_down_proj_cuda(*args)
    shape_agrees(torch, "twell_down_proj", y, *args)
    py = twell_down_proj_plain(*args)
    torch.cuda.synchronize()
    err, ok = close_err(torch, y, py)
    assert ok, f"K6 disagrees with the plain version ({case}): {err}"
    assert torch.equal(y, twell_down_proj_cuda(*args)), \
        f"K6 is not run-to-run deterministic ({case})"
    tw = twell.TwellActs(v, i, z, torch.tensor(overflow), t, c, n)
    valid = twell.slot_valid(tw)
    slots = int(valid.sum())
    rows = int(torch.unique(i[valid]).numel())
    # the W_d rows the pattern names, the valid slots' values and indices,
    # the counts, and the float32 y; 2 K flops per valid slot
    nbytes = rows * k * 2 + prefix_bytes(z, 2) + prefix_bytes(z, 4) + \
        m * n // t * 4 + 4 * m * k
    bnd, by = bound_ms(nbytes, 2 * slots * k)
    h = twell.unpack(tw)

    def k6():
        return twell_down_proj_cuda(*args)
    plan, width = None, 64
    if hasattr(sf, "down_proj_plan"):     # an earlier version has no plan
        p = sf.down_proj_plan(m, k, n, t, c, torch.cuda.get_device_properties(
            0).multi_processor_count)
        width = p.width
        plan = {"width": p.width, "row_blocks": p.row_blocks,
                "col_blocks": p.col_blocks, "ks": p.ks, "slices": p.slices,
                "h_chunks": p.h_chunks, "ring": p.stages, "smem": p.smem,
                "split": p.split, "other_union_ms": None}
        if p.ks > 1:
            # each block alone (no cluster: its own union and all its rows
            # of h): the same bits, timed
            default = sf.down_proj_plan
            sf.down_proj_plan = lambda *a, _p=dataclasses.replace(
                p, ks=1): _p
            try:
                assert torch.equal(y, k6()), "K6's union ways disagree"
                plan["other_union_ms"] = timer.ms(k6)
            finally:
                sf.down_proj_plan = default
    unions = [int(torch.unique(i[r0:r0 + width][valid[r0:r0 + width]])
                  .numel()) for r0 in range(0, m, width)]
    out = {"ms": timer.ms(k6),
           "plain_ms": timer.ms(lambda: twell_down_proj_plain(*args),
                                iters=5),
           "library_ms": timer.ms(lambda: torch.matmul(h, wd)),
           "host_us": host_us(torch, k6),
           "library_host_us": host_us(torch, lambda: torch.matmul(h, wd)),
           "bound_ms": bnd, "bound_by": by, "max_abs_err": err, "M": m,
           "K": k, "N": n, "act": act, "keep": keep, "overflow": overflow,
           "valid_slots_per_row": slots / m, "distinct_rows": rows,
           "union_per_row_block": unions, "plan": plan}
    if keep == KEEP:
        def k1_k6():
            pv, pi, pz = twell_gate_matmul_cuda(x, wg, t, c, act)
            return twell_down_proj_cuda(pv, pi, torch.clamp(pz, max=tc), wd,
                                        t)
        out["k1_k6_ms"] = timer.ms(k1_k6)
        out["dense_ffn_ms"] = timer.ms(lambda: torch.matmul(
            activation(act)(torch.matmul(x, wg)), wd))
    return out


def ssm_cases(torch, timer):
    """The attention-free families' serving shapes at decode (M 4), on a
    generator of their own (the kernels timed before see the inputs they
    saw before these were added): K1 with relu^2 and K6 at rwkv6-7b's
    channel mix (K 4096, N 14336), K1 then K2 at zamba2-1.2b's shared FFN
    (K 2048, N 8192), each with KEEP of its pattern's columns alive."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    k1_rwkv, _ = check_k1(torch, timer, 4, 14336, gen, k=4096, act="relu2")
    k6_rwkv = check_k6(torch, timer, 4, gen, k=4096, n=14336, act="relu2")
    k1_zamba, inputs = check_k1(torch, timer, 4, 8192, gen)
    k2_zamba = check_k2(torch, timer, *inputs)
    tag = {"arch": "rwkv6-7b"}
    return {"twell_gate_matmul": [{**k1_rwkv, **tag},
                                  {**k1_zamba, "arch": "zamba2-1.2b"}],
            "twell_down_proj": [{**k6_rwkv, **tag}],
            "twell_fused_ffn": [{**k2_zamba, "arch": "zamba2-1.2b"}]}


def xattn_cases(torch, timer):
    """The cross-attention families' shapes, on a generator of their own
    (the kernels timed before see the inputs they saw before these were
    added): K1, then K6, at whisper-large-v3's FFN (K 1280, N 5120) at
    decode (M 4) and over the encoder's rows of a 4-request batch (M 4 x
    1500 = 6000); K1 then K2 at llama-3.2-vision-11b's (K 4096, N 14336)
    at decode; each with KEEP of its pattern's columns alive; K7 at
    whisper's training step, 20 heads of 64."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    k1s, k6s = [], []
    for m in (4, 4 * XATTN_FRAMES):
        k1, _ = check_k1(torch, timer, m, 5120, gen, k=1280)
        k1s.append({**k1, "arch": "whisper-large-v3"})
        k6 = check_k6(torch, timer, m, gen, k=1280, n=5120)
        k6s.append({**k6, "arch": "whisper-large-v3"})
    k1_vis, inputs = check_k1(torch, timer, 4, 14336, gen, k=4096)
    k2_vis = check_k2(torch, timer, *inputs)
    del inputs
    k7 = check_k7(torch, timer, TRAIN_BATCH, TRAIN_SEQ, 20, 64, gen)
    tag = {"arch": "llama-3.2-vision-11b"}
    return {"twell_gate_matmul": k1s + [{**k1_vis, **tag}],
            "twell_down_proj": k6s,
            "twell_fused_ffn": [{**k2_vis, **tag}],
            "flash_attention": [{**k7, "arch": "whisper-large-v3"}]}


def k6_cases(torch, timer, gen):
    """K6 at olmo-1b's decode (M 4) and prefill step (M 256), then on a
    pattern with every column alive (M 256; its own generator, so the
    kernels timed after it see the inputs they saw before it was added)."""
    scattered = torch.Generator(device="cuda").manual_seed(SEED + 6)
    return [check_k6(torch, timer, 4, gen), check_k6(torch, timer, 256, gen),
            check_k6(torch, timer, 256, scattered, keep=1.0)]


def check_k5(torch, timer, m, threshold, gen, n=5632):
    """K5 on the main path's FFN shape (or a rank's ``n`` columns of it
    under tensor parallelism), with the W_g columns of half the tiles (11
    of the 22) zeroed (dead for every row) so the skip branch runs on the
    card.
    ``threshold`` None takes the median row-tile gate maximum of the live
    tiles, so the threshold drops about half of them. Beside the times: the
    host time of a call (and of ``x @ W_g``) and the launch plan. Each of
    the two kernels' device time from a profiled call is added later, by
    ``k5_splits``."""
    from repro_torch.kernels import sparse_ffn as sf
    from repro_torch.kernels.sparse_ffn import (tile_skip_ffn_cuda,
                                                tile_skip_ffn_plain)
    k, t = 2048, 256
    nt = n // t
    x, wg, wu, wd = gate_inputs(torch, m, k, n, gen)
    dead = torch.randperm(nt, generator=gen, device="cuda")[:nt // 2]
    wg.view(k, nt, t)[:, dead] = 0
    g = torch.relu(x.float() @ wg.float())
    gmax = g.reshape(m, nt, t).amax(-1)
    if threshold is None:
        threshold = float(gmax[gmax > 0].median())
    rb = -(-m // 32)
    flags = torch.empty((rb, nt), dtype=torch.int32, device="cuda")
    y, h = tile_skip_ffn_cuda(x, wg, wu, wd, t, "relu", threshold,
                              cell_active=flags)
    shape_agrees(torch, "tile_skip_ffn", (y, h), x, wg, wu, wd, t, "relu",
                 threshold)
    py, ph = tile_skip_ffn_plain(x, wg, wu, wd, t, "relu", threshold)
    torch.cuda.synchronize()
    # a row whose tile maximum lies within 1% of the threshold (or, at 0,
    # within 1e-3 max of zero) may be kept or dropped by either side
    near = (gmax - threshold).abs() <= 1e-2 * threshold if threshold else \
        (gmax > 0) & (gmax <= 1e-3 * gmax.max())
    rows = ~near.any(-1)
    err_y, ok_y = close_err(torch, y[rows], py[rows])
    err_h, ok_h = close_err(torch, h[rows], ph[rows])
    assert ok_y and ok_h, \
        f"K5 disagrees with the plain version (M={m}): {err_y} {err_h}"
    y2, _ = tile_skip_ffn_cuda(x, wg, wu, wd, t, "relu", threshold)
    assert torch.equal(y, y2), "K5 is not run-to-run deterministic"
    assert not bool(flags[:, dead].any()), "K5 ran a dead tile"
    keep = gmax > threshold                                   # (M, nT)
    skipped = 1.0 - float(flags.float().mean())
    tiles = int(flags.any(0).sum())        # tiles some active cell needs
    kept_pairs = int(keep.sum())
    nbytes = 2 * m * k + 2 * k * n + tiles * 2 * (2 * k * t) + \
        4 * m * k + 2 * m * n
    bnd, by = bound_ms(nbytes, 2 * m * k * n + kept_pairs * 4 * k * t)

    def k5():
        return tile_skip_ffn_cuda(x, wg, wu, wd, t, "relu", threshold)

    def dense_ffn():
        return torch.matmul(torch.matmul(x, wu) * torch.relu(
            torch.matmul(x, wg)), wd)

    res = {"ms": timer.ms(k5),
           "plain_ms": timer.ms(lambda: tile_skip_ffn_plain(
               x, wg, wu, wd, t, "relu", threshold), iters=5),
           "library_ms": timer.ms(dense_ffn),
           "bound_ms": bnd, "bound_by": by,
           "max_abs_err": max(err_y, err_h), "M": m, "N": n,
           "threshold": threshold, "dead_tiles": nt // 2,
           "cells": rb * nt, "skipped_share": skipped,
           "tiles_read": tiles, "kept_row_tiles": kept_pairs,
           "near_threshold_rows": int((~rows).sum()),
           "host_us": host_us(torch, k5),
           "x_wg_host_us": host_us(torch, lambda: torch.matmul(x, wg))}
    if hasattr(sf, "tile_skip_plan"):
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        plan = sf.tile_skip_plan(m, k, n, t, sms)
        res["plan"] = {"n": plan.width, "ks": plan.ks, "ring": plan.stages,
                       "g_rows": plan.g_rows, "per_sm": plan.per_sm,
                       "down_cols": plan.cols, "down_ks": plan.ks_down,
                       "down_ring": plan.stages_down}
    K5_SPLITS.append((res, timer, k5))
    return res


# (case record, timer, call) of every K5 case, profiled by k5_splits
K5_SPLITS = []


def k5_splits(torch):
    """Each K5 case's up and down kernels' device times from a profiled
    call, added to its record. Run after the main path: once
    torch.profiler has traced the card, later launches cost more host
    time (a serve phase run after it took 50% longer a step), so no phase
    of the main path may follow it. The down kernel is a programmatic
    dependent of the up kernel, as the path launches it, so its device
    time includes its wait for the up grid."""
    for res, timer, k5 in K5_SPLITS:
        split = kernel_split(torch, timer, k5)
        for part in ("up", "down"):
            got = [v for kname, v in split.items()
                   if f"{part}_kernel" in kname]
            launches = sum(n for _, n in got)
            res[f"{part}_ms"] = (sum(ms * n for ms, n in got) / launches
                                 if launches else None)
            res[f"{part}_launches"] = launches
    K5_SPLITS.clear()


def kernel_split(torch, timer, fn, calls=5):
    """{kernel name: (mean device ms a launch, launches recorded)} over
    ``calls`` calls of ``fn`` under torch.profiler, the L2 flushed before
    each (the flush is left out). The tracer may record fewer launches
    than were made, so the mean is over those it recorded."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            timer.flush_buf.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA") or "fill" in evt.key:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if evt.count:
            out[evt.key] = (us / 1e3 / evt.count, evt.count)
    return out


def paged_inputs(torch, gen, b, hkv, hd, bs, width):
    n = 1 + b * width
    kpool = torch.randn((n, bs, hkv, hd), generator=gen,
                        device="cuda").bfloat16()
    vpool = torch.randn((n, bs, hkv, hd), generator=gen,
                        device="cuda").bfloat16()
    perm = torch.randperm(n - 1, generator=gen, device="cuda") + 1
    bt = perm[:b * width].reshape(b, width).int().contiguous()
    return kpool, vpool, bt


def gathered(torch, pool, bt, h):
    from repro_torch.kernels.paged_decode_attention import gather_pages
    return gather_pages(pool, bt, h).transpose(1, 2).contiguous()


def check_k3(torch, timer, h, hkv, gen, hd=64):
    import torch.nn.functional as F
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention_cuda, paged_decode_attention_plain)
    b, bs, width = 4, 16, 64
    sl_list = [1000, 517, 33, 700]
    kpool, vpool, bt = paged_inputs(torch, gen, b, hkv, hd, bs, width)
    sl = torch.tensor(sl_list, dtype=torch.int32, device="cuda")
    q = torch.randn((b, 1, h, hd), generator=gen, device="cuda").bfloat16()
    o = paged_decode_attention_cuda(q, kpool, vpool, bt, sl)
    shape_agrees(torch, "paged_decode_attention", o, q, kpool, vpool, bt, sl)
    po = paged_decode_attention_plain(q, kpool, vpool, bt, sl)
    torch.cuda.synchronize()
    err, ok = close_err(torch, o, po)
    assert ok, f"K3 disagrees with the plain version (H={h}, Hkv={hkv}): {err}"
    assert torch.equal(o, paged_decode_attention_cuda(q, kpool, vpool, bt,
                                                      sl)), \
        "K3 gave other bits on the same inputs"
    pages = sum(s // bs + 1 for s in sl_list)
    nbytes = 2 * (2 * b * h * hd) + pages * bs * hkv * hd * 2 * 2
    bnd, by = bound_ms(nbytes, 4 * h * hd * sum(s + 1 for s in sl_list))
    kf, vf = gathered(torch, kpool, bt, h), gathered(torch, vpool, bt, h)
    kpos = torch.arange(width * bs, device="cuda")
    mask = (kpos[None, :] <= sl[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)

    def k3():
        return paged_decode_attention_cuda(q, kpool, vpool, bt, sl)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kf, vf, attn_mask=mask)
    one_key = torch.zeros_like(sl)
    return {"ms": timer.ms(k3),
            # every request at one live key (one tile, one rank): the
            # fixed cost of a call
            "one_tile_ms": timer.ms(lambda: paged_decode_attention_cuda(
                q, kpool, vpool, bt, one_key)),
            "plain_ms": timer.ms(lambda: paged_decode_attention_plain(
                q, kpool, vpool, bt, sl), iters=5),
            "library_ms": timer.ms(sdpa),
            "host_us": host_us(torch, k3),
            "library_host_us": host_us(torch, sdpa),
            "bound_ms": bnd, "bound_by": by, "max_abs_err": err,
            "H": h, "Hkv": hkv, "hd": hd, "seq_lens": sl_list}


def check_k4(torch, timer, h, hkv, gen, hd=64):
    import torch.nn.functional as F
    from repro_torch.kernels.paged_chunk_attention import (
        paged_chunk_attention_cuda, paged_chunk_attention_plain)
    b, s, bs, width = 4, 64, 16, 64
    sl_list, nn_list = [900, 448, 300, 0], [64, 40, 64, 0]
    kpool, vpool, bt = paged_inputs(torch, gen, b, hkv, hd, bs, width)
    sl = torch.tensor(sl_list, dtype=torch.int32, device="cuda")
    nn = torch.tensor(nn_list, dtype=torch.int32, device="cuda")
    q = torch.randn((b, s, h, hd), generator=gen, device="cuda").bfloat16()
    o = paged_chunk_attention_cuda(q, kpool, vpool, bt, sl, nn)
    shape_agrees(torch, "paged_chunk_attention", o, q, kpool, vpool, bt, sl,
                 nn)
    po = paged_chunk_attention_plain(q, kpool, vpool, bt, sl, nn)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(o.float()).all()), "K4 produced non-finite rows"
    assert float(o[3].float().abs().max()) == 0.0, \
        "K4: a padded row (num_new = 0, empty history) must be exactly zero"
    valid = (torch.arange(s, device="cuda")[None, :] < nn[:, None])
    err, ok = close_err(torch, o, po, valid[:, :, None, None].expand_as(o))
    assert ok, f"K4 disagrees with the plain version (H={h}, Hkv={hkv}): {err}"
    assert torch.equal(o, paged_chunk_attention_cuda(q, kpool, vpool, bt, sl,
                                                     nn)), \
        "K4 is not run-to-run deterministic"
    pages = sum((sl_ + nn_ - 1) // bs + 1 for sl_, nn_ in zip(sl_list, nn_list)
                if nn_ > 0)
    keys = sum(sl_ + i + 1 for sl_, nn_ in zip(sl_list, nn_list)
               for i in range(nn_))
    nbytes = 2 * (2 * b * s * h * hd) + pages * bs * hkv * hd * 2 * 2
    bnd, by = bound_ms(nbytes, 4 * h * hd * keys)
    kf, vf = gathered(torch, kpool, bt, h), gathered(torch, vpool, bt, h)
    pos = sl[:, None] + torch.arange(s, device="cuda")[None, :]
    kpos = torch.arange(width * bs, device="cuda")
    mask = (kpos[None, None, :] <= pos[:, :, None])[:, None]
    qt = q.transpose(1, 2)
    return {"ms": timer.ms(lambda: paged_chunk_attention_cuda(
                q, kpool, vpool, bt, sl, nn)),
            "plain_ms": timer.ms(lambda: paged_chunk_attention_plain(
                q, kpool, vpool, bt, sl, nn), iters=5),
            "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                qt, kf, vf, attn_mask=mask)),
            "bound_ms": bnd, "bound_by": by, "max_abs_err": err,
            "H": h, "Hkv": hkv, "hd": hd, "chunk": s, "seq_lens": sl_list,
            "num_new": nn_list}


def check_k7(torch, timer, b, s, h, hd, gen):
    """K7 at the training forward's attention shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    q, k, v = (torch.randn((b, s, h, hd), generator=gen,
                           device="cuda").bfloat16() for _ in range(3))
    o = flash_attention_cuda(q, k, v)
    shape_agrees(torch, "flash_attention", o, q, k, v)
    po = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    err, ok = close_err(torch, o, po)
    assert ok, f"K7 disagrees with the plain version (B={b}, S={s}): {err}"
    assert torch.equal(o, flash_attention_cuda(q, k, v)), \
        "K7 is not run-to-run deterministic"
    # q, k, v read once, o written once; QK^T and PV over the causal pairs
    bnd, by = bound_ms(4 * b * s * h * hd * 2,
                       4 * hd * b * h * s * (s + 1) // 2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return {"ms": timer.ms(lambda: flash_attention_cuda(q, k, v)),
            "plain_ms": timer.ms(lambda: flash_attention_plain(q, k, v),
                                 iters=3),
            "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)),
            "bound_ms": bnd, "bound_by": by, "max_abs_err": err,
            "B": b, "S": s, "H": h, "hd": hd}


def k7_cases(torch, timer, gen):
    """K7 at the train phase's batch (paper-0.5b: 32 heads of 64), one
    4096-token row, olmo-1b's training shape (16 heads of 128), and the
    train_dense phase's: phi3-mini-3.8b's 32 heads of 96 (padded to 128)
    and deepseek-67b's 64 of 128."""
    return [check_k7(torch, timer, TRAIN_BATCH, TRAIN_SEQ, 32, 64, gen),
            check_k7(torch, timer, 1, 4096, 32, 64, gen),
            check_k7(torch, timer, TRAIN_BATCH, TRAIN_SEQ, 16, 128, gen),
            check_k7(torch, timer, TRAIN_BATCH, TRAIN_SEQ, 32, 96, gen),
            check_k7(torch, timer, TRAIN_BATCH, TRAIN_SEQ, 64, 128, gen)]


# (H, Hkv, hd) of K3's and K4's cases: paper-0.5b MHA and GQA 32/8 at hd
# 64, olmo-1b's 16 heads of 128, phi3-mini-3.8b's 32 of 96, deepseek-67b's
# 64 over 8 KV heads of 128 (G 8) and llama3-405b's 128 over 8 (G 16)
ATTN_CASES = [(32, 32, 64), (32, 8, 64), (16, 16, 128), (32, 32, 96),
              (64, 8, 128), (128, 8, 128)]


def hybrid_inputs(torch, gen, n=5632, scattered=True, k=2048):
    """The train phase's FFN at full width (M = 8192 tokens, K 2048, N
    5632, ELL width 128, backup M/8) with TRAIN_ALIVE gate columns alive:
    x, the packed gate hg (its pattern), W_u, W_d, a gradient gy, and a
    pattern hs scattered over all N columns (None without ``scattered``).
    With N 8192 the same for olmo-1b's non-gated FFN, hg then the packed
    relu(x @ W_u) with TRAIN_ALIVE columns of W_u alive; with (K, N) a
    dense config's FFN (deepseek-67b's (8192, 22016), llama3-405b's
    (16384, 53248)) on the same pattern."""
    from repro_torch.core import hybrid as hyb
    m = TRAIN_BATCH * TRAIN_SEQ
    x = (torch.randn((m, k), generator=gen, device="cuda")).bfloat16()
    wg = (torch.randn((k, n), generator=gen, device="cuda") * 0.02
          * alive_columns(torch, gen, n)).bfloat16()
    wu = (torch.randn((k, n), generator=gen, device="cuda") * 0.02).bfloat16()
    wd = (torch.randn((n, k), generator=gen, device="cuda") * 0.02).bfloat16()
    gy = (torch.randn((m, k), generator=gen, device="cuda") * 1e-3).bfloat16()
    g = torch.relu(x @ wg)
    hg = hyb.pack(g, 128, m // 8, mask=g > 0)
    assert not bool(hg.overflow), "the K8/K9 inputs overflow the backup"
    if not scattered:
        return x, hg, wu, wd, gy, None
    # K9's worst case: each row's columns drawn independently over all N,
    # ~108 a row (as many as hg's), so a 128-row block's union is near N
    scat = torch.rand((m, n), generator=gen, device="cuda") < 108 / n
    hs = hyb.pack(scat.bfloat16(), 128, m // 8, mask=scat)
    assert not bool(hs.overflow), "the scattered pattern overflows"
    return x, hg, wu, wd, gy, hs


def alive_columns(torch, gen, n):
    """(n,) float mask with exactly TRAIN_ALIVE ones at random columns."""
    mask = torch.zeros((n,), device="cuda")
    mask[torch.randperm(n, generator=gen, device="cuda")[:TRAIN_ALIVE]] = 1
    return mask


def hybrid_work(torch, hy, k, val_bytes, w_bytes=2):
    """(valid slots, bytes every ELL-side call reads in its pattern and W
    rows) for the pattern of ``hy``: each row's valid prefix of values and
    indices, the row counts and flags, the W rows the pattern names."""
    live = ~hy.is_dense
    slot = torch.arange(hy.ell_width, device="cuda")
    valid = (slot[None] < hy.row_nnz[:, None]) & live[:, None]
    slots = int(valid.sum())
    rows = int(torch.unique(hy.ell_indices[valid]).numel())
    m = hy.ell_indices.shape[0]
    counts = valid.sum(-1)
    return slots, (prefix_bytes(counts, val_bytes) + prefix_bytes(counts, 4)
                   + m * 5 + rows * k * w_bytes)


def check_k8(torch, timer, inputs, orient, pattern="alive"):
    """K8, y = h @ W on the ELL side: forward h (bf16 values) @ W_d,
    backward a gradient on h's pattern (float32 values bf16 cannot hold,
    as the hybrid backward passes them) @ W_u^T; on the train phase's
    pattern or the scattered one. With the host time of a call beside the
    library call's and the mean union of a 128-row block."""
    from repro_torch.core import hybrid as hyb
    from repro_torch.kernels import hybrid_matmul as hm
    from repro_torch.kernels.hybrid_matmul import (hybrid_to_dense_cuda,
                                                   hybrid_to_dense_plain)
    x, hg, wu, wd, _, hs = inputs
    hy = hg if pattern == "alive" else hs
    if orient == "forward":
        vals, w = hy.ell_values, wd
    else:
        vals, w = hy.ell_values.float() / 3, wu.t().contiguous()
    args = (vals, hy.ell_indices, hy.row_nnz, ~hy.is_dense, w)
    y = hybrid_to_dense_cuda(*args)
    shape_agrees(torch, "hybrid_to_dense", y, *args)
    py = hybrid_to_dense_plain(*args)
    torch.cuda.synchronize()
    err, ok = close_err(torch, y, py)
    assert ok, f"K8 ({orient}, {pattern}) disagrees with the plain " \
        f"version: {err}"
    assert torch.equal(y, hybrid_to_dense_cuda(*args)), \
        "K8 is not run-to-run deterministic"
    m, k = y.shape
    slots, read = hybrid_work(torch, hy, k, vals.element_size())
    bnd, by = bound_ms(read + 4 * m * k, 2 * slots * k)
    dense_h = hyb.unpack(hy._replace(ell_values=vals.to(w.dtype))).to(w.dtype)

    def k8():
        return hybrid_to_dense_cuda(*args)

    def lib():
        return torch.matmul(dense_h, w)
    plan = None
    if hasattr(hm, "h2d_plan"):         # an earlier version has no plan
        p = hm.h2d_plan(m, k, w.shape[0], hy.ell_width,
                        torch.cuda.get_device_properties(0)
                        .multi_processor_count, vals.element_size() // 2)
        plan = {"splits": p.splits, "ring": p.stages, "tile_cols": p.cols,
                "smem": p.smem, "wide_maps": getattr(p, "wide", False)}
    return {"ms": timer.ms(k8),
            "plain_ms": timer.ms(lambda: hybrid_to_dense_plain(*args),
                                 iters=3),
            "library_ms": timer.ms(lib),
            "host_us": host_us(torch, k8),
            "library_host_us": host_us(torch, lib),
            "bound_ms": bnd, "bound_by": by, "max_abs_err": err,
            "orient": orient, "pattern": pattern, "M": m,
            "E": hy.ell_width, "K": k, "values": str(vals.dtype),
            "plan": plan,
            "valid_slots_per_row": slots / m,
            "union_per_128_rows": float(union_sizes(torch, hy).float()
                                        .mean()),
            "backup_rows": int(hy.is_dense.sum())}


def check_k8_f32(torch, inputs, rows=1024):
    """K8 on an f32 W (the per-row kernel of the float32 gradient checks):
    against the plain version, and a digest of its output's bits, to hold
    against an earlier version's from the same call."""
    from repro_torch.kernels.hybrid_matmul import (hybrid_to_dense_cuda,
                                                   hybrid_to_dense_plain)
    _, hg, _, wd, _, _ = inputs
    args = (hg.ell_values[:rows].float() / 3, hg.ell_indices[:rows],
            hg.row_nnz[:rows], ~hg.is_dense[:rows], wd.float())
    y = hybrid_to_dense_cuda(*args)
    err, ok = close_err(torch, y, hybrid_to_dense_plain(*args))
    assert ok, f"K8 (f32 W) disagrees with the plain version: {err}"
    digest = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]
    return {"orient": "f32_w", "M": rows, "max_abs_err": err,
            "digest": digest}


def k8_cases(torch, timer, inputs):
    """K8 forward and backward on the train phase's pattern, forward on the
    scattered one (a union near N: the tile in chunks), then on an f32 W."""
    return [check_k8(torch, timer, inputs, "forward"),
            check_k8(torch, timer, inputs, "backward"),
            check_k8(torch, timer, inputs, "forward", "scattered"),
            check_k8_f32(torch, inputs)]


def union_sizes(torch, hy, rows=128):
    """The columns of the union of each ``rows``-row block's valid slots
    (K9's bf16 kernel computes a block's rows against that union)."""
    m, e = hy.ell_indices.shape
    slot = torch.arange(e, device=hy.ell_indices.device)
    valid = (slot[None] < hy.row_nnz[:, None]) & ~hy.is_dense[:, None]
    block = (torch.arange(m, device=valid.device) // rows)[:, None]
    hit = torch.zeros((-(-m // rows), hy.n), dtype=torch.bool,
                      device=valid.device)
    hit[block.expand(m, e)[valid], hy.ell_indices[valid].long()] = True
    return hit.sum(1)


def check_k9(torch, timer, inputs, orient, pattern="alive"):
    """K9, the SDDMM on the pattern: forward h_u = (x @ W_u)[pattern] (W_u^T
    read by rows), backward grad_h = (gy @ W_d^T)[pattern] (W_d read by
    rows); on the train phase's pattern (TRAIN_ALIVE columns alive) or the
    scattered one. With the host time of a call beside ``x @ W``'s, the
    mean union of a 128-row block and a digest of the output's bits (to
    hold against an earlier version's from the same call)."""
    from repro_torch.kernels import hybrid_matmul as hm
    from repro_torch.kernels.hybrid_matmul import (dense_to_hybrid_cuda,
                                                   dense_to_hybrid_plain)
    x, hg, wu, wd, gy, hs = inputs
    hy = hg if pattern == "alive" else hs
    a, wt = (x, wu.t().contiguous()) if orient == "forward" else (gy, wd)
    args = (a, wt, hy.ell_indices, hy.row_nnz, ~hy.is_dense)
    v = dense_to_hybrid_cuda(*args)
    shape_agrees(torch, "dense_to_hybrid", v, *args)
    pv = dense_to_hybrid_plain(*args)
    torch.cuda.synchronize()
    err, ok = close_err(torch, v, pv)
    assert ok, f"K9 ({orient}, {pattern}) disagrees with the plain " \
        f"version: {err}"
    assert torch.equal(v, dense_to_hybrid_cuda(*args)), \
        "K9 is not run-to-run deterministic"
    digest = hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()[:16]
    m, k = a.shape
    slots, read = hybrid_work(torch, hy, k, 0)
    bnd, by = bound_ms(read + 2 * m * k + 4 * m * hy.ell_width,
                       2 * slots * k)
    w = wt.t()

    def k9():
        return dense_to_hybrid_cuda(*args)

    def lib():
        return torch.matmul(a, w)
    p = hm.d2h_plan(m, k, wt.shape[0], hy.ell_width,
                    torch.cuda.get_device_properties(0).multi_processor_count)
    plan = {"splits": p.splits, "ring": p.stages, "smem": p.smem,
            "wide_maps": getattr(p, "wide", False)}
    return {"ms": timer.ms(k9),
            "plain_ms": timer.ms(lambda: dense_to_hybrid_plain(*args),
                                 iters=3),
            "library_ms": timer.ms(lib),
            "host_us": host_us(torch, k9),
            "library_host_us": host_us(torch, lib),
            "bound_ms": bnd, "bound_by": by, "max_abs_err": err,
            "orient": orient, "pattern": pattern, "M": m,
            "E": hy.ell_width, "K": k,
            "valid_slots_per_row": slots / m,
            "union_per_128_rows": float(union_sizes(torch, hy).float()
                                        .mean()),
            "backup_rows": int(hy.is_dense.sum()), "digest": digest,
            "plan": plan}


def k9_cases(torch, timer, inputs):
    """K9 forward and backward on the train phase's pattern, then forward
    on the scattered one (the design's worst case)."""
    return [check_k9(torch, timer, inputs, "forward"),
            check_k9(torch, timer, inputs, "backward"),
            check_k9(torch, timer, inputs, "forward", "scattered")]


KERNELS = {
    "twell_gate_matmul": ("src/repro_torch/kernels/csrc/twell_pack.cu",
                          "src/repro/kernels/twell_pack.py:61"),
    "twell_fused_ffn": ("src/repro_torch/kernels/csrc/twell_fused_ffn.cu",
                        "src/repro/kernels/sparse_ffn.py:50"),
    "twell_down_proj": ("src/repro_torch/kernels/csrc/twell_down_proj.cu",
                        "src/repro/kernels/sparse_ffn.py:105"),
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        "src/repro/kernels/paged_decode_attention.py:77"),
    "paged_chunk_attention": (
        "src/repro_torch/kernels/csrc/paged_chunk_attention.cu",
        "src/repro/kernels/paged_chunk_attention.py:78"),
    "tile_skip_ffn": ("src/repro_torch/kernels/csrc/tile_skip_ffn.cu",
                      "src/repro/kernels/sparse_ffn.py:159"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:58"),
    "hybrid_to_dense": ("src/repro_torch/kernels/csrc/hybrid_matmul.cu",
                        "src/repro/kernels/hybrid_matmul.py:48"),
    "dense_to_hybrid": ("src/repro_torch/kernels/csrc/hybrid_matmul.cu",
                        "src/repro/kernels/hybrid_matmul.py:101"),
}


# K1's timed shapes, (N, M): paper-0.5b's W_g at decode (4), the 256-row
# prefill step, the spec verify (4 requests x 5 tokens = 20) and 64 rows;
# olmo-1b's W_u (N 8192) at decode and prefill
K1_SHAPES = [(5632, 4), (5632, 256), (5632, 20), (5632, 64), (8192, 4),
             (8192, 256)]


def k1_plan_variants(tp, m, k, n, t, sms):
    """gate_plan's plan first, then every cluster size 1..8 (at most the K
    stages) x rows a block (the plan's width; 64 and 128 above 64 rows) x
    ring depth (3, and as deep as the rank's K loop within the shared
    memory)."""
    base = tp.gate_plan(m, k, n, t, sms)
    yield base
    widths = sorted({base.width} | ({64, 128} if m > 64 else set()))
    for w in widths:
        rb = -(-m // w)
        fit = (tp.SMEM_BYTES - 1024) // (tp.stage_bytes(t, w) + 16)
        for ks in range(1, min(tp.MAX_KS, base.k_stages) + 1):
            deep = min(max(tp.MIN_STAGES, -(-base.k_stages // ks)), fit)
            for st in sorted({tp.MIN_STAGES, deep}):
                plan = tp.GatePlan(w, rb, ks, st, base.k_stages,
                                   (n // t * ks, rb))
                if plan != base:
                    yield plan


def phase_k1_plans(torch):
    """K1 at each of K1_SHAPES under each of ``k1_plan_variants``: held by
    ``k1_agrees``, timed, with the runtime's count of the clusters the card
    holds at once (cudaOccupancyMaxActiveClusters). Then the fixed cost of a call: K1 and ``x @ W`` at one
    K stage (M 4, K 64, N 5632), and the Timer around no work."""
    from repro_torch.kernels import twell_pack as tp
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    timer = Timer(torch)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    default = tp.gate_plan
    k, t, c = 2048, 256, 8
    rows = []
    for n, m in K1_SHAPES:
        x, wg, _, _ = gate_inputs(torch, m, k, n, gen)
        base = default(m, k, n, t, sms)
        for plan in list(k1_plan_variants(tp, m, k, n, t, sms)):
            tp.gate_plan = lambda *a, _p=plan: _p
            try:
                k1_agrees(torch, x, wg, t, c, f"M={m}, N={n}, {plan}")
                ms = timer.ms(lambda: tp.twell_gate_matmul_cuda(x, wg, t, c))
            finally:
                tp.gate_plan = default
            rows.append({
                "M": m, "N": n, "width": plan.width, "ks": plan.ks,
                "stages": plan.stages, "blocks": plan.blocks,
                "clusters": plan.blocks // plan.ks,
                "resident": tp.gate_resident_clusters(t, plan),
                "default": plan == base, "ms": ms})
    x, wg, _, _ = gate_inputs(torch, 4, 64, 5632, gen)
    floor = {"M": 4, "K": 64, "N": 5632,
             "ms": timer.ms(lambda: tp.twell_gate_matmul_cuda(x, wg, t, c)),
             "library_ms": timer.ms(lambda: torch.matmul(x, wg)),
             "empty_ms": timer.ms(lambda: None)}
    emit({"phase": "k1_plans", "cases": rows, "floor": floor})


def phase_kernels(torch, only=None):
    """One entry per kernel: the top-level numbers at the shape the main
    path runs most (decode: M = 4 for K1/K2, K3, K5 and K6, K5 with a
    threshold as the drafts run it, K3 MHA first, then GQA and olmo-1b's 16
    heads of 128; the 64-token prefill chunk for K4, in the same order; the
    train phase's batch for K7, K8 and K9, K8/K9 in their forward
    orientation on the train phase's pattern); every measured case under
    "cases". ``only``: just those kernels (A/B timing)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    timer = Timer(torch)
    if only is not None:
        checks = {
            "twell_gate_matmul": lambda: [
                check_k1(torch, timer, m, n, gen)[0]
                for n, m in K1_SHAPES] +
            ssm_cases(torch, timer)["twell_gate_matmul"] +
            xattn_cases(torch, timer)["twell_gate_matmul"],
            "paged_chunk_attention": lambda: [
                check_k4(torch, timer, h, hkv, gen, hd=hd)
                for h, hkv, hd in ATTN_CASES],
            "flash_attention": lambda: k7_cases(torch, timer, gen) +
            xattn_cases(torch, timer)["flash_attention"],
            "tile_skip_ffn": lambda: k5_cases(torch, timer, gen),
            "paged_decode_attention": lambda: [
                check_k3(torch, timer, h, hkv, gen, hd=hd)
                for h, hkv, hd in ATTN_CASES],
            "dense_to_hybrid": lambda: k9_cases(
                torch, timer, hybrid_inputs(torch, gen)) +
            hybrid_dense_cases(torch, timer, gen, k8=False)[
                "dense_to_hybrid"],
            "hybrid_to_dense": lambda: k8_cases(
                torch, timer, hybrid_inputs(torch, gen)) +
            hybrid_dense_cases(torch, timer, gen, k9=False)[
                "hybrid_to_dense"],
            "twell_fused_ffn": lambda: k2_cases(torch, timer, gen)[1] +
            k2_wide_cases(torch, timer, gen)[1] +
            k2_dense_cases(torch, timer, gen)[1] +
            ssm_cases(torch, timer)["twell_fused_ffn"] +
            xattn_cases(torch, timer)["twell_fused_ffn"],
            "twell_down_proj": lambda: k6_cases(torch, timer, gen) +
            ssm_cases(torch, timer)["twell_down_proj"] +
            xattn_cases(torch, timer)["twell_down_proj"],
        }
        return kernel_table(torch, {name: checks[name]() for name in only})
    k1s, k2s = k2_cases(torch, timer, gen)
    k1w, k2w = k2_wide_cases(torch, timer, gen)
    cases = {
        "twell_gate_matmul": k1s + [
            check_k1(torch, timer, m, n, gen)[0] for n, m in K1_SHAPES[3:]]
        + k1w,
        "twell_fused_ffn": k2s + k2w,
        "twell_down_proj": k6_cases(torch, timer, gen),
        "paged_decode_attention": [check_k3(torch, timer, h, hkv, gen,
                                            hd=hd)
                                   for h, hkv, hd in ATTN_CASES],
        "paged_chunk_attention": [check_k4(torch, timer, h, hkv, gen, hd=hd)
                                  for h, hkv, hd in ATTN_CASES],
        "tile_skip_ffn": k5_cases(torch, timer, gen),
        "flash_attention": k7_cases(torch, timer, gen),
    }
    hybrid = hybrid_inputs(torch, gen)
    cases["hybrid_to_dense"] = k8_cases(torch, timer, hybrid)
    cases["dense_to_hybrid"] = k9_cases(torch, timer, hybrid)
    del hybrid
    k1d, k2d = k2_dense_cases(torch, timer, gen)
    cases["twell_gate_matmul"] += k1d
    cases["twell_fused_ffn"] += k2d
    for name, runs in hybrid_dense_cases(torch, timer, gen).items():
        cases[name] += runs
    for name, runs in ssm_cases(torch, timer).items():
        cases[name] += runs
    for name, runs in xattn_cases(torch, timer).items():
        cases[name] += runs
    for name, runs in tp_cases(torch, timer, gen).items():
        cases[name] += runs
    return kernel_table(torch, cases)


# (arch, K, N, K8's orientations, K9's) that a training phase runs at the
# train phase's M 8192, E 128 and TRAIN_ALIVE pattern: olmo-1b's non-gated
# FFN (train_olmo: its forward packs relu(x @ W_u) directly, no K9
# forward), deepseek-67b's (train_dense) and llama3-405b's (trained on the
# CPU only; its widest N held here) on the wide union maps, and rwkv6-7b's
# non-gated channel mix (train_ssm; relu^2 has relu's support)
HYBRID_DENSE_CASES = (
    ("olmo-1b", 2048, 8192, ("forward", "backward"), ("backward",)),
    ("deepseek-67b", 8192, 22016, ("forward", "backward"),
     ("forward", "backward")),
    ("llama3-405b", 16384, 53248, ("forward", "backward"),
     ("forward", "backward")),
    ("rwkv6-7b", 4096, 14336, ("forward", "backward"), ("backward",)))


def hybrid_dense_cases(torch, timer, gen, k8=True, k9=True):
    """K8 and K9 (or only the one asked for) at each of
    HYBRID_DENSE_CASES's shapes; those past N 16384 (the wide union maps)
    none on an earlier port without them."""
    from repro_torch.kernels import hybrid_matmul as hm
    out = {"hybrid_to_dense": [], "dense_to_hybrid": []}
    for arch, k, n, k8s, k9s in HYBRID_DENSE_CASES:
        if n > 16384 and not hasattr(hm, "NARROW_MAX_N"):
            continue
        hybrid = hybrid_inputs(torch, gen, n=n, scattered=False, k=k)
        tag = {"arch": arch, "N": n}
        out["hybrid_to_dense"] += [
            {**check_k8(torch, timer, hybrid, orient), **tag}
            for orient in k8s if k8]
        out["dense_to_hybrid"] += [
            {**check_k9(torch, timer, hybrid, orient), **tag}
            for orient in k9s if k9]
        del hybrid
        gc.collect()
        torch.cuda.empty_cache()
    return out


def k5_cases(torch, timer, gen):
    """K5 at the drafts' M = 4 (threshold at the median, then 0) and at a
    256-row chunk (the same two thresholds)."""
    return [check_k5(torch, timer, m, thr, gen)
            for m, thr in ((4, None), (4, 0.0), (256, None), (256, 0.0))]


# tensor parallelism's per-rank FFN shards at decode (M 4): (arch, tp, K,
# N of a rank, K1 + K2, K5): paper-0.5b's whole-tile splits of its 22
# tiles (tp 2: 11 a rank, an odd count; tp 4: 6 or 5), deepseek-67b's 86
# tiles at tp 8 (11 or 10), llama3-405b's 208 at tp 8 (26)
TP_FFN_SHARDS = (("paper-0.5b", 2, 2048, 2816, True),
                 ("paper-0.5b", 4, 2048, 1536, True),
                 ("paper-0.5b", 4, 2048, 1280, True),
                 ("deepseek-67b", 8, 8192, 2816, False),
                 ("deepseek-67b", 8, 8192, 2560, False),
                 ("llama3-405b", 8, 16384, 6656, False))
# and attention's per-rank heads (arch, tp, H, Hkv, hd): paper-0.5b at tp
# 2, one kv head a rank of deepseek-67b (G 8) and llama3-405b (G 16)
TP_ATTN_SHARDS = (("paper-0.5b", 2, 16, 16, 64), ("deepseek-67b", 8, 8, 1, 128),
                  ("llama3-405b", 8, 16, 1, 128))


def tp_cases(torch, timer, gen):
    """K1-K5 at the per-rank shapes of tensor-parallel serving
    (TP_FFN_SHARDS, TP_ATTN_SHARDS), each held against its plain version
    and timed as the other cases; K5 with its threshold at the median
    (the drafts' regime). Past K 2048 the weights' std is scaled by
    sqrt(2048 / K), as ``k2_dense_cases``'s."""
    out = {name: [] for name in ("twell_gate_matmul", "twell_fused_ffn",
                                 "tile_skip_ffn", "paged_decode_attention",
                                 "paged_chunk_attention")}
    for arch, tp, k, n, k5 in TP_FFN_SHARDS:
        tag = {"tp_shard": f"{arch} tp {tp}"}
        k1, inputs = check_k1(torch, timer, 4, n, gen, k=k,
                              scale=0.08 * (2048 / k) ** 0.5)
        out["twell_gate_matmul"].append({**k1, **tag})
        out["twell_fused_ffn"].append({**check_k2(torch, timer, *inputs),
                                       **tag})
        del inputs
        if k5:
            out["tile_skip_ffn"].append(
                {**check_k5(torch, timer, 4, None, gen, n=n), **tag})
    gc.collect()
    torch.cuda.empty_cache()
    for arch, tp, h, hkv, hd in TP_ATTN_SHARDS:
        tag = {"tp_shard": f"{arch} tp {tp}"}
        out["paged_decode_attention"].append(
            {**check_k3(torch, timer, h, hkv, gen, hd=hd), **tag})
        out["paged_chunk_attention"].append(
            {**check_k4(torch, timer, h, hkv, gen, hd=hd), **tag})
    return out


def kernel_table(torch, cases):
    import importlib.util
    if importlib.util.find_spec("repro_torch.launch.op_analysis"):
        unchecked = [n for n in cases if not SHAPE_CHECKS.get(n)]
        assert not unchecked, f"no shape-function check of {unchecked}"
    out = []
    for name, runs in cases.items():
        head = runs[0]
        src, replaces = KERNELS[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": None,
                    "max_abs_err": max(r["max_abs_err"] for r in runs),
                    "ms": head["ms"], "plain_ms": head["plain_ms"],
                    "bound_ms": head["bound_ms"],
                    "bound_by": head["bound_by"],
                    "library_ms": head["library_ms"], "cases": runs})
    emit({"phase": "kernels", "tolerance": BF16_TOL,
          "summary": {k["name"]: {"max_abs_err": k["max_abs_err"],
                                  "ms": k["ms"]} for k in out},
          "shape_checks": dict(SHAPE_CHECKS)})
    return out


# --------------------------------------------------------------------------- #
# 4. the main path: full-width paper-0.5b through the serving engine
# --------------------------------------------------------------------------- #

def model_and_prompts(torch):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config("paper-0.5b")
    params = lm.init(cfg, device="cuda", seed=SEED)
    # random weights stand in for a trained model: keep 2% of the gate
    # columns alive, the ~99%-zero gate activations of the paper's regime
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    alive = torch.rand((cfg.num_layers, 1, cfg.d_ff), generator=gen,
                       device="cuda") < KEEP
    params["blocks"]["ffn"]["wg"] *= alive.to(params["blocks"]["ffn"]["wg"])
    return cfg, params, serve_prompts(np.random.RandomState(SEED),
                                      cfg.vocab_size)


def serve_prompts(rng, vocab):
    """The serving phases' 6 prompts: 64-512 tokens, the 1st and 5th
    sharing a 256-token prefix."""
    def toks(n):
        return rng.randint(0, vocab, n).tolist()
    shared = toks(256)
    return [shared + toks(64), toks(512), toks(64), toks(200),
            shared + toks(128), toks(96)]


SERVE_KERNELS = ("twell_gate_matmul", "twell_fused_ffn",
                 "paged_decode_attention", "paged_chunk_attention")
SPEC_KERNELS = SERVE_KERNELS + ("tile_skip_ffn",)


def serving_engine(cfg, params, new_tokens, backend="gather", **kw):
    from repro_torch.serving import ServingEngine
    return ServingEngine(params, cfg, backend=backend, block_size=16,
                         max_batch=4, max_seq_len=512 + new_tokens,
                         prefill_chunk=64, device="cuda", **kw)


def serve_run(torch, phase, cfg, params, prompts, new_tokens, kernels):
    """The greedy serving run of a serve phase on a fresh engine: every
    kernel of ``kernels`` launched over exactly this run, no TwELL
    overflow, every request at max_tokens, the prefix cache hit, no
    leaked blocks. Emits the phase's line, then a profiled rerun."""
    from repro_torch.kernels import ops
    engine = serving_engine(cfg, params, new_tokens)
    ops.OverflowLog.reset()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_tokens=new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    assert all(launches[k] > 0 for k in kernels), \
        f"a kernel of the {phase} path never launched: {launches}"
    assert not ops.OverflowLog.seen(), "a TwELL tile overflowed"
    assert all(len(o.token_ids) == new_tokens for o in outs), \
        [len(o.token_ids) for o in outs]
    assert engine.cached_tokens_total > 0, "the prefix cache never hit"
    engine.kv.check_invariants()
    assert engine.kv.num_available == engine.kv.num_blocks - 1, \
        "KV blocks leaked"
    total = sum(len(o.token_ids) for o in outs)
    ttft = sorted(o.ttft for o in outs)
    decode_ms = [s.wall_ms for s in engine.stats
                 if s.decode_batch and not s.prefill_tokens]
    res = {"phase": phase, "arch": cfg.name, "backend": "gather",
           "dtype": cfg.param_dtype, "layers": cfg.num_layers,
           "requests": len(outs),
           "prompt_lens": [len(p) for p in prompts],
           "new_tokens": new_tokens, "wall_s": wall,
           "tokens_per_s": total / wall, "ttft_ms_mean": 1e3 * sum(ttft) /
           len(ttft), "ttft_ms_max": 1e3 * ttft[-1],
           "decode_step_ms_mean": (sum(decode_ms) / len(decode_ms)
                                   if decode_ms else None),
           "steps": len(engine.stats),
           "cached_prefix_tokens": engine.cached_tokens_total,
           "launches": launches, "first_tokens": [o.token_ids[0]
                                                  for o in outs]}
    emit(res)
    emit({**profile_run(torch, serving_engine(cfg, params, new_tokens),
                        prompts, new_tokens), "run": phase,
          "decode_step_launches": decode_step_launches(
              torch, serving_engine(cfg, params, new_tokens), prompts,
              new_tokens)})
    res.update(cfg=cfg, params=params, prompts=prompts, outs=outs)
    return res


def phase_serve(torch):
    cfg, params, prompts = model_and_prompts(torch)
    return serve_run(torch, "serve", cfg, params, prompts, 32,
                     SERVE_KERNELS)


def profile_run(torch, engine, prompts, new_tokens):
    """The workload once more, on a fresh engine under torch.profiler (not
    part of the launch counts, which cover the unprofiled runs only)."""
    return profile_fn(torch, lambda: engine.generate(prompts,
                                                     max_tokens=new_tokens))


def decode_step_launches(torch, engine, prompts, new_tokens, steps=4):
    """The device work of ``steps`` decode-only steps of the workload (a
    decode batch, no prompt tokens), each traced alone by torch.profiler:
    its decode batch, its kernel launches, and its copies and fills. The
    other steps run untraced, after the first ``steps`` such steps too."""
    from torch.profiler import ProfilerActivity, profile
    for p in prompts:
        engine.submit(p, max_tokens=new_tokens)
    seen = []
    while engine.has_unfinished():
        if len(seen) == steps:
            engine.step()
            continue
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            engine.step()
            torch.cuda.synchronize()
        st = engine.stats[-1]
        if not st.decode_batch or st.prefill_tokens:
            continue
        names = [e.name for e in prof.events()
                 if str(e.device_type).endswith("CUDA")]
        copies = sum(n.startswith(("Memcpy", "Memset")) for n in names)
        seen.append({"decode_batch": st.decode_batch,
                     "kernels": len(names) - copies, "copies": copies})
    return seen


def profile_fn(torch, fn):
    """``fn()`` under torch.profiler: device busy share (kernel time over
    wall time; the profiler's own host cost makes it a lower bound), device
    time by kernel (the top 12), and every kernel of the port's own
    (``csrc/*.cu``: their symbols are in anonymous namespaces) with its
    device time and calls."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        kernels.append((us / 1e3, evt.count, evt.key[:90]))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    return {"phase": "profile", "wall_ms": wall_ms,
            "kernel_calls": sum(k[1] for k in kernels),
            "device_kernel_ms": busy_ms if kernels else "not measured",
            "device_busy_share": busy_ms / wall_ms if kernels else None,
            "top_kernels": [{"ms": ms, "calls": n, "name": name}
                            for ms, n, name in kernels[:12]],
            "port_kernels": [{"ms": ms, "calls": n, "name": name}
                             for ms, n, name in kernels
                             if name.split("::")[0].endswith(
                                 "(anonymous namespace)")]}


# --------------------------------------------------------------------------- #
# 5. self-speculative decoding on the same weights
# --------------------------------------------------------------------------- #

def spec_run(torch, cfg, params, prompts, new_tokens,
             threshold=DRAFT_THRESHOLD):
    """One greedy speculating run on a fresh engine; launch counts over
    exactly this run. Returns (engine, outputs, wall seconds, launches)."""
    from repro_torch.kernels import ops
    from repro_torch.serving import SpecConfig
    engine = serving_engine(cfg, params, new_tokens, spec=SpecConfig(
        k=SPEC_K, draft_backend="tile_skip", draft_threshold=threshold))
    ops.OverflowLog.reset()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_tokens=new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    assert not ops.OverflowLog.seen(), "a TwELL gate tile overflowed"
    assert all(len(o.token_ids) == new_tokens for o in outs), \
        [len(o.token_ids) for o in outs]
    engine.kv.check_invariants()
    assert engine.kv.num_available == engine.kv.num_blocks - 1, \
        "KV blocks leaked"
    return engine, outs, wall, launches


def phase_spec(torch, serve):
    """Greedy speculation: every request reaches max_tokens, no block
    leaks, K1-K5 all launched, acceptance strictly between 0 and 1,
    and tokens equal to the non-speculative run's up to the first position
    where that run's top-2 logit margin is at most LOGIT_TOL (draft and
    verify read attention through K3 and K4, so past a near-tie bf16 may
    choose either). Then a seeded stochastic run, twice, equal tokens, and
    greedy acceptance at two lower thresholds (why DRAFT_THRESHOLD)."""
    from repro_torch.serving import SamplingParams
    cfg, params, prompts = serve["cfg"], serve["params"], serve["prompts"]
    new_tokens = serve["new_tokens"]
    engine, outs, wall, launches = spec_run(torch, cfg, params, prompts,
                                            new_tokens)
    assert all(launches[k] > 0 for k in SPEC_KERNELS), \
        f"a kernel of the speculative path never launched: {launches}"
    drafted = sum(o.spec_drafted for o in outs)
    accepted = sum(o.spec_accepted for o in outs)
    assert 0 < accepted < drafted, \
        f"acceptance {accepted}/{drafted} is not strictly between 0 and 1"
    spec_steps = [s for s in engine.stats if s.spec_batch]
    ref = serving_engine(cfg, params, new_tokens, record_logits=True
                         ).generate(prompts, max_tokens=new_tokens)
    ties = first_near_ties(torch, ref)
    compared = equal_before(outs, [r.token_ids for r in ref], ties,
                            "speculative")
    ttft = sorted(o.ttft for o in outs)
    prof = profile_run(torch, serving_engine(
        cfg, params, new_tokens, spec=engine.spec), prompts, new_tokens)
    runs = []
    for _ in range(2):
        sampled = [SamplingParams(temperature=0.8, top_k=50, seed=100 + i)
                   for i in range(len(prompts))]
        eng = serving_engine(cfg, params, new_tokens, spec=engine.spec)
        hs = [eng.submit(p, sampling=sp, max_tokens=new_tokens)
              for p, sp in zip(prompts, sampled)]
        while eng.has_unfinished():
            eng.step()
        eng.kv.check_invariants()
        assert eng.kv.num_available == eng.kv.num_blocks - 1
        runs.append([h.result() for h in hs])
    assert [o.token_ids for o in runs[0]] == [o.token_ids for o in runs[1]], \
        "seeded stochastic speculation is not reproducible"
    assert all(len(o.token_ids) == new_tokens for o in runs[0])
    sweep = []
    for t in (0.0, 1.5):
        _, souts, swall, _ = spec_run(torch, cfg, params, prompts,
                                      new_tokens, threshold=t)
        sweep.append({"draft_threshold": t, "acceptance_rate": sum(
            o.spec_accepted for o in souts) / sum(
            o.spec_drafted for o in souts), "tokens_per_s":
            sum(len(o.token_ids) for o in souts) / swall})
    total = sum(len(o.token_ids) for o in outs)
    res = {"phase": "spec", "arch": cfg.name, "verify_backend": "gather",
           "draft_backend": "tile_skip", "k": SPEC_K,
           "draft_threshold": DRAFT_THRESHOLD, "requests": len(outs),
           "new_tokens": new_tokens, "wall_s": wall,
           "tokens_per_s": total / wall,
           "ttft_ms_mean": 1e3 * sum(ttft) / len(ttft),
           "ttft_ms_max": 1e3 * ttft[-1], "steps": len(engine.stats),
           "spec_steps": len(spec_steps), "drafted": drafted,
           "accepted": accepted, "acceptance_rate": accepted / drafted,
           "draft_ms_mean": sum(s.draft_ms for s in spec_steps) /
           len(spec_steps),
           "verify_ms_mean": sum(s.verify_ms for s in spec_steps) /
           len(spec_steps),
           "device_busy_share": prof["device_busy_share"],
           "profile_wall_ms": prof["wall_ms"],
           "device_kernel_ms": prof["device_kernel_ms"],
           "top_kernels": prof["top_kernels"][:8],
           "port_kernels": prof["port_kernels"],
           "tokens_equal_before_near_tie": compared,
           "nonspec_tokens_per_s": serve["tokens_per_s"],
           "stochastic": {"temperature": 0.8, "top_k": 50,
                          "acceptance_rate": sum(
                              o.spec_accepted for o in runs[0]) /
                          max(1, sum(o.spec_drafted for o in runs[0])),
                          "first_tokens": [o.token_ids[0] for o in runs[0]]},
           "threshold_sweep": sweep, "launches": launches}
    emit(res)
    res.update(outs=outs, near_ties=ties, spec_config=engine.spec)
    return res


def first_near_ties(torch, ref):
    """Each request's first output position where the recorded logits'
    top-2 margin is at most LOGIT_TOL (its length if none): past it, bf16
    rounding that differs between two runs may pick either token."""
    ties = []
    for r in ref:
        pos = 0
        for row in r.logits:
            top2 = torch.topk(torch.from_numpy(row), 2).values
            if float(top2[0] - top2[1]) <= LOGIT_TOL:
                break
            pos += 1
        ties.append(pos)
    return ties


def equal_before(outs, want, ties, what):
    """Asserts each request's tokens equal ``want``'s before its near-tie;
    returns the number of tokens compared a request."""
    for o, w, n in zip(outs, want, ties):
        assert o.token_ids[:n] == w[:n], \
            f"request {o.rid}: {what} tokens differ before the first " \
            f"near-tie ({n}): {o.token_ids[:n]} against {w[:n]}"
    return list(ties)


# --------------------------------------------------------------------------- #
# 5b. the pipelined engine after warmup(), and each program against eager
# --------------------------------------------------------------------------- #

def warm_run(torch, cfg, params, prompts, new_tokens, **kw):
    """A fresh engine with ``warmup=True``, then the greedy workload timed:
    no program made after the warmup, no TwELL overflow, every request at
    max_tokens, nothing in flight and a clean pool after ``flush()``.
    Returns (engine, outputs, wall seconds, launches over the run)."""
    from repro_torch.kernels import ops
    engine = serving_engine(cfg, params, new_tokens, warmup=True, **kw)
    made = dict(engine.programs.made)
    ops.OverflowLog.reset()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_tokens=new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    assert dict(engine.programs.made) == made, \
        f"a program was made after warmup: {made} -> {engine.programs.made}"
    assert not ops.OverflowLog.seen(), "a TwELL tile overflowed"
    assert all(len(o.token_ids) == new_tokens for o in outs), \
        [len(o.token_ids) for o in outs]
    assert engine.flush() == [] and engine._inflight is None
    engine.kv.check_invariants()
    assert engine.kv.num_available == engine.kv.num_blocks - 1, \
        "KV blocks leaked"
    assert engine._reserved == 0, "a reservation leaked"
    return engine, outs, wall, launches


def run_numbers(engine, outs, wall, prof):
    """The timing columns of one warmed run and its profiled rerun."""
    ttft = sorted(o.ttft for o in outs)
    decode = [s for s in engine.stats if s.decode_batch and
              not s.prefill_tokens]

    def mean(xs):
        return sum(xs) / len(xs) if xs else None
    return {"warmup_seconds": engine.warmup_seconds,
            "programs": dict(engine.programs.made),
            "tokens_per_s": sum(len(o.token_ids) for o in outs) / wall,
            "wall_s": wall, "ttft_ms_mean": 1e3 * sum(ttft) / len(ttft),
            "ttft_ms_max": 1e3 * ttft[-1],
            "decode_step_ms_mean": mean([s.wall_ms for s in decode]),
            "sync_ms_mean": mean([s.sync_ms for s in engine.stats]),
            "overlap_ms_mean": mean([s.overlap_ms for s in engine.stats]),
            "steps": len(engine.stats),
            "device_busy_share": prof["device_busy_share"],
            "profile_wall_ms": prof["wall_ms"],
            "device_kernel_ms": prof["device_kernel_ms"]}


def graph_against_eager(torch, engine, prog, args, eager):
    """One replay of ``prog`` on ``args`` against ``eager`` (the model
    function called directly) on the same inputs, each from the same copy
    of the pools: outputs and written K/V bitwise equal. The null block
    (0) is left out: every padded position writes there, and which of
    several writes to one slot lands is not defined."""
    import numpy as np
    pools = engine.kv.pools
    snap = {n: p.clone() for n, p in pools.items()}
    got = prog(*args)
    got = [t.clone() for t in (got if isinstance(got, tuple) else (got,))]
    written = {n: p.clone() for n, p in pools.items()}
    for n, p in pools.items():
        p.copy_(snap[n])
    want = eager(*[torch.from_numpy(a).cuda() if isinstance(a, np.ndarray)
                   else a for a in args])
    torch.cuda.synchronize()
    res = {"outputs_equal": all(torch.equal(g, w)
                                for g, w in zip(got, want)),
           "kv_equal": all(torch.equal(written[n][:, 1:], pools[n][:, 1:])
                           for n in pools),
           "kv_written": any(not torch.equal(written[n][:, 1:],
                                             snap[n][:, 1:]) for n in pools)}
    for n, p in pools.items():
        p.copy_(snap[n])
    return res


def check_graphs(torch, engine):
    """decode (4, 32, greedy), prefill (4, 64, greedy), draft (4, greedy)
    and verify (4,) of ``engine`` (speculating, table width 34), each
    replayed once against its eager model call, bitwise."""
    import numpy as np
    from repro_torch.models import lm
    rng = np.random.RandomState(SEED + 7)
    p, e, w = engine.params, engine, engine.table_width
    bt = (1 + np.arange(4)[:, None] * w + np.arange(w)[None]).astype(
        np.int32)                                   # 4 rows, distinct blocks

    def ints(*shape, hi=None):
        return rng.randint(0, hi or e.cfg.vocab_size, shape).astype(np.int32)
    sl = np.array([500, 257, 33, 100], np.int32)
    start = np.array([0, 100, 250, 448], np.int32)
    num_new = np.array([64, 17, 64, 1], np.int32)
    sl0 = np.array([100, 37, 300, 5], np.int32)
    dlen = np.array([4, 4, 2, 0], np.int32)
    drafts = torch.from_numpy(ints(4, SPEC_K).astype(np.int64)).cuda()
    cases = {
        "decode": (e._jit_decode(4, 32, True), [bt[:, :32], sl, ints(4, 1)],
                   lambda b, s, t: (lambda lg: (lg[:, -1].argmax(-1),
                                                lg[:, -1]))(
                       lm.paged_decode_step(p, e.kv.pools, b, s, t,
                                            e.cfg_decode)[0])),
        "prefill": (e._jit_prefill(4, 64, True),
                    [bt, ints(4, 64), start, num_new],
                    lambda b, t, s, n: (lambda lg: (lg[:, 0].argmax(-1),
                                                    lg[:, 0]))(
                        lm.paged_prefill(p, e.kv.pools, b, t, n,
                                         e.cfg_prefill, start_lens=s,
                                         last_only=True)[0])),
        "draft": (e._jit_draft(4, True), [bt, sl0, ints(4, 1), dlen],
                  lambda b, s, t, d: e.drafter.draft(
                      p, e.kv.pools, b, s, t, d, None, None, None, None,
                      greedy=True)[:2]),
        "verify": (e._jit_verify(4),
                   [bt, sl0, (dlen + (dlen > 0)).astype(np.int32),
                    ints(4, 1), drafts],
                   lambda b, s, n, t, d: (e.verifier.verify(
                       p, e.kv.pools, b, s, n,
                       torch.cat([t, d.to(t.dtype)], dim=1))[0],)),
    }
    out = {}
    for name, (prog, args, eager) in cases.items():
        out[name] = graph_against_eager(torch, engine, prog, args, eager)
        assert out[name]["outputs_equal"] and out[name]["kv_equal"], \
            f"{name}: the replay differs from the eager call: {out[name]}"
        assert out[name]["kv_written"], f"{name} wrote no K/V"
    return out


def phase_pipeline(torch, serve, spec):
    """The serve phase's settings and prompts on engines made with
    ``warmup=True``: synchronous, then pipelined (``pipeline=True``). No
    program made after the warmup; K1-K4 launched (counted through the
    graphs' replays) over exactly the pipelined run; no overflow; the
    prefix cache hit; the pool clean after ``flush()``; the pipelined
    tokens equal to the serve phase's (synchronous) up to each request's
    first near-tie (spec phase's reference logits). Both runs' timing and a
    profiled rerun of each on a fresh warmed engine. Then a greedy
    speculative run (spec phase's settings) pipelined after warmup, its
    tokens equal to the synchronous spec run's up to the first near-tie,
    and one replay of each entry (decode, prefill, draft, verify) held
    bitwise against its eager model call."""
    cfg, params, prompts = serve["cfg"], serve["params"], serve["prompts"]
    n = serve["new_tokens"]
    ties = spec["near_ties"]
    res = {"phase": "pipeline", "arch": cfg.name, "backend": "gather",
           "requests": len(prompts), "new_tokens": n, "near_ties": ties}
    steps, mode_outs = {}, {}
    for mode in ("sync", "pipeline"):
        kw = {"pipeline": mode == "pipeline"}
        engine, outs, wall, launches = warm_run(torch, cfg, params, prompts,
                                                n, **kw)
        steps[mode] = [(s.decode_batch, s.padded_batch, s.prefill_tokens)
                       for s in engine.stats]
        mode_outs[mode] = outs
        prof_engine = serving_engine(cfg, params, n, warmup=True, **kw)
        prof = profile_fn(torch, lambda: prof_engine.generate(
            prompts, max_tokens=n))
        res[mode] = {**run_numbers(engine, outs, wall, prof),
                     "launches": launches,
                     # the warmed engine once more: every traced step
                     # replays graphs only (none captured)
                     "decode_step_launches": decode_step_launches(
                         torch, prof_engine, prompts, n),
                     "tokens_equal_serve": [
                         o.token_ids == w.token_ids
                         for o, w in zip(outs, serve["outs"])]}
        if mode == "pipeline":
            assert all(launches[k] > 0 for k in SERVE_KERNELS), \
                f"a kernel of the pipelined path never launched: {launches}"
            assert engine.cached_tokens_total > 0, "the prefix cache never hit"
            res["launches"] = launches
        equal_before(outs, [o.token_ids for o in serve["outs"]], ties,
                     f"{mode} graphed")
    if not all(res["pipeline"]["tokens_equal_serve"]):
        res["why_unequal"] = (
            "past a near-tie: the (decode batch, padded batch, prefill "
            "tokens) of each step differ between the runs, and the batch "
            "shape picks which cuBLAS algorithm (and summation order) runs")
        res["step_shapes"] = steps
    engine, souts, swall, slaunches = warm_run(
        torch, cfg, params, prompts, n, pipeline=True, spec=spec[
            "spec_config"])
    assert all(slaunches[k] > 0 for k in SPEC_KERNELS), \
        f"a kernel of the pipelined speculative path never launched: " \
        f"{slaunches}"
    equal_before(souts, [o.token_ids for o in spec["outs"]], ties,
                 "pipelined speculative")
    drafted = sum(o.spec_drafted for o in souts)
    res["spec"] = {
        "k": SPEC_K, "draft_threshold": DRAFT_THRESHOLD,
        "warmup_seconds": engine.warmup_seconds,
        "programs": dict(engine.programs.made),
        "tokens_per_s": sum(len(o.token_ids) for o in souts) / swall,
        "sync_spec_tokens_per_s": spec["tokens_per_s"],
        "acceptance_rate": sum(o.spec_accepted for o in souts) / drafted,
        "tokens_equal_sync_spec": [o.token_ids == w.token_ids for o, w in
                                   zip(souts, spec["outs"])],
        "launches": slaunches}
    res["graph_vs_eager"] = check_graphs(torch, engine)
    emit(res)
    res.update(outs=mode_outs["pipeline"], spec_outs=souts)
    return res


# --------------------------------------------------------------------------- #
# 5b'. tensor-parallel serving: the sharded path at tp 1 on one card
# --------------------------------------------------------------------------- #

def first_difference(torch, cfg, params, prompts, n, outs, want, **kw):
    """The first token where ``outs`` and ``want`` differ, and the top-2
    logit margin there, from a rerun of the sharded engine that records
    its logits (a failure message)."""
    for o, w in zip(outs, want):
        if o.token_ids != w.token_ids:
            pos = next(i for i, (a, b) in enumerate(zip(o.token_ids,
                                                        w.token_ids))
                       if a != b)
            rec = serving_engine(cfg, params, n, record_logits=True, **kw
                                 ).generate(prompts, max_tokens=n)[o.rid]
            top2 = torch.topk(torch.from_numpy(rec.logits[pos]), 2).values
            return {"request": o.rid, "position": pos,
                    "tokens": (o.token_ids[pos], w.token_ids[pos]),
                    "margin": float(top2[0] - top2[1])}
    return None


# CUgraphNodeType (cuda.h) by value
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
                    4: "graph", 5: "empty", 6: "wait_event",
                    7: "event_record"}


def graph_nodes(torch, prog):
    """The nodes, by type, of a program's entry captured once more into a
    CUDA graph that keeps its node list (``keep_graph``), read through the
    CUDA API (``cuGraphGetNodes``, ``cuGraphNodeGetType``). A capture runs
    nothing; its host-side launch and collective counts are taken back
    out."""
    import ctypes

    from repro_torch.distributed import collectives
    from repro_torch.kernels import build
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with build.captured_launches(), \
            build.captured_launches(collectives.CALLS):
        with torch.cuda.graph(g, stream=side, capture_error_mode="relaxed"):
            prog.fn(*prog.inputs)
    cuda = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cuda.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cuda.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    counts = {}
    for node in nodes:
        kind = ctypes.c_int()
        assert cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                       ctypes.byref(kind)) == 0
        name = GRAPH_NODE_TYPES.get(kind.value, str(kind.value))
        counts[name] = counts.get(name, 0) + 1
    del g
    return counts


def phase_serve_tp(torch, serve, spec, pipe):
    """Tensor-parallel serving's code path on one card: a one-rank
    ``model`` mesh (``make_serving_mesh(1)`` on NCCL, joined through a
    file store in a temporary directory), the weights sharded by
    ``bridge.shard_params`` and the pools by ``PagedKVCache(mesh=)``,
    every layer's collectives inside the CUDA graphs. The pipeline phase's
    warmed, pipelined gather run and its speculative run (k SPEC_K
    tile-skip drafts), on the sharded engine: tokens bitwise equal to
    that phase's (the same settings; at one rank the all_reduce is NCCL's
    in-place no-op and the all_gather a copy, so the arithmetic is the
    unsharded engine's), and equal to the serve and spec phases' up to
    their near-ties; K1-K5 launched over the runs; the collectives each
    captured decode program made (2 a layer, the embedding's, and the
    logits' gather); one decode program's graph nodes by type beside the
    unsharded one's (the gather's copy among them); the decode step time
    beside the unsharded one."""
    import os
    import tempfile

    import torch.distributed as dist
    from repro_torch.distributed import collectives, ranks, sharding
    cfg, params, prompts = serve["cfg"], serve["params"], serve["prompts"]
    n = serve["new_tokens"]
    spec_config = spec["spec_config"]
    res = {"phase": "serve_tp", "arch": cfg.name, "backend": "gather",
           "tp": 1, "requests": len(prompts), "new_tokens": n}
    with tempfile.TemporaryDirectory() as d:
        ranks.join(0, 1, "cuda:0", os.path.join(d, "store"))
        try:
            mesh = sharding.make_serving_mesh(1, "cuda")
            res["backend_of_mesh"] = dist.get_backend()
            runs = {}
            for run, kw, want in (
                    ("gather", {}, pipe["outs"]),
                    ("spec", {"spec": spec_config}, pipe["spec_outs"])):
                collectives.reset_calls()
                engine, outs, wall, launches = warm_run(
                    torch, cfg, params, prompts, n, pipeline=True,
                    mesh=mesh, **kw)
                diff = first_difference(torch, cfg, params, prompts, n, outs,
                                        want, pipeline=True, mesh=mesh, **kw)
                assert diff is None, \
                    f"serve_tp {run}: tokens differ from the unsharded " \
                    f"engine's: {diff}"
                equal_before(outs, [o.token_ids for o in (
                    serve if run == "gather" else spec)["outs"]],
                    spec["near_ties"], f"serve_tp {run}")
                progs = {key: p.collectives for key, p in
                         engine.programs._programs.items()
                         if key[0] == "decode"}
                runs[run] = {
                    "tokens_equal_unsharded": True, "wall_s": wall,
                    "tokens_per_s": sum(len(o.token_ids) for o in outs) /
                    wall, "warmup_seconds": engine.warmup_seconds,
                    "collective_calls": collectives.calls(),
                    "launches": launches}
                if run == "gather":
                    decode = [s.wall_ms for s in engine.stats
                              if s.decode_batch and not s.prefill_tokens]
                    runs[run]["decode_step_ms_mean"] = sum(decode) / len(
                        decode)
                    runs[run]["decode_program_collectives"] = \
                        sorted({tuple(sorted(c.items()))
                                for c in progs.values()})
                    want_calls = {"all_reduce": 2 * cfg.num_layers + 1,
                                  "all_gather": 1}
                    assert all(c == want_calls for c in progs.values()), \
                        f"a decode program captured {progs}, not {want_calls}"
                    # one decode program's graph, sharded and unsharded
                    res["decode_graph_nodes"] = graph_nodes(
                        torch, engine._jit_decode(4, 32, True))
                    res["unsharded_decode_graph_nodes"] = graph_nodes(
                        torch, serving_engine(cfg, params, n)._jit_decode(
                            4, 32, True))
                del engine
            launches = {k: runs["gather"]["launches"].get(k, 0) +
                        runs["spec"]["launches"].get(k, 0)
                        for k in runs["gather"]["launches"]}
            assert all(launches[k] > 0 for k in SPEC_KERNELS), \
                f"a kernel of the sharded path never launched: {launches}"
        finally:
            gc.collect()            # no graph holds the communicator now
            dist.destroy_process_group()
    sharded = res["decode_graph_nodes"]
    plain = res["unsharded_decode_graph_nodes"]
    # at one rank NCCL's all_gather is a device copy (a memcpy node) and
    # its in-place all_reduce enqueues nothing
    assert sharded.get("memcpy", 0) == plain.get("memcpy", 0) + 1, \
        f"the sharded decode graph does not hold the logits' all_gather " \
        f"copy: {sharded} against {plain}"
    res.update(runs=runs, launches=launches,
               unsharded_decode_step_ms_mean=pipe["pipeline"][
                   "decode_step_ms_mean"])
    emit(res)
    return res


# --------------------------------------------------------------------------- #
# 5c. the HTTP front end: EngineSpec + telemetry + ServingServer
# --------------------------------------------------------------------------- #

HTTP_TIMEOUT = 300           # seconds: the limit of every HTTP call
HTTP_CANCEL_TOKENS = 400     # the dropped stream's max_tokens (never reached)
# the rounds are halved from 30 and 31 so that the whole script stays well
# inside its 1200 s limit
HTTP_ROUNDS = 15             # timed rounds of each way of sending the wave
INPROCESS_ROUNDS = 16        # in-process rounds an engine; the first unread


class Http:
    """JSON and SSE calls to one ``ServingServer``, each with a timeout."""

    def __init__(self, srv):
        self.srv = srv
        self.base = f"http://{srv.host}:{srv.port}"

    def get(self, path):
        import urllib.request
        with urllib.request.urlopen(self.base + path,
                                    timeout=HTTP_TIMEOUT) as r:
            body = r.read()
            return r.status, (json.loads(body) if path != "/metrics"
                              else body.decode())

    def complete(self, prompt, max_tokens):
        """A non-streamed completion: its token ids."""
        import urllib.request
        req = urllib.request.Request(
            self.base + "/v1/completions",
            data=json.dumps({"prompt": prompt,
                             "max_tokens": max_tokens}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            out = json.load(r)
        assert out["choices"][0]["finish_reason"] == "length", out
        return out["choices"][0]["token_ids"]

    def stream(self, prompt, max_tokens, drop_after=None):
        """A streamed completion: its token ids, read to ``[DONE]``, or its
        first ``drop_after`` chunks' before the connection is dropped."""
        import http.client
        conn = http.client.HTTPConnection(self.srv.host, self.srv.port,
                                          timeout=HTTP_TIMEOUT)
        try:
            conn.request("POST", "/v1/completions",
                         body=json.dumps({"prompt": prompt,
                                          "max_tokens": max_tokens,
                                          "stream": True}),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200, resp.status
            toks, chunks = [], 0
            while True:
                line = resp.fp.readline()
                assert line, "the stream ended without [DONE]"
                if not line.startswith(b"data: "):
                    continue
                payload = line.strip()[len(b"data: "):]
                if payload == b"[DONE]":
                    return toks
                chunk = json.loads(payload)["choices"][0]
                toks.extend(chunk["token_ids"])
                chunks += 1
                if drop_after is not None and chunks == drop_after:
                    resp.close()
                    return toks
        finally:
            conn.close()


def http_wave(api, prompts, n):
    """The prompts sent at once, even ones as plain requests and odd ones
    over SSE, in prompt order 1 ms apart: their token ids and the wave's
    wall seconds."""
    import concurrent.futures as cf
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(len(prompts)) as pool:
        futs = []
        for i, p in enumerate(prompts):
            call = api.complete if i % 2 == 0 else api.stream
            futs.append(pool.submit(call, p, n))
            time.sleep(0.001)
        got = [f.result(timeout=HTTP_TIMEOUT) for f in futs]
    return got, time.perf_counter() - t0


def server_wave(srv, prompts, n, waiters):
    """The prompts submitted in process to the server's engine thread, no
    HTTP: ``waiters`` threads wait for them as a plain request's handler
    does (``wait_finished``, woken by every step's ``notify_all``), each
    for its share in turn. Their token ids and the wall seconds."""
    import concurrent.futures as cf
    t0 = time.perf_counter()
    handles = [srv.engine.submit(p, max_tokens=n) for p in prompts]

    def wait(group):
        for h in group:
            srv.wait_finished(h)
    with cf.ThreadPoolExecutor(waiters) as pool:
        list(pool.map(wait, [handles[i::waiters] for i in range(waiters)],
                      timeout=HTTP_TIMEOUT))
    wall = time.perf_counter() - t0
    srv.check()
    assert all(h.finished for h in handles)
    return [h.result().token_ids for h in handles], wall


def spread(xs):
    """Median, min and max of a list of numbers."""
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def steps_of(stats):
    """Means of a run's decode-only steps (wall, sync), its step count and
    the wall seconds of its steps summed (against the run's wall: the
    share of it the engine spent inside a step)."""
    decode = [s for s in stats if s.decode_batch and not s.prefill_tokens]
    return {"steps": len(stats),
            "steps_wall_s": sum(s.wall_ms for s in stats) / 1e3,
            "decode_step_ms_mean": sum(s.wall_ms for s in decode) /
            len(decode),
            "sync_ms_mean": sum(s.sync_ms for s in stats) / len(stats)}


def server_window(srv, api, prompts, n, rounds=HTTP_ROUNDS):
    """Tokens/s of the 6-prompt wave on the warmed server, ``rounds``
    times each way, the ways interleaved a round: over HTTP (3 plain, 3
    SSE), in process to the engine thread with 6 waiting threads, and
    with one. Each way's tokens/s a round with their spread, its window
    (the rounds' summed wall) and its decode step and sync means a round:
    what separates HTTP's own cost from that of waking the waiters."""
    engine = srv.engine
    ways = {"http": lambda: http_wave(api, prompts, n),
            "server_6_waiters": lambda: server_wave(srv, prompts, n, 6),
            "server_1_waiter": lambda: server_wave(srv, prompts, n, 1)}
    rows = {name: [] for name in ways}
    for _ in range(rounds):
        for name, wave in ways.items():
            first = len(engine.stats)
            got, wall = wave()
            srv.check()
            assert all(len(t) == n for t in got), [len(t) for t in got]
            rows[name].append({"tokens_per_s": len(prompts) * n / wall,
                               "wall_s": wall,
                               **steps_of(engine.stats[first:])})
    return {name: {"rounds": rs,
                   "window_s": sum(r["wall_s"] for r in rs),
                   "tokens_per_s": spread([r["tokens_per_s"] for r in rs]),
                   "decode_step_ms_mean": spread(
                       [r["decode_step_ms_mean"] for r in rs]),
                   "sync_ms_mean": spread([r["sync_ms_mean"] for r in rs])}
            for name, rs in rows.items()}


def metric(text, name):
    """The value of the sample line ``name`` (labels included) in a
    Prometheus text; None when absent."""
    for line in text.splitlines():
        if line.rsplit(" ", 1)[0] == name:
            return float(line.rsplit(" ", 1)[1])
    return None


def request_tracks(doc):
    """rid -> the span and instant names of its Chrome-trace track."""
    tracks = {}
    for ev in doc["traceEvents"]:
        if ev["ph"] != "M" and ev["tid"] > 0:
            tracks.setdefault(ev["tid"] - 1, []).append(ev["name"])
    return tracks


def inprocess_run(torch, engine, prompts, n):
    """``generate()`` of the prompts on a warmed engine: tokens/s and the
    means of its decode-only steps (wall, sync) over exactly this run."""
    first = len(engine.stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_tokens=n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return outs, {"tokens_per_s": sum(len(o.token_ids) for o in outs) / wall,
                  "wall_s": wall, **steps_of(engine.stats[first:])}


def static_against_engine(torch, cfg, params, prompts, n, want, ties):
    """The static reference loop (monolithic cache, plain attention, K1 +
    K2) on each prompt alone: tokens equal to ``want`` up to the earlier
    of the request's near-tie and the loop's own first near-tie."""
    from repro_torch.launch import serve as serve_cli
    cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, ffn_impl="gather"))
    toks, own, wall = [], [], 0.0
    for p in prompts:
        logits = []
        prompt = torch.tensor([p], dtype=torch.int64, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve_cli.generate(params, cfg, prompt, n, len(p) + n + 1,
                                 logits_out=logits)
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        toks.append(out[0, len(p):].tolist())
        own.extend(first_near_ties(torch, [types.SimpleNamespace(
            logits=[lg[0].cpu().numpy() for lg in logits])]))
    compared = [min(a, b) for a, b in zip(ties, own)]
    for i, (t, w, m) in enumerate(zip(toks, want, compared)):
        assert t[:m] == w[:m], \
            f"request {i}: the static loop differs from the engine before " \
            f"the first near-tie ({m}): {t[:m]} against {w[:m]}"
    return {"tokens_per_s": len(prompts) * n / wall, "wall_s": wall,
            "tokens_compared": compared, "own_near_ties": own,
            "tokens_equal": [t == w for t, w in zip(toks, want)]}


def hook_host_us(torch, engine):
    """Host microseconds of each telemetry hook a pipelined decode step of
    4 rows calls (``on_ffn`` once, ``on_tokens`` a row, ``phase`` six
    times, ``on_step`` once), on a scratch ``Telemetry`` with the engine's
    cost model and pool, and their sum for such a step."""
    import numpy as np
    from repro_torch.models import lm
    from repro_torch.observability import accounting
    from repro_torch.serving import Telemetry
    tm = Telemetry(trace=True)
    tm.attach_compute(engine.cfg, accounting.param_count(
        lm.trainable(engine.params)))
    layers = engine.cfg.num_layers
    probe = np.stack([np.full(layers, 60.0), np.full(layers, 0.2),
                      np.ones(layers)])
    req = types.SimpleNamespace(rid=0, priority=0, spans=[], span_open=None,
                                arrival_time=time.perf_counter())
    us = {"on_ffn": host_us(torch, lambda: tm.on_ffn(
              4, probe[0], tile_frac_per_layer=probe[1],
              ffn_present=probe[2], impl="gather")),
          "on_tokens": host_us(torch, lambda: tm.on_tokens(req, 1)),
          "phase": host_us(torch, lambda: tm.phase("collect", 0.0, 1e-3,
                                                   0)),
          "on_step": host_us(torch, lambda: tm.on_step(
              kv=engine.kv, reserved=0, wall_s=2e-3, sync_s=1e-3))}
    us["decode_step"] = us["on_ffn"] + 4 * us["on_tokens"] + \
        6 * us["phase"] + us["on_step"]
    return us


def phase_http(torch, serve, spec, pipe):
    """The serve phase's weights, prompts and engine settings behind the
    HTTP server, the engine built through ``EngineSpec`` with
    ``pipeline=True`` and ``Telemetry(trace=True)``: see the module
    docstring, 5c. Every HTTP call has a timeout; the server's engine
    thread is checked after each part (``check()`` raises its error)."""
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineSpec, Telemetry
    from repro_torch.serving.server import ServingServer
    cfg, params, prompts = serve["cfg"], serve["params"], serve["prompts"]
    n = serve["new_tokens"]
    ties = spec["near_ties"]
    espec = EngineSpec(backend="gather", block_size=16, max_batch=4,
                       max_seq_len=512 + n, prefill_chunk=64, pipeline=True,
                       telemetry=Telemetry(trace=True), device="cuda")
    engine = espec.build(params, cfg)
    tm = engine.telemetry
    srv = ServingServer(engine, host="127.0.0.1", port=0, warmup=True)
    srv.start()
    api = Http(srv)
    res = {"phase": "http", "arch": cfg.name, "backend": "gather",
           "pipeline": True, "requests": len(prompts), "new_tokens": n}
    try:
        t0 = time.perf_counter()
        ready = srv.wait_ready(timeout=HTTP_TIMEOUT)
        srv.check()
        assert ready, "the warmup did not end in time"
        res["warmup_s"] = time.perf_counter() - t0
        status, health = api.get("/healthz")
        assert status == 200 and health["ok"], health
        made = dict(engine.programs.made)
        compiles = tm.summary()["jit_compiles"]
        ops.OverflowLog.reset()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        got, wall = http_wave(api, prompts, n)
        srv.check()
        assert all(len(t) == n for t in got), [len(t) for t in got]
        res["tokens_per_s"] = len(prompts) * n / wall
        res["wall_s"] = wall
        res["tokens_compared"] = equal_before(
            [types.SimpleNamespace(rid=i, token_ids=t)
             for i, t in enumerate(got)],
            [o.token_ids for o in pipe["outs"]], ties, "HTTP")
        res["tokens_equal_pipeline"] = [
            t == o.token_ids for t, o in zip(got, pipe["outs"])]
        _, text = api.get("/metrics")
        tokens = metric(text, "serving_tokens_generated_total")
        ttft = metric(text, 'serving_ttft_seconds_count{priority="0",'
                            'role="unified"}')
        assert tokens == len(prompts) * n, (tokens, len(prompts) * n)
        assert ttft == len(prompts), ttft
        for phase in ("plan", "launch", "collect", "overlap"):
            assert metric(text, 'serving_step_phase_seconds_count{phase="%s"}'
                          % phase), f"no {phase} phase in /metrics"
        _, stats = api.get("/v1/stats")
        sp = stats["sparsity"]
        assert sp["mean_ffn_sparsity"] > 0.97, sp
        assert sp["flops_reduction"] is not None and sp["mfu"] is not None
        res["stats"] = {**sp, "phases_ms_mean":
                        stats["telemetry"]["phases_ms_mean"],
                        "prefix_cache_hit_rate":
                        stats["telemetry"]["prefix_cache_hit_rate"],
                        "ttft_s": stats["telemetry"]["ttft_s"]}
        # a 7th stream, dropped after 2 chunks: the server cancels it
        before = engine.cancelled_total
        dropped = api.stream(prompts[2], HTTP_CANCEL_TOKENS, drop_after=2)
        deadline = time.time() + HTTP_TIMEOUT
        while engine.cancelled_total == before or engine.has_unfinished():
            srv.check()
            assert time.time() < deadline, "the dropped stream never ended"
            time.sleep(0.01)
        assert tm.metrics.requests_total.value(
            outcome="cancelled", role="unified") == 1
        res["dropped_stream_tokens"] = len(dropped)
        launches = ops.launch_counts()
        assert all(launches[k] > 0 for k in SERVE_KERNELS), \
            f"a kernel of the HTTP path never launched: {launches}"
        assert not ops.OverflowLog.seen(), "a TwELL tile overflowed"
        # timing over a window of seconds (not in the launch counts): the
        # prompts' prefixes are cached from here on, as in the in-process
        # rounds below
        res["window"] = server_window(srv, api, prompts, n)
        assert not ops.OverflowLog.seen(), "a TwELL tile overflowed"
        assert dict(engine.programs.made) == made, \
            f"a program was made after warmup: {made} -> " \
            f"{engine.programs.made}"
        assert tm.summary()["jit_compiles"] == compiles
        engine.kv.check_invariants()
        assert engine.kv.num_available == engine.kv.num_blocks - 1, \
            "KV blocks leaked"
        assert engine._reserved == 0, "a reservation leaked"
        res["launches"] = launches
        res["jit_compiles"] = compiles
    finally:
        srv.shutdown()
    srv.check()
    assert not any(t.is_alive() for t in srv._threads), "a thread survived"
    trace_path = ROOT / "build" / "http_trace.json"
    trace_path.parent.mkdir(exist_ok=True)
    engine.export_trace(str(trace_path))
    tracks = request_tracks(json.loads(trace_path.read_text()))
    # the checked wave, the dropped stream, then 3 ways x HTTP_ROUNDS waves
    assert len(tracks) == (1 + 3 * HTTP_ROUNDS) * len(prompts) + 1, \
        sorted(tracks)
    for rid, names in tracks.items():
        assert names[:3] == ["QUEUED", "PREFILL", "DECODE"] and \
            names[3] in ("FINISH", "CANCEL") and len(names) == 4, \
            f"request {rid}: track {names}"
    res["trace"] = {"path": str(trace_path.relative_to(ROOT)),
                    "bytes": trace_path.stat().st_size,
                    "tracks": len(tracks),
                    "cancelled_tracks": sum(t[-1] == "CANCEL"
                                            for t in tracks.values())}
    assert res["trace"]["cancelled_tracks"] == 1, res["trace"]
    # in process on warmed engines, telemetry on / off, pipelined and
    # synchronous, interleaved a round; the first round pays one-time
    # costs (a thread's first run, the prefix cache's first fill) and is
    # left out of the spread
    off = serving_engine(cfg, params, n, pipeline=True, warmup=True)
    engines = {"on": engine, "off": off,
               "sync_on": espec.replace(pipeline=False, warmup=True,
                                        telemetry=True).build(params, cfg),
               "sync_off": serving_engine(cfg, params, n, warmup=True)}
    runs = {name: [] for name in engines}
    for _ in range(INPROCESS_ROUNDS):
        for name, eng in engines.items():
            runs[name].append(inprocess_run(torch, eng, prompts, n)[1])
    for name, rows in runs.items():
        read = rows[1:]
        res[f"inprocess_telemetry_{name}"] = {
            "first": rows[0], "rounds": read,
            "window_s": sum(r["wall_s"] for r in read),
            **{k: spread([r[k] for r in read])
               for k in ("tokens_per_s", "decode_step_ms_mean",
                         "sync_ms_mean")}}
    res["pipeline_phase_telemetry_off"] = {
        k: pipe["pipeline"][k] for k in ("tokens_per_s",
                                         "decode_step_ms_mean",
                                         "sync_ms_mean")}
    res["static_loop"] = static_against_engine(torch, cfg, params, prompts,
                                               n, got, ties)
    res["engine_tokens_per_s"] = \
        res["inprocess_telemetry_on"]["tokens_per_s"]["median"]
    res["hook_host_us"] = hook_host_us(torch, engine)
    # last: torch.profiler slows later launches
    res["decode_step_launches"] = {
        "telemetry_on": decode_step_launches(torch, engine, prompts, n),
        "telemetry_off": decode_step_launches(torch, off, prompts, n)}
    emit(res)
    return res


# --------------------------------------------------------------------------- #
# 5d. disaggregated serving: a prefill and a decode engine, one coordinator
# --------------------------------------------------------------------------- #

DISAGG_TTL = 2               # steps: the churn run's transfer TTL, short
#                              enough to expire while the decode batch is full


def disagg_coordinator(cfg, params, new_tokens, transport=None, ttl=64,
                       **kw):
    """The serve phase's engine settings as a DisaggCoordinator: a prefill
    and a decode engine, each with its own KV pool and CUDA graphs."""
    from repro_torch.serving import DisaggCoordinator, EngineSpec
    spec = EngineSpec(backend="gather", block_size=16, max_batch=4,
                      max_seq_len=512 + new_tokens, prefill_chunk=64,
                      device="cuda", **kw)
    return DisaggCoordinator(params, cfg, spec=spec, transport=transport,
                             transfer_ttl_steps=ttl)


def recording(torch, inner, snapshot=True):
    """``inner`` (a Transport) with each migration's block ids recorded
    and, with ``snapshot``, after each copy the source and destination
    blocks snapshot on the card (no sync: what the decode engine's next
    replay will read), for a bitwise check after the run."""
    from repro_torch.serving import Transport

    class Recording(Transport):
        def __init__(self):
            self.inner, self.moves = inner, []

        def warmup(self, src_kv, dst_kv, max_blocks):
            return self.inner.warmup(src_kv, dst_kv, max_blocks)

        def transfer(self, src_kv, dst_kv, src_blocks, dst_blocks):
            self.inner.transfer(src_kv, dst_kv, src_blocks, dst_blocks)
            self.moves.append({"src": list(src_blocks),
                               "dst": list(dst_blocks)})
            if not snapshot:
                return
            si, di = torch.tensor([src_blocks, dst_blocks]).pin_memory(
                ).cuda(non_blocking=True)
            self.moves[-1].update(
                kv_src={n: p.index_select(1, si)
                        for n, p in src_kv.pools.items()},
                kv_dst={n: p.index_select(1, di)
                        for n, p in dst_kv.pools.items()})

        def check(self):
            """Each migration's destination blocks equal its source blocks
            bit for bit; drops the source snapshots."""
            for m in self.moves:
                for n, got in m["kv_dst"].items():
                    assert torch.equal(got.view(torch.int16),
                                       m["kv_src"][n].view(torch.int16)), \
                        f"migrated {n} blocks {m['dst']} differ from " \
                        f"their source {m['src']}"
                del m["kv_src"]
    return Recording()


def disagg_run(torch, coord, prompts, n, kernels):
    """The workload through ``coord``: every request at max_tokens, each
    kernel of ``kernels`` launched over exactly this run, no TwELL
    overflow, zero prefill tokens on the decode engine, no program made
    during the run when the coordinator was warmed, both pools clean.
    Returns (outputs, wall seconds, launches)."""
    from repro_torch.kernels import ops
    made = coord.programs_made()
    ops.OverflowLog.reset()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = coord.generate(prompts, max_tokens=n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    assert all(launches[k] > 0 for k in kernels), \
        f"a kernel of the disaggregated path never launched: {launches}"
    assert not ops.OverflowLog.seen(), "a TwELL tile overflowed"
    assert all(len(o.token_ids) == n for o in outs), \
        [len(o.token_ids) for o in outs]
    assert coord.decode_engine.prefill_tokens_total == 0 and not any(
        s.prefill_tokens for s in coord.decode_engine.stats), \
        "a prefill chunk ran on the decode engine"
    if coord.warmup_report:
        assert coord.programs_made() == made, \
            f"a program was made after warmup: {made} -> " \
            f"{coord.programs_made()}"
    disagg_clean(coord)
    return outs, wall, launches


def disagg_clean(coord):
    """Both pools pass check_invariants with nothing held, reserved,
    buffered or leaked."""
    for name, eng in (("prefill", coord.prefill_engine),
                      ("decode", coord.decode_engine)):
        eng.kv.check_invariants()
        assert eng.kv.num_available == eng.kv.num_blocks - 1, \
            f"{name} pool leaked blocks"
        assert not [o for o in eng.kv._tables if o < 0], \
            f"{name} pool: a transfer hold outlived the run"
        assert eng._reserved == 0, f"{name}: a reservation leaked"
    assert len(coord.buffer) == 0 and coord.buffer.blocks_pinned == 0


def block_mib(kv):
    """MiB of one block over every pool (K and V, all layers)."""
    return sum(p[:, 0].numel() * p.element_size()
               for p in kv.pools.values()) / 2 ** 20


def transfer_times(torch, coord, transport, moves):
    """Each recorded migration's copy again on the run's pools (the run
    is over; the blocks' contents no longer matter), timed by CUDA events
    with the L2 flushed and the card spinning while the host enqueues
    (``Timer``), and by the host clock around the call and a sync."""
    timer = Timer(torch)
    src, dst = coord.prefill_engine.kv, coord.decode_engine.kv
    rows = []
    for m in moves:
        def copy():
            transport.transfer(src, dst, m["src"], m["dst"])
        ms = timer.ms(copy, iters=3, warmup=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        copy()
        torch.cuda.synchronize()
        rows.append({"blocks": len(m["src"]), "ms": ms,
                     "host_ms": (time.perf_counter() - t0) * 1e3})
    mib = block_mib(dst)
    blocks = sum(r["blocks"] for r in rows)
    total = sum(r["ms"] for r in rows)
    return {"migrations": rows, "block_mib": mib, "blocks": blocks,
            "ms_per_migration": total / len(rows),
            "ms_per_mib": total / (blocks * mib),
            "host_ms_per_migration": sum(r["host_ms"] for r in rows) /
            len(rows)}


def timing_columns(outs, wall, stats):
    ttft = sorted(o.ttft for o in outs)
    decode = [s.wall_ms for s in stats if s.decode_batch and
              not s.prefill_tokens]
    return {"tokens_per_s": sum(len(o.token_ids) for o in outs) / wall,
            "wall_s": wall, "ttft_ms_mean": 1e3 * sum(ttft) / len(ttft),
            "ttft_ms_max": 1e3 * ttft[-1],
            "decode_step_ms_mean": (sum(decode) / len(decode)
                                    if decode else None)}


DISAGG_ROUNDS = 10           # timed rounds of fresh prompts, engines in turn


def timed_rounds(torch, engines, vocab, n):
    """Tokens/s, mean TTFT and the decode step of warmed engines over
    DISAGG_ROUNDS rounds, each on new prompts of the serve phase's lengths
    and shared prefix (no prefix hits across rounds), the engines' order
    alternating a round; medians and min-max, and no program made."""
    import numpy as np
    rng = np.random.RandomState(SEED + 11)
    made = {k: (e.programs_made() if hasattr(e, "programs_made") else
                dict(e.programs.made)) for k, e in engines.items()}
    got = {k: [] for k in engines}
    for r in range(DISAGG_ROUNDS):
        prompts = serve_prompts(rng, vocab)
        for name in (list(engines) if r % 2 == 0 else list(engines)[::-1]):
            eng = engines[name]
            before = len(eng.stats)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = eng.generate(prompts, max_tokens=n)
            torch.cuda.synchronize()
            got[name].append(timing_columns(outs, time.perf_counter() - t0,
                                            eng.stats[before:]))
    for k, e in engines.items():
        now = e.programs_made() if hasattr(e, "programs_made") else \
            dict(e.programs.made)
        assert now == made[k], f"{k}: a program was made in the rounds"
    out = {k: {col: spread([r[col] for r in rows])
               for col in ("tokens_per_s", "ttft_ms_mean",
                           "decode_step_ms_mean")}
           for k, rows in got.items()}
    out["tokens_per_s_ratio"] = out["disagg"]["tokens_per_s"]["median"] / \
        out["unified"]["tokens_per_s"]["median"]
    return out


def peak_mib(torch, fn):
    """``fn()``'s result and the card's peak allocated MiB above what was
    allocated before it."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def phase_disagg(torch, serve, spec, smi):
    """The serve phase's model, prompts and engine settings behind a
    ``DisaggCoordinator`` (a prefill engine and a decode engine, each with
    its own KV pool and CUDA graphs):

    1. warmed, ``InProcessTransport``: tokens equal to a warmed synchronous
       unified engine's up to each request's first near-tie, zero prefill
       chunks on the decode engine, no program made after ``warmup()``,
       both pools clean, the migrated blocks the plan's count (each
       request's ceil(prompt / 16) blocks less the 16 of the shared prefix
       that dedupe on the decode side); its times and peak memory beside
       the unified engine's, then DISAGG_ROUNDS timed rounds of both;
    2. each transport unwarmed, every migration's blocks snapshot on the
       card right after its copy: destination equal to source, tokens
       equal to run 1's, and the two transports' blocks equal, bit for
       bit; each transport's copy time a migration and a MiB (CUDA
       events) on the migrations' own block lists;
    3. the spec phase's speculation (k=4 tile-skip drafts) on the decode
       engine: tokens equal to the unified speculating engine's up to the
       near-ties, K5 launched, no draft program made by the prefill engine;
    4. churn: a cancel mid-transfer, a cancel mid-decode and a TTL of
       DISAGG_TTL steps that expires entries while the decode batch is
       full: the re-prefilled requests' tokens equal the unified engine's
       up to the near-ties, both pools clean."""
    from repro_torch.serving import (HostRoundtripTransport,
                                     InProcessTransport, SpecConfig)
    from repro_torch.serving.disagg.coordinator import (STAGE_DECODE,
                                                        STAGE_TRANSFER)
    cfg, params, prompts = serve["cfg"], serve["params"], serve["prompts"]
    n = serve["new_tokens"]
    res = {"phase": "disagg", "card": smi, "arch": cfg.name,
           "backend": "gather", "requests": len(prompts), "new_tokens": n}
    if spec is None:            # --phases: the near-ties of a fresh run
        ref = serving_engine(cfg, params, n, record_logits=True).generate(
            prompts, max_tokens=n)
        ties = first_near_ties(torch, ref)
        spec_cfg = SpecConfig(k=SPEC_K, draft_backend="tile_skip",
                              draft_threshold=DRAFT_THRESHOLD)
        spec_outs = spec_run(torch, cfg, params, prompts, n)[1]
    else:
        ties, spec_cfg, spec_outs = spec["near_ties"], spec["spec_config"], \
            spec["outs"]
    res["near_ties"] = ties

    def unified():
        engine = serving_engine(cfg, params, n, warmup=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = engine.generate(prompts, max_tokens=n)
        torch.cuda.synchronize()
        return engine, outs, time.perf_counter() - t0
    (uni, uni_outs, uni_wall), uni_mib = peak_mib(torch, unified)
    want = [o.token_ids for o in uni_outs]
    res["unified"] = {**timing_columns(uni_outs, uni_wall, uni.stats),
                      "warmup_seconds": uni.warmup_seconds,
                      "peak_mib": uni_mib}

    # 1. warmed, in-process transport: the timed run (block ids recorded,
    #    nothing else, so its memory and times are the transport's own)
    def run1():
        coord = disagg_coordinator(cfg, params, n, recording(
            torch, InProcessTransport(), snapshot=False))
        coord.warmup()
        return (coord,) + disagg_run(torch, coord, prompts, n,
                                     SERVE_KERNELS)
    (coord, outs, wall, launches), mib = peak_mib(torch, run1)
    equal_before(outs, want, ties, "disaggregated")
    expect = sum(-(-len(p) // 16) for p in prompts) - 256 // 16
    migrated = coord.migrated_blocks_total
    assert migrated == expect == sum(len(m["dst"])
                                     for m in coord.transport.moves), \
        f"{migrated} blocks migrated, the plan says {expect}"
    res["in_process"] = {
        **timing_columns(outs, wall, coord.stats), "warmed": True,
        "warmup_seconds": coord.warmup_seconds,
        "warmup_programs": coord.programs_made(),
        "warmup_transfer_row": [r for r in coord.warmup_report
                                if r["role"] == "transfer"],
        "peak_mib": mib, "migrated_blocks": migrated,
        "expected_blocks": expect,
        "decode_prefill_tokens": coord.decode_engine.prefill_tokens_total,
        "cached_tokens": coord.cached_tokens_total,
        "tokens_equal_unified": [o.token_ids == w
                                 for o, w in zip(outs, want)],
        "transfer": transfer_times(torch, coord, InProcessTransport(),
                                   coord.transport.moves),
        "launches": launches}
    total = dict(launches)
    res["rounds"] = timed_rounds(torch, {"unified": uni, "disagg": coord},
                                 cfg.vocab_size, n)
    del coord, uni

    # 2. each transport with every migration's blocks snapshot
    # right after its copy: destination equal to source, and the two
    # transports' tokens and blocks equal, bit for bit
    runs = {}
    for name, transport in (("in_process_checked", InProcessTransport()),
                            ("host_roundtrip", HostRoundtripTransport())):
        coord = disagg_coordinator(cfg, params, n,
                                   recording(torch, transport))
        outs2, wall2, launches2 = disagg_run(torch, coord, prompts, n,
                                             SERVE_KERNELS)
        coord.transport.check()
        assert [o.token_ids for o in outs2] == [o.token_ids for o in outs], \
            f"{name}: the tokens differ from the warmed run's"
        runs[name] = coord.transport.moves
        res[name] = {**timing_columns(outs2, wall2, coord.stats),
                     "warmed": False, "kv_bitwise_after_claim": True,
                     "tokens_equal_warmed_run": True,
                     "launches": launches2}
        if name == "host_roundtrip":
            res[name]["transfer"] = transfer_times(
                torch, coord, transport, coord.transport.moves)
        del coord
        for k, v in launches2.items():
            total[k] = total.get(k, 0) + v
    a, b = runs["in_process_checked"], runs["host_roundtrip"]
    assert [(m["src"], m["dst"]) for m in a] == \
        [(m["src"], m["dst"]) for m in b], "the migrations differ"
    for ma, mb in zip(a, b):
        for name in ma["kv_dst"]:
            assert torch.equal(ma["kv_dst"][name].view(torch.int16),
                               mb["kv_dst"][name].view(torch.int16)), \
                f"migrated {name} blocks differ between the transports"
    res["host_roundtrip"]["blocks_equal_in_process"] = True
    del runs, a, b

    # 3. speculation on the decode engine
    coord = disagg_coordinator(cfg, params, n, spec=spec_cfg)
    souts, swall, slaunches = disagg_run(torch, coord, prompts, n,
                                         SPEC_KERNELS)
    assert coord.prefill_engine.programs.made["draft"] == 0, \
        "the prefill engine drafted"
    equal_before(souts, [o.token_ids for o in spec_outs], ties,
                 "disaggregated speculative")
    drafted = sum(o.spec_drafted for o in souts)
    res["spec"] = {**timing_columns(souts, swall, coord.stats),
                   "warmed": False, "k": SPEC_K,
                   "draft_threshold": DRAFT_THRESHOLD,
                   "acceptance_rate": sum(o.spec_accepted for o in souts) /
                   drafted,
                   "tokens_equal_unified_spec": [
                       o.token_ids == w.token_ids
                       for o, w in zip(souts, spec_outs)],
                   "launches": slaunches}
    del coord
    for k, v in slaunches.items():
        total[k] = total.get(k, 0) + v

    # 4. churn: cancel mid-transfer and mid-decode, TTL expiry, re-prefill
    from repro_torch.kernels import ops
    coord = disagg_coordinator(cfg, params, n, ttl=DISAGG_TTL)
    ops.reset_launch_counts()
    hs = [coord.submit(p, max_tokens=n) for p in prompts]
    cancelled = {}
    while coord.has_unfinished():
        coord.step()
        stages = {h.rid: coord._slots[h.rid].stage for h in hs}
        if "transfer" not in cancelled:
            rid = next((r for r, s in stages.items()
                        if s == STAGE_TRANSFER), None)
            if rid is not None and coord.cancel(rid):
                cancelled["transfer"] = rid
        if "decode" not in cancelled and coord.expired_total:
            # after an expiry: a slot freed earlier would let every
            # waiting transfer in before its TTL ran out
            rid = next((r for r, s in stages.items() if s == STAGE_DECODE
                        and len(coord._slots[r].req.output_tokens) >= 4),
                       None)
            if rid is not None and coord.cancel(rid):
                cancelled["decode"] = rid
    torch.cuda.synchronize()
    claunches = ops.launch_counts()
    couts = [h.result() for h in hs]
    assert set(cancelled) == {"transfer", "decode"}, cancelled
    assert {couts[r].finish_reason for r in cancelled.values()} == \
        {"cancelled"}, [o.finish_reason for o in couts]
    kept = [o for o in couts if o.rid not in cancelled.values()]
    assert all(o.finish_reason == "length" for o in kept)
    assert coord.expired_total >= 1, "no transfer expired"
    requeued = [o.rid for o in kept if o.num_preemptions]
    assert requeued, "no request re-prefilled"
    equal_before(kept, [want[o.rid] for o in kept],
                 [ties[o.rid] for o in kept], "re-prefilled")
    assert coord.decode_engine.prefill_tokens_total == 0
    assert all(claunches[k] > 0 for k in SERVE_KERNELS), claunches
    disagg_clean(coord)
    res["churn"] = {"ttl_steps": DISAGG_TTL, "cancelled": cancelled,
                    "expired": coord.expired_total,
                    "preempted": coord.preempted_total,
                    "requeued_rids": requeued,
                    "num_preemptions": [o.num_preemptions for o in couts],
                    "tokens_equal_unified": {
                        o.rid: o.token_ids == want[o.rid] for o in kept},
                    "role_stats": coord.role_stats(),
                    "launches": claunches}
    del coord
    for k, v in claunches.items():
        total[k] = total.get(k, 0) + v
    res["launches"] = total
    emit(res)
    return res



# --------------------------------------------------------------------------- #
# 6. olmo-1b: the non-gated TwELL path (K1 + K6) through the serving engine
# --------------------------------------------------------------------------- #

OLMO_KERNELS = ("twell_gate_matmul", "twell_down_proj",
                "paged_decode_attention", "paged_chunk_attention")


def olmo_model(torch):
    """olmo-1b at full width and depth in bfloat16, random weights from
    SEED, with all but KEEP of every layer's W_u columns zeroed: the
    non-gated counterpart of the gate sparsity in ``model_and_prompts``
    (~164 live columns a layer, ~5 a 256-column tile of 32 slots)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config("olmo-1b")
    params = lm.init(cfg, device="cuda", seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    alive = torch.rand((cfg.num_layers, 1, cfg.d_ff), generator=gen,
                       device="cuda") < KEEP
    params["blocks"]["ffn"]["wu"] *= alive.to(params["blocks"]["ffn"]["wu"])
    return cfg, params


def phase_serve_olmo(torch, serve):
    """The serve phase's prompts and engine settings on olmo-1b: K1, K3,
    K4 and K6 each launched over exactly this run, and K2 never (the FFN
    is not gated)."""
    cfg, params = olmo_model(torch)
    res = serve_run(torch, "serve_olmo", cfg, params, serve["prompts"],
                    serve["new_tokens"], OLMO_KERNELS)
    assert res["launches"]["twell_fused_ffn"] == 0, \
        "the non-gated FFN went through the gated kernel K2"
    return res


# --------------------------------------------------------------------------- #
# 6b. the MoE family at full width: mixtral-8x22b and llama4-scout, served
# --------------------------------------------------------------------------- #

MOE_KERNELS = ("twell_gate_matmul", "twell_fused_ffn")
MOE_GEN = 32                       # greedy tokens a request
MOE_RING_TOL = 1e-3                # float32 decode against the forward:
#                                    sums over 4096 keys and the FFN in
#                                    other orders, on logits of order 1
MOE_GATHER_TOL = LOGIT_TOL         # bf16 gather against bf16 dense logits
#                                    of one layer: the same router input
#                                    bits, so the same experts; the FFNs
#                                    round differently
# (arch, layers, requests, prompt tokens): mixtral's prompt runs 64 past
# its 4096 window, so the decode ring wraps before the first generated
# token; mixtral serves 1 of its 56 layers (the depth of its gather and
# ring checks), since its 4160 host-bound decode steps at 2 layers took
# the whole script to 1098 s of its 1200 s limit on an H100 (80GB HBM3,
# 700 W) with a slower host; llama4 2 of 48
MOE_SERVE = (("mixtral-8x22b", 1, 2, 4096 + 64),
             ("llama4-scout-17b-a16e", 2, 2, 64))


def moe_model(torch, arch, layers, impl, keep=KEEP, alive=None):
    """``arch`` at full width and ``layers`` layers in bfloat16 with the
    FFN as ``impl``, random weights from SEED (lm.init), and in every
    expert all but ``keep`` of W_g's columns zeroed (or exactly ``alive``
    columns alive): the MoE counterpart of ``model_and_prompts``'s gate
    sparsity."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, ffn_impl=impl))
    params = lm.init(cfg, device="cuda", seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    wg = params["blocks"]["moe"]["experts"]["wg"]       # (L, E, K, N)
    for w in wg.flatten(0, 1):
        if alive is None:
            w *= (torch.rand((1, cfg.d_ff), generator=gen, device="cuda")
                  < keep).to(w)
        else:
            w *= alive_columns(torch, gen, cfg.d_ff).to(w)
    return cfg, params


def moe_static_run(torch, cfg, params, prompt, impl, gen=MOE_GEN):
    """The serve CLI's static loop (``launch/serve.py:generate``, greedy,
    ``gen`` new tokens) with the FFN as ``impl``: tokens, each generated
    step's logits, wall seconds and the kernel launches over exactly this
    run."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, ffn_impl=impl))
    logits = []
    ops.OverflowLog.reset()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = serve.generate(params, cfg, prompt, gen,
                          prompt.shape[1] + gen + 1, logits_out=logits)
    torch.cuda.synchronize()
    return toks, logits, time.perf_counter() - t0, ops.launch_counts()


def moe_decode_against_forward(torch, cfg, params, toks, logits):
    """A static-loop run's decode logits at its generated positions (all
    past the window) against ``lm.forward``'s on the same tokens (dense
    FFN): one request, right-padded to a multiple of the window (the
    banded forward's chunks; causal, so the padding moves no earlier
    position). Returns each compared position's max abs difference and
    the positions."""
    from repro_torch.models import lm
    cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, ffn_impl="dense"))
    row = toks[:1]
    total = -(-row.shape[1] // cfg.window) * cfg.window
    padded = torch.nn.functional.pad(row, (0, total - row.shape[1]))
    first = row.shape[1] - MOE_GEN - 1              # the last prompt token
    with torch.no_grad():
        fwd, _ = lm.forward(params, {"tokens": padded}, cfg)
    want = fwd[0, first:first + MOE_GEN].float()
    got = torch.stack([lg[0] for lg in logits])
    return (got - want).abs().amax(dim=-1).tolist(), \
        [first, first + MOE_GEN - 1]


def moe_ring_check(torch, cfg, params, prompt):
    """The ring against the forward in float32, where a router's top-k
    choice cannot flip between the two (in bf16 the router logits of a
    2-row decode step and of the 8192-row forward round differently, and
    a token whose second and third experts are that close takes another
    expert: an order-1 change of its FFN output). mixtral's first layer at
    full width in float32 (the bf16 weights widened), one request of the
    prompt, the static loop with the dense FFN: its decode logits past
    the window within MOE_RING_TOL of ``lm.forward``'s."""
    from repro_torch.launch import serve
    from repro_torch.tree import tree_map
    cfg32 = dataclasses.replace(cfg, num_layers=1, dtype="float32",
                                param_dtype="float32",
                                sparsity=dataclasses.replace(
                                    cfg.sparsity, ffn_impl="dense"))
    p32 = {**params, "blocks": tree_map(lambda t: t[:1],
                                        params["blocks"])}
    p32 = tree_map(lambda t: t.float(), p32)
    logits = []
    t0 = time.perf_counter()
    toks = serve.generate(p32, cfg32, prompt[:1], MOE_GEN,
                          prompt.shape[1] + MOE_GEN + 1, logits_out=logits)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    errs, span = moe_decode_against_forward(torch, cfg32, p32, toks, logits)
    del p32
    return {"layers": 1, "dtype": "float32", "max_abs_diff": max(errs),
            "positions": span, "tolerance": MOE_RING_TOL,
            "step_ms": wall / (prompt.shape[1] + MOE_GEN) * 1e3}


def moe_forced_logits(torch, cfg, params, toks, first, cache=None):
    """``toks`` (B, T) teacher-forced through the static loop's decode
    (``lm.init_cache``, or ``cache`` when given, and ``lm.decode_step``,
    as ``serve.generate`` prefills its prompt): the float32 logits of
    positions ``first`` to T - 1, (B, T - first, V)."""
    from repro_torch.models import lm
    if cache is None:
        cache = lm.init_cache(cfg, toks.shape[0], toks.shape[1] + 1,
                              device="cuda")
    out = []
    with torch.no_grad():
        for i in range(toks.shape[1]):
            lg, cache = lm.decode_step(params, cache, toks[:, i:i + 1], cfg)
            if i >= first:
                out.append(lg[:, 0].float())
    return torch.stack(out, dim=1)


def moe_gather_check(torch, cfg, params, toks, plen, layers=1,
                     tol=MOE_GATHER_TOL):
    """K1 + K2 inside the static decode, held numerically: ``params``'
    first layer (or ``layers``) in bf16, the dense run's tokens ``toks`` teacher-forced
    through decode (``moe_forced_logits``) with the gather FFN and with the
    dense FFN, logits at every generated position (mixtral's all past the
    window, so the ring has wrapped). With one layer the router sees the
    same bits under both (embedding and attention do not depend on the
    FFN), so it picks the same experts and the logits differ only by the
    FFNs' rounding: within ``tol``. Launches here are not the
    main path's and are not counted."""
    from repro_torch.tree import tree_map
    p1 = {**params, "blocks": tree_map(lambda t: t[:layers],
                                       params["blocks"])}
    got = {}
    t0 = time.perf_counter()
    for impl in ("gather", "dense"):
        c1 = dataclasses.replace(cfg, num_layers=layers, sparsity=dataclasses.
                                 replace(cfg.sparsity, ffn_impl=impl))
        got[impl] = moe_forced_logits(torch, c1, p1, toks[:, :-1], plen - 1)
    torch.cuda.synchronize()
    err = (got["gather"] - got["dense"]).abs().amax(dim=-1)      # (B, P)
    return {"layers": layers, "dtype": cfg.param_dtype, "max_abs_diff":
            float(err.max()), "median_abs_diff": float(err.median()),
            "positions": [plen - 1, toks.shape[1] - 2],
            "rows": toks.shape[0], "tolerance": tol,
            "wall_s": time.perf_counter() - t0}


def phase_serve_moe(torch):
    """mixtral-8x22b and llama4-scout-17b-a16e at full width and MOE_SERVE's
    layers (bf16, KEEP of every expert's gate columns alive) through the
    serve CLI's static loop, greedy: the gather FFN (K1 + K2 for every
    expert at every step, K2 past K 4096: 6144 and 5120), then the dense
    FFN on the same prompts, tokens equal up to each request's first
    near-tie (LOGIT_TOL). mixtral's prompts run past its 4096-token window,
    so the decode ring wraps; there its decode logits are held against
    ``lm.forward``'s in float32 (``moe_ring_check``; the bf16 run's
    differences are reported beside). K1 + K2 are held numerically inside
    that decode by ``moe_gather_check`` (one layer, gather against dense
    on the same tokens). Tokens/s and the step time of each."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.observability import accounting
    runs, launches = [], {}
    for arch, layers, batch, plen in MOE_SERVE:
        cfg, params = moe_model(torch, arch, layers, "gather")
        e, steps = cfg.num_experts, plen + MOE_GEN
        rng = np.random.RandomState(SEED)
        prompt = torch.tensor(rng.randint(0, cfg.vocab_size, (batch, plen)),
                              dtype=torch.int64, device="cuda")
        toks, logits, wall, counts = moe_static_run(torch, cfg, params,
                                                    prompt, "gather")
        overflow = ops.OverflowLog.seen()
        for k in MOE_KERNELS:
            assert counts[k] == steps * layers * e, \
                f"{arch}: {k} launched {counts[k]} times, not once an " \
                f"expert a layer a step ({steps * layers * e})"
            launches[k] = launches.get(k, 0) + counts[k]
        assert not overflow, f"{arch}: a TwELL tile overflowed"
        dtoks, dlogits, dwall, _ = moe_static_run(torch, cfg, params, prompt,
                                                  "dense")
        ties = serve.first_near_ties(dlogits)
        for r, n in enumerate(ties):
            assert torch.equal(toks[r, plen:plen + n],
                               dtoks[r, plen:plen + n]), \
                f"{arch} row {r}: gather and dense differ before the " \
                f"first near-tie ({n})"
        res = {"arch": arch, "layers": layers, "experts": e,
               "top_k": cfg.top_k, "d_model": cfg.d_model,
               "d_ff": cfg.d_ff,
               "params": accounting.param_count(lm.trainable(params)),
               "requests": batch, "prompt_len": plen, "new_tokens": MOE_GEN,
               "decode_steps": steps,
               "cache_slots": lm.init_cache(cfg, 1, steps + 1,
                                            device="cuda")["k"].shape[2],
               "window": cfg.window, "attn_chunk": cfg.attn_chunk,
               "gather": {"wall_s": wall,
                          "step_ms": wall / steps * 1e3,
                          "tokens_per_s": batch * MOE_GEN / wall,
                          "launches": {k: counts[k] for k in MOE_KERNELS}},
               "dense": {"wall_s": dwall, "step_ms": dwall / steps * 1e3,
                         "tokens_per_s": batch * MOE_GEN / dwall},
               "near_ties": ties, "overflow": overflow,
               "first_tokens": toks[:, plen].tolist(),
               "gather_vs_dense": moe_gather_check(torch, cfg, params,
                                                   dtoks, plen)}
        if cfg.window:
            errs, span = moe_decode_against_forward(torch, cfg, params,
                                                    dtoks, dlogits)
            res["decode_vs_forward_bf16"] = {
                "max_abs_diff": max(errs),
                "median_abs_diff": statistics.median(errs),
                "positions_within_logit_tol": sum(e <= LOGIT_TOL
                                                  for e in errs),
                "positions": span}
            res["decode_vs_forward_f32"] = moe_ring_check(torch, cfg, params,
                                                          prompt)
        runs.append(res)
        emit({"phase": "serve_moe", **res})
        gvd = res["gather_vs_dense"]
        assert gvd["max_abs_diff"] <= MOE_GATHER_TOL, \
            f"{arch}: gather's decode logits differ from dense's by " \
            f"{gvd['max_abs_diff']} on one layer"
        if cfg.window:
            assert steps > cfg.window == res["cache_slots"], \
                f"{arch}: the ring did not wrap"
            ring = res["decode_vs_forward_f32"]
            assert ring["max_abs_diff"] <= MOE_RING_TOL, \
                f"{arch}: decode past the window differs from the forward " \
                f"by {ring['max_abs_diff']} in float32"
        del params, logits, dlogits
        gc.collect()
        torch.cuda.empty_cache()
    return {"launches": launches, "runs": runs}


# --------------------------------------------------------------------------- #
# 6c. the remaining dense configs at full width through the engine
# --------------------------------------------------------------------------- #

# (arch, layers, witness tolerance): phi3-mini-3.8b at 8 of its 32 layers
# (its 32 took the whole script to 1173 s of its 1200 s limit on an H100
# (80GB HBM3, 700 W) with a slower host), deepseek-67b and llama3-405b at
# 2 of 95 and 126 (3.42 B, 12.32 B; depth cut to fit one card beside the
# engine's graphs). The tolerance holds each bf16 path's served logits
# against float32's beyond one bf16 step (``dense_gather_check``): 1.5x
# the larger path's reading on the H100 at these depths (0.0384, 0.1991,
# 0.4313: gather and dense within 7% of each other; phi3 read 0.0606 at
# 32 layers), as the logits grow with d_model (llama3's reach 16-32)
DENSE_SERVE = (("phi3-mini-3.8b", 8, 0.06), ("deepseek-67b", 2, 0.3),
               ("llama3-405b", 2, 0.65))
DENSE_CHECK_PROMPTS = (2, 5)       # the 64- and 96-token prompts
DENSE_GEN = 32                     # greedy tokens a request


def dense_model(torch, arch, layers, keep=KEEP):
    """``arch`` at full width (and ``layers`` layers, or all) in bfloat16,
    random weights from SEED (lm.init), all but ``keep`` of every layer's
    W_g columns zeroed, as ``model_and_prompts`` does for paper-0.5b."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params = lm.init(cfg, device="cuda", seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    for w in params["blocks"]["ffn"]["wg"]:
        w *= (torch.rand((1, cfg.d_ff), generator=gen, device="cuda")
              < keep).to(w)
    return cfg, params


def dense_run_numbers(engine, outs, wall):
    decode_ms = [s.wall_ms for s in engine.stats
                 if s.decode_batch and not s.prefill_tokens]
    ttft = sorted(o.ttft for o in outs)
    return {"wall_s": wall,
            "tokens_per_s": sum(len(o.token_ids) for o in outs) / wall,
            "decode_step_ms_mean": (sum(decode_ms) / len(decode_ms)
                                    if decode_ms else None),
            "ttft_ms_mean": 1e3 * sum(ttft) / len(ttft),
            "warmup_seconds": engine.warmup_seconds,
            "steps": len(engine.stats)}


def bf16_step(torch, v):
    """The spacing of bf16 values at |v|: 2^(floor(log2 |v|) - 7)."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp(min=2 ** -126)))
                      - 7)


def dense_gather_check(torch, cfg, params, prompts, dense_outs,
                       witness_tol):
    """K1-K4 inside the served model, held numerically as
    ``moe_gather_check`` holds K1 + K2: each of DENSE_CHECK_PROMPTS
    prefilled, then the dense engine's greedy tokens teacher-forced
    through ``lm.paged_decode_step`` (``run_paged``) under the gather FFN
    (K1 + K2, K3, K4) and under the dense FFN (K3, K4) -- the same
    attention kernels on both; the FFNs round differently -- on the
    model's first layer (``layers_1``) and on all it serves. The caller
    asserts: on one layer the two within LOGIT_TOL beyond one bf16 step of
    the logit itself (the logits are bf16; at llama3-405b's largest, 16-32,
    one step is 0.125, above LOGIT_TOL). At the served depth the two
    paths' rounding compounds through each gated FFN, so each is held
    against a witness, ``f32_rows``: the same weights and tokens through
    ``lm.forward`` in float32 on the CPU (the plain dense FFN), each path
    within ``witness_tol`` of it beyond one bf16 step, and gather no
    farther from it than dense by more than LOGIT_TOL. Launches here are
    not the main path's and are not counted."""
    one = dataclasses.replace(cfg, num_layers=1)
    first = paged_rows(torch, one, first_layers(params, 1), prompts,
                       dense_outs)
    served = paged_rows(torch, cfg, params, prompts, dense_outs)
    t0 = time.perf_counter()
    ref = f32_rows(torch, cfg, params, prompts, dense_outs)
    return {"layers_1": logits_apart(torch, first["gather"],
                                     first["dense"]),
            f"layers_{cfg.num_layers}": logits_apart(
                torch, served["gather"], served["dense"]),
            "f32_witness": {
                **{be: logits_apart(torch, served[be], ref)
                   for be in ("gather", "dense")},
                "tolerance": witness_tol,
                "wall_s": time.perf_counter() - t0},
            "prompts": list(DENSE_CHECK_PROMPTS),
            "positions": len(ref) // len(DENSE_CHECK_PROMPTS),
            "tolerance": LOGIT_TOL}


def paged_rows(torch, cfg, params, prompts, dense_outs):
    """The logits rows of ``dense_gather_check``'s prompts, the dense
    run's tokens teacher-forced, under gather and under dense, on
    ``cfg``'s layers of ``params`` (bf16, the card)."""
    rows = {"gather": [], "dense": []}
    with torch.no_grad():
        for ridx in DENSE_CHECK_PROMPTS:
            forced = dense_outs[ridx].token_ids[:-1]
            for be in rows:
                rows[be] += run_paged(torch, params, cfg, prompts[ridx],
                                      len(forced), "cuda", forced=forced,
                                      backend=be)
    return rows


def f32_rows(torch, cfg, params, prompts, dense_outs):
    """``paged_rows``'s positions from ``lm.forward`` in float32 on the
    CPU over each prompt and its teacher-forced tokens (causal: its row at
    a position is the decode step's there), the plain dense FFN, on the
    same weights."""
    from repro_torch.models import lm
    from repro_torch.tree import tree_map
    cfg32 = dataclasses.replace(
        cfg, dtype="float32", param_dtype="float32", remat="none",
        sparsity=dataclasses.replace(cfg.sparsity, ffn_impl="dense"))
    cpu = tree_map(lambda t: t.to("cpu").float(), lm.trainable(params))
    rows = []
    with torch.no_grad():
        for ridx in DENSE_CHECK_PROMPTS:
            prompt = prompts[ridx]
            toks = prompt + dense_outs[ridx].token_ids[:-1]
            logits, _ = lm.forward(
                cpu, {"tokens": torch.tensor([toks], dtype=torch.int32)},
                cfg32)
            rows += list(logits[0, len(prompt) - 1:])
    return rows


def logits_apart(torch, rows_a, rows_b):
    """How far two lists of logits rows are apart: the largest and the
    median of the rows' largest differences, and the largest beyond one
    bf16 step of the larger logit."""
    diffs, beyond = [], []
    for a, b in zip(rows_a, rows_b, strict=True):
        d = (a - b).abs()
        diffs.append(float(d.max()))
        beyond.append(float((d - bf16_step(
            torch, torch.maximum(a.abs(), b.abs()))).max()))
    return {"max_abs_diff": max(diffs),
            "median_abs_diff": statistics.median(diffs),
            "max_beyond_one_bf16_step": max(beyond)}


def phase_serve_dense(torch):
    """phi3-mini-3.8b (8 layers: head dim 96), deepseek-67b (2 layers: 64
    heads over 8 KV heads of 128, d_model 8192, d_ff 22016) and
    llama3-405b (2 layers: 128 heads over 8, d_model 16384, d_ff 53248:
    K2 past K 8192) at full width in bf16 with KEEP of every layer's gate
    columns alive, through the engine with the serve phase's settings
    (paged, block 16, 4 requests a batch, 64-token prefill chunks), warmed
    (every program captured as a CUDA graph first) on the serve phase's
    six prompts drawn over each config's vocabulary, DENSE_GEN greedy
    tokens each: the gather FFN (K1-K4 each launched over exactly this
    run, no TwELL overflow, the prefix cache hit, a clean pool), then the
    dense FFN (``--ffn-impl dense``) on a fresh warmed engine, tokens equal
    up to each request's first near-tie (LOGIT_TOL); ``dense_gather_check``
    holds the gather logits against dense's on the first layer, and both
    against float32 on the CPU at the served depth. Tokens/s, the decode
    step
    and TTFT of each. Returns the gather runs' launches and phi3's first 2
    layers for ``check``."""
    import numpy as np
    from repro_torch.observability import accounting
    from repro_torch.tree import leaves_with_path, tree_map
    launches, runs, phi3 = {}, [], None
    for arch, layers, witness_tol in DENSE_SERVE:
        cfg, params = dense_model(torch, arch, layers)
        prompts = serve_prompts(np.random.RandomState(SEED), cfg.vocab_size)
        engine, outs, wall, counts = warm_run(torch, cfg, params, prompts,
                                              DENSE_GEN)
        assert all(counts[k] > 0 for k in SERVE_KERNELS), \
            f"{arch}: a kernel of the gather path never launched: {counts}"
        assert engine.cached_tokens_total > 0, \
            f"{arch}: the prefix cache never hit"
        gather = {**dense_run_numbers(engine, outs, wall),
                  "launches": {k: counts[k] for k in SERVE_KERNELS}}
        for k in SERVE_KERNELS:
            launches[k] = launches.get(k, 0) + counts[k]
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        dengine, douts, dwall, _ = warm_run(torch, cfg, params, prompts,
                                            DENSE_GEN, backend="dense",
                                            record_logits=True)
        dense = dense_run_numbers(dengine, douts, dwall)
        del dengine
        gc.collect()
        torch.cuda.empty_cache()
        ties = first_near_ties(torch, douts)
        compared = equal_before(outs, [o.token_ids for o in douts], ties,
                                f"{arch} gather against dense")
        check = dense_gather_check(torch, cfg, params, prompts, douts,
                                   witness_tol)
        res = {"arch": arch, "layers": cfg.num_layers,
               "d_model": cfg.d_model, "heads": cfg.num_heads,
               "kv_heads": cfg.num_kv_heads,
               "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
               "vocab": cfg.padded_vocab,
               "params": accounting.param_count(params),
               "param_bytes": sum(t.numel() * t.element_size()
                                  for _, t in leaves_with_path(params)),
               "requests": len(prompts), "new_tokens": DENSE_GEN,
               "gather": gather, "dense": dense, "near_ties": ties,
               "tokens_compared": compared,
               "tokens_equal": [o.token_ids == w.token_ids
                                for o, w in zip(outs, douts)],
               "gather_vs_dense": check}
        runs.append(res)
        emit({"phase": "serve_dense", **res})
        one = check["layers_1"]
        assert one["max_beyond_one_bf16_step"] <= LOGIT_TOL, \
            f"{arch}: on one layer gather's logits differ from dense's by " \
            f"{one['max_abs_diff']}, {one['max_beyond_one_bf16_step']} " \
            "beyond a bf16 step"
        wit = check["f32_witness"]
        for be in ("gather", "dense"):
            assert wit[be]["max_beyond_one_bf16_step"] <= witness_tol, \
                f"{arch}: {be}'s logits differ from float32's by " \
                f"{wit[be]['max_abs_diff']}"
        assert wit["gather"]["max_abs_diff"] <= \
            wit["dense"]["max_abs_diff"] + LOGIT_TOL, \
            f"{arch}: gather is farther from float32 than dense: {wit}"
        if arch == "phi3-mini-3.8b":
            p2 = first_layers(params, 2)
            phi3 = (dataclasses.replace(cfg, num_layers=2),
                    {**p2, "blocks": tree_map(lambda t: t.clone(),
                                              p2["blocks"])}, prompts)
        del params, outs, douts
        gc.collect()
        torch.cuda.empty_cache()
    return {"launches": launches, "runs": runs, "phi3": phi3}


# --------------------------------------------------------------------------- #
# 6d-6e. the static-loop families at full width: zamba2-1.2b and rwkv6-7b
# (attention-free), whisper-large-v3 and llama-3.2-vision-11b (cross
# attention)
# --------------------------------------------------------------------------- #

# (arch, layers (None: all), requests, prompt tokens) through the serve
# CLI's static loop. zamba2's first 12 of its 38 layers (the shared block
# twice) and rwkv6's first 8 of 32: every layer here and in train_ssm
# would add ~90 s on an H100 (80GB HBM3, 700 W), ~130 s where its host is
# slower, to a script that must stay well inside its 1200 s limit
SSM_SERVE = (("zamba2-1.2b", 12, 4, 64), ("rwkv6-7b", 8, 4, 64))
# every layer: whisper's 32 encoder and 32 decoder layers (1.54 B
# parameters), vision's 40, 8 of them tanh-gated cross blocks (9.78 B),
# from a cross cache that ``lm.prefill_cross_cache`` filled
XATTN_SERVE = (("whisper-large-v3", None, 4, 64),
               ("llama-3.2-vision-11b", None, 4, 64))
STATIC_GEN = 32                    # greedy tokens a request
XATTN_FRAMES = 1500                # whisper's encoder frames (30 s of audio)
# the FFN kernels of each config's gather path: a gated FFN's K1 + K2
# (zamba2's shared block, vision's self and cross blocks), a non-gated
# one's K1, then K6 (rwkv6's channel mix with relu^2, whisper's FFN)
STATIC_KERNELS = {
    "zamba2-1.2b": ("twell_gate_matmul", "twell_fused_ffn"),
    "rwkv6-7b": ("twell_gate_matmul", "twell_down_proj"),
    "whisper-large-v3": ("twell_gate_matmul", "twell_down_proj"),
    "llama-3.2-vision-11b": ("twell_gate_matmul", "twell_fused_ffn")}
# (encoder layers, layers) of the first-layers checks (gather against
# dense in bf16, the float32 recurrence check, the card against the CPU):
# zamba2's first 6 (the shared block once), rwkv6's first 2, whisper's
# first 2 + 2, vision's first super-block (4 self blocks and its cross
# block)
STATIC_CHECK_DEPTH = {"zamba2-1.2b": (0, 6), "rwkv6-7b": (0, 2),
                      "whisper-large-v3": (2, 2),
                      "llama-3.2-vision-11b": (0, 5)}
XATTN_CHECK_PLEN = 16              # prompt tokens of the cross families'
#                                    CPU check (the attention-free ones
#                                    take the whole prompt)
# each bf16 path's logits against float32's at the served depth, the dense
# run's tokens teacher-forced through all three: 1.5x the larger path's
# reading on the H100 (80GB HBM3, 700 W) at SSM_SERVE's and XATTN_SERVE's
# depths: 0.1075 zamba2 (12 layers), 1.2782 rwkv6 (8), 0.0512 whisper,
# 0.1049 vision (logit std 0.91, 1.28, 0.72, 1.28). On random weights bf16
# rounding grows through the depth and the recurrent state: rwkv6 at all
# 32 layers ends as far from float32 as its logits spread, gather and
# dense alike, as the JAX package's bf16 forward does
# (tests/test_torch_ssm.py::test_bf16_gap_to_float32_grows_as_in_jax)
STATIC_SERVED_TOL = {"zamba2-1.2b": 0.16, "rwkv6-7b": 1.9,
                     "whisper-large-v3": 0.08, "llama-3.2-vision-11b": 0.16}
SSM_RECUR_LEN = 512                # tokens: 2 SSD chunks, 2 WKV chunks
SSM_RECUR_TOL = 1e-3               # float32 decode against the chunked
#                                    forward: sums in other orders (the
#                                    chunks' products against the per-token
#                                    states), logits of order 1


def static_pattern(params):
    """The weights whose columns the FFN's pattern follows, as views:
    zamba2's shared block's W_g, each rwkv6 layer's channel-mix W_u,
    whisper's encoder and decoder W_u, vision's self and cross W_g."""
    if "enc_blocks" in params:
        return list(params["enc_blocks"]["ffn"]["wu"]) + \
            list(params["dec_blocks"]["ffn"]["wu"])
    if "shared_attn" in params:
        return [params["shared_attn"]["ffn"]["wg"]]
    blocks = params["blocks"]
    if "cm" in blocks:
        return list(blocks["cm"]["wu"])
    return [w for ws in blocks["selfs"]["ffn"]["wg"] for w in ws] + \
        list(blocks["cross"]["ffn"]["wg"])


def static_model(torch, arch, layers=None, impl="gather", alive=None):
    """``arch`` at full width (``layers`` decoder layers, all unless
    given) in bfloat16 with the FFN as ``impl``, random weights from SEED
    (lm.init), all but KEEP of the pattern's columns zeroed (or exactly
    ``alive`` alive): the counterpart of ``model_and_prompts``'s gate
    sparsity. Every vision cross block's gates are set nonzero, different
    per block (at init's zeros the cross blocks add nothing)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, ffn_impl=impl))
    params = lm.init(cfg, device="cuda", seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    for w in static_pattern(params):
        if alive is None:
            w *= (torch.rand((1, cfg.d_ff), generator=gen, device="cuda")
                  < KEEP).to(w)
        else:
            w *= alive_columns(torch, gen, cfg.d_ff).to(w)
    if cfg.family == "vlm":
        cross = params["blocks"]["cross"]
        nb = cross["gate_attn"].shape[0]
        cross["gate_attn"].copy_(torch.linspace(0.5, 1.0, nb))
        cross["gate_ffn"].copy_(torch.linspace(-0.9, -0.4, nb))
    return cfg, params


def static_extras(torch, cfg, batch, seed):
    """The batch extra of a cross family from ``seed``, bf16 on the card:
    whisper's frames (batch, XATTN_FRAMES, D), vision's patches (batch,
    num_image_tokens, D), standard normal; {} for the other families."""
    if cfg.family not in ("audio", "vlm"):
        return {}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    name, length = ("frames", XATTN_FRAMES) if cfg.family == "audio" \
        else ("patches", cfg.num_image_tokens)
    return {name: torch.randn((batch, length, cfg.d_model), generator=gen,
                              device="cuda").bfloat16()}


def static_cache(torch, cfg, params, extras, batch, cache_len):
    """``lm.init_cache`` sized from ``extras`` on the parameters' device,
    then ``lm.prefill_cross_cache``; None without extras (the static loop
    and ``moe_forced_logits`` then make their own)."""
    from repro_torch.models import lm
    if not extras:
        return None
    enc_len = extras["frames"].shape[1] if "frames" in extras else 0
    cache = lm.init_cache(cfg, batch, cache_len,
                          device=params["embed"].device, enc_len=enc_len,
                          num_patches=cfg.num_image_tokens)
    with torch.no_grad():
        return lm.prefill_cross_cache(params, cache, extras, cfg)


def static_run(torch, cfg, params, prompt, extras, impl):
    """The cross cache of ``extras`` (``static_cache``), then the serve
    CLI's static loop from it (``launch/serve.py:generate``, greedy,
    STATIC_GEN new tokens) with the FFN as ``impl``: tokens, each
    generated step's logits, the seconds of the two and the kernel
    launches over exactly both."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, ffn_impl=impl))
    cache_len = prompt.shape[1] + STATIC_GEN + 1
    logits = []
    ops.OverflowLog.reset()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = static_cache(torch, cfg, params, extras, prompt.shape[0],
                         cache_len)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    toks = serve.generate(params, cfg, prompt, STATIC_GEN, cache_len,
                          logits_out=logits, cache=cache)
    torch.cuda.synchronize()
    return toks, logits, {"prefill_cross_s": t1 - t0,
                          "wall_s": time.perf_counter() - t1}, \
        ops.launch_counts()


def static_first_layers(cfg, params, arch):
    """``cfg`` and ``params`` cut to ``arch``'s STATIC_CHECK_DEPTH: the
    first encoder and decoder layers (vision: whole super-blocks;
    zamba2's shared block kept whole)."""
    from repro_torch.tree import tree_map
    enc, dec = STATIC_CHECK_DEPTH[arch]
    if cfg.family == "audio":
        cut = {"enc_blocks": tree_map(lambda t: t[:enc],
                                      params["enc_blocks"]),
               "dec_blocks": tree_map(lambda t: t[:dec],
                                      params["dec_blocks"])}
        return dataclasses.replace(cfg, encoder_layers=enc,
                                   num_layers=dec), {**params, **cut}
    n = dec // cfg.cross_every if cfg.family == "vlm" else dec
    return dataclasses.replace(cfg, num_layers=dec), \
        {**params, "blocks": tree_map(lambda t: t[:n], params["blocks"])}


def static_forced(torch, cfg, params, extras, toks, first, impl):
    """``toks`` teacher-forced through decode (``moe_forced_logits``)
    from a cross cache of ``extras`` (none without them), the FFN as
    ``impl``."""
    cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, ffn_impl=impl))
    cache = static_cache(torch, cfg, params, extras, toks.shape[0],
                         toks.shape[1] + 1)
    return moe_forced_logits(torch, cfg, params, toks, first, cache=cache)


def static_gather_check(torch, arch, cfg, params, extras, toks, plen):
    """The FFN kernels inside the decode and (whisper) the encoder, held
    numerically: the first STATIC_CHECK_DEPTH layers in bf16, the dense
    run's tokens teacher-forced under gather and under dense (the cross
    cache made again under each), logits at every generated position
    within LOGIT_TOL. Launches here are not the main path's."""
    c1, p1 = static_first_layers(cfg, params, arch)
    t0 = time.perf_counter()
    got = {impl: static_forced(torch, c1, p1, extras, toks[:, :-1],
                               plen - 1, impl)
           for impl in ("gather", "dense")}
    torch.cuda.synchronize()
    err = (got["gather"] - got["dense"]).abs().amax(dim=-1)
    return {"layers": list(STATIC_CHECK_DEPTH[arch]), "dtype": "bfloat16",
            "max_abs_diff": float(err.max()),
            "median_abs_diff": float(err.median()),
            "positions": [plen - 1, toks.shape[1] - 2],
            "tolerance": LOGIT_TOL, "wall_s": time.perf_counter() - t0}


def static_served_check(torch, cfg, params, extras, dtoks, dlogits, plen):
    """The dense run's tokens ``dtoks`` teacher-forced at the served depth
    through decode under gather (bf16, from a cross cache of ``extras``),
    beside the dense run's own logits ``dlogits`` (the static loop
    teacher-forces the same tokens, so they are the forced dense logits)
    and float32's: the bf16 weights widened (``wu_t`` left out: the dense
    FFN does not read it) through ``lm.forward`` over the same tokens and
    extras (causal: its row at a position is the decode step's there; one
    pass in place of a decode step a position). Each pair's max and
    median abs difference over the generated positions, and the float32
    logits' scale."""
    from repro_torch.models import lm
    from repro_torch.tree import tree_map
    forced = {"dense": torch.stack(dlogits, dim=1),
              "gather": static_forced(torch, cfg, params, extras,
                                      dtoks[:, :-1], plen - 1, "gather")}
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                                sparsity=dataclasses.replace(
                                    cfg.sparsity, ffn_impl="dense"))
    p32 = tree_map(lambda t: t.float(), lm.trainable(params))
    with torch.no_grad():
        fwd, _ = lm.forward(p32, {"tokens": dtoks[:, :-1], **extras}, cfg32)
    forced["float32"] = fwd[:, plen - 1:].float()
    del p32, fwd
    gc.collect()
    torch.cuda.empty_cache()
    out = {"layers": cfg.num_layers,
           "float32_logit_absmax": float(forced["float32"].abs().max()),
           "float32_logit_std": float(forced["float32"].std())}
    for a, b in (("gather", "dense"), ("gather", "float32"),
                 ("dense", "float32")):
        err = (forced[a] - forced[b]).abs().amax(dim=-1)
        out[f"{a}_vs_{b}"] = {"max_abs_diff": float(err.max()),
                              "median_abs_diff": float(err.median())}
    return out


def ssm_recurrence_check(torch, cfg, params, arch):
    """The recurrent decode against the chunked training forward, in
    float32 on the card: the first STATIC_CHECK_DEPTH layers of ``params``
    widened to float32, SSM_RECUR_LEN random tokens teacher-forced through
    ``decode_step`` (the per-token Mamba2 state and WKV scan), their logits
    at every position held within SSM_RECUR_TOL of ``lm.forward``'s (the
    chunked SSD and WKV, 2 chunks of 256 each) on the same tokens, dense
    FFN."""
    import numpy as np
    from repro_torch.models import lm
    from repro_torch.tree import tree_map
    c1, p1 = static_first_layers(cfg, params, arch)
    cfg32 = dataclasses.replace(c1, dtype="float32", param_dtype="float32",
                                sparsity=dataclasses.replace(
                                    cfg.sparsity, ffn_impl="dense"))
    p32 = tree_map(lambda t: t.float(), p1)
    rng = np.random.RandomState(SEED + 1)
    toks = torch.tensor(rng.randint(0, cfg.vocab_size, (1, SSM_RECUR_LEN)),
                        dtype=torch.int64, device="cuda")
    t0 = time.perf_counter()
    got = moe_forced_logits(torch, cfg32, p32, toks, 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with torch.no_grad():
        fwd, _ = lm.forward(p32, {"tokens": toks}, cfg32)
    err = (got - fwd.float()).abs().amax(dim=-1)[0]
    del p32, got, fwd
    return {"layers": c1.num_layers, "dtype": "float32",
            "tokens": SSM_RECUR_LEN,
            "max_abs_diff": float(err.max()),
            "median_abs_diff": float(err.median()),
            "max_abs_diff_first_chunk": float(err[:256].max()),
            "max_abs_diff_second_chunk": float(err[256:].max()),
            "tolerance": SSM_RECUR_TOL,
            "decode_step_ms": wall / SSM_RECUR_LEN * 1e3}


def serve_static(torch, phase, table):
    """Each config of ``table`` (SSM_SERVE or XATTN_SERVE) at its depth
    and full width in bf16, KEEP of the FFN pattern's columns alive:
    ``prefill_cross_cache`` over its frames or patches (whisper's encoder
    over the 6000 frame rows: K1, then K6, once a layer), then the serve
    CLI's static loop from that cache, greedy, under gather (the
    STATIC_KERNELS at every FFN a step: zamba2's shared block at each of
    its applications, every layer of the others; counted exactly, the
    other FFN kernel never) and then dense, no TwELL overflow, finite
    logits. The dense run's tokens teacher-forced through gather and dense
    on the first STATIC_CHECK_DEPTH layers (within LOGIT_TOL: the kernels
    inside the decode, held numerically) and at the served depth through
    both and float32 (each within STATIC_SERVED_TOL of float32). Tokens
    equal up to each request's first near-tie: a top-2 margin of dense's
    logits at most LOGIT_TOL or twice the served gather-to-dense gap, the
    most by which that gap can turn a token. The cross cache's seconds,
    tokens/s, the step time and a traced gather step from the served cross
    cache; the attention-free families' ``ssm_recurrence_check``. Keeps
    each config's first layers, its prompt (a cross family's first
    XATTN_CHECK_PLEN tokens) and its extras on the CPU for
    ``phase_check``."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.observability import accounting
    runs, launches, check = [], {}, {}
    ffn_kernels = ("twell_gate_matmul", "twell_fused_ffn", "twell_down_proj")
    for arch, layers, batch, plen in table:
        cfg, params = static_model(torch, arch, layers)
        extras = static_extras(torch, cfg, batch, SEED + 11)
        steps = plen + STATIC_GEN
        ffn_step = cfg.num_layers // cfg.shared_attn_every \
            if cfg.family == "hybrid" else cfg.num_layers
        enc_calls = cfg.encoder_layers
        rng = np.random.RandomState(SEED)
        prompt = torch.tensor(rng.randint(0, cfg.vocab_size, (batch, plen)),
                              dtype=torch.int64, device="cuda")
        toks, logits, secs, counts = static_run(
            torch, cfg, params, prompt, extras, "gather")
        overflow = ops.OverflowLog.seen()
        dtoks, dlogits, dsecs, _ = static_run(
            torch, cfg, params, prompt, extras, "dense")
        # three gather decode steps (two prompt tokens, one new) traced,
        # from a cross cache of the served frames or patches
        cache = static_cache(torch, cfg, params, extras, batch, 4)
        prof = profile_fn(torch, lambda: serve.generate(
            params, cfg, prompt[:, :2], 1, 4, cache=cache))
        del cache
        few = static_gather_check(torch, arch, cfg, params, extras, dtoks,
                                  plen)
        served = static_served_check(torch, cfg, params, extras, dtoks,
                                     dlogits, plen)
        tie_tol = max(LOGIT_TOL,
                      2 * served["gather_vs_dense"]["max_abs_diff"])
        ties = serve.first_near_ties(dlogits, tie_tol)
        res = {"arch": arch, "family": cfg.family,
               "layers": cfg.num_layers,
               "encoder_layers": cfg.encoder_layers,
               "d_model": cfg.d_model, "d_ff": cfg.d_ff,
               "gated": cfg.gated, "norm": cfg.norm,
               "params": accounting.param_count(lm.trainable(params)),
               "requests": batch, "prompt_len": plen,
               "new_tokens": STATIC_GEN, "decode_steps": steps,
               "cross_len": next(iter(extras.values())).shape[1]
               if extras else 0,
               "ffn_per_step": ffn_step, "encoder_ffn_calls": enc_calls,
               "gather": {**secs, "step_ms": secs["wall_s"] / steps * 1e3,
                          "tokens_per_s": batch * STATIC_GEN /
                          secs["wall_s"],
                          "launches": {k: counts.get(k, 0)
                                       for k in ffn_kernels}},
               "dense": {**dsecs, "step_ms": dsecs["wall_s"] / steps * 1e3,
                         "tokens_per_s": batch * STATIC_GEN /
                         dsecs["wall_s"]},
               "profiled_gather_step": {
                   "kernels": prof["kernel_calls"] / 3,
                   "wall_ms": prof["wall_ms"] / 3,
                   "device_busy_share": prof["device_busy_share"],
                   "top_kernels": prof["top_kernels"][:6]},
               "gather_vs_dense_first_layers": few,
               "gather_vs_dense_served": served,
               "served_tolerance": STATIC_SERVED_TOL[arch],
               "near_tie_tolerance": tie_tol, "near_ties": ties,
               "near_ties_at_logit_tol": serve.first_near_ties(dlogits),
               "tokens_equal_before": [
                   int(next((j for j in range(STATIC_GEN)
                             if toks[r, plen + j] != dtoks[r, plen + j]),
                            STATIC_GEN)) for r in range(batch)],
               "overflow": overflow,
               "first_tokens": toks[:, plen].tolist()}
        if cfg.family in ("hybrid", "ssm"):
            res["decode_vs_forward_f32"] = ssm_recurrence_check(
                torch, cfg, params, arch)
        runs.append(res)
        emit({"phase": phase, **res})
        for k in ffn_kernels:
            want = steps * ffn_step + enc_calls \
                if k in STATIC_KERNELS[arch] else 0
            assert counts.get(k, 0) == want, \
                f"{arch}: {k} launched {counts.get(k, 0)} times, not " \
                f"{want} ({ffn_step} FFNs a step, {steps} steps, " \
                f"{enc_calls} in the encoder)"
        for k in STATIC_KERNELS[arch]:
            launches[k] = launches.get(k, 0) + counts[k]
        assert not overflow, f"{arch}: a TwELL tile overflowed"
        assert all(bool(torch.isfinite(lg).all()) for lg in logits), \
            f"{arch}: non-finite logits"
        assert few["max_abs_diff"] <= LOGIT_TOL, \
            f"{arch}: gather's decode logits differ from dense's by " \
            f"{few['max_abs_diff']} at {few['layers']} layers"
        for path in ("gather", "dense"):
            err = served[f"{path}_vs_float32"]["max_abs_diff"]
            assert err <= STATIC_SERVED_TOL[arch], \
                f"{arch}: {path}'s served logits differ from float32's by " \
                f"{err}"
        for r, n in enumerate(ties):
            assert torch.equal(toks[r, plen:plen + n],
                               dtoks[r, plen:plen + n]), \
                f"{arch} row {r}: gather and dense differ before the " \
                f"first near-tie ({n})"
        if "decode_vs_forward_f32" in res:
            recur = res["decode_vs_forward_f32"]
            assert recur["max_abs_diff"] <= SSM_RECUR_TOL, \
                f"{arch}: float32 decode differs from the chunked " \
                f"forward by {recur['max_abs_diff']}"
        c1, p1 = static_first_layers(cfg, params, arch)
        check[arch] = (c1, lm.params_to(p1, "cpu"),
                       prompt[0, :XATTN_CHECK_PLEN if extras else plen]
                       .tolist(),
                       {k: v[:1].cpu() for k, v in extras.items()})
        del params, logits, dlogits, p1, extras
        gc.collect()
        torch.cuda.empty_cache()
    return {"launches": launches, "runs": runs, "check": check}


def phase_serve_ssm(torch):
    """zamba2-1.2b and rwkv6-7b (SSM_SERVE) through ``serve_static``:
    zamba2's K1 + K2 at each of the shared block's applications a step,
    rwkv6's K1 with relu^2, then K6, in every layer a step; then
    ``ssm_recurrence_check``."""
    return serve_static(torch, "serve_ssm", SSM_SERVE)


def phase_serve_xattn(torch):
    """whisper-large-v3 (32 encoder and 32 decoder layers, 4 x
    XATTN_FRAMES frames: K1, then K6, in the encoder once a layer and in
    every decoder layer a step) and llama-3.2-vision-11b (all 40 layers, 4
    x 1024 patches, the cross gates nonzero: K1 + K2 in its 32 self and 8
    cross blocks a step) through ``serve_static``."""
    return serve_static(torch, "serve_xattn", XATTN_SERVE)


# --------------------------------------------------------------------------- #
# 7. training: full-width paper-0.5b through the hybrid FFN
# --------------------------------------------------------------------------- #

TRAIN_KERNELS = ("flash_attention", "hybrid_to_dense", "dense_to_hybrid")


def train_setup(torch, cfg):
    """Seeded random weights of ``cfg`` on the card with TRAIN_ALIVE of
    every layer's pattern columns alive (W_g's, or W_u's in a non-gated
    FFN), as the trainable tree."""
    from repro_torch.models import lm
    params = lm.init(cfg, device="cuda", seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    ffn = params["blocks"]["ffn"]
    for w in ffn["wg"] if cfg.gated else ffn["wu"]:
        w *= alive_columns(torch, gen, cfg.d_ff).to(w)
    return lm.trainable(params)


def train_config(impl, layers=None, arch="paper-0.5b", remat="none"):
    """``arch`` with the FFN trained as ``impl``, under ``remat`` (the
    train phase and the check keep every activation, as they always
    have; None keeps the config's own mode)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, ffn_impl=impl))
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return cfg


def train_batches(torch, cfg, batch, seq, steps):
    from repro_torch.data.pipeline import SyntheticLM
    data = SyntheticLM(cfg.vocab_size, batch, seq, seed=SEED)
    return [{k: torch.from_numpy(v).to("cuda") for k, v in next(data).items()}
            for _ in range(steps)]


def train_run(torch, impl):
    """TRAIN_STEPS AdamW steps of full-width, full-depth paper-0.5b through
    the port's make_train_step, on SyntheticLM batches of TRAIN_BATCH x
    TRAIN_SEQ; then one more step under the profiler. Launch counts, the
    hybrid log and peak memory cover exactly the TRAIN_STEPS steps."""
    from repro_torch import training
    from repro_torch.config import TrainConfig
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    cfg = train_config(impl)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()    # what earlier phases still hold
    params = train_setup(torch, cfg)
    opt = adamw.init(params)
    step = training.make_train_step(cfg, TrainConfig(
        learning_rate=1e-3, warmup_steps=1, total_steps=TRAIN_STEPS + 1))
    batches = train_batches(torch, cfg, TRAIN_BATCH, TRAIN_SEQ,
                            TRAIN_STEPS + 1)
    ops.HybridOverflowLog.reset()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, nnz, step_ms = [], [], [], []
    for b in batches[:TRAIN_STEPS]:
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, b)
        losses.append(float(metrics["loss"]))    # syncs: the step is done
        step_ms.append((time.perf_counter() - t0) * 1e3)
        gnorms.append(float(metrics["grad_norm"]))
        nnz.append([float(metrics["nnz_mean"]), int(metrics["nnz_max"])])
    peak = torch.cuda.max_memory_allocated()
    launches = ops.launch_counts()
    overflow = ops.HybridOverflowLog.seen()
    ell_rows, backup_rows = ops.HybridOverflowLog.rows()
    holder = {"params": params, "opt": opt}

    def one_step():
        holder["params"], holder["opt"], m = step(
            holder["params"], holder["opt"], batches[TRAIN_STEPS])
        float(m["loss"])
    prof = profile_fn(torch, one_step)
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]     # median
    tokens = TRAIN_BATCH * TRAIN_SEQ
    return {"phase": "train", "impl": impl, "steps": TRAIN_STEPS,
            "losses": losses, "grad_norms": gnorms,
            "nnz_mean_max_per_step": nnz, "step_ms": step_ms,
            "step_ms_median_after_first": steady,
            "tokens_per_s": tokens / steady * 1e3,
            "peak_mem_bytes": peak, "base_mem_bytes": base,
            "launches": launches,
            "hybrid_overflow": overflow, "ell_rows": ell_rows,
            "backup_rows": backup_rows,
            "profiled_step": {k: prof[k] for k in (
                "wall_ms", "device_kernel_ms", "device_busy_share")},
            "top_kernels": prof["top_kernels"][:8]}


TRAIN_PEAKS = {}    # impl -> the train phase's run (its measured peak)


def phase_train(torch):
    """The hybrid run (K7, K8, K9 each launched, no overflow, both sides
    of the format used, finite and falling loss), then the same steps with
    the dense FFN beside it: the paper's Table 1 comparison, reported.
    One line for each run, then one for the gradient check."""
    hybrid = train_run(torch, "hybrid")
    TRAIN_PEAKS["hybrid"] = hybrid
    emit(hybrid)
    launches = hybrid["launches"]
    assert all(launches[k] > 0 for k in TRAIN_KERNELS), \
        f"a kernel of the training path never launched: {launches}"
    assert not hybrid["hybrid_overflow"], "the hybrid dense backup overflowed"
    assert hybrid["ell_rows"] > 0 and hybrid["backup_rows"] > 0, \
        f"a side of the hybrid format is empty: {hybrid['ell_rows']} ELL, " \
        f"{hybrid['backup_rows']} backup rows"
    finite = [x for x in hybrid["losses"] + hybrid["grad_norms"]
              if x == x and abs(x) != float("inf")]
    assert len(finite) == 2 * TRAIN_STEPS, "non-finite loss or grad norm"
    assert hybrid["losses"][-1] < hybrid["losses"][0], \
        f"the loss did not fall: {hybrid['losses']}"
    torch.cuda.empty_cache()
    dense = train_run(torch, "dense")
    TRAIN_PEAKS["dense"] = dense
    emit(dense)
    assert dense["launches"]["flash_attention"] > 0
    emit(grad_check(torch))
    return hybrid


MESH_MOE_ROWS = (2, 1024)          # tokens through the sorted dispatch
CARD = {}                          # the nvidia-smi line, for the phases


def mesh_train_run(torch, rank, dev):
    """The train phase's hybrid run through the mesh step on a one-rank
    NCCL mesh (pod 1, data 1, model 1): the same weights, TrainConfig and
    batches, the launch counts over exactly the steps."""
    from repro_torch import training
    from repro_torch.config import TrainConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.optim import adamw
    import torch.distributed as dist
    mesh = mesh_mod.make_train_mesh((1, 1, 1), ("pod", "data", "model"),
                                    dev)
    assert dist.get_backend() == "nccl", dist.get_backend()
    cfg = train_config("hybrid")
    params = train_setup(torch, cfg)
    opt = adamw.init(params)
    step = training.make_train_step(cfg, TrainConfig(
        learning_rate=1e-3, warmup_steps=1, total_steps=TRAIN_STEPS + 1),
        mesh=mesh)
    batches = train_batches(torch, cfg, TRAIN_BATCH, TRAIN_SEQ,
                            TRAIN_STEPS + 1)
    ops.HybridOverflowLog.reset()
    ops.reset_launch_counts()
    losses, gnorms, step_ms = [], [], []
    for b in batches[:TRAIN_STEPS]:
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, b)
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        gnorms.append(float(metrics["grad_norm"]))
    res = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "backend": dist.get_backend(), "losses": losses,
           "grad_norms": gnorms, "step_ms": step_ms,
           "launches": ops.launch_counts(),
           "hybrid_overflow": ops.HybridOverflowLog.seen()}
    del params, opt, step
    return res


def mesh_moe_run(torch, rank, dev):
    """train_moe's full-width mixtral layer (hybrid FFN, TRAIN_ALIVE gate
    columns an expert, bf16) on MESH_MOE_ROWS tokens: moe_apply_sorted at
    data 1 with a capacity at which nothing can drop (C = T) against the
    one-hot dispatch, then at the config's capacity. Launches count the
    sorted dispatches only."""
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import lm, moe
    mesh = mesh_mod.make_train_mesh((1, 1, 1), ("pod", "data", "model"),
                                    dev)
    cfg, params = moe_model(torch, "mixtral-8x22b", 1, "hybrid",
                            alive=TRAIN_ALIVE)
    layer = lm._layer(params["blocks"]["moe"], 0)
    layer = {"router": layer["router"], "experts": {
        k: v for k, v in layer["experts"].items() if k != "wu_t"}}
    del params
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    x = torch.randn((*MESH_MOE_ROWS, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    launches = {}
    out = {}
    no_drop = dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.top_k)
    with torch.no_grad():
        for name, c in (("no_drop", no_drop), ("config", cfg)):
            ops.reset_launch_counts()
            y, aux = moe.moe_apply_sorted(layer, x, c, c.sparsity, True,
                                          mesh, ("pod", "data"))
            torch.cuda.synchronize()
            for k, n in ops.launch_counts().items():
                launches[k] = launches.get(k, 0) + n
            out[name] = (y, float(aux["moe_drop_frac"]))
        ref, _ = moe.moe_apply_onehot(layer, x, cfg, cfg.sparsity, True)
    y, no_drop_frac = out.pop("no_drop")
    err, ok = close_err(torch, y, ref)
    del layer, x, y, ref
    return {"tokens": list(MESH_MOE_ROWS), "experts": cfg.num_experts,
            "top_k": cfg.top_k,
            "no_drop_capacity_factor": no_drop.capacity_factor,
            "no_drop_frac": no_drop_frac, "max_abs_err_vs_onehot": err,
            "within_tol": ok, "capacity_factor": cfg.capacity_factor,
            "moe_drop_frac": out["config"][1], "launches": launches}


def phase_train_mesh(torch):
    """7m: the train phase's hybrid run through the mesh step on a
    one-rank NCCL mesh, held against the train phase's losses and grad
    norms, and the sorted MoE dispatch at full width (see the module
    docstring). Runs the train phase first if it has not run."""
    from repro_torch.distributed import ranks
    t0 = time.perf_counter()
    if "hybrid" not in TRAIN_PEAKS:
        TRAIN_PEAKS["hybrid"] = train_run(torch, "hybrid")
    ref = TRAIN_PEAKS["hybrid"]
    run = ranks.in_one_rank(lambda r, d: mesh_train_run(torch, r, d), "cuda")
    gc.collect()
    torch.cuda.empty_cache()
    diffs = {key: max(abs(a - b) for a, b in zip(run[key], ref[key]))
             for key in ("losses", "grad_norms")}
    bitwise = all(run[k] == ref[k] for k in ("losses", "grad_norms"))
    moe_res = ranks.in_one_rank(lambda r, d: mesh_moe_run(torch, r, d),
                                "cuda")
    gc.collect()
    torch.cuda.empty_cache()
    res = {"phase": "train_mesh", "card": CARD.get("smi"),
           "arch": "paper-0.5b", "impl": "hybrid", **run,
           "train_losses": ref["losses"], "train_grad_norms":
           ref["grad_norms"], "train_step_ms": ref["step_ms"],
           "max_abs_diff": diffs, "bitwise": bitwise,
           "tolerance": BF16_TOL, "moe": moe_res,
           "seconds": round(time.perf_counter() - t0, 1)}
    emit(res)
    missing = [k for k in TRAIN_KERNELS if run["launches"].get(k, 0) == 0]
    assert not missing, f"the mesh step never launched {missing}"
    assert not run["hybrid_overflow"], "the mesh step's backup overflowed"
    for key, d in diffs.items():
        worst = max(abs(v) for v in ref[key])
        assert d <= BF16_TOL * max(1.0, worst), \
            f"mesh step {key} off the train phase's by {d}"
    assert moe_res["within_tol"], \
        f"sorted MoE off the one-hot by {moe_res['max_abs_err_vs_onehot']}"
    assert moe_res["no_drop_frac"] == 0.0
    launches = dict(run["launches"])
    for k, n in moe_res["launches"].items():
        launches[k] = launches.get(k, 0) + n
    return {"launches": launches}


def grad_check(torch, m=4096, k=2048, n=5632, seed=SEED + 3, gated=True,
               act="relu"):
    """One full-width FFN layer in float32 (M rows, paper-0.5b's K 2048 and
    N 5632 unless given, TRAIN_ALIVE pattern columns alive): the hybrid
    autograd.Function (K8 and K9) against torch autograd of the dense
    formula, y = (x W_u * act(x W_g)) W_d, or act(x W_u) W_d when not
    ``gated`` (rwkv6-7b's channel mix: relu^2), with the L1 term mean|h|
    (``_dense_apply``). Tolerance: max |g - g_ref| <= GRAD_TOL max |g_ref|
    per gradient; both sides take float32 products summed in float32 in
    different orders (the kernels per row and slot, cuBLAS by tiles)."""
    from repro_torch.config import SparsityConfig
    from repro_torch.core import sparse_ffn
    gen = torch.Generator(device="cuda").manual_seed(seed)
    coeff = 0.5

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    x, gy = r(m, k), r(m, k, scale=1e-2)
    names = ("wg", "wu", "wd") if gated else ("wu", "wd")
    ws = {}
    for name in names:
        shape = (n, k) if name == "wd" else (k, n)
        ws[name] = r(*shape, scale=0.02)
        if name == names[0]:        # the weight the pattern follows
            ws[name] = ws[name] * alive_columns(torch, gen, n)
    leaves = [x] + [ws[w] for w in names]
    live = [t.clone().requires_grad_(True) for t in leaves]
    fn = sparse_ffn._HybridGated if gated else sparse_ffn._HybridNongated
    y, l1, nnz, _ = fn.apply(*live, 128, m // 8, act)
    got = torch.autograd.grad((y * gy).sum() + coeff * l1, live)
    ref = [t.clone().requires_grad_(True) for t in leaves]
    scfg = SparsityConfig(enabled=True, activation=act)
    y_ref, aux = sparse_ffn._dense_apply(dict(zip(names, ref[1:])), ref[0],
                                         scfg, gated, True)
    want = torch.autograd.grad((y_ref * gy).sum() + coeff * aux["l1"], ref)
    errs = {}
    for name, g, w in zip(("x",) + names, got, want):
        errs[name] = float((g - w).abs().max() / w.abs().max())
        assert errs[name] <= GRAD_TOL, \
            f"hybrid grad {name} off by {errs[name]} of its max"
    return {"phase": "grad_check", "M": m, "K": k, "N": n,
            "dtype": "float32", "gated": gated, "act": act,
            "tolerance": GRAD_TOL,
            "rel_max_err": errs, "backup_rows": int((nnz > 128).sum()),
            "mean_nnz": float(nnz.mean())}


# --------------------------------------------------------------------------- #
# 7a. the dry run: predicted peaks against the train phase's measured ones
# --------------------------------------------------------------------------- #

DRYRUN_TOL = 0.10                  # dense prediction vs the measured peak
# the trainings that wait on memory (ROADMAP.md queue 1 item 3): arch and
# layers, hybrid FFN, under the config's own remat
WAITING_TRAININGS = (("llama3-405b", 1), ("llama4-scout-17b-a16e", 2),
                     ("rwkv6-7b", 32))


def phase_dryrun(torch):
    """The port's dry run (``launch/dryrun.py``: the step on meta tensors,
    every kernel a shape function, no card) of the train phase's two
    steps, paper-0.5b hybrid and dense at TRAIN_BATCH x TRAIN_SEQ under
    remat none (the learning-rate settings move no byte), each predicted
    peak beside the train phase's measured one: ``max_memory_allocated``
    over its steps less what was allocated before its run began (the
    earlier phases' tensors). The dense prediction must be within
    DRYRUN_TOL of it; the hybrid's gap is printed (the trace takes the hybrid backward's
    columns at capacity, N, where the card takes the live ones). Then the
    predicted peaks, with no card run, of WAITING_TRAININGS on the same
    tokens. Runs the train phase first if it has not run."""
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import dryrun
    if not TRAIN_PEAKS:
        phase_train(torch)
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    card = torch.cuda.get_device_properties(0).total_memory
    out = {"phase": "dryrun", "tolerance": DRYRUN_TOL,
           "card_memory_bytes": card}
    for impl in ("hybrid", "dense"):
        t0 = time.perf_counter()
        _, ana = dryrun.trace_cell(train_config(impl), shape)
        run = TRAIN_PEAKS[impl]
        measured = run["peak_mem_bytes"] - run["base_mem_bytes"]
        out[impl] = {
            "predicted_peak_bytes": ana["peak_bytes"],
            "measured_peak_bytes": measured,
            "measured_max_memory_allocated": run["peak_mem_bytes"],
            "base_mem_bytes": run["base_mem_bytes"],
            "gap": (ana["peak_bytes"] - measured) / measured,
            "argument_bytes": ana["argument_bytes"],
            "dot_flops": ana["dot_flops_corrected"],
            "hbm_bytes": ana["hbm_bytes_estimate"],
            "kernel_calls": {k: v["calls"]
                             for k, v in ana["kernels"].items()},
            "trace_s": round(time.perf_counter() - t0, 2)}
    waiting = {}
    for arch, layers in WAITING_TRAININGS:
        t0 = time.perf_counter()
        cfg = train_config("hybrid", layers=layers, arch=arch, remat=None)
        _, ana = dryrun.trace_cell(cfg, shape)
        waiting[arch] = {"layers": layers, "remat": cfg.remat,
                         "predicted_peak_bytes": ana["peak_bytes"],
                         "argument_bytes": ana["argument_bytes"],
                         "fits_card": ana["peak_bytes"] <= card,
                         "trace_s": round(time.perf_counter() - t0, 2)}
    out["waiting"] = waiting
    emit(out)
    gap = out["dense"]["gap"]
    assert abs(gap) <= DRYRUN_TOL, \
        f"dense predicted peak {gap:+.1%} off the measured one"
    return out


# --------------------------------------------------------------------------- #
# 7b-7d. training at the paper's scale: recomputation, paper-1.5b, olmo-1b
# --------------------------------------------------------------------------- #

REMAT_MODES = ("none", "dots", "full", "2level")
REMAT_STEPS = 2
P15_STEPS = 3
P15_BATCHES = (8, 6, 4, 2, 1)      # tried in turn until dense at remat
#                                    "none" fits TRAIN_SEQ tokens a row
OLMO_TRAIN_STEPS = 5


def peak_of(torch, fn):
    """(fn(), max_memory_allocated over it, after reset_peak_memory_stats:
    whatever was allocated before counts too)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated()


def train_steps(torch, cfg, batches, params=None, profile=False):
    """AdamW steps of ``cfg`` through the port's make_train_step, one a
    batch, from ``params`` (default: ``train_setup``'s; the update makes
    new tensors, so a caller's tree is left as it was). First one loss and
    gradient on the first batch with the optimizer state allocated: its
    peak (``grad_peak_mem_bytes``) is the forward and backward's, which
    the step's can hide under AdamW's (the update allocates the new
    parameters, m and v, and float32 temporaries, before the old ones go).
    Launch counts, the hybrid log and the step peak (``peak_mem_bytes``,
    the parameters and optimizer state included) cover exactly the
    steps; with ``profile``, one more step on the first batch is traced
    after them (``profile_fn``: wall, kernels, busy share, the top 8)."""
    from repro_torch import training
    from repro_torch.config import TrainConfig
    from repro_torch.kernels import ops
    from repro_torch.observability import accounting
    from repro_torch.optim import adamw
    from repro_torch import device as device_mod
    params = train_setup(torch, cfg) if params is None else params
    n_params = accounting.param_count(params)
    opt = adamw.init(params, device_mod.torch_dtype(cfg.opt_state_dtype))
    _, grad_peak = peak_of(torch, lambda: loss_and_grads(
        torch, params, batches[0], cfg)[0])
    step = training.make_train_step(cfg, TrainConfig(
        learning_rate=1e-3, warmup_steps=1, total_steps=len(batches) + 1))
    ops.HybridOverflowLog.reset()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, b)
        losses.append(float(metrics["loss"]))     # syncs: the step is done
        step_ms.append((time.perf_counter() - t0) * 1e3)
    ell_rows, backup_rows = ops.HybridOverflowLog.rows()
    median = statistics.median(step_ms[1:] or step_ms)
    tokens = batches[0]["tokens"].numel()
    res = {"arch": cfg.name, "impl": cfg.sparsity.ffn_impl,
           "remat": cfg.remat, "layers": cfg.num_layers,
           "batch": list(batches[0]["tokens"].shape),
           "losses": losses, "step_ms": step_ms,
           "step_ms_median_after_first": median,
           "tokens_per_s": tokens / median * 1e3,
           # dense-equivalent 6 N D over the median step against the
           # card's bf16 peak (observability/accounting.py)
           "mfu": accounting.mfu(accounting.model_flops(
               cfg, n_params, tokens, train=True), median / 1e3),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "grad_peak_mem_bytes": grad_peak,
           "launches": ops.launch_counts(),
           "hybrid_overflow": ops.HybridOverflowLog.seen(),
           "ell_rows": ell_rows, "backup_rows": backup_rows}
    if profile:
        prof = profile_fn(torch, lambda: float(
            step(params, opt, batches[0])[2]["loss"]))
        res["profiled_step"] = {k: prof[k] for k in (
            "wall_ms", "kernel_calls", "device_kernel_ms",
            "device_busy_share")}
        res["top_kernels"] = prof["top_kernels"][:8]
    return res


def summed_launches(runs):
    out = {}
    for run in runs:
        for k, n in run["launches"].items():
            out[k] = out.get(k, 0) + n
    return out


def assert_trained(run, kernels):
    """Each of ``kernels`` launched, finite losses that fall; for the
    hybrid FFN rows on both sides of the format and no overflow."""
    what = f"{run['arch']} {run['impl']} remat={run['remat']}"
    missing = [k for k in kernels if run["launches"].get(k, 0) == 0]
    assert not missing, f"{what}: {missing} never launched"
    losses = run["losses"]
    assert all(x == x and abs(x) != float("inf") for x in losses), \
        f"{what}: non-finite loss {losses}"
    assert losses[-1] < losses[0], f"{what}: the loss did not fall {losses}"
    if run["impl"] == "hybrid":
        assert not run["hybrid_overflow"], f"{what}: the backup overflowed"
        assert run["ell_rows"] > 0 and run["backup_rows"] > 0, \
            f"{what}: a side of the hybrid format is empty " \
            f"({run['ell_rows']} ELL, {run['backup_rows']} backup rows)"


def phase_remat(torch):
    """paper-0.5b at full width and depth, hybrid FFN with TRAIN_ALIVE
    columns, TRAIN_BATCH x TRAIN_SEQ tokens: one loss and gradient under
    each of ``remat`` none, dots, full and 2level from the same parameters
    and batch, each bitwise equal to none's (recomputation reruns the same
    kernels, which use no atomics, on the same inputs), then REMAT_STEPS
    AdamW steps a mode (the same losses bit for bit). Peak memory and step
    time of each; peak(none) > peak(dots) > peak(full) asserted, 2level
    reported beside full. Recomputed kernels count again: the launches of
    a mode's gradient show it."""
    from repro_torch.kernels import ops
    cfg0 = train_config("hybrid")
    params = train_setup(torch, cfg0)
    batches = train_batches(torch, cfg0, TRAIN_BATCH, TRAIN_SEQ,
                            1 + REMAT_STEPS)
    ref, modes, runs = None, {}, []
    for mode in REMAT_MODES:
        cfg = dataclasses.replace(cfg0, remat=mode)
        ops.reset_launch_counts()
        (loss, grads), grad_peak = peak_of(torch, lambda: loss_and_grads(
            torch, params, batches[0], cfg))
        grad_launches = {k: n for k, n in ops.launch_counts().items()
                         if k in TRAIN_KERNELS}
        grads = {k: g.cpu() for k, g in grads.items()}
        if ref is None:
            ref = (loss, grads)
        unequal = {k: float((g.float() - ref[1][k].float()).abs().max())
                   for k, g in grads.items() if not torch.equal(g, ref[1][k])}
        del grads
        run = train_steps(torch, cfg, batches[1:], params=params)
        runs.append(run)
        modes[mode] = {"loss": loss, "loss_equal": loss == ref[0],
                       "unequal_grads": unequal,
                       "grad_peak_mem_bytes": grad_peak,
                       "grad_launches": grad_launches,
                       **{k: run[k] for k in (
                           "losses", "step_ms",
                           "step_ms_median_after_first", "peak_mem_bytes",
                           "launches")}}
        torch.cuda.empty_cache()
    res = {"phase": "remat", "arch": cfg0.name, "impl": "hybrid",
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "steps": REMAT_STEPS,
           "modes": modes}
    emit(res)
    for mode, m in modes.items():
        assert m["loss_equal"] and not m["unequal_grads"], \
            f"remat={mode}: loss or gradients differ from none's: " \
            f"{m['loss']} vs {modes['none']['loss']}, {m['unequal_grads']}"
        assert m["losses"] == modes["none"]["losses"], \
            f"remat={mode}: step losses differ from none's"
    for key in ("peak_mem_bytes", "grad_peak_mem_bytes"):
        peaks = [modes[m][key] for m in ("none", "dots", "full")]
        assert peaks[0] > peaks[1] > peaks[2], \
            f"{key} not none > dots > full: {peaks}"
    for run in runs:
        missing = [k for k in TRAIN_KERNELS if run["launches"][k] == 0]
        assert not missing, f"remat={run['remat']}: {missing} never launched"
        assert not run["hybrid_overflow"]
    return {"launches": summed_launches(runs)}


def p15_run(torch, impl, remat, batch):
    """P15_STEPS steps of paper-1.5b at full width and all 28 layers, or
    None where they do not fit the card."""
    cfg = train_config(impl, arch="paper-1.5b", remat=remat)
    try:
        return train_steps(torch, cfg, train_batches(
            torch, cfg, batch, TRAIN_SEQ, P15_STEPS))
    except torch.cuda.OutOfMemoryError:
        return None
    finally:
        gc.collect()
        torch.cuda.empty_cache()


def phase_train_1p5b(torch):
    """paper-1.5b (28 layers, d_model 2048, d_ff 5632) at full width and
    depth in bf16, the train phase's TRAIN_ALIVE columns a layer, hybrid
    and dense, each at remat none (the paper's Table 1 comparison) and full
    (the config's own), P15_STEPS steps each. The batch is TRAIN_BATCH x
    TRAIN_SEQ unless dense at none does not fit: then all four take the
    largest of P15_BATCHES rows that dense at none fits. Peak memory,
    step time and tokens/s of each, the hybrid/dense peak ratio at each
    mode; hybrid's peak below dense's at none asserted."""
    free, total = torch.cuda.mem_get_info()
    tried = []
    for batch in P15_BATCHES:
        dense_none = p15_run(torch, "dense", "none", batch)
        if dense_none is not None:
            break
        tried.append(batch)
    assert dense_none is not None, "paper-1.5b does not train on the card"
    runs = {("dense", "none"): dense_none}
    for impl, remat in (("dense", "full"), ("hybrid", "none"),
                        ("hybrid", "full")):
        run = p15_run(torch, impl, remat, batch)
        assert run is not None, f"paper-1.5b {impl} remat={remat} at " \
            f"batch {batch} ran out of memory"
        runs[(impl, remat)] = run
    res = {"phase": "train_1p5b", "arch": "paper-1.5b",
           "batch": [batch, TRAIN_SEQ], "batches_not_fitting": tried,
           "card_free_bytes_before": free, "card_total_bytes": total,
           "runs": [r for r in runs.values()],
           "hybrid_over_dense_peak": {
               key: {m: runs[("hybrid", m)][key] / runs[("dense", m)][key]
                     for m in ("none", "full")}
               for key in ("peak_mem_bytes", "grad_peak_mem_bytes")}}
    emit(res)
    for (impl, _), run in runs.items():
        assert_trained(run, TRAIN_KERNELS if impl == "hybrid"
                       else ("flash_attention",))
    for key, ratio in res["hybrid_over_dense_peak"].items():
        assert ratio["none"] < 1, \
            f"paper-1.5b: the hybrid {key} is not below dense's at none"
    return {"launches": summed_launches(runs.values())}


def phase_train_olmo(torch):
    """olmo-1b (16 layers, 16 heads of 128, non-gated d_ff 8192, non-
    parametric LayerNorm) at full width and depth in bf16 under its own
    remat ("full"), TRAIN_ALIVE of every layer's W_u columns alive (as many
    as the train phase keeps of W_g: rows on both sides of the hybrid
    format and no backup overflow), TRAIN_BATCH x TRAIN_SEQ tokens: the
    hybrid (non-gated) FFN then the dense one, OLMO_TRAIN_STEPS steps each.
    K7 at hd 128, K8 and K9 launched, finite and falling loss."""
    from repro_torch.configs import get_config
    remat = get_config("olmo-1b").remat
    runs = []
    for impl in ("hybrid", "dense"):
        cfg = train_config(impl, arch="olmo-1b", remat=remat)
        runs.append(train_steps(torch, cfg, train_batches(
            torch, cfg, TRAIN_BATCH, TRAIN_SEQ, OLMO_TRAIN_STEPS)))
        gc.collect()
        torch.cuda.empty_cache()
    hybrid, dense = runs
    emit({"phase": "train_olmo", "arch": "olmo-1b", "remat": remat,
          "alive_columns": TRAIN_ALIVE, "runs": runs,
          "hybrid_over_dense_peak": {
              key: hybrid[key] / dense[key]
              for key in ("peak_mem_bytes", "grad_peak_mem_bytes")}})
    assert_trained(hybrid, TRAIN_KERNELS)
    assert_trained(dense, ("flash_attention",))
    return {"launches": summed_launches(runs)}


# --------------------------------------------------------------------------- #
# 7e. training mixtral-8x22b's full-width layer
# --------------------------------------------------------------------------- #

MOE_TRAIN_STEPS = 4
MOE_TRAIN_BATCH = 8                # rows of TRAIN_SEQ tokens a step
MOE_GRAD_ROWS = 256


def moe_train_run(torch, impl):
    """MOE_TRAIN_STEPS steps of mixtral-8x22b at full width, 1 layer, under
    remat none (S = TRAIN_SEQ <= the window: K7), MOE_TRAIN_BATCH rows,
    TRAIN_ALIVE of every expert's gate columns alive."""
    from repro_torch.models import lm
    cfg, params = moe_model(torch, "mixtral-8x22b", 1, impl,
                            alive=TRAIN_ALIVE)
    cfg = dataclasses.replace(cfg, remat="none")
    params = lm.trainable(params)
    res = train_steps(torch, cfg, train_batches(
        torch, cfg, MOE_TRAIN_BATCH, TRAIN_SEQ, MOE_TRAIN_STEPS),
        params=params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def moe_grad_check(torch):
    """mixtral-8x22b's MoE block at full width (8 experts of d_ff 16384,
    top 2) in float32 on MOE_GRAD_ROWS tokens, TRAIN_ALIVE gate columns an
    expert: the hybrid FFN (K8 and K9 in every expert) against autograd of
    the dense formula, gradients of x, the router and every expert leaf
    within GRAD_TOL of their max, as ``grad_check``."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("mixtral-8x22b")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    p = moe.moe_init(cfg.d_model, cfg.d_ff, cfg.num_experts, True,
                     torch.float32, gen, torch.device("cuda"))
    for w in p["experts"]["wg"]:
        w *= alive_columns(torch, gen, cfg.d_ff)
    x = torch.randn((MOE_GRAD_ROWS, cfg.d_model), generator=gen,
                    device="cuda")
    gy = torch.randn(x.shape, generator=gen, device="cuda") * 1e-2
    leaves = {"x": x, "router": p["router"],
              **{f"experts/{k}": v for k, v in p["experts"].items()}}
    grads = {}
    for impl in ("hybrid", "dense"):
        scfg = dataclasses.replace(cfg.sparsity, ffn_impl=impl)
        live = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
        params = {"router": live["router"], "experts": {
            k.split("/")[1]: v for k, v in live.items() if "/" in k}}
        y, aux = moe.moe_apply(params, live["x"], cfg, scfg, True)
        loss = (y * gy).sum() + 0.5 * aux["l1"] + aux["moe_balance"]
        grads[impl] = dict(zip(live, torch.autograd.grad(loss,
                                                         list(live.values()))))
        del live, params, y, aux
    errs = {}
    for name, want in grads["dense"].items():
        errs[name] = float((grads["hybrid"][name] - want).abs().max()
                           / want.abs().max())
        assert errs[name] <= GRAD_TOL, \
            f"MoE hybrid grad {name} off by {errs[name]} of its max"
    del grads, p
    gc.collect()
    torch.cuda.empty_cache()
    return {"M": MOE_GRAD_ROWS, "dtype": "float32", "experts":
            cfg.num_experts, "tolerance": GRAD_TOL, "rel_max_err": errs}


def phase_train_moe(torch):
    """mixtral-8x22b's full-width layer (2.91 B parameters: 8 experts of
    d_ff 16384 at d_model 6144, 48 heads over 8 KV heads of 128; bf16 AdamW
    moments, as the config keeps them) trained MOE_TRAIN_STEPS steps,
    hybrid FFN then dense, on TRAIN_SEQ-token rows (within the 4096-token
    window: attention degenerates to causal, K7), MOE_TRAIN_BATCH rows a
    step: K7, K8 and K9 launched, rows on
    both sides of the hybrid format, no overflow, finite and falling loss,
    step time and peak memory; then the float32 gradient check of the MoE
    block against the dense formula."""
    free, total = torch.cuda.mem_get_info()
    hybrid = moe_train_run(torch, "hybrid")
    dense = moe_train_run(torch, "dense")
    runs = [hybrid, dense]
    res = {"phase": "train_moe", "arch": "mixtral-8x22b", "layers": 1,
           "batch": [MOE_TRAIN_BATCH, TRAIN_SEQ],
           "alive_columns": TRAIN_ALIVE, "card_free_bytes_before": free,
           "card_total_bytes": total, "runs": runs,
           "hybrid_over_dense_peak": {
               key: hybrid[key] / dense[key]
               for key in ("peak_mem_bytes", "grad_peak_mem_bytes")},
           "grad_check": moe_grad_check(torch)}
    emit(res)
    assert_trained(hybrid, TRAIN_KERNELS)
    assert_trained(dense, ("flash_attention",))
    return {"launches": summed_launches(runs)}


# --------------------------------------------------------------------------- #
# 7f. training the remaining dense configs at full width
# --------------------------------------------------------------------------- #

# (arch, layers, the FFN gradient check's rows): phi3-mini-3.8b at 8 of 32
# layers (1.10 B parameters, f32 moments; K7 at head dim 96), deepseek-67b
# at 1 of 95 (2.37 B, bf16 moments, its f32 logits over 102400 columns);
# llama3-405b's one layer with its embedding and head (7.39 B) does not
# fit beside AdamW's functional update and trains on the CPU only
DENSE_TRAIN = (("phi3-mini-3.8b", 8, 2048), ("deepseek-67b", 1, 1024))
DENSE_TRAIN_STEPS = 4


def phase_train_dense(torch):
    """phi3-mini-3.8b (8 layers) and deepseek-67b (1 layer) at full width
    in bf16 under their own remat ("full") and AdamW moment dtype,
    TRAIN_ALIVE of every layer's gate columns alive, TRAIN_BATCH x
    TRAIN_SEQ tokens a step, hybrid then dense, DENSE_TRAIN_STEPS steps
    each: K7 (head dim 96 and 128), K8 and K9 (N 8192; N 22016 on the wide
    union maps) launched, rows on both sides of the format, no overflow, a
    falling loss, step time, peak and MFU (``train_steps``); then the
    config's FFN layer in float32, hybrid gradients against the dense
    formula (``grad_check``). A fixed batch: an out-of-memory error fails
    the phase."""
    from repro_torch.configs import get_config
    free, total = torch.cuda.mem_get_info()
    runs = []
    for arch, layers, rows in DENSE_TRAIN:
        pair = []
        for impl in ("hybrid", "dense"):
            cfg = train_config(impl, layers=layers, arch=arch, remat=None)
            pair.append(train_steps(torch, cfg, train_batches(
                torch, cfg, TRAIN_BATCH, TRAIN_SEQ, DENSE_TRAIN_STEPS)))
            gc.collect()
            torch.cuda.empty_cache()
        hybrid, dense = pair
        full = get_config(arch)
        check = grad_check(torch, m=rows, k=full.d_model, n=full.d_ff,
                           seed=SEED + 8)
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": "train_dense", "arch": arch, "layers": layers,
              "remat": hybrid["remat"],
              "opt_state_dtype": full.opt_state_dtype,
              "batch": [TRAIN_BATCH, TRAIN_SEQ],
              "alive_columns": TRAIN_ALIVE,
              "card_free_bytes_before": free, "card_total_bytes": total,
              "runs": pair,
              "hybrid_over_dense_peak": {
                  key: hybrid[key] / dense[key]
                  for key in ("peak_mem_bytes", "grad_peak_mem_bytes")},
              "grad_check": check})
        assert_trained(hybrid, TRAIN_KERNELS)
        assert_trained(dense, ("flash_attention",))
        runs += pair
    return {"launches": summed_launches(runs)}


# --------------------------------------------------------------------------- #
# 7g-7h. training the static-loop families at full width
# --------------------------------------------------------------------------- #

# (arch, layers (None: all), rows of TRAIN_SEQ tokens a step, the FFN
# gradient check's rows): zamba2-1.2b at 12 of 38 layers (cut with its
# serving depth, see SSM_SERVE), rwkv6-7b at 8 of 32 (2.15 B, f32 AdamW
# moments: about 22 bytes a parameter in the functional update)
SSM_TRAIN = (("zamba2-1.2b", 12, TRAIN_BATCH, 2048),
             ("rwkv6-7b", 8, TRAIN_BATCH, 1024))
# whisper-large-v3 at all 32 + 32 layers (1.54 B parameters), vision at one
# super-block (4 self blocks and a cross block) with its 128256-row
# embedding and head (2.14 B) on half the batch: at TRAIN_BATCH rows it
# peaked at 61.1 GB alone, and after the earlier phases its backward could
# not place the 3.91 GiB float32 logits (31.79 GiB reserved by the
# allocator but split)
XATTN_TRAIN = (("whisper-large-v3", None, TRAIN_BATCH, 2048),
               ("llama-3.2-vision-11b", 5, TRAIN_BATCH // 2, 1024))
STATIC_TRAIN_STEPS = 4             # the first at learning rate 0 (warmup)


def train_static(torch, phase, table):
    """Each config of ``table`` (SSM_TRAIN or XATTN_TRAIN) at its depth and
    full width in bf16 under its own remat ("full") and AdamW moments
    (float32), TRAIN_ALIVE of the pattern's columns alive, the table's rows
    of TRAIN_SEQ tokens a step (S 1024: the chunked SSD and WKV), hybrid
    then dense, STATIC_TRAIN_STEPS steps each: K8 and K9 launched, K7
    wherever the family has causal softmax attention (zamba2's shared
    block, the decoders; the encoder's and the cross attention are plain,
    as in JAX), rows on both sides of the format, no overflow, a falling
    loss, step time, peak and MFU (``train_steps``; for whisper the
    accounting's 6 N D counts the decoder's tokens only), one hybrid step
    traced; then each config's FFN layer in float32, hybrid gradients
    against the dense formula (``grad_check``). The attention-free
    families take fresh batches; the cross families one batch with its
    frames or patches every step: vision's 128256-way head spreads the
    loss of fresh random batches by ~0.2 at init, more than three updates
    move it, so only a batch seen again shows the fall. A fixed batch and
    depth: an out-of-memory error fails the phase."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    free, total = torch.cuda.mem_get_info()
    runs = []
    for arch, layers, batch, rows in table:
        pair = []
        for impl in ("hybrid", "dense"):
            cfg, params = static_model(torch, arch, layers, impl,
                                       alive=TRAIN_ALIVE)
            params = lm.trainable(params)
            extras = static_extras(torch, cfg, batch, SEED + 20)
            if extras:
                b = train_batches(torch, cfg, batch, TRAIN_SEQ, 1)[0]
                batches = [{**b, **extras}] * STATIC_TRAIN_STEPS
            else:
                batches = train_batches(torch, cfg, batch, TRAIN_SEQ,
                                        STATIC_TRAIN_STEPS)
            pair.append(train_steps(torch, cfg, batches, params=params,
                                    profile=impl == "hybrid"))
            del params, batches, extras
            gc.collect()
            torch.cuda.empty_cache()
        hybrid, dense = pair
        full = get_config(arch)
        check = grad_check(torch, m=rows, k=full.d_model, n=full.d_ff,
                           seed=SEED + 9, gated=full.gated,
                           act=full.sparsity.activation)
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": phase, "arch": arch, "family": full.family,
              "layers": hybrid["layers"],
              "encoder_layers": full.encoder_layers,
              "remat": hybrid["remat"],
              "opt_state_dtype": full.opt_state_dtype,
              "batch": [batch, TRAIN_SEQ],
              "cross_len": {"audio": XATTN_FRAMES, "vlm":
                            full.num_image_tokens}.get(full.family, 0),
              "alive_columns": TRAIN_ALIVE,
              "card_free_bytes_before": free, "card_total_bytes": total,
              "runs": pair,
              "hybrid_over_dense_peak": {
                  key: hybrid[key] / dense[key]
                  for key in ("peak_mem_bytes", "grad_peak_mem_bytes")},
              "grad_check": check})
        attn = () if full.family == "ssm" else ("flash_attention",)
        assert_trained(hybrid, attn + TRAIN_KERNELS[1:])
        assert_trained(dense, attn)
        runs += pair
    return {"launches": summed_launches(runs)}


def phase_train_ssm(torch):
    """zamba2-1.2b (12 layers) and rwkv6-7b (8 layers) through
    ``train_static``: K8 and K9 (rwkv6 non-gated with relu^2), K7 for
    zamba2's shared block."""
    return train_static(torch, "train_ssm", SSM_TRAIN)


def phase_train_xattn(torch):
    """whisper-large-v3 (32 + 32 layers, TRAIN_BATCH x XATTN_FRAMES frames
    a step: the encoder's FFN at 12000 rows) and llama-3.2-vision-11b (one
    super-block, TRAIN_BATCH / 2 x 1024 patches, gates nonzero) through
    ``train_static``: K7, K8 and K9."""
    return train_static(torch, "train_xattn", XATTN_TRAIN)


# --------------------------------------------------------------------------- #
# 8. the same weights in float32 on the CPU
# --------------------------------------------------------------------------- #

def run_paged(torch, params, cfg, prompt, steps, device, forced=None,
              backend="gather"):
    """Prefill ``prompt`` in one chunk, then ``steps`` greedy decode steps
    (feeding ``forced`` tokens when given) through ``backend``'s FFN path.
    Returns the logits rows."""
    from repro_torch.models import lm
    from repro_torch.serving.backends import DECODE, PREFILL, get_backend
    be = get_backend(backend)
    bs = 16
    width = -(-(len(prompt) + steps) // bs)
    pools = lm.init_paged_cache(cfg, 1 + width, bs, device=device)
    bt = torch.arange(1, 1 + width, dtype=torch.int32,
                      device=device)[None]
    toks = torch.tensor([prompt], dtype=torch.int32, device=device)
    num_new = torch.tensor([len(prompt)], dtype=torch.int32, device=device)
    logits, _ = lm.paged_prefill(params, pools, bt, toks, num_new,
                                 be.configure(cfg, PREFILL), last_only=True)
    rows = [logits[0, 0].float().cpu()]
    for i in range(steps):
        tok = forced[i] if forced is not None else int(rows[-1].argmax())
        sl = torch.tensor([len(prompt) + i], dtype=torch.int32, device=device)
        logits, _ = lm.paged_decode_step(
            params, pools, bt, sl,
            torch.tensor([[tok]], dtype=torch.int32, device=device),
            be.configure(cfg, DECODE))
        rows.append(logits[0, 0].float().cpu())
    return rows


def first_layers(tree, n):
    """The parameter tree with its stacked per-layer leaves cut to n."""
    return {**tree, "blocks": {
        name: {k: v[:n] for k, v in leaf.items()}
        for name, leaf in tree["blocks"].items()}}


def static_check(torch, arch, cfg, cpu_params, prompt, steps=4,
                 extras=None):
    """``arch`` at the depth of ``cfg`` (its first layers; bf16 weights
    kept on the CPU by ``serve_static``): the
    static loop in float32 on the CPU (the plain versions) prefills
    ``prompt`` and decodes ``steps`` greedy tokens, from a cross cache of
    ``extras`` (frames or patches, one request) when given; the card
    (bf16, the gather FFN: K1 + K2 or K1 + K6) teacher-forces the CPU's
    tokens through ``decode_step`` from its own cross cache. Logits of the
    prefill's last position and of each decode step within LOGIT_TOL,
    tokens equal wherever the CPU's top-2 margin exceeds it."""
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, ffn_impl="gather"))
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    p32 = tree_map(lambda t: t.float(), cpu_params)
    cache_len = len(prompt) + steps + 2
    extras = extras or {}
    cache = static_cache(torch, cfg32, p32, extras, 1, cache_len)
    ref = []
    toks = serve.generate(p32, cfg32, torch.tensor([prompt]), steps + 1,
                          cache_len, logits_out=ref, cache=cache)
    del p32, cache
    card_params = lm.params_to(cpu_params, "cuda")
    cache = static_cache(torch, cfg, card_params,
                         {k: v.cuda() for k, v in extras.items()}, 1,
                         toks.shape[1])
    card = moe_forced_logits(torch, cfg, card_params, toks[:, :-1].cuda(),
                             len(prompt) - 1, cache=cache)[0].cpu()
    del card_params, cache
    diffs = []
    for step, (a, b) in enumerate(zip(card, (r[0] for r in ref))):
        assert bool(torch.isfinite(a).all()), f"{arch}: non-finite logits"
        assert a.shape == (cfg.padded_vocab,)
        diffs.append(float((a - b).abs().max()))
        top2 = torch.topk(b, 2).values
        if float(top2[0] - top2[1]) > LOGIT_TOL:
            assert int(a.argmax()) == int(b.argmax()), \
                f"{arch} step {step}: token differs"
    assert max(diffs) <= LOGIT_TOL, \
        f"{arch}: card vs CPU logits differ by {max(diffs)}"
    return {"arch": arch, "layers": cfg.num_layers,
            "encoder_layers": cfg.encoder_layers, "len": len(prompt),
            "backend": "gather", "norm": cfg.norm,
            "max_abs_logit_diff": diffs,
            "cpu_first_token": int(toks[0, len(prompt)])}


def phase_check(torch, serve, olmo, dense, ssm, xattn):
    """Tolerance: card logits (bf16 weights and activations, 8 layers) within
    LOGIT_TOL of the CPU's float32 logits, whose spread is about 1; a bf16
    value carries 8 significant bits, a relative rounding of 2^-9 per step.
    A token must match wherever the CPU's top-2 margin exceeds the tolerance.
    paper-0.5b runs its 8 layers; olmo-1b and phi3-mini-3.8b (head dim 96
    through K1-K4) run their first 2 (at full width), so that the CPU's
    float32 run stays short. Then one training step, ``check_train``."""
    from repro_torch.models import lm
    from repro_torch.tree import tree_map
    olmo_cfg = dataclasses.replace(olmo["cfg"], num_layers=2)
    phi3_cfg, phi3_params, phi3_prompts = dense["phi3"]
    models = {}
    for arch, cfg, params in (
            ("paper-0.5b", serve["cfg"], serve["params"]),
            ("olmo-1b", olmo_cfg, first_layers(olmo["params"], 2)),
            ("phi3-mini-3.8b", phi3_cfg, phi3_params)):
        models[arch] = (cfg, params, dataclasses.replace(
            cfg, dtype="float32", param_dtype="float32"),
            tree_map(lambda t: t.float(), lm.params_to(params, "cpu")))
    report = []
    # the 64- and 96-token prompts through gather (paper-0.5b: K1 + K2;
    # olmo-1b: K1 + K6; phi3-mini: K1 + K2, K3 and K4 at head dim 96), the
    # 64-token one through tile_skip at threshold 0 (K5)
    for arch, ridx, backend in (("paper-0.5b", 2, "gather"),
                                ("paper-0.5b", 5, "gather"),
                                ("paper-0.5b", 2, "tile_skip"),
                                ("olmo-1b", 2, "gather"),
                                ("olmo-1b", 5, "gather"),
                                ("phi3-mini-3.8b", 2, "gather"),
                                ("phi3-mini-3.8b", 5, "gather")):
        cfg, params, cfg32, cpu_params = models[arch]
        with torch.no_grad():
            prompt = (phi3_prompts if arch == "phi3-mini-3.8b"
                      else serve["prompts"])[ridx]
            ref = run_paged(torch, cpu_params, cfg32, prompt, 4, "cpu",
                            backend=backend)
            forced = [int(r.argmax()) for r in ref[:-1]]
            card = run_paged(torch, params, cfg, prompt, 4, "cuda",
                             forced=forced, backend=backend)
        diffs = [float((a - b).abs().max()) for a, b in zip(card, ref)]
        for step, (a, b) in enumerate(zip(card, ref)):
            assert bool(torch.isfinite(a).all()), "non-finite logits"
            assert a.shape == (cfg.padded_vocab,)
            top2 = torch.topk(b, 2).values
            if float(top2[0] - top2[1]) > LOGIT_TOL:
                assert int(a.argmax()) == int(b.argmax()), \
                    f"{arch} prompt {ridx} step {step}: token differs"
        top2 = torch.topk(ref[0], 2).values
        # the engine ran all of olmo's 16 layers: no first token to hold
        engine_first = serve["outs"][ridx].token_ids[0] \
            if arch == "paper-0.5b" else None
        if engine_first is not None and backend == "gather" and \
                float(top2[0] - top2[1]) > LOGIT_TOL:
            assert engine_first == int(ref[0].argmax()), \
                f"prompt {ridx}: engine's first token differs from CPU"
        assert max(diffs) <= LOGIT_TOL, \
            f"{arch} prompt {ridx}: card vs CPU logits differ by {max(diffs)}"
        report.append({"arch": arch, "layers": cfg.num_layers,
                       "prompt": ridx, "len": len(prompt),
                       "backend": backend,
                       "max_abs_logit_diff": diffs,
                       "cpu_top2_margin": float(top2[0] - top2[1]),
                       "engine_first_token": engine_first,
                       "cpu_first_token": int(ref[0].argmax())})
    # rwkv6-7b's first 2 layers (affine LayerNorm, K1 with relu^2 + K6),
    # zamba2-1.2b's first 6 (the shared block once: K1 + K2), whisper-
    # large-v3's first 2 + 2 (K1 + K6, one request's 1500 frames) and
    # llama-3.2-vision-11b's first super-block (K1 + K2, 1024 patches, the
    # gated cross block) through the static loop's decode, the cross
    # families from prefilled cross caches
    for arch, (cfg, cpu_params, prompt, extras) in (
            *ssm["check"].items(), *xattn["check"].items()):
        with torch.no_grad():
            report.append(static_check(torch, arch, cfg, cpu_params, prompt,
                                       extras=extras))
    emit({"phase": "check", "tolerance": LOGIT_TOL, "prompts": report,
          "train_step": check_train(torch),
          "train_step_olmo": check_train(torch, "olmo-1b", remat=None)})


def loss_and_grads(torch, params, batch, cfg):
    from repro_torch.models import lm
    from repro_torch.tree import leaves_with_path, tree_map
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    named = list(leaves_with_path(live))
    loss, _ = lm.loss_fn(live, batch, cfg)
    grads = torch.autograd.grad(loss, [t for _, t in named])
    return float(loss.detach()), {n: g for (n, _), g in zip(named, grads)}


def check_train(torch, arch="paper-0.5b", remat="none"):
    """One training step's loss and gradients of ``arch`` at full width, 2
    layers, batch 1 x 256, hybrid FFN, under ``remat`` (None: the
    config's; olmo-1b recomputes, ``full``): the card (bf16, kernels
    K7-K9) against the CPU (float32, the plain versions) on the same
    weights. Tolerance: loss
    within TRAIN_LOSS_TOL relative; each gradient leaf within
    TRAIN_GRAD_TOL relative (Frobenius norm of the difference over the
    CPU's). A bf16 value carries 8 significant bits (2^-9 relative per
    rounding); a gradient passes some twenty roundings on its way back
    through 2 layers, which add as a random walk to a few percent, and a
    gate pre-activation within a rounding of zero may join or leave the
    ReLU pattern on the card, which changes W_g's gradient by a full-size
    term for that entry (measured on the H100: 2-4% for the attention
    and W_u/W_d leaves, 4.8% for W_g). 10% leaves room for that without
    hiding a wrong formula, which gives errors of order 1."""
    import numpy as np
    from repro_torch.models import lm
    from repro_torch.tree import tree_map
    cfg = train_config("hybrid", layers=2, arch=arch, remat=remat)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    batch = train_batches(torch, cfg, 1, 256, 1)[0]
    params = train_setup(torch, cfg)
    cpu_params = tree_map(lambda t: t.float(), lm.params_to(params, "cpu"))
    card_loss, card = loss_and_grads(torch, params, batch, cfg)
    cpu_loss, cpu = loss_and_grads(
        torch, cpu_params, {k: v.cpu() for k, v in batch.items()}, cfg32)
    rel = {}
    for name, g in cpu.items():
        diff = card[name].float().cpu() - g
        rel[name] = float(diff.norm() / g.norm().clamp(min=1e-30))
        assert rel[name] <= TRAIN_GRAD_TOL, \
            f"gradient {name}: card vs CPU relative error {rel[name]}"
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    assert np.isfinite(card_loss) and loss_rel <= TRAIN_LOSS_TOL, \
        f"loss: card {card_loss} vs CPU {cpu_loss}"
    return {"arch": arch, "remat": cfg.remat, "layers": 2, "batch": 1,
            "seq": 256, "card_loss": card_loss,
            "cpu_loss": cpu_loss, "loss_rel_err": loss_rel,
            "loss_tolerance": TRAIN_LOSS_TOL,
            "grad_tolerance": TRAIN_GRAD_TOL, "grad_rel_err": rel}


def serve_tp_alone(torch, serve, *_):
    """``--phases serve_tp``: the serve_tp phase against references it
    makes itself (the pipeline phase's two warmed pipelined runs, unsharded,
    and a recorded run's near-ties)."""
    cfg, params, prompts = serve["cfg"], serve["params"], serve["prompts"]
    n = serve["new_tokens"]
    spec_config = spec_default()
    ref = serving_engine(cfg, params, n, record_logits=True).generate(
        prompts, max_tokens=n)
    spec = {"spec_config": spec_config, "outs": ref,
            "near_ties": first_near_ties(torch, ref)}
    pipe = {}
    for key, kw in (("outs", {}), ("spec_outs", {"spec": spec_config})):
        engine, outs, _, _ = warm_run(torch, cfg, params, prompts, n,
                                      pipeline=True, **kw)
        pipe[key] = outs
        if key == "outs":
            decode = [s.wall_ms for s in engine.stats
                      if s.decode_batch and not s.prefill_tokens]
            pipe["pipeline"] = {"decode_step_ms_mean":
                                sum(decode) / len(decode)}
    return phase_serve_tp(torch, {**serve, "outs": ref}, spec, pipe)


def spec_default():
    from repro_torch.serving import SpecConfig
    return SpecConfig(k=SPEC_K, draft_backend="tile_skip",
                      draft_threshold=DRAFT_THRESHOLD)


SERVE_PHASES = {"disagg": phase_disagg, "serve_tp": serve_tp_alone,
                "serve_moe": lambda torch, *_: phase_serve_moe(torch),
                "serve_dense": lambda torch, *_: phase_serve_dense(torch),
                "serve_ssm": lambda torch, *_: phase_serve_ssm(torch),
                "serve_xattn": lambda torch, *_: phase_serve_xattn(torch)}
TRAIN_PHASES = {"train": phase_train, "train_mesh": phase_train_mesh,
                "dryrun": phase_dryrun,
                "remat": phase_remat,
                "train_1p5b": phase_train_1p5b,
                "train_olmo": phase_train_olmo,
                "train_moe": phase_train_moe,
                "train_dense": phase_train_dense,
                "train_ssm": phase_train_ssm,
                "train_xattn": phase_train_xattn,
                "check_train": lambda torch: emit({
                    "phase": "check_train",
                    "train_step": check_train(torch),
                    "train_step_olmo": check_train(torch, "olmo-1b",
                                                   remat=None)})}


if __name__ == "__main__":
    sys.exit(main())
