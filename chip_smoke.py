#!/usr/bin/env python3
"""Bring-up check of the PyTorch port on one NVIDIA card (H100).

Run from the repo root with no arguments: ``python3 chip_smoke.py``. It puts
``src`` on ``sys.path``, imports the port (``repro_torch``; never JAX or the
JAX package) and runs these phases, each printing one JSON line:

  1. device   -- ``nvidia-smi`` name and power limit, torch and CUDA versions
  2. build    -- compiles ``src/repro_torch/kernels/csrc/*.cu`` (one nvcc per
                 source, in parallel) into ``build/repro_torch/``
  3. kernels  -- each hand-written kernel (K1 gate matmul + TwELL pack, K2
                 fused up/down projection, K3 paged decode attention, K4 paged
                 chunk attention, K5 tile-skip gated FFN, K6 non-gated TwELL
                 down projection, K7 causal flash attention, K8 and K9 the
                 ELL sides of the hybrid products) on the card at the main
                 paths' shapes in bfloat16, held against its plain PyTorch
                 version on the same inputs, then timed beside the plain
                 version, a library call and its bound
  4. serve    -- the port's ``ServingEngine`` serves paper-0.5b at full width
                 (gather/TwELL backend, paged KV, chunked prefill, prefix
                 cache): 6 greedy requests; the launch count of every kernel
                 of this path (K1-K4) over exactly this run must be above 0;
                 then a profiled rerun (phase "profile")
  5. spec     -- the same weights and prompts through self-speculative
                 decoding (k = 4 tile-skip drafts, K5 + K3; one batched
                 TwELL verify, K1 + K2 + K4): every kernel's launch count
                 over the greedy run above 0, tokens equal to the
                 non-speculative run's up to its first near-tie, the pool
                 clean, and a seeded stochastic run twice with equal tokens
  6. serve_olmo -- olmo-1b (non-gated FFN, non-parametric LayerNorm, head
                 dim 128) at full width and depth through the same engine
                 settings and prompts, 98% of every layer's W_u columns
                 zeroed: K1 packs relu(x @ W_u), K6 projects down, K3/K4
                 attend; each launched over exactly this run, no overflow,
                 the prefix cache hit, the pool clean; then a profiled rerun
  7. train    -- TRAIN_STEPS AdamW steps of paper-0.5b at full width and
                 depth through the port's ``make_train_step`` with the hybrid
                 FFN (K8 + K9) and K7 attention, 8 x 1024 SyntheticLM tokens
                 a step: K7-K9 each launched over exactly this run, no
                 hybrid overflow, rows on both sides of the format, finite
                 and falling loss; step time, tokens/s, peak memory and the
                 busy share of a profiled step, beside the same steps with
                 the dense FFN; then a float32 gradient check of one hybrid
                 FFN layer against autograd of the dense formula
  8. check    -- the same weights in float32 on the CPU (plain versions)
                 against the card: prefill plus 4 decode steps of two prompts
                 through the gather path and one through tile_skip, logits
                 within a stated tolerance; the same for two prompts through
                 olmo-1b's first 2 layers (K1 + K6); and one training step
                 (2 layers, 1 x 256 tokens, hybrid): loss and every gradient
                 leaf
  9. the kernel table ``{"kernels": [...]}`` (launches summed over the serve,
     spec, olmo serve and hybrid train runs), then the last line
     ``{"ok": true, "device": {...}}``.

Any failure raises: the script exits non-zero and prints no last line. It
exits non-zero without a card and when the repo's ``src/`` is absent.
Random weights are made from a seed; nothing is downloaded.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
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


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "repo root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 plain versions
    torch.backends.cudnn.allow_tf32 = False         # run in full f32

    smi = phase_device(torch)
    phase_build()
    kernels = phase_kernels(torch)
    serve = phase_serve(torch)
    spec = phase_spec(torch, serve)
    olmo = phase_serve_olmo(torch, serve)
    train = phase_train(torch)
    phase_check(torch, serve, olmo)
    for k in kernels:
        k["launches"] = sum(run["launches"][k["name"]] for run in
                            (serve, spec, olmo, train))
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
    emit({"phase": "build", "seconds": round(secs, 2),
          "sources": [p.name for p in build.sources()],
          "dir": str(build.BUILD_DIR), "ptxas": usage})


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


def gate_inputs(torch, m, k, n, gen):
    x = (torch.randn((m, k), generator=gen, device="cuda") * 0.5).bfloat16()
    alive = torch.rand((n,), generator=gen, device="cuda") < KEEP
    wg = (torch.randn((k, n), generator=gen, device="cuda") * 0.08
          * alive[None]).bfloat16()
    wu = (torch.randn((k, n), generator=gen, device="cuda") * 0.08).bfloat16()
    wd = (torch.randn((n, k), generator=gen, device="cuda") * 0.08).bfloat16()
    return x, wg, wu, wd


def check_k1_k2(torch, timer, m, gen):
    from repro_torch.core import twell
    from repro_torch.kernels.sparse_ffn import (twell_fused_ffn_cuda,
                                                twell_fused_ffn_plain)
    from repro_torch.kernels.twell_pack import (twell_gate_matmul_cuda,
                                                twell_gate_matmul_plain)
    k, n, t, c = 2048, 5632, 256, 8
    tc = t // c
    x, wg, wu, wd = gate_inputs(torch, m, k, n, gen)
    wu_t = wu.t().contiguous()
    # K1
    v, i, z = twell_gate_matmul_cuda(x, wg, t, c, "relu")
    pv, pi, pz = twell_gate_matmul_plain(x, wg, t, c, "relu")
    torch.cuda.synchronize()
    pre = x.float() @ wg.float()
    # a pre-activation within 1e-3 max|pre| of zero may round either way
    near = ((pre != 0) & (pre.abs() < 1e-3 * pre.abs().max())).any(-1)
    rows = ~near
    assert bool((z[rows] == pz[rows]).all()), f"K1 nnz mismatch (M={m})"
    assert bool((i[rows] == pi[rows]).all()), f"K1 indices mismatch (M={m})"
    assert int(z.max()) <= tc, f"K1 geometry overflows (M={m})"
    err1, ok1 = close_err(torch, v[rows], pv[rows])
    assert ok1, f"K1 values disagree with the plain version (M={m}): {err1}"
    out_bytes = m * n // c * (2 + 4) + m * n // t * 4
    b1, by1 = bound_ms(2 * (m * k + k * n) + out_bytes, 2 * m * k * n)
    k1 = {"ms": timer.ms(lambda: twell_gate_matmul_cuda(x, wg, t, c)),
          "plain_ms": timer.ms(lambda: twell_gate_matmul_plain(x, wg, t, c),
                               iters=5),
          "library_ms": timer.ms(lambda: torch.matmul(x, wg)),
          "bound_ms": b1, "bound_by": by1, "max_abs_err": err1,
          "near_zero_rows": int(near.sum()), "M": m}
    # K2, on the plain version's packed gate (the same input for both)
    tw = twell.TwellActs(pv, pi, torch.clamp(pz, max=tc), (pz > tc).any(),
                         t, c, n)
    y = twell_fused_ffn_cuda(x, tw, wu_t, wd)
    py = twell_fused_ffn_plain(x, tw, wu_t, wd)
    torch.cuda.synchronize()
    err2, ok2 = close_err(torch, y, py)
    assert ok2, f"K2 disagrees with the plain version (M={m}): {err2}"
    assert torch.equal(y, twell_fused_ffn_cuda(x, tw, wu_t, wd)), \
        "K2 is not run-to-run deterministic"
    valid = twell.slot_valid(tw)
    slots = int(valid.sum())
    cols = int(torch.unique(tw.indices[valid]).numel())
    in_bytes = 2 * m * k + prefix_bytes(tw.nnz, 2) + \
        prefix_bytes(tw.nnz, 4) + m * n // t * 4
    b2, by2 = bound_ms(in_bytes + 2 * cols * k * 2 + 4 * m * k,
                       4 * k * slots)

    def dense_ffn():
        return torch.matmul(torch.matmul(x, wu) * torch.relu(
            torch.matmul(x, wg)), wd)

    k2 = {"ms": timer.ms(lambda: twell_fused_ffn_cuda(x, tw, wu_t, wd)),
          "plain_ms": timer.ms(lambda: twell_fused_ffn_plain(x, tw, wu_t,
                                                              wd), iters=5),
          "library_ms": timer.ms(dense_ffn),
          "bound_ms": b2, "bound_by": by2, "max_abs_err": err2,
          "active_slots_per_row": slots / m, "distinct_columns": cols,
          "M": m}
    return k1, k2


def check_k6(torch, timer, m, gen):
    """K6 at olmo-1b's FFN shape (K 2048, N 8192, T 256, C 8) with KEEP of
    the W_u columns alive, on the pattern of relu(x @ W_u) packed by the
    plain version (the same input for both); then K1 + K6, the non-gated
    FFN as the serving path runs it, beside the dense relu(x @ W_u) @ W_d."""
    from repro_torch.core import twell
    from repro_torch.kernels.sparse_ffn import (twell_down_proj_cuda,
                                                twell_down_proj_plain)
    from repro_torch.kernels.twell_pack import (twell_gate_matmul_cuda,
                                                twell_gate_matmul_plain)
    k, n, t, c = 2048, 8192, 256, 8
    tc = t // c
    # gate_inputs' KEEP-masked gate weight stands in for olmo's W_u (its
    # real W_u, dense, is dropped): relu(x @ wg) is then as sparse as the
    # up projection of the serve_olmo phase
    x, wg, _, wd = gate_inputs(torch, m, k, n, gen)
    v, i, z = twell_gate_matmul_plain(x, wg, t, c, "relu")
    assert int(z.max()) <= tc, f"K6 inputs overflow T/C (M={m})"
    args = (v, i, z, wd, t)
    y = twell_down_proj_cuda(*args)
    py = twell_down_proj_plain(*args)
    torch.cuda.synchronize()
    err, ok = close_err(torch, y, py)
    assert ok, f"K6 disagrees with the plain version (M={m}): {err}"
    assert torch.equal(y, twell_down_proj_cuda(*args)), \
        "K6 is not run-to-run deterministic"
    tw = twell.TwellActs(v, i, z, (z > tc).any(), t, c, n)
    valid = twell.slot_valid(tw)
    slots = int(valid.sum())
    rows = int(torch.unique(i[valid]).numel())
    # the W_d rows the pattern names, the valid slots' values and indices,
    # the counts, and the float32 y; 2 K flops per valid slot
    nbytes = rows * k * 2 + prefix_bytes(z, 2) + prefix_bytes(z, 4) + \
        m * n // t * 4 + 4 * m * k
    bnd, by = bound_ms(nbytes, 2 * slots * k)
    h = twell.unpack(tw)

    def k1_k6():
        pv, pi, pz = twell_gate_matmul_cuda(x, wg, t, c, "relu")
        return twell_down_proj_cuda(pv, pi, torch.clamp(pz, max=tc), wd, t)

    return {"ms": timer.ms(lambda: twell_down_proj_cuda(*args)),
            "plain_ms": timer.ms(lambda: twell_down_proj_plain(*args),
                                 iters=5),
            "library_ms": timer.ms(lambda: torch.matmul(h, wd)),
            "bound_ms": bnd, "bound_by": by, "max_abs_err": err, "M": m,
            "valid_slots_per_row": slots / m, "distinct_rows": rows,
            "k1_k6_ms": timer.ms(k1_k6),
            "dense_ffn_ms": timer.ms(lambda: torch.matmul(
                torch.relu(torch.matmul(x, wg)), wd))}


def check_k5(torch, timer, m, threshold, gen):
    """K5 on the main path's FFN shape, with the W_g columns of 11 of the 22
    tiles zeroed (dead for every row) so the skip branch runs on the card.
    ``threshold`` None takes the median row-tile gate maximum of the live
    tiles, so the threshold drops about half of them."""
    from repro_torch.kernels.sparse_ffn import (tile_skip_ffn_cuda,
                                                tile_skip_ffn_plain)
    k, n, t = 2048, 5632, 256
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

    def dense_ffn():
        return torch.matmul(torch.matmul(x, wu) * torch.relu(
            torch.matmul(x, wg)), wd)

    return {"ms": timer.ms(lambda: tile_skip_ffn_cuda(x, wg, wu, wd, t,
                                                       "relu", threshold)),
            "plain_ms": timer.ms(lambda: tile_skip_ffn_plain(
                x, wg, wu, wd, t, "relu", threshold), iters=5),
            "library_ms": timer.ms(dense_ffn),
            "bound_ms": bnd, "bound_by": by,
            "max_abs_err": max(err_y, err_h), "M": m,
            "threshold": threshold, "dead_tiles": nt // 2,
            "cells": rb * nt, "skipped_share": skipped,
            "tiles_read": tiles, "kept_row_tiles": kept_pairs,
            "near_threshold_rows": int((~rows).sum())}


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


def check_k3(torch, timer, h, hkv, gen):
    import torch.nn.functional as F
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention_cuda, paged_decode_attention_plain)
    b, hd, bs, width = 4, 64, 16, 64
    sl_list = [1000, 517, 33, 700]
    kpool, vpool, bt = paged_inputs(torch, gen, b, hkv, hd, bs, width)
    sl = torch.tensor(sl_list, dtype=torch.int32, device="cuda")
    q = torch.randn((b, 1, h, hd), generator=gen, device="cuda").bfloat16()
    o = paged_decode_attention_cuda(q, kpool, vpool, bt, sl)
    po = paged_decode_attention_plain(q, kpool, vpool, bt, sl)
    torch.cuda.synchronize()
    err, ok = close_err(torch, o, po)
    assert ok, f"K3 disagrees with the plain version (H={h}, Hkv={hkv}): {err}"
    pages = sum(s // bs + 1 for s in sl_list)
    nbytes = 2 * (2 * b * h * hd) + pages * bs * hkv * hd * 2 * 2
    bnd, by = bound_ms(nbytes, 4 * h * hd * sum(s + 1 for s in sl_list))
    kf, vf = gathered(torch, kpool, bt, h), gathered(torch, vpool, bt, h)
    kpos = torch.arange(width * bs, device="cuda")
    mask = (kpos[None, :] <= sl[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)
    return {"ms": timer.ms(lambda: paged_decode_attention_cuda(
                q, kpool, vpool, bt, sl)),
            "plain_ms": timer.ms(lambda: paged_decode_attention_plain(
                q, kpool, vpool, bt, sl), iters=5),
            "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                qt, kf, vf, attn_mask=mask)),
            "bound_ms": bnd, "bound_by": by, "max_abs_err": err,
            "H": h, "Hkv": hkv, "seq_lens": sl_list}


def check_k4(torch, timer, h, hkv, gen):
    import torch.nn.functional as F
    from repro_torch.kernels.paged_chunk_attention import (
        paged_chunk_attention_cuda, paged_chunk_attention_plain)
    b, s, hd, bs, width = 4, 64, 64, 16, 64
    sl_list, nn_list = [900, 448, 300, 0], [64, 40, 64, 0]
    kpool, vpool, bt = paged_inputs(torch, gen, b, hkv, hd, bs, width)
    sl = torch.tensor(sl_list, dtype=torch.int32, device="cuda")
    nn = torch.tensor(nn_list, dtype=torch.int32, device="cuda")
    q = torch.randn((b, s, h, hd), generator=gen, device="cuda").bfloat16()
    o = paged_chunk_attention_cuda(q, kpool, vpool, bt, sl, nn)
    po = paged_chunk_attention_plain(q, kpool, vpool, bt, sl, nn)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(o.float()).all()), "K4 produced non-finite rows"
    assert float(o[3].float().abs().max()) == 0.0, \
        "K4: a padded row (num_new = 0, empty history) must be exactly zero"
    valid = (torch.arange(s, device="cuda")[None, :] < nn[:, None])
    err, ok = close_err(torch, o, po, valid[:, :, None, None].expand_as(o))
    assert ok, f"K4 disagrees with the plain version (H={h}, Hkv={hkv}): {err}"
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
            "H": h, "Hkv": hkv, "chunk": s, "seq_lens": sl_list,
            "num_new": nn_list}


def check_k7(torch, timer, b, s, h, hd, gen):
    """K7 at the training forward's attention shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    q, k, v = (torch.randn((b, s, h, hd), generator=gen,
                           device="cuda").bfloat16() for _ in range(3))
    o = flash_attention_cuda(q, k, v)
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


def hybrid_inputs(torch, gen):
    """The train phase's FFN at full width (M = 8192 tokens, K 2048, N
    5632, ELL width 128, backup M/8) with TRAIN_ALIVE gate columns alive:
    x, the packed gate hg (its pattern), W_u, W_d and a gradient gy."""
    from repro_torch.core import hybrid as hyb
    m, k, n = TRAIN_BATCH * TRAIN_SEQ, 2048, 5632
    x = (torch.randn((m, k), generator=gen, device="cuda")).bfloat16()
    wg = (torch.randn((k, n), generator=gen, device="cuda") * 0.02
          * alive_columns(torch, gen, n)).bfloat16()
    wu = (torch.randn((k, n), generator=gen, device="cuda") * 0.02).bfloat16()
    wd = (torch.randn((n, k), generator=gen, device="cuda") * 0.02).bfloat16()
    gy = (torch.randn((m, k), generator=gen, device="cuda") * 1e-3).bfloat16()
    g = torch.relu(x @ wg)
    hg = hyb.pack(g, 128, m // 8, mask=g > 0)
    assert not bool(hg.overflow), "the K8/K9 inputs overflow the backup"
    return x, hg, wu, wd, gy


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


def check_k8(torch, timer, inputs, orient):
    """K8, y = h @ W on the ELL side: forward h (bf16 values) @ W_d,
    backward grad_hu (float32 values) @ W_u^T."""
    from repro_torch.core import hybrid as hyb
    from repro_torch.kernels.hybrid_matmul import (hybrid_to_dense_cuda,
                                                   hybrid_to_dense_plain)
    x, hg, wu, wd, _ = inputs
    if orient == "forward":
        vals, w = hg.ell_values, wd
    else:
        vals, w = hg.ell_values.float(), wu.t().contiguous()
    args = (vals, hg.ell_indices, hg.row_nnz, ~hg.is_dense, w)
    y = hybrid_to_dense_cuda(*args)
    py = hybrid_to_dense_plain(*args)
    torch.cuda.synchronize()
    err, ok = close_err(torch, y, py)
    assert ok, f"K8 ({orient}) disagrees with the plain version: {err}"
    assert torch.equal(y, hybrid_to_dense_cuda(*args)), \
        "K8 is not run-to-run deterministic"
    m, k = y.shape
    slots, read = hybrid_work(torch, hg, k, vals.element_size())
    bnd, by = bound_ms(read + 4 * m * k, 2 * slots * k)
    dense_h = hyb.unpack(hg._replace(ell_values=vals.to(w.dtype))).to(w.dtype)
    return {"ms": timer.ms(lambda: hybrid_to_dense_cuda(*args)),
            "plain_ms": timer.ms(lambda: hybrid_to_dense_plain(*args),
                                 iters=3),
            "library_ms": timer.ms(lambda: torch.matmul(dense_h, w)),
            "bound_ms": bnd, "bound_by": by, "max_abs_err": err,
            "orient": orient, "M": m, "E": hg.ell_width, "K": k,
            "valid_slots_per_row": slots / m,
            "backup_rows": int(hg.is_dense.sum())}


def check_k9(torch, timer, inputs, orient):
    """K9, the SDDMM on the pattern: forward h_u = (x @ W_u)[pattern] (W_u^T
    read by rows), backward grad_h = (gy @ W_d^T)[pattern] (W_d read by
    rows)."""
    from repro_torch.kernels.hybrid_matmul import (dense_to_hybrid_cuda,
                                                   dense_to_hybrid_plain)
    x, hg, wu, wd, gy = inputs
    a, wt = (x, wu.t().contiguous()) if orient == "forward" else (gy, wd)
    args = (a, wt, hg.ell_indices, hg.row_nnz, ~hg.is_dense)
    v = dense_to_hybrid_cuda(*args)
    pv = dense_to_hybrid_plain(*args)
    torch.cuda.synchronize()
    err, ok = close_err(torch, v, pv)
    assert ok, f"K9 ({orient}) disagrees with the plain version: {err}"
    assert torch.equal(v, dense_to_hybrid_cuda(*args)), \
        "K9 is not run-to-run deterministic"
    m, k = a.shape
    slots, read = hybrid_work(torch, hg, k, 0)
    bnd, by = bound_ms(read + 2 * m * k + 4 * m * hg.ell_width,
                       2 * slots * k)
    w = wt.t()
    return {"ms": timer.ms(lambda: dense_to_hybrid_cuda(*args)),
            "plain_ms": timer.ms(lambda: dense_to_hybrid_plain(*args),
                                 iters=3),
            "library_ms": timer.ms(lambda: torch.matmul(a, w)),
            "bound_ms": bnd, "bound_by": by, "max_abs_err": err,
            "orient": orient, "M": m, "E": hg.ell_width, "K": k,
            "valid_slots_per_row": slots / m,
            "backup_rows": int(hg.is_dense.sum())}


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


def phase_kernels(torch):
    """One entry per kernel: the top-level numbers at the shape the main
    path runs most (decode: M = 4 for K1/K2, K3, K5 and K6, K5 with a
    threshold as the drafts run it; the 64-token prefill chunk for K4; the
    train phase's batch for K7, K8 and K9, K8/K9 in their forward
    orientation); every measured case under "cases"."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    timer = Timer(torch)
    k1_4, k2_4 = check_k1_k2(torch, timer, 4, gen)
    k1_256, k2_256 = check_k1_k2(torch, timer, 256, gen)
    cases = {
        "twell_gate_matmul": [k1_4, k1_256],
        "twell_fused_ffn": [k2_4, k2_256],
        "twell_down_proj": [check_k6(torch, timer, 4, gen),
                            check_k6(torch, timer, 256, gen)],
        "paged_decode_attention": [check_k3(torch, timer, 32, 32, gen),
                                   check_k3(torch, timer, 32, 8, gen)],
        "paged_chunk_attention": [check_k4(torch, timer, 32, 32, gen),
                                  check_k4(torch, timer, 32, 8, gen)],
        "tile_skip_ffn": [check_k5(torch, timer, 4, None, gen),
                          check_k5(torch, timer, 4, 0.0, gen),
                          check_k5(torch, timer, 256, None, gen),
                          check_k5(torch, timer, 256, 0.0, gen)],
        "flash_attention": [check_k7(torch, timer, TRAIN_BATCH, TRAIN_SEQ,
                                     32, 64, gen),
                            check_k7(torch, timer, 1, 4096, 32, 64, gen)],
    }
    hybrid = hybrid_inputs(torch, gen)
    cases["hybrid_to_dense"] = [check_k8(torch, timer, hybrid, o)
                                for o in ("forward", "backward")]
    cases["dense_to_hybrid"] = [check_k9(torch, timer, hybrid, o)
                                for o in ("forward", "backward")]
    del hybrid
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
                                  "ms": k["ms"]} for k in out}})
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
    rng = np.random.RandomState(SEED)

    def toks(n):
        return rng.randint(0, cfg.vocab_size, n).tolist()
    shared = toks(256)
    prompts = [shared + toks(64), toks(512), toks(64), toks(200),
               shared + toks(128), toks(96)]
    return cfg, params, prompts


SERVE_KERNELS = ("twell_gate_matmul", "twell_fused_ffn",
                 "paged_decode_attention", "paged_chunk_attention")
SPEC_KERNELS = SERVE_KERNELS + ("tile_skip_ffn",)


def serving_engine(cfg, params, new_tokens, **kw):
    from repro_torch.serving import ServingEngine
    return ServingEngine(params, cfg, backend="gather", block_size=16,
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
                        prompts, new_tokens), "run": phase})
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


def profile_fn(torch, fn):
    """``fn()`` under torch.profiler: device busy share (kernel time over
    wall time; the profiler's own host cost makes it a lower bound) and
    device time by kernel."""
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
            "device_kernel_ms": busy_ms if kernels else "not measured",
            "device_busy_share": busy_ms / wall_ms if kernels else None,
            "top_kernels": [{"ms": ms, "calls": n, "name": name}
                            for ms, n, name in kernels[:12]]}


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
    compared = []
    for o, r in zip(outs, ref):
        n = 0
        for pos, row in enumerate(r.logits):
            top2 = torch.topk(torch.from_numpy(row), 2).values
            if float(top2[0] - top2[1]) <= LOGIT_TOL:
                break
            assert o.token_ids[pos] == r.token_ids[pos], \
                f"request {o.rid}: speculative token {pos} differs"
            n += 1
        compared.append(n)
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
           "tokens_equal_before_near_tie": compared,
           "nonspec_tokens_per_s": serve["tokens_per_s"],
           "stochastic": {"temperature": 0.8, "top_k": 50,
                          "acceptance_rate": sum(
                              o.spec_accepted for o in runs[0]) /
                          max(1, sum(o.spec_drafted for o in runs[0])),
                          "first_tokens": [o.token_ids[0] for o in runs[0]]},
           "threshold_sweep": sweep, "launches": launches}
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
# 7. training: full-width paper-0.5b through the hybrid FFN
# --------------------------------------------------------------------------- #

TRAIN_KERNELS = ("flash_attention", "hybrid_to_dense", "dense_to_hybrid")


def train_setup(torch, cfg):
    """Seeded random weights of ``cfg`` on the card with TRAIN_ALIVE of
    every layer's gate columns alive, as the trainable tree."""
    from repro_torch.models import lm
    params = lm.init(cfg, device="cuda", seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for wg in params["blocks"]["ffn"]["wg"]:
        wg *= alive_columns(torch, gen, cfg.d_ff).to(wg)
    return lm.trainable(params)


def train_config(impl, layers=None):
    from repro_torch.configs import get_config
    cfg = get_config("paper-0.5b")
    cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, ffn_impl=impl))
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
            "peak_mem_bytes": peak, "launches": launches,
            "hybrid_overflow": overflow, "ell_rows": ell_rows,
            "backup_rows": backup_rows,
            "profiled_step": {k: prof[k] for k in (
                "wall_ms", "device_kernel_ms", "device_busy_share")},
            "top_kernels": prof["top_kernels"][:8]}


def phase_train(torch):
    """The hybrid run (K7, K8, K9 each launched, no overflow, both sides
    of the format used, finite and falling loss), then the same steps with
    the dense FFN beside it: the paper's Table 1 comparison, reported.
    One line for each run, then one for the gradient check."""
    hybrid = train_run(torch, "hybrid")
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
    emit(dense)
    assert dense["launches"]["flash_attention"] > 0
    emit(grad_check(torch))
    return hybrid


def grad_check(torch):
    """One full-width FFN layer in float32 (M 4096 rows, TRAIN_ALIVE gate
    columns alive): the hybrid autograd.Function (K8 and K9) against
    torch autograd of the dense formula, y = (x W_u * relu(x W_g)) W_d with
    the L1 term mean|h| (``_dense_apply``). Tolerance: max |g - g_ref| <= GRAD_TOL max |g_ref|
    per gradient; both sides take float32 products summed in float32 in
    different orders (the kernels per row and slot, cuBLAS by tiles)."""
    from repro_torch.config import SparsityConfig
    from repro_torch.core import sparse_ffn
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    m, k, n, coeff = 4096, 2048, 5632, 0.5

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    x, gy = r(m, k), r(m, k, scale=1e-2)
    ws = {"wg": r(k, n, scale=0.02) * alive_columns(torch, gen, n),
          "wu": r(k, n, scale=0.02),
          "wd": r(n, k, scale=0.02)}
    leaves = [x] + [ws[w] for w in ("wg", "wu", "wd")]
    live = [t.clone().requires_grad_(True) for t in leaves]
    y, l1, nnz, _ = sparse_ffn._HybridGated.apply(*live, 128, m // 8, "relu")
    got = torch.autograd.grad((y * gy).sum() + coeff * l1, live)
    ref = [t.clone().requires_grad_(True) for t in leaves]
    scfg = SparsityConfig(enabled=True, activation="relu")
    y_ref, aux = sparse_ffn._dense_apply(dict(zip(("wg", "wu", "wd"),
                                                  ref[1:])),
                                         ref[0], scfg, True, True)
    want = torch.autograd.grad((y_ref * gy).sum() + coeff * aux["l1"], ref)
    errs = {}
    for name, g, w in zip(("x", "wg", "wu", "wd"), got, want):
        errs[name] = float((g - w).abs().max() / w.abs().max())
        assert errs[name] <= GRAD_TOL, \
            f"hybrid grad {name} off by {errs[name]} of its max"
    return {"phase": "grad_check", "M": m, "dtype": "float32",
            "tolerance": GRAD_TOL,
            "rel_max_err": errs, "backup_rows": int((nnz > 128).sum()),
            "mean_nnz": float(nnz.mean())}


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


def phase_check(torch, serve, olmo):
    """Tolerance: card logits (bf16 weights and activations, 8 layers) within
    LOGIT_TOL of the CPU's float32 logits, whose spread is about 1; a bf16
    value carries 8 significant bits, a relative rounding of 2^-9 per step.
    A token must match wherever the CPU's top-2 margin exceeds the tolerance.
    paper-0.5b runs its 8 layers; olmo-1b runs its first 2 (at full width),
    so that the CPU's float32 run stays short. Then one training step,
    ``check_train``."""
    from repro_torch.models import lm
    from repro_torch.tree import tree_map
    olmo_cfg = dataclasses.replace(olmo["cfg"], num_layers=2)
    models = {}
    for arch, cfg, params in (
            ("paper-0.5b", serve["cfg"], serve["params"]),
            ("olmo-1b", olmo_cfg, first_layers(olmo["params"], 2))):
        models[arch] = (cfg, params, dataclasses.replace(
            cfg, dtype="float32", param_dtype="float32"),
            tree_map(lambda t: t.float(), lm.params_to(params, "cpu")))
    report = []
    # the 64- and 96-token prompts through gather (paper-0.5b: K1 + K2;
    # olmo-1b: K1 + K6), the 64-token one through tile_skip at threshold 0
    # (K5)
    for arch, ridx, backend in (("paper-0.5b", 2, "gather"),
                                ("paper-0.5b", 5, "gather"),
                                ("paper-0.5b", 2, "tile_skip"),
                                ("olmo-1b", 2, "gather"),
                                ("olmo-1b", 5, "gather")):
        cfg, params, cfg32, cpu_params = models[arch]
        with torch.no_grad():
            prompt = serve["prompts"][ridx]
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
    emit({"phase": "check", "tolerance": LOGIT_TOL, "prompts": report,
          "train_step": check_train(torch)})


def loss_and_grads(torch, params, batch, cfg):
    from repro_torch.models import lm
    from repro_torch.tree import leaves_with_path, tree_map
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    named = list(leaves_with_path(live))
    loss, _ = lm.loss_fn(live, batch, cfg)
    grads = torch.autograd.grad(loss, [t for _, t in named])
    return float(loss.detach()), {n: g for (n, _), g in zip(named, grads)}


def check_train(torch):
    """One training step's loss and gradients at full width, 2 layers,
    batch 1 x 256, hybrid FFN: the card (bf16, kernels K7-K9) against the
    CPU (float32, the plain versions) on the same weights. Tolerance: loss
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
    cfg = train_config("hybrid", layers=2)
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
    return {"layers": 2, "batch": 1, "seq": 256, "card_loss": card_loss,
            "cpu_loss": cpu_loss, "loss_rel_err": loss_rel,
            "loss_tolerance": TRAIN_LOSS_TOL,
            "grad_tolerance": TRAIN_GRAD_TOL, "grad_rel_err": rel}


if __name__ == "__main__":
    sys.exit(main())
