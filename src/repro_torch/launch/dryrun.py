"""Dry run of one (arch x shape) cell on one H100, without the card (ports
``repro/launch/dryrun.py``).

JAX's dry run lowers and compiles a cell's step for 256 or 512 fake host
devices and reads XLA's memory and cost analyses. The port's runs the
step the card would run on meta tensors, which carry shapes and dtypes
and no data: the parameters, optimizer state and inputs are
``launch/specs.py``'s, every hand-written kernel stands in as its shape
function (``kernels/build.route``), and ``launch/op_analysis.py`` counts
the FLOPs, bytes and live storages of every op, the backward and
recomputation included. Nothing is allocated on any device and no card is
needed. (A fake CUDA tensor under ``FakeTensorMode`` would take the same
path, but torch built without CUDA runs no backward on one: its autograd
engine asks for the CUDA accelerator. A fake tensor's ops run their meta
kernels in any case, so the trace is the same op for op.)

The record keeps JAX's keys where the quantity carries over:
``param_count`` (the trainable tree, JAX's), ``peak_bytes_per_device``
(the high-water mark of live storages, arguments included),
``argument_size_in_bytes``, ``output_size_in_bytes``,
``temp_size_in_bytes`` (peak less both), ``alias_size_in_bytes`` (0: the
port's AdamW makes new tensors and donates nothing, so old and new
parameters and moments coexist in the update, and that is in the peak;
the decode cache is updated in place and is an argument, not an output),
``dot_flops_per_device``, ``collective_bytes_per_device`` (``{"total":
0}`` on one device), ``hbm_bytes_per_device`` (fused) and
``hbm_bytes_strict``, ``microbatch`` and ``status``. ``mesh`` is ``"1"``
and ``n_devices`` 1: one card, the mesh waits for ``ROADMAP.md`` queue 1
item 6.2. ``bound`` is ``"capacity"`` when a kernel whose work depends on
the data ran (K2-K6, K8, K9: live columns, sequence lengths) or the
hybrid backward took all N columns: that work is counted at the most its
shapes allow, an upper bound; else ``"exact"``. ``kernels`` gives each
kernel's calls, FLOPs and bytes.

XLA-only fields are dropped: ``hlo_chars``,
``generated_code_size_in_bytes``, ``xla_flops_per_device_raw``,
``xla_bytes_accessed_raw``, ``lower_s``/``compile_s`` (``trace_s``
instead) and the ``--dump-hlo`` flag. ``--multi-pod`` exits non-zero.

Usage: PYTHONPATH=src python -m repro_torch.launch.dryrun --arch paper-0.5b
--shape train_4k [--ffn-impl hybrid] [--remat full] [--microbatch 16]
[--out results/dryrun_torch/cell.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional, Tuple

import torch

from repro_torch import training
from repro_torch.config import LM_SHAPES, TrainConfig, shape_by_name
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import op_analysis, specs
from repro_torch.models import lm
from repro_torch.observability import accounting

# long_500k needs sub-quadratic attention: the SSM, hybrid and windowed or
# chunked archs run it, full-attention archs skip it (as JAX's dry run)
LONG_OK = {"mixtral-8x22b", "llama4-scout-17b-a16e", "zamba2-1.2b",
           "rwkv6-7b"}

MESH_WAITS = ("the port's dry run is one H100; the mesh (--multi-pod, "
              "dryrun_all --mesh multi) waits for ROADMAP.md queue 1 item 6.2")

# kernels whose work depends on data: their shape functions report it at
# the capacity of their shapes
CAPACITY_KERNELS = {"twell_fused_ffn", "twell_down_proj", "tile_skip_ffn",
                    "paged_decode_attention", "paged_chunk_attention",
                    "hybrid_to_dense", "dense_to_hybrid"}


def cell_list():
    cells = []
    for arch in list_archs():
        for sh in LM_SHAPES:
            if sh.name == "long_500k" and arch not in LONG_OK:
                continue
            cells.append((arch, sh.name))
    return cells


def cell_config(arch: str, ffn_impl: Optional[str] = None,
                remat: Optional[str] = None,
                overrides: Optional[Dict[str, str]] = None):
    """``arch``'s config with the CLI's replacements, as JAX's
    ``run_cell`` makes them (an override takes the field's type)."""
    cfg = get_config(arch)
    if ffn_impl:
        cfg = dataclasses.replace(
            cfg, sparsity=dataclasses.replace(cfg.sparsity, ffn_impl=ffn_impl))
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    if overrides:
        typed = {}
        for k, v in overrides.items():
            cur = getattr(cfg, k)
            typed[k] = type(cur)(v) if cur is not None else v
        cfg = dataclasses.replace(cfg, **typed)
    return cfg


def trace_cell(cfg, shape, *, microbatch: int = 0,
               grad_accum_dtype: str = "float32") -> Tuple[int, Dict]:
    """Run ``cfg``'s step for ``shape`` on meta tensors -> (param_count,
    ``op_analysis`` of the step)."""
    params = specs.abstract_params(cfg)
    train_params = lm.trainable(params)
    n = accounting.param_count(train_params)
    inp = specs.input_specs(cfg, shape)
    if shape.kind == "train":
        opt = specs.abstract_opt_state(params, cfg)
        step = training.make_train_step(cfg, TrainConfig(
            microbatch=microbatch, grad_accum_dtype=grad_accum_dtype))
        del params
        _, ana = op_analysis.count(step, train_params, opt, inp["batch"])
        return n, ana
    del train_params
    with torch.no_grad():
        if shape.kind == "prefill":
            _, ana = op_analysis.count(training.make_prefill_step(cfg),
                                       params, inp["batch"])
        else:
            _, ana = op_analysis.count(training.make_serve_step(cfg),
                                       params, inp["cache"], inp["tokens"])
    return n, ana


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             ffn_impl: Optional[str] = None, remat: Optional[str] = None,
             microbatch: int = 0, grad_accum_dtype: str = "float32",
             overrides: Optional[Dict[str, str]] = None) -> Dict:
    if multi_pod:
        raise NotImplementedError(MESH_WAITS)
    cfg = cell_config(arch, ffn_impl, remat, overrides)
    shape = shape_by_name(shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": "1", "axes": [],
           "kind": shape.kind, "ffn_impl": cfg.sparsity.ffn_impl,
           "remat": cfg.remat, "n_devices": 1, "device": "H100"}
    t0 = time.time()
    n, ana = trace_cell(cfg, shape, microbatch=microbatch,
                        grad_accum_dtype=grad_accum_dtype)
    rec["trace_s"] = round(time.time() - t0, 2)
    rec["param_count"] = n
    rec["argument_size_in_bytes"] = ana["argument_bytes"]
    rec["output_size_in_bytes"] = ana["output_bytes"]
    rec["temp_size_in_bytes"] = (ana["peak_bytes"] - ana["argument_bytes"]
                                 - ana["output_bytes"])
    rec["alias_size_in_bytes"] = 0
    rec["peak_bytes_per_device"] = ana["peak_bytes"]
    rec["dot_flops_per_device"] = ana["dot_flops_corrected"]
    rec["collective_bytes_per_device"] = ana["collective_bytes"]
    rec["hbm_bytes_per_device"] = ana["hbm_bytes_estimate"]
    rec["hbm_bytes_strict"] = ana["hbm_bytes_strict"]
    rec["microbatch"] = microbatch
    rec["bound"] = "capacity" if set(ana["kernels"]) & CAPACITY_KERNELS \
        or cfg.sparsity.ffn_impl == "hybrid" else "exact"
    rec["ops"] = ana["ops"]
    rec["kernels"] = ana["kernels"]
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true",
                    help="not yet: " + MESH_WAITS)
    ap.add_argument("--ffn-impl", default=None,
                    help="override sparsity.ffn_impl (dense|hybrid|...)")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--grad-accum-dtype", default="float32")
    ap.add_argument("--override", action="append", default=[],
                    help="ModelConfig field override, e.g. rwkv_chunk=64")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.multi_pod:
        print(f"dryrun: {MESH_WAITS}", file=sys.stderr)
        raise SystemExit(2)

    try:
        rec = run_cell(args.arch, args.shape, ffn_impl=args.ffn_impl,
                       remat=args.remat, microbatch=args.microbatch,
                       grad_accum_dtype=args.grad_accum_dtype,
                       overrides=dict(o.split("=", 1) for o in args.override))
        rec["status"] = "ok"
    except Exception as e:  # record failures as data, not crashes
        rec = {"arch": args.arch, "shape": args.shape, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    print(json.dumps({k: v for k, v in rec.items() if k != "traceback"},
                     indent=1))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    if rec["status"] != "ok":
        raise SystemExit(1)


if __name__ == "__main__":
    main()
