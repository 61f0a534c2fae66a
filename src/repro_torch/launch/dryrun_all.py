"""Run every dry-run cell as a subprocess and collect the JSONs (ports
``repro/launch/dryrun_all.py``).

Per-cell knobs, JAX's for one pod: train cells run with 2-level (sqrt)
remat and microbatches of 16 rows; the largest archs accumulate gradients
in bf16 (``BF16_ACCUM``). Each cell's record goes to ``RESULTS``
(``results/dryrun_torch/`` at the repo root, ignored by git), one file a
cell; a cell already there with status ok is skipped unless ``--force``.
``--mesh`` takes only ``single``: the port's dry run is one H100, and the
mesh waits for ``ROADMAP.md`` queue 1 item 6.2.

Usage: PYTHONPATH=src python -m repro_torch.launch.dryrun_all
[--only arch] [--timeout S] [--force]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

BF16_ACCUM = {"mixtral-8x22b", "llama3-405b", "deepseek-67b",
              "llama4-scout-17b-a16e"}
# larger microbatches amortise FSDP gathers where activations fit (JAX's
# single-pod setting for deepseek-67b; kept so the cells match)
MB32_SINGLE = {"deepseek-67b"}


def cell_cmd(arch, shape, out):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--out", str(out)]
    if shape == "train_4k":
        mb = "32" if arch in MB32_SINGLE else "16"
        cmd += ["--remat", "2level", "--microbatch", mb]
        if arch in BF16_ACCUM:
            cmd += ["--grad-accum-dtype", "bfloat16"]
    return cmd


def _status(out: Path) -> str:
    try:
        return json.loads(out.read_text()).get("status", "?")
    except (OSError, ValueError):
        return "badjson"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None)
    ap.add_argument("--mesh", default="single", choices=["single"],
                    help="single only: the mesh waits for ROADMAP.md "
                         "queue 1 item 6.2")
    ap.add_argument("--timeout", type=int, default=1200)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import cell_list
    RESULTS.mkdir(parents=True, exist_ok=True)
    cells = [(a, s) for a, s in cell_list() if not args.only or a == args.only]
    t00 = time.time()
    n_ok = n_fail = n_skip = 0
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    for arch, shape in cells:
        tag = f"{arch}__{shape}__single"
        out = RESULTS / (tag + ".json")
        if out.exists() and not args.force and _status(out) == "ok":
            n_skip += 1
            continue
        t0 = time.time()
        try:
            r = subprocess.run(cell_cmd(arch, shape, out),
                               capture_output=True, text=True,
                               timeout=args.timeout, env=env)
            crashed = r.returncode != 0 and _status(out) != "error"
            stderr = r.stderr
        except subprocess.TimeoutExpired as e:
            crashed, stderr = True, f"timeout after {e.timeout} s"
        if crashed:
            out.write_text(json.dumps(
                {"arch": arch, "shape": shape, "status": "crash",
                 "stderr": (stderr or "")[-3000:]}, indent=1))
        status = _status(out)
        if status == "ok":
            n_ok += 1
        else:
            n_fail += 1
        print(f"[{time.time() - t00:7.1f}s] {tag:60s} {status:8s} "
              f"{time.time() - t0:6.1f}s", flush=True)
    print(f"done: ok={n_ok} fail={n_fail} skipped={n_skip}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
