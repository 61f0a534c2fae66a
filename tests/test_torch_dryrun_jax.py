"""The port's dry run against JAX's on the same reduced cells: JAX's
``repro.launch.dryrun.run_cell`` in a subprocess on a (1, 1) mesh,
monkeypatched as tests/test_distributed.py's mini dry run does, beside
``repro_torch.launch.dryrun.run_cell`` in process.

Cells: paper-0.5b and olmo-1b at 2 layers, ``train_4k`` (dense FFN, remat
none) and ``decode_32k``, each at 8 rows of 64 tokens. ``param_count`` is
equal exactly. Dot FLOPs within 2%: XLA counts the dots of its optimized
HLO, the port the products of its eager step. In a train cell the port
does one product more, which is taken out before the comparison: K7's
backward recomputes each row's scores q k^T (2 B H S^2 hd a layer,
``kernels/flash_attention.py:flash_attention_backward``), where XLA keeps
the forward's probabilities. At this shape (d_model 64, S 64) that
product alone is 2.4% of the step's dot FLOPs.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro_torch.config import shape_by_name
from repro_torch.configs import get_config
from repro_torch.launch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("paper-0.5b", "olmo-1b")
SHAPES = ("train_4k", "decode_32k")
LAYERS, SEQ, BATCH = 2, 64, 8
FLOPS_RTOL = 0.02

_JAX = f"""
import dataclasses, json
import jax
from jax.sharding import AxisType
import repro.launch.dryrun as dr
import repro.configs as C
import repro.config as rc
dr.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
    (1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
dr.get_config = lambda name: C.get_config(name).reduced(num_layers={LAYERS})
shapes = {{s.name: s for s in rc.LM_SHAPES}}
dr.shape_by_name = lambda n: dataclasses.replace(
    shapes[n], seq_len={SEQ}, global_batch={BATCH})
out = {{}}
for arch in {ARCHS!r}:
    for shape in {SHAPES!r}:
        rec = dr.run_cell(arch, shape, multi_pod=False, ffn_impl="dense",
                          remat="none")
        out[arch + "/" + shape] = {{k: rec[k] for k in (
            "param_count", "dot_flops_per_device", "n_devices")}}
print("JAX_RECORDS", json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_records():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", _JAX], capture_output=True,
                       text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("JAX_RECORDS ")][-1]
    return json.loads(line[len("JAX_RECORDS "):])


@pytest.fixture
def reduced_cells(monkeypatch):
    monkeypatch.setattr(dryrun, "get_config",
                        lambda name: get_config(name).reduced(
                            num_layers=LAYERS))
    monkeypatch.setattr(dryrun, "shape_by_name",
                        lambda n: dataclasses.replace(
                            shape_by_name(n), seq_len=SEQ,
                            global_batch=BATCH))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_dry_run_matches_jax(jax_records, reduced_cells, arch, shape):
    want = jax_records[f"{arch}/{shape}"]
    got = dryrun.run_cell(arch, shape, ffn_impl="dense", remat="none")
    assert got["param_count"] == want["param_count"]
    assert got["n_devices"] == 1 and got["mesh"] == "1"
    cfg = dryrun.get_config(arch)
    recompute = LAYERS * 2 * BATCH * cfg.num_heads * SEQ ** 2 * \
        cfg.resolved_head_dim if shape == "train_4k" else 0
    flops = got["dot_flops_per_device"] - recompute
    rel = abs(flops - want["dot_flops_per_device"]) / \
        want["dot_flops_per_device"]
    assert rel <= FLOPS_RTOL, (got["dot_flops_per_device"], recompute,
                               want["dot_flops_per_device"], rel)
