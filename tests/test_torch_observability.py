"""The port's observability package (``repro_torch/observability``) against
the JAX package's: every accounting function at equal constants (the port
holds the H100's, the JAX package a TPU's, so ``peak`` and ``tdp_w`` are
passed), the TwELL occupancy bridge on the same activations, the sparsity
report of a step, and the JSONL run log (round trip, torn line, closed
logger, as tests/test_observability.py holds the JAX one).

Tolerance: the cost model is float64 host arithmetic in the same order on
both sides, so every number is equal; a statistic reduced from float32
activations within 1e-6 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import twell as jtwell
from repro.models import lm as jlm
from repro.observability import accounting as jacc
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import twell
from repro_torch.models import lm
from repro_torch.observability import (CHIP_TDP_W, HBM_BW, LINK_BW,
                                       PEAK_FLOPS, RunLogger, SparsityReport,
                                       accounting, iter_runlog, read_runlog)

ARCHS = ("paper-0.5b", "paper-1.5b", "olmo-1b")
IMPLS = ("dense", "gather", "tile_skip", "hybrid")


def _cfgs(arch, impl="dense"):
    out = []
    for base in (jax_get_config(arch), get_config(arch)):
        out.append(dataclasses.replace(base, sparsity=dataclasses.replace(
            base.sparsity, ffn_impl=impl)))
    return out


def test_constants_are_the_h100s():
    assert (PEAK_FLOPS, HBM_BW, LINK_BW, CHIP_TDP_W) == \
        (989e12, 3.35e12, 900e9, 700.0)


@pytest.mark.parametrize("arch", ["paper-0.5b", "olmo-1b"])
def test_param_count_matches_jax(arch):
    jcfg, cfg = (c.reduced() for c in _cfgs(arch))
    tree = jax.tree_util.tree_map(np.array,
                                  jlm.init(jax.random.PRNGKey(0), jcfg))
    params = lm.trainable(bridge.from_numpy(tree))
    assert accounting.param_count(params) == jacc.param_count(tree)
    n = accounting.param_count(params)
    assert accounting.matmul_params(cfg, n) == jacc.matmul_params(jcfg, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_mfu_and_energy_match_jax(arch):
    jcfg, cfg = _cfgs(arch)
    n = 1_234_567_891
    for train in (False, True):
        for tokens in (1, 8192):
            assert accounting.model_flops(cfg, n, tokens, train=train) == \
                jacc.model_flops(jcfg, n, tokens, train=train)
    for args in ((3e15, 1.5), (3e15, 1.5, 4), (1.0, 0.0), (1.0, 1.0, 0)):
        assert accounting.mfu(*args, peak=PEAK_FLOPS) == \
            jacc.mfu(*args, peak=PEAK_FLOPS)
    for args in ((8192, 0.25), (8192, 0.25, 4), (1.0, 0.0)):
        assert accounting.tokens_per_joule(*args, tdp_w=CHIP_TDP_W) == \
            jacc.tokens_per_joule(*args, tdp_w=CHIP_TDP_W)
    assert accounting.mfu(989e12, 1.0) == 1.0


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_ffn_cost_model_matches_jax(arch, impl):
    jcfg, cfg = _cfgs(arch, impl)
    assert accounting.ffn_dense_flops_per_token(cfg) == \
        jacc.ffn_dense_flops_per_token(jcfg)
    for nnz in (0, 10.5, 113, cfg.d_ff, 10 * cfg.d_ff):
        for tf in (None, 0.25, 1.5):
            assert accounting.ffn_effective_flops_per_token(
                cfg, impl, nnz, tf) == \
                jacc.ffn_effective_flops_per_token(jcfg, impl, nnz, tf)
            for db in (None, 4):
                assert accounting.ffn_bytes_per_token(
                    cfg, impl, nnz, tf, dtype_bytes=db) == \
                    jacc.ffn_bytes_per_token(jcfg, impl, nnz, tf,
                                             dtype_bytes=db)
    with pytest.raises(ValueError):
        accounting.ffn_effective_flops_per_token(cfg, "sparse", 1)


@pytest.mark.parametrize("impl", IMPLS)
def test_sparsity_report_matches_jax(impl):
    jcfg, cfg = _cfgs("paper-1.5b", impl)
    rng = np.random.RandomState(0)
    nnz = rng.uniform(0, 200, cfg.num_layers)
    tf = rng.uniform(0, 1, cfg.num_layers)
    dead = rng.uniform(0, 0.1, cfg.num_layers)
    present = (rng.rand(cfg.num_layers) < 0.9).astype(np.float32)
    kw = dict(tile_frac_per_layer=tf, dead_frac_per_layer=dead,
              ffn_present=present, n_params=1_543_000_000, train=True,
              chips=1)
    got = SparsityReport.build(cfg, 8192, torch.from_numpy(nnz), **kw)
    want = jacc.SparsityReport.build(jcfg, 8192, nnz, **kw)
    assert got.to_dict() == want.to_dict()
    assert got.mfu_estimate(0.9, peak=PEAK_FLOPS) == \
        want.mfu_estimate(0.9, peak=PEAK_FLOPS)
    assert SparsityReport.build(cfg, 8, nnz).mfu_estimate(1.0) is None


def test_stats_and_tile_occupancy_match_jax():
    rng = np.random.RandomState(0)
    h = rng.randn(64, 512).astype(np.float32)
    h[rng.rand(64, 512) < 0.97] = 0
    h = np.maximum(h, 0)
    got = accounting.stats_from_hidden(torch.from_numpy(h))
    want = jacc.stats_from_hidden(jnp.asarray(h))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    tw = twell.pack(torch.from_numpy(h), 128, 4)
    jtw = jtwell.pack(jnp.asarray(h), 128, 4)
    np.testing.assert_array_equal(tw.nnz.numpy(), np.asarray(jtw.nnz))
    for rb in (8, 16):
        got = accounting.tile_occupancy_from_twell(tw, rb)
        want = jacc.tile_occupancy_from_twell(jtw, rb)
        assert got == pytest.approx(want, rel=1e-6)
        np.testing.assert_array_equal(
            twell.tile_activity(tw, rb).numpy(),
            np.asarray(jtwell.tile_activity(jtw, rb)))


# --------------------------------------------------------------------------- #
# JSONL run log
# --------------------------------------------------------------------------- #

def test_runlog_roundtrip_and_kinds(tmp_path):
    p = str(tmp_path / "run.jsonl")
    with RunLogger(p, meta={"arch": "tiny"}) as log:
        log.step(0, loss=2.0, nnz_per_layer=torch.tensor([3.0, 4.0]))
        log.step(1, loss=torch.tensor(1.5),
                 nnz_per_layer=np.array([2.0, 3.0]))
        log.event("watchdog", message="slow step", step=1)
    recs = read_runlog(p)
    assert [r["kind"] for r in recs] == ["meta", "step", "step", "event"]
    assert recs[0]["schema_version"] == 1 and recs[0]["arch"] == "tiny"
    steps = read_runlog(p, kind="step")
    assert steps[0]["nnz_per_layer"] == [3.0, 4.0]    # tensors -> lists
    assert steps[1]["loss"] == 1.5 and steps[1]["nnz_per_layer"] == [2., 3.]
    assert all("ts" in r for r in recs)
    assert read_runlog(p, kind="event")[0]["event"] == "watchdog"


def test_runlog_append_and_torn_line(tmp_path):
    p = str(tmp_path / "run.jsonl")
    with RunLogger(p) as log:
        log.step(0, loss=1.0)
    with open(p, "a") as f:
        f.write('{"kind": "step", "truncat\n')      # simulated crash
    with RunLogger(p) as log:                        # resume appends
        log.step(1, loss=0.5)
    assert [r["kind"] for r in iter_runlog(p)] == \
        ["meta", "step", "meta", "step"]             # torn line skipped


def test_closed_runlog_raises(tmp_path):
    log = RunLogger(str(tmp_path / "r.jsonl"))
    log.close()
    with pytest.raises(RuntimeError):
        log.step(0, loss=1.0)


def test_runlog_console_echo(tmp_path, capsys):
    with RunLogger(str(tmp_path / "r.jsonl"), console=True) as log:
        log.event("resume", message="resumed from step 3", step=3)
        log.event("quiet")
    assert capsys.readouterr().out == "[train] resumed from step 3\n"
