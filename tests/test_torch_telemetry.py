"""The port's telemetry (``repro_torch.serving.telemetry`` / ``trace`` /
``engine_spec``) against the JAX package's, on the CPU.

- The registry: the same calls on both ``MetricsRegistry`` classes render
  byte-identical Prometheus text, and so do the two ``ServingMetrics``
  catalogs (families, HELP and TYPE lines, buckets).
- The engine hooks, on the workloads of tests/test_telemetry.py (simple,
  cancel while queued and while running, preempt-resume, spec): every
  request's span sequence, the lifecycle counters, the KV-pool gauges and
  ``jit_compiles_total{entry}`` equal the JAX engine's on the same bridged
  weights, synchronous and pipelined; the per-layer FFN sparsity and the
  dense/effective FLOPs counters within 1e-5 relative (float32).
- Tokens with telemetry on equal tokens with it off, synchronous and
  pipelined, with and without speculation; the Chrome trace parses.
- ``EngineSpec``'s fields are the port's ``ServingEngine.__init__``
  keywords.
"""
import dataclasses
import inspect
import json

import numpy as np
import pytest

from repro.serving import SamplingParams as JaxSampling
from repro.serving import ServingEngine as JaxEngine
from repro.serving import SpecConfig as JaxSpec
from repro.serving import telemetry as jtel
from repro_torch.serving import (EngineSpec, SamplingParams, ServingEngine,
                                 SpecConfig, Telemetry, TraceRecorder,
                                 span_names)
from repro_torch.serving import telemetry as ttel
from repro_torch.serving.trace import SPAN_DECODE, SPAN_FINISH, SPAN_QUEUED
from test_torch_engine import BS, _model

REL = 1e-5


# --------------------------------------------------------------------------- #
# registry and catalog: byte-identical exposition
# --------------------------------------------------------------------------- #

def _exercise(mod):
    """One fixed sequence of registry and catalog calls; the rendered text."""
    r = mod.MetricsRegistry()
    c = r.counter("c_total", "a counter", ["kind"])
    c.inc(kind="x")
    c.inc(2.5, kind="x")
    c.inc(kind="y")
    g = r.gauge("g", "a gauge")
    g.set(7)
    g.inc(-2)
    h = r.histogram("h_seconds", "latency", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.1, 0.5, 2.0, 99.0, 1e-9, 3.25):
        h.observe(v)
    m = mod.ServingMetrics(r)
    rng = np.random.RandomState(0)
    for phase in ("decode", "prefill", "plan", "overlap", "step"):
        for v in rng.exponential(0.01, 5):
            m.step_phase_seconds.observe(float(v), phase=phase)
    m.kv_blocks.set(12, state="free")
    m.kv_blocks.set(3.5, state="live")
    m.spec_acceptance.observe(0.75)
    m.spec_acceptance.observe(1.0)
    m.ttft_seconds.observe(0.123, priority="0", role="unified")
    m.jit_compiles_total.inc(entry="decode")
    m.build_info.set(1, backend="gather", attn_backend="plain",
                     scheduler="fcfs", spec_k="0", tp="1")
    m.effective_flops_total.inc(1.5e12)
    m.mfu.set(0.0123456789)
    m.ffn_sparsity.set(0.98125, layer="0")
    return r.render_prometheus()


def test_registry_renders_byte_identical_to_jax():
    assert _exercise(ttel) == _exercise(jtel)
    assert ttel.TIME_BUCKETS == jtel.TIME_BUCKETS
    assert ttel.RATIO_BUCKETS == jtel.RATIO_BUCKETS


def test_catalogs_render_the_same_families():
    mine = ttel.ServingMetrics(ttel.MetricsRegistry())
    theirs = jtel.ServingMetrics(jtel.MetricsRegistry())
    text = mine.registry.render_prometheus()
    assert text == theirs.registry.render_prometheus()
    assert text.count("# TYPE ") == 28
    assert ttel.MetricsRegistry(enabled=False).render_prometheus() == ""
    names = [n for n in dir(jtel) if n.startswith("PHASE_")]
    assert {n: getattr(ttel, n) for n in names} == \
        {n: getattr(jtel, n) for n in names}


# --------------------------------------------------------------------------- #
# engine hooks on the workloads of tests/test_telemetry.py
# --------------------------------------------------------------------------- #

def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, n).tolist() for n in lens]


def _drain(engine):
    while engine.has_unfinished():
        engine.step()


def _simple(engine):
    hs = [engine.submit(p, max_tokens=5) for p in _prompts([6, 9], seed=3)]
    _drain(engine)
    return hs


def _cancel(engine):
    p1, p2 = _prompts([8, 6], seed=5)
    ha = engine.submit(p1, max_tokens=4)
    hb = engine.submit(p2, max_tokens=4)
    engine.step()
    assert hb.cancel()                        # while still queued
    engine.step()
    assert ha.status == "running"
    assert ha.cancel()                        # mid-decode
    _drain(engine)
    return [ha, hb]


def _preempt(engine):
    lo_p, hi_p = _prompts([8, 8], seed=21)
    lo = engine.submit(lo_p, max_tokens=6, priority=0)
    for _ in range(3):
        engine.step()
    hi = engine.submit(hi_p, max_tokens=4, priority=1)
    _drain(engine)
    assert lo.result().num_preemptions == 1
    return [lo, hi]


def _spec(engine):
    hs = [engine.submit(p, max_tokens=6) for p in _prompts([8, 5], seed=31)]
    _drain(engine)
    return hs


WORKLOADS = {
    "simple": (_simple, dict(max_batch=2, max_seq_len=32)),
    "cancel": (_cancel, dict(num_blocks=4, max_batch=2, max_seq_len=16)),
    "preempt": (_preempt, dict(num_blocks=6, max_batch=2, max_seq_len=16,
                               scheduler="priority")),
    "spec": (_spec, dict(max_batch=2, max_seq_len=32,
                         spec=dict(k=2, draft_backend="tile_skip"))),
}


def _cfgs(backend):
    jp, jcfg, tcfg, tp = _model()
    if backend == "gather":
        jcfg, tcfg = [dataclasses.replace(c, sparsity=dataclasses.replace(
            c.sparsity, twell_c=1)) for c in (jcfg, tcfg)]
    return jp, jcfg, tcfg, tp


def _port(backend, kw, telemetry=True, pipeline=False):
    _, _, tcfg, tp = _cfgs(backend)
    kw = dict(kw)
    spec = kw.pop("spec", None)
    return ServingEngine(tp, tcfg, backend=backend, block_size=BS,
                         telemetry=telemetry, pipeline=pipeline,
                         spec=None if spec is None else SpecConfig(**spec),
                         device="cpu", **kw)


def _jax(backend, kw, pipeline=False):
    jp, jcfg, _, _ = _cfgs(backend)
    kw = dict(kw)
    spec = kw.pop("spec", None)
    return JaxEngine(jp, jcfg, backend=backend, block_size=BS,
                     telemetry=True, pipeline=pipeline,
                     spec=None if spec is None else JaxSpec(**spec), **kw)


def _books(tm):
    """Every exactly comparable counter and gauge of one engine's run."""
    m = tm.metrics
    return {
        "steps": m.steps_total.value(),
        "tokens": m.tokens_total.value(),
        "submitted": m.submitted_total.value(),
        "requests": {tuple(sorted(ls.items())): m.requests_total.value(**ls)
                     for ls in m.requests_total.label_sets()},
        "preemptions": m.preemptions_total.value(),
        "prefix": {s: m.prefix_tokens_total.value(source=s)
                   for s in ("cached", "computed")},
        "spec": {o: m.spec_tokens_total.value(outcome=o)
                 for o in ("drafted", "accepted")},
        "kv_blocks": {ls["state"]: m.kv_blocks.value(**ls)
                      for ls in m.kv_blocks.label_sets()},
        "kv_events": {ls["event"]: m.kv_events_total.value(**ls)
                      for ls in m.kv_events_total.label_sets()},
        "jit_compiles": {ls["entry"]: m.jit_compiles_total.value(**ls)
                         for ls in m.jit_compiles_total.label_sets()},
        "ttft_count": m.ttft_seconds.snapshot(priority="0",
                                              role="unified")["count"],
        "itl_count": m.itl_seconds.snapshot(priority="0",
                                            role="unified")["count"],
        "phases": sorted(ls["phase"] for ls in
                         m.step_phase_seconds.label_sets()),
    }


def _sparsity(tm):
    m = tm.metrics
    return ({ls["layer"]: m.ffn_sparsity.value(**ls)
             for ls in m.ffn_sparsity.label_sets()},
            m.dense_flops_total.value(), m.effective_flops_total.value(),
            m.tile_occupancy.snapshot())


def _close(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-30)


CASES = [("simple", "dense", False), ("simple", "gather", True),
         ("cancel", "dense", False), ("cancel", "gather", True),
         ("preempt", "dense", True), ("preempt", "gather", False),
         ("spec", "dense", False), ("spec", "gather", True)]


@pytest.mark.parametrize("workload,backend,pipeline", CASES,
                         ids=[f"{w}-{b}-{'pipe' if p else 'sync'}"
                              for w, b, p in CASES])
def test_engine_telemetry_equals_jax(workload, backend, pipeline):
    run, kw = WORKLOADS[workload]
    je, te = _jax(backend, kw, pipeline), _port(backend, kw,
                                                 pipeline=pipeline)
    jh, th = run(je), run(te)
    for a, b in zip(jh, th):
        assert b.result().token_ids == a.result().token_ids
        assert span_names(b.result().spans) == span_names(a.result().spans)
        assert [s.args for s in b.result().spans] == \
            [tuple((k, v) for k, v in s.args) for s in a.result().spans]
    assert _books(te.telemetry) == _books(je.telemetry)
    tl, td, teff, tocc = _sparsity(te.telemetry)
    jl, jd, jeff, jocc = _sparsity(je.telemetry)
    assert set(tl) == set(jl) == {str(i) for i in range(te.cfg.num_layers)}
    assert all(_close(tl[k], jl[k]) for k in jl), (tl, jl)
    assert _close(td, jd) and _close(teff, jeff), (td, jd, teff, jeff)
    assert tocc["count"] == jocc["count"]
    ts, js = te.telemetry.summary(), je.telemetry.summary()
    assert _close(ts["sparsity"]["mean_ffn_sparsity"],
                  js["sparsity"]["mean_ffn_sparsity"])
    assert ts["jit_compiles"] == js["jit_compiles"]
    prom = te.telemetry.registry.render_prometheus()
    assert ('serving_build_info{backend="%s",attn_backend="plain",'
            'scheduler="%s",spec_k="%d",tp="1"} 1'
            % (backend, te.scheduler.name, 0 if te.spec is None else 2)
            ) in prom


# --------------------------------------------------------------------------- #
# telemetry changes no token; the trace exports
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipe"])
@pytest.mark.parametrize("spec", [None, dict(k=2, draft_backend="tile_skip")],
                         ids=["plain", "spec"])
def test_tokens_equal_with_telemetry_off(pipeline, spec):
    kw = dict(max_batch=4, max_seq_len=48, prefill_chunk=8)
    if spec is not None:
        kw["spec"] = spec
    prompts = _prompts([6, 19, 11, 3], seed=7)
    samp = [None, SamplingParams(temperature=0.8, top_k=8, seed=3), None,
            SamplingParams(temperature=1.0, seed=4)]
    outs = []
    for telemetry in (False, True):
        e = _port("gather", kw, telemetry=telemetry, pipeline=pipeline)
        hs = [e.submit(p, sampling=s, max_tokens=7)
              for p, s in zip(prompts, samp)]
        _drain(e)
        outs.append([h.result() for h in hs])
        assert (e.telemetry is None) == (not telemetry)
    assert [o.token_ids for o in outs[0]] == [o.token_ids for o in outs[1]]
    assert all(o.spans is None for o in outs[0])
    assert all(o.spans is not None for o in outs[1])


def test_chrome_trace_export(tmp_path):
    e = _port("gather", dict(max_batch=2, max_seq_len=32), pipeline=True)
    for p in _prompts([6, 9], seed=11):
        e.submit(p, max_tokens=4)
    e.step()
    path = tmp_path / "engine.trace.json"
    e.export_trace(str(path))                 # mid-flight: open spans too
    _drain(e)
    e.export_trace(str(path))
    evs = json.loads(path.read_text())["traceEvents"]
    names = {ev["args"]["name"] for ev in evs if ev["ph"] == "M"}
    assert {"engine step phases", "request 0", "request 1"} <= names
    durs = [ev for ev in evs if ev["ph"] == "X"]
    assert all(ev["dur"] >= 0 and ev["ts"] >= 0 for ev in durs)
    assert {"plan", "launch", "collect", "overlap", SPAN_QUEUED,
            SPAN_DECODE} <= {ev["name"] for ev in durs}
    assert len([ev for ev in evs if ev["ph"] == "i" and
                ev["name"] == SPAN_FINISH]) == 2
    off = _port("dense", dict(max_batch=2, max_seq_len=32), telemetry=False)
    with pytest.raises(RuntimeError):
        off.export_trace(str(tmp_path / "never.json"))
    assert not (tmp_path / "never.json").exists()


def test_shared_telemetry_instance_and_trace_off():
    """A Telemetry passed in is the one the engine publishes into; with
    trace=False there are metrics but no spans."""
    tm = Telemetry(trace=False)
    e = _port("dense", dict(max_batch=2, max_seq_len=32), telemetry=tm)
    assert e.telemetry is tm
    outs = e.generate(_prompts([5], seed=2), max_tokens=3)
    assert outs[0].spans is None and tm.trace is None
    assert tm.metrics.tokens_total.value() == 3
    rec = TraceRecorder(max_events=3)
    for i in range(5):
        rec.phase_span("decode", float(i), float(i) + 0.5, i)
    assert len(rec) == 3


def test_engine_spec_mirrors_engine_ctor():
    sig = inspect.signature(ServingEngine.__init__)
    ctor = {n: p for n, p in sig.parameters.items()
            if n not in ("self", "params", "cfg")}
    fields = {f.name: f for f in dataclasses.fields(EngineSpec)}
    assert set(ctor) == set(fields), \
        "EngineSpec fields drifted from ServingEngine.__init__ kwargs"
    for name, p in ctor.items():
        assert fields[name].default == p.default, name
    _, _, tcfg, tp = _cfgs("dense")
    spec = EngineSpec(block_size=BS, max_batch=2, max_seq_len=32,
                      device="cpu")
    e = spec.replace(telemetry=True).build(tp, tcfg)
    assert e.telemetry is not None and e.max_batch == 2
    assert spec.kwargs()["telemetry"] is False
    ref = spec.build(tp, tcfg).generate(_prompts([6], seed=1), max_tokens=4)
    jp, jcfg, _, _ = _cfgs("dense")
    want = JaxEngine(jp, jcfg, block_size=BS, max_batch=2,
                     max_seq_len=32).generate(_prompts([6], seed=1),
                                              sampling=JaxSampling(),
                                              max_tokens=4)
    assert ref[0].token_ids == want[0].token_ids
