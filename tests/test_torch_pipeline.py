"""The port's pipelined engine (``ServingEngine(pipeline=True)``) and its
step programs, against the port's synchronous engine and the JAX package's
pipelined engine on the same bridged weights: the regimes of
tests/test_pipeline.py (greedy, seeded stochastic, speculative decode,
chunked prefill with prefix-cache COW, preempt/resume) token for token for
the dense and gather backends; cancels racing an in-flight step (queued,
mid-prefill, mid-decode, mid-spec) with launched tables untouched;
``flush()`` and ``has_unfinished()`` draining the tail; zero new programs
after ``warmup()``, whose rows equal the JAX engine's. Also the pieces the
card's graphs rest on, checked on the CPU: ``OverflowLog`` flags updated in
place, the replay launch accounting, and the sampler's bits.

Everything runs on the CPU in float32: the port on its plain versions (a
CPU program is its eager entry), JAX on its references.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.serving import SamplingParams as JaxSampling
from repro.serving import ServingEngine as JaxEngine
from repro.serving import SpecConfig as JaxSpec
from repro.serving.pipeline import bucket_grid as jax_bucket_grid
from repro_torch.kernels import build, ops
from repro_torch.serving import (EVENT_CANCEL, EVENT_PREEMPT, SamplingParams,
                                 ServingEngine, SpecConfig)
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import sampling as tsampling
from repro_torch.serving.pipeline import bucket, bucket_grid, sequence_hash
from test_torch_engine import BS, _model

BACKENDS = ["dense", "gather"]


def _cfgs(backend):
    """(JAX params, JAX config, port config, port params); the gather
    backend at C = 1, as tests/test_torch_engine.py runs it."""
    jp, jcfg, tcfg, tp = _model()
    if backend == "gather":
        jcfg, tcfg = [dataclasses.replace(c, sparsity=dataclasses.replace(
            c.sparsity, twell_c=1)) for c in (jcfg, tcfg)]
    return jp, jcfg, tcfg, tp


def _port(backend="dense", pipeline=True, spec=None, **kw):
    _, _, tcfg, tp = _cfgs(backend)
    kw.setdefault("block_size", BS)
    return ServingEngine(tp, tcfg, backend=backend, device="cpu",
                         pipeline=pipeline,
                         spec=None if spec is None else SpecConfig(**spec),
                         **kw)


def _jax(backend="dense", spec=None, **kw):
    jp, jcfg, _, _ = _cfgs(backend)
    kw.setdefault("block_size", BS)
    return JaxEngine(jp, jcfg, backend=backend, pipeline=True,
                     spec=None if spec is None else JaxSpec(**spec), **kw)


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, n).tolist() for n in lens]


def _drain(engine):
    events = []
    while engine.has_unfinished():
        events.extend(engine.step())
    return events


def _assert_clean(engine):
    engine.kv.check_invariants()
    assert engine.kv.num_available == engine.kv.num_blocks - 1, \
        "KV blocks leaked"
    assert engine._reserved == 0, "reservation leaked"
    assert engine._inflight is None, "in-flight step survived the drain"


def _three(run, backend, **kw):
    """``run(engine, sampling_cls)`` on JAX's pipelined engine, the port's
    synchronous engine and the port's pipelined engine built with ``kw``;
    asserts the three results equal and the port's pools clean. Returns
    (port pipelined result, its engine, port synchronous engine)."""
    je = _jax(backend, **kw)
    ts, tp = _port(backend, False, **kw), _port(backend, True, **kw)
    want = run(je, JaxSampling)
    got_sync = run(ts, SamplingParams)
    got = run(tp, SamplingParams)
    assert got_sync == want, "port synchronous engine diverged from JAX"
    assert got == want, "port pipelined engine diverged from JAX's"
    for eng in (ts, tp):
        _assert_clean(eng)
    return got, tp, ts


# --------------------------------------------------------------------------- #
# bucketing helpers: tests/test_pipeline.py:78
# --------------------------------------------------------------------------- #

def test_bucket_and_grid():
    assert [bucket(n, 1, 4) for n in (1, 2, 3, 4, 5, 9)] == [1, 2, 4, 4, 4, 4]
    assert bucket(5, 4, 64) == 8 and bucket(17, 4, 64) == 32
    assert bucket_grid(1, 4) == [1, 2, 4]
    assert bucket_grid(4, 64) == [4, 8, 16, 32, 64]
    for lo, hi in ((1, 4), (4, 64), (2, 5), (1, 34)):
        grid = set(bucket_grid(lo, hi))
        assert all(bucket(n, lo, hi) in grid for n in range(1, hi + 1))
        assert bucket_grid(lo, hi) == jax_bucket_grid(lo, hi)
    assert engine_mod.bucket is bucket          # the old import still works


# --------------------------------------------------------------------------- #
# pipelined == synchronous == JAX pipelined, regime by regime
# --------------------------------------------------------------------------- #

def _generate(prompts, sampling=None, max_tokens=6):
    def run(eng, cls):
        sp = None if sampling is None else cls(**sampling)
        return [o.token_ids for o in eng.generate(prompts, sampling=sp,
                                                  max_tokens=max_tokens)]
    return run


@pytest.mark.parametrize("backend", BACKENDS)
def test_pipeline_greedy_identity(backend):
    _, tp, ts = _three(_generate(_prompts([5, 9, 7, 12])), backend,
                       max_batch=4, max_seq_len=32)
    # the pipelined run overlapped: collect came a step after launch
    assert any(s.overlap_ms > 0 for s in tp.stats)
    assert all(s.overlap_ms == 0 for s in ts.stats)


@pytest.mark.parametrize("backend", BACKENDS)
def test_pipeline_seeded_stochastic_identity(backend):
    """Per-request keys are (seed, output position)-determined, never
    schedule-determined, so the one-step launch lag cannot change draws."""
    got, _, _ = _three(_generate(
        _prompts([5, 9, 7], seed=3),
        dict(temperature=0.9, top_k=32, top_p=0.9, seed=77)), backend,
        max_batch=4, max_seq_len=32, seed=11)
    assert any(got), "no tokens sampled"


@pytest.mark.parametrize("backend", BACKENDS)
def test_pipeline_spec_identity(backend):
    """Draft + verify under the pipeline (the verify's token block built
    from the draft program's output, both in one launch)."""
    _, tp, _ = _three(_generate(_prompts([6, 9, 5], seed=7), max_tokens=8),
                      backend, max_batch=4, max_seq_len=32,
                      spec=dict(k=2, draft_backend="tile_skip",
                                draft_threshold=0.3))
    assert sum(s.spec_drafted for s in tp.stats) > 0
    assert sum(s.spec_accepted for s in tp.stats) > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_pipeline_chunked_prefill_prefix_cow_identity(backend):
    """Chunked prefill + shared-prefix reuse + COW of the live shared last
    block: the launch/collect split must not reorder any of it."""
    rng = np.random.RandomState(17)
    system = rng.randint(0, 256, 3 * BS).tolist()          # block-aligned
    first = system + rng.randint(0, 256, 3).tolist()
    later = [system + rng.randint(0, 256, 3).tolist()
             for _ in range(2)] + [list(system)]           # fully cached dupe

    def run(eng, _cls):
        outs = [o.token_ids for o in eng.generate([first], max_tokens=4)]
        outs += [o.token_ids for o in eng.generate(later, max_tokens=4)]
        return outs, eng.cached_tokens_total

    (_, cached), tp, _ = _three(run, backend, max_batch=4, max_seq_len=32,
                                prefill_chunk=4, min_prefill_bucket=4)
    assert cached > 0, "prefix cache never hit"
    assert tp.kv.cow_count >= 1, "COW never exercised"


@pytest.mark.parametrize("backend", BACKENDS)
def test_pipeline_preempt_resume_identity(backend):
    """Priority preemption under a tight pool: victims planned while a
    step is in flight preempt at collect, and the resumed request's tokens
    equal the synchronous engine's."""
    lo_p, hi_p = _prompts([8, 8], seed=21)

    def run(eng, _cls):
        lo = eng.submit(lo_p, max_tokens=6, priority=0)
        for _ in range(4):
            eng.step()
        hi = eng.submit(hi_p, max_tokens=4, priority=1)
        events = _drain(eng)
        assert any(e.kind == EVENT_PREEMPT and e.rid == lo.rid
                   for e in events), "low-priority row not preempted"
        return (lo.result().token_ids, hi.result().token_ids,
                lo.result().num_preemptions)

    got, _, _ = _three(run, backend, num_blocks=6, max_batch=2,
                       max_seq_len=16, scheduler="priority")
    assert got[2] >= 1


# --------------------------------------------------------------------------- #
# cancel racing an in-flight launched step: tests/test_pipeline.py:222-352
# --------------------------------------------------------------------------- #

def _sync_ref(prompt, steps, **kw):
    """The uninterrupted tokens of ``prompt`` on the port's synchronous
    engine (greedy)."""
    eng = _port(pipeline=False, max_batch=2, max_seq_len=32, **kw)
    return eng.generate([prompt], max_tokens=steps)[0].token_ids


def test_cancel_queued_request_pipelined():
    p1, p2 = _prompts([8, 6], seed=5)
    engine = _port(num_blocks=4, max_batch=2, max_seq_len=16)
    ha = engine.submit(p1, max_tokens=4)
    hb = engine.submit(p2, max_tokens=4)
    engine.step()
    assert hb.status == "waiting"
    assert hb.cancel()
    evs = engine.step()          # queued cancels resolve at plan, same step
    assert [e.kind for e in evs if e.rid == hb.rid] == [EVENT_CANCEL]
    assert hb.result().token_ids == []
    _drain(engine)
    assert ha.result().finish_reason == "length"
    _assert_clean(engine)


def test_cancel_mid_chunked_prefill_pipelined():
    long_p, other = _prompts([20, 6], seed=9)
    ref = _sync_ref(other, 4)
    engine = _port(max_batch=4, max_seq_len=32, prefill_chunk=4,
                   min_prefill_bucket=4)
    h = engine.submit(long_p, max_tokens=4)
    ho = engine.submit(other, max_tokens=4)
    engine.step()
    engine.step()
    assert h.status == "prefilling"      # 20-token prompt, 4-token chunks
    assert h.cancel()
    events = []
    while not h.finished:
        events.extend(engine.step())
    assert any(e.kind == EVENT_CANCEL and e.rid == h.rid for e in events)
    assert h.result().finish_reason == "cancelled"
    engine.kv.check_invariants()
    _drain(engine)
    assert ho.result().token_ids == ref, "cancel perturbed another request"
    _assert_clean(engine)


def test_cancel_mid_decode_pipelined_keeps_launched_token():
    """The in-flight launched token commits BEFORE the deferred cancel: the
    stream never shortens against the synchronous engine, and the partial
    output is a prefix of the uninterrupted run."""
    prompt = _prompts([6], seed=11)[0]
    ref = _sync_ref(prompt, 8)
    engine = _port(max_batch=2, max_seq_len=32)
    h = engine.submit(prompt, max_tokens=8)
    for _ in range(3):
        engine.step()
    assert h.status == "running" and len(h.tokens) >= 1
    assert engine._inflight is not None
    n_before = len(h.tokens)
    assert h.cancel()
    evs = engine.step()
    out = h.result()
    assert any(e.kind == EVENT_CANCEL and e.rid == h.rid for e in evs)
    assert out.finish_reason == "cancelled"
    assert len(out.token_ids) == n_before + 1
    assert out.token_ids == ref[:len(out.token_ids)]
    _assert_clean(engine)


def test_cancel_mid_spec_pipelined():
    prompts = _prompts([6, 9], seed=13)
    refs = [_sync_ref(p, 16) for p in prompts]
    engine = _port(max_batch=2, max_seq_len=32,
                   spec=dict(k=3, draft_backend="tile_skip"))
    # a spec step commits up to k+1 tokens: budget large enough that the
    # deferred cancel lands before the length cap does
    ha = engine.submit(prompts[0], max_tokens=16)
    hb = engine.submit(prompts[1], max_tokens=16)
    for _ in range(3):
        engine.step()
    assert ha.spec_drafted > 0
    assert ha.cancel()
    events = []
    while not ha.finished:
        events.extend(engine.step())
    assert any(e.kind == EVENT_CANCEL and e.rid == ha.rid for e in events)
    assert ha.result().finish_reason == "cancelled"
    assert ha.result().token_ids == refs[0][:len(ha.result().token_ids)]
    engine.kv.check_invariants()
    _drain(engine)
    assert hb.result().token_ids == refs[1]
    _assert_clean(engine)


def test_cancel_inflight_never_touches_launched_tables():
    """``cancel()`` landing while a launched step is in flight must not
    mutate any launched block table (or free its blocks) before collect
    commits the launched token: a plan-phase free would hand the in-flight
    decode's pages to the next admission."""
    prompts = _prompts([6, 7], seed=19)
    engine = _port(max_batch=2, max_seq_len=32)
    ha = engine.submit(prompts[0], max_tokens=8)
    hb = engine.submit(prompts[1], max_tokens=8)
    for _ in range(3):
        engine.step()
    assert engine._inflight is not None
    rids = [r.rid for r in engine.running]
    assert ha.rid in rids and hb.rid in rids
    fingerprint = sequence_hash([engine.kv.block_table(r) for r in rids])
    free_before = engine.kv.num_free
    assert ha.cancel()
    # the cancel flag alone must not move the pool
    assert sequence_hash([engine.kv.block_table(r) for r in rids]) \
        == fingerprint
    assert engine.kv.num_free == free_before
    evs = engine.step()
    assert any(e.kind == EVENT_CANCEL and e.rid == ha.rid for e in evs)
    engine.kv.check_invariants()
    _drain(engine)
    assert hb.result().finish_reason == "length"
    _assert_clean(engine)


# --------------------------------------------------------------------------- #
# drain semantics: tests/test_pipeline.py:358-397
# --------------------------------------------------------------------------- #

def test_flush_drains_inflight():
    prompt = _prompts([6], seed=29)[0]
    engine = _port(max_batch=2, max_seq_len=32)
    assert engine.flush() == []          # nothing in flight: no-op
    h = engine.submit(prompt, max_tokens=6)
    engine.step()
    engine.step()
    assert engine._inflight is not None
    n = len(h.tokens)
    events = engine.flush()
    assert engine._inflight is None
    assert len(h.tokens) == n + 1, "flush did not commit the launched token"
    assert events, "flush returned no events for the committed token"
    _drain(engine)
    assert h.result().finish_reason == "length"
    _assert_clean(engine)


def test_has_unfinished_counts_inflight_tail():
    """Drain loops end only after the in-flight tail commits: the last
    launched token is never dropped."""
    prompt = _prompts([5], seed=31)[0]
    ref = _sync_ref(prompt, 4)
    engine = _port(max_batch=2, max_seq_len=16)
    h = engine.submit(prompt, max_tokens=4)
    steps = 0
    while engine.has_unfinished():
        engine.step()
        steps += 1
        assert steps < 50
    assert h.result().token_ids == ref
    _assert_clean(engine)


# --------------------------------------------------------------------------- #
# warmup: every program made up front, the JAX engine's grid
# --------------------------------------------------------------------------- #

def test_warmup_zero_steady_state_programs():
    engine = _port(max_batch=2, max_seq_len=32, prefill_chunk=8,
                   min_prefill_bucket=4, warmup=True)
    assert engine.warmup_seconds > 0
    assert engine.warmup_report, "warmup made nothing"
    made = dict(engine.programs.made)
    # warmup's programs are themselves counted: exactly one per report row
    assert sum(made.values()) == len(engine.warmup_report)
    engine.generate(_prompts([5, 9, 7], seed=37), max_tokens=6)
    engine.generate(_prompts([3, 11], seed=38), sampling=SamplingParams(
        temperature=0.8, seed=5), max_tokens=4)
    assert dict(engine.programs.made) == made, \
        "steady-state serving made a program after warmup"
    _assert_clean(engine)


def test_warmup_report_rows_equal_jax():
    """The same (entry, shape) rows in the same order as the JAX engine's
    warmup for the same settings, speculation on."""
    kw = dict(max_batch=2, max_seq_len=8, prefill_chunk=8,
              min_prefill_bucket=4,
              spec=dict(k=2, draft_backend="tile_skip"))
    je = _jax(**kw)
    te = _port(**kw)
    want = [(r["entry"], tuple(r["shape"])) for r in je.warmup()]
    got = [(r["entry"], tuple(r["shape"])) for r in te.warmup()]
    assert got == want
    assert {e for e, _ in got} == {"decode", "prefill", "draft", "verify"}
    assert sum(te.programs.made.values()) == len(got)


def test_dropped_engine_is_freed_by_refcount():
    """An engine's programs close over its weights and pools, never over
    the engine: dropping the last reference frees it (pools, programs and,
    on the card, the graphs' memory) at once, without the garbage
    collector."""
    import gc
    import weakref
    engine = _port(max_batch=2, max_seq_len=16, prefill_chunk=8,
                   min_prefill_bucket=4, warmup=True,
                   spec=dict(k=2, draft_backend="tile_skip"))
    engine.generate(_prompts([5, 3], seed=41), max_tokens=4)
    assert all(engine.programs.made.values())
    ref = weakref.ref(engine)
    gc.disable()
    try:
        del engine
        assert ref() is None, "a reference cycle keeps the engine alive"
    finally:
        gc.enable()


# --------------------------------------------------------------------------- #
# what the card's graphs rest on, checked on the CPU
# --------------------------------------------------------------------------- #

def test_overflow_log_reset_keeps_and_zeroes_its_tensor():
    """A graph keeps writing into the flag it captured, so ``reset()``
    zeroes the flag in place and never replaces it."""
    for log, args in ((ops.OverflowLog, ()),
                      (ops.HybridOverflowLog,
                       (torch.tensor([True, False, False]),))):
        log.record(torch.tensor(True), *args)
        flag = log._flags[torch.device("cpu")]
        assert log.seen()
        log.reset()
        assert not log.seen()
        assert log._flags[torch.device("cpu")] is flag and not bool(flag)
        log.record(torch.tensor(False), *args)
        assert not log.seen()
        log.record(torch.tensor(True), *args)
        assert log.seen() and log._flags[torch.device("cpu")] is flag
        log.reset()
    rows = ops.HybridOverflowLog._rows[torch.device("cpu")]
    ops.HybridOverflowLog.record(torch.tensor(False),
                                 torch.tensor([True, False, False]))
    assert ops.HybridOverflowLog.rows() == (2, 1)
    ops.HybridOverflowLog.reset()
    assert ops.HybridOverflowLog._rows[torch.device("cpu")] is rows
    assert ops.HybridOverflowLog.rows() == (0, 0)


def test_replay_launch_accounting():
    """A capture's host-side counts are taken back out and added once per
    replay; counts outside the capture stand."""
    build.reset_launches()
    build.count_launch("twell_fused_ffn")
    with build.captured_launches() as captured:
        build.count_launch("twell_gate_matmul")
        build.count_launch("twell_gate_matmul")
        build.count_launch("paged_decode_attention")
    assert captured == {"twell_gate_matmul": 2, "paged_decode_attention": 1}
    assert ops.launch_counts()["twell_gate_matmul"] == 0
    assert ops.launch_counts()["twell_fused_ffn"] == 1
    for replays in (1, 2, 3):
        build.add_launches(captured)
        counts = ops.launch_counts()
        assert counts["twell_gate_matmul"] == 2 * replays
        assert counts["paged_decode_attention"] == replays
        assert counts["twell_fused_ffn"] == 1
    with pytest.raises(RuntimeError):
        with build.captured_launches() as failed:
            build.count_launch("tile_skip_ffn")
            raise RuntimeError("capture failed")
    assert failed == {"tile_skip_ffn": 1}
    assert ops.launch_counts()["tile_skip_ffn"] == 0
    build.reset_launches()


def _uniform_before(key, shape, minval, maxval):
    """``sampling.uniform`` as it was written before its bounds became
    Python scalars (tensors made from host numbers)."""
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    f = tsampling._bits_to_unit(tsampling.random_bits(key, shape))
    return torch.maximum(lo, f * (hi - lo) + lo)


@pytest.mark.parametrize("seed", range(4))
def test_uniform_and_categorical_bits_unchanged(seed):
    rng = np.random.RandomState(seed)
    keys = tsampling.fold_in(tsampling.PRNGKey(seed),
                             torch.arange(8, dtype=torch.int64))
    for shape, lo, hi in (((257,), 0.0, 1.0),
                          ((3, 64), float(np.finfo(np.float32).tiny), 1.0),
                          ((999,), -2.5, 0.7)):
        for key in keys:
            got = tsampling.uniform(key, shape, lo, hi)
            want = _uniform_before(key, shape, lo, hi)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    logits = torch.from_numpy(rng.randn(8, 256).astype(np.float32))
    want = torch.argmax(-tsampling.log(-tsampling.log(_uniform_before(
        keys, (256,), float(np.finfo(np.float32).tiny), 1.0))) + logits,
        dim=-1)
    assert torch.equal(tsampling.categorical(keys, logits), want)
