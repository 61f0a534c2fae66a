"""The port's disaggregated serving (``repro_torch.serving.disagg``) against
the JAX package's, on the CPU, case for case with tests/test_disagg.py.

- ``PagedKVCache.hold`` pins and rejections, and the ``TransferBuffer``
  lifecycle and counters, equal to the JAX pool's and buffer's.
- The coordinator's tokens equal the port's unified engine's AND the JAX
  ``DisaggCoordinator``'s on the same bridged weights (greedy and seeded
  stochastic, dense and gather, with the decode engine speculating), with
  equal migrated-block counts, ``role_stats()`` and per-step event
  sequences (kind, rid, step, tokens): through the host-roundtrip
  transport, cancels at every stage, TTL expiry, decode-side prefix
  dedupe and the randomized churn schedule (``check_invariants`` on both
  pools after every step).
- The role-labelled ``/metrics`` series and the ``/v1/stats`` body
  (``roles`` section included) equal JAX's for the same run.
- ``EngineSpec`` build and replace; the coordinator refuses a pipelined
  spec, a mesh and a shared scheduler instance.

Reduced paper-0.5b in float32; both models are built once (the
``_model`` cache of tests/test_torch_engine.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.serving import DisaggCoordinator as JaxCoordinator
from repro.serving import EngineSpec as JaxSpec
from repro.serving import HostRoundtripTransport as JaxHostRoundtrip
from repro.serving import InProcessTransport as JaxInProcess
from repro.serving import PagedKVCache as JaxKV
from repro.serving import PriorityScheduler as JaxPriority
from repro.serving import SamplingParams as JaxSampling
from repro.serving import SpecConfig as JaxSpecConfig
from repro.serving import TransferBuffer as JaxBuffer
from repro.serving.server import ServingServer as JaxServer
from repro_torch.serving import (EVENT_CANCEL, DisaggCoordinator, EngineSpec,
                                 HostRoundtripTransport, InProcessTransport,
                                 PagedKVCache, PriorityScheduler,
                                 SamplingParams, ServingEngine, SpecConfig,
                                 TransferBuffer, finished_outputs)
from repro_torch.serving.disagg.coordinator import (STAGE_DECODE,
                                                    STAGE_PREFILL,
                                                    STAGE_TRANSFER)
from repro_torch.serving.server import ServingServer
from test_torch_engine import BS, _model


def _models(backend="dense"):
    """(JAX params, JAX cfg, port cfg, port params) of the reduced
    paper-0.5b, dense FFN; gather with twell_c = 1 as
    tests/test_torch_engine.py runs it."""
    jp, jcfg, tcfg, tp = _model()
    if backend == "gather":
        jcfg, tcfg = [dataclasses.replace(c, sparsity=dataclasses.replace(
            c.sparsity, twell_c=1)) for c in (jcfg, tcfg)]
    return jp, jcfg, tcfg, tp


def _prompts(lens, seed=0, vocab=256):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).tolist() for n in lens]


def _kw(**kw):
    """tests/test_disagg.py:_spec's settings."""
    base = dict(backend="dense", block_size=BS, max_batch=4, max_seq_len=48,
                prefill_chunk=8, scheduler="priority")
    base.update(kw)
    return base


def _port(coord_kw=None, **kw):
    """A port coordinator (``spec`` given as SpecConfig kwargs)."""
    kw = _kw(**kw)
    _, _, tcfg, tp = _models(kw["backend"])
    spec = kw.pop("spec", None)
    return DisaggCoordinator(tp, tcfg, spec=EngineSpec(
        spec=None if spec is None else SpecConfig(**spec), device="cpu",
        **kw), **(coord_kw or {}))


def _coords(coord_kw=None, **kw):
    """A JAX coordinator and a port coordinator on the same weights and
    settings."""
    jkw = _kw(**kw)
    jp, jcfg, _, _ = _models(jkw["backend"])
    spec = jkw.pop("spec", None)
    jc = JaxCoordinator(jp, jcfg, spec=JaxSpec(
        spec=None if spec is None else JaxSpecConfig(**spec), **jkw),
        **(coord_kw or {}))
    return jc, _port(coord_kw, **kw)


def _unified(**kw):
    kw = _kw(**kw)
    _, _, tcfg, tp = _models(kw["backend"])
    spec = kw.pop("spec", None)
    return EngineSpec(spec=None if spec is None else SpecConfig(**spec),
                      device="cpu", **kw).build(tp, tcfg)


def _drain(engine):
    """Every event until the engine is idle, as (step index, kind, rid,
    tokens) in commit order."""
    events = []
    i = 0
    while engine.has_unfinished():
        events.extend((i, e.kind, e.rid, tuple(e.tokens))
                      for e in engine.step())
        i += 1
    return events


def _assert_clean(coord):
    for name, kv in (("prefill", coord.prefill_engine.kv),
                     ("decode", coord.decode_engine.kv)):
        kv.check_invariants()
        assert kv.num_available == kv.num_blocks - 1, \
            f"{name} pool leaked blocks"
    assert coord.prefill_engine._reserved == 0
    assert coord.decode_engine._reserved == 0
    assert len(coord.buffer) == 0 and coord.buffer.blocks_pinned == 0


def _run(engine, prompts, max_tokens, sampling=None):
    """Submit all, drain; (token ids per request, the event sequence)."""
    hs = [engine.submit(p, max_tokens=max_tokens,
                        sampling=None if sampling is None else sampling(i))
          for i, p in enumerate(prompts)]
    events = _drain(engine)
    return [h.result().token_ids for h in hs], events


def _step_columns(coord):
    """The decode engine's per-step (decode batch, prefill tokens,
    migrated blocks, role): the disagg columns of StepStats."""
    return [(s.decode_batch, s.prefill_tokens, s.migrated_blocks, s.role)
            for s in coord.decode_engine.stats]


# --------------------------------------------------------------------------- #
# transfer buffer + hold() units
# --------------------------------------------------------------------------- #

def _pools(num_blocks):
    _, jcfg, tcfg, _ = _models()
    return JaxKV(jcfg, num_blocks=num_blocks, block_size=BS), \
        PagedKVCache(tcfg, num_blocks=num_blocks, block_size=BS,
                     device="cpu")


def test_hold_pins_blocks_across_free():
    seen = []
    for kv in _pools(10):
        kv.allocate(rid=7, n_blocks=3)
        blocks = kv.block_table(7)
        kv.hold(-8, blocks)
        kv.free(7)                   # request table gone, contents pinned
        kv.check_invariants()
        assert kv.num_available == 9 - 3
        assert all(kv.ref_count(b) == 1 for b in blocks)
        assert -8 in kv
        kv.free(-8)
        kv.check_invariants()
        assert kv.num_available == 9
        seen.append((blocks, kv.num_free, kv.num_evictable))
    assert seen[0] == seen[1]


def test_hold_revives_evictable_blocks():
    """A registered block parked in the LRU is revived by a hold (no
    longer evictable) and parks again on release, as in JAX."""
    seen = []
    for kv in _pools(8):
        toks = list(range(2 * BS))
        kv.allocate_prefix(1, toks, 2)
        kv.register_prefix(1, toks)
        blocks = kv.block_table(1)
        kv.free(1)
        assert kv.num_evictable == 2
        kv.hold(-2, blocks)
        kv.check_invariants()
        assert kv.num_evictable == 0
        kv.free(-2)
        kv.check_invariants()
        seen.append((kv.num_evictable, kv.match_prefix(toks)))
    assert seen[0] == seen[1] == (2, seen[0][1]) and len(seen[0][1]) == 2


def test_hold_rejects_null_free_and_duplicate_owner():
    _, kv = _pools(6)
    kv.allocate(rid=1, n_blocks=2)
    blocks = kv.block_table(1)
    with pytest.raises(ValueError, match="null block"):
        kv.hold(-2, [0])
    free_block = [b for b in range(1, 6) if b not in blocks][0]
    with pytest.raises(ValueError, match="free"):
        kv.hold(-2, [free_block])
    kv.hold(-2, blocks)
    with pytest.raises(ValueError, match="already holds"):
        kv.hold(-2, blocks)
    kv.free(-2)
    kv.free(1)
    kv.check_invariants()


def test_transfer_buffer_lifecycle_and_counters():
    books = []
    for kv, Buf in zip(_pools(16), (JaxBuffer, TransferBuffer)):
        buf = Buf(kv, max_entries=2, ttl_steps=3)
        for rid in (0, 1):
            kv.allocate(rid, 2)
            buf.publish(rid, kv.block_table(rid), cached_tokens=7, step=rid)
            kv.free(rid)
        assert len(buf) == 2 and buf.full and buf.blocks_pinned == 4
        assert 0 in buf and buf.get(1).cached_tokens == 7
        assert buf.get(1).hold_id == -2
        kv.allocate(5, 2)
        with pytest.raises(RuntimeError, match="full"):
            buf.publish(5, kv.block_table(5), cached_tokens=7, step=2)
        with pytest.raises(ValueError, match="already has"):
            buf.max_entries = 3
            buf.publish(0, kv.block_table(5), cached_tokens=7, step=2)
        buf.max_entries = 2
        kv.free(5)
        entry = buf.claim(0)
        assert entry.rid == 0 and len(buf) == 1
        assert buf.cancel(1) and not buf.cancel(1)
        kv.check_invariants()
        assert kv.num_available == 15
        # TTL: a fresh entry published at step 10 expires at step >= 13
        kv.allocate(9, 1)
        buf.publish(9, kv.block_table(9), cached_tokens=3, step=10)
        kv.free(9)
        assert buf.expire(now_step=12) == []
        dropped = buf.expire(now_step=13)
        assert [e.rid for e in dropped] == [9] and len(buf) == 0
        kv.check_invariants()
        assert kv.num_available == 15
        books.append((buf.published_total, buf.claimed_total,
                      buf.cancelled_total, buf.expired_total,
                      entry.blocks, dropped[0].blocks))
    assert books[0] == books[1]
    assert books[1][:4] == (3, 1, 1, 1)
    with pytest.raises(ValueError, match="max_entries"):
        TransferBuffer(_pools(4)[1], max_entries=0)
    with pytest.raises(ValueError, match="ttl_steps"):
        TransferBuffer(_pools(4)[1], ttl_steps=0)


def test_transports_copy_blocks_bitwise_in_place():
    """Both transports write the destination blocks with the source
    blocks' bits into the destination's existing pool tensors (never
    rebinding them: a captured CUDA graph holds their addresses), and
    touch no other block."""
    _, _, tcfg, _ = _models()
    src = PagedKVCache(tcfg, num_blocks=8, block_size=BS, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for pool in src.pools.values():
        pool.copy_(torch.randn(pool.shape, generator=gen))
    for transport in (InProcessTransport(), HostRoundtripTransport()):
        dst = PagedKVCache(tcfg, num_blocks=6, block_size=BS, device="cpu")
        ptrs = {n: p.data_ptr() for n, p in dst.pools.items()}
        before = {n: p.clone() for n, p in dst.pools.items()}
        transport.transfer(src, dst, [5, 2, 7], [1, 4, 3])
        for n, p in dst.pools.items():
            assert p.data_ptr() == ptrs[n]
            assert torch.equal(p[:, [1, 4, 3]], src.pools[n][:, [5, 2, 7]])
            assert torch.equal(p[:, [0, 2, 5]], before[n][:, [0, 2, 5]])
        transport.transfer(src, dst, [], [])
        with pytest.raises(ValueError, match="mismatch"):
            transport.transfer(src, dst, [1, 2], [1])


def test_host_roundtrip_bfloat16_bit_for_bit():
    """numpy has no bfloat16: the payload crosses as raw bytes with its
    dtype name and comes back bit for bit."""
    _, _, tcfg, _ = _models()
    cfg = dataclasses.replace(tcfg, param_dtype="bfloat16")
    src = PagedKVCache(cfg, num_blocks=5, block_size=BS, device="cpu")
    dst = PagedKVCache(cfg, num_blocks=5, block_size=BS, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for pool in src.pools.values():
        pool.copy_(torch.randn(pool.shape, generator=gen).to(pool.dtype))
    HostRoundtripTransport().transfer(src, dst, [1, 4], [3, 2])
    for n, p in dst.pools.items():
        assert p.dtype == torch.bfloat16
        assert torch.equal(p[:, [3, 2]].view(torch.int16),
                           src.pools[n][:, [1, 4]].view(torch.int16))


def test_transport_warmup_differs_from_jax_only_in_its_count():
    """The JAX transport compiles one gather/scatter per power-of-two
    block-count bucket up to max_blocks and reports that many shapes; the
    port's eager in-place copy has one form for every count, so its
    warmup runs it once (null block onto null block) and reports 1. The
    coordinator's transfer row is therefore (1, max_blocks) where JAX's
    is (buckets, max_blocks)."""
    jkv, tkv = _pools(6)
    jkv2, tkv2 = _pools(6)
    assert JaxInProcess().warmup(jkv, jkv2, 12) == 5      # 1, 2, 4, 8, 16
    assert InProcessTransport().warmup(tkv, tkv2, 12) == 1
    assert HostRoundtripTransport().warmup(tkv, tkv2, 12) == \
        JaxHostRoundtrip().warmup(jkv, jkv2, 12) == 0


def test_coordinator_warmup_then_makes_no_program():
    tc = _port(max_batch=2, max_seq_len=24)
    report = tc.warmup()
    made = tc.programs_made()
    assert {r["role"] for r in report} == {"prefill", "decode", "transfer"}
    tx = [r for r in report if r["role"] == "transfer"]
    assert len(tx) == 1 and tx[0]["shape"] == (1, 6)
    assert tc.warmup_seconds > 0 and tc.warmup_report is report
    want = _unified(max_batch=2, max_seq_len=24).generate(
        _prompts([6, 11]), max_tokens=5)
    outs = tc.generate(_prompts([6, 11]), max_tokens=5)
    assert [o.token_ids for o in outs] == [o.token_ids for o in want]
    assert tc.programs_made() == made
    _assert_clean(tc)


# --------------------------------------------------------------------------- #
# coordinator vs unified engine vs JAX coordinator: token identity
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("backend", ["dense", "gather"])
def test_disagg_greedy_identical_to_unified_and_jax(backend):
    prompts = _prompts([6, 11, 9, 14])
    unified, _ = _run(_unified(backend=backend), prompts, 8)
    jc, tc = _coords(backend=backend)
    jtoks, jevents = _run(jc, prompts, 8)
    ttoks, tevents = _run(tc, prompts, 8)
    assert ttoks == unified == jtoks
    assert tevents == jevents
    assert tc.decode_engine.prefill_tokens_total == 0
    assert tc.decode_engine.migrated_blocks_total == \
        jc.decode_engine.migrated_blocks_total > 0
    assert _step_columns(tc) == _step_columns(jc)
    _assert_clean(tc)
    rs = tc.role_stats()
    assert rs == jc.role_stats()
    assert rs["transfer"]["published_total"] == \
        rs["transfer"]["claimed_total"] == 4


@pytest.mark.parametrize("backend", ["dense", "gather"])
def test_disagg_decode_logits_equal_unified(backend):
    """An untrained model's argmax is degenerate, so tokens alone could
    hide a wrong migration: every decode step's logits on the migrated
    blocks equal the unified engine's (float32, 2e-4 as
    tests/test_torch_engine.py). The first token's logits are the
    prefill engine's clone's, not the canonical request's."""
    prompts = _prompts([6, 11, 9, 14], seed=8)
    want = _unified(backend=backend, record_logits=True).generate(
        prompts, max_tokens=8)
    tc = _port(backend=backend, record_logits=True)
    hs = [tc.submit(p, max_tokens=8) for p in prompts]
    for h in hs:
        tc._slots[h.rid].req.logits_trace = []
    _drain(tc)
    for h, w in zip(hs, want):
        got = h.result()
        assert got.token_ids == w.token_ids and len(got.logits) == 7
        for g, r in zip(got.logits, w.logits[1:]):
            np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-4)
    _assert_clean(tc)


@pytest.mark.parametrize("backend", ["dense", "gather"])
def test_disagg_stochastic_identical_to_unified_and_jax(backend):
    prompts = _prompts([7, 12, 9], seed=3)

    def sp(cls):
        return lambda i: cls(temperature=1.3, top_k=40, seed=100 + i)
    unified, _ = _run(_unified(backend=backend, max_batch=2), prompts, 6,
                      sp(SamplingParams))
    jc, tc = _coords(backend=backend, max_batch=2)
    jtoks, jevents = _run(jc, prompts, 6, sp(JaxSampling))
    ttoks, tevents = _run(tc, prompts, 6, sp(SamplingParams))
    assert ttoks == unified == jtoks
    assert tevents == jevents
    _assert_clean(tc)


def test_unseeded_stochastic_keys_are_the_unified_engines():
    """An unseeded request's base key is the master key folded by the
    coordinator rid, equal to the unified engine's for that rid and kept
    where the engine keeps its keys; the sampled tokens agree too (the
    unified engine's unseeded draws equal JAX's:
    tests/test_torch_engine.py)."""
    prompts = _prompts([7, 12, 9], seed=4)

    def sp(i):
        return SamplingParams(temperature=1.0, top_k=20)
    uni = _unified(max_batch=2)
    unified, _ = _run(uni, prompts, 5, sp)
    tc = _port(max_batch=2)
    ttoks, _ = _run(tc, prompts, 5, sp)
    assert ttoks == unified
    h = tc.submit(prompts[0], max_tokens=2)
    u = uni.submit(prompts[0], max_tokens=2)
    assert h.rid == u.rid == 3
    assert torch.equal(tc._slots[h.rid].req.base_key,
                       uni._requests[u.rid].base_key)
    assert tc._slots[h.rid].req.base_key.device == \
        uni._requests[u.rid].base_key.device


def test_disagg_speculating_decode_engine_identical():
    """The decode engine drafts k = 2 tile-skip tokens and verifies them
    on migrated blocks; tokens equal the unified speculating engine's and
    the JAX coordinator's, with equal acceptance."""
    prompts = _prompts([6, 11], seed=9)
    spec = dict(k=2, draft_backend="tile_skip")
    uni = _unified(spec=spec)
    unified, _ = _run(uni, prompts, 8)
    jc, tc = _coords(spec=spec)
    jtoks, jevents = _run(jc, prompts, 8)
    ttoks, tevents = _run(tc, prompts, 8)
    assert ttoks == unified == jtoks
    assert tevents == jevents
    drafted = sum(s.spec_drafted for s in tc.stats)
    assert drafted > 0
    assert [(s.spec_drafted, s.spec_accepted) for s in tc.stats] == \
        [(s.spec_drafted, s.spec_accepted) for s in jc.stats]
    assert tc.decode_engine.prefill_tokens_total == 0
    _assert_clean(tc)


def test_disagg_host_roundtrip_transport():
    """The host roundtrip against the in-process transport (whose runs
    equal JAX's coordinator's above) and the unified engine."""
    prompts = _prompts([10, 6], seed=5)
    unified, _ = _run(_unified(max_batch=2), prompts, 5)
    tc, inproc = [_port(dict(transport=t), max_batch=2)
                  for t in (HostRoundtripTransport(), InProcessTransport())]
    ttoks, tevents = _run(tc, prompts, 5)
    itoks, ievents = _run(inproc, prompts, 5)
    assert ttoks == itoks == unified
    assert tevents == ievents
    # the decode pools after the two transports' runs: bit for bit
    for n, p in tc.decode_engine.kv.pools.items():
        assert torch.equal(p[:, 1:], inproc.decode_engine.kv.pools[n][:, 1:])
    _assert_clean(tc)


# --------------------------------------------------------------------------- #
# cancellation at every migration stage
# --------------------------------------------------------------------------- #

def _cancel_queued_and_mid_prefill(coord):
    ha = coord.submit(_prompts([6])[0], max_tokens=4)
    hb = coord.submit(_prompts([20], seed=1)[0], max_tokens=4)
    assert coord.cancel(hb)              # still queued: prefill slot is busy
    events = [(0, e.kind, e.rid, tuple(e.tokens)) for e in coord.step()]
    assert hb.finished and hb.result().finish_reason == "cancelled"
    hc = coord.submit(_prompts([24], seed=2)[0], max_tokens=4)
    while coord._slots[hc.rid].stage != STAGE_PREFILL:
        events += [(-1, e.kind, e.rid, tuple(e.tokens)) for e in coord.step()]
    coord.cancel(hc)                     # mid-prefill: forwarded to engine
    events += _drain(coord)
    assert hc.result().finish_reason == "cancelled"
    assert ha.result().finish_reason == "length"
    return [h.result().token_ids for h in (ha, hb, hc)], events


def test_cancel_queued_and_mid_prefill():
    jc, tc = _coords(max_batch=1)
    assert _cancel_queued_and_mid_prefill(tc) == \
        _cancel_queued_and_mid_prefill(jc)
    _assert_clean(tc)


def _cancel_mid_transfer(coord):
    # fcfs never preempts, so with one decode slot occupied the second
    # request parks in the transfer buffer: cancel it there
    ha = coord.submit(_prompts([6])[0], max_tokens=12)
    while coord._slots[ha.rid].stage != STAGE_DECODE:
        coord.step()
    hb = coord.submit(_prompts([9], seed=1)[0], max_tokens=4)
    while coord._slots[hb.rid].stage != STAGE_TRANSFER:
        coord.step()
    assert len(coord.buffer) == 1
    coord.cancel(hb)
    evs = coord.step()
    assert any(e.kind == EVENT_CANCEL and e.rid == hb.rid for e in evs)
    assert hb.result().finish_reason == "cancelled"
    assert coord.buffer.cancelled_total == 1 and len(coord.buffer) == 0
    _drain(coord)
    assert ha.result().finish_reason == "length"
    return [h.result().token_ids for h in (ha, hb)], coord.role_stats()


def test_cancel_mid_transfer():
    jc, tc = _coords(max_batch=1, scheduler="fcfs")
    assert _cancel_mid_transfer(tc) == _cancel_mid_transfer(jc)
    _assert_clean(tc)


def _cancel_mid_decode(coord):
    h = coord.submit(_prompts([8])[0], max_tokens=16)
    while coord._slots[h.rid].stage != STAGE_DECODE:
        coord.step()
    coord.step()
    coord.cancel(h)
    _drain(coord)
    out = h.result()
    assert out.finish_reason == "cancelled" and len(out.token_ids) < 16
    return out.token_ids, coord.role_stats()


def test_cancel_mid_decode():
    jc, tc = _coords()
    assert _cancel_mid_decode(tc) == _cancel_mid_decode(jc)
    _assert_clean(tc)


# --------------------------------------------------------------------------- #
# TTL expiry -> re-queue -> re-prefill, still token-identical
# --------------------------------------------------------------------------- #

def test_ttl_expiry_requeues_and_preserves_tokens():
    kw = dict(max_batch=1, scheduler="fcfs", num_blocks=12, max_seq_len=32)
    prompts = _prompts([6, 9], seed=7)
    unified, _ = _run(_unified(**kw), prompts, 8)
    jc, tc = _coords(coord_kw=dict(transfer_ttl_steps=2), **kw)
    jtoks, jevents = _run(jc, prompts, 8)
    ttoks, tevents = _run(tc, prompts, 8)
    assert ttoks == unified == jtoks
    assert tevents == jevents
    # with one decode slot, the second request must sit in the buffer past
    # the 2-step TTL at least once -> expire -> re-prefill -> same tokens
    assert tc.buffer.expired_total >= 1
    assert tc.expired_total == tc.buffer.expired_total == \
        jc.buffer.expired_total
    assert tc.preempted_total == jc.preempted_total >= tc.expired_total
    _assert_clean(tc)


# --------------------------------------------------------------------------- #
# decode-side prefix-cache dedupe
# --------------------------------------------------------------------------- #

def _dedupe(coord):
    # 3 full prompt blocks + a 2-token tail block: the repeat dedupes the
    # full blocks against the warm decode prefix cache but must still
    # transfer the private tail block
    prompt = _prompts([3 * BS + 2], seed=11)[0]
    h1 = coord.submit(prompt, max_tokens=4)
    _drain(coord)
    h2 = coord.submit(prompt, max_tokens=4)
    _drain(coord)
    o1, o2 = h1.result(), h2.result()
    assert o1.token_ids == o2.token_ids
    assert 0 < o2.migrated_blocks < o1.migrated_blocks
    assert o2.cached_prefix_tokens > 0
    assert o1.role == o2.role == "decode"
    assert o1.transfer_wait_ms >= 0.0
    return [(o.token_ids, o.migrated_blocks, o.cached_prefix_tokens)
            for o in (o1, o2)]


def test_migration_dedupes_against_warm_decode_prefix_cache():
    jc, tc = _coords()
    assert _dedupe(tc) == _dedupe(jc)
    assert tc.cached_tokens_total == jc.cached_tokens_total
    assert tc.migrated_blocks_total == jc.migrated_blocks_total


# --------------------------------------------------------------------------- #
# randomized migration churn: invariants after every step
# --------------------------------------------------------------------------- #

def _churn(coord, vocab):
    rng = np.random.RandomState(42)
    handles, n_submitted, events, i = [], 0, [], 0
    while n_submitted < 10 or coord.has_unfinished():
        if n_submitted < 10 and rng.rand() < 0.5:
            p = rng.randint(0, vocab, rng.randint(4, 14)).tolist()
            handles.append(coord.submit(
                p, max_tokens=int(rng.randint(2, 8)),
                priority=int(rng.randint(0, 3))))
            n_submitted += 1
        if handles and rng.rand() < 0.15:
            coord.cancel(handles[rng.randint(len(handles))])
        events += [(i, e.kind, e.rid, tuple(e.tokens)) for e in coord.step()]
        i += 1
        for kv in (coord.prefill_engine.kv, coord.decode_engine.kv):
            kv.check_invariants()
    reasons = {h.result().finish_reason for h in handles}
    assert reasons <= {"length", "cancelled"}
    assert coord.finished_total + coord.cancelled_total == 10
    assert coord.decode_engine.prefill_tokens_total == 0
    return events, [h.result().token_ids for h in handles], \
        coord.role_stats(), coord.preempted_total


def test_randomized_churn_invariants_every_step():
    worst = -(-24 // BS) + 1
    jc, tc = _coords(coord_kw=dict(transfer_ttl_steps=3), max_batch=2,
                     max_seq_len=24, num_blocks=1 + 2 * worst)
    vocab = _models()[2].vocab_size
    got = _churn(tc, vocab)
    assert got == _churn(jc, vocab)
    _assert_clean(tc)


# --------------------------------------------------------------------------- #
# /metrics and /v1/stats with role labels, against JAX's
# --------------------------------------------------------------------------- #

def _series(text):
    """Prometheus text -> {series: value}, comments dropped."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, val = line.rsplit(" ", 1)
            out[key] = float(val)
    return out


# families whose values hang on wall time or float32 sums, not on the run's
# events (their series keys are still compared)
_TIMED = ("_seconds_bucket", "_seconds_sum", "serving_mfu",
          "serving_tokens_per_joule", "serving_effective_flops",
          "serving_dense_flops", "serving_ffn_sparsity",
          "serving_tile_occupancy_ratio_bucket",
          "serving_tile_occupancy_ratio_sum", "serving_warmup_seconds")


def test_metrics_and_stats_roles_equal_jax():
    jc, tc = _coords(telemetry=True, max_batch=2)
    prompts = _prompts([6, 11, 9], seed=2)
    for c in (jc, tc):
        hs = [c.submit(p, max_tokens=5) for p in prompts]
        c.step()
        c.cancel(hs[2])
        _drain(c)
    jt = _series(jc.telemetry.registry.render_prometheus())
    tt = _series(tc.telemetry.registry.render_prometheus())
    # the port's paged-KV read path is "plain" on the CPU (JAX: its
    # attn_backend, "ref")
    info = {k for k in tt if k.startswith("serving_build_info")}
    assert info == {k.replace('attn_backend="ref"', 'attn_backend="plain"')
                    for k in jt if k.startswith("serving_build_info")}
    assert set(tt) - info == {k for k in jt
                              if not k.startswith("serving_build_info")}
    for k, v in jt.items():
        if not k.startswith("serving_build_info") and \
                not any(s in k for s in _TIMED):
            assert tt[k] == v, k
    for role in ("prefill", "decode"):
        assert f'serving_requests_total{{outcome="finished",role="{role}"}}' \
            in tt
    assert tt['serving_kv_migrated_blocks_total{role="decode"}'] > 0
    jsrv, tsrv = JaxServer(jc, port=0), ServingServer(tc, port=0)
    try:
        js, ts = jsrv.stats(), tsrv.stats()
    finally:
        jsrv.httpd.server_close()
        tsrv.httpd.server_close()
    assert ts["roles"] == js["roles"]
    assert {k: v for k, v in ts.items() if k not in ("telemetry",
                                                     "sparsity")} == \
        {k: v for k, v in js.items() if k not in ("telemetry", "sparsity")}
    assert set(ts["telemetry"]["ttft_s"]) == set(js["telemetry"]["ttft_s"])
    assert set(ts["telemetry"]["ttft_s"]) >= {"0@decode"}


# --------------------------------------------------------------------------- #
# EngineSpec; what the coordinator refuses
# --------------------------------------------------------------------------- #

def test_engine_spec_build_and_replace():
    _, _, tcfg, tp = _models()
    spec = EngineSpec(**_kw(max_batch=3), device="cpu")
    engine = spec.build(tp, tcfg)
    assert isinstance(engine, ServingEngine)
    assert engine.max_batch == 3 and engine.role == "unified"
    assert spec.replace(role="prefill").role == "prefill"
    assert spec.role == "unified"                     # frozen: no mutation
    h = engine.submit(_prompts([5])[0], max_tokens=3)
    outs = [o for ev in engine.step() for o in finished_outputs([ev])]
    while engine.has_unfinished():
        outs += finished_outputs(engine.step())
    assert outs and h.result().token_ids == outs[0].token_ids


def test_coordinator_rejects_pipeline_mesh_and_scheduler_instance():
    jp, jcfg, tcfg, tp = _models()
    for Coord, Spec, Prio, params, cfg, extra in (
            (JaxCoordinator, JaxSpec, JaxPriority, jp, jcfg, {}),
            (DisaggCoordinator, EngineSpec, PriorityScheduler, tp, tcfg,
             {"device": "cpu"})):
        with pytest.raises(NotImplementedError, match="pipeline"):
            Coord(params, cfg, spec=Spec(**_kw(pipeline=True), **extra))
        with pytest.raises(ValueError, match="policy name"):
            Coord(params, cfg, spec=Spec(**_kw(scheduler=Prio()), **extra))
    # a spec that carries a mesh (EngineSpec.mesh, tensor-parallel
    # serving) is refused with JAX's error, on both sides
    for Coord, Spec, params, cfg, extra in (
            (JaxCoordinator, JaxSpec, jp, jcfg, {}),
            (DisaggCoordinator, EngineSpec, tp, tcfg, {"device": "cpu"})):
        with pytest.raises(NotImplementedError, match="unsharded"):
            Coord(params, cfg, spec=Spec(**_kw(), mesh=object(), **extra))


def test_engine_resume_interface():
    """submit(outputs=, base_key=) admits like a preempt-resume under the
    given key; admit_migrated refuses a live rid; withdraw hands a running
    request back; StepStats carries the migrated blocks and the role."""
    engine = _unified()
    with pytest.raises(ValueError, match="must exceed"):
        engine.submit([1, 2, 3], max_tokens=2, outputs=[4, 5])
    ref = _unified().generate([[1, 2, 3]], max_tokens=6)[0].token_ids
    key = engine._master_key
    h = engine.submit([1, 2, 3], max_tokens=6, outputs=ref[:2],
                      base_key=key)
    assert engine._requests[h.rid].base_key is key
    while engine.has_unfinished():
        engine.step()
    assert h.result().token_ids == ref
    h2 = engine.submit([1, 2, 3], max_tokens=6)
    engine.step()
    req = engine._requests[h2.rid]
    assert engine.withdraw(h2.rid + 7) is None
    with pytest.raises(ValueError, match="already live"):
        engine.admit_migrated(req, lambda fresh, skip: None)
    got = engine.withdraw(h2.rid)
    assert got is req and got.num_preemptions == 1
    assert engine.preempted_total == 1 and not engine.running
    engine.kv.check_invariants()
    assert engine.kv.num_available == engine.kv.num_blocks - 1
    assert {(s.migrated_blocks, s.role) for s in engine.stats} == \
        {(0, "unified")}
