"""The PyTorch port's ServingEngine against repro.serving.ServingEngine:
greedy and seeded stochastic tokens identical on the same weights
(bridged) and the same workloads as the JAX package's engine tests, and
the paged KV-cache pool invariants of tests/test_serving.py and
tests/test_prefix_cache.py on the port's pool. Everything runs on the CPU: the port on its plain versions,
JAX on its references.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as JaxModelConfig
from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.serving import ServingEngine as JaxEngine
from repro.serving import finished_outputs as jax_finished
from repro_torch import bridge
from repro_torch.config import ModelConfig
from repro_torch.configs import get_config
from repro_torch.serving import (PagedKVCache, SamplingParams, ServingEngine,
                                 finished_outputs)

BS = 4


def _cfgs(ffn_impl="dense", twell_c=1):
    """(JAX config, port config): reduced paper-0.5b, tests/test_serving.py:19"""
    out = []
    for base in (jax_get_config("paper-0.5b"), get_config("paper-0.5b")):
        c = base.reduced()
        out.append(dataclasses.replace(c, sparsity=dataclasses.replace(
            c.sparsity, ffn_impl=ffn_impl, twell_c=twell_c)))
    return out


def _tiny_cfgs():
    """The GQA config of tests/test_paged_attention.py:204-208."""
    kw = dict(name="t", family="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
              head_dim=16, dtype="float32", param_dtype="float32",
              remat="none", vocab_pad_multiple=8)
    return JaxModelConfig(**kw), ModelConfig(**kw)


_MODELS = {}


def _model(kind="paper"):
    if kind not in _MODELS:
        jcfg, tcfg = _cfgs() if kind == "paper" else _tiny_cfgs()
        jp = jlm.init(jax.random.PRNGKey(0), jcfg)
        _MODELS[kind] = (jp, jcfg, tcfg,
                         bridge.from_numpy(jax.tree_util.tree_map(np.asarray,
                                                                  jp)))
    return _MODELS[kind]


def _engines(kind="paper", backend="dense", **kw):
    """A JAX engine and a port engine on the same weights and settings."""
    jp, jcfg, tcfg, tp = _model(kind)
    if backend == "gather":
        jcfg, tcfg = [dataclasses.replace(c, sparsity=dataclasses.replace(
            c.sparsity, twell_c=1)) for c in (jcfg, tcfg)]
    kw.setdefault("block_size", BS)
    return (JaxEngine(jp, jcfg, backend=backend, **kw),
            ServingEngine(tp, tcfg, backend=backend, device="cpu", **kw))


def _prompts(vocab, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).tolist() for n in lens]


def _drain(engine, finished):
    outs = {}
    while engine.has_unfinished():
        for o in finished(engine.step()):
            outs[o.rid] = o
    return outs


@pytest.mark.parametrize("backend", ["dense", "gather"])
def test_static_workload_tokens_identical(backend):
    """tests/test_serving.py:131 workload. An untrained model's argmax is
    degenerate, so the per-step logits are compared too (float32 2e-4, as
    tests/test_kernels.py)."""
    je, te = _engines(backend=backend, max_batch=4, max_seq_len=32,
                      record_logits=True)
    prompts = _prompts(256, [5, 9, 7])
    want = je.generate(prompts, max_tokens=6)
    outs = te.generate(prompts, max_tokens=6)
    assert [o.token_ids for o in outs] == [o.token_ids for o in want]
    for o, w in zip(outs, want):
        assert len(o.logits) == len(w.logits) == 6
        for got, ref in zip(o.logits, w.logits):
            np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    assert all(o.finish_reason == "length" for o in outs)
    te.kv.check_invariants()
    assert te.kv.num_available == te.kv.num_blocks - 1


@pytest.mark.parametrize("backend", ["dense", "gather"])
def test_staggered_arrival_tokens_and_batches_identical(backend):
    """tests/test_serving.py:182 workload: joins mid-flight."""
    results = []
    for eng, fin in zip(_engines(backend=backend, max_batch=4,
                                 max_seq_len=32),
                        (jax_finished, finished_outputs)):
        prompts = _prompts(256, [5, 8, 6, 11], seed=3)
        outs = {}
        for p in prompts[:2]:
            eng.add_request(p, max_tokens=5)
        for _ in range(2):
            for o in fin(eng.step()):
                outs[o.rid] = o
        for p in prompts[2:]:
            eng.add_request(p, max_tokens=5)
        outs.update(_drain(eng, fin))
        results.append(([outs[r].token_ids for r in range(4)],
                        [(s.decode_batch, s.prefills) for s in eng.stats]))
    assert results[1] == results[0]
    assert len({b for b, _ in results[1][1]}) > 1


def test_prefix_hit_tokens_and_accounting_identical():
    """tests/test_prefix_cache.py:164 workload: re-served prompts."""
    res = []
    for eng in _engines(max_batch=2, max_seq_len=32):
        prompts = _prompts(256, [8, 11], seed=3)
        first = [o.token_ids for o in eng.generate(prompts, max_tokens=5)]
        second = eng.generate(prompts, max_tokens=5)
        res.append((first, [o.token_ids for o in second],
                    [o.cached_prefix_tokens for o in second],
                    eng.prefill_tokens_total, eng.cached_tokens_total))
    assert res[1] == res[0]
    assert res[1][2] == [7, 8]


def test_cow_on_divergent_suffixes_identical():
    """tests/test_prefix_cache.py:208 workload: copy-on-write."""
    res = []
    for eng, fin in zip(_engines(max_batch=2, max_seq_len=32),
                        (jax_finished, finished_outputs)):
        prompt = _prompts(256, [8], seed=9)[0]
        warm = eng.generate([prompt], max_tokens=6)[0].token_ids
        eng.add_request(prompt, max_tokens=6)
        eng.add_request(prompt, max_tokens=6)
        outs = _drain(eng, fin)
        res.append((warm, [outs[r].token_ids for r in sorted(outs)],
                    eng.kv.cow_count))
    assert res[1] == res[0]
    assert res[1][2] >= 1
    assert all(t == res[1][0] for t in res[1][1])


def test_chunked_prefill_staggered_identical():
    """tests/test_prefix_cache.py:300 workload: 4-token chunks."""
    res = []
    for eng, fin in zip(_engines(max_batch=4, max_seq_len=32,
                                 prefill_chunk=4, min_prefill_bucket=4),
                        (jax_finished, finished_outputs)):
        prompts = _prompts(256, [11, 20, 7], seed=17)
        outs = {}
        eng.add_request(prompts[0], max_tokens=5)
        for _ in range(2):
            for o in fin(eng.step()):
                outs[o.rid] = o
        for p in prompts[1:]:
            eng.add_request(p, max_tokens=5)
        outs.update(_drain(eng, fin))
        res.append(([outs[r].token_ids for r in range(3)],
                    [s.prefill_tokens for s in eng.stats]))
    assert res[1] == res[0]
    assert sum(1 for t in res[1][1] if t) >= 5


def test_preempt_resume_identical_gqa():
    """tests/test_paged_attention.py:278 workload on the GQA config."""
    rng = np.random.RandomState(21)
    prompts = [rng.randint(1, 250, size=n).tolist() for n in (8, 8)]
    res = []
    for eng in _engines("tiny", num_blocks=6, max_batch=2, max_seq_len=16,
                        prefill_chunk=16, min_prefill_bucket=4,
                        scheduler="priority"):
        lo = eng.submit(prompts[0], max_tokens=6, priority=0)
        for _ in range(4):
            eng.step()
        hi = eng.submit(prompts[1], max_tokens=4, priority=1)
        while eng.has_unfinished():
            eng.step()
        res.append((lo.result().token_ids, hi.result().token_ids,
                    lo.result().num_preemptions))
    assert res[1] == res[0]
    assert res[1][2] >= 1, "preemption never happened"


# --------------------------------------------------------------------------- #
# seeded stochastic sampling: tests/test_serving.py:312 and
# tests/test_handle_api.py:371, 449, 473, port vs JAX token for token
# --------------------------------------------------------------------------- #

def _jax_sp(**kw):
    from repro.serving import SamplingParams as JaxSampling
    return JaxSampling(**kw)


def _each_engine(**kw):
    """(engine, SamplingParams class) for the JAX engine, then the port's."""
    return zip(_engines(**kw), (_jax_sp, SamplingParams))


def test_engine_stochastic_reproducible_and_batch_independent():
    prompts = _prompts(256, [6, 9], seed=13)
    sp = dict(temperature=1.0, top_k=16, seed=42)
    res = []
    for eseed, batch in ((1, prompts[:1]), (2, prompts)):
        outs = [[o.token_ids for o in eng.generate(batch, sampling=cls(**sp),
                                                   max_tokens=6)]
                for eng, cls in _each_engine(max_batch=2, max_seq_len=32,
                                             seed=eseed)]
        assert outs[1] == outs[0]
        res.append(outs[1][0])
    assert res[0] == res[1]


def test_preempt_resume_seeded_stochastic_identical():
    lo_p, hi_p = _prompts(256, [8, 8], seed=23)
    sp = dict(temperature=0.9, top_k=32, seed=77)
    res = []
    for eng, cls in _each_engine(num_blocks=5, max_batch=2, max_seq_len=16,
                                 seed=6, scheduler="priority"):
        lo = eng.submit(lo_p, sampling=cls(**sp), max_tokens=6, priority=0)
        for _ in range(3):
            eng.step()
        hi = eng.submit(hi_p, sampling=cls(**sp), max_tokens=4, priority=1)
        while eng.has_unfinished():
            eng.step()
        res.append((lo.result().token_ids, hi.result().token_ids,
                    lo.result().num_preemptions))
    assert res[1] == res[0]
    assert res[1][2] >= 1, "preemption never happened"
    eng.kv.check_invariants()
    _, te = _engines(max_batch=2, max_seq_len=16, seed=5)
    solo = te.generate([lo_p], sampling=SamplingParams(**sp),
                       max_tokens=6)[0]
    assert solo.token_ids == res[1][0], "seeded preempt/resume diverged"


def test_seeded_requests_identical_across_arrival_order():
    target, filler = _prompts(256, [7, 9], seed=29)

    def run(order, engine_seed):
        res = []
        for eng, cls in _each_engine(max_batch=2, max_seq_len=32,
                                     seed=engine_seed):
            hs = {}
            for tag in order:
                if tag == "t":
                    hs["t"] = eng.submit(target, max_tokens=6, sampling=cls(
                        temperature=1.0, top_k=16, seed=123))
                else:
                    eng.submit(filler, max_tokens=6, sampling=cls(
                        temperature=0.8, seed=9))
            while eng.has_unfinished():
                eng.step()
            res.append(hs["t"].result().token_ids)
        assert res[1] == res[0]
        return res[1]

    assert run("tf", 1) == run("ft", 2) == run("t", 3)


def test_unseeded_identical_prompts_draw_independently():
    prompt = _prompts(256, [7], seed=31)[0]
    res = [[o.token_ids for o in eng.generate(
        [prompt, prompt], sampling=cls(temperature=1.0, top_p=0.9),
        max_tokens=8)]
        for eng, cls in _each_engine(max_batch=2, max_seq_len=32)]
    assert res[1] == res[0]
    assert res[1][0] != res[1][1], \
        "unseeded duplicates must not replay each other's draws"


# --------------------------------------------------------------------------- #
# paged KV-cache pool: tests/test_serving.py:47-80, test_prefix_cache.py:88-135
# --------------------------------------------------------------------------- #

def _pool(num_blocks):
    return PagedKVCache(_model()[2], num_blocks=num_blocks, block_size=BS,
                        device="cpu")


def test_pool_allocate_free_reuse():
    kv = _pool(8)
    assert kv.num_free == 7                       # block 0 reserved (null)
    a = kv.allocate(1, 3)
    b = kv.allocate(2, 2)
    assert 0 not in a + b and len(set(a + b)) == 5
    kv.check_invariants()
    with pytest.raises(MemoryError):
        kv.allocate(3, 3)
    with pytest.raises(ValueError):
        kv.allocate(1, 1)
    kv.free(1)
    c = kv.allocate(3, 5)
    assert set(a) <= set(c)
    kv.free(2)
    kv.free(3)
    assert kv.num_free == 7
    kv.check_invariants()


def test_pool_append_and_table_array():
    kv = _pool(6)
    kv.allocate(7, 1)
    kv.append_block(7)
    assert len(kv.block_table(7)) == 2
    assert (kv.blocks_for(1), kv.blocks_for(4), kv.blocks_for(5)) == (1, 1, 2)
    arr = kv.table_array([7], batch=3, width=4)
    assert arr.shape == (3, 4) and arr.dtype == np.int32
    assert list(arr[0, :2]) == kv.block_table(7)
    assert (arr[0, 2:] == 0).all() and (arr[1:] == 0).all()
    with pytest.raises(ValueError):
        kv.table_array([7], batch=1, width=1)


def test_pool_refcounts_shared_alloc_and_decref_to_lru():
    kv = _pool(10)
    prompt = list(range(8))
    kv.allocate(1, 2)
    kv.register_prefix(1, prompt)
    shared = kv.block_table(1)
    assert kv.allocate_prefix(2, prompt + [9, 9], 3) == 8
    assert kv.block_table(2)[:2] == shared
    assert kv.ref_count(shared[0]) == 2
    kv.free(1)
    assert kv.ref_count(shared[0]) == 1 and kv.num_evictable == 0
    kv.free(2)
    assert kv.num_evictable == 2 and kv.num_free == 7
    assert kv.allocate_prefix(3, prompt, 2) == 8
    assert kv.num_evictable == 0
    kv.free(3)
    kv.check_invariants()


def test_pool_lru_eviction_oldest_first_and_exhaustion():
    kv = _pool(5)
    a, b = [10] * BS, [20] * BS
    kv.allocate(1, 1); kv.register_prefix(1, a); kv.free(1)
    kv.allocate(2, 1); kv.register_prefix(2, b); kv.free(2)
    assert kv.num_free == 2 and kv.num_evictable == 2
    kv.allocate(3, 3)
    assert kv.evict_count == 1
    assert kv.match_prefix(a) == [] and kv.match_prefix(b) != []
    kv.check_invariants()
    with pytest.raises(MemoryError):
        kv.allocate(4, 2)
    kv.free(3)
    kv.check_invariants()


def test_pool_cow_copies_content_and_fixes_refcounts():
    kv = _pool(8)
    prompt = list(range(8))
    kv.allocate(1, 2)
    kv.register_prefix(1, prompt)
    shared = kv.block_table(1)[1]
    kv.pools["kpool"][:, shared] = 7.0
    kv.allocate_prefix(2, prompt, 2)
    new = kv.ensure_writable(2, 1)
    assert new is not None and new != shared and kv.cow_count == 1
    assert kv.ref_count(shared) == 1 and kv.ref_count(new) == 1
    assert kv.block_table(2)[1] == new and kv.block_table(1)[1] == shared
    for pool in kv.pools.values():
        assert torch.equal(pool[:, new], pool[:, shared])
    assert float(kv.pools["kpool"][:, new].min()) == 7.0
    assert kv.ensure_writable(2, 1) is None
    kv.free(1); kv.free(2)
    kv.check_invariants()
