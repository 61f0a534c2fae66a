"""The port's self-speculative decoding against the JAX package's, on the
same bridged weights and the workloads of tests/test_spec_decode.py: token
ids and per-request spec_drafted / spec_accepted identical, greedy and
seeded stochastic alike, and the paged pool's invariants after each case.
Everything runs on the CPU in float32: the port on its plain versions
(tile-skip drafts through K5's plain version), JAX on its references.
"""
import jax
import numpy as np
import pytest
import torch

from repro.serving import SamplingParams as JaxSampling
from repro.serving import ServingEngine as JaxEngine
from repro.serving import SpecConfig as JaxSpec
from repro.serving import finished_outputs as jax_finished
from repro.serving.request import Request as JaxRequest
from repro.serving.spec.verifier import Verifier as JaxVerifier
from repro_torch.models import lm
from repro_torch.serving import (PagedKVCache, SamplingParams, ServingEngine,
                                 SpecConfig, finished_outputs,
                                 make_draft_pair)
from repro_torch.serving import sampling as tsampling
from repro_torch.serving.request import Request
from repro_torch.serving.spec import Verifier
from test_torch_engine import BS, _model, _prompts


def _both(kind="paper", backend="dense", spec=None, **kw):
    """(JAX engine, port engine) on the same weights, speculating with the
    same SpecConfig."""
    jp, jcfg, tcfg, tp = _model(kind)
    kw.setdefault("block_size", BS)
    return (JaxEngine(jp, jcfg, backend=backend,
                      spec=None if spec is None else JaxSpec(**spec), **kw),
            ServingEngine(tp, tcfg, backend=backend, device="cpu",
                          spec=None if spec is None else SpecConfig(**spec),
                          **kw))


def _summary(outs):
    return {rid: (o.token_ids, o.finish_reason, o.spec_drafted,
                  o.spec_accepted) for rid, o in outs.items()}


def _check_pool(engine):
    engine.kv.check_invariants()
    assert engine.kv.num_available == engine.kv.num_blocks - 1


def _generate_both(prompts, spec, max_tokens, sampling=None, backend="dense",
                   **kw):
    """generate() on both engines; returns (jax outs, port outs, port
    engine) after checking the port's pool drained clean."""
    je, te = _both(backend=backend, spec=spec, **kw)
    jsp = None if sampling is None else JaxSampling(**sampling)
    tsp = None if sampling is None else SamplingParams(**sampling)
    want = je.generate(prompts, sampling=jsp, max_tokens=max_tokens)
    got = te.generate(prompts, sampling=tsp, max_tokens=max_tokens)
    _check_pool(te)
    return want, got, te


def _same(want, got):
    assert [(o.token_ids, o.finish_reason, o.spec_drafted, o.spec_accepted)
            for o in got] == \
        [(o.token_ids, o.finish_reason, o.spec_drafted, o.spec_accepted)
         for o in want]


# --------------------------------------------------------------------------- #
# rollback primitive: tests/test_spec_decode.py:51
# --------------------------------------------------------------------------- #

def test_kv_truncate_frees_tail_and_invalidates_table():
    kv = PagedKVCache(_model()[2], num_blocks=10, block_size=4, device="cpu")
    blocks = kv.allocate(1, 5)
    assert kv.truncate(1, 2) == 3
    assert kv.block_table(1) == blocks[:2]
    assert kv.num_free == 9 - 2
    kv.check_invariants()
    assert kv.truncate(1, 2) == 0
    assert list(kv.table_array([1], 1, 5)[0]) == blocks[:2] + [0, 0, 0]
    with pytest.raises(ValueError, match="keep_blocks"):
        kv.truncate(1, 0)
    kv.free(1)
    kv.check_invariants()


# --------------------------------------------------------------------------- #
# engine workloads: tests/test_spec_decode.py:73-251
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("k", [2, 4])
def test_spec_greedy_staggered_identical(k):
    """Staggered arrivals with a lossy tile-skip draft (threshold 0.3)."""
    spec = dict(k=k, draft_backend="tile_skip", draft_threshold=0.3)
    res = []
    for eng, fin in zip(_both(spec=spec, max_batch=4, max_seq_len=32),
                        (jax_finished, finished_outputs)):
        prompts = _prompts(256, [5, 8, 6, 11], seed=3)
        outs = {}
        for p in prompts[:2]:
            eng.add_request(p, max_tokens=7)
        for _ in range(2):
            for o in fin(eng.step()):
                outs[o.rid] = o
        for p in prompts[2:]:
            eng.add_request(p, max_tokens=7)
        while eng.has_unfinished():
            for o in fin(eng.step()):
                outs[o.rid] = o
        res.append((_summary(outs),
                    [(s.spec_batch, s.spec_drafted, s.spec_accepted)
                     for s in eng.stats]))
    assert res[1] == res[0]
    _check_pool(eng)
    assert sum(s.spec_drafted for s in eng.stats) > 0
    assert any(s.spec_accepted for s in eng.stats)


def test_spec_exact_draft_accepts_everything():
    want, got, te = _generate_both(_prompts(256, [5, 9, 7]),
                                   dict(k=3, draft_threshold=0.0), 6,
                                   max_batch=4, max_seq_len=32)
    _same(want, got)
    assert all(o.acceptance_rate == 1.0 and o.spec_drafted for o in got)
    assert len(te.stats) < sum(len(o.token_ids) for o in got)


def test_spec_with_gather_verifier():
    """TwELL gather verifies tile-skip drafts: the paper's pair."""
    want, got, _ = _generate_both(_prompts(256, [5, 9], seed=7),
                                  dict(k=2, draft_threshold=0.3), 6,
                                  backend="gather", max_batch=2,
                                  max_seq_len=32)
    _same(want, got)
    assert sum(o.spec_drafted for o in got) > 0


def test_spec_mixed_batch_with_no_spec_request():
    res = []
    for eng, fin in zip(_both(spec=dict(k=2), max_batch=2, max_seq_len=32),
                        (jax_finished, finished_outputs)):
        prompts = _prompts(256, [5, 9], seed=5)
        eng.add_request(prompts[0], max_tokens=6, no_spec=True)
        eng.add_request(prompts[1], max_tokens=6)
        outs = {}
        while eng.has_unfinished():
            for o in fin(eng.step()):
                outs[o.rid] = o
        res.append((_summary(outs),
                    [(s.decode_batch, s.spec_batch) for s in eng.stats]))
    assert res[1] == res[0]
    _check_pool(eng)
    assert res[1][0][0][2] == 0 and res[1][0][1][2] > 0
    assert any(d and s for d, s in res[1][1])


def test_spec_eos_mid_acceptance_discards_tail():
    """Seeded stochastic request: its free run, then the same run cut at
    an EOS that lands inside an accepted draft."""
    prompt = _prompts(256, [6], seed=5)[0]
    sp = dict(temperature=1.0, seed=7)
    free_want, free_got, _ = _generate_both([prompt], dict(k=4), 8,
                                            sampling=sp, max_batch=2,
                                            max_seq_len=32)
    _same(free_want, free_got)
    toks = free_got[0].token_ids
    assert len(toks) == 8
    eos = toks[2]
    res = []
    for eng, cls in zip(_both(spec=dict(k=4), max_batch=2, max_seq_len=32),
                        (JaxSampling, SamplingParams)):
        res.append(eng.generate([prompt], sampling=cls(**sp), max_tokens=8,
                                eos_token_id=eos)[0])
    _same(res[:1], res[1:])
    assert res[1].finish_reason == "eos"
    assert res[1].token_ids == toks[:toks.index(eos) + 1]
    _check_pool(eng)


def test_spec_respects_max_tokens_budget():
    want, got, _ = _generate_both(_prompts(256, [5, 6], seed=9), dict(k=6),
                                  3, max_batch=2, max_seq_len=32)
    _same(want, got)
    assert all(len(o.token_ids) == 3 for o in got)


def test_spec_pool_accounting_under_tight_pool():
    want, got, _ = _generate_both(_prompts(256, [8, 8], seed=9), dict(k=2),
                                  4, num_blocks=4, max_batch=2,
                                  max_seq_len=16)
    _same(want, got)


def test_spec_stochastic_reproducible_and_batch_independent():
    prompts = _prompts(256, [6, 9], seed=13)
    sp = dict(temperature=1.0, top_k=16, top_p=0.95, seed=42)
    res = []
    for eseed, batch in ((1, prompts[:1]), (2, prompts)):
        want, got, _ = _generate_both(batch, dict(k=2), 6, sampling=sp,
                                      max_batch=2, max_seq_len=32,
                                      seed=eseed)
        _same(want, got)
        res.append(got[0].token_ids)
    assert res[0] == res[1] and len(res[0]) == 6


def test_spec_config_validation():
    with pytest.raises(ValueError, match="k must be"):
        SpecConfig(k=0).validate()
    with pytest.raises(ValueError, match="draft_threshold"):
        SpecConfig(draft_threshold=-1.0).validate()
    pair = make_draft_pair("dense", "tile_skip", 0.25)
    assert pair.draft.threshold == 0.25
    assert "draft[" in pair.describe()
    with pytest.raises(ValueError, match="only applies to tile_skip"):
        make_draft_pair("dense", "gather", 0.25)


# --------------------------------------------------------------------------- #
# acceptance rule (unit): tests/test_spec_decode.py:262-309, port vs JAX
# --------------------------------------------------------------------------- #

def _accept_both(k, sampling, drafted, draft_logits, target_logits):
    jr = JaxRequest(rid=0, prompt=[1], max_tokens=8,
                    sampling=JaxSampling(**sampling))
    jr.base_key = jax.random.PRNGKey(0)
    tr = Request(rid=0, prompt=[1], max_tokens=8,
                 sampling=SamplingParams(**sampling))
    tr.base_key = tsampling.PRNGKey(0)
    want = JaxVerifier(None, k).accept(jr, k, drafted, draft_logits,
                                       target_logits)
    got = Verifier(None).accept(tr, k, drafted, draft_logits,
                                   target_logits)
    assert got == want
    return got


def test_accept_greedy_prefix_and_correction():
    tgt = np.zeros((4, 16), np.float32)
    tgt[0, 3] = tgt[1, 5] = tgt[2, 7] = tgt[3, 9] = 10.0
    assert _accept_both(3, {}, np.array([3, 6, 7]), None, tgt) == ([3, 5], 1)
    assert _accept_both(3, {}, np.array([3, 5, 7]), None, tgt) == \
        ([3, 5, 7, 9], 3)


def test_accept_stochastic_identical_dists_always_accepts():
    logits = np.random.RandomState(0).randn(5, 32).astype(np.float32)
    draft = logits[:4]
    drafted = np.array([int(np.argmax(r)) for r in draft])
    sp = dict(temperature=0.7, top_k=8, top_p=0.9, seed=0)
    emitted, n = _accept_both(4, sp, drafted, draft, logits)
    assert n == 4 and emitted[:4] == drafted.tolist()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_accept_stochastic_rejection_resamples_in_support(seed):
    """A draft token the target gives no mass is rejected; the resampled
    token (residual draw under the request's threefry key) is JAX's."""
    tgt = np.full((2, 16), -1e9, np.float32)
    tgt[0, 2] = tgt[0, 3] = 5.0
    dr = np.full((1, 16), -1e9, np.float32)
    dr[0, 5] = 5.0
    emitted, n = _accept_both(1, dict(temperature=1.0, seed=seed),
                              np.array([5]), dr, tgt)
    assert n == 0 and emitted[0] in (2, 3)


def test_draft_writes_past_budget_go_to_null_block():
    """write_valid=False rows of a draft step leave the pool untouched
    (models/layers.py's decode branch, as the JAX package's)."""
    _, te = _both(max_batch=2, max_seq_len=32)
    pools = lm.init_paged_cache(te.cfg, 4, 4, device="cpu")
    bt = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    sl = torch.tensor([1, 2], dtype=torch.int32)
    tok = torch.tensor([[5], [6]], dtype=torch.int32)
    lm.paged_decode_step(te.params, pools, bt, sl, tok, te.cfg_decode,
                         write_valid=torch.tensor([True, False]))
    k = pools["kpool"][0]
    assert k[1, 1].abs().sum() > 0            # row 0 wrote its position
    assert k[3].abs().sum() == 0              # row 1's page untouched
    assert k[0, 0].abs().sum() > 0            # ... its write hit the null
