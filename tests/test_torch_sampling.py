"""The port's threefry sampler against jax.random and repro.serving.sampling:
keys and random bits bit-identical, uniform and Gumbel draws bit-identical,
filter_logits equal in float32, sampled tokens identical on seeded numpy
logits, and the sampling-support tests of tests/test_serving.py:263-345.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import sampling as jsampling
from repro_torch.serving import SamplingParams
from repro_torch.serving import sampling

SEEDS = [0, 1, 7, 42, 12345, -3, 2 ** 31 - 1]


def _np(key):
    return np.asarray(key).astype(np.int64)


def _keys(n, seed=0):
    """n distinct (jax, port) key pairs."""
    j = jax.random.split(jax.random.PRNGKey(seed), n)
    return j, torch.from_numpy(_np(j))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_bit_identical(seed):
    jk, tk = jax.random.PRNGKey(seed), sampling.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    for d in (0, 1, 5, 2 ** 31, 2 ** 32 - 1, 0x53504543):
        np.testing.assert_array_equal(sampling.fold_in(tk, d).numpy(),
                                      _np(jax.random.fold_in(jk, d)))


def test_batch_and_spec_keys_bit_identical():
    base_j, base_t = _keys(6, seed=3)
    pos = np.array([0, 1, 7, 100, 2 ** 20, 5], np.int32)
    np.testing.assert_array_equal(
        sampling.batch_keys(base_t, torch.from_numpy(pos)).numpy(),
        _np(jsampling.batch_keys(base_j, jnp.asarray(pos))))
    for stream in (sampling.STREAM_DRAFT, sampling.STREAM_ACCEPT,
                   sampling.STREAM_RESAMPLE):
        np.testing.assert_array_equal(
            sampling.spec_batch_keys(base_t, torch.from_numpy(pos),
                                     stream).numpy(),
            _np(jsampling.spec_batch_keys(base_j, jnp.asarray(pos), stream)))
        np.testing.assert_array_equal(
            sampling.spec_key(base_t[2], 9, stream).numpy(),
            _np(jsampling.spec_key(base_j[2], 9, stream)))
    master_j, master_t = jax.random.PRNGKey(11), sampling.PRNGKey(11)
    for rid, seed in ((0, None), (5, None), (3, 99)):
        np.testing.assert_array_equal(
            sampling.request_base_key(master_t, rid, seed).numpy(),
            _np(jsampling.request_base_key(master_j, rid, seed)))
        np.testing.assert_array_equal(
            sampling.request_key(master_t, rid).numpy(),
            _np(jsampling.request_key(master_j, rid)))


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5), (49152,)])
def test_random_bits_uniform_gumbel_bit_identical(shape):
    jk, tk = jax.random.PRNGKey(42), sampling.PRNGKey(42)
    np.testing.assert_array_equal(sampling.random_bits(tk, shape).numpy(),
                                  _np(jax.random.bits(jk, shape)))
    np.testing.assert_array_equal(sampling.uniform(tk, shape).numpy(),
                                  np.asarray(jax.random.uniform(jk, shape)))
    np.testing.assert_array_equal(sampling.gumbel(tk, shape).numpy(),
                                  np.asarray(jax.random.gumbel(jk, shape)))


def test_log_is_xlas_float32_log():
    """Every float32 class: normal, denormal (flushed to zero), zero,
    negative, infinity, and a dense sweep of (0, 100)."""
    x = np.random.RandomState(0).uniform(0, 100, 200_000).astype(np.float32)
    x[:8] = [0.0, 1e-39, -1e-39, 1e-38, 1.2e-38, -1.0, np.inf, 1.0]
    want = np.asarray(jnp.log(jnp.asarray(x)))
    got = sampling.log(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def _filter_args(seed, b=6, v=1000):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, v) * 3).astype(np.float32)
    temps = np.array([0, 0.5, 0.8, 1.0, 1.3, 0.7], np.float32)[:b]
    topk = np.array([0, 5, 50, 0, 10, 2000], np.int32)[:b]
    topp = np.array([1, 0.9, 0.5, 0.95, 1.0, 0.3], np.float32)[:b]
    return logits, temps, topk, topp


@pytest.mark.parametrize("with_top_p", [True, False])
def test_filter_logits_equal(with_top_p):
    logits, temps, topk, topp = _filter_args(1)
    want = jsampling.filter_logits(jnp.asarray(logits), jnp.asarray(temps),
                                   jnp.asarray(topk),
                                   jnp.asarray(topp) if with_top_p else None)
    got = sampling.filter_logits(torch.from_numpy(logits),
                                 torch.from_numpy(temps),
                                 torch.from_numpy(topk),
                                 torch.from_numpy(topp) if with_top_p
                                 else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(6))
def test_sample_tokens_and_categorical_identical(seed):
    logits, temps, topk, topp = _filter_args(10 + seed)
    base_j, base_t = _keys(6, seed)
    pos = np.random.RandomState(seed).randint(0, 1000, 6).astype(np.int32)
    kj = jsampling.batch_keys(base_j, jnp.asarray(pos))
    kt = sampling.batch_keys(base_t, torch.from_numpy(pos))
    want = jsampling.sample_tokens(jnp.asarray(logits), kj, jnp.asarray(temps),
                                   jnp.asarray(topk), jnp.asarray(topp))
    got = sampling.sample_tokens(torch.from_numpy(logits), kt,
                                 torch.from_numpy(temps),
                                 torch.from_numpy(topk),
                                 torch.from_numpy(topp))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i in range(6):
        np.testing.assert_array_equal(
            int(sampling.categorical(kt[i], torch.from_numpy(logits[i]))),
            int(jax.random.categorical(kj[i], jnp.asarray(logits[i]))))


# --------------------------------------------------------------------------- #
# support: tests/test_serving.py:263-345
# --------------------------------------------------------------------------- #

def _sample(logits, keys, temps, topks, topps=None):
    return sampling.sample_tokens(
        torch.as_tensor(logits), keys, torch.as_tensor(temps),
        torch.as_tensor(topks), None if topps is None else
        torch.as_tensor(topps)).numpy()


def _split(seed, n):
    return torch.from_numpy(_np(jax.random.split(jax.random.PRNGKey(seed),
                                                 n)))


def test_sample_tokens_greedy_rows_match_argmax():
    logits = np.random.RandomState(0).randn(4, 32).astype(np.float32)
    toks = _sample(logits, _split(0, 4), np.zeros(4, np.float32),
                   np.zeros(4, np.int32))
    np.testing.assert_array_equal(toks, logits.argmax(-1))


def test_sample_tokens_top_k_restricts_support():
    logits = np.random.RandomState(1).randn(2, 64).astype(np.float32)
    top2 = np.argsort(-logits, axis=-1)[:, :2]
    for i in range(20):
        toks = _sample(logits, _split(i, 2), np.ones(2, np.float32),
                       np.full(2, 2, np.int32))
        for b in range(2):
            assert toks[b] in top2[b]


def test_sampling_keys_advance_per_step():
    logits = np.random.RandomState(2).randn(1, 256).astype(np.float32)
    base = sampling.PRNGKey(0)[None]
    draws = {int(_sample(logits, sampling.batch_keys(base, torch.tensor([p])),
                         np.ones(1, np.float32), np.zeros(1, np.int32))[0])
             for p in range(8)}
    assert len(draws) > 1, "all positions replayed the same draw"


def test_sample_tokens_top_p_restricts_support():
    logits = np.random.RandomState(4).randn(2, 64).astype(np.float32)
    logits[:, 7] = 12.0
    for i in range(10):
        toks = _sample(logits, _split(i, 2), np.ones(2, np.float32),
                       np.zeros(2, np.int32), np.full(2, 0.5, np.float32))
        assert (toks == 7).all()


def test_sample_tokens_top_p_one_is_noop():
    logits = np.random.RandomState(5).randn(3, 32).astype(np.float32)
    args = (_split(0, 3), np.ones(3, np.float32),
            np.asarray([0, 4, 16], np.int32))
    np.testing.assert_array_equal(_sample(logits, *args),
                                  _sample(logits, *args,
                                          np.ones(3, np.float32)))


def test_sample_tokens_top_k_above_vocab_is_clamped():
    logits = np.random.RandomState(6).randn(2, 16).astype(np.float32)
    keys, temps = _split(3, 2), np.ones(2, np.float32)
    np.testing.assert_array_equal(
        _sample(logits, keys, temps, np.full(2, 999, np.int32)),
        _sample(logits, keys, temps, np.zeros(2, np.int32)))


def test_sampling_params_validation():
    with pytest.raises(ValueError, match="top_k"):
        SamplingParams(top_k=-1).validate()
    for bad in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError, match="top_p"):
            SamplingParams(top_p=bad).validate()
    SamplingParams(temperature=0.7, top_k=10_000, top_p=0.9).validate()
    with pytest.raises(ValueError, match="int32"):
        sampling.PRNGKey(2 ** 31)
