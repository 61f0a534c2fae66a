"""Plain versions of the paged-attention kernels K3 (decode) and K4
(chunk-append) in the PyTorch port, held against the JAX package's Pallas
kernels in interpret mode and its kernels/ref.py oracles on the same numpy
inputs: ragged and boundary seq_lens, GQA, num_new = 0.

Tolerance: float32 2e-5 absolute, as tests/test_paged_attention.py holds
the Pallas kernels to the oracle. Chunk rows at or past num_new are padding
(garbage in every version, ref.py:87-97) and are compared only for being
finite.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.paged_chunk_attention import paged_chunk_attention_pallas
from repro.kernels.paged_decode_attention import paged_decode_attention_pallas
from repro_torch.kernels import ops
from repro_torch.kernels.paged_chunk_attention import \
    paged_chunk_attention_plain
from repro_torch.kernels.paged_decode_attention import \
    paged_decode_attention_plain

TOL = 2e-5


def _random_paged(rng, b, hkv, hd, bs, width):
    """Random pools + a valid random block table (block 0 = null)."""
    n = 1 + b * width
    kpool = rng.randn(n, bs, hkv, hd).astype(np.float32)
    vpool = rng.randn(n, bs, hkv, hd).astype(np.float32)
    perm = rng.permutation(np.arange(1, n))
    bt = perm[:b * width].reshape(b, width).astype(np.int32)
    return kpool, vpool, bt


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


DECODE_CASES = [
    # (b, hkv, g, hd, bs, width, seq_lens or None = random)
    (5, 2, 2, 16, 4, 4, [0, 3, 4, 8, 15]),      # boundaries: 0, page edges, last
    (3, 4, 1, 16, 8, 3, None),                  # MHA, ragged
    (4, 2, 4, 8, 2, 6, None),                   # GQA G=4
    (2, 1, 8, 16, 4, 5, [19, 0]),               # GQA G=8, full table
    (1, 4, 2, 32, 16, 2, [31]),
]


@pytest.mark.parametrize("case", range(len(DECODE_CASES)))
def test_decode_plain_matches_pallas_and_ref(case):
    b, hkv, g, hd, bs, width, sl = DECODE_CASES[case]
    rng = np.random.RandomState(case)
    kpool, vpool, bt = _random_paged(rng, b, hkv, hd, bs, width)
    sl = np.asarray(sl if sl is not None else
                    rng.randint(0, width * bs, size=b), np.int32)
    q = rng.randn(b, 1, hkv * g, hd).astype(np.float32)
    want_k = paged_decode_attention_pallas(*_j(q, kpool, vpool, bt, sl),
                                           interpret=True)
    want_r = ref.paged_attention_decode(*_j(q, kpool, vpool, bt, sl))
    got = paged_decode_attention_plain(*_t(q, kpool, vpool, bt, sl)).numpy()
    np.testing.assert_allclose(got, np.asarray(want_k), atol=TOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(want_r), atol=TOL, rtol=0)
    via_ops = ops.paged_attention_decode(*_t(q, kpool, vpool, bt, sl))
    np.testing.assert_array_equal(via_ops.numpy(), got)


def test_decode_padded_row_is_finite():
    """A padded batch row: seq_len 0 and an all-null table."""
    rng = np.random.RandomState(11)
    kpool, vpool, _ = _random_paged(rng, 2, 2, 16, 4, 3)
    bt = np.zeros((2, 3), np.int32)
    q = rng.randn(2, 1, 4, 16).astype(np.float32)
    out = paged_decode_attention_plain(*_t(q, kpool, vpool, bt,
                                           np.zeros(2, np.int32)))
    assert torch.isfinite(out).all()


CHUNK_CASES = [
    # (b, hkv, g, hd, bs, s, width)
    (3, 2, 1, 16, 4, 4, 5),
    (2, 1, 4, 16, 2, 8, 7),      # GQA G=4, G*S = 32 query rows per kv head
    (4, 2, 2, 16, 4, 2, 4),
    (2, 2, 2, 32, 8, 16, 4),
]


@pytest.mark.parametrize("case", range(len(CHUNK_CASES)))
def test_chunk_plain_matches_pallas_and_ref(case):
    b, hkv, g, hd, bs, s, width = CHUNK_CASES[case]
    rng = np.random.RandomState(100 + case)
    kpool, vpool, bt = _random_paged(rng, b, hkv, hd, bs, width)
    sl = rng.randint(0, width * bs - s, size=b).astype(np.int32)
    nn = rng.randint(1, s + 1, size=b).astype(np.int32)
    nn[0] = 0                                   # one num_new = 0 row
    sl[-1] = 0                                  # one fresh prefill
    nn[-1] = s                                  # ... of a full chunk
    q = rng.randn(b, s, hkv * g, hd).astype(np.float32)
    want_k = paged_chunk_attention_pallas(*_j(q, kpool, vpool, bt, sl, nn),
                                          interpret=True)
    want_r = ref.paged_attention_extend(*_j(q, kpool, vpool, bt, sl, nn))
    got = paged_chunk_attention_plain(*_t(q, kpool, vpool, bt, sl, nn))
    assert torch.isfinite(got).all()
    valid = (np.arange(s)[None, :] < nn[:, None])[:, :, None, None]
    got = got.numpy()
    np.testing.assert_allclose(got * valid, np.asarray(want_k) * valid,
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(got * valid, np.asarray(want_r) * valid,
                               atol=TOL, rtol=0)
    via_ops = ops.paged_attention_extend(*_t(q, kpool, vpool, bt, sl, nn))
    np.testing.assert_array_equal(via_ops.numpy(), got)


def test_gqa_head_group_mapping():
    """Head h reads kv head h // G, per head (distinct pages per kv head)."""
    rng = np.random.RandomState(4)
    b, hkv, g, hd, bs, width = 2, 4, 2, 8, 4, 3
    kpool, vpool, bt = _random_paged(rng, b, hkv, hd, bs, width)
    sl = np.asarray([5, 9], np.int32)
    q = rng.randn(b, 1, hkv * g, hd).astype(np.float32)
    out = paged_decode_attention_plain(*_t(q, kpool, vpool, bt, sl)).numpy()
    kf = kpool[bt].reshape(b, -1, hkv, hd)
    vf = vpool[bt].reshape(b, -1, hkv, hd)
    kpos = np.arange(kf.shape[1])
    for h in range(hkv * g):
        logits = np.einsum("bd,bkd->bk", q[:, 0, h], kf[:, :, h // g]) / \
            np.sqrt(hd)
        logits = np.where(kpos[None] <= sl[:, None], logits, -1e30)
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        o = np.einsum("bk,bkd->bd", p, vf[:, :, h // g])
        np.testing.assert_allclose(out[:, 0, h], o, atol=TOL, rtol=0)
