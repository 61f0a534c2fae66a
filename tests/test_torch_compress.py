"""``repro_torch/optim/compress.py`` against ``repro/optim/compress.py``:
the int8 and top-k helpers on hypothesis seeds (numpy inputs through
both, as ``tests/test_optim.py:57-84`` draws them), the error feedback
over steps, and ``compressed_psum`` in one process as the one rank of a
gloo group (a one-pod ``pod`` axis) against JAX's on a one-device mesh.
The sharded cases (two pods on 8 ranks) are in
``tests/test_torch_mesh_train.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.optim import compress as jcompress
from repro_torch.distributed import ranks
from repro_torch.launch import mesh as mesh_mod
from repro_torch.optim import compress


def _normal(seed, shape=(64,)):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_int8_matches_jax(seed):
    g = _normal(seed % (2 ** 32))
    q, s = compress._int8_compress(torch.from_numpy(g))
    jq, js = jcompress._int8_compress(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-7)
    back = compress._int8_decompress(q, s).numpy()
    np.testing.assert_allclose(back, np.asarray(
        jcompress._int8_decompress(jq, js)), rtol=1e-6, atol=1e-8)
    assert np.abs(back - g).max() <= float(s) * 0.51 + 1e-6


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.sampled_from([0.01, 0.1, 0.4]))
def test_topk_mask_matches_jax(seed, frac):
    g = _normal(seed % (2 ** 32), (8, 16))
    got = compress._topk_mask(torch.from_numpy(g), frac).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jcompress._topk_mask(jnp.asarray(g), frac)))


def test_topk_mask_example():
    g = torch.tensor([0.1, -5.0, 0.2, 3.0, -0.05])
    np.testing.assert_array_equal(compress._topk_mask(g, 0.4).numpy(),
                                  [0, 1, 0, 1, 0])


def test_error_feedback_is_lossless_over_time():
    """The residual carries what int8 dropped: the mean of what was sent
    over 50 steps is the gradient."""
    g = torch.from_numpy(_normal(0, (32,)))
    err = torch.zeros(32)
    sent_total = torch.zeros(32)
    for _ in range(50):
        gf = g + err
        sent = compress._int8_decompress(*compress._int8_compress(gf))
        err = gf - sent
        sent_total = sent_total + sent
    np.testing.assert_allclose((sent_total / 50).numpy(), g.numpy(),
                               atol=2e-3)


def _one_pod(rank, dev, g, e):
    mesh = mesh_mod.make_debug_mesh((1,), ("pod",))
    t = {"w": torch.from_numpy(g)}
    te = {"w": torch.from_numpy(e)}
    out = {}
    for method in ("int8", "topk", "none"):
        red, err = compress.compressed_psum(t, te, mesh, method=method,
                                            topk_frac=0.1)
        out[method] = (red["w"].numpy(), err["w"].numpy())
    red, err = compress.compressed_psum(t, te, mesh, axis="data")
    out["no_axis"] = (red["w"] is t["w"], err["w"] is te["w"])
    return out


def test_compressed_psum_one_pod_matches_jax():
    g, e = _normal(3, (16, 8)), 0.01 * _normal(4, (16, 8))
    got = ranks.in_one_rank(_one_pod, "cpu", (g, e))
    mesh = jax.make_mesh((1,), ("pod",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    for method in ("int8", "topk"):
        with jax.set_mesh(mesh):
            red, err = jcompress.compressed_psum(
                {"w": jnp.asarray(g)}, {"w": jnp.asarray(e)}, mesh,
                method=method, topk_frac=0.1)
        np.testing.assert_allclose(got[method][0], np.asarray(red["w"]),
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(got[method][1], np.asarray(err["w"]),
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(got[method][0] + got[method][1], g + e,
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["none"][0], g)
    np.testing.assert_array_equal(got["none"][1], e)
    assert got["no_axis"] == (True, True)


def test_init_error_state():
    p = {"a": torch.ones(3, dtype=torch.bfloat16), "b": {"c": torch.ones(2)}}
    e = compress.init_error_state(p)
    assert e["a"].dtype == torch.float32 and not e["a"].any()
    assert e["b"]["c"].shape == (2,)
