"""The port's dry-run pieces on the CPU, in process: ``hybrid.transpose``
against JAX's, ``launch/specs.py`` against ``repro/launch/specs.py``
(parameter leaves of all 12 configs at full size, the inputs of every
family), each kernel's shape function against its plain version's
outputs, ``launch/op_analysis.py`` on steps with known answers, and the
serve and prefill steps against JAX's on the same weights.

Tolerance: the hybrid format exactly (indices, counts, routing, values
copied); shapes, dtypes, counts and byte sums exactly; the steps' float32
logits 2e-4 (rtol and atol), as tests/test_torch_model.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import shape_by_name as jax_shape_by_name
from repro.configs import get_config as jax_get_config
from repro.core import hybrid as jhyb
from repro.launch import specs as jspecs
from repro.models import lm as jlm
from repro import training as jtraining
from repro_torch import bridge, training
from repro_torch.config import shape_by_name
from repro_torch.configs import get_config, list_archs
from repro_torch.core import hybrid as hyb
from repro_torch.core import twell
from repro_torch.kernels import build, ops
from repro_torch.launch import op_analysis, specs
from repro_torch.models import lm
from repro_torch.observability import accounting
from repro_torch.tree import leaves, leaves_with_path

TOL = dict(rtol=2e-4, atol=2e-4)
META = torch.device("meta")
FIELDS = ("ell_values", "ell_indices", "row_nnz", "is_dense", "dense_rows",
          "dense_map", "overflow")
FAMILY_ARCHS = ("paper-0.5b", "mixtral-8x22b", "zamba2-1.2b", "rwkv6-7b",
                "whisper-large-v3", "llama-3.2-vision-11b")


def _mixed_rows(seed, m, n, sparse_nnz, dense_frac):
    """Rows with a few non-zeros plus some dense rows, as
    tests/test_torch_hybrid.py builds them."""
    rng = np.random.RandomState(seed)
    h = np.zeros((m, n), np.float32)
    for r in range(m):
        h[r, rng.randint(0, n, sparse_nnz)] = \
            np.abs(rng.randn(sparse_nnz)) + 0.1
    dense = rng.rand(m) < dense_frac
    h[dense] = np.abs(rng.randn(int(dense.sum()), n)) + 0.1
    return h


# --------------------------------------------------------------------------- #
# hybrid.transpose (Listing 7)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("seed,dense_frac,e_t,backup_t", [
    (0, 0.0, 16, 8), (1, 0.2, 8, 16), (2, 0.4, 4, 2)])
def test_transpose_matches_jax(seed, dense_frac, e_t, backup_t):
    m, n, e, md = 48, 40, 8, 12
    h = _mixed_rows(seed, m, n, 3, dense_frac)
    got = hyb.transpose(hyb.pack(torch.from_numpy(h), e, md), m, e_t,
                        backup_t)
    want = jax.jit(lambda x: jhyb.transpose(jhyb.pack(x, e, md), m, e_t,
                                            backup_t))(jnp.asarray(h))
    assert got.n == want.n == m
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    if not bool(got.overflow):
        np.testing.assert_array_equal(hyb.unpack(got).numpy(), h.T)


# --------------------------------------------------------------------------- #
# launch/specs.py against repro/launch/specs.py
# --------------------------------------------------------------------------- #

def _jax_dtype(dt) -> str:
    return jnp.dtype(dt).name


def _torch_dtype(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", list_archs())
def test_abstract_params_match_jax(arch):
    """Every trainable leaf of the port's tree (``lm.trainable``, without
    the derived ``wu_t``) has JAX's path, shape and dtype, at full size;
    the gated FFNs carry ``wu_t`` (N, K) beside ``wu`` (K, N)."""
    params = specs.abstract_params(get_config(arch))
    assert all(t.is_meta for t in leaves(params))
    got = {p: (tuple(t.shape), _torch_dtype(t.dtype))
           for p, t in leaves_with_path(lm.trainable(params))}
    want = {p: (tuple(s.shape), _jax_dtype(s.dtype))
            for p, s in leaves_with_path(
                jspecs.abstract_params(jax_get_config(arch)))}
    assert got == want
    n = accounting.param_count(lm.trainable(params))
    assert n == sum(int(np.prod(s)) for s, _ in want.values())
    derived = {p: tuple(t.shape) for p, t in leaves_with_path(params)
               if p.endswith("wu_t")}
    for p, shape in derived.items():
        assert shape == got[p[:-len("wu_t")] + "wu"][0][:-2] + \
            got[p[:-len("wu_t")] + "wu"][0][-2:][::-1]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_match_jax(arch, shape):
    got = specs.input_specs(get_config(arch), shape_by_name(shape))
    want = jspecs.input_specs(jax_get_config(arch), jax_shape_by_name(shape))
    if "cache" in want:
        assert got["cache"].pop("pos") == 0
        want["cache"].pop("pos")
    got = {p: (tuple(t.shape), _torch_dtype(t.dtype))
           for p, t in leaves_with_path(got)}
    want = {p: (tuple(s.shape), _jax_dtype(s.dtype))
            for p, s in leaves_with_path(want)}
    assert got == want


def test_opt_state_follows_the_trainable_tree():
    cfg = get_config("llama3-405b")
    params = specs.abstract_params(cfg)
    opt = specs.abstract_opt_state(params, cfg)
    train = dict(leaves_with_path(lm.trainable(params)))
    m = dict(leaves_with_path(opt.m))
    assert m.keys() == train.keys()
    assert all(m[k].shape == train[k].shape and
               m[k].dtype == torch.bfloat16 for k in m)   # opt_state_dtype
    assert opt.step.is_meta and opt.step.dtype == torch.int32


# --------------------------------------------------------------------------- #
# kernels' shape functions against their plain versions
# --------------------------------------------------------------------------- #

def _r(gen, *shape, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(dtype)


def _meta(x):
    if isinstance(x, torch.Tensor):
        return x.to(META)
    if isinstance(x, twell.TwellActs):
        return x._replace(values=x.values.to(META),
                          indices=x.indices.to(META), nnz=x.nnz.to(META),
                          overflow=x.overflow.to(META))
    return x


def _same_outputs(plain, shape_only):
    p = [t for t in leaves(tuple(plain)) if isinstance(t, torch.Tensor)]
    s = [t for t in leaves(tuple(shape_only))
         if isinstance(t, torch.Tensor)]
    assert len(p) == len(s)
    for a, b in zip(p, s):
        assert b.is_meta
        assert (tuple(a.shape), a.dtype) == (tuple(b.shape), b.dtype)


@pytest.fixture
def no_build(monkeypatch):
    """A shape function never reaches a build, a bind or a launch."""
    def refuse(*a, **k):
        raise AssertionError("a tensor without data reached the build")
    monkeypatch.setattr(build, "bind", refuse)
    monkeypatch.setattr(build, "library", refuse)
    monkeypatch.setattr(build, "count_launch", refuse)


def _works(fn, *args):
    """(outputs, the work the shape function reported)."""
    seen = []
    build.WORK_SINKS.append(lambda *w: seen.append(w))
    try:
        out = fn(*args)
    finally:
        build.WORK_SINKS.pop()
    return out, seen


@pytest.mark.parametrize("m,k,n,tile,c", [(4, 64, 512, 128, 8),
                                           (70, 128, 1024, 256, 16)])
def test_shapes_k1_k2_k6(no_build, m, k, n, tile, c):
    gen = torch.Generator().manual_seed(m)
    x, wg, wu, wd = (_r(gen, m, k), _r(gen, k, n, scale=0.1),
                     _r(gen, k, n, scale=0.1), _r(gen, n, k, scale=0.1))
    tw = ops.twell_gate_matmul(x, wg, tile, c)
    mtw, work = _works(ops.twell_gate_matmul, x.to(META), wg.to(META), tile,
                       c)
    _same_outputs(tw, mtw)
    slots = n // c
    assert work == [("twell_gate_matmul", 2 * m * k * n,
                     2 * (m * k + k * n + m * slots) + 4 * m * slots +
                     4 * m * (n // tile))]
    wu_t = wu.t().contiguous()
    y = ops.twell_fused_ffn(x, tw, wu_t, wd)
    my, work = _works(ops.twell_fused_ffn, x.to(META), mtw, wu_t.to(META),
                      wd.to(META))
    _same_outputs((y,), (my,))
    u = min(n, m * slots)
    assert work[0][:2] == ("twell_fused_ffn", 4 * m * u * k)
    y6 = ops.twell_down_proj(tw, wd)
    my6, work = _works(ops.twell_down_proj, mtw, wd.to(META))
    _same_outputs((y6,), (my6,))
    assert work[0][:2] == ("twell_down_proj", 2 * m * u * k)


@pytest.mark.parametrize("m,k,n,tile", [(4, 64, 512, 128),
                                        (40, 128, 768, 256)])
def test_shape_k5(no_build, m, k, n, tile):
    gen = torch.Generator().manual_seed(m)
    args = (_r(gen, m, k), _r(gen, k, n), _r(gen, k, n), _r(gen, n, k))
    out = ops.tile_skip_ffn(*args, tile, "relu2", 0.5)
    mout, work = _works(ops.tile_skip_ffn, *map(_meta, args), tile, "relu2",
                        0.5)
    _same_outputs(out, mout)
    assert work[0][:2] == ("tile_skip_ffn", 6 * m * k * n)


def _paged(gen, b, h, hkv, hd, bs, width, s=1):
    q = _r(gen, b, s, h, hd)
    pool = (_r(gen, 1 + b * width, bs, hkv, hd),
            _r(gen, 1 + b * width, bs, hkv, hd))
    bt = torch.arange(1, 1 + b * width, dtype=torch.int32).reshape(b, width)
    sl = torch.full((b,), bs * width - s, dtype=torch.int32)
    return q, pool, bt, sl


@pytest.mark.parametrize("b,h,hkv,hd,bs,width", [(2, 4, 4, 64, 16, 3),
                                                 (3, 8, 2, 128, 8, 5)])
def test_shapes_k3_k4(no_build, b, h, hkv, hd, bs, width):
    gen = torch.Generator().manual_seed(b)
    q, (kp, vp), bt, sl = _paged(gen, b, h, hkv, hd, bs, width)
    o = ops.paged_attention_decode(q, kp, vp, bt, sl)
    mo, work = _works(ops.paged_attention_decode,
                      *map(_meta, (q, kp, vp, bt, sl)))
    _same_outputs((o,), (mo,))
    assert work[0][:2] == ("paged_decode_attention",
                           4 * b * h * width * bs * hd)
    q, (kp, vp), bt, sl = _paged(gen, b, h, hkv, hd, bs, width, s=5)
    nn = torch.full((b,), 5, dtype=torch.int32)
    o = ops.paged_attention_extend(q, kp, vp, bt, sl, nn)
    mo, work = _works(ops.paged_attention_extend,
                      *map(_meta, (q, kp, vp, bt, sl, nn)))
    _same_outputs((o,), (mo,))
    assert work[0][:2] == ("paged_chunk_attention",
                           4 * b * 5 * h * width * bs * hd)


@pytest.mark.parametrize("b,s,h,hd", [(1, 16, 2, 64), (2, 40, 3, 96)])
def test_shape_k7(no_build, b, s, h, hd):
    gen = torch.Generator().manual_seed(s)
    qkv = [_r(gen, b, s, h, hd) for _ in range(3)]
    o = ops.flash_attention(*qkv)
    mo, work = _works(ops.flash_attention, *map(_meta, qkv))
    _same_outputs((o,), (mo,))
    assert work == [("flash_attention", 4 * b * h * s * s * hd,
                     4 * 2 * b * s * h * hd)]


@pytest.mark.parametrize("m,n,k,e", [(24, 64, 32, 8), (160, 96, 48, 4)])
def test_shapes_k8_k9(no_build, m, n, k, e):
    h = torch.from_numpy(_mixed_rows(m, m, n, 3, 0.1)).to(torch.bfloat16)
    hy = hyb.pack(h, e, m // 4)
    gen = torch.Generator().manual_seed(m)
    w, x = _r(gen, n, k), _r(gen, m, k)
    args8 = (hy.ell_values, hy.ell_indices, hy.row_nnz, ~hy.is_dense, w)
    y = ops.hybrid_to_dense(*args8)
    my, work8 = _works(ops.hybrid_to_dense, *map(_meta, args8))
    _same_outputs((y,), (my,))
    args9 = (x, w, hy.ell_indices, hy.row_nnz, ~hy.is_dense)
    v = ops.dense_to_hybrid(*args9)
    mv, work9 = _works(ops.dense_to_hybrid, *map(_meta, args9))
    _same_outputs((v,), (mv,))
    u = min(n, min(m, 128) * e)            # a row block's union capacity
    assert work8[0][:2] == ("hybrid_to_dense", 2 * m * u * k)
    assert work9[0][:2] == ("dense_to_hybrid", 2 * m * u * k)


def test_plans_use_the_h100_sm_count():
    """Without a card the shape functions plan for the H100: a shape its
    plan refuses is refused on meta tensors too."""
    assert accounting.H100_SMS == 132
    x = torch.empty(4, 64, dtype=torch.bfloat16, device=META)
    w = torch.empty(64, 500, dtype=torch.bfloat16, device=META)
    with pytest.raises(ValueError):
        ops.twell_gate_matmul(x, w, 128, 8)          # N % tile != 0


# --------------------------------------------------------------------------- #
# launch/op_analysis.py on known answers
# --------------------------------------------------------------------------- #

def test_dot_flops_of_a_loop():
    """Four mm of 8x16 @ 16x32 in a loop: 4 x 2 x 8 x 16 x 32 dot FLOPs
    (the case of tests/test_hlo_roofline.py's while loop, which the text
    analysis multiplies by its trip count; here the loop unrolls)."""
    def step(x, w):
        acc = torch.zeros(8, 32, device=x.device)
        for _ in range(4):
            acc = acc + x @ w
        return acc

    x = torch.empty(8, 16, device=META)
    w = torch.empty(16, 32, device=META)
    _, ana = op_analysis.count(step, x, w)
    assert ana["dot_flops_corrected"] == 4 * 2 * 8 * 16 * 32
    assert ana["collective_bytes"] == {"total": 0}
    assert ana["hbm_bytes_strict"] >= ana["hbm_bytes_estimate"] > 0


def test_peak_of_a_known_chain():
    """args 1024 B; a 4096 B temporary freed before an 8192 B one; the
    output (2048 B) aliases nothing: peak = 1024 + 8192 + 2048 while the
    last temporary and the output coexist."""
    def step(a):
        t1 = a.new_empty(1024)           # 4096 B
        del t1
        t2 = a.new_empty(2048)           # 8192 B
        out = t2[:512].clone()           # 2048 B, a view's copy
        del t2
        return out

    a = torch.empty(256, device=META)    # 1024 B
    out, ana = op_analysis.count(step, a)
    assert (ana["argument_bytes"], ana["output_bytes"]) == (1024, 2048)
    assert ana["peak_bytes"] == 1024 + 8192 + 2048


def test_meta_trace_matches_a_real_cpu_run():
    """A plain-only step (the dense FFN's products and AdamW's update, no
    kernel) traced on meta tensors and run on real CPU tensors: the same
    peak, FLOPs and bytes."""
    def step(params, x):
        with torch.enable_grad():
            live = [p.detach().requires_grad_(True) for p in params]
            h = torch.relu(x @ live[0])
            loss = (h @ live[1]).float().pow(2).mean()
            grads = torch.autograd.grad(loss, live)
        return [p - 0.1 * g for p, g in zip(params, grads)]

    gen = torch.Generator().manual_seed(0)
    real = ([torch.randn(32, 64, generator=gen),
             torch.randn(64, 32, generator=gen)],
            torch.randn(16, 32, generator=gen))
    meta = ([p.to(META) for p in real[0]], real[1].to(META))
    _, on_cpu = op_analysis.count(step, *real)
    _, on_meta = op_analysis.count(step, *meta)
    for key in ("peak_bytes", "argument_bytes", "output_bytes",
                "dot_flops_corrected", "hbm_bytes_estimate",
                "hbm_bytes_strict"):
        assert on_cpu[key] == on_meta[key], key
    assert on_cpu["peak_bytes"] > on_cpu["argument_bytes"] + \
        on_cpu["output_bytes"]


# --------------------------------------------------------------------------- #
# the serve and prefill steps against JAX's
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def reduced():
    jcfg = jax_get_config("paper-0.5b").reduced()
    cfg = get_config("paper-0.5b").reduced()
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    params = bridge.from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, cfg, jparams, params


def test_prefill_step_matches_jax(reduced):
    jcfg, cfg, jparams, params = reduced
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 16),
                                            dtype=np.int32)
    want = jax.jit(jtraining.make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got = training.make_prefill_step(cfg)(
            params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_serve_step_matches_jax(reduced):
    jcfg, cfg, jparams, params = reduced
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 3),
                                            dtype=np.int32)
    jstep = jax.jit(jtraining.make_serve_step(jcfg))
    step = training.make_serve_step(cfg)
    jcache = jlm.init_cache(jcfg, 2, 8)
    cache = lm.init_cache(cfg, 2, 8, device="cpu")
    for i in range(3):
        want, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, i:i + 1]))
        with torch.no_grad():
            got, cache = step(params, cache,
                              torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert cache["pos"] == int(jcache["pos"]) == 3
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               **TOL)
