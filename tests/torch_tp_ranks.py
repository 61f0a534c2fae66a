"""What each rank of ``tests/test_torch_tp.py`` runs (and the unsharded
reference runs in the test's own process): the tensor-parallel workload
of ``tests/test_tp_serving.py:95-160`` through the port's engine. A module
of its own, without JAX, because spawned ranks import the function they
run by its module's name."""
import dataclasses

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.distributed import collectives, sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm
from repro_torch.serving import (EVENT_TOKEN, PagedKVCache, SamplingParams,
                                 ServingEngine, SpecConfig)


def tiled_config(c: int):
    """Reduced paper-0.5b with 4 TwELL tiles of 32 (the default reduced
    config has one tile of 128, which two ranks cannot split), C = ``c``
    (1: no tile overflows, as the port's JAX parity tests run gather;
    4: 8 slots a tile, overflowing on ``lm.init`` weights)."""
    cfg = get_config("paper-0.5b").reduced()
    return dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, twell_tile=32, twell_c=c))


def workload(vocab: int):
    """(arrival step, prompt, max_tokens): chunked prefill (prefill_chunk
    8), a fully cached duplicate prompt arriving while the first decodes
    (a copy-on-write of the shared last block), staggered arrivals."""
    rng = np.random.RandomState(7)
    a = rng.randint(0, vocab, 20).tolist()
    b = a[:16] + rng.randint(0, vocab, 4).tolist()
    d = rng.randint(0, vocab, 9).tolist()
    return [(0, a, 10), (1, d, 6), (3, list(a), 8), (4, b, 8)]


ENGINE = dict(block_size=4, max_batch=4, max_seq_len=48, prefill_chunk=8)


def spec_config():
    return SpecConfig(k=2, draft_backend="tile_skip", draft_threshold=0.05)


def engine(params, cfg, backend, mesh, **kw):
    return ServingEngine(params, cfg, backend=backend, spec=spec_config(),
                         mesh=mesh, device="cpu", **ENGINE, **kw)


def drive(eng, work, sampling=None):
    """Submit ``work`` staggered through the handle/event API, step to the
    end (flushing a pipelined engine), and check what JAX's test checks:
    the streamed TOKEN events equal each terminal output, the pool's
    invariants. Returns {rid: tokens}."""
    handles, streamed, pending, step = {}, {}, list(work), 0
    while pending or eng.has_unfinished():
        while pending and pending[0][0] <= step:
            _, p, mt = pending.pop(0)
            h = eng.submit(p, max_tokens=mt, sampling=sampling and
                           sampling(len(handles)))
            handles[h.rid] = h
            streamed[h.rid] = []
        for ev in eng.step():
            if ev.kind == EVENT_TOKEN:
                streamed[ev.rid].extend(ev.tokens)
        step += 1
    assert eng.flush() == []
    eng.kv.check_invariants()
    outs = {r: h.result().token_ids for r, h in handles.items()}
    assert streamed == outs, "events != terminal output"
    return outs


def _served(eng, outs):
    return {"tokens": outs, "cow": eng.kv.cow_count,
            "drafted": sum(s.spec_drafted for s in eng.stats),
            "cached": eng.cached_tokens_total}


def summary(tm):
    """The telemetry summary's entries that do not depend on timing."""
    s = tm.summary()
    sp = {k: v for k, v in s["sparsity"].items()
          if k not in ("mfu", "tokens_per_joule_proxy")}
    return {"sparsity": sp,
            **{k: s[k] for k in ("steps", "tokens_generated",
                                 "prefix_cache_hit_rate",
                                 "spec_acceptance_rate",
                                 "spec_acceptance_hist", "jit_compiles")}}


def serving_suite(mesh, jax_params, dense_only=False):
    """Every engine run of the file on ``mesh`` (None: the unsharded
    reference): gather with JAX's weights on the C 1 config; dense and
    tile_skip (and, unless ``dense_only``, a seeded stochastic gather run,
    gather with telemetry, gather pipelined) with the port's own weights on
    the C 4 config; each with the workload's tile-skip drafts."""
    from repro_torch.serving import Telemetry
    out = {}
    cfg1, cfg4 = tiled_config(1), tiled_config(4)
    params4 = lm.init(cfg4, device="cpu", seed=0)
    backends = ("dense",) if dense_only else ("dense", "tile_skip")
    for name in backends:
        eng = engine(params4, cfg4, name, mesh)
        out[name] = _served(eng, drive(eng, workload(cfg4.vocab_size)))
    if dense_only:
        return out
    p1 = bridge.from_numpy(jax_params)
    eng = engine(p1, cfg1, "gather", mesh)
    out["jax_gather"] = _served(eng, drive(eng, workload(cfg1.vocab_size)))
    a, _, _, d = [w[1] for w in workload(cfg1.vocab_size)]
    kw = dict(backend="gather", mesh=mesh, device="cpu", **ENGINE,
              spec=SpecConfig(k=2, draft_backend="tile_skip"))
    shim = [o.token_ids for o in ServingEngine(p1, cfg1, **kw).generate(
        [a, d], max_tokens=6)]
    eng = ServingEngine(p1, cfg1, **kw)
    hs = [eng.submit(p, max_tokens=6) for p in (a, d)]
    while eng.has_unfinished():
        eng.step()
    assert [h.result().token_ids for h in hs] == shim, "shim != handle API"
    out["shim"] = shim
    eng = engine(params4, cfg4, "gather", mesh)
    out["sampled"] = _served(eng, drive(
        eng, workload(cfg4.vocab_size), sampling=lambda i: SamplingParams(
            temperature=0.8, top_k=8, seed=100 + i)))
    tm = Telemetry()
    eng = engine(params4, cfg4, "gather", mesh, telemetry=tm)
    out["telemetry"] = {**_served(eng, drive(eng, workload(
        cfg4.vocab_size))), "summary": summary(tm)}
    prom = tm.registry.render_prometheus()
    out["tp_label"] = [ln for ln in prom.splitlines()
                       if ln.startswith("serving_build_info{")]
    eng = engine(params4, cfg4, "gather", mesh, pipeline=True)
    out["pipelined"] = _served(eng, drive(eng, workload(cfg4.vocab_size)))
    return out


def cow_pools(mesh, content):
    """JAX's sharded COW sequence (``test_tp_serving.py:222``) on a pool
    holding ``content`` (this rank's kv heads of it under ``mesh``): two
    requests sharing two blocks, a copy-on-write of the second, growth,
    truncation and frees, the invariants after each. Returns the pools."""
    cfg = get_config("paper-0.5b").reduced()
    kv = PagedKVCache(cfg, 10, 4, device="cpu", mesh=mesh)
    h = kv.pools["kpool"].shape[3]
    r = 0 if mesh is None else mesh.get_local_rank("model")
    for n, pool in kv.pools.items():
        pool.copy_(torch.from_numpy(content[n][:, :, :, r * h:(r + 1) * h]))
    toks = list(range(8))
    kv.allocate_prefix(0, toks, 2)
    kv.register_prefix(0, toks)
    kv.allocate_prefix(1, toks, 2)          # shares both blocks (ref 2)
    kv.check_invariants()
    assert kv.ensure_writable(1, 1) is not None
    kv.check_invariants()
    kv.append_block(1)
    kv.truncate(1, 2)
    kv.check_invariants()
    kv.free(0)
    kv.free(1)
    kv.check_invariants()
    return {n: p.numpy().copy() for n, p in kv.pools.items()}


def flash(mesh, q, k, v, length):
    """``flash_decode_attention`` on this rank's slice of the sequence."""
    tp, r = sharding.tp_size(mesh), mesh.get_local_rank("model")
    s = k.shape[1] // tp
    return collectives.flash_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k[:, r * s:(r + 1) * s]),
        torch.from_numpy(v[:, r * s:(r + 1) * s]), length, mesh).numpy()


def rank_tp2(rank, dev, jax_params, cow_content, flash_in):
    mesh = sharding.make_serving_mesh(2, dev)
    out = serving_suite(mesh, jax_params)
    out["cow"] = cow_pools(mesh, cow_content)
    out["flash"] = flash(mesh, *flash_in)
    out["calls"] = collectives.calls()
    return out


def rank_tp4(rank, dev, flash_in):
    mesh = sharding.make_serving_mesh(4, dev)
    out = serving_suite(mesh, None, dense_only=True)
    out["flash"] = flash(mesh, *flash_in)
    debug = mesh_mod.make_debug_mesh((2, 2), ("data", "model"))
    out["debug_mesh"] = (sharding.mesh_axes(debug),
                         debug.get_local_rank("data"),
                         debug.get_local_rank("model"))
    return out
