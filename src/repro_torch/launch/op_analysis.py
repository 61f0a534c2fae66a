"""What ``repro/launch/hlo_analysis.py`` measures, over a traced step.

The JAX package reads its roofline terms from the optimized HLO text of a
compiled step. The port has no HLO: a step is eager PyTorch. So this module
keeps the measures and drops the parser. ``OpCounter`` is a
``TorchDispatchMode`` that sees every aten op of a step below autograd,
the backward and any recomputation included. It works on any tensors and
is meant for meta ones (the dry run): a step run on meta tensors is the
card's path, with each hand-written kernel standing in as its shape
function (``kernels/build.route``).

What it counts, under ``hlo_analysis``'s names where the quantity is the
same (``analyze``):

- ``dot_flops_corrected``: 2 prod(out) contract for ``mm``, ``addmm``,
  ``bmm``, ``baddbmm`` and ``convolution``, plus the FLOPs each kernel's
  shape function reports (``build.report_work``). Python loops unroll, so
  there are no while loops to correct for. Attention counts its full S x S
  products (K7's causal skip gets no credit), the convention of XLA's HLO
  and of ``torch.utils.flop_counter``.
- ``collective_bytes``: ``{"total": 0}``. One device runs no collectives;
  the key stays for the mesh.
- ``hbm_bytes_strict``: operand plus output bytes of every op that moves
  data (views, aliases and uninitialised allocations move none), each
  operand at its view's size; the kernels' reported bytes.
- ``hbm_bytes_estimate``: the same over the data-movement and
  compute-anchor ops only (``TRAFFIC_OPS``: the products, gathers and
  scatters, copies, concatenation, reductions) and the kernels,
  elementwise chains taken as fused, as ``hlo_analysis.hbm_bytes``'s
  ``fused``.

And what XLA's ``memory_analysis`` gives the JAX dry run:

- ``peak_bytes``: the high-water mark of live storage bytes over the
  step, the arguments included. Each storage counts once, however many
  views it has; it is live from the op that made it until its last
  reference goes. ``argument_bytes``: the arguments' storages;
  ``output_bytes``: the outputs' storages that are not arguments'.

What differs from ``hlo_analysis``: the HLO is XLA's after fusion and
buffer assignment, so its peak is XLA's schedule; here the peak is
eager PyTorch's, freed by reference counting, which is the order the
card's caching allocator sees. That allocator rounds each block up and
holds cuBLAS workspaces, which a storage count does not see. The
kernels' work is what their shape functions state, at the capacity their
shapes allow where the work depends on data (see each ``*_shape``).
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import build
from repro_torch.tree import leaves

aten = torch.ops.aten

TRAFFIC_OPS = frozenset(p for p in (
    aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution,
    aten.convolution_backward, aten.index, aten.index_select, aten.gather,
    aten.scatter, aten.scatter_add, aten.scatter_reduce, aten.index_put,
    aten.index_put_, aten.index_add, aten.index_add_, aten.scatter_,
    aten.scatter_add_, aten.embedding, aten.embedding_dense_backward,
    aten.copy_, aten._to_copy, aten.clone, aten.cat, aten.sum, aten.mean,
    aten.amax, aten.amin, aten.max, aten.min, aten.any, aten.all,
    aten.argmax, aten.cumsum, aten.logsumexp, aten._softmax,
    aten._log_softmax, aten._softmax_backward_data,
    aten._log_softmax_backward_data, aten.linalg_vector_norm,
    aten.var_mean, aten.sort, aten.topk, aten.constant_pad_nd, aten.flip,
    aten.slice_scatter, aten.select_scatter, aten.repeat,
    aten.masked_scatter, aten.nonzero))

# allocate without writing, or only read metadata: no data moves
_NOFLOW = frozenset((
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten._unsafe_view, aten.lift_fresh,
    aten.lift_fresh_copy, aten._local_scalar_dense, aten.sym_size,
    aten.sym_stride, aten.sym_numel, aten.is_same_size))


def _addmm_flops(args, out) -> int:
    return 2 * out.numel() * args[1].shape[-1]


def _conv_flops(args, out) -> int:
    weight = args[1]
    contract = 1
    for d in weight.shape[1:]:
        contract *= d
    return 2 * out.numel() * contract


_DOTS: Dict[Any, Callable[[Tuple, torch.Tensor], int]] = {
    aten.mm: lambda a, o: 2 * o.numel() * a[0].shape[-1],
    aten.bmm: lambda a, o: 2 * o.numel() * a[0].shape[-1],
    aten.addmm: _addmm_flops,
    aten.baddbmm: _addmm_flops,
    aten.convolution: _conv_flops,
}


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(xs):
    """The tensors among an op's arguments or results (an aten op nests
    them at most one list deep)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from (y for y in x if isinstance(y, torch.Tensor))


class OpCounter(TorchDispatchMode):
    """Counts a step's dot FLOPs, HBM bytes (strict and fused) and live
    storage bytes, and the work its kernels' shape functions report. Call
    ``arguments`` with the step's inputs before running it, ``outputs``
    with its results after (``count`` does both)."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0
        self.hbm_strict = 0
        self.hbm_fused = 0
        self.ops = 0
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.live = self.peak = 0
        self.argument_bytes = self.output_bytes = 0
        self._sizes: Dict[int, int] = {}     # storage -> bytes, while live
        self._args: set = set()

    # -- storages ----------------------------------------------------------
    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def _track(self, t: torch.Tensor) -> int:
        """Register t's storage once; returns its key."""
        st = t.untyped_storage()
        key = st._cdata
        size = st.nbytes()
        old = self._sizes.get(key)
        if old is None:
            weakref.finalize(st, self._free, key)
            self._sizes[key] = size
            self.live += size
        elif old != size:                  # resized in place
            self._sizes[key] = size
            self.live += size - old
        if self.live > self.peak:
            self.peak = self.live
        return key

    def arguments(self, *args) -> None:
        for t in leaves(args):
            if isinstance(t, torch.Tensor):
                key = self._track(t)
                if key not in self._args:
                    self._args.add(key)
                    self.argument_bytes += self._sizes[key]

    def outputs(self, *outs) -> None:
        seen = set()
        for t in leaves(outs):
            if isinstance(t, torch.Tensor):
                key = self._track(t)
                if key not in self._args and key not in seen:
                    seen.add(key)
                    self.output_bytes += self._sizes[key]

    # -- kernels -----------------------------------------------------------
    def _kernel(self, name: str, flops: int, nbytes: int) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.dot_flops += flops
        self.hbm_strict += nbytes
        self.hbm_fused += nbytes

    def __enter__(self):
        build.WORK_SINKS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        build.WORK_SINKS.remove(self._kernel)
        return super().__exit__(*exc)

    # -- ops ---------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace != "aten":        # prim.device and the like
            return out
        self.ops += 1
        packet = func.overloadpacket
        dot = _DOTS.get(packet)
        if dot is not None:
            self.dot_flops += dot(args, out)
        outs = list(_tensors(out if isinstance(out, (list, tuple))
                             else (out,)))
        if not func.is_view and packet not in _NOFLOW:
            flow = sum(_bytes(t) for t in outs) + sum(
                _bytes(t) for t in _tensors(args)) + sum(
                _bytes(t) for t in _tensors((kwargs or {}).values()))
            self.hbm_strict += flow
            if packet in TRAFFIC_OPS:
                self.hbm_fused += flow
        for t in outs:
            self._track(t)
        return out

    def analyze(self) -> Dict[str, Any]:
        """``hlo_analysis.analyze``'s keys, and the memory terms."""
        return {"dot_flops_corrected": self.dot_flops,
                "collective_bytes": {"total": 0},
                "hbm_bytes_estimate": self.hbm_fused,
                "hbm_bytes_strict": self.hbm_strict,
                "peak_bytes": self.peak,
                "argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "ops": self.ops,
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}


def count(fn: Callable, *args) -> Tuple[Any, Dict[str, Any]]:
    """Run ``fn(*args)`` under an ``OpCounter`` -> (its result, the
    counter's ``analyze()``). On meta tensors a trace; on real ones it
    measures the same step as it runs."""
    counter = OpCounter()
    with counter:
        counter.arguments(*args)
        out = fn(*args)
        counter.outputs(out)
    return out, counter.analyze()
