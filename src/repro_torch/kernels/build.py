"""Build the Hopper kernels in ``kernels/csrc/`` and load them with ctypes.

Each ``csrc/*.cu`` source exposes a plain C interface (pointers, ints and
the CUDA stream; the function returns ``cudaGetLastError()`` after its
launch) and is compiled on first use into its own shared library under
``build/repro_torch/`` at the repo root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/repro_torch/<name>.so csrc/<name>.cu

One ``nvcc`` per source, all started together. Nothing is compiled when
the module is imported: the CPU tests import every module, and the CPU has
no compiler.

Launch counts live here too: each kernel wrapper calls ``count_launch``
right after its kernel launched, and nowhere else, so a run can show that
its main path went through the kernels. A CUDA graph's replays add the
counts its capture recorded (``captured_launches``, ``add_launches``).

A kernel's shape function (the stand-in for its launch on tensors without
data, ``route``) launches nothing and counts nothing here: it calls
``report_work`` with the FLOPs and bytes the kernel would do, which every
listener in ``WORK_SINKS`` receives (``launch/op_analysis.py``).
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional

import torch

from repro_torch import device as device_mod

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel name -> launches since the last reset
LAUNCHES: Dict[str, int] = {
    "twell_gate_matmul": 0,
    "twell_fused_ffn": 0,
    "paged_decode_attention": 0,
    "paged_chunk_attention": 0,
    "tile_skip_ffn": 0,
    "twell_down_proj": 0,
    "flash_attention": 0,
    "hybrid_to_dense": 0,
    "dense_to_hybrid": 0,
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_LOG: Dict[str, str] = {}        # source name -> nvcc's -Xptxas -v report
BUILD_SECONDS: Optional[float] = None


# listeners of report_work: fn(kernel name, FLOPs, HBM bytes)
WORK_SINKS: List[Callable[[str, int, int], None]] = []


def report_work(name: str, flops: int, nbytes: int) -> None:
    """A shape function's account of its kernel's work (no launch)."""
    for sink in WORK_SINKS:
        sink(name, flops, nbytes)


def route(t: torch.Tensor, cuda, plain, shape):
    """The function a kernel entry point calls for input ``t``: the
    kernel's launch for a CUDA tensor, its shape function for a tensor
    without data (a meta tensor, the dry run's, or a fake CUDA one under
    ``FakeTensorMode``), the plain version for a CPU tensor."""
    if device_mod.shape_only(t):
        return shape
    return cuda if t.is_cuda else plain


def nbytes(*ts: torch.Tensor) -> int:
    """Bytes of the tensors' elements, each read or written once."""
    return sum(t.numel() * t.element_size() for t in ts)


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def captured_launches(into: Optional[Dict[str, int]] = None
                      ) -> Iterator[Dict[str, int]]:
    """Around a CUDA graph capture: the wrappers count on the host, so a
    capture counts launches that have not run. The counts made inside the
    block are taken back out of ``into`` (default ``LAUNCHES``; also the
    collectives' ``CALLS``) and left in the yielded dict; ``add_launches``
    adds them once per replay of the graph."""
    into = LAUNCHES if into is None else into
    before = dict(into)
    taken: Dict[str, int] = {}
    try:
        yield taken
    finally:
        for k, n in before.items():
            if into[k] != n:
                taken[k] = into[k] - n
                into[k] = n


def add_launches(counts: Dict[str, int],
                 into: Optional[Dict[str, int]] = None) -> None:
    into = LAUNCHES if into is None else into
    for k, n in counts.items():
        into[k] += n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME); the CUDA kernels "
                       "are built from source on the machine with the card")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_all() -> float:
    """Compile every ``csrc/*.cu`` in parallel (one nvcc each) and load the
    libraries. Returns the wall seconds the build took. Raises with the
    compiler's output if any source fails."""
    global BUILD_SECONDS
    with _LOCK:
        if BUILD_SECONDS is not None:
            return BUILD_SECONDS
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for src in sources():
            out = BUILD_DIR / f"{src.stem}.so"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(out), str(src)]
            procs[src.stem] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
        failed = []
        for name, proc in procs.items():
            log, _ = proc.communicate()
            BUILD_LOG[name] = log
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for name in procs:
            _LIBS[name] = ctypes.CDLL(str(BUILD_DIR / f"{name}.so"))
        BUILD_SECONDS = time.perf_counter() - t0
        return BUILD_SECONDS


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all on first use."""
    if name not in _LIBS:
        build_all()
    return _LIBS[name]


def bind(lib_name: str, fn_name: str, argtypes):
    """A C entry point with its argtypes set (pointers and the stream as
    ``c_void_p``, ints as ``c_int``) and an ``int`` (cudaError_t) result."""
    fn = getattr(library(lib_name), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
