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
its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

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


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
