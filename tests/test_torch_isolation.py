"""The PyTorch port stands alone: no JAX and nothing of the JAX package in
``src/repro_torch/`` or ``chip_smoke.py``; its entry points run on the card
unless the caller asks for the CPU; a kernel wrapper refuses a CPU tensor
instead of falling back; importing the package compiles nothing."""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "attr", "") == "import_module" and \
                node.args and isinstance(node.args[0], (ast.Constant,
                                                        ast.JoinedStr)):
            arg = node.args[0]
            yield arg.value if isinstance(arg, ast.Constant) else \
                "".join(v.value for v in arg.values
                        if isinstance(v, ast.Constant))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "flax", "optax")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_walk_covers_the_package():
    names = {p.name for p in PORT_FILES}
    assert {"engine.py", "lm.py", "ops.py", "bridge.py", "build.py",
            "chip_smoke.py"} <= names


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_a_card_unless_cpu(no_card):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serving import ServingEngine
    cfg = get_config("paper-0.5b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_paged_cache(cfg, 4, 4)
    params = lm.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(params, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced"])
    engine = ServingEngine(params, cfg, block_size=4, max_seq_len=16,
                           device="cpu")
    assert engine.generate([[1, 2, 3]], max_tokens=2)[0].token_ids


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise; the plain path is chosen by ops
    from the tensor's device, never by a failed launch."""
    from repro_torch.core import twell
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.hybrid_matmul import (dense_to_hybrid_cuda,
                                                   hybrid_to_dense_cuda)
    from repro_torch.kernels.paged_chunk_attention import \
        paged_chunk_attention_cuda
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention_cuda
    from repro_torch.kernels.sparse_ffn import (tile_skip_ffn_cuda,
                                                twell_down_proj_cuda,
                                                twell_fused_ffn_cuda)
    from repro_torch.kernels.twell_pack import twell_gate_matmul_cuda
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    w = torch.zeros(64, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        twell_gate_matmul_cuda(x, w, 256, 8)
    tw = twell.pack(torch.zeros(4, 256, dtype=torch.bfloat16), 256, 8)
    with pytest.raises(ValueError, match="CUDA"):
        twell_fused_ffn_cuda(x, tw, w.t().contiguous(), w.t().contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        tile_skip_ffn_cuda(x, w, w, w.t().contiguous(), 256)
    with pytest.raises(ValueError, match="CUDA"):
        twell_down_proj_cuda(tw.values, tw.indices, tw.nnz,
                             w.t().contiguous(), 256)
    q = torch.zeros(2, 1, 4, 16, dtype=torch.bfloat16)
    pool = torch.zeros(3, 4, 2, 16, dtype=torch.bfloat16)
    bt = torch.ones(2, 1, dtype=torch.int32)
    sl = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention_cuda(q, pool, pool, bt, sl)
    with pytest.raises(ValueError, match="CUDA"):
        paged_chunk_attention_cuda(q, pool, pool, bt, sl, sl)
    qkv = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(qkv, qkv, qkv)
    idx = torch.zeros(4, 8, dtype=torch.int32)
    nnz = torch.zeros(4, dtype=torch.int32)
    live = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        hybrid_to_dense_cuda(torch.zeros(4, 8), idx, nnz, live, w.t())
    with pytest.raises(ValueError, match="CUDA"):
        dense_to_hybrid_cuda(x, w.t().contiguous(), idx, nnz, live)


def test_importing_the_package_builds_nothing():
    import repro_torch.launch.serve  # noqa: F401  (imports every layer)
    from repro_torch.kernels import build
    assert build.BUILD_SECONDS is None and not build.BUILD_LOG
