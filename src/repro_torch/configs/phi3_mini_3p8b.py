"""phi3-mini-3.8b — 32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064,
RoPE + SwiGLU (here: sparse ReLU-GLU per the paper's recipe).
[arXiv:2404.14219; unverified]"""
from repro_torch.config import ModelConfig, SparsityConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=1e4,
    sparsity=SparsityConfig(enabled=True, l1_coeff=2e-5),
    source="arXiv:2404.14219; unverified",
)
