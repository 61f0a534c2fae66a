"""deepseek-67b — 95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400,
llama-style dense. [arXiv:2401.02954; hf]"""
from repro_torch.config import ModelConfig, SparsityConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
    rope_theta=1e4,
    opt_state_dtype="bfloat16",
    sparsity=SparsityConfig(enabled=True, l1_coeff=2e-5),
    source="arXiv:2401.02954; hf",
)
