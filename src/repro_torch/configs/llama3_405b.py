"""llama3-405b — 126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
[arXiv:2407.21783; unverified]"""
from repro_torch.config import ModelConfig, SparsityConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=5e5,
    opt_state_dtype="bfloat16",     # required to fit one 256-chip v5e pod
    sparsity=SparsityConfig(enabled=True, l1_coeff=2e-5),
    source="arXiv:2407.21783; unverified",
)
