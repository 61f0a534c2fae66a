"""olmo-1b — 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304,
non-parametric LayerNorm, tied embeddings. [arXiv:2402.00838; hf]"""
from repro_torch.config import ModelConfig, SparsityConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparametric_ln",
    tied_embeddings=True,
    gated=False,                    # olmo-1b uses a non-gated (SwiGLU-free) MLP
    rope_theta=1e4,
    sparsity=SparsityConfig(enabled=True, l1_coeff=2e-5),
    source="arXiv:2402.00838; hf",
)
