"""llama-3.2-vision-11b — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, cross-attention image layers every 5th layer; vision frontend
stubbed (precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.config import ModelConfig, SparsityConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    cross_every=5,
    num_image_tokens=1024,
    rope_theta=5e5,
    sparsity=SparsityConfig(enabled=True, l1_coeff=2e-5),
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
