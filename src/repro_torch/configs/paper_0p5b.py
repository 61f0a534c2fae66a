"""The paper's 0.5B 'Transformer++' (App. B Table 2): 8L d_model=2048 32H
(kv=32, head 64) gated d_ff=5632, ReLU, GPT2 vocab 49152, tied embeddings."""
from repro_torch.config import ModelConfig, SparsityConfig

CONFIG = ModelConfig(
    name="paper-0.5b",
    family="dense",
    num_layers=8,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=49152,
    tied_embeddings=True,
    rope_theta=1e4,
    sparsity=SparsityConfig(enabled=True, l1_coeff=2e-5),
    source="paper App. B Table 2",
)
