"""whisper-large-v3 — enc-dec, 32L d_model=1280 20H (kv=20) d_ff=5120
vocab=51866, conv frontend stubbed (precomputed frame embeddings).
Non-gated FFN -> the paper's App. C.2 non-gated sparse variant applies.
[arXiv:2212.04356; unverified]"""
from repro_torch.config import ModelConfig, SparsityConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,                   # decoder layers
    encoder_layers=32,
    d_model=1280,
    num_heads=20,                    # 20 % 16 != 0 -> attention FSDP-only, FFN TP
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,                # padded to 51968 for 16-way TP
    gated=False,
    norm="layernorm",
    tied_embeddings=True,
    rope_theta=0.0,                  # whisper uses learned/sinusoidal positions
    sparsity=SparsityConfig(enabled=True, l1_coeff=2e-5),
    source="arXiv:2212.04356; unverified",
)
