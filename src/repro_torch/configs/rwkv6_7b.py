"""rwkv6-7b (Finch) — 32L d_model=4096, attention-free WKV time-mix with
data-dependent decay, channel-mix FFN d_ff=14336, vocab=65536.
[arXiv:2404.05892; hf]

Technique applicability: channel-mix already uses squared-ReLU activations;
the L1 recipe + non-gated TwELL path apply to its hidden activations
(activation="relu2").
"""
from repro_torch.config import ModelConfig, SparsityConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,                    # wkv heads = d_model / rwkv_head_dim
    num_kv_heads=64,
    head_dim=64,
    rwkv_head_dim=64,
    rwkv_chunk=256,                  # chunked WKV (numerically exact; 380x
    d_ff=14336,                      # memory-roofline win — EXPERIMENTS §Perf B)
    vocab_size=65536,
    gated=False,
    norm="layernorm",
    rope_theta=0.0,
    sparsity=SparsityConfig(enabled=True, l1_coeff=2e-5, activation="relu2"),
    source="arXiv:2404.05892; hf",
)
