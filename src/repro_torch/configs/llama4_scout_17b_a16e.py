"""llama4-scout-17b-a16e — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1, chunked local attention + early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.config import ModelConfig, SparsityConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_heads=40,                    # NOTE: 40 % 16 != 0 -> attention is FSDP-only,
    num_kv_heads=8,                  # experts take the 16-way model axis (exact EP)
    head_dim=128,
    num_layers=48,
    d_model=5120,
    d_ff=8192,
    vocab_size=202048,
    num_experts=16,
    top_k=1,
    attn_chunk=8192,                 # chunked local attention -> long_500k runnable
    rope_theta=5e5,
    opt_state_dtype="bfloat16",
    sparsity=SparsityConfig(enabled=True, l1_coeff=2e-5),
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
