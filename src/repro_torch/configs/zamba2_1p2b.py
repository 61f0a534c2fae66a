"""zamba2-1.2b — 38L d_model=2048 (Mamba2 backbone, ssm_state=64) + shared
attention block (32H kv=32) applied periodically, d_ff=8192 vocab=32000.
[arXiv:2411.15242; hf]

Technique applicability: the shared attention block's gated FFN carries the
paper's sparsity recipe; Mamba2 blocks have no (M,N) post-activation hidden
layer, so the technique is inapplicable there (see DESIGN.md §4).
"""
from repro_torch.config import ModelConfig, SparsityConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,                   # mamba2 layers
    d_model=2048,
    num_heads=32,                    # shared attention block
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    shared_attn_every=6,
    rope_theta=1e4,
    sparsity=SparsityConfig(enabled=True, l1_coeff=2e-5),
    source="arXiv:2411.15242; hf",
)
