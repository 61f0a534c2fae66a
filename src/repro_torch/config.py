"""Configuration system for the sparse-LLM framework.

The PyTorch port's copy of ``src/repro/config.py``, field for field (the
tests compare the two), so the port imports nothing of the JAX package.
Plain frozen dataclasses (no external deps). One ``ModelConfig`` covers all
ten assigned architecture families via optional fields; ``family`` selects
the model code. ``ShapeConfig`` describes the assigned input-shape cells.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class SparsityConfig:
    """The paper's technique (Sec. 2.2 + Sec. 3) as a first-class feature."""

    enabled: bool = True
    l1_coeff: float = 2e-5          # recommended conservative value (Sec. 4.2)
    activation: str = "relu"        # relu | silu | relu2 (rwkv channel-mix)
    # ---- TwELL (inference) --------------------------------------------------
    twell_tile: int = 256           # T == T_n of the gate matmul (Sec. 3.2)
    twell_c: int = 8                # compression ratio C (App. A: C=8 recommended)
    # ---- hybrid (training) --------------------------------------------------
    ell_width: int = 128            # N_nz-hat (App. B.2.1: 128 robust above 1.5e-5)
    dense_backup_frac: float = 0.125  # backup rows = M/8 (App. B.2.1)
    # ---- execution strategy -------------------------------------------------
    ffn_impl: str = "dense"         # dense | tile_skip | gather | hybrid
    # tile_skip only: drop (row x hidden-tile) blocks whose max |gate
    # activation| is below this value. 0.0 = lossless (skip exact-zero tiles
    # only). >0 trades accuracy for sparsity — the cheap "draft" regime that
    # self-speculative decoding pairs with the exact gather/TwELL verifier.
    tile_skip_threshold: float = 0.0
    # ---- induction schedule / mitigation (App. C.3) ------------------------
    l1_warmup_steps: int = 0        # 0 = constant coefficient (paper default)
    l1_constant_steps: int = 0      # steps at 0 before linear warmup
    dead_reinit: bool = False       # targeted reinitialization, Eq. 6
    dead_reinit_lambda: float = 0.1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    gated: bool = True              # gated (Eq. 1) vs non-gated (Eq. 5, App. C.2)
    norm: str = "rmsnorm"           # rmsnorm | layernorm | nonparametric_ln (olmo)
    rope_theta: float = 10_000.0
    tied_embeddings: bool = False
    vocab_pad_multiple: int = 128   # pad vocab so TP sharding divides
    # ---- attention variants -------------------------------------------------
    window: int = 0                 # sliding-window attention width (mixtral)
    attn_chunk: int = 0             # chunked local attention (llama4 iRoPE-style)
    # ---- MoE -----------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # ---- SSM (mamba2 / zamba2) ----------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    shared_attn_every: int = 0      # zamba2: shared attention block period
    # ---- RWKV ----------------------------------------------------------------
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 0             # 0 = per-token scan; >0 = chunked WKV
    # ---- encoder-decoder (whisper) / vlm ------------------------------------
    encoder_layers: int = 0
    cross_every: int = 0            # vlm: cross-attention layer period
    num_image_tokens: int = 1024    # vlm patch-embedding stub length
    # ---- serving -------------------------------------------------------------
    # Paged-attention backend for the serving engine (see
    # repro/serving/attention.py): "ref" = gather-pages SDPA in plain JAX
    # (the numerics reference), "pallas" = fused paged Pallas kernels (TPU),
    # "interpret" = the same kernels in Pallas interpret mode (CPU CI).
    attn_backend: str = "ref"
    # ---- numerics / memory ---------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"   # bf16 for the very large archs
    remat: str = "full"             # none | full | dots | 2level
    # ---- technique -----------------------------------------------------------
    sparsity: SparsityConfig = field(default_factory=SparsityConfig)
    # ---- provenance ----------------------------------------------------------
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            num_layers=min(self.num_layers, 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads else 0,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            vocab_pad_multiple=8,
            dtype="float32",
            param_dtype="float32",
            remat="none",
        )
        if self.num_experts:
            small.update(num_experts=min(self.num_experts, 4), top_k=min(self.top_k, 2))
        if self.ssm_state:
            small.update(ssm_state=16, ssm_head_dim=16)
        if self.encoder_layers:
            small.update(encoder_layers=2)
        if self.window:
            small.update(window=32)
        if self.attn_chunk:
            small.update(attn_chunk=32)
        if self.shared_attn_every:
            small.update(shared_attn_every=2)
        if self.cross_every:
            small.update(cross_every=2, num_image_tokens=8)
        if self.rwkv_head_dim and self.family == "ssm":
            small.update(rwkv_head_dim=16)
        small.update(overrides)
        new = replace(self, **small)
        # scale the sparse-format geometry to the reduced hidden size
        d_ff = new.d_ff
        tile = min(self.sparsity.twell_tile, d_ff)
        while d_ff % tile:
            tile //= 2
        return replace(new, sparsity=replace(
            self.sparsity, twell_tile=tile,
            twell_c=min(self.sparsity.twell_c, max(tile // 8, 1)),
            ell_width=min(self.sparsity.ell_width, max(d_ff // 4, 8))))


@dataclass(frozen=True)
class ShapeConfig:
    name: str                       # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


@dataclass(frozen=True)
class TrainConfig:
    """Paper training recipe (App. B, Table 2)."""

    learning_rate: float = 1e-3
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 600
    total_steps: int = 10_000
    max_grad_norm: float = 1.0
    seed: int = 0
    microbatch: int = 0             # 0 = no gradient accumulation
    grad_accum_dtype: str = "float32"  # bf16 saves accumulator memory at scale
    # fault tolerance
    checkpoint_every: int = 200
    keep_checkpoints: int = 3
    checkpoint_dir: str = "/tmp/repro_ckpt"
    async_checkpoint: bool = True
    # distributed extras
    grad_compression: str = "none"  # none | int8 | topk
    grad_compression_topk: float = 0.01


def shape_by_name(name: str) -> ShapeConfig:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; have {[s.name for s in LM_SHAPES]}")


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)
