"""RecurrentGemma-9B (Griffin) — RG-LRU + local attention, 2:1 pattern.

[hybrid] 38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000
[arXiv:2402.19427; unverified]

Block pattern (recurrent, recurrent, local-attention) repeated; 38 layers
= 12 full groups + 2 trailing recurrent blocks. Local attention window
2048, MQA (kv=1). GeGLU MLP per the Griffin paper.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "recurrentgemma-9b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    attn_window=2048,
    block_pattern=("rglru", "rglru", "attn"),
    rglru_width=4096,
    act="gelu_glu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    attn_logit_softcap=0.0,
    tie_embeddings=True,
    source="arXiv:2402.19427",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name=ARCH_ID + "-smoke",
        n_layers=5,  # exercises remainder handling (5 = 1 group + 2)
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_window=32,
        rglru_width=64,
    )


def matrix_config() -> ModelConfig:
    """Conformance-matrix tiny: one full (rglru, rglru, attn) group so
    both block kinds (RG-LRU recurrence + windowed attention) sit in
    every checkpoint cell."""
    return CONFIG.replace(
        name=ARCH_ID + "-matrix",
        n_layers=3,
        d_model=32,
        n_heads=2,
        n_kv_heads=1,
        head_dim=16,
        d_ff=64,
        vocab_size=64,
        attn_window=8,
        rglru_width=32,
    )
