"""Phi-4-mini 3.8B — dense LM, RoPE + SwiGLU + GQA.

[dense] 32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064
[arXiv:2412.08905; hf]
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "phi4-mini-3.8b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    head_dim=128,
    act="silu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="arXiv:2412.08905",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
    )
