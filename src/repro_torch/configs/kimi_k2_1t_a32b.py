"""Kimi K2 — trillion-parameter MoE, 32B active.

[moe] 61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840,
MoE 384e top-8  [arXiv:2501.kimi2; unverified]

Per the assignment table the attention is GQA (kv=8). d_ff=2048 is the
per-expert hidden dim; one DeepSeek-V3-style shared expert per layer.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "kimi-k2-1t-a32b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,           # per-expert hidden (moe_d_ff defaults to d_ff)
    vocab_size=163840,
    head_dim=112,        # 7168 / 64
    n_experts=384,
    experts_per_token=8,
    n_shared_experts=1,
    act="silu",
    norm="rmsnorm",
    rope_theta=50_000.0,
    source="arXiv:2501.kimi2",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=32,
        vocab_size=256,
        n_experts=8,
        experts_per_token=2,
        n_shared_experts=1,
    )


def matrix_config() -> ModelConfig:
    """Conformance-matrix tiny: keeps top-k>1 routing (the second MoE
    row of the matrix — llama4 covers top-1), floor everything else."""
    return CONFIG.replace(
        name=ARCH_ID + "-matrix",
        n_layers=1,
        d_model=32,
        n_heads=2,
        n_kv_heads=1,
        head_dim=16,
        d_ff=16,
        vocab_size=64,
        n_experts=4,
        experts_per_token=2,
        n_shared_experts=1,
    )
