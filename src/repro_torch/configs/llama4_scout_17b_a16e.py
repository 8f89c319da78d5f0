"""Llama-4 Scout — 17B-active, 16-expert MoE with early fusion.

[moe] 48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048,
MoE 16e top-1  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Top-1 routed expert + one always-on shared expert per Llama-4's design.
The vision frontend is a stub per the assignment (early-fusion patch
embeddings are precomputed in ``input_specs``).
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "llama4-scout-17b-a16e"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    n_experts=16,
    experts_per_token=1,
    n_shared_experts=1,
    act="silu",
    norm="rmsnorm",
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=64,
        vocab_size=256,
        n_experts=4,
        experts_per_token=1,
        n_shared_experts=1,
    )


def matrix_config() -> ModelConfig:
    """Conformance-matrix tiny: top-1 routing + shared expert kept (the
    MoE C/R surface), everything else at the floor."""
    return CONFIG.replace(
        name=ARCH_ID + "-matrix",
        n_layers=1,
        d_model=32,
        n_heads=2,
        n_kv_heads=1,
        head_dim=16,
        d_ff=32,
        vocab_size=64,
        n_experts=2,
        experts_per_token=1,
        n_shared_experts=1,
    )
