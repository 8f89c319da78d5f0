"""Qwen1.5-110B — dense LM, GQA with QKV bias.

[dense] 80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064
[hf:Qwen/Qwen1.5-0.5B; hf]
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen1.5-110b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    act="silu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-110B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=256,
    )
