"""StarCoder2-3B — dense code LM, GQA + RoPE.

[dense] 30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152
[arXiv:2402.19173; hf]

StarCoder2 uses LayerNorm (with bias) and a plain GeLU MLP (d_ff = 4*d),
plus QKV bias — faithful to the HF config.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "starcoder2-3b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    head_dim=128,
    qkv_bias=True,
    act="gelu",
    norm="layernorm",
    rope_theta=999_999.44,
    tie_embeddings=True,
    source="arXiv:2402.19173",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=256,
    )


def matrix_config() -> ModelConfig:
    """Conformance-matrix tiny: the smallest same-family config that
    still exercises every C/R-relevant code path (GQA + biases here),
    sized so a full torture cell compiles and runs in seconds on CPU."""
    return CONFIG.replace(
        name=ARCH_ID + "-matrix",
        n_layers=1,
        d_model=32,
        n_heads=2,
        n_kv_heads=1,
        head_dim=16,
        d_ff=64,
        vocab_size=64,
    )
