"""Mamba-2 780M — attention-free SSM with SSD (state-space duality).

[ssm] 48L d_model=1536 (attn-free) d_ff=0 vocab=50280, ssm_state=128
[arXiv:2405.21060; unverified]

Each block: in_proj -> (z, x, B, C, dt); short causal conv on (x, B, C);
chunked SSD scan with scalar-per-head decay; gated RMSNorm; out_proj.
d_inner = 2 * d_model, head_dim = 64 -> 48 heads.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "mamba2-780m"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    norm="rmsnorm",
    tie_embeddings=True,
    source="arXiv:2405.21060",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        ssm_state=16,
        ssm_head_dim=16,
        vocab_size=256,
    )


def matrix_config() -> ModelConfig:
    """Conformance-matrix tiny: the SSD scan + conv state path at the
    floor (d_inner=64, 8 heads of 8)."""
    return CONFIG.replace(
        name=ARCH_ID + "-matrix",
        n_layers=1,
        d_model=32,
        ssm_state=8,
        ssm_head_dim=8,
        vocab_size=64,
    )
