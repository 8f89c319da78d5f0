"""Whisper-base — encoder-decoder audio model; conv frontend stubbed.

[audio] 6L d_model=512 8H (GQA kv=8) d_ff=2048 vocab=51865
[arXiv:2212.04356; unverified]

Backbone only per the assignment: the log-mel + conv frontend is a stub;
``input_specs()`` supplies precomputed frame embeddings (1500 frames x
d_model) to the encoder. 6 encoder + 6 decoder layers, MHA (kv=8 == 8H),
LayerNorm + GeLU, learned positions approximated with RoPE-free absolute
embeddings folded into the stub.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "whisper-base"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="audio",
    n_layers=6,               # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    head_dim=64,
    is_encoder_decoder=True,
    n_encoder_layers=6,
    encoder_seq=1500,
    frontend_dim=512,
    act="gelu",
    norm="layernorm",
    tie_embeddings=True,
    source="arXiv:2212.04356",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        n_encoder_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        encoder_seq=24,
        frontend_dim=64,
    )


def matrix_config() -> ModelConfig:
    """Conformance-matrix tiny: one encoder + one decoder layer keeps
    the cross-attention cache (the enc-dec-specific C/R payload) in
    every matrix cell."""
    return CONFIG.replace(
        name=ARCH_ID + "-matrix",
        n_layers=1,
        n_encoder_layers=1,
        d_model=32,
        n_heads=2,
        n_kv_heads=2,
        head_dim=16,
        d_ff=64,
        vocab_size=64,
        encoder_seq=8,
        frontend_dim=32,
    )
