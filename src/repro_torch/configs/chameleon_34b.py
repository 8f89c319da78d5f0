"""Chameleon-34B — early-fusion VLM decoder, VQ image tokens in the vocab.

[vlm] 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536
[arXiv:2405.09818; unverified]

Early fusion means image patches are VQ-quantized into discrete codes that
live in the same 65536-entry vocabulary as text tokens, so the backbone is
an ordinary dense decoder; the VQ tokenizer frontend is a stub per the
assignment (``input_specs()`` supplies token ids). Chameleon uses qk-norm
for training stability at scale.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "chameleon-34b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    head_dim=128,
    qk_norm=True,
    act="silu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    source="arXiv:2405.09818",
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
