"""Configuration dataclasses for the model zoo and input shapes.

Every assigned architecture gets one module in this package defining a
``CONFIG: ModelConfig`` at the exact published dimensions plus a
``smoke_config()`` returning a reduced same-family config for CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters.

    A single config class covers all five families (dense / moe / ssm /
    hybrid / enc-dec); family-specific fields default to "off".
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- attention flavor ---
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_window: int = 0          # 0 = full attention; >0 = local window
    attn_logit_softcap: float = 0.0

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0             # per-expert hidden dim (0 -> d_ff)
    router_aux_loss: float = 0.01
    capacity_factor: float = 1.25

    # --- SSM (mamba2) ---
    ssm_state: int = 0            # d_state; >0 enables SSD blocks
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4

    # --- hybrid (recurrentgemma) ---
    # period pattern of block kinds, e.g. ("rglru", "rglru", "attn")
    block_pattern: tuple = ()
    rglru_width: int = 0          # recurrent width (0 -> d_model)

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0          # fixed encoder frames (stub frontend)
    frontend_dim: int = 0         # dim of precomputed frame/patch embeddings

    # --- norm / activation / embedding ---
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    norm_eps: float = 1e-6
    act: str = "silu"             # silu (SwiGLU) | gelu (plain MLP)
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # --- provenance ---
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can serve 500k-token contexts without a full
        O(seq) dense KV cache per layer (SSM state / windowed attention)."""
        if self.family == "ssm":
            return True
        if self.family == "hybrid" and self.attn_window > 0:
            return True
        return False

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def n_params(self) -> int:
        """Analytic total parameter count (embeddings included)."""
        h = self.resolved_head_dim
        d = self.d_model
        attn = d * (self.n_heads * h) * 2 + d * (self.n_kv_heads * h) * 2 \
            if self.n_heads else 0
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * h
        gated = self.act == "silu"
        per_ff = lambda dff: d * dff * (3 if gated else 2)
        total = 0
        if self.family == "ssm":
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_head_dim
            # in_proj -> (z,x,B,C,dt), conv(x,B,C), out_proj
            conv_dim = d_in + 2 * self.ssm_state
            per_layer = (
                d * (2 * d_in + 2 * self.ssm_state + nh)
                + conv_dim * self.ssm_conv_width
                + d_in * d
                + 2 * nh  # A_log, D
                + 2 * d   # norms
            )
            total += per_layer * self.n_layers
        elif self.family == "hybrid":
            per = len(self.block_pattern)
            w = self.rglru_width or d
            # in-proj x2 + out-proj + conv/gates/lambda (per-channel)
            rglru_layer = 3 * d * w + 9 * w + per_ff(self.d_ff)
            attn_layer = attn + per_ff(self.d_ff)
            n_r = sum(1 for b in self.block_pattern if b == "rglru")
            groups, rem = divmod(self.n_layers, per)
            n_rg = groups * n_r + sum(
                1 for b in self.block_pattern[:rem] if b == "rglru")
            n_at = self.n_layers - n_rg
            total += n_rg * rglru_layer + n_at * attn_layer
        else:
            per_layer = attn
            if self.n_experts:
                per_layer += self.n_experts * per_ff(self.resolved_moe_d_ff)
                per_layer += self.n_shared_experts * per_ff(self.resolved_moe_d_ff)
                per_layer += d * self.n_experts  # router
            else:
                per_layer += per_ff(self.d_ff)
            per_layer += 2 * d  # norms
            total += per_layer * self.n_layers
            if self.is_encoder_decoder:
                # encoder self-attn + ff, decoder adds cross-attn
                enc_layer = attn + per_ff(self.d_ff) + 2 * d
                total += enc_layer * self.n_encoder_layers
                total += attn * self.n_layers  # cross-attention
        emb = self.vocab_size * d
        total += emb if self.tie_embeddings else 2 * emb
        total += d  # final norm
        return int(total)

    def n_active_params(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if not self.n_experts:
            return self.n_params()
        gated = self.act == "silu"
        per_ff = self.d_model * self.resolved_moe_d_ff * (3 if gated else 2)
        dead = (self.n_experts - self.experts_per_token) * per_ff * self.n_layers
        return int(self.n_params() - dead)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: what gets lowered for the dry-run."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


# The assigned LM-family shape set (identical across archs).
TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shapes_for(config: ModelConfig) -> tuple:
    """Applicable shape cells for an arch (long_500k needs sub-quadratic
    sequence handling; skip documented in DESIGN.md §7)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if config.sub_quadratic:
        out.append(LONG_500K)
    return tuple(out)
