"""Griffin/RecurrentGemma blocks: the RG-LRU gated linear recurrence and
local attention in a repeating pattern (rglru, rglru, attn) — the port
of ``repro.models.hybrid``.

Prefill runs the recurrence over the whole sequence through ``rg_lru``:
on a CUDA tensor the hand-written kernel of ``kernels/rg_lru``, with no
option; on a CPU tensor its plain version (the JAX package takes
``jax.lax.associative_scan``; both compute the same recurrence in f32).
Decode is the O(1) step ``rg_lru_step``. The gates are per channel, as in
the JAX package (its documented simplification of RecurrentGemma's
block-diagonal gate projections). Paths, shapes, dtypes and the
arithmetic around the recurrence follow the JAX module step for step.
One deliberate difference: a block returns its new decode state and the
caller writes it into its cache in place (the attention block's KV
cache is written in place by ``layers.attention_forward``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.host import torch_dtype
from repro_torch.kernels.rg_lru import ops as rg_ops
from repro_torch.kernels.rg_lru.ref import gates
from repro_torch.models.layers import (apply_norm, attention_forward,
                                       attention_template, mlp_forward,
                                       mlp_template, norm_template)
from repro_torch.models.params import P

CONV_WIDTH = 4


def rglru_block_template(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    w = cfg.rglru_width or d
    cw = CONV_WIDTH
    return {
        "norm": norm_template(cfg),
        "w_x": P((d, w), ("embed", "ff"), fan_in=d),
        "w_gate_branch": P((d, w), ("embed", "ff"), fan_in=d),
        "conv_w": P((cw, w), (None, "ff"), init="scaled", fan_in=cw),
        "conv_b": P((w,), ("ff",), init="zeros"),
        "rg_lambda": P((w,), ("ff",), init="rglru_a", dtype="float32"),
        "gate_a_w": P((w,), ("ff",), init="normal", fan_in=1, scale=0.1,
                      dtype="float32"),
        "gate_a_b": P((w,), ("ff",), init="zeros", dtype="float32"),
        "gate_x_w": P((w,), ("ff",), init="normal", fan_in=1, scale=0.1,
                      dtype="float32"),
        "gate_x_b": P((w,), ("ff",), init="zeros", dtype="float32"),
        "w_out": P((w, d), ("ff", "embed"), fan_in=w),
        "mlp_norm": norm_template(cfg),
        "mlp": mlp_template(cfg),
    }


def attn_block_template(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "norm": norm_template(cfg),
        "attn": attention_template(cfg),
        "mlp_norm": norm_template(cfg),
        "mlp": mlp_template(cfg),
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: [B,S,W]; w: [cw,W]; state: the previous
    cw-1 inputs [B,cw-1,W] or None (zeros). Returns (y, new_state)."""
    cw = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, cw - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * w[i] for i in range(cw))
    new_state = xp[:, xp.shape[1] - (cw - 1):]
    return y + b, new_state


def rg_lru(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
           lam: torch.Tensor, h0: Optional[torch.Tensor] = None):
    """The RG-LRU recurrence. x, r, i: [B,S,W] f32; lam: [W]; h0: [B,W]
    or None. Returns (h [B,S,W], h_last [B,W])."""
    h = rg_ops.rg_lru_fwd(x, r, i, lam, h0)
    return h, h[:, -1]


def rg_lru_step(x, r, i, lam, h_prev):
    """One decode step. x, r, i: [B,1,W]; h_prev: [B,W]."""
    log_a, gate = gates(r[:, 0], lam)
    h = torch.exp(log_a) * h_prev + gate * (i[:, 0] * x[:, 0])
    return h[:, None], h


def rglru_block_forward(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                        x: torch.Tensor,
                        cache: Optional[Dict[str, torch.Tensor]] = None):
    """Recurrent mixer + MLP, both residual. x: [B,S,D]. Returns (x,
    new_cache or None)."""
    B, S, D = x.shape
    h = apply_norm(cfg, p["norm"], x)
    xb = h @ p["w_x"]                                   # [B,S,W]
    gb = F.gelu(h @ p["w_gate_branch"], approximate="tanh")

    conv_state = cache["conv"] if cache is not None else None
    xc, new_conv = _causal_conv1d(xb, p["conv_w"], p["conv_b"], conv_state)

    xf = xc.to(torch.float32)
    r = torch.sigmoid(xf * p["gate_a_w"] + p["gate_a_b"])
    ig = torch.sigmoid(xf * p["gate_x_w"] + p["gate_x_b"])

    if cache is not None and S == 1:
        y, h_last = rg_lru_step(xf, r, ig, p["rg_lambda"], cache["state"])
    else:
        h0 = cache["state"] if cache is not None else None
        y, h_last = rg_lru(xf, r, ig, p["rg_lambda"], h0)

    y = (y.to(x.dtype) * gb) @ p["w_out"]
    x = x + y
    x = x + mlp_forward(cfg, p["mlp"], apply_norm(cfg, p["mlp_norm"], x))

    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv, "state": h_last}
    return x, new_cache


def attn_block_forward(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                       x: torch.Tensor, positions: torch.Tensor,
                       cache: Optional[Dict[str, torch.Tensor]] = None
                       ) -> torch.Tensor:
    """Local (windowed) attention + MLP, both residual; a given KV
    ``cache`` is written in place."""
    h = apply_norm(cfg, p["norm"], x)
    x = x + attention_forward(cfg, p["attn"], h, positions,
                              window=cfg.attn_window, cache=cache)
    return x + mlp_forward(cfg, p["mlp"], apply_norm(cfg, p["mlp_norm"], x))


def rglru_cache_spec(cfg: ModelConfig, batch: int):
    """(shape, dtype) of one RG-LRU block's decode state: the conv
    window in the model dtype and the f32 recurrent state."""
    w = cfg.rglru_width or cfg.d_model
    return {
        "conv": ((batch, CONV_WIDTH - 1, w), torch_dtype(cfg.dtype)),
        "state": ((batch, w), torch.float32),
    }
