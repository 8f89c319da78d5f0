"""Training planner for one device — the port of the train branch of
``repro.parallel.planner``: choose remat and gradient accumulation from
an analytic memory estimate against the device's budget.

The estimate is the reference's, term for term, for a mesh of one
device (no tensor, data or sequence sharding): params, two optimizer
moments at ``moments_bytes`` each (1: int8 block-quantized, the
reference's default — ROADMAP C9 notes that AdamW keeps f32 moments
below 5e10 params), a gradient accumulator when accumulating, and
activations under full remat (one residual per layer boundary plus 3x
the logits). The budget is 0.9 x the device's memory:
``total_memory`` of the CUDA card, or the JAX package's TPU v5e
constant (16 GiB) on the CPU, so plans made in the CPU tests equal the
reference's. Serving plans wait for ROADMAP A9; of the serving
estimate only the ssm and hybrid branches (params, the decode state,
activations) are here. The hybrid's params come from
``ModelConfig.n_params()``, which counts 6,611,185,664 for
recurrentgemma-9b against 8,524,206,080 template leaves (ROADMAP); the
estimate keeps the reference's count.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.parallel.sharding import ParallelPlan

HBM_BYTES = 16 * 1024**3       # the reference's per-chip budget (TPU v5e)


def _bytes_per_param(dtype: str = "bfloat16") -> int:
    return 2 if "16" in dtype else 4


def device_budget(device: Optional[torch.device] = None) -> float:
    """0.9 x the memory of ``device`` (the CPU: the reference's 16 GiB)."""
    if device is not None and torch.device(device).type == "cuda":
        return 0.9 * torch.cuda.get_device_properties(device).total_memory
    return 0.9 * HBM_BYTES


@dataclass
class MemoryEstimate:
    params: float
    opt_state: float            # moments, plus the accumulator if any
    activations: float
    total: float
    kv_cache: float = 0.0       # serving: the decode state

    def fits(self, budget: float = 0.9 * HBM_BYTES) -> bool:
        return self.total < budget


def estimate_train_memory(cfg: ModelConfig, shape: ShapeConfig,
                          grad_accum: int,
                          moments_bytes: int = 1) -> MemoryEstimate:
    """Bytes on the one device (see the module docstring)."""
    n = cfg.n_params()
    bp = _bytes_per_param(cfg.dtype)
    params = n * bp
    opt = n * (2 * moments_bytes)
    grads = n * bp if grad_accum > 1 else 0.0
    toks = shape.global_batch / grad_accum * shape.seq_len
    resid = toks * cfg.d_model * bp
    depth = cfg.n_layers + (cfg.n_encoder_layers or 0)
    acts = resid * (depth + 2) + toks * cfg.vocab_size * bp * 3
    total = params + opt + grads + acts
    return MemoryEstimate(params, opt + grads, acts, total)


def estimate_serve_memory(cfg: ModelConfig,
                          shape: ShapeConfig) -> MemoryEstimate:
    """Bytes of an ssm or hybrid serving cell on the one device — those
    branches of the reference's ``estimate_serve_memory`` with no
    sharding: params, the decode state and activations. The ssm state is
    the f32 scan state plus the conv windows; the hybrid's, the windowed
    KV caches of its attention layers plus each recurrent layer's f32
    state and conv window. The other families wait for ROADMAP A9."""
    if cfg.family not in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the port estimates serving memory for the ssm "
            "and hybrid families only; the rest waits for ROADMAP A9")
    n = cfg.n_params()
    bp = _bytes_per_param(cfg.dtype)
    params = n * bp
    b_eff = max(shape.global_batch, 1)
    if cfg.family == "ssm":
        d_in = cfg.ssm_expand * cfg.d_model
        nh = d_in // cfg.ssm_head_dim
        per_layer = b_eff * (nh * cfg.ssm_head_dim * cfg.ssm_state * 4
                             + 3 * d_in * bp)
        cache = per_layer * cfg.n_layers
    else:
        w = cfg.rglru_width or cfg.d_model
        period = len(cfg.block_pattern)
        n_attn = sum(1 for i in range(cfg.n_layers)
                     if cfg.block_pattern[i % period] == "attn")
        n_rec = cfg.n_layers - n_attn
        win = min(cfg.attn_window or shape.seq_len, shape.seq_len)
        kv = b_eff * win * cfg.n_kv_heads * cfg.resolved_head_dim * 2 * bp
        cache = n_attn * kv + n_rec * b_eff * w * (4 + 3 * bp)
    acts = b_eff * max(shape.seq_len if shape.kind == "prefill" else 1, 1) \
        * cfg.d_model * bp * 4
    return MemoryEstimate(params, 0.0, acts, params + cache + acts, cache)


def make_plan(cfg: ModelConfig, shape: ShapeConfig,
              device: Optional[torch.device] = None) -> ParallelPlan:
    """Escalating search over gradient accumulation 1 -> 4 -> 16 for a
    plan whose estimate fits the device's budget."""
    if shape.kind != "train":
        raise NotImplementedError(
            f"{shape.name}: the port plans training only; serving plans "
            "wait for ROADMAP A9")
    budget = device_budget(device)
    est1 = estimate_train_memory(cfg, shape, 1)
    static = est1.params + est1.opt_state
    if static > budget:
        return ParallelPlan(
            remat="full", grad_accum=1,
            notes=f"train OVERBUDGET static={static / 2**30:.1f}GiB "
                  f"est={est1.total / 2**30:.1f}GiB (params+opt exceed "
                  "the device; accumulation would not help)")
    for accum in (1, 4, 16):
        est = estimate_train_memory(cfg, shape, accum)
        if est.fits(budget):
            return ParallelPlan(
                remat="full", grad_accum=accum,
                notes=f"train accum={accum} est={est.total / 2**30:.1f}GiB")
    est = estimate_train_memory(cfg, shape, 16)
    return ParallelPlan(
        remat="full", grad_accum=16,
        notes=f"train OVERBUDGET est={est.total / 2**30:.1f}GiB")
