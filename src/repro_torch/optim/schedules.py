"""LR schedules as pure functions of the step counter — the port of
``repro.optim.schedules``.

The arithmetic is float32 tensor math, op for op as the JAX package's
``jnp`` version (Python scalars meet float32 tensors as float32), not
Python doubles: a double-precision schedule would differ from the
reference in the last bits of ``lr`` and, through the update, of every
parameter.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch


@dataclass(frozen=True)
class ScheduleConfig:
    kind: str = "warmup_cosine"     # warmup_cosine | warmup_linear | constant
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_ratio: float = 0.1


def schedule_lr(cfg: ScheduleConfig, step,
                overrides: Dict[str, float] = None) -> torch.Tensor:
    """The learning rate at ``step`` as a 0-d float32 CPU tensor."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.kind == "constant":
        base = torch.tensor(1.0, dtype=torch.float32)
    elif cfg.kind == "warmup_linear":
        frac = torch.clamp((s - cfg.warmup_steps) /
                           max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        base = 1.0 - (1.0 - cfg.min_ratio) * frac
    else:  # warmup_cosine
        frac = torch.clamp((s - cfg.warmup_steps) /
                           max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        base = cfg.min_ratio + (1.0 - cfg.min_ratio) * cos
    lr = cfg.peak_lr * warm * base
    if overrides and "lr_scale" in overrides:
        lr = lr * overrides["lr_scale"]
    return lr
