"""The distribution decision for one (arch, shape, device) cell — the
port of ``repro.parallel.sharding``'s ``ParallelPlan``, train branch.

The port runs on one device, so a plan carries only what the train
step reads: the remat policy and the number of gradient-accumulation
microbatches. The logical-axis sharding rules, batch and model axes of
the JAX plan wait for multi-device plans (ROADMAP A9).
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ParallelPlan:
    remat: str = "full"                   # none | full
    grad_accum: int = 1
    notes: str = ""

    def with_(self, **kw) -> "ParallelPlan":
        return replace(self, **kw)
