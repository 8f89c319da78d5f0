"""Synthetic many-client traffic for fleet experiments — the port of
``repro.serving.traffic`` (numpy draws, so a seed gives the same
arrivals in both packages).

A fleet claim ("zero dropped requests during a live move") is only as
strong as the load it was proven under; this generator produces that
load deterministically. Arrivals are Poisson per engine step (the
standard open-loop serving model: clients don't wait for each other),
prompt lengths and token budgets draw uniformly from ranges, and
everything comes from one seeded ``RandomState`` — the same seed
replays the same traffic, which is what lets a migration run be
compared request-by-request against an undisturbed reference run.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class TrafficGenerator:
    """Open-loop Poisson arrivals over a FleetRouter (or any object
    with ``submit(prompt, max_new) -> rid``).

    ``rate``        mean arrivals per ``tick()`` (Poisson lambda).
    ``vocab``       token id range for synthetic prompts (exclusive).
    ``prompt_len``  inclusive (lo, hi) prompt-length range.
    ``max_new``     inclusive (lo, hi) token-budget range.
    ``limit``       total requests to emit (None = unbounded).
    """

    def __init__(self, rate: float, *, seed: int = 0, vocab: int = 32,
                 prompt_len: Tuple[int, int] = (3, 9),
                 max_new: Tuple[int, int] = (4, 12),
                 limit: Optional[int] = None) -> None:
        if rate < 0:
            raise ValueError(f"rate={rate}: arrivals per tick must be "
                             ">= 0")
        self.rate = float(rate)
        self.vocab = int(vocab)
        self.prompt_len = prompt_len
        self.max_new = max_new
        self.limit = limit
        self.rng = np.random.RandomState(seed)
        self.emitted: Dict[int, Dict[str, Any]] = {}   # rid -> shape

    def _draw(self) -> Tuple[np.ndarray, int]:
        plen = int(self.rng.randint(self.prompt_len[0],
                                    self.prompt_len[1] + 1))
        prompt = self.rng.randint(1, self.vocab,
                                  size=plen).astype(np.int32)
        budget = int(self.rng.randint(self.max_new[0],
                                      self.max_new[1] + 1))
        return prompt, budget

    def tick(self, router: Any, *, engine: Optional[str] = None) -> List[int]:
        """One step of arrivals: Poisson-many new requests submitted to
        ``router``; returns their rids."""
        n = int(self.rng.poisson(self.rate))
        if self.limit is not None:
            n = min(n, self.limit - len(self.emitted))
        rids = []
        for _ in range(n):
            prompt, budget = self._draw()
            kw = {"engine": engine} if engine is not None else {}
            rid = router.submit(prompt, budget, **kw)
            self.emitted[rid] = {"prompt": prompt, "max_new": budget}
            rids.append(rid)
        return rids

    def drained(self) -> bool:
        return self.limit is not None and len(self.emitted) >= self.limit
