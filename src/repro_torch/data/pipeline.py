"""Deterministic, seekable, checkpointable data pipeline.

The pipeline's *logical position* is a single integer cursor (global batch
index) — upper-half state. Batches are generated content-addressed from
(seed, cursor, shard): a counter-based Philox PRNG gives O(1) seek, so
restore fast-forwards by just setting the cursor (no replaying gigabytes
of input), and straggler-driven shard reassignment (DataReassign op)
changes only *which host materializes which rows*, never the bytes.

This stands in for a real corpus reader; the interface (batch_at /
host_slice / cursor) is what the C/R layer needs, and a file-backed
implementation would keep it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    vocab_size: int = 32000
    seq_len: int = 128
    global_batch: int = 8
    n_shards: int = 1            # host-level shards of the batch
    frames: int = 0              # >0: also emit encoder frames (enc-dec)
    frame_dim: int = 0


class TokenPipeline:
    def __init__(self, cfg: DataConfig,
                 assignment: Optional[List[Tuple[int, int]]] = None) -> None:
        assert cfg.global_batch % cfg.n_shards == 0
        self.cfg = cfg
        # host -> owned shards (straggler rebalancing rewrites this)
        self.assignment = assignment or [(h, h) for h in range(cfg.n_shards)]

    # --- deterministic generation ---------------------------------------

    def _rng(self, cursor: int, shard: int) -> np.random.Generator:
        bits = np.random.Philox(key=self.cfg.seed,
                                counter=[0, 0, cursor, shard])
        return np.random.Generator(bits)

    def _shard_batch(self, cursor: int, shard: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rows = c.global_batch // c.n_shards
        rng = self._rng(cursor, shard)
        # documents: zipf-ish token stream with eos resets (deterministic)
        toks = rng.integers(0, c.vocab_size, size=(rows, c.seq_len + 1),
                            dtype=np.int64).astype(np.int32)
        out = {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:],
        }
        if c.frames:
            out["frames"] = rng.standard_normal(
                (rows, c.frames, c.frame_dim), dtype=np.float32)
        return out

    # --- public API -------------------------------------------------------

    def batch_at(self, cursor: int) -> Dict[str, np.ndarray]:
        """Full global batch (single-controller path)."""
        shards = [self._shard_batch(cursor, s)
                  for s in range(self.cfg.n_shards)]
        return {k: np.concatenate([s[k] for s in shards], axis=0)
                for k in shards[0]}

    def host_slice(self, cursor: int, host: int) -> Dict[str, np.ndarray]:
        """Rows this host materializes under the current assignment."""
        owned = sorted(s for h, s in self.assignment if h == host)
        shards = [self._shard_batch(cursor, s) for s in owned]
        if not shards:
            return {}
        return {k: np.concatenate([s[k] for s in shards], axis=0)
                for k in shards[0]}

    def reassign(self, assignment: List[Tuple[int, int]]) -> None:
        self.assignment = list(assignment)

    def spec(self) -> Dict[str, tuple]:
        c = self.cfg
        out = {"tokens": ((c.global_batch, c.seq_len), np.int32),
               "targets": ((c.global_batch, c.seq_len), np.int32)}
        if c.frames:
            out["frames"] = ((c.global_batch, c.frames, c.frame_dim),
                             np.float32)
        return out
