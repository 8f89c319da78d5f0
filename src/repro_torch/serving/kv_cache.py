"""Decode-state allocation (KV caches, SSM states, RG-LRU states) — the
port of ``repro.serving.kv_cache``.

Caches are lower-half resources: allocated through the logged runtime
API (CacheAlloc), referenced by virtual ids, re-allocated fresh at
restore by replay. For *serving* restores the cache contents are also
checkpointed as an upper-half entry (they are semantic: the
conversation's context) — see ``ServingEngine.session_state``.
"""
from __future__ import annotations

from typing import Any

from repro_torch.configs import registry as cfg_registry
from repro_torch.models import model as M


def allocate_cache(arch: str, batch: int, max_seq: int, lower) -> Any:
    """An empty cache on the lower half's device (CacheAlloc)."""
    cfg = cfg_registry.resolve_config(arch)
    return M.init_cache(cfg, batch, max_seq, device=lower.mesh)
