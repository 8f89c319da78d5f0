"""CachedBackend — a local read-through blob cache over any other store.

``cached:/ssd-path?over=sharded:/remote?hosts=4`` makes restoring from a
slow or remote store just another ``--store`` string: reads hit the
local tier first and fall through to the inner store, warming the cache
on the way back (MANA's transport-agnostic image sourcing, applied to
the content-addressed blob layer). Because blob names are
content-addressed, a cached copy can never go stale — the cache needs no
invalidation protocol, only space.

Division of labor:

* **blobs** are the cached tier. ``get_blob`` serves a local hit
  without touching the inner store; a miss reads through and
  write-through-warms the local copy. ``put_blob`` writes both tiers so
  a snapshot taken through a cached front restores warm.
* **manifests** (and step listing, GC, deletion) always delegate to the
  inner store — publication/visibility must have exactly one source of
  truth, and a manifest read is tiny next to the blobs it references.
* **replication machinery** sees through the front via the ``inner``
  attribute (the replica-scan CLI unwraps it), and the streaming
  restore's fetch fan-out gets both tiers as independent hedgeable
  sources from ``blob_sources`` below — a fetch served by the remote
  store still warms the cache, which is how a streaming restore doubles
  as a cache-priming pass.
"""
from __future__ import annotations

import threading
from pathlib import Path
from typing import Any, Callable, Dict, List, Tuple

from repro_torch.core.backends.base import (CheckpointBackend, clean_tmp_under,
                                      write_atomic)


class CachedBackend(CheckpointBackend):
    def __init__(self, cache_dir: str, inner: CheckpointBackend, *,
                 fsync: bool = False) -> None:
        # local tier is a cache, not the durability story — fsync
        # defaults off (losing it costs re-fetches, never data)
        self.cache_dir = Path(cache_dir)
        self.inner = inner
        self.fsync = fsync
        (self.cache_dir / "blobs").mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self.stats: Dict[str, int] = {"hits": 0, "misses": 0, "warmed": 0}
        self.clean_tmp()

    # --- blobs: local tier first, read-through + warm ------------------

    def _cache_path(self, name: str) -> Path:
        return self.cache_dir / "blobs" / name[:2] / name

    def _warm(self, name: str, data: bytes) -> None:
        p = self._cache_path(name)
        if p.exists():
            return  # content-addressed: identical by construction
        p.parent.mkdir(parents=True, exist_ok=True)
        write_atomic(p, data, self.fsync)
        with self._lock:
            self.stats["warmed"] += 1

    def put_blob(self, name: str, data: bytes) -> None:
        self.inner.put_blob(name, data)   # durability first
        self._warm(name, data)

    def get_blob(self, name: str) -> bytes:
        p = self._cache_path(name)
        try:
            data = p.read_bytes()
        except FileNotFoundError:
            pass
        else:
            with self._lock:
                self.stats["hits"] += 1
            return data
        with self._lock:
            self.stats["misses"] += 1
        data = self.inner.get_blob(name)
        self._warm(name, data)
        return data

    def has_blob(self, name: str) -> bool:
        return self._cache_path(name).exists() or self.inner.has_blob(name)

    def blob_sources(self, name: str) -> List[Tuple[str, Callable[[], bytes]]]:
        """Both tiers as independent fetch sources for the streaming
        restore: the local cache (preferred; raises on a miss so the
        fetcher falls to the next source immediately) and every source
        of the inner store, each wrapped to warm the cache on the way
        through. Hedging a slow remote read against the cache is a
        no-op on a cold cache and a free win on a warm one."""
        from repro_torch.core.replication import blob_sources as inner_sources

        def read_cache() -> bytes:
            data = self._cache_path(name).read_bytes()
            with self._lock:
                self.stats["hits"] += 1
            return data

        out: List[Tuple[str, Callable[[], bytes]]] = [("cache", read_cache)]
        for label, read in inner_sources(self.inner, name):

            def read_and_warm(r=read) -> bytes:
                data = r()
                self._warm(name, data)
                return data

            out.append((label, read_and_warm))
        return out

    # --- everything with one source of truth delegates -----------------

    def commit_manifest(self, step: int, manifest: Dict[str, Any]) -> None:
        self.inner.commit_manifest(step, manifest)

    def get_manifest(self, step: int) -> Dict[str, Any]:
        return self.inner.get_manifest(step)

    def list_steps(self) -> List[int]:
        return self.inner.list_steps()

    def clean_tmp(self, max_age_seconds: float = 3600.0) -> int:
        return (clean_tmp_under(self.cache_dir, max_age_seconds)
                + self.inner.clean_tmp(max_age_seconds))

    def delete_step(self, step: int) -> None:
        self.inner.delete_step(step)

    def gc_blobs(self, referenced: set) -> int:
        n = self.inner.gc_blobs(referenced)
        # keep the cache in lockstep so it never outgrows the store
        for p in (self.cache_dir / "blobs").glob("*/*"):
            if p.name not in referenced:
                p.unlink()
                n += 1
        return n
