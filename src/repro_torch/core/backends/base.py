"""CheckpointBackend ABC — the package-agnostic boundary (paper §II/§V).

Everything above this interface (split halves, op-log, virtual ids, delta
encoding, codecs, the async snapshot pipeline) is shared between
backends, which is the paper's agnosticism claim: the same core ran under
both CRIU and DMTCP. Here the two backends are LocalFSBackend
(CRIU-analogue: one monolithic image directory per checkpoint) and
ShardedBackend (DMTCP-analogue: coordinator manifest + per-host shard
files + optional peer replication).

Commit protocol (crash safety contract every backend must honor):

  1. blobs first — ``put_blob`` writes to a temp file, fsyncs, then
     atomically renames into place. Blob names are content-addressed, so
     a re-write after a crash is idempotent and a partial temp file is
     invisible garbage (swept by ``clean_tmp`` on open).
  2. manifest last — ``commit_manifest`` is the *only* publication
     point: temp write + fsync + rename (+ directory fsync). A
     checkpoint is visible iff its manifest file exists, so a crash at
     any earlier instant leaves the previous checkpoint as "latest",
     never a torn one.

Blob writes fan out: the async pipeline's writer pool issues many
concurrent ``put_blob`` calls per snapshot (and ShardedBackend further
fans each one to per-host writers + replicas), so implementations must
be thread-safe.
"""
from __future__ import annotations

import abc
import os
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Optional


def fsync_dir(d: Path) -> None:
    """Make a rename durable: fsync the directory holding the entry."""
    fd = os.open(d, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_atomic(path: Path, data: bytes, fsync: bool) -> None:
    """The commit-protocol write: temp file in the target directory,
    optional fsync, atomic rename, optional directory fsync; the temp
    file is unlinked on any failure. Both backends publish blobs and
    manifests through this one helper so durability fixes land once."""
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.rename(tmp, path)
        if fsync:
            fsync_dir(path.parent)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def clean_tmp_under(root: Path, max_age_seconds: float) -> int:
    """Sweep stale temp files under `root` (see clean_tmp contract)."""
    import time
    cutoff = time.time() - max_age_seconds
    n = 0
    for p in root.rglob(".tmp*"):
        try:
            if p.stat().st_mtime < cutoff:
                p.unlink()
                n += 1
        except FileNotFoundError:  # racing writer finished/cleaned it
            pass
    return n


class CheckpointBackend(abc.ABC):
    @abc.abstractmethod
    def put_blob(self, name: str, data: bytes) -> None:
        """Durably store a blob (idempotent by name; content-addressed
        names). Must be safe to call concurrently from many threads."""

    @abc.abstractmethod
    def get_blob(self, name: str) -> bytes:
        ...

    @abc.abstractmethod
    def has_blob(self, name: str) -> bool:
        ...

    @abc.abstractmethod
    def commit_manifest(self, step: int, manifest: Dict[str, Any]) -> None:
        """Atomically publish a checkpoint at `step` (fsync + rename).
        Must only be called after every blob the manifest references is
        durable; partial blob writes are harmless garbage."""

    @abc.abstractmethod
    def get_manifest(self, step: int) -> Dict[str, Any]:
        ...

    @abc.abstractmethod
    def list_steps(self) -> List[int]:
        ...

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return max(steps) if steps else None

    def clean_tmp(self, max_age_seconds: float = 3600.0) -> int:
        """Sweep temp files left by a crashed writer; returns count.
        Called on open. Only files older than ``max_age_seconds`` are
        removed: another live process may have in-flight writes in the
        same root, and unlinking a fresh temp file would break its
        rename. A no-op for backends without temp files."""
        return 0

    @abc.abstractmethod
    def delete_step(self, step: int) -> None:
        """Remove a manifest (blob GC handled separately)."""

    @abc.abstractmethod
    def gc_blobs(self, referenced: set) -> int:
        """Delete blobs not in `referenced`; returns count removed."""
