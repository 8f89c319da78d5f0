"""ShardedBackend — the DMTCP-analogue.

DMTCP writes one checkpoint file per rank, coordinated by a central
coordinator that publishes completion. Here: blobs are hashed to N
virtual hosts; each host owns a directory and writes its blobs in
parallel (thread pool standing in for per-host writers); the coordinator
commits the manifest only after every host's writes land — and verifies
that claim at commit time: a manifest referencing a blob no live host
can serve is refused, never published silently partial. Optional peer
replication keeps each blob *also* on host (h+1) % N so a single-host
loss restores without the primary; ``core.replication`` rebuilds a lost
host's directory from those peer copies (``replication.repair``), and
``fail_host``/``heal_host`` here are the failure injection it and the
tests drive.
"""
from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor, wait
from pathlib import Path
from typing import Any, Dict, List, Optional

from repro_torch.api.errors import BackendUnavailable
from repro_torch.core.backends.base import (CheckpointBackend, clean_tmp_under,
                                      write_atomic)


def _host_of(name: str, n_hosts: int) -> int:
    # stable fnv-1a over the blob name
    h = 2166136261
    for ch in name.encode():
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return h % n_hosts


class ShardedBackend(CheckpointBackend):
    def __init__(self, root: str, n_hosts: int = 4, replicate: bool = False,
                 writers: int = 4, *, fsync: bool = True) -> None:
        self.root = Path(root)
        self.n_hosts = n_hosts
        self.replicate = replicate
        self.fsync = fsync
        self._pool = ThreadPoolExecutor(max_workers=writers)
        self._failed_hosts: set = set()  # failure injection for tests
        for h in range(n_hosts):
            (self.root / f"host_{h:03d}").mkdir(parents=True, exist_ok=True)
        (self.root / "coordinator").mkdir(parents=True, exist_ok=True)
        self.clean_tmp()

    # --- failure injection ----------------------------------------------

    def fail_host(self, h: int) -> None:
        self._failed_hosts.add(h)

    def heal_host(self, h: int) -> None:
        self._failed_hosts.discard(h)

    # --- blobs -----------------------------------------------------------

    def _placements(self, name: str) -> List[tuple]:
        """(host, path) for every copy the blob should have, primary
        first — the single definition of the placement/replication
        layout (reads, writes and replication repair all derive from
        it)."""
        h = _host_of(name, self.n_hosts)
        out = [(h, self.root / f"host_{h:03d}" / name)]
        if self.replicate:
            r = (h + 1) % self.n_hosts
            out.append((r, self.root / f"host_{r:03d}" / f"replica_{name}"))
        return out

    def _paths(self, name: str) -> List[Path]:
        return [p for _, p in self._placements(name)]

    def _write(self, path: Path, host: int, data: bytes) -> None:
        if host in self._failed_hosts:
            # the per-host writer is down: the write is LOST, and saying
            # so here is what lets the pipeline abort before the
            # manifest publishes a checkpoint it cannot serve
            raise IOError(f"host {host} down; write of {path.name} lost")
        if path.exists():
            return
        write_atomic(path, data, self.fsync)

    def put_blob(self, name: str, data: bytes) -> None:
        futures = [self._pool.submit(self._write, p, host, data)
                   for host, p in self._placements(name)]
        done, _ = wait(futures)
        for f in done:
            f.result()

    def get_blob(self, name: str) -> bytes:
        errors = []
        for host, p in self._placements(name):
            if host in self._failed_hosts:
                errors.append(f"host {host} down")
                continue
            if p.exists():
                return p.read_bytes()
            errors.append(f"{p} missing")
        raise FileNotFoundError(f"blob {name}: {'; '.join(errors)}")

    def has_blob(self, name: str) -> bool:
        return any(host not in self._failed_hosts and p.exists()
                   for host, p in self._placements(name))

    # --- coordinator manifests --------------------------------------------

    def _manifest_path(self, step: int) -> Path:
        return self.root / "coordinator" / f"step_{step:012d}.json"

    def commit_manifest(self, step: int, manifest: Dict[str, Any]) -> None:
        # the coordinator's completion check, made real: every blob the
        # manifest references must be servable by a live host *now*, or
        # the commit fails loudly instead of publishing a checkpoint
        # whose writes were silently lost (a down host's writer raises
        # in put_blob, but this also catches out-of-band loss between
        # write and commit). Blobs the parent chain link already
        # references were verified at ITS commit and are skipped, so
        # this stat pass is O(this snapshot's writes) — scaling with
        # the change rate like the rest of the dirty-capture pipeline —
        # not O(total checkpoint size). A vanished parent (GC race)
        # falls back to verifying everything.
        from repro_torch.core.delta import referenced_hashes
        from repro_torch.core.replication import verify_restorable
        exclude: set = set()
        base = manifest.get("base_step")
        if base is not None:
            try:
                exclude = referenced_hashes(self.get_manifest(base))
            except FileNotFoundError:
                pass
        missing = verify_restorable(self, manifest, exclude=exclude)
        if missing:
            raise BackendUnavailable(
                f"refusing to commit step {step}: {len(missing)} "
                f"referenced blob(s) unservable (first: {missing[0]})")
        write_atomic(self._manifest_path(step),
                     json.dumps(manifest).encode(), self.fsync)

    def clean_tmp(self, max_age_seconds: float = 3600.0) -> int:
        return clean_tmp_under(self.root, max_age_seconds)

    def get_manifest(self, step: int) -> Dict[str, Any]:
        return json.loads(self._manifest_path(step).read_text())

    def list_steps(self) -> List[int]:
        return sorted(int(p.stem.split("_")[1])
                      for p in (self.root / "coordinator").glob("step_*.json"))

    def delete_step(self, step: int) -> None:
        p = self._manifest_path(step)
        if p.exists():
            p.unlink()

    def gc_blobs(self, referenced: set) -> int:
        n = 0
        for h in range(self.n_hosts):
            for p in (self.root / f"host_{h:03d}").iterdir():
                name = p.name
                if name.startswith("replica_"):
                    name = name[len("replica_"):]
                if name not in referenced:
                    p.unlink()
                    n += 1
        return n
