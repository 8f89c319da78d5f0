"""LocalFSBackend — the CRIU-analogue.

One image directory; blobs under blobs/ (content-addressed, shared across
steps, which is what makes delta checkpoints cheap); blobs and manifests
both follow the temp-write + fsync + atomic-rename commit protocol of
``backends.base`` — the equivalent of CRIU's complete-image-or-nothing
semantics. Stale ``.tmp`` files from a crashed writer are swept on open.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List

from repro_torch.core.backends.base import (CheckpointBackend, clean_tmp_under,
                                      write_atomic)


class LocalFSBackend(CheckpointBackend):
    def __init__(self, root: str, *, fsync: bool = True) -> None:
        self.root = Path(root)
        self.fsync = fsync
        (self.root / "blobs").mkdir(parents=True, exist_ok=True)
        (self.root / "manifests").mkdir(parents=True, exist_ok=True)
        self.clean_tmp()

    # --- blobs ---------------------------------------------------------

    def _blob_path(self, name: str) -> Path:
        # two-level fanout to keep directories small at scale
        return self.root / "blobs" / name[:2] / name

    def put_blob(self, name: str, data: bytes) -> None:
        p = self._blob_path(name)
        if p.exists():
            return  # content-addressed: identical by construction
        p.parent.mkdir(parents=True, exist_ok=True)
        write_atomic(p, data, self.fsync)

    def get_blob(self, name: str) -> bytes:
        return self._blob_path(name).read_bytes()

    def has_blob(self, name: str) -> bool:
        return self._blob_path(name).exists()

    # --- manifests -----------------------------------------------------

    def _manifest_path(self, step: int) -> Path:
        return self.root / "manifests" / f"step_{step:012d}.json"

    def commit_manifest(self, step: int, manifest: Dict[str, Any]) -> None:
        write_atomic(self._manifest_path(step),
                     json.dumps(manifest).encode(), self.fsync)

    def get_manifest(self, step: int) -> Dict[str, Any]:
        return json.loads(self._manifest_path(step).read_text())

    def list_steps(self) -> List[int]:
        out = []
        for p in (self.root / "manifests").glob("step_*.json"):
            out.append(int(p.stem.split("_")[1]))
        return sorted(out)

    def clean_tmp(self, max_age_seconds: float = 3600.0) -> int:
        return clean_tmp_under(self.root, max_age_seconds)

    def delete_step(self, step: int) -> None:
        p = self._manifest_path(step)
        if p.exists():
            p.unlink()

    def gc_blobs(self, referenced: set) -> int:
        n = 0
        for p in (self.root / "blobs").glob("*/*"):
            if p.name not in referenced:
                p.unlink()
                n += 1
        return n
