"""CheckpointManager: the phased (capture / encode / commit) snapshot
API over the async pipeline in ``core.async_snapshot``.

``save`` is capture-then-return: the caller thread pays only the
device→staging copy; delta encoding (``core.delta`` +
``kernels.ckpt_codec``) and backend writes overlap subsequent train or
serve steps on the pipeline's encode thread + writer pool. A checkpoint
exists iff its manifest committed (fsync+rename in the backend), so a
crash mid-write never corrupts the latest checkpoint.

Manifests are format 2 or 3: they may record a ``base_step``, forming a
delta chain of XOR links back to a full base snapshot
(``delta_base_interval``). With ``sparse_capture`` (the default when
chaining), chain links are *sparse*: capture fingerprints each leaf
per-chunk (kernels/ckpt_codec) and transfers only dirty chunks, and the
manifest (format 3) records only those chunks. ``restore`` materializes
the chain — full base decoded first, each delta link applied forward —
and returns host state plus the PRUNED op-log (record-prune-replay) and
upper-half structure, which is everything restore needs on any topology.
Formats 1-3 all restore through the same path (matrix in README).

Synchronous behavior (``async_save=False`` or ``save(block=True)``) runs
the same pipeline and joins it before returning.

This manager is mechanism; applications should construct it through the
public surface — ``repro_torch.api.Policy.build_manager`` (validated
configuration) inside a ``repro_torch.api.CheckpointSession`` (the lifecycle
facade) — rather than spelling the kwargs here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.core.async_snapshot import (AsyncSnapshotter, SnapshotHandle,
                                       materialize_manifest_chain)
from repro_torch.core.backends.base import CheckpointBackend
from repro_torch.core.oplog import OpLog
from repro_torch.core.split_state import UpperHalf


@dataclass
class RestoredState:
    step: int
    manifest: Dict[str, Any]
    # entry -> leaf path -> np.ndarray (bfloat16 as its uint16 bit view;
    # an int8 codec leaf as a delta.Int8Leaf that reads as one)
    entries: Dict[str, Dict[str, np.ndarray]]
    oplog: OpLog


class CheckpointManager:
    def __init__(
        self,
        backend: CheckpointBackend,
        *,
        codec_by_kind: Optional[Dict[str, str]] = None,
        async_save: bool = True,
        keep_last: Optional[int] = None,
        prune_oplog: bool = True,
        delta_base_interval: int = 1,
        backpressure: str = "block",
        writers: int = 4,
        compress: bool = True,
        sparse_capture: bool = True,
        sparse_chunk_bytes: Optional[int] = None,
        sparse_min_bytes: Optional[int] = None,
    ) -> None:
        self.backend = backend
        # e.g. {"opt_state": "int8"} — moments tolerate quantization
        self.codec_by_kind = codec_by_kind or {}
        self.async_save = async_save
        self.keep_last = keep_last
        extra: Dict[str, Any] = {}
        if sparse_chunk_bytes is not None:
            extra["sparse_chunk_bytes"] = sparse_chunk_bytes
        self.pipeline = AsyncSnapshotter(
            backend,
            codec_by_kind=codec_by_kind,
            delta_base_interval=delta_base_interval,
            backpressure=backpressure,
            writers=writers,
            compress=compress,
            keep_last=keep_last,
            prune_oplog=prune_oplog,
            sparse_capture=sparse_capture,
            sparse_min_bytes=sparse_min_bytes,
            **extra,
        )

    @property
    def stats(self) -> Dict[str, Any]:
        return self.pipeline.stats

    # --- save -------------------------------------------------------------

    def save(self, step: int, upper: UpperHalf, oplog: OpLog,
             block: bool = False,
             job_meta: Optional[Dict[str, Any]] = None,
             ) -> Optional[SnapshotHandle]:
        """Phase 1 (capture) on this thread; phases 2-3 in the pipeline.

        Returns a SnapshotHandle to the in-flight snapshot, or None when
        it completed synchronously — or was dropped by a "skip"
        backpressure policy (distinguish via ``stats['skipped']``). A
        blocking save is never dropped: asking to block is asking to
        wait for a slot."""
        blocking = block or not self.async_save
        handle = self.pipeline.snapshot(step, upper, oplog,
                                        job_meta=job_meta,
                                        must_take=blocking)
        if handle is None:
            return None
        if blocking:
            try:
                handle.result()
            except BaseException as e:
                self.pipeline.consume_error(e)  # delivered here, not to
                raise                           # a later wait()
            return None
        return handle

    def wait(self) -> None:
        """Join the pipeline; re-raises the latest failed snapshot."""
        self.pipeline.drain()

    def close(self) -> None:
        """Drain and shut down the pipeline's threads. Long-lived
        processes creating managers per job should close them (or use
        the manager as a context manager)."""
        self.pipeline.close()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --- restore ------------------------------------------------------------

    def resolve_step(self, step: Optional[int] = None) -> int:
        """Drain in-flight snapshots, then resolve a restore target:
        the latest committed step when ``step`` is None. Raises
        FileNotFoundError when nothing is committed."""
        self.wait()
        if step is None:
            step = self.backend.latest_step()
            if step is None:
                raise FileNotFoundError("no committed checkpoints")
        return step

    def restore(self, step: Optional[int] = None,
                workers: Optional[int] = None,
                skip_entries=()) -> RestoredState:
        """Materialize a committed checkpoint's delta chain into host
        arrays. ``workers`` sizes the leaf-decode pool (restore latency
        matters as much as checkpoint overhead — CRIUgpu's point);
        ``skip_entries`` names entries the caller will rebuild instead
        of rebind, left undecoded. (A streaming restore waits for
        ROADMAP A4.) The full restart lifecycle on top of this is
        ``core.incarnation``."""
        step = self.resolve_step(step)
        manifest, entries = materialize_manifest_chain(
            self.backend, step, workers=workers, skip_entries=skip_entries)
        oplog = OpLog.from_json(manifest["oplog"])
        return RestoredState(step=step, manifest=manifest, entries=entries,
                             oplog=oplog)

    # retention GC lives in the pipeline (AsyncSnapshotter.gc) and runs
    # on the encode thread after each commit when keep_last is set — do
    # not call it from other threads, it races in-flight encodes
