"""Policy: the checkpoint lifecycle as one validated, frozen value.

``CheckpointManager`` accreted a dozen loose constructor kwargs (cadence
here, chain length there, backpressure somewhere else) that every
caller re-plumbed. ``Policy`` replaces that sprawl: one immutable
dataclass that validates at construction — a bad combination is a
``PolicyError`` at the line that wrote it, not a surprise deep inside
the first chained save — and builds a correctly-wired manager for any
backend. Being frozen, a policy is shareable by-value configuration:
launchers, tests and supervisors can pass it around without defensive
copies.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional

from repro_torch.api.errors import PolicyError

_BACKPRESSURE = ("block", "skip")


@dataclass(frozen=True)
class Policy:
    """Snapshot-lifecycle configuration.

    ``interval``   auto-snapshot cadence in app steps for
                   ``CheckpointSession.maybe_snapshot`` (None = snapshots
                   are taken only when explicitly requested).
    ``chain``      delta-chain length: a full base snapshot every
                   ``chain`` checkpoints, XOR links between (1 = every
                   snapshot is a full base).
    ``keep_last``  retention GC: checkpoints to keep (None = keep all).
    ``sparse``     dirty-chunk capture on chain links (auto-disabled by
                   the pipeline when chaining is off or the accelerator
                   can't fingerprint cheaply).
    ``sparse_chunk_bytes`` / ``sparse_min_bytes``  dirty-chunk geometry
                   (None = pipeline defaults; only valid with chain>=2).
    ``backpressure`` "block" (wait for a staging slot) or "skip" (drop
                   the snapshot when the pipeline is busy).
    ``writers``    backend writer-pool width.
    ``compress``   zlib-probe blob compression.
    ``prune_oplog`` record-prune-replay the op-log into manifests.
    ``async_save`` capture-and-return snapshots (False = synchronous).
    ``replicate``  peer replication default for store specs that
                   support it (None = the spec decides).
    ``codecs``     entry kind -> codec name (e.g. {"opt_state": "int8"}).
    ``streaming_restore`` restore-side default: stream the payload
                   (return at hot-tier-decoded, cold entries page in on
                   first touch) instead of materializing it as one
                   barrier. Bit-identical either way; an explicit
                   ``streaming=`` at the restore call wins.
    ``lazy_kinds`` entry kinds the streaming restore defers to the cold
                   tier (None = the streaming default: optimizer
                   moments + KV cache).
    ``drain_deadline_s`` planned-move budget: the worst per-batch
                   blackout a ``CheckpointSession.migrate`` /
                   ``FleetRouter`` drain may cost before the move is
                   flagged ``within_deadline=False`` (None = no
                   deadline; moves are never aborted mid-flight — a
                   half-moved fleet is worse than a late one).
    ``migrate_batch`` sessions frozen per move batch: bounds any one
                   session's blackout — the rest keep decoding on the
                   source while a batch is in transit (None = move all
                   chosen sessions in one batch).
    """

    interval: Optional[int] = None
    chain: int = 1
    keep_last: Optional[int] = None
    sparse: bool = True
    sparse_chunk_bytes: Optional[int] = None
    sparse_min_bytes: Optional[int] = None
    backpressure: str = "block"
    writers: int = 4
    compress: bool = True
    prune_oplog: bool = True
    async_save: bool = True
    replicate: Optional[bool] = None
    codecs: Mapping[str, str] = field(default_factory=dict)
    streaming_restore: bool = False
    lazy_kinds: Optional[tuple] = None
    drain_deadline_s: Optional[float] = None
    migrate_batch: Optional[int] = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "codecs", dict(self.codecs))
        if self.interval is not None and self.interval < 1:
            raise PolicyError(
                f"interval={self.interval}: the snapshot cadence must be "
                ">= 1 app step, or None for explicit snapshots only")
        if self.chain < 1:
            raise PolicyError(
                f"chain={self.chain}: the delta-chain length must be >= 1 "
                "(1 = every snapshot is a full base)")
        if self.keep_last is not None and self.keep_last < 1:
            raise PolicyError(
                f"keep_last={self.keep_last}: retention must keep at "
                "least one checkpoint, or None to keep all")
        if self.backpressure not in _BACKPRESSURE:
            raise PolicyError(
                f"backpressure={self.backpressure!r}: choose 'block' "
                "(wait for a staging slot) or 'skip' (drop the snapshot)")
        if self.writers < 1:
            raise PolicyError(f"writers={self.writers}: the writer pool "
                              "needs at least one thread")
        sparse_knobs = [k for k in ("sparse_chunk_bytes",
                                    "sparse_min_bytes")
                        if getattr(self, k) is not None]
        if sparse_knobs and self.chain < 2:
            raise PolicyError(
                f"{'/'.join(sparse_knobs)} set with chain={self.chain}: "
                "sparse dirty-chunk capture only applies to delta-chain "
                "links — set chain >= 2 or drop the sparse knobs")
        if sparse_knobs and not self.sparse:
            raise PolicyError(
                f"{'/'.join(sparse_knobs)} set with sparse=False: the "
                "dirty-chunk knobs have no effect — enable sparse or "
                "drop them")
        if self.lazy_kinds is not None:
            if isinstance(self.lazy_kinds, str) \
                    or not all(isinstance(k, str) for k in self.lazy_kinds):
                raise PolicyError(
                    f"lazy_kinds={self.lazy_kinds!r} must be a sequence "
                    "of entry-kind names (e.g. ('opt_state', 'cache')), "
                    "or None for the streaming default")
            object.__setattr__(self, "lazy_kinds", tuple(self.lazy_kinds))
            if not self.streaming_restore:
                raise PolicyError(
                    f"lazy_kinds={self.lazy_kinds!r} set with "
                    "streaming_restore=False: the cold tier only exists "
                    "under a streaming restore — enable it or drop the "
                    "knob (a per-call restore(streaming=True) uses the "
                    "streaming default tiers)")
        if self.drain_deadline_s is not None and self.drain_deadline_s <= 0:
            raise PolicyError(
                f"drain_deadline_s={self.drain_deadline_s}: the planned-"
                "move blackout budget must be > 0 seconds, or None for "
                "no deadline")
        if self.migrate_batch is not None and self.migrate_batch < 1:
            raise PolicyError(
                f"migrate_batch={self.migrate_batch}: a move batch "
                "freezes at least one session, or None to move all "
                "chosen sessions in one batch")
        if self.codecs:
            from repro_torch.api.registry import available_codecs
            known = available_codecs()
            for kind, name in self.codecs.items():
                if name not in known:
                    raise PolicyError(
                        f"codecs[{kind!r}]={name!r}: unknown codec "
                        f"(available: {known}); register one with "
                        "repro_torch.api.register_codec")

    def with_(self, **changes: Any) -> "Policy":
        """A modified copy, re-validated."""
        return dataclasses.replace(self, **changes)

    def build_manager(self, backend):
        """A ``CheckpointManager`` wired exactly as this policy says."""
        from repro_torch.core.checkpoint import CheckpointManager
        extra: Dict[str, Any] = {}
        if self.sparse_chunk_bytes is not None:
            extra["sparse_chunk_bytes"] = self.sparse_chunk_bytes
        return CheckpointManager(
            backend,
            codec_by_kind=dict(self.codecs),
            async_save=self.async_save,
            keep_last=self.keep_last,
            prune_oplog=self.prune_oplog,
            delta_base_interval=self.chain,
            backpressure=self.backpressure,
            writers=self.writers,
            compress=self.compress,
            sparse_capture=self.sparse,
            sparse_min_bytes=self.sparse_min_bytes,
            **extra,
        )
