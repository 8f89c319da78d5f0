"""Incarnation: the restore lifecycle as a first-class object.

The paper's restart (§II-III) is a fixed sequence — materialize the
checkpoint payload, load a fresh copy of the driver, replay the logged
calls, rebind the application's handles — and its headline demo (§IV)
is bringing back a *live* application with the user's session intact.
Before this module, that sequence lived as free functions every caller
hand-assembled; now one object owns it, in order, with timings:

    inc   = Incarnation(manager, step=..., mesh_factory=...)
    state = inc.materialize()     # 0: delta chain -> host arrays
                                  #    (decoded across a worker pool)
    lower = inc.build_lower()     # 1-2: fresh LowerHalf, new_incarnation
                                  #      handle generation, op-log replay
    tree  = inc.bind(name, template)   # 3: upper half rebinds onto the
    n     = inc.scalar(name)           #    replayed device

Phases are enforced in order (bind before materialize is a bug, not a
silent None), each phase is timed (``inc.timings``), and both the
serving engine (`serving/engine.py`) resumes through this object —
there is exactly one restart protocol.

Elastic restores hand the incarnation a *replacement* for a logged
resource's geometry: ``mesh_factory`` supplies the device the logged
``MeshCreate`` binds, and ``rewrite_op`` transforms individual ops before
replay — the serving engine uses it to re-slot a continuous-batching
checkpoint onto a different slot count (CacheAlloc batch N -> M,
decode Compile recompiled at the new batch) while keeping every virtual
id stable across the rewrite.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.api.errors import CheckpointError
from repro_torch.core.checkpoint import CheckpointManager, RestoredState
from repro_torch.core.oplog import CacheAlloc, Compile, Op, OpLog
from repro_torch.core.split_state import LowerHalf
from repro_torch.core.virtual_ids import VirtualId


class LifecycleError(CheckpointError, RuntimeError):
    """An Incarnation phase was invoked out of order (or twice)."""


class Incarnation:
    """One restart of a checkpointed job. Single-use: a second restore
    constructs a second Incarnation."""

    def __init__(self, manager: CheckpointManager,
                 step: Optional[int] = None,
                 mesh_factory: Optional[Callable] = None,
                 rewrite_op: Optional[Callable[[Op], Op]] = None,
                 decode_workers: Optional[int] = None,
                 skip_entries: Optional[List[str]] = None,
                 streaming: bool = False,
                 lazy_kinds=None) -> None:
        self.manager = manager
        self.step = step
        self.mesh_factory = mesh_factory
        self.rewrite_op = rewrite_op
        self.decode_workers = decode_workers
        # entries the caller will rebuild rather than rebind (e.g. the
        # KV cache on a re-slot restore) — skipped at decode, so their
        # chains never inflate materialize latency
        self.skip_entries = tuple(skip_entries or ())
        # streaming: materialize() returns at hot-tier-decoded instead
        # of everything-decoded; cold entries (lazy_kinds) page in on
        # first touch while replay/rebind proceed (core.streaming)
        self.streaming = streaming
        self.lazy_kinds = lazy_kinds
        self.streamer = None
        self.restored: Optional[RestoredState] = None
        self.lower: Optional[LowerHalf] = None
        self.released = False
        self.timings: Dict[str, Any] = {}

    # --- phase 0: materialize the payload ------------------------------

    def materialize(self) -> RestoredState:
        """Walk the manifest's ``base_step`` delta chain back to its full
        base and decode every leaf forward, fanned out across a decode
        worker pool. Dense links (formats 1-2) XOR-apply whole buffers;
        sparse links (format 3, dirty-chunk capture) patch only the
        chunks the link recorded — so restoring a long chain of sparse
        snapshots costs the base decode plus the sum of the deltas, not
        chain length x state size. Unknown newer manifest formats are
        rejected up front rather than misread. The result is plain host
        arrays + the pruned op-log — everything restore needs, on any
        topology.

        With ``streaming=True`` this returns once the *hot* tier is
        decoded (``materialize_s`` then measures time-to-hot, the
        latency the resumed app actually waits); the cold tier keeps
        streaming behind replay and rebind, and ``stream_timings()``
        reports the per-phase fetch/decode/fault counters."""
        if self.restored is not None:
            raise LifecycleError("materialize() already ran")
        t0 = time.monotonic()
        kw: Dict[str, Any] = {}
        if self.streaming:
            kw["streaming"] = True
            if self.lazy_kinds is not None:
                kw["lazy_kinds"] = self.lazy_kinds
        self.restored = self.manager.restore(self.step,
                                             workers=self.decode_workers,
                                             skip_entries=self.skip_entries,
                                             **kw)
        self.streamer = self.restored.streamer
        self.step = self.restored.step
        self.timings["materialize_s"] = time.monotonic() - t0
        return self.restored

    # --- phases 1-2: fresh lower half + replay -------------------------

    def build_lower(self) -> LowerHalf:
        """Construct a fresh LowerHalf (the 'load a fresh copy of the
        driver' moment) and replay the pruned op-log through it:
        recompiles step functions, re-allocates caches, fast-forwards
        data assignment — rebinding the checkpoint's virtual ids to this
        incarnation's real objects.

        ``mesh_factory`` substitutes the device at the MeshCreate op;
        ``rewrite_op`` transforms each op before replay (elastic
        re-slotting). The replayed (possibly rewritten) ops become the
        new incarnation's log, so a later checkpoint of this process
        carries a self-consistent history forward."""
        if self.restored is None:
            raise LifecycleError("build_lower() before materialize()")
        if self.lower is not None:
            raise LifecycleError("build_lower() already ran")
        t0 = time.monotonic()
        lower = LowerHalf(mesh_factory=self.mesh_factory)
        ops: List[Op] = []
        for op in self.restored.oplog.ops:
            if self.rewrite_op is not None:
                op = self.rewrite_op(op)
            lower.apply_op(op)
            ops.append(op)
        lower.oplog = OpLog(ops)
        self.lower = lower
        self.timings["replay_s"] = time.monotonic() - t0
        return lower

    # --- phase 3: upper-half rebinding ---------------------------------

    def bind(self, name: str, template, plan=None, logical=None):
        """Rematerialize one upper-half entry onto this incarnation's
        device: path-matched host leaves -> tensors with the template's
        dtypes (elastic: the payload references no devices). On a
        ``DeviceMesh`` each rank keeps its block of each leaf, placed by
        the leaf's logical axes under ``plan``."""
        from repro_torch.core.restore import materialize_entry
        if self.lower is None:
            raise LifecycleError("bind() before build_lower()")
        if self.released:
            raise LifecycleError("payload released; bind() must run "
                                 "before release()")
        t0 = time.monotonic()
        out = materialize_entry(self.restored, name, template,
                                self.mesh_or_none(), plan, logical)
        self.timings["rebind_s"] = \
            self.timings.get("rebind_s", 0.0) + time.monotonic() - t0
        return out

    def scalar(self, name: str):
        """Plain scalar/int-tree entries (step counters, cursors)."""
        from repro_torch.core.restore import restore_scalar
        if self.restored is None:
            raise LifecycleError("scalar() before materialize()")
        if self.released:
            raise LifecycleError("payload released; scalar() must run "
                                 "before release()")
        return restore_scalar(self.restored, name)

    def entry_paths(self, name: str) -> Dict[str, Any]:
        """Raw path->host-array map for one entry (callers that rebuild
        structure themselves, e.g. the serving scheduler)."""
        if self.restored is None:
            raise LifecycleError("entry_paths() before materialize()")
        if self.released:
            raise LifecycleError("payload released; entry_paths() must "
                                 "run before release()")
        return self.restored.entries[name]

    def release(self) -> None:
        """Drop the host-side payload once every entry is rebound. The
        decoded arrays otherwise stay referenced for the life of the
        resumed process — the full checkpoint size held in host RAM
        just to keep timings readable. Manifest, job metadata, timings
        and the lower half survive."""
        if self.restored is not None:
            self.restored.entries = {}
        self.released = True

    def has_entry(self, name: str) -> bool:
        if self.restored is None:
            raise LifecycleError("has_entry() before materialize()")
        return name in self.restored.entries

    # --- log introspection (find the vids replay rebound) --------------

    def last_compile(self, fn_name: str) -> Optional[VirtualId]:
        """vexec of the last Compile of ``fn_name`` in the replayed log —
        the executable a resumed loop should step with."""
        if self.lower is None:
            raise LifecycleError("last_compile() before build_lower()")
        vexec = None
        for op in self.lower.oplog.ops:
            if isinstance(op, Compile) and op.fn_name == fn_name:
                vexec = op.vexec
        return vexec

    def last_cache_alloc(self) -> Optional[VirtualId]:
        """vcache of the last live CacheAlloc in the replayed log."""
        if self.lower is None:
            raise LifecycleError("last_cache_alloc() before build_lower()")
        vcache = None
        for op in self.lower.oplog.ops:
            if isinstance(op, CacheAlloc) \
                    and self.lower.handles.is_bound(op.vcache):
                vcache = op.vcache
        return vcache

    # --- convenience ---------------------------------------------------

    @property
    def job(self) -> Dict[str, Any]:
        """The checkpoint's job metadata (arch, shape, seeds, ...)."""
        if self.restored is None:
            raise LifecycleError("job before materialize()")
        return self.restored.manifest.get("job", {})

    @property
    def manifest(self) -> Dict[str, Any]:
        if self.restored is None:
            raise LifecycleError("manifest before materialize()")
        return self.restored.manifest

    def mesh_or_none(self):
        """The replayed mesh, or None when the log bound no hardware
        (e.g. a checkpoint from an unlogged runtime)."""
        try:
            return self.lower.mesh if self.lower is not None else None
        except Exception:
            return None

    def stream_timings(self) -> Optional[Dict[str, Any]]:
        """Per-phase streaming-restore counters (fetch bytes/s per
        source, decode overlap %, lazy faults served, hedges won), or
        None on an eager restore. Safe to call at any point after
        materialize(); counters reflect progress so far, and the
        snapshot is also folded into ``timings['stream']`` so a later
        reader of the plain timings dict sees it."""
        if self.streamer is None:
            return None
        t = self.streamer.timings()
        self.timings["stream"] = t
        return t
