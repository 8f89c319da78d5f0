"""CheckpointableApp: the one protocol between applications and C/R.

The paper's application never knows which checkpoint package is
underneath (§V); here the application never knows which *mechanism* is
underneath. An app declares its semantic state (upper-half entries with
logical axes), names itself via ``job_meta()["kind"]``, and rebinds
after a restore through ``bind(RestoreContext)`` — snapshotting,
delta-chain policy, backend choice, incarnation replay and supervision
all come for free from ``CheckpointSession``. The trainer, the serving
engine and ``examples/checkpointable_pipeline.py`` all speak exactly
this protocol; nothing workload-specific leaks into the session.

Required surface::

    checkpoint_state() -> UpperHalf   # entries + logical axes, current
    checkpoint_step()  -> int         # the snapshot's step id
    job_meta()         -> dict        # must carry "kind" (the registry key)
    bind(restore)      -> None        # rebind state from a RestoreContext

Optional hooks, discovered by name::

    session_state() -> UpperHalf      # dynamic per-snapshot state; takes
                                      # precedence over checkpoint_state
    runtime_log()   -> OpLog          # logged lower-half history to ride
                                      # along (default: empty log)
    quiesce()       -> None           # flush/stop work before teardown —
                                      # the supervisor calls it before
                                      # replacing a runner
    apply_reassignment(assignment)    # adopt + log a data-shard move
                                      # (supervisor rebalances)
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Protocol, \
    runtime_checkable

from repro_torch.api.errors import PolicyError

REQUIRED_METHODS = ("checkpoint_state", "checkpoint_step", "job_meta",
                    "bind")
OPTIONAL_HOOKS = ("session_state", "runtime_log", "quiesce",
                  "apply_reassignment")


@runtime_checkable
class CheckpointableApp(Protocol):
    """Structural protocol — apps implement it, they never inherit it."""

    def checkpoint_state(self) -> Any: ...          # -> UpperHalf

    def checkpoint_step(self) -> int: ...

    def job_meta(self) -> Dict[str, Any]: ...

    def bind(self, restore: "RestoreContext") -> None: ...


def validate_app(app: Any) -> None:
    """Protocol conformance with a nameable error, not an AttributeError
    three layers deep at the first snapshot."""
    missing = [n for n in REQUIRED_METHODS
               if not callable(getattr(app, n, None))]
    if missing:
        raise PolicyError(
            f"{type(app).__name__} is not a CheckpointableApp: missing "
            f"{missing}; the protocol requires {list(REQUIRED_METHODS)} "
            f"(optional hooks: {list(OPTIONAL_HOOKS)})")
    meta = app.job_meta()
    if not isinstance(meta, dict) or "kind" not in meta:
        raise PolicyError(
            f"{type(app).__name__}.job_meta() must be a dict with a "
            "'kind' key — restore resolves the app binder from it "
            "(register one with repro_torch.api.register_app_kind)")


class RestoreContext:
    """One restore, as the application sees it.

    Wraps the core ``Incarnation`` lifecycle behind a surface an app can
    use without importing ``repro_torch.core``: ``scalar``/``tree``/``paths``
    pull entries out of the materialized payload (driving materialize →
    replay lazily on first touch), ``lower``/``mesh`` expose the
    replayed runtime, ``release()`` drops the host payload when every
    entry is rebound. Binders that need the full phase control (elastic
    rewrites, skipped entries) call ``incarnation()`` once with their
    overrides before touching any helper.
    """

    def __init__(self, manager, step: int, job: Dict[str, Any], *,
                 mesh_factory: Optional[Callable] = None,
                 rewrite_op: Optional[Callable] = None,
                 decode_workers: Optional[int] = None,
                 streaming: bool = False,
                 lazy_kinds=None) -> None:
        self.manager = manager
        self.step = step
        self.job = dict(job)
        self.mesh_factory = mesh_factory
        self.rewrite_op = rewrite_op
        self.decode_workers = decode_workers
        self.streaming = streaming
        self.lazy_kinds = lazy_kinds
        self._inc = None

    # --- advanced surface (binders) ------------------------------------

    def incarnation(self, *, skip_entries: Optional[List[str]] = None,
                    rewrite_op: Optional[Callable] = None,
                    mesh_factory: Optional[Callable] = None):
        """The underlying ``Incarnation``, constructed once. Explicit
        arguments override the session-level options (a binder composing
        its own op rewrite passes the composed callable here)."""
        if self._inc is None:
            from repro_torch.core.incarnation import Incarnation
            self._inc = Incarnation(
                self.manager, step=self.step,
                mesh_factory=mesh_factory or self.mesh_factory,
                rewrite_op=rewrite_op or self.rewrite_op,
                decode_workers=self.decode_workers,
                skip_entries=skip_entries,
                streaming=self.streaming,
                lazy_kinds=self.lazy_kinds)
        return self._inc

    def _ready(self):
        inc = self.incarnation()
        if inc.restored is None:
            inc.materialize()
        if inc.lower is None:
            inc.build_lower()
        return inc

    # --- simple surface (apps) -----------------------------------------

    def scalar(self, name: str):
        """A plain scalar entry (step counters, cursors)."""
        return self._ready().scalar(name)

    def paths(self, name: str) -> Dict[str, Any]:
        """Raw leaf-path -> host-array map for one entry."""
        return self._ready().entry_paths(name)

    def tree(self, name: str, template=None):
        """One entry as a nested dict: with a ``template``, rebound onto
        this incarnation's device with the template's dtypes; without
        one, rebuilt structurally from the recorded paths — for state
        whose shape is data (queues, dynamic dicts)."""
        inc = self._ready()
        if template is None:
            from repro_torch.tree import tree_from_paths
            return tree_from_paths(inc.entry_paths(name))
        return inc.bind(name, template)

    def has(self, name: str) -> bool:
        return self._ready().has_entry(name)

    def release(self) -> None:
        """Drop the decoded host payload (call once every entry is
        rebound — keeps the checkpoint's RAM out of the resumed run)."""
        if self._inc is not None:
            self._inc.release()

    # --- replayed runtime ----------------------------------------------

    @property
    def lower(self):
        return self._ready().lower

    @property
    def mesh(self):
        """The replayed device (a ``torch.device``)."""
        return self._ready().mesh_or_none()

    @property
    def timings(self) -> Dict[str, float]:
        return self._inc.timings if self._inc is not None else {}
