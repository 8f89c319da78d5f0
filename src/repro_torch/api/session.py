"""CheckpointSession: the whole checkpoint lifecycle behind one object.

Before this facade every workload hand-rolled the same choreography:
construct a backend, wire a ``CheckpointManager``, thread step counters
and op-logs into ``save()``, drive an ``Incarnation`` phase by phase on
restore, and hook a ``ClusterSupervisor`` up by hand. The session owns
that sequence once, for every app that speaks ``CheckpointableApp``:

    sess = CheckpointSession("localfs:/tmp/job",
                             Policy(interval=5, chain=4, keep_last=3))
    sess.attach(app)                 # protocol-validated
    ...
    sess.maybe_snapshot()            # policy cadence; non-blocking
    ...
    app = sess.restore("latest")     # kind-registry binder + attach
    sup = sess.supervise([0, 1, 2])  # failure loop over the same session

Restore is checkpoint-*kind* driven: the manifest's ``job["kind"]``
names the registered binder that rebuilds the app through a
``RestoreContext`` — the session never contains workload code, which is
what keeps the paper's §V agnosticism claim honest at the API layer.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Union

from repro_torch.api.app import RestoreContext, validate_app
from repro_torch.api.errors import PolicyError
from repro_torch.api.policy import Policy
from repro_torch.api.registry import resolve_app_kind, resolve_backend


class CheckpointSession:
    """One app + one store + one policy, owned end to end.

    ``store`` is a URI-style spec (``localfs:/path``,
    ``sharded:/path?hosts=4``) or an already-built backend instance;
    ``policy`` defaults to ``Policy()``. ``from_manager`` adopts an
    existing ``CheckpointManager`` instead (the legacy-shim path).
    """

    def __init__(self, store: Union[str, Any], policy: Optional[Policy] = None,
                 *, app: Any = None, manager: Any = None) -> None:
        self.policy = policy or Policy()
        if manager is not None:
            if store is not None:
                raise PolicyError("give CheckpointSession a store OR a "
                                  "manager, not both")
            self.manager = manager
        elif store is None:
            raise PolicyError("CheckpointSession needs a store spec, a "
                              "backend instance, or manager=")
        else:
            if isinstance(store, str):
                defaults: Dict[str, str] = {}
                if self.policy.replicate is not None:
                    defaults["replicate"] = "1" if self.policy.replicate \
                        else "0"
                backend = resolve_backend(store, defaults=defaults)
            else:
                backend = store
            # Policy.replicate is a *default* (an explicit spec param
            # wins), but it must never be silently unservable: if the
            # user asked for replication and the resolved store can't
            # provide it, say so now — not at the first lost host.
            if self.policy.replicate \
                    and not getattr(backend, "replicate", False) \
                    and not (isinstance(store, str)
                             and "replicate=" in store):
                raise PolicyError(
                    f"Policy(replicate=True) but the "
                    f"{type(backend).__name__} store does not replicate; "
                    "use a replicating backend (e.g. "
                    "'sharded:/path?replicate=1') or construct it with "
                    "replication on")
            self.manager = self.policy.build_manager(backend)
        self._app: Any = None
        self.supervisor: Any = None
        if app is not None:
            self.attach(app)

    @classmethod
    def from_manager(cls, manager, policy: Optional[Policy] = None,
                     *, app: Any = None) -> "CheckpointSession":
        """Adopt an existing ``CheckpointManager`` (its pipeline settings
        win over ``policy``'s snapshot knobs; ``policy.interval`` still
        drives ``maybe_snapshot``)."""
        return cls(None, policy, app=app, manager=manager)

    # --- app attachment ------------------------------------------------

    @property
    def app(self) -> Any:
        return self._app

    @property
    def backend(self):
        return self.manager.backend

    def attach(self, app: Any) -> Any:
        """Validate the protocol and make ``app`` this session's app."""
        validate_app(app)
        self._app = app
        return app

    def _require_app(self) -> Any:
        if self._app is None:
            raise PolicyError("no app attached; call attach(app) or "
                              "restore() first")
        return self._app

    # --- snapshots -----------------------------------------------------

    def snapshot(self, block: bool = False):
        """One snapshot of the attached app at its current step: the
        optional ``session_state()`` hook wins over ``checkpoint_state()``
        (dynamic-state apps rebuild their entries per snapshot), the
        optional ``runtime_log()`` rides along for replay. Returns the
        in-flight ``SnapshotHandle`` (None when blocking or dropped under
        "skip" backpressure)."""
        app = self._require_app()
        state_fn = getattr(app, "session_state", None)
        state = state_fn() if callable(state_fn) else app.checkpoint_state()
        log_fn = getattr(app, "runtime_log", None)
        if callable(log_fn):
            log = log_fn()
        else:
            from repro_torch.core.oplog import OpLog
            log = OpLog()
        return self.manager.save(int(app.checkpoint_step()), state, log,
                                 block=block, job_meta=dict(app.job_meta()))

    def maybe_snapshot(self, *, final: bool = False):
        """Policy-driven cadence: snapshot when the app's step lands on
        ``policy.interval`` (or unconditionally when ``final`` — the
        end-of-run boundary). Returns the handle, or None when the
        cadence says not yet."""
        if final:
            return self.snapshot()
        if not self.policy.interval:
            return None
        step = int(self._require_app().checkpoint_step())
        if step and step % self.policy.interval == 0:
            return self.snapshot()
        return None

    # --- restore -------------------------------------------------------

    def restorable_steps(self) -> List[int]:
        """Committed steps whose full delta chain is still intact."""
        from repro_torch.core.restore import restorable_steps
        return restorable_steps(self.backend)

    def latest_step(self) -> Optional[int]:
        return self.backend.latest_step()

    def restore(self, step: Union[int, str, None] = None, *,
                expect_kind: Optional[str] = None,
                mesh_factory: Optional[Callable] = None,
                rewrite_op: Optional[Callable] = None,
                workers: Optional[int] = None,
                decode_workers: Optional[int] = None,
                streaming: Optional[bool] = None,
                **app_kwargs: Any) -> Any:
        """Rebuild and attach the checkpointed app.

        ``step`` is a step number, ``"latest"`` or None (latest). The
        manifest's ``job["kind"]`` resolves the registered binder, which
        drives the incarnation through a ``RestoreContext`` and returns
        the app; ``app_kwargs`` pass through to it (e.g. ``params=`` /
        ``n_slots=`` for the serving engine). ``expect_kind`` guards a
        caller that only handles one workload.

        ``workers`` sizes the restore's fetch/decode pools, threaded
        through the incarnation to ``CheckpointManager.restore``
        (``decode_workers`` is the older spelling of the same knob).
        ``streaming`` streams the payload — the app comes back once the
        hot tier is decoded and cold entries page in on first touch —
        with None deferring to ``policy.streaming_restore``. Streaming
        and eager restores are bit-identical."""
        if workers is not None and decode_workers is not None \
                and workers != decode_workers:
            raise PolicyError(
                f"workers={workers} and decode_workers={decode_workers} "
                "are the same knob spelled twice; pass one")
        workers = workers if workers is not None else decode_workers
        if streaming is None:
            streaming = self.policy.streaming_restore
        if step in (None, "latest"):
            resolved = self.manager.resolve_step(None)
        else:
            resolved = self.manager.resolve_step(int(step))
        job = self.backend.get_manifest(resolved).get("job", {})
        kind = job.get("kind", "train")
        if expect_kind is not None and kind != expect_kind:
            raise PolicyError(f"not a {expect_kind} checkpoint: {job!r}")
        binder = resolve_app_kind(kind)
        ctx = RestoreContext(self.manager, resolved, job,
                             mesh_factory=mesh_factory,
                             rewrite_op=rewrite_op,
                             decode_workers=workers,
                             streaming=bool(streaming),
                             lazy_kinds=self.policy.lazy_kinds)
        return self.attach(binder(ctx, **app_kwargs))

    # --- live migration ------------------------------------------------

    def migrate(self, to: Any, *, slots: Optional[List[int]] = None,
                include_queue: bool = False,
                via: Optional[str] = None,
                batch: Optional[int] = None,
                deadline_s: Optional[float] = None,
                streaming: bool = True):
        """Live-migrate this session's serving app's sessions onto
        another engine, through the C/R protocol: the chosen slots
        freeze, snapshot as a ``SessionBundle`` on a *move channel* (a
        dedicated store beside this session's chain — migration traffic
        never interleaves with the periodic snapshot chain), restore,
        and re-enter the target through admission replay — the re-slot
        machinery, so an N-slot engine's sessions land on an M-slot
        engine token-identically. The source keeps serving its
        unaffected slots throughout.

        ``to`` is the target engine (or a session holding one).
        ``via`` overrides the move-channel store spec (default: a
        ``_moves/`` directory under this session's store root).
        ``batch`` / ``deadline_s`` default to ``policy.migrate_batch`` /
        ``policy.drain_deadline_s``. Returns a ``MoveResult`` with
        per-batch blackout accounting."""
        from repro_torch.api.errors import MigrationError
        from repro_torch.core.migration import migrate_sessions

        source = self._require_app()
        target = to.app if isinstance(to, CheckpointSession) else to
        if target is None:
            raise MigrationError("target session has no app attached")
        if via is None:
            root = getattr(self.backend, "root", None)
            if root is None:
                raise MigrationError(
                    f"{type(self.backend).__name__} store has no root "
                    "path to derive a move channel from; pass via= (a "
                    "store spec for the migration transport)")
            via = f"localfs:{root}"
        return migrate_sessions(
            source, target, via=via, slots=slots,
            include_queue=include_queue,
            batch=batch if batch is not None else self.policy.migrate_batch,
            deadline_s=deadline_s if deadline_s is not None
            else self.policy.drain_deadline_s,
            streaming=streaming)

    # --- supervision ---------------------------------------------------

    def supervise(self, hosts: List[int], *,
                  spares: Optional[List[int]] = None,
                  heartbeat_timeout: float = 60.0,
                  clock: Callable[[], float] = time.monotonic,
                  allow_shrink: bool = True,
                  n_shards: Optional[int] = None,
                  restore_kwargs: Union[None, Dict[str, Any],
                                        Callable[[Any], Dict[str, Any]]] = None,
                  on_restored: Optional[Callable[[Any, Any], None]] = None,
                  teardown: Optional[Callable[[Any], None]] = None,
                  reassign: Optional[Callable[[Any, Any], None]] = None,
                  repair_storage: bool = True,
                  event_sink: Optional[
                      Callable[[float, str, Dict[str, Any]], None]] = None):
        """Close the failure loop over this session: a
        ``ClusterSupervisor`` whose restore hook goes back through
        ``CheckpointSession.restore`` — so a RESTART/SHRINK decision
        rebuilds whatever kind of app the checkpoint holds, through the
        protocol, with the decision's op rewrite applied.

        ``restore_kwargs`` supplies the binder kwargs a restore needs
        (dict, or ``callable(RestoreTarget) -> dict`` for kwargs that
        depend on the surviving topology — e.g. serving's proportional
        slot count); ``on_restored(app, target)`` observes each executed
        rebuild; ``event_sink(t, kind, detail)`` taps the supervisor's
        event stream live (``core.churn.IncidentLog`` writes it as
        JSONL). The supervisor also drives the app only through
        protocol hooks (``quiesce`` at teardown, ``apply_reassignment``
        for rebalances)."""
        from repro_torch.core.supervisor import (ClusterSupervisor,
                                                 one_device_mesh)

        def _restore(target):
            kw = restore_kwargs(target) if callable(restore_kwargs) \
                else dict(restore_kwargs or {})
            if kw.get("mesh_factory") is not None:
                kw["mesh_factory"] = one_device_mesh(kw["mesh_factory"])
            app = self.restore(step=target.step,
                               rewrite_op=target.rewrite_op(), **kw)
            if on_restored is not None:
                on_restored(app, target)
            return app

        sup = ClusterSupervisor(
            list(hosts), manager=self.manager, spares=list(spares or []),
            heartbeat_timeout=heartbeat_timeout, clock=clock,
            allow_shrink=allow_shrink, n_shards=n_shards,
            restore=_restore, teardown=teardown, reassign=reassign,
            repair_storage=repair_storage, runner=self._app,
            event_sink=event_sink)
        self.supervisor = sup
        return sup

    # --- lifecycle -----------------------------------------------------

    @property
    def stats(self) -> Dict[str, Any]:
        return self.manager.stats

    def wait(self) -> None:
        """Join the snapshot pipeline; re-raises the latest failure."""
        self.manager.wait()

    def close(self) -> None:
        self.manager.close()

    def __enter__(self) -> "CheckpointSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
