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

Restore is checkpoint-*kind* driven: the manifest's ``job["kind"]``
names the registered binder that rebuilds the app through a
``RestoreContext`` — the session never contains workload code, which is
what keeps the paper's §V agnosticism claim honest at the API layer.
"""
from __future__ import annotations

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
        ``streaming=True`` is refused: the port's streaming restore
        waits for ROADMAP A4."""
        if workers is not None and decode_workers is not None \
                and workers != decode_workers:
            raise PolicyError(
                f"workers={workers} and decode_workers={decode_workers} "
                "are the same knob spelled twice; pass one")
        workers = workers if workers is not None else decode_workers
        if streaming:
            raise PolicyError("streaming restore waits for ROADMAP A4 "
                              "(core/streaming.py); restore eagerly")
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
                             decode_workers=workers)
        return self.attach(binder(ctx, **app_kwargs))

    # --- not ported yet ------------------------------------------------

    def migrate(self, to: Any, **kw: Any):
        """Live migration of serving sessions (the JAX package's
        ``core.migration``) waits for ROADMAP A7."""
        raise PolicyError("CheckpointSession.migrate is not ported yet: "
                          "it waits for ROADMAP A7 (core/migration.py)")

    def supervise(self, hosts: List[int], **kw: Any):
        """The failure loop (the JAX package's ``core.supervisor``)
        waits for ROADMAP A7."""
        raise PolicyError("CheckpointSession.supervise is not ported yet: "
                          "it waits for ROADMAP A7 (core/supervisor.py)")

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
