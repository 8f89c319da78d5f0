"""Typed exception hierarchy for the public checkpoint API.

One base — ``CheckpointError`` — under which everything the checkpoint
machinery raises *on purpose* is classified, so a caller holding a
``CheckpointSession`` can write one ``except CheckpointError`` instead
of guessing which layer's ``ValueError``/``RuntimeError`` might
surface. Every subclass ALSO inherits the builtin type its raise sites
historically used (``ValueError`` / ``RuntimeError``), so existing
``except``/``pytest.raises`` call sites keep working unchanged — the
hierarchy adds ways to catch, it never removes one.

    CheckpointError
    ├── PolicyError          (ValueError)   bad Policy / store spec / app
    ├── BackendUnavailable   (RuntimeError) storage cannot serve a commit
    ├── SnapshotError        (RuntimeError) capture/encode pipeline failure
    ├── RestoreError         (ValueError)   checkpoint cannot be decoded
    ├── MigrationError       (RuntimeError) planned move cannot execute
    ├── LifecycleError       (RuntimeError) Incarnation phase out of order
    └── SupervisorError      (RuntimeError) failure loop cannot execute

``StaleHandleError`` predates the hierarchy and stays a ``KeyError``
subclass (callers index handle tables with it); it is re-exported here
so app code never imports ``repro_torch.core`` for an exception type.
"""
from __future__ import annotations


class CheckpointError(Exception):
    """Base of every typed error the checkpoint API raises."""


class PolicyError(CheckpointError, ValueError):
    """Invalid configuration: a bad ``Policy`` field combination, a
    malformed backend store spec, an unknown registry key, or an object
    that does not satisfy the ``CheckpointableApp`` protocol."""


class BackendUnavailable(CheckpointError, RuntimeError):
    """A storage backend cannot serve what a commit or read requires
    (e.g. a manifest referencing blobs no live host can serve)."""


class SnapshotError(CheckpointError, RuntimeError):
    """The snapshot pipeline could not capture or encode a checkpoint."""


class RestoreError(CheckpointError, ValueError):
    """A committed checkpoint could not be decoded or rematerialized
    (unknown manifest format, broken delta chain, missing metadata)."""


class MigrationError(CheckpointError, RuntimeError):
    """A planned live move cannot execute: source/target is not a
    serving-style engine, an unknown engine name, or a routing state
    that would drop requests."""


# Re-exported members defined in their home modules (they are raised
# from layers that must not import upward). StaleHandleError is
# imported at the END of this module, AFTER every class above exists:
# repro_torch.core modules import from here at their own module top, so the
# core -> api.errors -> core.virtual_ids cycle re-enters this module
# partially initialized — by then the classes it needs are defined.
from repro_torch.core.virtual_ids import StaleHandleError  # noqa: E402,F401


def __getattr__(name: str):
    # LifecycleError / SupervisorError live in modules that themselves
    # import CheckpointError from here — resolve them lazily so this
    # module never imports them at load time.
    if name == "LifecycleError":
        from repro_torch.core.incarnation import LifecycleError
        return LifecycleError
    if name == "SupervisorError":
        from repro_torch.core.supervisor import SupervisorError
        return SupervisorError
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
