"""repro_torch.api — the public, checkpoint-agnostic session surface
(the port of ``repro.api``; the same names, minus those whose modules
are not ported yet: FleetRouter, MoveResult and SupervisorError wait
for ROADMAP A7).

Applications import ONLY from here: the ``CheckpointableApp`` protocol
to implement, the ``CheckpointSession`` facade that owns the snapshot /
restore / supervise lifecycle, the frozen ``Policy`` value, the
URI-spec registries (``register_backend`` / ``register_app_kind`` /
``register_codec``), the typed error hierarchy, and the state-declaration
types (``UpperHalf``, ``OpLog``) re-exported so app code never reaches
into ``repro_torch.core``. See ARCHITECTURE.md "Public API".

Exports resolve lazily (PEP 562): ``repro_torch.core`` modules import
``repro_torch.api.errors`` at their own load time, so this package must stay
import-cycle-neutral — nothing heavy runs until an attribute is asked
for.
"""
from __future__ import annotations

__all__ = [
    # facade + protocol
    "CheckpointSession",
    "CheckpointableApp",
    "RestoreContext",
    "Policy",
    "validate_app",
    # registries
    "register_app_kind",
    "register_backend",
    "register_codec",
    "resolve_app_kind",
    "resolve_backend",
    "parse_store_spec",
    "available_codecs",
    # state declaration (re-exports: apps never import repro_torch.core)
    "UpperHalf",
    "OpLog",
    # typed errors
    "CheckpointError",
    "PolicyError",
    "BackendUnavailable",
    "SnapshotError",
    "RestoreError",
    "MigrationError",
    "StaleHandleError",
    "LifecycleError",
    "errors",
]

_HOMES = {
    "CheckpointSession": "repro_torch.api.session",
    "CheckpointableApp": "repro_torch.api.app",
    "RestoreContext": "repro_torch.api.app",
    "validate_app": "repro_torch.api.app",
    "Policy": "repro_torch.api.policy",
    "register_app_kind": "repro_torch.api.registry",
    "register_backend": "repro_torch.api.registry",
    "register_codec": "repro_torch.api.registry",
    "resolve_app_kind": "repro_torch.api.registry",
    "resolve_backend": "repro_torch.api.registry",
    "parse_store_spec": "repro_torch.api.registry",
    "available_codecs": "repro_torch.api.registry",
    "UpperHalf": "repro_torch.core.split_state",
    "OpLog": "repro_torch.core.oplog",
    "CheckpointError": "repro_torch.api.errors",
    "PolicyError": "repro_torch.api.errors",
    "BackendUnavailable": "repro_torch.api.errors",
    "SnapshotError": "repro_torch.api.errors",
    "RestoreError": "repro_torch.api.errors",
    "MigrationError": "repro_torch.api.errors",
    "StaleHandleError": "repro_torch.api.errors",
    "LifecycleError": "repro_torch.api.errors",
}


def __getattr__(name: str):
    if name == "errors":
        import repro_torch.api.errors as errors
        return errors
    home = _HOMES.get(name)
    if home is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(home), name)


def __dir__():
    return sorted(__all__)
