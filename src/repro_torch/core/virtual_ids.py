"""Virtual handle translation (paper §III).

The runtime hands out resources whose real identities are not stable
across a restart: meshes bound to physical devices, compiled executables,
KV-cache allocations. Exactly like OpenGL's GLuint ids, the real handle
obtained after restart differs from the one obtained originally — so the
application (and the op-log) only ever hold *virtual ids*, and a
translation table maps them to the current incarnation's real objects.

On restore, replay repopulates the table: the same vids come to denote
freshly created real objects, and nothing above the table notices.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Generic, Iterator, Optional, Tuple, TypeVar

T = TypeVar("T")


class StaleHandleError(KeyError):
    """A vid from a previous incarnation was used without rebinding."""


@dataclass(frozen=True)
class VirtualId:
    """Opaque, serializable handle. ``kind`` is a namespace ("mesh",
    "exec", "cache", ...); ``uid`` is unique within the table's life
    across incarnations (monotone, never reused)."""

    kind: str
    uid: int

    def __repr__(self) -> str:
        return f"<v:{self.kind}#{self.uid}>"


class HandleTable:
    """vid -> real object, with incarnation generations.

    * ``create(kind, obj)``  — allocate a vid bound to obj (logged side).
    * ``bind(vid, obj)``     — (re)bind an existing vid (replay side).
    * ``translate(vid)``     — real object for the *current* incarnation;
                               raises StaleHandleError if not rebound.
    * ``new_incarnation()``  — invalidate all bindings (fresh lower half),
                               keeping vids allocated so replay can rebind.
    """

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._next_uid = itertools.count(1)
        self._generation = 0
        # vid -> (generation, obj)
        self._real: Dict[VirtualId, Tuple[int, Any]] = {}
        self._allocated: Dict[VirtualId, None] = {}

    @property
    def generation(self) -> int:
        return self._generation

    def create(self, kind: str, obj: Any) -> VirtualId:
        with self._lock:
            vid = VirtualId(kind, next(self._next_uid))
            self._allocated[vid] = None
            self._real[vid] = (self._generation, obj)
            return vid

    def allocate(self, kind: str) -> VirtualId:
        """Allocate a vid with no binding yet (e.g. pre-declared)."""
        with self._lock:
            vid = VirtualId(kind, next(self._next_uid))
            self._allocated[vid] = None
            return vid

    def bind(self, vid: VirtualId, obj: Any) -> VirtualId:
        with self._lock:
            if vid not in self._allocated:
                # replay of a log from a previous process: adopt the vid,
                # bumping the uid counter past it so future ids stay unique
                self._allocated[vid] = None
                self._next_uid = itertools.count(
                    max(vid.uid + 1, next(self._next_uid)))
            self._real[vid] = (self._generation, obj)
            return vid

    def translate(self, vid: VirtualId) -> Any:
        with self._lock:
            entry = self._real.get(vid)
            if entry is None:
                raise StaleHandleError(
                    f"{vid} has no binding in generation {self._generation}")
            gen, obj = entry
            if gen != self._generation:
                raise StaleHandleError(
                    f"{vid} bound in generation {gen}, current is "
                    f"{self._generation}; replay must rebind it")
            return obj

    def is_bound(self, vid: VirtualId) -> bool:
        with self._lock:
            e = self._real.get(vid)
            return e is not None and e[0] == self._generation

    def release(self, vid: VirtualId) -> None:
        with self._lock:
            self._real.pop(vid, None)
            self._allocated.pop(vid, None)

    def new_incarnation(self) -> int:
        """Start a fresh lower half: every binding becomes stale."""
        with self._lock:
            self._generation += 1
            return self._generation

    def live_vids(self):
        with self._lock:
            return [v for v, (g, _) in self._real.items()
                    if g == self._generation]


# --- host correspondence -----------------------------------------------------

class HostMap:
    """Logical host coordinate -> physical host rank, via the same
    vid/handle indirection as every other unstable resource.

    A multi-host job addresses its peers by *logical* rank (shard
    ownership, collective neighbors, heartbeat identity). The physical
    rank behind a logical host is exactly as unstable as a GLuint: a
    hot-spare takeover rebinds the dead host's logical coordinate to the
    spare's physical rank, and nothing holding the logical id notices —
    the supervisor's failure loop (``core.supervisor``) drives these
    rebinds. Translation goes through a ``HandleTable``, so a logical
    host whose physical backing died and was never remapped raises
    ``StaleHandleError`` instead of silently resolving to a corpse."""

    def __init__(self, hosts) -> None:
        self._table = HandleTable()
        self._vids: Dict[int, VirtualId] = {
            l: self._table.create("host", p) for l, p in enumerate(hosts)}

    def logical_hosts(self) -> list:
        return sorted(self._vids)

    def vid(self, logical: int) -> VirtualId:
        return self._vids[logical]

    def physical(self, logical: int) -> int:
        """Current physical rank behind a logical host (raises
        StaleHandleError if it was unbound and never remapped)."""
        return self._table.translate(self._vids[logical])

    def physical_hosts(self) -> list:
        """Physical ranks of every *bound* logical host, logical order."""
        return [self._table.translate(v)
                for l, v in sorted(self._vids.items())
                if self._table.is_bound(v)]

    def logical_of(self, physical: int) -> Optional[int]:
        for l in sorted(self._vids):
            v = self._vids[l]
            if self._table.is_bound(v) and \
                    self._table.translate(v) == physical:
                return l
        return None

    def remap(self, logical: int, physical: int) -> VirtualId:
        """Hot-spare takeover: the same logical coordinate now denotes a
        different physical host; the vid is stable across the rebind."""
        return self._table.bind(self._vids[logical], physical)

    def unbind(self, logical: int) -> None:
        """Shrink: the logical host leaves the world (its vid survives,
        translating it raises until a future grow remaps it; ``bind``
        re-adopts released vids, so ``remap`` can revive the slot)."""
        self._table.release(self._vids[logical])

    def admit(self, physical: int) -> int:
        """Grow: bind a physical host to a logical slot — the lowest
        coordinate a shrink/drain vacated if one exists (``bind``
        re-adopts the released vid, so shard ownership keyed on the
        logical rank revives with it), else a brand-new coordinate past
        the current world. Returns the logical rank."""
        for l in sorted(self._vids):
            if not self._table.is_bound(self._vids[l]):
                self._table.bind(self._vids[l], physical)
                return l
        l = max(self._vids) + 1 if self._vids else 0
        self._vids[l] = self._table.create("host", physical)
        return l


# --- device correspondence ---------------------------------------------------

class DeviceMap:
    """Logical mesh coordinate -> physical device, per incarnation.

    The upper half references only (axis_name, index) coordinates; this is
    the paper's upper/lower thread-correspondence problem mapped to
    devices. Elastic restarts rebuild it over a different topology."""

    def __init__(self) -> None:
        self._mesh = None

    def bind_mesh(self, mesh) -> None:
        self._mesh = mesh

    def device_at(self, **coords):
        if self._mesh is None:
            raise StaleHandleError("no mesh bound in this incarnation")
        idx = tuple(coords.get(a, 0) for a in self._mesh.axis_names)
        return self._mesh.devices[idx]

    @property
    def mesh(self):
        if self._mesh is None:
            raise StaleHandleError("no mesh bound in this incarnation")
        return self._mesh
