"""Split-process state partition (paper §II), adapted to a PyTorch runtime.

``UpperHalf`` — the application half: semantic training/serving state
(params, optimizer moments, RNG counters, data cursor, step). Stored as
*logically addressed* nested dicts of tensors and arrays: every leaf is
reachable by a stable path string (the JAX package's keystr paths, see
``repro_torch.tree``) and may be annotated with logical axes. This is
the only state a checkpoint saves.

``LowerHalf`` — the driver half: the device, registered step functions,
live cache allocations, schedule overrides, data-shard assignment. Never
serialized. Every mutating entry point both executes and appends to the
op-log, so a fresh LowerHalf can be driven back into an equivalent state
by replay (core.oplog). The op-log's JSON is the reference's, op for op:
``MeshCreate`` binds a ``torch.device`` here (where the JAX package
built a ``jax.sharding.Mesh``), and ``Compile`` binds a registered
Python step function — PyTorch runs eagerly, so there is nothing to jit.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.oplog import (
    OpLog, Op, MeshCreate, Compile, CacheAlloc, CacheFree, DataAdvance,
    DataReassign, ScheduleSet,
)
from repro_torch.core.virtual_ids import HandleTable, DeviceMap, VirtualId
from repro_torch.host import dtype_name, host_copy, resolve_device
from repro_torch.tree import fill_like, flatten_with_paths, tree_from_paths

__all__ = ["UpperHalf", "LowerHalf", "StateEntry", "FUNCTION_REGISTRY",
           "register_step_fn", "fill_like", "flatten_with_paths",
           "tree_from_paths"]


# ---------------------------------------------------------------------------
# upper half
# ---------------------------------------------------------------------------

@dataclass
class StateEntry:
    kind: str                  # params | opt_state | rng | data_cursor | ...
    tree: Any                  # nested dict (tensors / host arrays / scalars)
    logical: Any = None        # matching pytree of logical axis tuples


class UpperHalf:
    """Named registry of semantic state entries."""

    def __init__(self) -> None:
        self._entries: Dict[str, StateEntry] = {}

    def register(self, name: str, kind: str, tree, logical=None) -> None:
        self._entries[name] = StateEntry(kind, tree, logical)

    def update(self, name: str, tree) -> None:
        self._entries[name].tree = tree

    def get(self, name: str):
        return self._entries[name].tree

    def entry(self, name: str) -> StateEntry:
        return self._entries[name]

    def names(self) -> List[str]:
        return list(self._entries)

    def items(self):
        return self._entries.items()

    def to_host(self) -> Dict[str, Dict[str, Any]]:
        """Copy every leaf to the host: {entry: {leaf_path: CPU tensor or
        np.ndarray}}.

        This is the checkpoint's payload — note it contains no handles,
        no devices, no executables (the split-process guarantee).

        Every leaf is COPIED at the snapshot point (``host_copy``):
        ``.cpu()`` of a CPU tensor and ``.numpy()`` alias their source,
        and a caller mutating state after save() returns would race the
        async background writer."""
        return {name: {p: host_copy(v)
                       for p, v in flatten_with_paths(e.tree)}
                for name, e in self._entries.items()}

    def structure(self) -> Dict[str, Any]:
        """JSON-able description (kinds + leaf shapes/dtypes + logical)."""
        desc = {}
        for name, e in self._entries.items():
            leaves = {}
            for p, v in flatten_with_paths(e.tree):
                # shape/dtype description needs no device transfer:
                # array-likes carry both already; scalar/non-array
                # leaves (int, float, list) are viewed through numpy
                arr = v if hasattr(v, "shape") else np.asarray(v)
                leaves[p] = {"shape": list(arr.shape),
                             "dtype": dtype_name(arr)}
            logical = None
            if e.logical is not None:
                logical = {p: list(ax) for p, ax in flatten_with_paths(e.logical)}
            desc[name] = {"kind": e.kind, "leaves": leaves, "logical": logical}
        return desc


# ---------------------------------------------------------------------------
# function registry: Compile ops resolve through here
# ---------------------------------------------------------------------------

# fn_name -> builder(arch, shape_key, plan_key, lower_half) -> callable
# (a plain Python step function: the port runs eagerly, no jit)
FUNCTION_REGISTRY: Dict[str, Callable] = {}


def register_step_fn(name: str):
    def deco(builder):
        FUNCTION_REGISTRY[name] = builder
        return builder
    return deco


# ---------------------------------------------------------------------------
# lower half
# ---------------------------------------------------------------------------

class LowerHalf:
    """The reinitializable driver half.

    Construction is cheap and touches no devices; ``mesh_create`` (direct
    or via replay) binds hardware. A restart constructs a new LowerHalf
    (or calls ``reset()``) and replays the op-log.

    ``mesh_factory`` supplies the ``torch.device`` a ``MeshCreate``
    binds (the caller's choice of card or CPU); without one, the op
    binds the CUDA card (``host.resolve_device``).
    """

    def __init__(self, handles: Optional[HandleTable] = None,
                 oplog: Optional[OpLog] = None,
                 mesh_factory: Optional[Callable] = None) -> None:
        self.handles = handles or HandleTable()
        self.oplog = oplog or OpLog()
        self.devices = DeviceMap()
        # mesh_factory overrides logged mesh geometry (elastic restore)
        self.mesh_factory = mesh_factory
        self.vmesh: Optional[VirtualId] = None
        self.schedule_overrides: Dict[str, float] = {}
        self.data_cursor_replayed = 0
        self.data_assignment: Optional[Tuple[Tuple[int, int], ...]] = None
        self._compiled: Dict[Tuple[str, str, str, str], VirtualId] = {}
        self._lock = threading.RLock()

    # --- logged public API (execute + append) --------------------------

    def mesh_create(self, shape, axes) -> VirtualId:
        with self._lock:
            vmesh = self.handles.allocate("mesh")
            op = self.oplog.append(MeshCreate, vmesh=vmesh,
                                   shape=tuple(shape), axes=tuple(axes))
            self._apply(op)
            return vmesh

    def compile_step(self, fn_name: str, arch: str, shape_key: str,
                     plan_key: str = "") -> VirtualId:
        with self._lock:
            vexec = self.handles.allocate("exec")
            op = self.oplog.append(Compile, vexec=vexec, fn_name=fn_name,
                                   arch=arch, shape_key=shape_key,
                                   plan_key=plan_key)
            self._apply(op)
            return vexec

    def cache_alloc(self, arch: str, batch: int, max_seq: int) -> VirtualId:
        with self._lock:
            vcache = self.handles.allocate("cache")
            op = self.oplog.append(CacheAlloc, vcache=vcache, arch=arch,
                                   batch=batch, max_seq=max_seq)
            self._apply(op)
            return vcache

    def cache_free(self, vcache: VirtualId) -> None:
        with self._lock:
            op = self.oplog.append(CacheFree, vcache=vcache)
            self._apply(op)

    def data_advance(self, n: int) -> None:
        with self._lock:
            op = self.oplog.append(DataAdvance, n=n)
            self._apply(op)

    def data_reassign(self, assignment) -> None:
        with self._lock:
            op = self.oplog.append(
                DataReassign, assignment=tuple(map(tuple, assignment)))
            self._apply(op)

    def schedule_set(self, key: str, value: float) -> None:
        with self._lock:
            op = self.oplog.append(ScheduleSet, key=key, value=float(value))
            self._apply(op)

    # --- resolution ------------------------------------------------------

    @property
    def mesh(self):
        return self.devices.mesh

    def executable(self, vexec: VirtualId):
        return self.handles.translate(vexec)

    def cache(self, vcache: VirtualId):
        return self.handles.translate(vcache)

    # --- replay side -----------------------------------------------------

    def reset(self) -> None:
        """Fresh incarnation: drop all real bindings (the 'kill the driver'
        moment). vids stay allocated; replay rebinds them."""
        self.handles.new_incarnation()
        self.devices = DeviceMap()
        self.vmesh = None
        self.schedule_overrides = {}
        self.data_cursor_replayed = 0
        self.data_assignment = None
        self._compiled = {}

    def apply_op(self, op: Op) -> None:
        """Execute one op without logging (replay path)."""
        self._apply(op)

    def _apply(self, op: Op) -> None:
        if isinstance(op, MeshCreate):
            if self.mesh_factory is not None:
                mesh = self.mesh_factory()
            else:
                if int(np.prod(op.shape)) != 1:
                    raise NotImplementedError(
                        f"a {tuple(op.shape)} device mesh: the port runs "
                        "on one device until ROADMAP A9 (DeviceMesh)")
                mesh = resolve_device(None)
            self.devices.bind_mesh(mesh)
            self.handles.bind(op.vmesh, mesh)
            self.vmesh = op.vmesh
        elif isinstance(op, Compile):
            key = (op.fn_name, op.arch, op.shape_key, op.plan_key)
            if key in self._compiled and self.handles.is_bound(
                    self._compiled[key]):
                # identical compilation already live: alias the vid to the
                # existing executable instead of recompiling
                fn = self.handles.translate(self._compiled[key])
            else:
                builder = FUNCTION_REGISTRY[op.fn_name]
                fn = builder(op.arch, op.shape_key, op.plan_key, self)
                self._compiled[key] = op.vexec
            self.handles.bind(op.vexec, fn)
        elif isinstance(op, CacheAlloc):
            from repro_torch.serving.kv_cache import allocate_cache
            cache = allocate_cache(op.arch, op.batch, op.max_seq, self)
            self.handles.bind(op.vcache, cache)
        elif isinstance(op, CacheFree):
            self.handles.release(op.vcache)
        elif isinstance(op, DataAdvance):
            self.data_cursor_replayed += op.n
        elif isinstance(op, DataReassign):
            self.data_assignment = op.assignment
        elif isinstance(op, ScheduleSet):
            self.schedule_overrides[op.key] = op.value
        else:
            raise TypeError(f"unknown op {op}")

    # --- observability (for tests / prune equivalence) -------------------

    def fingerprint(self) -> Dict[str, Any]:
        mesh = None
        try:
            mesh = str(self.devices.mesh)
        except Exception:
            pass
        compiled = sorted(
            key for key, vexec in self._compiled.items()
            if self.handles.is_bound(vexec))
        live_caches = sorted(
            v.uid for v in self.handles.live_vids() if v.kind == "cache")
        return {
            "mesh": mesh,
            "compiled": compiled,
            "caches": live_caches,
            "schedule": dict(self.schedule_overrides),
            "data_cursor": self.data_cursor_replayed,
            "assignment": self.data_assignment,
        }
