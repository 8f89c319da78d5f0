"""Log-and-replay of runtime-mutating operations (paper §III).

The lower half's state machine (mesh, compiled executables, cache
allocations, data-shard assignment, schedule mutations) cannot be
serialized — but every call that mutates it flows through this log. On
restore the log is replayed against a *fresh* lower half, driving it into
an equivalent state, exactly as the paper replays OpenGL calls against a
freshly loaded driver.

Pruning implements the record-prune-replay idea the paper cites as future
work (§VI): ops whose effects are dead (freed caches, superseded
compilations, coalesced data seeks, overwritten schedule sets) are removed
so the log stays O(live state) instead of O(history). The invariant —
``replay(prune(log)) == replay(log)`` up to observable lower-half state —
is property-tested.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, asdict
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.virtual_ids import VirtualId


# ---------------------------------------------------------------------------
# ops — pure-data records; only vids + JSON-able args
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Op:
    seq: int

    def is_mutating(self) -> bool:
        return True


@dataclass(frozen=True)
class MeshCreate(Op):
    vmesh: VirtualId = None
    shape: Tuple[int, ...] = ()
    axes: Tuple[str, ...] = ()


@dataclass(frozen=True)
class Compile(Op):
    """Request compilation of a registered step function."""
    vexec: VirtualId = None
    fn_name: str = ""            # key in the FunctionRegistry
    arch: str = ""
    shape_key: str = ""          # input-shape cell
    plan_key: str = ""           # serialized plan knobs


@dataclass(frozen=True)
class CacheAlloc(Op):
    vcache: VirtualId = None
    arch: str = ""
    batch: int = 0
    max_seq: int = 0


@dataclass(frozen=True)
class CacheFree(Op):
    vcache: VirtualId = None


@dataclass(frozen=True)
class DataAdvance(Op):
    """The data pipeline consumed n batches (cursor moves forward)."""
    n: int = 0


@dataclass(frozen=True)
class DataReassign(Op):
    """Straggler mitigation re-balanced host->shard ownership."""
    assignment: Tuple[Tuple[int, int], ...] = ()   # (host, shard) pairs


@dataclass(frozen=True)
class ScheduleSet(Op):
    key: str = ""
    value: float = 0.0


OP_TYPES = {c.__name__: c for c in
            (MeshCreate, Compile, CacheAlloc, CacheFree, DataAdvance,
             DataReassign, ScheduleSet)}


# ---------------------------------------------------------------------------
# the log
# ---------------------------------------------------------------------------

class OpLog:
    def __init__(self, ops: Optional[List[Op]] = None) -> None:
        self._ops: List[Op] = list(ops or [])
        self._next_seq = (self._ops[-1].seq + 1) if self._ops else 0

    def append(self, op_cls, **kw) -> Op:
        op = op_cls(seq=self._next_seq, **kw)
        self._next_seq += 1
        self._ops.append(op)
        return op

    @property
    def ops(self) -> List[Op]:
        return list(self._ops)

    def __len__(self) -> int:
        return len(self._ops)

    # --- pruning (record-prune-replay) ---------------------------------

    def prune(self) -> "OpLog":
        """Remove ops with dead effects. Keeps relative order of survivors."""
        ops = self._ops
        keep = [True] * len(ops)

        # 1) CacheAlloc cancelled by a later CacheFree (and the free itself)
        freed = {}
        for i, op in enumerate(ops):
            if isinstance(op, CacheFree):
                freed[op.vcache] = i
        for i, op in enumerate(ops):
            if isinstance(op, CacheAlloc) and op.vcache in freed \
                    and freed[op.vcache] > i:
                keep[i] = False
                keep[freed[op.vcache]] = False

        # 2) duplicate Compile of the same (fn, arch, shape, plan): keep first
        seen_compiles = set()
        for i, op in enumerate(ops):
            if isinstance(op, Compile):
                key = (op.fn_name, op.arch, op.shape_key, op.plan_key)
                if key in seen_compiles:
                    keep[i] = False
                else:
                    seen_compiles.add(key)

        # 3) coalesce DataAdvance runs into a single seek (replace last)
        total_advance = sum(op.n for op in ops if isinstance(op, DataAdvance))
        seen_advance = False
        for i in range(len(ops) - 1, -1, -1):
            if isinstance(ops[i], DataAdvance):
                if seen_advance:
                    keep[i] = False
                seen_advance = True

        # 4) ScheduleSet: keep only the last per key
        seen_sched = set()
        for i in range(len(ops) - 1, -1, -1):
            if isinstance(ops[i], ScheduleSet):
                if ops[i].key in seen_sched:
                    keep[i] = False
                else:
                    seen_sched.add(ops[i].key)

        # 5) DataReassign: keep only the last
        seen_reassign = False
        for i in range(len(ops) - 1, -1, -1):
            if isinstance(ops[i], DataReassign):
                if seen_reassign:
                    keep[i] = False
                seen_reassign = True

        out = []
        for i, op in enumerate(ops):
            if not keep[i]:
                continue
            if isinstance(op, DataAdvance):
                op = DataAdvance(seq=op.seq, n=total_advance)
            out.append(op)
        return OpLog(out)

    # --- replay ----------------------------------------------------------

    def replay(self, runtime) -> None:
        """Drive a fresh lower half through the logged mutations.
        ``runtime`` is core.split_state.LowerHalf (duck-typed for tests)."""
        for op in self._ops:
            runtime.apply_op(op)

    # --- serialization ----------------------------------------------------

    def to_json(self) -> str:
        def enc(op: Op) -> Dict[str, Any]:
            d = asdict(op)
            d["__type__"] = type(op).__name__
            for k, v in list(d.items()):
                if isinstance(v, dict) and set(v) == {"kind", "uid"}:
                    d[k] = {"__vid__": True, **v}
            return d

        return json.dumps([enc(op) for op in self._ops])

    @classmethod
    def from_json(cls, s: str) -> "OpLog":
        raw = json.loads(s)
        ops: List[Op] = []
        for d in raw:
            t = OP_TYPES[d.pop("__type__")]
            for k, v in list(d.items()):
                if isinstance(v, dict) and v.get("__vid__"):
                    d[k] = VirtualId(v["kind"], v["uid"])
                elif isinstance(v, list):
                    d[k] = tuple(tuple(x) if isinstance(x, list) else x
                                 for x in v)
            ops.append(t(**d))
        return cls(ops)
