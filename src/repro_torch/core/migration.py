"""Live migration as a fleet primitive: planned snapshot → restore
moves of serving sessions between engines, with bounded blackout — the
port of ``repro.core.migration``. A ``SessionBundle`` keeps the
reference's app kind and entries, so a bundle written by either package
restores in the other.

The paper's split-process design exists so a running GPU application
can be moved off its hardware and reincarnated elsewhere without the
app noticing; CRIUgpu carries the same primitive into container live
migration, and MANA's agnostic transport shows the state can land on a
*different* world than it left. The supervisor (core/supervisor.py)
covers the reactive half — something died; this module is the
proactive half: nothing died, the operator wants the sessions
somewhere else (defrag, maintenance, rebalancing), and the move must
cost milliseconds of per-session blackout, not a restart.

The mechanism is deliberately the C/R protocol, not object handoff:

  freeze    ``ServingEngine.extract_sessions`` removes the chosen
            slots' live requests from the source WITHOUT stopping its
            decode loop — unaffected slots keep generating, freed
            slots refill from the source queue;
  capture   the frozen sessions become a ``SessionBundle`` — a
            CheckpointableApp whose upper half is the request trees —
            snapshotted through a dedicated *move channel*: its own
            store under ``<store>/_moves/...`` with ``chain=1``, so
            migration traffic can never interleave with (or corrupt)
            the source engine's periodic delta chain;
  restore   the bundle restores (streaming by default) on the target
            side and every session re-enters through admission, so an
            N-slot engine's sessions land on an M-slot engine
            token-identically. The port's bundle also carries each
            session's cache column (``ServingEngine.session_columns``),
            which lands in its new slot as a re-slotted session's does;
            a move onto a target whose cache it does not fit raises
            ``MigrationError`` before the source gives anything up. The
            JAX package's bundle carries no cache: its target
            re-prefills every history, which on an H100 in bf16 parted
            requests' tokens (ROADMAP C23, a port-only divergence), and
            such a bundle still restores in the port that way;
  cutover   requests that arrived mid-move for the draining engine
            were held by the router and are replayed on the target.

Per-session blackout is bounded by the *batch size*, not the engine
size: ``migrate_batch`` sessions freeze per round while the rest keep
decoding — the knob (``Policy.migrate_batch``) trades total move time
against worst-case per-session stall. ``MoveResult`` reports each
batch's blackout.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.errors import MigrationError

# entry kinds follow the serving engine's vocabulary: request trees are
# scheduler state (hot tier under a streaming restore — a move wants
# the sessions first, always)
_BUNDLE_KIND = "serving-move"


def _request_cls():
    # serving imports core, never the reverse — resolve the concrete
    # Request type lazily, only where a bundle rebuilds one
    from repro_torch.serving.engine import Request
    return Request


def _request_tree(r: Any) -> Dict[str, np.ndarray]:
    from repro_torch.serving.engine import _request_tree as enc
    return enc(r)


def _request_from_tree(t: Dict[str, Any]) -> Any:
    from repro_torch.serving.engine import _request_from_tree as dec
    return dec(t)


class SessionBundle:
    """The unit of migration: frozen live sessions as a protocol
    citizen. Snapshotting and restoring it through a CheckpointSession
    IS the transport — the bundle never assumes source and target share
    a process, only a store.

    ``columns`` ({rid: cache column}, batch 1) ride along as the
    ``carried`` entry (kind ``cache``, the serving engine's layout); a
    restored bundle holds that entry's leaf paths and host arrays as
    ``carried`` (empty for a bundle written without columns, as the JAX
    package writes it)."""

    kind = _BUNDLE_KIND

    def __init__(self, requests: Sequence[Any] = (),
                 source_step: int = 0,
                 columns: Optional[Dict[int, Any]] = None) -> None:
        self.requests: List[Any] = list(requests)
        self.source_step = int(source_step)
        self.columns: Dict[int, Any] = dict(columns or {})
        self.carried: Dict[str, Any] = {}

    # --- CheckpointableApp protocol ------------------------------------

    def checkpoint_state(self):
        from repro_torch.core.split_state import UpperHalf
        up = UpperHalf()
        up.register("moved", "sched",
                    {f"{i:06d}": _request_tree(r)
                     for i, r in enumerate(self.requests)})
        up.register("source_step", "step", np.int64(self.source_step))
        if self.columns:
            up.register("carried", "cache",
                        {str(rid): col for rid, col in self.columns.items()})
        return up

    def checkpoint_step(self) -> int:
        return self.source_step

    def job_meta(self) -> Dict[str, Any]:
        return {"kind": self.kind, "n_sessions": len(self.requests)}

    def bind(self, restore) -> None:
        moved = restore.tree("moved") if restore.has("moved") else {}
        self.requests = [_request_from_tree(v)
                         for _, v in sorted(moved.items())]
        self.source_step = int(restore.scalar("source_step"))
        self.carried = {}
        if restore.has("carried"):
            cols = restore.paths("carried")
            if callable(getattr(cols, "wait", None)):
                cols.wait()      # a streamed restore: the cold tier
            self.carried = {p: cols[p] for p in cols}
        restore.release()


def _register_bundle_kind() -> None:
    from repro_torch.api.registry import resolve_app_kind, register_app_kind
    try:
        resolve_app_kind(_BUNDLE_KIND)
        return
    except Exception:
        pass

    @register_app_kind(_BUNDLE_KIND)
    def _restore_bundle(restore) -> SessionBundle:
        bundle = SessionBundle()
        bundle.bind(restore)
        return bundle


_register_bundle_kind()


@dataclass
class MoveResult:
    """One executed move, with its blackout accounting. ``blackout_s``
    is the WORST per-batch freeze→serving-again wall time — the number
    a session could observe; totals are what the operator paid."""
    move_id: int
    source: str
    target: str
    moved: List[int] = field(default_factory=list)   # rids, move order
    batches: List[Dict[str, float]] = field(default_factory=list)
    blackout_s: float = 0.0
    capture_s: float = 0.0
    restore_s: float = 0.0
    replayed: int = 0            # held mid-move requests flushed at cutover
    carried: int = 0             # sessions whose cache column landed
    deadline_s: Optional[float] = None
    within_deadline: bool = True
    requests: List[Any] = field(default_factory=list)  # landed objects


def _channel_spec(via: str, sub: str) -> str:
    """A store spec for one move channel under ``via``: same scheme,
    sub-path appended — migration traffic lives beside the engine's
    chain, never inside it."""
    from repro_torch.api.registry import parse_store_spec
    if via.startswith("/"):
        via = f"localfs:{via}"
    scheme, path, params = parse_store_spec(via)
    q = "&".join(f"{k}={v}" for k, v in params.items())
    return f"{scheme}:{path.rstrip('/')}/{sub}" + (f"?{q}" if q else "")


def _chunks(seq: List[Any], n: int) -> List[List[Any]]:
    return [list(seq[i:i + n]) for i in range(0, len(seq), n)]


def migrate_sessions(source: Any, target: Any, *, via: str,
                     slots: Optional[Sequence[int]] = None,
                     include_queue: bool = False,
                     batch: Optional[int] = None,
                     deadline_s: Optional[float] = None,
                     streaming: bool = True,
                     move_id: int = 0,
                     source_name: str = "source",
                     target_name: str = "target",
                     settle: bool = True) -> MoveResult:
    """Move live sessions from ``source`` onto ``target`` through the
    C/R protocol, batch by batch.

    Each batch freezes at most ``batch`` slots (None = all chosen slots
    at once), snapshots them as a ``SessionBundle`` on a fresh move
    channel under ``via``, restores the bundle (``streaming`` by
    default) and re-admits every session on the target; ``settle`` runs
    one target engine step so the batch's blackout clock stops at
    "serving again", not "queued". The source keeps decoding its
    remaining slots between batches. ``deadline_s`` is judged against
    the worst per-batch blackout and reported on the result — a planned
    move that missed its drain deadline must be visible, not silent.

    A source that serves over a mesh is moved from every rank of its
    mesh: each reads the chosen slots' columns (collective; they land
    whole on the mesh's lead rank) and frees the slots, and only the
    lead, which holds the target, goes on through the move channel. The
    other ranks pass ``target=None`` and get the moved rids alone."""
    from repro_torch.api.policy import Policy
    from repro_torch.api.session import CheckpointSession

    commits = getattr(source, "commits", None)
    lead = not callable(commits) or commits()
    for attr, owner, role in (("extract_sessions", source, "source"),
                              ("submit", target, "target"),
                              ("step", target, "target")):
        if owner is None and not lead:
            continue
        if not callable(getattr(owner, attr, None)):
            raise MigrationError(
                f"{role} {type(owner).__name__} has no {attr}(); live "
                "migration needs a serving-style engine on both ends")

    active = [s for s in range(source.n_slots)
              if source.slot_req[s] is not None]
    chosen = active if slots is None else \
        [s for s in slots if source.slot_req[s] is not None]
    if batch is not None and batch < 1:
        raise MigrationError(f"batch={batch}: a move batch freezes at "
                             "least one slot")
    shapes = [getattr(e, "column_shapes", None) for e in (source, target)]
    if chosen and lead and all(map(callable, shapes)) and \
            shapes[0]() != shapes[1]():
        # checked before the source gives anything up: a begun session
        # lands with its cache column, which must fit the target's cache
        raise MigrationError(
            f"the cache columns of {source_name}'s sessions do not fit "
            f"{target_name}'s cache (another model or max_seq); a move "
            "lands each begun session with its column (ROADMAP C23)")

    res = MoveResult(move_id=move_id, source=source_name,
                     target=target_name, deadline_s=deadline_s)
    batches = _chunks(chosen, batch or max(1, len(chosen))) or [[]]
    policy = Policy(chain=1, async_save=False)
    for bi, group in enumerate(batches):
        last = bi == len(batches) - 1
        t0 = time.monotonic()
        columns = getattr(source, "session_columns", None)
        cols = columns(group) if group and callable(columns) else {}
        reqs = source.extract_sessions(group) if group else []
        if last and include_queue:
            if callable(columns):
                cols.update(columns([], include_queue=True))
            reqs += source.extract_sessions([], include_queue=True)
        if not reqs:
            continue
        if not lead:
            res.moved += [r.rid for r in reqs]
            continue
        spec = _channel_spec(via, f"_moves/m{move_id:04d}_{bi}")
        with CheckpointSession(spec, policy) as chan:
            chan.attach(SessionBundle(reqs, source.steps, columns=cols))
            chan.snapshot(block=True)
            t1 = time.monotonic()
            landed = chan.restore("latest", expect_kind=_BUNDLE_KIND,
                                  streaming=streaming)
        t2 = time.monotonic()
        if landed.carried and callable(getattr(target, "carry", None)):
            res.carried += len(target.carry(landed.carried))
        for r in landed.requests:
            target.submit(r)
        if settle:
            target.step()      # admission replay + the next token: the
        t3 = time.monotonic()  # moved sessions are being served again
        res.moved += [r.rid for r in landed.requests]
        res.requests += list(landed.requests)
        res.capture_s += t1 - t0
        res.restore_s += t2 - t1
        res.batches.append({"n": float(len(reqs)),
                            "blackout_s": t3 - t0,
                            "capture_s": t1 - t0,
                            "restore_s": t2 - t1})
        res.blackout_s = max(res.blackout_s, t3 - t0)
    if deadline_s is not None and res.blackout_s > deadline_s:
        res.within_deadline = False
    return res


class FleetRouter:
    """Routes requests over named live engines and moves sessions
    between them with bounded blackout.

    The router is the fleet's front door: ``submit`` picks the least
    loaded engine (or honors a pin), ``step`` advances every engine one
    decode round and collects finished requests exactly once —
    ``duplicates`` and ``dropped()`` make the zero-loss claim a counter,
    not a hope. ``migrate``/``drain`` run the snapshot→restore move
    while the source keeps serving; requests pinned to a draining
    engine are *held* and replayed on the target at cutover."""

    def __init__(self, engines: Dict[str, Any], via: str, *,
                 migrate_batch: Optional[int] = None,
                 drain_deadline_s: Optional[float] = None) -> None:
        if not engines:
            raise MigrationError("FleetRouter needs at least one engine")
        self.engines = dict(engines)
        self.via = via
        self.migrate_batch = migrate_batch
        self.drain_deadline_s = drain_deadline_s
        self.owner: Dict[int, str] = {}
        self.inflight: Dict[int, Any] = {}
        self.completed: Dict[int, Any] = {}
        self.duplicates = 0
        self.draining: set = set()
        self.moves: List[MoveResult] = []
        self._held: List[Tuple[str, Any]] = []
        self._next_rid = 1
        self._next_move = 0

    # --- routing --------------------------------------------------------

    def _load(self, name: str) -> int:
        return len(self.engines[name].live_requests())

    def submit(self, prompt, max_new: int, *,
               engine: Optional[str] = None) -> int:
        """Route one request; returns its rid. A request pinned to a
        draining engine is held and replayed on the move's target."""
        rid = self._next_rid
        self._next_rid += 1
        req = _request_cls()(rid=rid,
                             prompt=np.asarray(prompt, np.int32),
                             max_new=int(max_new))
        self.inflight[rid] = req
        if engine is not None and engine in self.draining:
            self._held.append((engine, req))
            self.owner[rid] = engine
            return rid
        open_engines = [n for n in self.engines if n not in self.draining]
        if not open_engines:
            raise MigrationError("every engine is draining; nowhere to "
                                 "route the request")
        name = engine if engine is not None else \
            min(open_engines, key=self._load)
        if name not in self.engines:
            raise MigrationError(f"unknown engine {name!r} "
                                 f"(have {sorted(self.engines)})")
        self.engines[name].submit(req)
        self.owner[rid] = name
        return rid

    def step(self) -> int:
        """One decode round across the fleet; returns active slots."""
        active = 0
        for name, eng in self.engines.items():
            if name in self.draining and not eng.live_requests():
                continue
            active += eng.step()
        self._collect()
        return active

    def _collect(self) -> None:
        for rid, req in list(self.inflight.items()):
            if req.done:
                if rid in self.completed:
                    self.duplicates += 1
                else:
                    self.completed[rid] = req
                del self.inflight[rid]

    def dropped(self) -> List[int]:
        """rids that are neither in flight nor completed — must be
        empty at all times for the zero-loss claim to hold."""
        return sorted(set(self.owner) - set(self.completed)
                      - set(self.inflight))

    # --- moves ----------------------------------------------------------

    def migrate(self, src: str, dst: str, *,
                slots: Optional[Sequence[int]] = None,
                include_queue: bool = False,
                batch: Optional[int] = None,
                deadline_s: Optional[float] = None,
                streaming: bool = True,
                keep_draining: bool = False) -> MoveResult:
        """Move ``slots`` (default: every live session) from engine
        ``src`` to ``dst``. The source serves its unaffected slots
        throughout; held mid-move requests replay on the target."""
        for name in (src, dst):
            if name not in self.engines:
                raise MigrationError(f"unknown engine {name!r} "
                                     f"(have {sorted(self.engines)})")
        if src == dst:
            raise MigrationError(f"migrate {src!r} -> itself is a no-op "
                                 "asked loudly; pick a different target")
        move_id = self._next_move
        self._next_move += 1
        self.draining.add(src)
        try:
            res = migrate_sessions(
                self.engines[src], self.engines[dst], via=self.via,
                slots=slots, include_queue=include_queue,
                batch=batch if batch is not None else self.migrate_batch,
                deadline_s=deadline_s if deadline_s is not None
                else self.drain_deadline_s,
                streaming=streaming, move_id=move_id,
                source_name=src, target_name=dst)
            # the landed request objects are the live ones now — the
            # router must watch them, not the frozen source-side twins
            for r in res.requests:
                self.inflight[r.rid] = r
                self.owner[r.rid] = dst
            held, self._held = self._held, []
            for name, req in held:
                if name == src:
                    self.engines[dst].submit(req)
                    self.owner[req.rid] = dst
                    res.replayed += 1
                else:
                    self._held.append((name, req))
        finally:
            if not keep_draining:
                self.draining.discard(src)
        self._collect()
        self.moves.append(res)
        return res

    def drain(self, src: str, dst: str, *,
              deadline_s: Optional[float] = None) -> MoveResult:
        """Move EVERYTHING off ``src`` — live slots and waiting queue —
        and keep it out of the routing rotation afterwards (the
        maintenance form of ``migrate``)."""
        return self.migrate(src, dst, include_queue=True,
                            deadline_s=deadline_s, keep_draining=True)

    # --- observability --------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        return {
            "engines": {n: self._load(n) for n in self.engines},
            "draining": sorted(self.draining),
            "submitted": self._next_rid - 1,
            "completed": len(self.completed),
            "inflight": len(self.inflight),
            "held": len(self._held),
            "duplicates": self.duplicates,
            "dropped": len(self.dropped()),
            "moves": len(self.moves),
            "worst_blackout_s": max((m.blackout_s for m in self.moves),
                                    default=0.0),
        }
