"""Churn: trace-driven fleet turbulence, survived — and measured (the
port of ``repro.core.churn``; numpy seeds the generators, so the same
seed gives the same trace, byte for byte, in both packages).

The fault-injection suite kills one host at one step; a real fleet sees
*continuous* churn: spot preemptions that arrive with a grace window,
Poisson host deaths, correlated rack failures, and — crucially — hosts
coming *back*. MANA-for-MPI and CRIUgpu (PAPERS.md) both frame C/R as a
fleet primitive precisely because failure there is a process, not an
event. This module makes churn a first-class, replayable input:

``ChurnTrace``   an ordered stream of ``ChurnEvent``s (``die``,
                 ``preempt`` with a grace window, ``return``, operator
                 ``drain``), serializable as JSONL so any observed or
                 generated churn pattern can be replayed bit-for-bit.
                 Seeded generators: ``poisson`` (independent exponential
                 interarrivals, a preemption fraction, deterministic
                 returns) and ``correlated_racks`` (a rack incident
                 takes every present member at the same instant).

``ChurnEngine``  drives a ``ClusterSupervisor`` through a trace on the
                 virtual clock. A ``preempt`` with sufficient grace is
                 handled *proactively* — snapshot + ``planned_move``
                 (drain onto a spare, or a deliberate shrink) before
                 the deadline, so the heartbeat-timeout path never
                 fires for it; an insufficient grace degrades to a
                 plain death at the deadline. A ``return`` re-admits
                 the host to the spare pool, and the engine *grows* the
                 world back toward its target size (``supervisor.grow``
                 — the inverse of shrink) the moment capacity is idle:
                 a recovered host rejoins as capacity, not dead weight.

``GoodputMeter`` the number that justifies all of the above: useful
                 steps ÷ attempted steps (deterministic on the virtual
                 clock) and useful steps ÷ wall-clock, with a
                 per-incident breakdown of steps lost to rollbacks
                 (``ChurnEngine.report``).

``IncidentLog``  the supervisor's event stream as operator-readable
                 JSONL, written as it happens — a churn run stays
                 post-mortem-able even if the supervisor itself dies.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

EVENT_KINDS = ("die", "preempt", "return", "drain")


@dataclass(frozen=True)
class ChurnEvent:
    """One fleet event at virtual time ``t`` (the step clock).

    ``die``      host stops heartbeating at ``t`` — the supervisor only
                 learns of it when the silence crosses the timeout;
    ``preempt``  a preemption *notice*: the host will be reclaimed at
                 ``t + grace_s``. Enough grace → proactive snapshot +
                 drain; too little → it is just a death at the deadline;
    ``return``   the host rejoins the fleet as idle capacity (spare
                 pool; an engine configured to grow consumes it);
    ``drain``    operator-initiated planned move of a healthy host that
                 stays in the fleet afterwards (maintenance).
    """
    t: float
    kind: str
    host: int
    grace_s: float = 0.0

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown churn event kind {self.kind!r} "
                f"(have {'/'.join(EVENT_KINDS)})")
        # times are floats on disk and in memory, so an int-authored
        # trace roundtrips through JSONL byte-for-byte
        object.__setattr__(self, "t", float(self.t))
        object.__setattr__(self, "grace_s", float(self.grace_s))

    def to_json(self) -> Dict[str, Any]:
        d = {"t": self.t, "kind": self.kind, "host": self.host}
        if self.kind == "preempt":
            d["grace_s"] = self.grace_s
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ChurnEvent":
        try:
            return cls(t=float(d["t"]), kind=str(d["kind"]),
                       host=int(d["host"]),
                       grace_s=float(d.get("grace_s", 0.0)))
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"bad churn event {d!r}: {e}") from e


class ChurnTrace:
    """An ordered, replayable churn event stream."""

    def __init__(self, events: Sequence[ChurnEvent] = ()) -> None:
        # stable sort: same-tick events keep authoring order, which is
        # what makes a recorded trace replay bit-for-bit
        self.events: List[ChurnEvent] = sorted(events, key=lambda e: e.t)

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    # --- JSONL record / replay ------------------------------------------

    def to_jsonl(self) -> str:
        return "".join(json.dumps(e.to_json()) + "\n" for e in self.events)

    @classmethod
    def from_jsonl(cls, text: str) -> "ChurnTrace":
        events = []
        for i, line in enumerate(text.splitlines(), 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"churn trace line {i} is not JSON: "
                                 f"{line!r} ({e})") from e
            events.append(ChurnEvent.from_json(d))
        return cls(events)

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())

    @classmethod
    def load(cls, path) -> "ChurnTrace":
        with open(path) as f:
            return cls.from_jsonl(f.read())

    # --- seeded generators ----------------------------------------------

    @classmethod
    def poisson(cls, hosts: Sequence[int], *, rate: float, seed: int = 0,
                horizon: float = 100.0, preempt: float = 0.5,
                grace: float = 3.0, return_after: Optional[float] = 8.0,
                max_events: Optional[int] = None) -> "ChurnTrace":
        """Independent churn: fleet-wide exponential interarrivals at
        ``rate`` incidents per tick; each incident takes one present
        host — a preemption notice carrying ``grace`` ticks with
        probability ``preempt``, a hard death otherwise. A departed
        host returns ``return_after`` ticks after it left (None: gone
        for good). Same seed → identical trace, always."""
        if rate <= 0:
            raise ValueError(f"poisson rate must be > 0, got {rate}")
        rng = np.random.RandomState(seed)
        events: List[ChurnEvent] = []
        present = set(int(h) for h in hosts)
        returns: List[Tuple[float, int]] = []   # (t, host), sorted
        t = 0.0
        while max_events is None or len(events) < max_events:
            t += float(rng.exponential(1.0 / rate))
            # hosts scheduled to be back by now are victims again
            while returns and returns[0][0] <= t:
                present.add(returns.pop(0)[1])
            if t >= horizon:
                break
            if not present:
                if not returns:
                    break
                t = max(t, returns[0][0])
                continue
            victim = int(rng.choice(sorted(present)))
            present.discard(victim)
            if rng.random_sample() < preempt:
                events.append(ChurnEvent(t=t, kind="preempt", host=victim,
                                         grace_s=grace))
                gone_at = t + grace
            else:
                events.append(ChurnEvent(t=t, kind="die", host=victim))
                gone_at = t
            if return_after is not None:
                back = gone_at + return_after
                if back < horizon and (max_events is None
                                       or len(events) < max_events):
                    events.append(ChurnEvent(t=back, kind="return",
                                             host=victim))
                    returns.append((back, victim))
                    returns.sort()
        return cls(events)

    @classmethod
    def correlated_racks(cls, hosts: Sequence[int], *, rate: float,
                         rack_size: int = 2, seed: int = 0,
                         horizon: float = 100.0,
                         return_after: Optional[float] = 8.0,
                         max_events: Optional[int] = None) -> "ChurnTrace":
        """Correlated churn: hosts partition into racks of
        ``rack_size`` consecutive members; a rack incident kills every
        present member at the same instant (a top-of-rack switch, a
        power feed). The whole rack returns together ``return_after``
        ticks later."""
        if rate <= 0:
            raise ValueError(f"rack rate must be > 0, got {rate}")
        if rack_size < 1:
            raise ValueError(f"rack_size must be >= 1, got {rack_size}")
        rng = np.random.RandomState(seed)
        ordered = [int(h) for h in hosts]
        racks = [ordered[i:i + rack_size]
                 for i in range(0, len(ordered), rack_size)]
        events: List[ChurnEvent] = []
        present = set(ordered)
        returns: List[Tuple[float, int]] = []
        t = 0.0
        while max_events is None or len(events) < max_events:
            t += float(rng.exponential(1.0 / rate))
            while returns and returns[0][0] <= t:
                present.add(returns.pop(0)[1])
            if t >= horizon:
                break
            live_racks = [r for r in racks if any(h in present for h in r)]
            if not live_racks:
                if not returns:
                    break
                t = max(t, returns[0][0])
                continue
            rack = live_racks[int(rng.randint(len(live_racks)))]
            for h in rack:
                if h not in present:
                    continue
                if max_events is not None and len(events) >= max_events:
                    break
                present.discard(h)
                events.append(ChurnEvent(t=t, kind="die", host=h))
                if return_after is not None and t + return_after < horizon:
                    events.append(ChurnEvent(t=t + return_after,
                                             kind="return", host=h))
                    returns.append((t + return_after, h))
            returns.sort()
        return cls(events)

    @classmethod
    def from_spec(cls, spec: str, hosts: Sequence[int],
                  horizon: float) -> "ChurnTrace":
        kind, params = parse_churn_spec(spec)
        params.setdefault("horizon", horizon)
        if kind == "poisson":
            return cls.poisson(hosts, **params)
        return cls.correlated_racks(hosts, **params)


# spec key -> (generator kwarg, parser); shared keys first
_SPEC_KEYS = {
    "rate": ("rate", float), "seed": ("seed", int),
    "horizon": ("horizon", float), "events": ("max_events", int),
    "return": ("return_after", float),
}
_POISSON_KEYS = {**_SPEC_KEYS, "preempt": ("preempt", float),
                 "grace": ("grace", float)}
_RACK_KEYS = {**_SPEC_KEYS, "size": ("rack_size", int)}


def parse_churn_spec(spec: str) -> Tuple[str, Dict[str, Any]]:
    """``poisson:rate=0.1,seed=1[,preempt=0.5][,grace=3][,return=8]
    [,events=50][,horizon=100]`` or ``racks:rate=0.05,size=2,seed=1`` →
    (generator kind, kwargs). Unknown kinds/keys and bad values raise
    ``ValueError`` with the fix in the message."""
    kind, _, rest = spec.partition(":")
    keys = {"poisson": _POISSON_KEYS, "racks": _RACK_KEYS}.get(kind)
    if keys is None:
        raise ValueError(f"unknown churn generator {kind!r}; expected "
                         "'poisson:...' or 'racks:...'")
    params: Dict[str, Any] = {}
    for part in filter(None, rest.split(",")):
        k, eq, v = part.partition("=")
        if not eq or k not in keys:
            raise ValueError(
                f"bad churn spec parameter {part!r} for {kind}; known "
                f"keys: {', '.join(sorted(keys))}")
        name, cast = keys[k]
        try:
            params[name] = cast(v)
        except ValueError as e:
            raise ValueError(f"churn spec {k}={v!r}: {e}") from e
    if "rate" not in params:
        raise ValueError(f"churn spec {spec!r} needs rate= (incidents "
                         "per tick)")
    return kind, params


# --- goodput accounting -------------------------------------------------------


@dataclass
class GoodputReport:
    """Useful work under churn. ``goodput`` (useful ÷ attempted steps)
    is deterministic on the virtual clock — the gateable number;
    ``steps_per_s`` folds in real restore/repair wall time."""
    useful_steps: int
    attempted_steps: int
    lost_steps: int
    wall_s: float
    goodput: float
    steps_per_s: float
    incidents: List[Dict[str, Any]] = field(default_factory=list)
    proactive_preempts: int = 0
    degraded_preempts: int = 0
    grows: int = 0

    def to_json(self) -> Dict[str, Any]:
        return {
            "useful_steps": self.useful_steps,
            "attempted_steps": self.attempted_steps,
            "lost_steps": self.lost_steps,
            "wall_s": self.wall_s,
            "goodput": self.goodput,
            "steps_per_s": self.steps_per_s,
            "proactive_preempts": self.proactive_preempts,
            "degraded_preempts": self.degraded_preempts,
            "grows": self.grows,
            "incidents": self.incidents,
        }


class IncidentLog:
    """Supervisor ``event_sink`` → operator-readable JSONL, one line
    per event, flushed as it happens (the log survives the process)."""

    def __init__(self, path) -> None:
        self.path = str(path)
        self._f = open(self.path, "a")

    def __call__(self, t: float, kind: str, detail: Dict[str, Any]) -> None:
        self._f.write(json.dumps({"t": t, "event": kind, **detail},
                                 default=str, sort_keys=True) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def read_incident_log(path) -> List[Dict[str, Any]]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# --- the engine ---------------------------------------------------------------


class ChurnEngine:
    """Drives a ``ClusterSupervisor`` through a ``ChurnTrace`` on the
    virtual clock: one ``tick(step)`` per runner step fires due events,
    fans heartbeats out (silent hosts excluded), polls the supervisor,
    and grows the world back toward ``target_world`` whenever idle
    capacity exists. Construct first, hand ``engine.clock`` to the
    supervisor, then ``attach`` it.

    ``snapshot``  zero-arg hook taking a *blocking* snapshot of the
                  current runner (``lambda: sess.snapshot(block=True)``)
                  — the proactive half of preemption survival, and what
                  makes a grow lose zero steps. Without it, preemptions
                  still drain but fall back to the latest committed
                  step, and grows roll back like a shrink would.
    ``min_grace`` ticks of grace below which a preemption notice is not
                  actionable — the host simply dies at its deadline
                  (the heartbeat-timeout path, counted as degraded).
    ``grow``      False freezes the world at whatever churn leaves
                  (shrink-only fleets).
    ``target_world`` world size grows aim for; default: the attached
                  supervisor's initial world size.
    """

    def __init__(self, trace: ChurnTrace, *,
                 snapshot: Optional[Callable[[], Any]] = None,
                 min_grace: float = 1.0,
                 grow: bool = True,
                 target_world: Optional[int] = None) -> None:
        self.trace = trace
        self.pending: List[ChurnEvent] = list(trace.events)
        self.snapshot = snapshot
        self.min_grace = min_grace
        self.grow_enabled = grow
        self.target_world = target_world
        self.sup: Any = None
        self._t = 0.0
        self.silent: set = set()        # in-world hosts gone quiet
        self.gone: set = set()          # hosts that left the fleet
        # accounting
        self._ticks = 0
        self._start: Optional[int] = None
        self._high = 0
        self._wall0: Optional[float] = None
        self.incident_rows: List[Dict[str, Any]] = []
        self.proactive_preempts = 0
        self.degraded_preempts = 0
        self.grows = 0

    def clock(self) -> float:
        return self._t

    def attach(self, sup) -> "ChurnEngine":
        self.sup = sup
        if self.target_world is None:
            self.target_world = len(sup.world)
        return self

    # --- the tick -------------------------------------------------------

    def tick(self, step: int) -> List[Any]:
        """Advance the world one step: fire due events, heartbeat the
        live hosts, poll, grow. Returns every executed decision's
        ``RestoreTarget`` (empty list on a quiet tick)."""
        self._t += 1.0
        self._ticks += 1
        if self._wall0 is None:
            self._wall0 = time.monotonic()
        if self._start is None:
            self._start = int(step) - 1
        self._high = max(self._high, int(step))
        executed: List[Any] = []
        self._fire_due(step, executed)
        for h in self.sup.world:
            if h not in self.silent:
                self.sup.beat(h, step)
        self._execute(step, executed, self.sup.poll)
        self._maybe_grow(step, executed)
        return executed

    def unfired_events(self) -> List[ChurnEvent]:
        return list(self.pending)

    def unresolved_hosts(self) -> List[int]:
        """Silent hosts whose death never produced an incident."""
        return sorted(self.silent)

    # --- event handling -------------------------------------------------

    def _fire_due(self, step: int, executed: List[Any]) -> None:
        due = [e for e in self.pending if step >= e.t]
        self.pending = [e for e in self.pending if step < e.t]
        for ev in due:
            if ev.kind == "die":
                self._on_die(ev)
            elif ev.kind == "preempt":
                self._on_preempt(ev, executed)
            elif ev.kind == "return":
                self._on_return(ev)
            elif ev.kind == "drain":
                self._on_drain(ev, step, executed)

    def _on_die(self, ev: ChurnEvent) -> None:
        sup = self.sup
        if ev.host in sup.world:
            self.silent.add(ev.host)
            self.gone.add(ev.host)
        elif ev.host in sup.policy.spares:
            # an idle spare dying costs nothing now, but it must not be
            # handed a workload later
            sup.policy.spares.remove(ev.host)
            self.gone.add(ev.host)
            sup._event("spare_lost", host=ev.host)

    def _on_preempt(self, ev: ChurnEvent, executed: List[Any]) -> None:
        sup = self.sup
        if ev.host not in sup.world:
            # a spare being reclaimed: it just leaves the pool
            if ev.host in sup.policy.spares:
                sup.policy.spares.remove(ev.host)
                self.gone.add(ev.host)
                sup._event("spare_preempted", host=ev.host)
            return
        if ev.grace_s >= self.min_grace:
            # enough grace to act: snapshot proactively, then drain the
            # host BEFORE the deadline — onto a spare if one is idle
            # (hot-spare-class blackout), else a deliberate shrink. The
            # heartbeat-timeout path never sees this host.
            sup._event("preempt_notice", host=ev.host, grace_s=ev.grace_s,
                       deadline=ev.t + ev.grace_s)
            if self.snapshot is not None:
                self.snapshot()
            target = self._execute(self._high, executed,
                                   sup.planned_move, ev.host)
            # planned_move returns the drained host to the spare pool
            # (it is healthy) — but a preempted host is being RECLAIMED:
            # it must not be handed a later workload
            if ev.host in sup.policy.spares:
                sup.policy.spares.remove(ev.host)
            self.gone.add(ev.host)
            self.proactive_preempts += 1
            assert target is not None
        else:
            # notice too short to act on: the host is simply gone at
            # the deadline, detected like any other death
            sup._event("preempt_degraded", host=ev.host,
                       grace_s=ev.grace_s)
            self.degraded_preempts += 1
            self.pending.append(ChurnEvent(t=ev.t + ev.grace_s,
                                           kind="die", host=ev.host))
            self.pending.sort(key=lambda e: e.t)

    def _on_return(self, ev: ChurnEvent) -> None:
        sup = self.sup
        self.gone.discard(ev.host)
        self.silent.discard(ev.host)   # a flaky host resuming heartbeats
        if ev.host not in sup.world and ev.host not in sup.policy.spares:
            sup.policy.spares.append(ev.host)
            sup._event("host_return", host=ev.host,
                       spares=list(sup.policy.spares))

    def _on_drain(self, ev: ChurnEvent, step: int,
                  executed: List[Any]) -> None:
        sup = self.sup
        if ev.host not in sup.world:
            sup._event("drain_skipped", host=ev.host,
                       reason="not in world")
            return
        if self.snapshot is not None:
            self.snapshot()
        self._execute(step, executed, sup.planned_move, ev.host)
        # unlike a preemption, a drained host stays in the fleet:
        # planned_move already returned it to the spare pool

    # --- grow -----------------------------------------------------------

    def _maybe_grow(self, step: int, executed: List[Any]) -> None:
        if not self.grow_enabled or self.sup is None:
            return
        while len(self.sup.world) < (self.target_world or 0) \
                and self.sup.policy.spares:
            host = self.sup.policy.spares[0]
            if self.snapshot is not None:
                self.snapshot()   # grow restores from the latest step;
                # a fresh snapshot makes that THIS step — zero rollback
            target = self._execute(step, executed, self.sup.grow, host)
            self.grows += 1
            assert target is not None

    # --- accounting -----------------------------------------------------

    def _runner_step(self, fallback: int) -> int:
        fn = getattr(getattr(self.sup, "runner", None),
                     "checkpoint_step", None)
        return int(fn()) if callable(fn) else int(fallback)

    def _execute(self, step: int, executed: List[Any],
                 fn: Callable, *args) -> Any:
        """Run one decision source (poll / planned_move / grow) with
        per-incident rollback accounting."""
        n0 = len(self.sup.incidents)
        target = fn(*args)
        if target is not None:
            executed.append(target)
            for d in getattr(target, "dead", ()):   # resolved, whichever
                self.silent.discard(d)              # policy ran
        after = self._runner_step(step)
        for inc in self.sup.incidents[n0:]:
            self.incident_rows.append({
                "t": self._t, "action": inc.action,
                "dead": list(inc.dead), "step": inc.step,
                "lost_steps": max(0, int(step) - after),
                "wall_s": inc.wall_s})
        return target

    def report(self) -> GoodputReport:
        useful = self._high - (self._start or 0) if self._ticks else 0
        wall = (time.monotonic() - self._wall0) if self._wall0 else 0.0
        return GoodputReport(
            useful_steps=useful,
            attempted_steps=self._ticks,
            lost_steps=sum(r["lost_steps"] for r in self.incident_rows),
            wall_s=wall,
            goodput=useful / self._ticks if self._ticks else 0.0,
            steps_per_s=useful / wall if wall > 0 else 0.0,
            incidents=list(self.incident_rows),
            proactive_preempts=self.proactive_preempts,
            degraded_preempts=self.degraded_preempts,
            grows=self.grows)
