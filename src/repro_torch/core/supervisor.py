"""ClusterSupervisor: the failure loop, closed (detect → decide → act) —
the port of ``repro.core.supervisor``, with the same names, events and
messages.

The paper's economics only land when nobody has to be paged: a crash
costs seconds *if* something notices the death, picks a response, and
drives the restart — MANA-for-MPI and CRIUgpu (PAPERS.md) both ship a
coordinator for exactly this reason. Before this module the ingredients
existed but nothing wired them together: ``HeartbeatMonitor`` /
``FailurePolicy`` (core/failure.py) produced decisions nobody executed,
and the restore machinery (core/incarnation.py) waited to be hand-driven.

The supervisor runs the loop on a (simulated or real) multi-host world:

    heartbeats ──> HeartbeatMonitor.dead_hosts()
                        │
                   FailurePolicy.decide()
                        │
          ┌─────────────┼──────────────────┐
     HOT_SPARE        SHRINK         RESTART_LAST_CKPT
     HostMap remap    unbind dead    (world unchanged;
     + logged         logical hosts   hosts restart in
     DataReassign     + elastic       place)
     (no restore —    restore onto   storage repair +
     peer-replicated  survivors +    Incarnation restore
     state covers     rebalance      from latest
     the loss)        shards         restorable step

Execution is real, not advisory: HOT_SPARE rebinds the dead host's
logical coordinate to a spare through ``core.virtual_ids.HostMap`` and
replays a logged ``DataReassign`` (``rebalance_shards``) so the
decision survives a *later* restart; SHRINK and RESTART tear the runner
down, repair a degraded ``ShardedBackend`` from peer replicas
(``core.replication``) and rebuild the runner through the caller's
``restore`` hook — which drives the Incarnation lifecycle (the
``RestoreTarget`` it receives carries the step, the surviving topology
and a ready-made ``rewrite_op`` for re-shard/re-slot replay).

The runner-*specific* rebuild stays with the caller as the ``restore``
hook — the supported wiring is ``repro_torch.api.CheckpointSession.
supervise``, whose hook resolves the checkpoint's app kind through the
registry and rebuilds whatever workload the manifest names; everything
policy-shaped — detection, decision, storage repair, host-map surgery,
reassignment logging, MTTR accounting — lives here, once, for every
kind. ``launch/train.py --supervise`` and ``launch/serve.py
--supervise`` route production entry points through it.

The port runs on one device, so its hosts are virtual: HOT_SPARE
rebinds the ``HostMap`` and logs a ``DataReassign``; SHRINK and GROW
rebalance the data shards over the new world and rebuild the runner on
the same device — an engine re-slotted onto as many slots as its
restore hook asks for (``launch/serve.py`` gives it slots in proportion
to the surviving hosts). The device mesh stays ``(1, 1)``: a restore
hook that hands the runner a mesh of more than one device raises
``NotImplementedError`` (``one_device_mesh``) until ROADMAP A9b step 2.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.api.errors import CheckpointError
from repro_torch.core.failure import (FailureAction, FailurePolicy,
                                HeartbeatMonitor, HostState,
                                StragglerDetector, rebalance_shards)
from repro_torch.core.oplog import DataReassign, Op
from repro_torch.core.virtual_ids import HostMap


@dataclass
class RestoreTarget:
    """Everything a ``restore`` hook needs to rebuild the runner after a
    decision: which action, which checkpoint step, which physical hosts
    survive, and the rebalanced shard assignment (if the supervisor
    manages shards). ``rewrite_op()`` hands the hook an op-log rewriter
    that replays any logged ``DataReassign`` onto the new assignment —
    the elastic re-shard path through ``Incarnation(rewrite_op=...)``."""
    action: FailureAction
    step: Optional[int]                       # latest restorable step
    hosts: List[int]                          # physical world after the act
    dead: List[int] = field(default_factory=list)
    mapping: Dict[int, int] = field(default_factory=dict)   # dead -> spare
    assignment: Optional[Tuple[Tuple[int, int], ...]] = None

    def rewrite_op(self) -> Optional[Callable[[Op], Op]]:
        if self.assignment is None:
            return None
        assignment = tuple(map(tuple, self.assignment))

        def rewrite(op: Op) -> Op:
            if isinstance(op, DataReassign):
                return dataclasses.replace(op, assignment=assignment)
            return op
        return rewrite


@dataclass
class Incident:
    """One executed decision, with its MTTR: detection (the poll that
    flagged the death) → runner serving again (restore hook returned /
    remap+reassign applied). ``wall_s`` is real elapsed time — the
    number to report; ``mttr_s`` uses the supervisor's injected clock,
    which in simulated worlds usually doesn't advance mid-execution
    (kept for callers whose clock IS wall time)."""
    action: str
    dead: List[int]
    step: Optional[int]
    mttr_s: float
    wall_s: float


class SupervisorError(CheckpointError, RuntimeError):
    """The supervisor could not execute a decision (no restore hook, no
    restorable checkpoint, unrecoverable storage)."""


def one_device_mesh(mesh_factory: Callable[[], Any]) -> Callable[[], Any]:
    """Wrap a restore hook's ``mesh_factory``: the port's runners live on
    one device, so a factory that builds a mesh of more than one device
    (a sequence or array of devices, or anything with a ``shape``) raises
    ``NotImplementedError`` naming ROADMAP A9b step 2 instead of
    restoring onto a topology the supervisor cannot drive yet (a trainer
    or an engine itself restores onto any mesh)."""
    def factory():
        mesh = mesh_factory()
        shape = getattr(mesh, "shape", None)
        n = None
        if shape is not None and not isinstance(shape, dict):
            n = 1
            for d in tuple(shape):
                n *= int(d)
        elif isinstance(mesh, (list, tuple)):
            n = len(mesh)
        if n is not None and n != 1:
            raise NotImplementedError(
                f"a restore onto a device mesh of {n} devices: the port's "
                "supervisor rebuilds runners on one device until ROADMAP "
                "A9b step 2")
        return mesh[0] if isinstance(mesh, (list, tuple)) else mesh
    return factory


class ClusterSupervisor:
    """Runs the detect→decide→execute loop for one job.

    ``hosts``    physical ranks the job starts on (logical coordinates
                 0..n-1 are bound to them through a ``HostMap``).
    ``manager``  CheckpointManager — consulted for the latest restorable
                 step and (ShardedBackend) storage repair.
    ``spares``   idle physical ranks the HOT_SPARE policy may consume.
    ``restore``  Callable[[RestoreTarget], runner] — rebuilds the runner
                 through the Incarnation lifecycle; the supported hook
                 is the one ``CheckpointSession.supervise`` wires (the
                 app-kind registry). Required for RESTART/SHRINK.
    ``teardown`` Callable[[runner], None] — optional explicit kill of
                 the current runner before a restore (default: drop the
                 reference; a real launcher would kill pods here).
    ``reassign`` Callable[[runner, assignment], None] — apply + *log* a
                 shard reassignment on the live runner. Defaults to
                 duck-typing ``runner.apply_reassignment`` (Trainer).
    ``n_shards`` data shards the supervisor balances across hosts; None
                 disables shard management (serving).

    The supervisor is deliberately synchronous and single-threaded: the
    caller owns the loop (beat → poll → step), which is what makes the
    whole failure path unit-testable with an injected clock — the same
    property ``HeartbeatMonitor`` was built around.
    """

    def __init__(self, hosts: List[int], *,
                 manager=None,
                 spares: Optional[List[int]] = None,
                 heartbeat_timeout: float = 60.0,
                 clock: Callable[[], float] = time.monotonic,
                 allow_shrink: bool = True,
                 n_shards: Optional[int] = None,
                 restore: Optional[Callable[[RestoreTarget], Any]] = None,
                 teardown: Optional[Callable[[Any], None]] = None,
                 reassign: Optional[Callable[[Any, Any], None]] = None,
                 straggler_k: float = 1.5,
                 repair_storage: bool = True,
                 runner: Any = None,
                 event_sink: Optional[
                     Callable[[float, str, Dict[str, Any]], None]] = None,
                 ) -> None:
        self.clock = clock
        self.manager = manager
        self.hostmap = HostMap(hosts)
        self.monitor = HeartbeatMonitor(list(hosts),
                                        timeout=heartbeat_timeout,
                                        clock=clock)
        self.policy = FailurePolicy(spares=list(spares or []),
                                    allow_shrink=allow_shrink)
        self.stragglers = StragglerDetector(self.monitor, k=straggler_k)
        self.n_shards = n_shards
        self.repair_storage = repair_storage
        self._restore = restore
        self._teardown = teardown
        self._reassign = reassign
        self.runner = runner
        self.incidents: List[Incident] = []
        self.events: List[Tuple[float, str, Dict[str, Any]]] = []
        # optional live tap on the event stream (incident logs): called
        # as (t, kind, detail) for every _event, as it happens
        self._event_sink = event_sink
        # the last assignment THIS supervisor applied; None until it has
        # rebalanced once. Deliberately not seeded with a synthetic
        # initial layout: the runner may have logged its own
        # reassignments, and a restart must replay that log untouched
        # unless the supervisor itself changed the topology.
        self._assignment: Optional[Tuple[Tuple[int, int], ...]] = None

    # --- world state ----------------------------------------------------

    @property
    def world(self) -> List[int]:
        """Physical hosts currently running the job (logical order)."""
        return self.hostmap.physical_hosts()

    def _quiesce(self) -> None:
        """Join the snapshot pipeline and absorb a casualty failure: an
        in-flight snapshot whose writer died WITH the host re-raises
        from ``wait()`` (the backend's loud-write contract), but that
        casualty is part of the incident being handled — recovery must
        proceed from the last *committed* step, not crash on it."""
        if self.manager is None:
            return
        try:
            self.manager.wait()
        except Exception as e:  # noqa: BLE001 — logged, incident-scoped
            self._event("casualty_snapshot", error=repr(e))

    def latest_restorable_step(self) -> Optional[int]:
        if self.manager is None:
            return None
        from repro_torch.core.restore import restorable_steps
        self._quiesce()
        ok = restorable_steps(self.manager.backend)
        return ok[-1] if ok else None

    def _event(self, kind: str, **detail) -> None:
        t = self.clock()
        self.events.append((t, kind, detail))
        if self._event_sink is not None:
            self._event_sink(t, kind, detail)

    # --- the loop: ingest, detect, decide, execute ----------------------

    def beat(self, host: int, step: int) -> None:
        """Heartbeat from a *physical* host (launcher loop / simulator)."""
        if host in self.monitor.hosts:
            self.monitor.beat(host, step)

    def poll(self) -> Optional[RestoreTarget]:
        """One detect→decide→execute cycle. Returns the executed
        decision's RestoreTarget (action NONE is returned as None)."""
        dead = self.monitor.dead_hosts()
        if not dead:
            return None
        t0, w0 = self.clock(), time.monotonic()
        action, info = self.policy.decide(dead, world=self.world)
        self._event("decision", action=action.value, dead=list(dead),
                    **{k: v for k, v in info.items() if k != "survivors"})
        if action is FailureAction.HOT_SPARE:
            target = self._do_hot_spare(dead, info["mapping"])
        elif action is FailureAction.SHRINK:
            target = self._do_shrink(dead, info["survivors"])
        elif action is FailureAction.RESTART_LAST_CKPT:
            target = self._do_restart(dead)
        else:  # pragma: no cover — decide() never returns NONE for dead
            return None
        self.incidents.append(Incident(
            action=action.value, dead=list(dead), step=target.step,
            mttr_s=self.clock() - t0, wall_s=time.monotonic() - w0))
        return target

    def check_stragglers(self) -> List[int]:
        """Straggler mitigation: hosts whose per-step EWMA exceeds
        k×median get their data shards moved to the fast hosts, as a
        *logged* DataReassign — the rebalance replays after any later
        restart. Returns the flagged hosts (possibly already handled)."""
        slow = self.stragglers.stragglers()
        if not slow or self.n_shards is None:
            return slow
        fast = [h for h in self.world if h not in slow]
        if not fast:
            return slow
        self._apply_assignment(rebalance_shards(self.n_shards, fast),
                               reason="straggler", hosts=slow)
        return slow

    def planned_move(self, host: int, to: Optional[int] = None, *,
                     rebuild: bool = False) -> RestoreTarget:
        """Proactively drain a HEALTHY host — the maintenance twin of the
        failure loop, sharing its machinery instead of reinventing it.

        With a landing host (``to``, defaulting to the first spare) the
        move is the hot-spare sequence minus the death: quiesce, repair,
        rebind the host's logical coordinate to the target — the vid
        stays stable, so shard ownership and the heartbeat world follow
        — and return the *drained* host to the spare pool (it is
        healthy; a later failure may consume it). ``rebuild=True``
        additionally tears the runner down and rebuilds it through the
        restore hook on the new world (for runners that pin physical
        resources the remap alone can't move).

        With no landing host available the world shrinks on purpose:
        the drained host leaves, and the runner rebuilds on the
        survivors through the same ``_recover`` path a SHRINK decision
        uses — which requires a restorable checkpoint, exactly like a
        real shrink."""
        logical = self.hostmap.logical_of(host)
        if logical is None:
            raise SupervisorError(
                f"host {host} is not part of this job's world "
                f"({self.hostmap.physical_hosts()}); nothing to drain")
        if to is None and self.policy.spares:
            to = self.policy.spares[0]
        if to is not None and to in self.world:
            raise SupervisorError(
                f"target {to} already serves this job; a planned move "
                "needs an idle landing host (or None to shrink)")
        t0, w0 = self.clock(), time.monotonic()
        if to is not None:
            self._quiesce()
            self._repair()
            self.hostmap.remap(logical, to)
            self.monitor.hosts.pop(host, None)
            self.monitor.hosts[to] = HostState(last_heartbeat=self.clock())
            if to in self.policy.spares:
                self.policy.spares.remove(to)
            self.policy.spares.append(host)   # drained, not dead: reusable
            self._event("planned_move", host=host, to=to, logical=logical)
            hosts = self.world
            assignment = None
            if self.n_shards is not None:
                assignment = self._apply_assignment(
                    rebalance_shards(self.n_shards, hosts),
                    reason="planned_move", hosts=[to])
            target = RestoreTarget(FailureAction.PLANNED_MOVE, step=None,
                                   hosts=hosts, mapping={host: to},
                                   assignment=assignment)
            if rebuild:
                self._recover(target)
            else:
                self._reset_heartbeats()
            action = "planned_move"
        else:
            survivors = [h for h in self.world if h != host]
            if not survivors:
                raise SupervisorError(
                    f"draining host {host} would empty the world; give "
                    "the job a spare to land on first")
            self.hostmap.unbind(logical)
            self.monitor.hosts.pop(host, None)
            assignment = (tuple(rebalance_shards(self.n_shards, survivors))
                          if self.n_shards is not None else None)
            target = RestoreTarget(FailureAction.PLANNED_MOVE, step=None,
                                   hosts=survivors, assignment=assignment)
            self._recover(target)
            self._event("restored", action="planned_drain",
                        step=target.step, hosts=survivors)
            action = "planned_drain"
        self.incidents.append(Incident(
            action=action, dead=[], step=target.step,
            mttr_s=self.clock() - t0, wall_s=time.monotonic() - w0))
        return target

    def grow(self, host: Optional[int] = None) -> RestoreTarget:
        """Elastic expansion — the inverse of SHRINK: admit an idle
        physical host into the world and rebuild the runner onto the
        larger topology from the latest restorable step (snapshot first
        and the grow loses zero steps). The host binds to the lowest
        logical coordinate a previous shrink/drain vacated (its vid
        revives, so shard ownership keyed on the logical rank follows)
        or to a brand-new coordinate; shards rebalance over the grown
        world and the ``RestoreTarget``'s ``rewrite_op`` replays the
        logged ``DataReassign`` onto the new assignment during
        Incarnation replay — the same elastic-restore machinery a
        shrink uses, pointed the other way.

        ``host`` defaults to the first spare (a returned/recovered host
        re-admitted to the pool rejoins as capacity, not dead weight).
        """
        if host is None:
            if not self.policy.spares:
                raise SupervisorError(
                    "grow needs an idle host to admit and the spare "
                    "pool is empty")
            host = self.policy.spares[0]
        if host in self.world:
            raise SupervisorError(
                f"host {host} already serves this job "
                f"({self.world}); grow admits an *idle* host")
        t0, w0 = self.clock(), time.monotonic()
        if host in self.policy.spares:
            self.policy.spares.remove(host)
        logical = self.hostmap.admit(host)
        self.monitor.hosts[host] = HostState(last_heartbeat=self.clock())
        hosts = self.world
        assignment = (tuple(rebalance_shards(self.n_shards, hosts))
                      if self.n_shards is not None else None)
        self._event("grow", host=host, logical=logical, hosts=hosts)
        target = RestoreTarget(FailureAction.GROW, step=None,
                               hosts=hosts, assignment=assignment)
        self._recover(target)
        if assignment is not None:
            # same dance as _do_shrink: the rewrite only transforms an
            # *existing* logged DataReassign — read what replay landed
            # and log the grown assignment freshly if it didn't
            current = getattr(getattr(self.runner, "lower", None),
                              "data_assignment", None)
            self._assignment = (tuple(map(tuple, current))
                                if current is not None else None)
            self._apply_assignment(assignment, reason="grow",
                                   hosts=[host])
        self._event("restored", action="grow", step=target.step,
                    hosts=hosts)
        self.incidents.append(Incident(
            action="grow", dead=[], step=target.step,
            mttr_s=self.clock() - t0, wall_s=time.monotonic() - w0))
        return target

    # --- decision execution ---------------------------------------------

    def _do_hot_spare(self, dead: List[int],
                      mapping: Dict[int, int]) -> RestoreTarget:
        """Rebind each dead host's *logical* coordinate to its spare —
        the vid stays stable, so everything addressing the logical rank
        (shard ownership, the heartbeat world) follows the remap — then
        rebalance shards over the new physical world, logged. No
        rollback: peer-replicated state covers the loss — which is
        exactly why storage repair runs here too (a no-op when the
        dead host's storage survived): the next snapshot must not die
        on a writer the takeover left down."""
        self._quiesce()   # in-flight writers stop before repair copies
        self._repair()
        for d, s in mapping.items():
            logical = self.hostmap.logical_of(d)
            if logical is None:
                raise SupervisorError(
                    f"dead host {d} has no logical coordinate (world: "
                    f"{self.hostmap.physical_hosts()}); cannot hand its "
                    f"role to spare {s}")
            self.hostmap.remap(logical, s)
            del self.monitor.hosts[d]
            self.monitor.hosts[s] = HostState(last_heartbeat=self.clock())
            if s in self.policy.spares:
                self.policy.spares.remove(s)
            self._event("hot_spare", dead=d, spare=s, logical=logical)
        hosts = self.world
        assignment = None
        if self.n_shards is not None:
            assignment = self._apply_assignment(
                rebalance_shards(self.n_shards, hosts),
                reason="hot_spare", hosts=list(mapping.values()))
        # storage repair may have blocked this thread past the timeout
        self._reset_heartbeats()
        return RestoreTarget(FailureAction.HOT_SPARE, step=None,
                             hosts=hosts, dead=list(dead),
                             mapping=dict(mapping), assignment=assignment)

    def _do_shrink(self, dead: List[int],
                   survivors: List[int]) -> RestoreTarget:
        """Elastic restore onto the surviving topology: dead logical
        hosts leave the world, the runner is rebuilt from the latest
        restorable step with shards rebalanced over the survivors — the
        ``RestoreTarget``'s ``rewrite_op`` replays the logged
        ``DataReassign`` onto the new assignment during Incarnation
        replay (the re-shard twin of serving's re-slot rewrite)."""
        for d in dead:
            logical = self.hostmap.logical_of(d)
            if logical is not None:
                self.hostmap.unbind(logical)
            self.monitor.hosts.pop(d, None)
        assignment = (tuple(rebalance_shards(self.n_shards, survivors))
                      if self.n_shards is not None else None)
        target = RestoreTarget(FailureAction.SHRINK, step=None,
                               hosts=list(survivors), dead=list(dead),
                               assignment=assignment)
        self._recover(target)
        if assignment is not None:
            # the rewrite only transforms an *existing* logged
            # DataReassign; a log that never rebalanced has none — read
            # what replay actually applied and log the survivor
            # assignment freshly if it didn't land
            current = getattr(getattr(self.runner, "lower", None),
                              "data_assignment", None)
            self._assignment = (tuple(map(tuple, current))
                                if current is not None else None)
            self._apply_assignment(assignment, reason="shrink",
                                   hosts=list(dead))
        self._event("restored", action="shrink", step=target.step,
                    hosts=list(survivors))
        return target

    def _do_restart(self, dead: List[int]) -> RestoreTarget:
        """Classic C/R: the world keeps its geometry (dead hosts restart
        in place — a rescheduled pod with the same logical rank), the
        runner tears down and resumes through the Incarnation from the
        latest restorable step."""
        target = RestoreTarget(FailureAction.RESTART_LAST_CKPT, step=None,
                               hosts=self.world, dead=list(dead),
                               assignment=self._assignment)
        self._recover(target)
        self._event("restored", action="restart_last_ckpt",
                    step=target.step, hosts=target.hosts)
        return target

    # --- execution helpers ----------------------------------------------

    def _recover(self, target: RestoreTarget) -> None:
        """The one recovery sequence both rebuilding policies share:
        tear the runner down, quiesce in-flight snapshot writers,
        repair degraded storage, resolve the restore step, rebuild the
        runner through the caller's hook, and give every survivor a
        fresh heartbeat grace period (the whole sequence blocked this
        single thread — without the reset, a recovery longer than the
        timeout would make the next poll declare healthy hosts dead).
        Fills ``target.step`` and replaces ``self.runner``."""
        self._teardown_runner()
        self._quiesce()   # in-flight writers stop before repair copies
        self._repair()
        target.step = self._require_step()
        self.runner = self._run_restore(target)
        self._reset_heartbeats()

    def _reset_heartbeats(self) -> None:
        """Give every monitored host a fresh grace period: execution
        blocked this thread, so nobody's beat could be ingested while a
        decision (teardown + repair + restore) ran."""
        now = self.clock()
        for st in self.monitor.hosts.values():
            st.last_heartbeat = now
            st.alive = True

    def _teardown_runner(self) -> None:
        """Kill the current runner — after giving it the protocol's
        optional ``quiesce()`` hook (CheckpointableApp): an app that
        buffers work gets one chance to flush before its replacement is
        rebuilt. A quiesce failure is part of the incident being
        handled, not a new crash."""
        if self.runner is not None:
            q = getattr(self.runner, "quiesce", None)
            if callable(q):
                try:
                    q()
                except Exception as e:  # noqa: BLE001 — incident-scoped
                    self._event("quiesce_failed", error=repr(e))
            if self._teardown is not None:
                self._teardown(self.runner)
        self.runner = None

    def _repair(self) -> None:
        """Rebuild a degraded ShardedBackend from peer replicas before
        the restore depends on it. Storage geometry is independent of
        the compute world (the N virtual storage hosts are directories,
        not processes), so repair always restores full redundancy and
        re-admits the repaired hosts — a shrink changes who *computes*,
        not where blobs live."""
        if not self.repair_storage or self.manager is None:
            return
        backend = getattr(self.manager, "backend", None)
        from repro_torch.core.backends.sharded import ShardedBackend
        if not isinstance(backend, ShardedBackend):
            return
        # cheap probe before the O(all blobs) sweep: a host death shows
        # up as an injected writer failure or a missing host directory.
        # Keeps the hot-spare path O(n_hosts) when storage survived —
        # the common case the ~ms takeover MTTR is advertised on.
        degraded = bool(backend._failed_hosts) or any(
            not (backend.root / f"host_{h:03d}").is_dir()
            for h in range(backend.n_hosts))
        if not degraded:
            return
        from repro_torch.core import replication
        rep = replication.repair(backend)
        if rep.restored or rep.unrecoverable:
            self._event("storage_repair", restored=rep.restored,
                        unrecoverable=len(rep.unrecoverable))
        if rep.unrecoverable:
            raise SupervisorError(
                f"{len(rep.unrecoverable)} blob(s) lost every copy "
                f"(first: {rep.unrecoverable[0]}); the latest "
                "checkpoint(s) referencing them are not restorable")

    def _require_step(self) -> int:
        step = self.latest_restorable_step()
        if step is None:
            raise SupervisorError("no restorable checkpoint to resume "
                                  "from (and the job is down)")
        return step

    def _run_restore(self, target: RestoreTarget) -> Any:
        if self._restore is None:
            raise SupervisorError(
                f"decision {target.action.value} needs a restore hook "
                "to rebuild the runner")
        return self._restore(target)

    def _apply_assignment(self, assignment, *, reason: str,
                          hosts: List[int]):
        assignment = tuple(map(tuple, assignment))
        if assignment == self._assignment:
            return assignment
        self._assignment = assignment
        if self._reassign is not None:
            self._reassign(self.runner, assignment)
        elif self.runner is not None and \
                hasattr(self.runner, "apply_reassignment"):
            self.runner.apply_reassignment(assignment)
        self._event("reassign", reason=reason, hosts=hosts,
                    assignment=assignment)
        return assignment

    # --- observability ----------------------------------------------------

    def mttr(self) -> Dict[str, float]:
        """Worst observed MTTR per executed action, in *wall* seconds —
        the injected clock typically stands still while a decision
        executes (it only ticks when the caller's loop runs), so
        ``Incident.wall_s`` is the number that means anything here.
        The restored runner's first step comes after it, and this
        accounting cannot see it."""
        out: Dict[str, float] = {}
        for inc in self.incidents:
            out[inc.action] = max(out.get(inc.action, 0.0), inc.wall_s)
        return out
