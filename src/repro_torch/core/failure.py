"""Failure detection and straggler mitigation for multi-host jobs — the
port of ``repro.core.failure`` (framework-free: the same code).

The detection logic is real (injectable clock makes it unit-testable);
host liveness is fed by the launcher's heartbeat loop on hardware, or by
tests/simulators here. Policies yield *decisions*;
``core.supervisor.ClusterSupervisor`` executes them end-to-end, routing
every runtime mutation through the logged API so the decision replays
correctly after a later restart (e.g. a DataReassign op for shard
rebalancing).

Policies:
  restart_last_ckpt — classic C/R: tear down, restore latest checkpoint
                      (the paper's Maya flow);
  hot_spare         — rebind the failed host's logical coordinates to a
                      spare host (virtual-id remap; no rollback needed if
                      peer-replicated state covers the loss);
  shrink            — elastic restore onto the surviving topology.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional, Tuple


class FailureAction(Enum):
    NONE = "none"
    RESTART_LAST_CKPT = "restart_last_ckpt"
    HOT_SPARE = "hot_spare"
    SHRINK = "shrink"
    # not a failure: an operator-initiated drain/move of a healthy host
    # (maintenance, defrag). Decided by ClusterSupervisor.planned_move,
    # never by FailurePolicy — nothing is dead.
    PLANNED_MOVE = "planned_move"
    # not a failure either: elastic expansion — an idle host joins the
    # world and the runner rebuilds onto the larger topology (the
    # inverse of SHRINK). Decided by ClusterSupervisor.grow, never by
    # FailurePolicy.
    GROW = "grow"


@dataclass
class HostState:
    last_heartbeat: float
    last_step: int = 0
    step_ewma: float = 0.0       # seconds per step
    alive: bool = True


class HeartbeatMonitor:
    def __init__(self, hosts: List[int], timeout: float = 60.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.timeout = timeout
        self.clock = clock
        now = clock()
        self.hosts: Dict[int, HostState] = {
            h: HostState(last_heartbeat=now) for h in hosts}

    def beat(self, host: int, step: int) -> None:
        now = self.clock()
        st = self.hosts[host]
        if step > st.last_step:
            dt = (now - st.last_heartbeat) / max(step - st.last_step, 1)
            st.step_ewma = dt if st.step_ewma == 0.0 else \
                0.8 * st.step_ewma + 0.2 * dt
        st.last_heartbeat = now
        st.last_step = step
        st.alive = True

    def dead_hosts(self) -> List[int]:
        now = self.clock()
        out = []
        for h, st in self.hosts.items():
            if now - st.last_heartbeat > self.timeout:
                st.alive = False
                out.append(h)
        return out

    def alive_hosts(self) -> List[int]:
        self.dead_hosts()
        return [h for h, st in self.hosts.items() if st.alive]


class StragglerDetector:
    """Flags hosts whose per-step time exceeds k x median EWMA."""

    def __init__(self, monitor: HeartbeatMonitor, k: float = 1.5,
                 min_steps: int = 3) -> None:
        self.monitor = monitor
        self.k = k
        self.min_steps = min_steps

    def stragglers(self) -> List[int]:
        sts = [(h, s) for h, s in self.monitor.hosts.items()
               if s.alive and s.last_step >= self.min_steps and s.step_ewma > 0]
        if len(sts) < 3:
            return []
        times = sorted(s.step_ewma for _, s in sts)
        median = times[len(times) // 2]
        return [h for h, s in sts if s.step_ewma > self.k * median]


@dataclass
class FailurePolicy:
    spares: List[int] = field(default_factory=list)
    allow_shrink: bool = True

    def decide(self, dead: List[int], world: List[int]) -> Tuple[FailureAction, dict]:
        if not dead:
            return FailureAction.NONE, {}
        if self.spares and len(dead) <= len(self.spares):
            mapping = {d: s for d, s in zip(dead, self.spares)}
            return FailureAction.HOT_SPARE, {"mapping": mapping}
        survivors = [h for h in world if h not in dead]
        # shrinking requires someone to shrink ONTO: an empty survivor
        # set (last host died) must restart-in-place, not divide by zero
        if self.allow_shrink and survivors \
                and len(survivors) >= len(world) // 2:
            return FailureAction.SHRINK, {"survivors": survivors}
        return FailureAction.RESTART_LAST_CKPT, {}


def rebalance_shards(n_shards: int, hosts: List[int]) -> List[Tuple[int, int]]:
    """Even host->shard assignment; returned pairs are logged via
    DataReassign so the decision replays after restore."""
    out = []
    for i in range(n_shards):
        out.append((hosts[i % len(hosts)], i))
    return out
