"""Shared --supervise surface for the launchers.

Both entry points (train, serve) route their run under a
``ClusterSupervisor`` with the same knobs and the same simulated-world
mechanics; this module is the single definition of the flags, their
validation, and the world driver — so none of it can drift between the
two. Only the runner-specific step/restore logic stays in each
launcher.

The driver is a thin shell over ``core.churn.ChurnEngine``: scripted
``--kill-host`` / ``--drain`` occurrences (repeatable) become a small
``ChurnTrace``, and the general form — a recorded JSONL trace
(``--churn-trace``) or a seeded generator (``--churn
poisson:rate=...,seed=...``) — drives deaths, grace-window preemptions,
returns and elastic grow through the same engine. ``--incident-log``
taps the supervisor's event stream as operator-readable JSONL.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Tuple, Union

from repro_torch.core.churn import ChurnEngine, ChurnEvent, ChurnTrace

Spec = Union[None, Tuple[int, int], List[Tuple[int, int]]]


def add_supervise_args(ap: argparse.ArgumentParser,
                       unit: str = "step") -> None:
    """``unit`` names the simulated clock tick in help text ("step" for
    training, "engine step" for serving)."""
    ap.add_argument("--supervise", action="store_true",
                    help="run under a ClusterSupervisor (detect -> "
                         "decide -> restore) over a simulated world")
    # world-shape flags default to None so "explicitly set but
    # --supervise forgotten" is distinguishable from "left alone" —
    # parse_supervise_args rejects the former and fills the defaults in
    ap.add_argument("--hosts", type=int, default=None,
                    help="simulated world size under --supervise "
                         "(default 2)")
    ap.add_argument("--spares", type=int, default=0,
                    help="idle spare hosts the hot-spare policy may use")
    ap.add_argument("--heartbeat-timeout", type=float, default=None,
                    help="ticks of heartbeat silence before a host is "
                         f"declared dead (one tick per {unit}; "
                         "default 3)")
    ap.add_argument("--no-shrink", action="store_true",
                    help="forbid elastic shrink: a death with no spare "
                         "restarts from the last checkpoint")
    ap.add_argument("--kill-host", action="append", default=None,
                    metavar="H@STEP",
                    help=f"fault injection: host H stops heartbeating "
                         f"at {unit} STEP (needs --supervise; "
                         "repeatable)")
    ap.add_argument("--drain", action="append", default=None,
                    metavar="H@STEP",
                    help=f"planned move: at {unit} STEP, drain healthy "
                         "host H onto a spare (or shrink the world if "
                         "none) via supervisor.planned_move (needs "
                         "--supervise; repeatable)")
    ap.add_argument("--churn-trace", default=None, metavar="FILE",
                    help="replay a JSONL churn trace (die / "
                         "preempt+grace / return / drain events) "
                         "against the run (needs --supervise)")
    ap.add_argument("--churn", default=None, metavar="SPEC",
                    help="generated churn: 'poisson:rate=0.1,seed=1"
                         "[,preempt=0.5][,grace=3][,return=8]"
                         "[,events=50]' or 'racks:rate=0.05,size=2,"
                         "seed=1' (needs --supervise)")
    ap.add_argument("--incident-log", default=None, metavar="PATH",
                    help="append the supervisor's event stream to PATH "
                         "as JSONL, one line per event, as it happens")


def parse_supervise_args(args, prog: str
                         ) -> Tuple[List[Tuple[int, int]], Optional[str]]:
    """-> (kills, error). ``kills`` is the list of parsed (host, step)
    injections (possibly empty); a non-None ``error`` is the message
    the launcher should print before exiting 2. Also normalizes the
    None-sentinel defaults of --hosts/--heartbeat-timeout."""
    if not args.supervise and (args.kill_host is not None or args.spares
                               or args.no_shrink
                               or args.hosts is not None
                               or args.heartbeat_timeout is not None
                               or getattr(args, "drain", None) is not None
                               or getattr(args, "churn_trace", None)
                               is not None
                               or getattr(args, "churn", None) is not None
                               or getattr(args, "incident_log", None)
                               is not None):
        return [], (f"[{prog}] --hosts/--spares/--heartbeat-timeout/"
                    "--no-shrink/--kill-host/--drain/--churn[-trace]/"
                    "--incident-log only make sense under --supervise "
                    "(nothing would watch the heartbeats)")
    if args.hosts is None:
        args.hosts = 2
    if args.heartbeat_timeout is None:
        args.heartbeat_timeout = 3.0
    kills: List[Tuple[int, int]] = []
    for spec in args.kill_host or []:
        try:
            h, s = spec.split("@")
            kill = (int(h), int(s))
        except ValueError:
            return [], (f"[{prog}] --kill-host: expected H@STEP, got "
                        f"{spec!r}")
        if not 0 <= kill[0] < args.hosts:
            # an out-of-world host would silently never die — the user
            # would believe the failure path was exercised when it wasn't
            return [], (f"[{prog}] --kill-host: host {kill[0]} is not in "
                        f"the simulated world 0..{args.hosts - 1}")
        kills.append(kill)
    return kills, None


def parse_drain_arg(args, prog: str
                    ) -> Tuple[List[Tuple[int, int]], Optional[str]]:
    """-> (drains, error): the parsed --drain (host, step) planned-move
    triggers, validated like --kill-host. Call AFTER
    ``parse_supervise_args`` (it fills the --hosts default)."""
    killed = set()
    for spec in args.kill_host or []:
        try:
            killed.add(int(spec.split("@")[0]))
        except ValueError:
            pass   # parse_supervise_args already reported it
    drains: List[Tuple[int, int]] = []
    for spec in getattr(args, "drain", None) or []:
        try:
            h, s = spec.split("@")
            drain = (int(h), int(s))
        except ValueError:
            return [], (f"[{prog}] --drain: expected H@STEP, got "
                        f"{spec!r}")
        if not 0 <= drain[0] < args.hosts:
            return [], (f"[{prog}] --drain: host {drain[0]} is not in "
                        f"the simulated world 0..{args.hosts - 1}")
        if drain[0] in killed:
            return [], (f"[{prog}] --drain and --kill-host target the "
                        f"same host {drain[0]}; a drained host has "
                        "already left the world — pick different hosts")
        drains.append(drain)
    return drains, None


def parse_churn_args(args, prog: str, horizon: float
                     ) -> Tuple[Optional[ChurnTrace], Optional[str]]:
    """-> (trace, error): the replayed (--churn-trace FILE) or generated
    (--churn SPEC, over world hosts 0..hosts-1 up to ``horizon`` ticks
    unless the spec pins its own) churn trace, or None when neither
    flag was given. Call AFTER ``parse_supervise_args``."""
    file = getattr(args, "churn_trace", None)
    spec = getattr(args, "churn", None)
    if file is not None and spec is not None:
        return None, (f"[{prog}] --churn-trace and --churn are mutually "
                      "exclusive (one trace per run)")
    if file is not None:
        try:
            return ChurnTrace.load(file), None
        except (OSError, ValueError) as e:
            return None, f"[{prog}] --churn-trace {file}: {e}"
    if spec is not None:
        try:
            return ChurnTrace.from_spec(
                spec, list(range(args.hosts)), horizon=horizon), None
        except ValueError as e:
            return None, f"[{prog}] --churn: {e}"
    return None, None


def _as_events(spec: Spec, kind: str) -> List[ChurnEvent]:
    pairs = [spec] if isinstance(spec, tuple) else list(spec or [])
    return [ChurnEvent(t=float(s), kind=kind, host=int(h))
            for h, s in pairs]


class SimWorldDriver:
    """The simulated world around a supervised run: one virtual-clock
    tick per step, every live host heartbeats (hosts the trace killed
    stay silent), then one supervisor poll, then elastic grow toward
    the starting world size when idle capacity exists. Construct the
    driver first, hand ``driver.clock`` to the ClusterSupervisor, then
    ``attach`` it.

    Scripted ``kill``/``drain`` events (a single (host, step) pair or a
    list of them) and a full ``trace`` compose into one ``ChurnTrace``
    driven by ``core.churn.ChurnEngine``; ``snapshot`` is the blocking
    proactive-snapshot hook preemption notices and grows use.
    """

    def __init__(self, kill: Spec = None, drain: Spec = None, *,
                 trace: Optional[ChurnTrace] = None,
                 snapshot=None, grow: bool = True,
                 min_grace: float = 1.0) -> None:
        events = list(trace.events) if trace is not None else []
        events += _as_events(kill, "die")
        events += _as_events(drain, "drain")
        self.engine = ChurnEngine(ChurnTrace(events), snapshot=snapshot,
                                  grow=grow, min_grace=min_grace)
        self.sup = None

    def clock(self) -> float:
        return self.engine.clock()

    def attach(self, sup) -> "SimWorldDriver":
        self.sup = sup
        self.engine.attach(sup)
        return self

    def tick(self, step: int) -> list:
        """Advance the world one step; returns every executed decision's
        RestoreTarget (empty list on a quiet tick), printing one line
        per incident."""
        n0 = len(self.sup.incidents)
        executed = self.engine.tick(step)
        for inc in self.sup.incidents[n0:]:
            print(f"[supervisor] {inc.action}: dead={inc.dead} -> "
                  f"hosts={self.sup.world} (mttr {inc.wall_s:.2f}s)")
        return executed

    def goodput(self):
        return self.engine.report()

    def print_goodput(self, label: str = "churn") -> None:
        rep = self.engine.report()
        if not rep.incidents and not self.engine.trace.events:
            return
        print(f"[{label}] goodput {rep.goodput:.2f} "
              f"({rep.useful_steps} useful / {rep.attempted_steps} "
              f"attempted steps, {rep.lost_steps} lost, "
              f"{len(rep.incidents)} incidents, "
              f"{rep.proactive_preempts} proactive preempts, "
              f"{rep.grows} grows)")

    def warn_if_kill_pending(self) -> None:
        """Call after the run's loop: trace events that never fired, or
        a death whose silence never crossed the timeout, must be said
        out loud — or the user believes the failure path was exercised
        when it wasn't."""
        for ev in self.engine.unfired_events():
            print(f"[supervisor] WARNING: churn event {ev.kind} host "
                  f"{ev.host}@{ev.t:g} never fired — the run ended "
                  f"before its step (raise --steps)", file=sys.stderr)
        for host in self.engine.unresolved_hosts():
            print(f"[supervisor] WARNING: host {host} went silent but "
                  f"never produced an incident — the run ended before "
                  f"the death could be detected (raise --steps or "
                  f"lower --heartbeat-timeout)", file=sys.stderr)
