"""Serving launcher: continuous-batching engine over a registry arch
(smoke configs for the CPU; full configs on the card), under the C/R
runtime when a checkpoint store is given — the port of
``repro.launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch phi4-mini-3.8b-smoke --requests 6 --max-new 8 \
      [--store localfs:/tmp/svc --snapshot-every 4] [--device cpu]

The engine runs on the CUDA card; ``--device cpu`` runs it on the CPU
(with no card and no ``--device``, the launcher refuses to start).
Prompts are drawn from numpy's ``RandomState(--seed)``, as the reference
draws them; the params are the port's seeded init.

With ``--store`` (or legacy ``--ckpt-dir``) the engine is built through
the logged lower half and snapshots its live sessions (queue, in-flight
requests, KV cache) every ``--snapshot-every`` steps; swapping the
checkpoint package is a one-string change (``--store
sharded:/tmp/svc?hosts=4``). ``--resume [latest|STEP]`` restores a
killed server and finishes the interrupted requests; pass a different
``--slots`` to re-slot the sessions onto a larger or smaller engine
(elastic serving restore).

``--supervise`` (requires a store) routes serving under a
``ClusterSupervisor`` over a simulated ``--hosts``-host world: a host
death (inject one with ``--kill-host H@STEP``) is detected after
``--heartbeat-timeout`` silent ticks and the decision executes for
real — hot-spare remaps the dead host to one of ``--spares``; shrink
restores the live sessions onto proportionally fewer slots through the
elastic re-slot path; restart resumes every session from the last
snapshot. In-flight generations continue token-identically.
``--migrate-to SLOTS@STEP`` moves every live session onto a fresh
engine through the move channel instead.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np

from repro_torch.configs import registry as cfg_registry
from repro_torch.core.churn import IncidentLog
from repro_torch.host import resolve_device
from repro_torch.launch.common import (add_store_args, build_session,
                                       parse_resume_arg, resolve_store,
                                       restore_timings_line, validate_resume)
from repro_torch.launch.supervise import (SimWorldDriver, add_supervise_args,
                                          parse_churn_args, parse_drain_arg,
                                          parse_supervise_args)
from repro_torch.models import model as M
from repro_torch.serving.engine import Request, ServingEngine


def build_parser() -> argparse.ArgumentParser:
    """The launcher's command line (also for callers that drive
    ``_run_supervised`` / ``_run_migrated`` themselves)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=5)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA "
                         "card; 'cpu' runs on the CPU)")
    ap.add_argument("--migrate-to", default=None, metavar="SLOTS@STEP",
                    help="live migration: at engine step STEP, move every "
                         "live session onto a fresh SLOTS-slot engine "
                         "through the C/R move channel and finish there "
                         "(needs --store; sessions continue "
                         "token-identically)")
    add_store_args(ap, interval_flag="--snapshot-every",
                   interval_default=4, interval_unit="engine steps")
    add_supervise_args(ap, unit="engine step")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    kill, err = parse_supervise_args(args, "serve")
    if err is not None:
        print(err, file=sys.stderr)
        return 2
    drain, err = parse_drain_arg(args, "serve")
    if err is not None:
        print(err, file=sys.stderr)
        return 2
    # a serving drain has no fixed step count; the generated-trace
    # horizon is a bound on the engine-step clock, not a promise
    trace, err = parse_churn_args(args, "serve",
                                  horizon=args.requests * args.max_new)
    if err is not None:
        print(err, file=sys.stderr)
        return 2
    migrate_to, err = _parse_migrate_to(args, "serve")
    if err is not None:
        print(err, file=sys.stderr)
        return 2
    spec, err = resolve_store(args, "serve")
    if err is not None:
        print(err, file=sys.stderr)
        return 2
    if args.supervise and not spec:
        print("[serve] --supervise needs --store/--ckpt-dir (restarts "
              "resume from snapshots)", file=sys.stderr)
        return 2
    if migrate_to is not None and not spec:
        print("[serve] --migrate-to needs --store/--ckpt-dir (the move "
              "channel rides beside the store)", file=sys.stderr)
        return 2
    if migrate_to is not None and args.supervise:
        print("[serve] --migrate-to and --supervise would both own the "
              "engine swap; use --drain H@STEP for a supervised planned "
              "move", file=sys.stderr)
        return 2

    # validate the cheap stuff before paying the param build
    resume, resume_step, err = parse_resume_arg(args, "serve")
    if err is not None:
        print(err, file=sys.stderr)
        return 2
    if resume and not spec:
        print("[serve] --resume needs --store/--ckpt-dir",
              file=sys.stderr)
        return 2

    sess = None
    if spec:
        sess, err = build_session(spec, "serve",
                                  interval=args.snapshot_every,
                                  keep_last=args.keep_last)
        if err is not None:
            print(err, file=sys.stderr)
            return 2
    step = resume_step
    if resume:
        step, err = validate_resume(sess, step, spec, "serve")
        if err is not None:
            print(err, file=sys.stderr)
            return 2
        ckpt_arch = sess.backend.get_manifest(step).get("job",
                                                        {}).get("arch")
        if ckpt_arch is not None and ckpt_arch != args.arch:
            print(f"[serve] --resume: checkpoint was taken with arch "
                  f"{ckpt_arch!r}, not {args.arch!r} — the params built "
                  f"from --arch would not match the restored engine",
                  file=sys.stderr)
            return 2

    # arguments are sound — now pay the param construction
    device = resolve_device(args.device)
    cfg = cfg_registry.resolve_config(args.arch)
    params = M.init_params(cfg, seed=args.seed, device=device)

    if resume:
        eng = sess.restore(step=step, expect_kind="serving",
                           params=params, n_slots=args.slots,
                           streaming=args.streaming_restore or None,
                           device=device)
        reqs = eng.live_requests()
        inc = eng.incarnation
        print(f"[serve] RESUMED at engine step {eng.steps} with "
              f"{len(reqs)} live requests on {eng.n_slots} slots "
              f"({restore_timings_line(inc)})")
    else:
        eng = ServingEngine.create(
            args.arch, params, n_slots=args.slots, max_seq=args.max_seq,
            manager=sess.manager if sess is not None else None,
            device=device)
        if sess is not None:
            sess.attach(eng)
        rng = np.random.RandomState(args.seed)
        reqs = [Request(rid=i,
                        prompt=rng.randint(0, cfg.vocab_size,
                                           size=args.prompt_len),
                        max_new=args.max_new)
                for i in range(args.requests)]
        for r in reqs:
            eng.submit(r)

    # tokens already generated before a crash don't count toward this
    # process's throughput — only what the drain below produces does
    already = sum(len(r.out) for r in reqs)
    t0 = time.monotonic()
    if args.supervise:
        eng, reg = _run_supervised(args, sess, eng, params, kill, drain,
                                   trace)
        reqs = sorted(reg.values(), key=lambda r: r.rid)
    elif migrate_to is not None:
        eng, reg = _run_migrated(args, sess, eng, migrate_to)
        reqs = sorted(reg.values(), key=lambda r: r.rid)
    else:
        eng.run_until_drained(
            snapshot_every=sess.policy.interval if sess is not None
            else None)
    dt = time.monotonic() - t0
    toks = sum(len(r.out) for r in reqs) - already
    print(f"[serve] {len(reqs)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s, {eng.steps} engine steps, "
          f"{eng.n_slots} slots)")
    for r in reqs:
        print(f"  rid={r.rid} out={r.out}")
    return 0


def _parse_migrate_to(args, prog: str):
    if args.migrate_to is None:
        return None, None
    try:
        s, at = args.migrate_to.split("@")
        mt = (int(s), int(at))
    except ValueError:
        return None, (f"[{prog}] --migrate-to: expected SLOTS@STEP, got "
                      f"{args.migrate_to!r}")
    if mt[0] < 1:
        return None, (f"[{prog}] --migrate-to: SLOTS must be >= 1, got "
                      f"{mt[0]}")
    return mt, None


def _run_migrated(args, sess, eng, migrate_to, max_steps: int = 10_000,
                  on_step=None, on_move=None):
    """Drain with one live move in the middle: at engine step STEP,
    every live session freezes, snapshots through the move channel and
    re-enters a fresh SLOTS-slot engine on the same device via
    admission — then the drain finishes there. ``on_step(engine)`` and
    ``on_move(move_result)``, when given, observe every engine step and
    the move. Returns the final engine and the newest Request object per
    rid (the landed objects are the authoritative ones after a move)."""
    n_slots, at = migrate_to
    reg = {r.rid: r for r in eng.live_requests()}

    def drain(until: Optional[int]) -> int:
        nonlocal max_steps
        while (eng.queue or any(eng.slot_req)) and max_steps > 0 \
                and (until is None or eng.steps < until):
            eng.step()
            if on_step is not None:
                on_step(eng)
            sess.maybe_snapshot()
            max_steps -= 1
        return max_steps

    drain(at)
    if eng.queue or any(eng.slot_req):
        target = ServingEngine.create(
            args.arch, eng.params, n_slots=n_slots, max_seq=args.max_seq,
            device=eng.device)
        res = sess.migrate(target, include_queue=True)
        if on_move is not None:
            on_move(res)
        print(f"[serve] migrated {len(res.moved)} sessions -> "
              f"{n_slots}-slot engine at step {eng.steps} (blackout "
              f"{res.blackout_s * 1e3:.0f}ms: capture "
              f"{res.capture_s * 1e3:.0f}ms + restore "
              f"{res.restore_s * 1e3:.0f}ms + first step)")
        eng = sess.attach(target)   # the session follows its sessions
        for r in eng.live_requests():
            reg[r.rid] = r
        drain(None)
    sess.wait()
    return eng, reg


def _run_supervised(args, sess, eng, params, kill, drain=None,
                    trace=None, max_steps: int = 10_000, on_step=None):
    """Drain the engine under the failure loop: one virtual-clock tick
    per engine step; a detected death swaps the engine under us through
    the session's app-kind registry, on the engine's device (shrink
    restores the live sessions onto proportionally fewer slots through
    the elastic re-slot path; a churn-driven grow expands them back
    through the same path). ``on_step(engine)``, when given, observes
    every engine step. Returns the final engine and the latest Request
    object seen per rid — finished or restored, the newest object holds
    the request's authoritative output."""
    world = list(range(args.hosts))
    spares = list(range(args.hosts, args.hosts + args.spares))
    driver = SimWorldDriver(kill, drain, trace=trace,
                            snapshot=lambda: sess.snapshot(block=True))
    device = eng.device

    def restore_kwargs(target):
        # ceiling division: losing 1 of 4 hosts must not halve a
        # 2-slot engine — capacity shrinks proportionally, rounded up
        # (and a grow back to the full world restores the full slots)
        n_slots = max(1, -(-args.slots * len(target.hosts) // args.hosts))
        return {"params": params, "n_slots": n_slots, "device": device}

    def on_restored(e, target):
        print(f"[supervisor] restored {len(e.live_requests())} live "
              f"sessions on {e.n_slots} slots at engine step {e.steps}")

    sink = IncidentLog(args.incident_log) if args.incident_log else None
    sup = sess.supervise(
        world, spares=spares,
        heartbeat_timeout=args.heartbeat_timeout,
        clock=driver.clock, allow_shrink=not args.no_shrink,
        restore_kwargs=restore_kwargs, on_restored=on_restored,
        event_sink=sink)
    driver.attach(sup)
    if sess.latest_step() is None:
        sess.snapshot(block=True)   # baseline: a death before the first
        # --snapshot-every commit still has a restore target (a resumed
        # engine already has one — don't overwrite its manifest)
    reg = {}
    while max_steps > 0:
        eng = sup.runner
        for r in eng.live_requests():
            reg[r.rid] = r
        if not (eng.queue or any(eng.slot_req)):
            break
        eng.step()
        if on_step is not None:
            on_step(eng)
        max_steps -= 1
        sess.maybe_snapshot()   # Policy.interval is the one cadence
        driver.tick(eng.steps)
    driver.warn_if_kill_pending()
    driver.print_goodput()
    if sink is not None:
        sink.close()
    sess.wait()
    return sup.runner, reg


if __name__ == "__main__":
    sys.exit(main())
