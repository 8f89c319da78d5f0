"""Training launcher: run any registry architecture under the C/R
runtime, with automatic restore-if-checkpoint-exists semantics (the
production crash-loop contract: the same command line either cold-starts
or transparently resumes) — the port of ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch starcoder2-3b-smoke --shape train_s32_b4 --steps 20 \
      --store localfs:/tmp/job1

The run goes on the CUDA card; ``--device cpu`` runs it on the CPU (with
no card and no ``--device``, the launcher refuses to start).
``--data-mesh D --model-mesh M`` (the reference's flags) train over a
(D, M) ``DeviceMesh``: the launcher spawns D x M ranks
(``launch.mesh.spawn_ranks``), every rank on the card (they share one
card on a one-card machine) or, with ``--device cpu``, gloo CPU ranks;
rank 0 prints and commits the snapshots. ``--data-mesh 0`` (the default)
puts every device on the data axis: one here, as the port runs one
device a process. A re-run of the same command restores the last
checkpoint onto whatever mesh the flags name, one device included:

  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch starcoder2-3b-smoke --steps 8 --store localfs:/tmp/job2 \
      --data-mesh 2 --model-mesh 2 --device cpu

Swapping checkpoint packages is a one-string change (the paper's §V
claim at the command line): ``--store sharded:/tmp/job1?hosts=4``.
``--ckpt-dir`` (+ ``--backend``) remain as legacy aliases.

Re-running the identical command after a kill continues bitwise from the
last committed checkpoint. ``--resume [latest|STEP]`` makes the intent
explicit: it *requires* a restorable checkpoint (and can pick a specific
step), where the default behavior silently falls back to a cold start.

``--supervise`` closes the failure loop in-process: the run is routed
under a ``ClusterSupervisor`` over a simulated ``--hosts``-host world
(deterministic virtual clock, one tick per step) with ``--spares`` idle
hosts and ``--heartbeat-timeout`` ticks of silence meaning death.
``--kill-host H@STEP`` injects a host death mid-run; the supervisor
detects it, decides (hot-spare > shrink > restart-last-ckpt), and
executes the decision end-to-end — storage repair, restore through the
session's app-kind registry onto the same device, logged shard
rebalance — then training continues:

  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch starcoder2-3b-smoke --steps 20 --store sharded:/tmp/job1 \
      --supervise --hosts 4 --spares 1 --kill-host 2@8
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.core.churn import IncidentLog
from repro_torch.core.failure import FailureAction
from repro_torch.host import resolve_device
from repro_torch.launch.mesh import make_mesh, spawn_ranks
from repro_torch.launch.common import (add_store_args, build_session,
                                       parse_resume_arg, resolve_store,
                                       restore_timings_line, validate_resume)
from repro_torch.launch.supervise import (SimWorldDriver, add_supervise_args,
                                          parse_churn_args, parse_drain_arg,
                                          parse_supervise_args)
from repro_torch.train.loop import Trainer, TrainJob


def build_parser() -> argparse.ArgumentParser:
    """The launcher's command line (also for callers that drive
    ``_run_supervised`` themselves)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="registry id or '<id>-smoke'")
    ap.add_argument("--shape", default="train_s32_b4",
                    help="shape cell or '<kind>_s<seq>_b<batch>'")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA "
                         "card; 'cpu' runs on the CPU)")
    ap.add_argument("--data-mesh", type=int, default=0,
                    help="data axis size (0 = all devices: one)")
    ap.add_argument("--model-mesh", type=int, default=1)
    add_store_args(ap, interval_flag="--ckpt-every", interval_default=5,
                   keep_last_default=3)
    add_supervise_args(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    kill, err = parse_supervise_args(args, "launch")
    if err is not None:
        print(err, file=sys.stderr)
        return 2
    drain, err = parse_drain_arg(args, "launch")
    if err is not None:
        print(err, file=sys.stderr)
        return 2
    trace, err = parse_churn_args(args, "launch", horizon=args.steps)
    if err is not None:
        print(err, file=sys.stderr)
        return 2
    spec, err = resolve_store(args, "launch")
    if err is not None:
        print(err, file=sys.stderr)
        return 2
    if spec is None:
        print("[launch] a checkpoint store is required: --store "
              "scheme:/path (or legacy --ckpt-dir DIR)", file=sys.stderr)
        return 2
    resume, resume_step, err = parse_resume_arg(args, "launch")
    if err is not None:
        print(err, file=sys.stderr)
        return 2

    device = resolve_device(args.device)
    mesh = (args.data_mesh or 1, args.model_mesh)
    if mesh != (1, 1):
        if args.supervise:
            print("[launch] --supervise over a mesh of more than one rank "
                  "waits for ROADMAP A9b step 2", file=sys.stderr)
            return 2
        spawn_ranks(_mesh_rank, mesh[0] * mesh[1], device=str(device),
                    args=(args, spec, resume, resume_step, mesh))
        return 0
    sess, err = build_session(spec, "launch", interval=args.ckpt_every,
                              keep_last=args.keep_last)
    if err is not None:
        print(err, file=sys.stderr)
        return 2

    if resume:
        resume_step, err = validate_resume(sess, resume_step, spec,
                                           "launch")
        if err is not None:
            print(err, file=sys.stderr)
            return 2

    if sess.latest_step() is not None:
        tr = sess.restore(step=resume_step, expect_kind="train",
                          streaming=args.streaming_restore or None,
                          device=device)
        inc = tr.incarnation
        print(f"[launch] RESUMED {args.arch} at step "
              f"{tr.checkpoint_step()} from {spec} "
              f"({restore_timings_line(inc)})")
    else:
        job = TrainJob(arch=args.arch, shape_key=args.shape)
        tr = sess.attach(Trainer(job, manager=sess.manager, device=device))
        tr.init_state()
        print(f"[launch] COLD START {args.arch} on {device}")

    if args.supervise:
        tr = _run_supervised(args, sess, tr, kill, drain, trace, device)
    else:
        for step in range(tr.checkpoint_step(), args.steps):
            m = tr.train_steps(1)
            print(f"step {m['step']:5.0f} loss {m['loss']:.4f} "
                  f"lr {m['lr']:.2e}", flush=True)
            sess.maybe_snapshot(final=step + 1 == args.steps)
    sess.wait()
    print(f"[launch] done at step {tr.checkpoint_step()}; "
          f"checkpoints: {sess.backend.list_steps()}")
    return 0


def _mesh_rank(rank, world, args, spec, resume, resume_step, mesh):
    """One rank of a (D, M) mesh run: restore onto ``mesh`` if the store
    has a checkpoint (every rank reads it), else a cold start; the step
    loop, with rank 0 printing and committing the snapshots (each one
    collective: each leaf gathered onto rank 0, ``Trainer.save``)."""
    device = resolve_device(args.device)
    say = print if rank == 0 else (lambda *a, **k: None)
    sess, err = build_session(spec, "launch", interval=args.ckpt_every,
                              keep_last=args.keep_last)
    if err is not None:
        raise ValueError(err)
    if resume:
        resume_step, err = validate_resume(sess, resume_step, spec, "launch")
        if err is not None:
            raise ValueError(err)
    factory = lambda: make_mesh(mesh, ("data", "model"), device)
    if sess.latest_step() is not None:
        tr = sess.restore(step=resume_step, expect_kind="train",
                          streaming=args.streaming_restore or None,
                          mesh_factory=factory)
        say(f"[launch] RESUMED {args.arch} at step {tr.checkpoint_step()} "
            f"from {spec} onto mesh {mesh} "
            f"({restore_timings_line(tr.incarnation)})")
    else:
        job = TrainJob(arch=args.arch, shape_key=args.shape)
        tr = Trainer(job, mesh, ("data", "model"), manager=sess.manager,
                     device=device)
        tr.init_state()
        say(f"[launch] COLD START {args.arch} on mesh {mesh} x {device}")
    for step in range(tr.checkpoint_step(), args.steps):
        m = tr.train_steps(1)
        say(f"step {m['step']:5.0f} loss {m['loss']:.4f} "
            f"lr {m['lr']:.2e}", flush=True)
        done = step + 1
        if done == args.steps or (args.ckpt_every
                                  and done % args.ckpt_every == 0):
            tr.save(block=False)
    if rank == 0:
        sess.wait()
    say(f"[launch] done at step {tr.checkpoint_step()}; "
        f"checkpoints: {sess.backend.list_steps()}")
    sess.close()


def _run_supervised(args, sess, tr, kill, drain=None, trace=None,
                    device=None, on_step=None):
    """The failure loop around the step loop: every step is one tick of
    the simulated world's clock; live hosts heartbeat, the supervisor
    polls, and an executed decision swaps the runner under us — the
    restore goes back through the session's app-kind registry onto
    ``device`` (the trainer's own by default), so the supervisor never
    touches trainer-specific code. Scripted --drain triggers and full
    --churn traces run through the same ``ChurnEngine``: preemption
    notices snapshot proactively and drain before the deadline,
    returned hosts re-enter the spare pool, and the engine grows the
    world back when capacity is idle. ``on_step(step, metrics)``, when
    given, observes every step's metrics. Returns the supervisor's
    runner."""
    world = list(range(args.hosts))
    spares = list(range(args.hosts, args.hosts + args.spares))
    driver = SimWorldDriver(kill, drain, trace=trace,
                            snapshot=lambda: sess.snapshot(block=True))

    def on_restored(t, target):
        print(f"[supervisor] restored at step "
              f"{t.checkpoint_step()} on hosts {target.hosts}")

    sink = IncidentLog(args.incident_log) if args.incident_log else None
    sup = sess.supervise(
        world, spares=spares,
        heartbeat_timeout=args.heartbeat_timeout,
        clock=driver.clock, n_shards=tr.shape.global_batch,
        allow_shrink=not args.no_shrink,
        restore_kwargs={"device": device if device is not None
                        else tr.device},
        on_restored=on_restored, event_sink=sink)
    driver.attach(sup)
    if sess.latest_step() is None:
        sess.snapshot(block=True)   # baseline: a death before the first
        # --ckpt-every commit still has a restore target
    step = tr.checkpoint_step()
    while step < args.steps:
        tr = sup.runner
        m = tr.train_steps(1)
        step = tr.checkpoint_step()
        print(f"step {m['step']:5.0f} loss {m['loss']:.4f} "
              f"hosts {sup.world}", flush=True)
        if on_step is not None:
            on_step(step, m)
        sess.maybe_snapshot(final=step == args.steps)
        targets = driver.tick(step)
        if any(t.action is not FailureAction.HOT_SPARE
               for t in targets):
            step = sup.runner.checkpoint_step()  # rolled back
    driver.warn_if_kill_pending()
    for inc in sup.incidents:
        print(f"[supervisor] incident {inc.action}: dead={inc.dead} "
              f"step={inc.step} mttr={inc.wall_s:.2f}s")
    driver.print_goodput()
    if sink is not None:
        sink.close()
    return sup.runner


if __name__ == "__main__":
    sys.exit(main())
