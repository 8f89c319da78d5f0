"""Fleet launcher: many live engines, one router, planned moves — the
port of ``repro.launch.fleet``.

  PYTHONPATH=src python -m repro_torch.launch.fleet \
      --arch phi4-mini-3.8b-smoke --engines 2 --slots 2 --rate 1.0 \
      --requests 12 --store localfs:/tmp/fleet --migrate e0:e1@6 \
      [--device cpu]

Every engine runs on the CUDA card (``--device cpu``: on the CPU; with no
card and no ``--device`` the launcher refuses to start), over one set of
params, the port's seeded init.

Synthetic Poisson traffic (``serving.traffic``) arrives at a
``FleetRouter`` over ``--engines`` named engines; at the trigger step a
live move runs through the C/R move channel — ``--migrate SRC:DST@STEP``
moves SRC's live slots onto DST while SRC keeps serving what stays,
``--drain NAME@STEP`` moves *everything* (slots + queue) and retires
NAME from the rotation. Requests that arrive for a draining engine are
held and replayed on the target. The run exits non-zero if any request
was dropped or duplicated — the router's counters are the claim.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.configs import registry as cfg_registry
from repro_torch.core.migration import FleetRouter
from repro_torch.host import resolve_device
from repro_torch.models import model as M
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.traffic import TrafficGenerator


def _parse_move(spec, prog: str, flag: str, names):
    """SRC:DST@STEP (--migrate) or NAME@STEP (--drain)."""
    if spec is None:
        return None, None
    try:
        head, at = spec.split("@")
        parts = head.split(":")
        if flag == "--migrate":
            src, dst = parts
        else:
            (src,), dst = parts, None
        move = (src, dst, int(at))
    except ValueError:
        shape = "SRC:DST@STEP" if flag == "--migrate" else "NAME@STEP"
        return None, (f"[{prog}] {flag}: expected {shape}, got {spec!r}")
    for name in filter(None, move[:2]):
        if name not in names:
            return None, (f"[{prog}] {flag}: unknown engine {name!r} "
                          f"(fleet has {sorted(names)})")
    if move[0] == move[1]:
        return None, f"[{prog}] {flag}: SRC and DST are both {move[0]!r}"
    return move, None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--engines", type=int, default=2)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--rate", type=float, default=1.0,
                    help="mean Poisson arrivals per fleet step")
    ap.add_argument("--requests", type=int, default=12,
                    help="total synthetic requests to emit")
    ap.add_argument("--steps", type=int, default=10_000,
                    help="fleet step budget")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA "
                         "card; 'cpu' runs on the CPU)")
    ap.add_argument("--store", required=True,
                    help="store spec the move channel rides under "
                         "(e.g. localfs:/tmp/fleet)")
    ap.add_argument("--migrate", default=None, metavar="SRC:DST@STEP",
                    help="at fleet step STEP, live-move SRC's slots "
                         "onto DST")
    ap.add_argument("--drain", default=None, metavar="NAME@STEP",
                    help="at fleet step STEP, move everything off NAME "
                         "and retire it from the rotation")
    ap.add_argument("--batch", type=int, default=None,
                    help="sessions frozen per move batch (bounds "
                         "per-session blackout)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="drain deadline in seconds (worst per-batch "
                         "blackout budget; missed = reported, not "
                         "aborted)")
    args = ap.parse_args(argv)

    if args.engines < 2 and (args.migrate or args.drain):
        print("[fleet] a move needs at least 2 engines", file=sys.stderr)
        return 2
    names = [f"e{i}" for i in range(args.engines)]
    migrate, err = _parse_move(args.migrate, "fleet", "--migrate", names)
    if err is not None:
        print(err, file=sys.stderr)
        return 2
    drain, err = _parse_move(args.drain, "fleet", "--drain", names)
    if err is not None:
        print(err, file=sys.stderr)
        return 2

    device = resolve_device(args.device)
    cfg = cfg_registry.resolve_config(args.arch)
    params = M.init_params(cfg, seed=args.seed, device=device)
    engines = {n: ServingEngine(cfg, params, device, n_slots=args.slots,
                                max_seq=args.max_seq) for n in names}
    router = FleetRouter(engines, via=args.store,
                         migrate_batch=args.batch,
                         drain_deadline_s=args.deadline)
    traffic = TrafficGenerator(args.rate, seed=args.seed,
                               vocab=cfg.vocab_size,
                               limit=args.requests)

    t0 = time.monotonic()
    for step in range(1, args.steps + 1):
        traffic.tick(router)
        router.step()
        for mv, kind in ((migrate, "migrate"), (drain, "drain")):
            if mv is not None and step == mv[2]:
                src, dst, _ = mv
                if dst is None:
                    dst = min((n for n in names if n != src),
                              key=lambda n: len(
                                  engines[n].live_requests()))
                res = router.drain(src, dst) if kind == "drain" \
                    else router.migrate(src, dst)
                print(f"[fleet] {kind} {src} -> {dst}: "
                      f"{len(res.moved)} sessions moved, blackout "
                      f"{res.blackout_s * 1e3:.0f}ms "
                      f"({len(res.batches)} batches, {res.replayed} "
                      f"held requests replayed, deadline "
                      f"{'ok' if res.within_deadline else 'MISSED'})")
        if traffic.drained() and not router.inflight \
                and not router._held:
            break
    dt = time.monotonic() - t0

    s = router.stats()
    toks = sum(len(r.out) for r in router.completed.values())
    print(f"[fleet] {s['submitted']} requests, {toks} tokens in "
          f"{dt:.2f}s over {args.engines} engines "
          f"({s['completed']} completed, {s['dropped']} dropped, "
          f"{s['duplicates']} duplicated, {s['moves']} moves, worst "
          f"blackout {s['worst_blackout_s'] * 1e3:.0f}ms)")
    if s["dropped"] or s["duplicates"] or s["inflight"] or s["held"]:
        print(f"[fleet] FAILED: requests lost or duplicated: {s}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
