"""Shared checkpoint-store surface for the launchers.

Both entry points (train, serve) speak the same store/resume flags and
build the same ``CheckpointSession``; this module is the single
definition of those flags, their validation, and the session
construction — so the surface can't drift between the two (the same
rule ``launch.supervise`` applies to the --supervise flags).

The store is a URI spec resolved through the ``repro_torch.api`` backend
registry, which makes the paper's §V two-package claim a command-line
literal — swapping checkpoint packages is a one-string change:

    --store localfs:/tmp/job1                      # CRIU-analogue
    --store sharded:/tmp/job1?hosts=4&replicate=1  # DMTCP-analogue

``--ckpt-dir``/``--backend`` stay as legacy aliases that fold into a
store spec.
"""
from __future__ import annotations

import argparse
from typing import Optional, Tuple

from repro_torch.api import CheckpointSession, Policy


def add_store_args(ap: argparse.ArgumentParser, *,
                   interval_flag: str = "--ckpt-every",
                   interval_default: int = 5,
                   interval_unit: str = "steps",
                   keep_last_default: Optional[int] = None) -> None:
    ap.add_argument("--store", default=None, metavar="URI",
                    help="checkpoint store spec 'scheme:/path[?k=v&...]' "
                         "(e.g. localfs:/tmp/job or "
                         "sharded:/tmp/job?hosts=4&replicate=1); "
                         "supersedes --ckpt-dir/--backend")
    ap.add_argument("--ckpt-dir", default=None,
                    help="legacy: checkpoint directory (folds into a "
                         "--store spec with --backend)")
    ap.add_argument("--backend", choices=("localfs", "sharded"),
                    default="localfs",
                    help="legacy: backend scheme for --ckpt-dir")
    ap.add_argument("--keep-last", type=int, default=keep_last_default,
                    help="retention: checkpoints to keep (default: "
                         f"{keep_last_default or 'all'})")
    ap.add_argument(interval_flag, type=int, default=interval_default,
                    help=f"snapshot cadence in {interval_unit}")
    ap.add_argument("--resume", nargs="?", const="latest", default=None,
                    metavar="STEP",
                    help="resume from a checkpoint: 'latest' (the bare "
                         "flag) or a step number; fails instead of "
                         "cold-starting when none is restorable")
    ap.add_argument("--streaming-restore", action="store_true",
                    help="stream the --resume: come back up as soon as "
                         "the hot tier (sessions, params) is decoded; "
                         "cold entries (optimizer moments, KV cache) "
                         "page in on first touch. Bit-identical to the "
                         "eager restore")


def resolve_store(args, prog: str) -> Tuple[Optional[str], Optional[str]]:
    """-> (store spec, error). Folds the legacy --ckpt-dir/--backend
    pair into a URI spec; a non-None error is the message the launcher
    prints before exiting 2."""
    if args.store and args.ckpt_dir:
        return None, (f"[{prog}] give --store or --ckpt-dir, not both "
                      "(--store already names the directory)")
    if args.store:
        return args.store, None
    if args.ckpt_dir:
        return f"{args.backend}:{args.ckpt_dir}", None
    return None, None


def build_session(spec: str, prog: str, *, interval: Optional[int] = None,
                  keep_last: Optional[int] = None,
                  ) -> Tuple[Optional[CheckpointSession], Optional[str]]:
    """-> (session, error): build the Policy AND resolve the store spec
    inside one error boundary, so any invalid flag value — bad scheme,
    bad parameter, bad cadence — becomes the launcher's one-line exit-2
    message, never a traceback. ``interval`` 0 means "no automatic
    cadence" on BOTH launchers (the store stays usable for explicit
    snapshots and resume)."""
    from repro_torch.api.errors import PolicyError
    try:
        policy = Policy(interval=interval or None, keep_last=keep_last)
        return CheckpointSession(spec, policy), None
    except PolicyError as e:
        return None, f"[{prog}] {e}"


def restore_timings_line(inc) -> str:
    """The per-phase restore observability for a RESUMED banner: eager
    phase timings always; under a streaming restore, also the pipeline
    counters — fetch wall + per-source throughput, how much decode hid
    inside the fetch window, lazy faults served, hedges won."""
    t = inc.timings
    parts = [f"materialize {t.get('materialize_s', 0.0):.2f}s",
             f"replay {t.get('replay_s', 0.0):.2f}s"]
    if "rebind_s" in t:
        parts.append(f"rebind {t['rebind_s']:.2f}s")
    st = inc.stream_timings() if hasattr(inc, "stream_timings") else None
    if st is not None:
        rates = ", ".join(
            f"{k} {v:.1f}MB/s" for k, v in
            sorted(st.get("fetch_mb_s_per_source", {}).items()))
        stream = f"stream[fetch {st['fetch_s']:.2f}s"
        if rates:
            stream += f" ({rates})"
        stream += (f", decode overlap {st['decode_overlap_pct']:.0f}%, "
                   f"lazy faults {st['lazy_faults']}")
        if st.get("hedges"):
            stream += f", hedges won {st['hedge_wins']}/{st['hedges']}"
        parts.append(stream + "]")
    return ", ".join(parts)


def parse_resume_arg(args, prog: str
                     ) -> Tuple[bool, Optional[int], Optional[str]]:
    """-> (resume requested, explicit step or None, error)."""
    if args.resume is None:
        return False, None, None
    if args.resume == "latest":
        return True, None, None
    try:
        return True, int(args.resume), None
    except ValueError:
        return True, None, (f"[{prog}] --resume: expected 'latest' or a "
                            f"step number, got {args.resume!r}")


def validate_resume(sess: CheckpointSession, step: Optional[int],
                    where: str, prog: str
                    ) -> Tuple[Optional[int], Optional[str]]:
    """Resolve an explicit --resume against the committed steps whose
    delta chains are intact. -> (step, error)."""
    ok = sess.restorable_steps()
    if not ok or (step is not None and step not in ok):
        return None, (f"[{prog}] --resume: step "
                      f"{'latest' if step is None else step} not "
                      f"restorable in {where} (have {ok})")
    return step if step is not None else ok[-1], None
