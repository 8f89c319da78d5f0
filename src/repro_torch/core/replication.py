"""Peer-replication repair for ``ShardedBackend`` (the DMTCP-analogue's
failure half).

With ``replicate=True`` every blob lives twice: the primary copy on its
owner host ``h = _host_of(name)`` and a ``replica_``-prefixed copy on
the ring successor ``(h+1) % N``. Losing any single host therefore
loses no data — but it *does* leave the store degraded: the next
checkpoint's writes to the dead host fail loudly, and a second failure
on an adjacent host would be unrecoverable. ``repair`` closes that
window: it re-creates the lost host's directory and rebuilds every blob
that should live there from its surviving peer copy, returning the
store to full redundancy before a restore (or the next snapshot) runs.

This is the supervisor's storage-repair step: the JAX package's
``ClusterSupervisor`` calls ``repair`` after a host death and before
driving the Incarnation restore, so the restore never depends on the
dead host (the port's failure loop waits for ROADMAP A7).

``scan`` is the read-only half (what's missing, what's unrecoverable);
``repair`` is scan + rewrite through the backend's atomic write
protocol, so a crash mid-repair leaves only invisible temp files.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.backends.base import write_atomic
from repro_torch.core.backends.sharded import ShardedBackend

_REPLICA = "replica_"


@dataclass
class RepairReport:
    """What a scan/repair pass found (and, for repair, fixed)."""
    hosts: int = 0
    blobs: int = 0                       # distinct blob names seen
    missing_primaries: int = 0
    missing_replicas: int = 0
    restored: int = 0                    # copies rewritten by repair()
    unrecoverable: List[str] = field(default_factory=list)

    @property
    def degraded(self) -> bool:
        return bool(self.missing_primaries or self.missing_replicas
                    or self.unrecoverable)


def _survey(backend: ShardedBackend) -> Dict[str, List[Path]]:
    """name -> every path the blob *should* occupy (primary first).

    Names come from two sources: the surviving host directories (covers
    garbage blobs a not-yet-committed manifest may still reference) and
    every committed manifest's referenced hashes — the latter is what
    lets a blob that lost *all* its copies still be named as
    unrecoverable instead of silently forgotten."""
    names = set()
    for h in range(backend.n_hosts):
        d = backend.root / f"host_{h:03d}"
        if not d.is_dir():
            continue
        for p in d.iterdir():
            n = p.name
            if n.startswith(".tmp"):
                continue
            names.add(n[len(_REPLICA):] if n.startswith(_REPLICA) else n)
    from repro_torch.core.delta import referenced_hashes
    for step in backend.list_steps():
        try:
            names |= referenced_hashes(backend.get_manifest(step))
        except FileNotFoundError:   # raced a concurrent GC
            pass
    return {n: backend._paths(n) for n in sorted(names)}


def _account(rep: RepairReport, backend: ShardedBackend, name: str,
             paths: List[Path]) -> List[Path]:
    """Classify one blob into the report; returns its surviving paths
    (empty = unrecoverable). The single definition of 'degraded' that
    scan and repair both count with."""
    rep.blobs += 1
    alive = [p for p in paths if p.exists()]
    if not alive:
        rep.unrecoverable.append(name)
        return alive
    if not paths[0].exists():
        rep.missing_primaries += 1
    if backend.replicate and len(paths) > 1 and not paths[1].exists():
        rep.missing_replicas += 1
    return alive


def scan(backend: ShardedBackend) -> RepairReport:
    """Read-only integrity survey: which blobs are missing their primary
    or replica copy, and which have lost *every* copy (named in
    ``unrecoverable`` — the checkpoints referencing them are gone for
    good and ``restorable_steps`` / manifest verification will say so
    loudly)."""
    rep = RepairReport(hosts=backend.n_hosts)
    for name, paths in _survey(backend).items():
        _account(rep, backend, name, paths)
    return rep


def repair(backend: ShardedBackend, host: Optional[int] = None,
           heal: bool = True) -> RepairReport:
    """Rebuild every missing blob copy from its surviving peer.

    ``host``: if given, that host's directory is (re)created first —
    the caller is telling us this host's storage was lost wholesale
    (e.g. ``rm -rf host_002``); repair then restores both the primaries
    it owned and the replicas it held for its ring predecessor. With
    ``host=None`` the whole store is swept — same result, useful when
    the caller only knows "something is degraded".

    ``heal``: drop ``host`` (or, when sweeping, every host) from the
    backend's failure-injection set once its data is rebuilt, so
    subsequent reads/writes reach it again.

    Every rewrite goes through the backend's atomic temp+fsync+rename
    protocol; a crash mid-repair is invisible and re-running repair is
    idempotent. Blobs with no surviving copy are reported, not raised:
    the caller decides whether the manifests that reference them are
    restorable (``restorable_steps`` / manifest verification will fail
    loudly for those)."""
    if heal:
        for h in ((host,) if host is not None else
                  range(backend.n_hosts)):
            backend.heal_host(h)
    for h in range(backend.n_hosts):
        (backend.root / f"host_{h:03d}").mkdir(parents=True, exist_ok=True)
    rep = RepairReport(hosts=backend.n_hosts)
    for name, paths in _survey(backend).items():
        alive = _account(rep, backend, name, paths)
        if not alive:
            continue
        data = None
        for p in paths:
            if not p.exists():
                if data is None:
                    data = alive[0].read_bytes()
                write_atomic(p, data, backend.fsync)
                rep.restored += 1
    return rep


def blob_sources(backend, name: str) -> List[Tuple[str, Callable[[], bytes]]]:
    """Every place one blob can be read from, as ordered
    ``(label, read_callable)`` pairs — the preferred source first.

    This is the streaming restore's fetch fan-out (the port's streaming
    restore waits for ROADMAP A4): a ``ShardedBackend``
    exposes the primary copy on the owner host and the ``replica_`` copy
    on its (h+1)%N ring successor as *independent* sources, so the
    fetcher can hedge a slow or dead primary with its peer instead of
    serializing behind ``get_blob``'s internal failover. Backends with
    their own tiering (e.g. the ``cached:`` read-through store) override
    the enumeration via a ``blob_sources`` method; anything else is a
    single opaque source. Each callable raises (``FileNotFoundError``,
    ``IOError``) when its copy is unavailable *at read time* — liveness
    is judged per read, not per plan."""
    own = getattr(backend, "blob_sources", None)
    if callable(own):
        return own(name)
    if isinstance(backend, ShardedBackend):
        out: List[Tuple[str, Callable[[], bytes]]] = []
        for host, path in backend._placements(name):
            if host in backend._failed_hosts:
                continue

            def read(p=path, h=host) -> bytes:
                if h in backend._failed_hosts:
                    raise IOError(f"host {h} down; read of {p.name} lost")
                return p.read_bytes()

            out.append((f"host_{host:03d}", read))
        if out:
            return out
        # every placement's host is failed: fall through to get_blob so
        # the error message names each dead copy
    return [("store", lambda: backend.get_blob(name))]


def verify_restorable(backend: ShardedBackend, manifest: dict,
                      exclude: Optional[set] = None) -> List[str]:
    """Blob names a manifest references that no live host can serve —
    empty means the checkpoint is servable right now. (Used by
    ``ShardedBackend.commit_manifest`` to fail loudly instead of
    publishing a checkpoint whose writes were lost.)

    ``exclude``: hashes already verified elsewhere and skipped here —
    the commit path passes the parent chain link's references, which
    were verified when *that* manifest committed, so per-commit
    verification cost stays O(this snapshot's writes), not O(total
    checkpoint size)."""
    from repro_torch.core.delta import referenced_hashes
    refs = referenced_hashes(manifest)
    if exclude:
        refs -= exclude
    return sorted(h for h in refs if not backend.has_blob(h))


# ---------------------------------------------------------------------------
# operator CLI: survey (and optionally repair) replica health
# ---------------------------------------------------------------------------

def report_json(rep: RepairReport) -> Dict:
    """A ``RepairReport`` as the stable JSON shape the CLI emits (the
    dataclass fields plus the derived ``degraded`` verdict)."""
    out = asdict(rep)
    out["degraded"] = rep.degraded
    return out


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m repro_torch.core.replication STORE [--json] [--repair]``

    Survey replica health before a planned restore: which blobs lost
    their primary or replica copy, and which lost every copy. Exits 0
    on a healthy (or fully repaired) store, 1 when degraded — so
    ``scan --json || page-someone`` works as an operator probe. The
    store spec goes through the same registry as ``--store``
    (``sharded:/path?hosts=4&replicate=1``, or ``cached:`` over it)."""
    import argparse
    import json as jsonmod
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.replication",
        description="survey (and repair) peer-replica health of a "
                    "sharded checkpoint store")
    ap.add_argument("store", help="store spec, e.g. "
                                  "'sharded:/path?hosts=4&replicate=1'")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the report as JSON on stdout")
    ap.add_argument("--repair", action="store_true",
                    help="rebuild missing copies from surviving peers "
                         "(scan only, by default)")
    ap.add_argument("--host", type=int, default=None,
                    help="with --repair: the host whose storage was "
                         "lost wholesale")
    args = ap.parse_args(argv)

    from repro_torch.api.registry import resolve_backend
    backend = resolve_backend(args.store)
    # a cached: front is a read-through view; replication health is a
    # property of the replicating store underneath it
    backend = getattr(backend, "inner", backend)
    if not isinstance(backend, ShardedBackend):
        print(f"error: {args.store!r} resolves to "
              f"{type(backend).__name__}, but replica scan needs a "
              "sharded store (scheme 'sharded:', or 'cached:' over it)",
              file=sys.stderr)
        return 2
    rep = repair(backend, host=args.host) if args.repair else scan(backend)
    if args.as_json:
        print(jsonmod.dumps(report_json(rep), indent=2, sort_keys=True))
    else:
        verb = "repair" if args.repair else "scan"
        print(f"{verb}: {rep.blobs} blobs across {rep.hosts} hosts; "
              f"{rep.missing_primaries} missing primaries, "
              f"{rep.missing_replicas} missing replicas, "
              f"{rep.restored} restored, "
              f"{len(rep.unrecoverable)} unrecoverable")
    # a repair's report keeps what it *found* (and fixed); the exit code
    # answers "is the store healthy now" — so re-survey after a repair
    health = scan(backend) if args.repair else rep
    return 1 if health.degraded else 0


if __name__ == "__main__":  # pragma: no cover — exercised via main()
    import sys
    sys.exit(main())
