"""Streaming restore: fetch, decode and page in a checkpoint as a
pipeline instead of a barrier — the port of ``repro.core.streaming``.

Eager restore (``materialize_manifest_chain``) reads every blob, decodes
every leaf, and only then lets replay and rebinding start; at full model
sizes that wall clock is the floor of the time to recover. CRIU's
lazy-pages restore and MANA's transport-agnostic blob sourcing are the
precedents this module applies to the delta-chain format:

fetch   every blob the target step's chain references streams in from
        *all* of its live sources concurrently — the owning host and
        its (h+1)%N replica peer on a sharded store
        (``replication.blob_sources``), the local cache tier and the
        remote store on a ``cached:`` front. A slow source is hedged:
        after ``hedge_s`` without a byte, the next copy is raced and
        the first success wins.
decode  a per-leaf dependency counter (sized by ``delta.
        leaf_blob_names`` over the leaf's XOR run) releases each leaf's
        chain decode the moment its *own* blobs land — decode overlaps
        fetch, and the decode code path is byte-for-byte the eager
        one (``_decode_chain_leaf``), which is what makes streaming
        restore bit-identical by construction. A leaf decodes to the
        same host value the eager path gives: a numpy array (bfloat16
        as its uint16 bit view) or, for an ``int8`` codec leaf, a
        ``delta.Int8Leaf`` that is dequantized where it is bound.
page-in leaves are split into priority tiers by entry kind: hot
        entries (session/scheduler state, params) are fetched first and
        ``hot_result`` returns as soon as they are decoded; cold
        entries (optimizer moments, the serving KV cache) become
        ``LazyLeaves`` placeholders that keep streaming in the
        background and block only the first toucher — a touch before
        arrival is a *lazy fault*, which promotes the leaf's remaining
        blobs to the front of the fetch queue.

The result is that a restored serving engine admits requests while the
bulk of the payload is still in flight; ``core.incarnation`` folds the
per-phase counters (bytes/s per source, decode overlap, faults served,
hedges won) into ``Incarnation.timings``.

The pools shut down by themselves once the last leaf resolves, from a
decode worker, while ``start()`` may still be submitting fetch loops (a
small checkpoint can be fetched by the first one) or a fetch or hedge
read may be in flight (a failed leaf drops its siblings). ``start()``
and every later submit therefore hold the lock that ``_shutdown_pools``
takes, and check ``_closed`` under it, so no submit can land on a pool
that is already shut down.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.api.errors import RestoreError
from repro_torch.core import delta as deltamod
from repro_torch.core.async_snapshot import (_decode_chain_leaf,
                                             leaf_chain_start,
                                             manifest_chain_steps)
from repro_torch.core.backends.base import CheckpointBackend

# entry kinds that default to the cold (lazy) tier: optimizer moments
# are untouched until the first optimizer step after resume, and the
# serving KV cache is consumed only at the first decode step — both can
# stream in behind admission / replay / hot rebinding
DEFAULT_LAZY_KINDS = ("opt_state", "cache")

# hedge a multi-source blob read after this long without a result
DEFAULT_HEDGE_S = 0.05

_LeafKey = Tuple[str, str]           # (entry name, leaf path)


class _BlobView:
    """``get_blob`` view over the fetcher's in-memory buffers, handed to
    the (unchanged) eager decode path — identical bytes in, identical
    arrays out."""

    def __init__(self, blobs: Dict[str, bytes]) -> None:
        self._blobs = blobs

    def get_blob(self, name: str) -> bytes:
        return self._blobs[name]


class LazyLeaves(Mapping):
    """One entry's leaf-path -> array map, resolving per leaf.

    Transparent to every consumer of ``RestoredState.entries`` values
    (``fill_like``, ``tree_from_paths``, ``restore_scalar`` only need
    Mapping semantics); a lookup of a leaf still in flight blocks that
    caller — and only that caller — after promoting the leaf to the
    front of the fetch queue (a *lazy fault*). ``wait()`` resolves the
    whole entry at once (bulk consumers like the serving engine's
    deferred cache merge)."""

    def __init__(self, name: str, paths: List[str],
                 materializer: "StreamingMaterializer") -> None:
        self._name = name
        self._paths = list(paths)
        self._m = materializer

    def __getitem__(self, path: str) -> np.ndarray:
        if path not in self._paths:
            raise KeyError(path)
        return self._m.leaf_value(self._name, path)

    def __iter__(self) -> Iterator[str]:
        return iter(self._paths)

    def __len__(self) -> int:
        return len(self._paths)

    def __contains__(self, path: object) -> bool:
        return path in self._paths

    def ready(self, path: str) -> bool:
        return self._m.leaf_ready(self._name, path)

    def wait(self) -> None:
        """Block until every leaf of this entry is decoded."""
        self._m.wait_entry(self._name)

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        done = sum(1 for p in self._paths if self.ready(p))
        return (f"LazyLeaves({self._name!r}, {done}/{len(self._paths)} "
                "decoded)")


class StreamingMaterializer:
    """One streaming materialization of one checkpoint step.

    Single-use, thread-owning: ``start()`` launches the fetch workers
    and decode pool, ``hot_result()`` blocks for the hot tier only, and
    the object shuts its pools down by itself once the last leaf
    decodes (or ``wait_all`` / an error drains it)."""

    def __init__(self, backend: CheckpointBackend, step: int, *,
                 skip_entries=(), lazy_kinds=DEFAULT_LAZY_KINDS,
                 fetch_workers: Optional[int] = None,
                 decode_workers: Optional[int] = None,
                 hedge_s: float = DEFAULT_HEDGE_S) -> None:
        import os
        self.backend = backend
        self.step = step
        self.hedge_s = hedge_s
        self.lazy_kinds = frozenset(lazy_kinds or ())
        cpus = os.cpu_count() or 1
        self.fetch_workers = fetch_workers or min(8, cpus)
        self.decode_workers = decode_workers or min(8, cpus)

        self.manifests = [backend.get_manifest(s)
                          for s in manifest_chain_steps(backend, step)]
        self.final = self.manifests[-1]
        skip = self._skip = set(skip_entries)

        self._lock = threading.Lock()
        self._futures: Dict[_LeafKey, Future] = {}
        self._hot_keys: List[_LeafKey] = []
        self._cold_keys: List[_LeafKey] = []
        # blob name -> bytes (held only while some leaf still needs it)
        self._blobs: Dict[str, bytes] = {}
        self._blob_refs: Dict[str, int] = {}
        self._blob_waiters: Dict[str, List[_LeafKey]] = {}
        self._leaf_pending: Dict[_LeafKey, set] = {}
        self._leaf_blobs: Dict[_LeafKey, List[str]] = {}
        self._view = _BlobView(self._blobs)

        for name, entry in self.final["entries"].items():
            if name in skip:
                continue
            cold = entry.get("kind") in self.lazy_kinds
            for path in entry["leaves"]:
                key = (name, path)
                self._futures[key] = Future()
                (self._cold_keys if cold else self._hot_keys).append(key)
                blobs: List[str] = []
                # THE run-start walk of the eager decoder — shared, so
                # the planner's blob set is the decode's blob set by
                # construction (an entry or leaf first introduced
                # mid-chain bounds the walk instead of KeyError-ing)
                i = leaf_chain_start(self.manifests, name, path)
                for m in self.manifests[i:]:
                    blobs.extend(deltamod.leaf_blob_names(
                        m["entries"][name]["leaves"][path]))
                uniq = list(dict.fromkeys(blobs))
                self._leaf_blobs[key] = uniq
                self._leaf_pending[key] = set(uniq)
                for b in uniq:
                    self._blob_refs[b] = self._blob_refs.get(b, 0) + 1
                    self._blob_waiters.setdefault(b, []).append(key)

        # fetch order: hot leaves' blobs first, then cold — dedup keeps
        # a blob shared across tiers at its earliest position
        order: List[str] = []
        for key in self._hot_keys + self._cold_keys:
            order.extend(self._leaf_blobs[key])
        self._queue: deque = deque(dict.fromkeys(order))
        self._queued: set = set(self._queue)
        self._hot_set = set(self._hot_keys)
        self._in_flight: set = set()
        self._leaves_left = len(self._futures)
        self._hot_left = len(self._hot_keys)
        self._hot_done = threading.Event()
        if self._hot_left == 0:
            self._hot_done.set()

        # observability
        self.stats: Dict[str, Any] = {
            "hot_leaves": len(self._hot_keys),
            "cold_leaves": len(self._cold_keys),
            "blobs": len(self._queued),
            "source_bytes": {},
            "hedges": 0,
            "hedge_wins": 0,
            "lazy_faults": 0,
        }
        self._t0: Optional[float] = None
        self._fetch_end: Optional[float] = None
        self._hot_ready_s: Optional[float] = None
        self._decode_busy_s = 0.0
        self._decode_overlap_s = 0.0
        self._started = False
        self._closed = False
        self._fetch_pool: Optional[ThreadPoolExecutor] = None
        self._hedge_pool: Optional[ThreadPoolExecutor] = None
        self._decode_pool: Optional[ThreadPoolExecutor] = None

    # --- lifecycle ------------------------------------------------------

    def start(self) -> "StreamingMaterializer":
        assert not self._started, "start() already ran"
        self._started = True
        self._t0 = time.monotonic()
        if not self._queue:
            self._fetch_end = self._t0
        # under the lock: every pool exists, and every fetch loop is
        # submitted, before a decode worker that resolves the last leaf
        # can shut the pools down
        with self._lock:
            self._decode_pool = ThreadPoolExecutor(
                max_workers=self.decode_workers,
                thread_name_prefix="stream-decode")
            # zero-blob leaves (all-zero tensors, empty arrays) decode now
            for key, pending in list(self._leaf_pending.items()):
                if not pending:
                    self._decode_pool.submit(self._decode_leaf, key)
            if self._queue:
                self._fetch_pool = ThreadPoolExecutor(
                    max_workers=self.fetch_workers,
                    thread_name_prefix="stream-fetch")
                # hedge slots: every fetch worker may hold one primary
                # and one hedge read in flight
                self._hedge_pool = ThreadPoolExecutor(
                    max_workers=max(4, 2 * self.fetch_workers),
                    thread_name_prefix="stream-hedge")
                for _ in range(self.fetch_workers):
                    self._fetch_pool.submit(self._fetch_loop)
        return self

    def _shutdown_pools(self) -> None:
        # called from a decode worker after the last leaf resolves, so
        # nothing may join its own pool; under the lock, so that no
        # submit falls between a ``_closed`` check and its pool's
        # shutdown (``_submit``)
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for pool in (self._fetch_pool, self._hedge_pool,
                         self._decode_pool):
                if pool is not None:
                    pool.shutdown(wait=False)

    def _submit(self, pool: Optional[ThreadPoolExecutor], fn,
                *args) -> Optional[Future]:
        """``pool.submit(fn, *args)`` unless the pools are shut down
        (then None): the check and the submit are one step under the
        lock. Once closed, every leaf has resolved, so nothing that is
        refused here had a reader left."""
        with self._lock:
            if self._closed:
                return None
            return pool.submit(fn, *args)

    # --- fetch side -----------------------------------------------------

    def _next_blob(self) -> Optional[str]:
        with self._lock:
            if not self._queue:
                return None
            name = self._queue.popleft()
            self._queued.discard(name)
            self._in_flight.add(name)
            return name

    def _fetch_loop(self) -> None:
        while True:
            name = self._next_blob()
            if name is None:
                return
            try:
                label, data = self._fetch_one(name)
            except Exception as e:  # all sources failed
                self._blob_failed(name, e)
                continue
            self._blob_done(name, label, data)

    def _fetch_one(self, name: str) -> Tuple[str, bytes]:
        from repro_torch.core.replication import blob_sources
        sources = blob_sources(self.backend, name)
        if len(sources) == 1:
            label, read = sources[0]
            return label, read()
        futs: Dict[Future, str] = {}
        idx = 0

        def submit_next() -> bool:
            nonlocal idx
            if idx >= len(sources):
                return False
            label, read = sources[idx]
            f = self._submit(self._hedge_pool, read)
            if f is None:
                return False
            idx += 1
            futs[f] = label
            return True

        submit_next()
        hedged = False
        errors: List[str] = []
        while futs:
            can_hedge = idx < len(sources)
            done, _ = futures_wait(
                list(futs), timeout=self.hedge_s if can_hedge else None,
                return_when=FIRST_COMPLETED)
            if not done:
                # the preferred copy is slow: race the next one
                hedged = True
                with self._lock:
                    self.stats["hedges"] += 1
                submit_next()
                continue
            for f in done:
                label = futs.pop(f)
                try:
                    data = f.result()
                except Exception as e:
                    errors.append(f"{label}: {e}")
                    continue
                if hedged and label != sources[0][0]:
                    with self._lock:
                        self.stats["hedge_wins"] += 1
                return label, data
            if not futs and not submit_next():
                break
        raise FileNotFoundError(
            f"blob {name}: no source served it ({'; '.join(errors)})")

    def _blob_done(self, name: str, label: str, data: bytes) -> None:
        ready: List[_LeafKey] = []
        with self._lock:
            # a blob whose every owning leaf already resolved (e.g. the
            # leaves failed while this read was in flight) has no one
            # left to decode it: keeping the bytes would leak them until
            # the materializer dies
            if self._blob_refs.get(name, 0) > 0:
                self._blobs[name] = data
            self._in_flight.discard(name)
            sb = self.stats["source_bytes"]
            sb[label] = sb.get(label, 0) + len(data)
            for key in self._blob_waiters.get(name, ()):
                pending = self._leaf_pending.get(key)
                if pending is None:
                    continue
                pending.discard(name)
                if not pending:
                    ready.append(key)
            if not self._queue and not self._in_flight \
                    and self._fetch_end is None:
                self._fetch_end = time.monotonic()
        for key in ready:
            self._submit(self._decode_pool, self._decode_leaf, key)

    def _blob_failed(self, name: str, exc: Exception) -> None:
        err = RestoreError(f"streaming restore: {exc}")
        err.__cause__ = exc
        with self._lock:
            self._in_flight.discard(name)
            keys = [k for k in self._blob_waiters.get(name, ())
                    if self._leaf_pending.pop(k, None) is not None]
            if not self._queue and not self._in_flight \
                    and self._fetch_end is None:
                self._fetch_end = time.monotonic()
        for key in keys:
            self._leaf_failed(key, err)

    # --- decode side ----------------------------------------------------

    def _decode_leaf(self, key: _LeafKey) -> None:
        fut = self._futures[key]
        if fut.done():
            return
        name, path = key
        t0 = time.monotonic()
        try:
            val = _decode_chain_leaf(self.manifests, self._view, name,
                                     path)
        except Exception as e:
            self._leaf_failed(key, e)
            return
        t1 = time.monotonic()
        # account first, then publish: a reader that holds every value
        # finds ``complete`` already true (the reference publishes first,
        # so ``complete`` can lag the last value a reader got)
        self._leaf_resolved(key, busy=t1 - t0, t0=t0, t1=t1)
        fut.set_result(val)

    def _leaf_resolved(self, key: _LeafKey, *, busy: float = 0.0,
                       t0: float = 0.0, t1: float = 0.0) -> None:
        hot = False
        with self._lock:
            self._decode_busy_s += busy
            if busy:
                # decode time spent while blobs were still arriving —
                # the pipeline's whole point, reported as overlap
                fe = self._fetch_end
                if fe is None:
                    self._decode_overlap_s += t1 - t0
                elif t0 < fe:
                    self._decode_overlap_s += fe - t0
            for b in self._leaf_blobs.get(key, ()):
                n = self._blob_refs.get(b, 0) - 1
                if n <= 0:
                    self._blob_refs.pop(b, None)
                    self._blobs.pop(b, None)
                    self._blob_waiters.pop(b, None)
                    # ownerless and never fetched (this leaf failed
                    # before its blobs landed): drop the queue entry so
                    # the fetch workers don't read bytes nobody wants
                    if b in self._queued:
                        self._queue.remove(b)
                        self._queued.discard(b)
                else:
                    self._blob_refs[b] = n
            if not self._queue and not self._in_flight \
                    and self._fetch_end is None:
                self._fetch_end = time.monotonic()
            self._leaf_pending.pop(key, None)
            self._leaves_left -= 1
            done = self._leaves_left == 0
            if key in self._hot_set:
                self._hot_left -= 1
                if self._hot_left == 0 and self._hot_ready_s is None:
                    # first writer wins; hot_result()'s fallback (for a
                    # hot tier that was empty at plan time) takes the
                    # same lock and honours the same None check
                    self._hot_ready_s = time.monotonic() - self._t0
                    hot = True
        if hot:
            self._hot_done.set()
        if done:
            self._shutdown_pools()

    def _leaf_failed(self, key: _LeafKey, exc: Exception) -> None:
        fut = self._futures[key]
        self._leaf_resolved(key)
        if not fut.done():
            fut.set_exception(exc)

    # --- page-in surface ------------------------------------------------

    def _promote(self, key: _LeafKey) -> None:
        """Move a faulted leaf's not-yet-fetched blobs to the front of
        the queue so the toucher waits on the shortest possible path."""
        with self._lock:
            pending = self._leaf_pending.get(key)
            if not pending:
                return
            head = [b for b in self._queue if b in pending]
            if not head:
                return
            for b in head:
                self._queue.remove(b)
            self._queue.extendleft(reversed(head))

    def leaf_ready(self, name: str, path: str) -> bool:
        return self._futures[(name, path)].done()

    def leaf_value(self, name: str, path: str) -> np.ndarray:
        fut = self._futures[(name, path)]
        if not fut.done():
            with self._lock:
                self.stats["lazy_faults"] += 1
            self._promote((name, path))
        return fut.result()

    def wait_entry(self, name: str) -> None:
        keys = [k for k in self._futures if k[0] == name]
        for k in keys:
            self._promote(k)
        for k in keys:
            self._futures[k].result()

    def wait_hot(self) -> None:
        self._hot_done.wait()
        for k in self._hot_keys:
            self._futures[k].result()   # surface a hot-tier failure

    def wait_all(self) -> None:
        for fut in self._futures.values():
            fut.result()

    @property
    def complete(self) -> bool:
        with self._lock:
            return self._leaves_left == 0

    # --- results --------------------------------------------------------

    def hot_result(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(manifest, entries) as soon as the hot tier is decoded: hot
        entries as plain dicts, cold entries as ``LazyLeaves`` still
        streaming behind them. Same key set as the eager materializer,
        including leafless entries (e.g. an empty request queue)."""
        self.wait_hot()
        with self._lock:
            if self._hot_ready_s is None:   # empty hot tier: first
                self._hot_ready_s = time.monotonic() - self._t0
        entries: Dict[str, Any] = {}
        for name, path in self._hot_keys:
            entries.setdefault(name, {})[path] = \
                self._futures[(name, path)].result()
        cold_paths: Dict[str, List[str]] = {}
        for name, path in self._cold_keys:
            cold_paths.setdefault(name, []).append(path)
        for name, paths in cold_paths.items():
            entries[name] = LazyLeaves(name, paths, self)
        # leafless entries (e.g. an empty request queue) stay present,
        # exactly as the eager materializer keeps them
        for name in self.final["entries"]:
            if name not in self._skip:
                entries.setdefault(name, {})
        return self.final, entries

    def timings(self) -> Dict[str, Any]:
        """Per-phase restore counters for ``Incarnation.timings``."""
        now = time.monotonic()
        t0 = self._t0 or now
        fetch_s = (self._fetch_end or now) - t0
        with self._lock:
            src = dict(self.stats["source_bytes"])
            busy = self._decode_busy_s
            overlap = self._decode_overlap_s
            out: Dict[str, Any] = {
                "fetch_s": fetch_s,
                "decode_busy_s": busy,
                "decode_overlap_pct":
                    100.0 * overlap / busy if busy > 0 else 0.0,
                "lazy_faults": self.stats["lazy_faults"],
                "hedges": self.stats["hedges"],
                "hedge_wins": self.stats["hedge_wins"],
                "hot_leaves": self.stats["hot_leaves"],
                "cold_leaves": self.stats["cold_leaves"],
            }
            if self._hot_ready_s is not None:
                out["hot_ready_s"] = self._hot_ready_s
        out["fetch_bytes_per_source"] = src
        if fetch_s > 0:
            out["fetch_mb_s_per_source"] = {
                k: v / fetch_s / 1e6 for k, v in src.items()}
        return out


def materialize_streaming(
    backend: CheckpointBackend, step: int, *,
    workers: Optional[int] = None, skip_entries=(),
    lazy_kinds=DEFAULT_LAZY_KINDS, hedge_s: float = DEFAULT_HEDGE_S,
) -> Tuple[Dict[str, Any], Dict[str, Any], StreamingMaterializer]:
    """Streaming counterpart of ``materialize_manifest_chain``: returns
    as soon as the hot tier is decoded, with cold entries as
    ``LazyLeaves`` still streaming, plus the materializer for stats and
    explicit waits. Bit-identical to the eager path — the decode code is
    the same function over the same bytes; only the schedule differs."""
    sm = StreamingMaterializer(
        backend, step, skip_entries=skip_entries, lazy_kinds=lazy_kinds,
        fetch_workers=workers, decode_workers=workers, hedge_s=hedge_s)
    sm.start()
    manifest, entries = sm.hot_result()
    return manifest, entries, sm
