"""The port's streaming restore (``repro_torch.core.streaming``) against
the eager restore and the JAX package's.

Every case of ``tests/test_streaming_restore.py`` runs on the port:
streaming restore is a schedule, not a different restore, so the
pipeline (parallel fetch -> decode-while-fetch -> first-touch cold
leaves) must give the eager materializer's bytes across delta chains;
the hot tier must come back while the cold tier is unreadable; a failed
leaf must neither leak bytes nor keep fetching; the ``workers=`` and
``streaming`` knobs must thread from the session down to the manager;
the ``cached:`` store must serve the second restore from local bytes.

Then what only the port has to show: chains written by either package
restore streamed in the other to the bytes of the writer's eager
restore (float32, bfloat16 and ``int8`` codec leaves); the serving
engine's deferred cache merge gives the eager restore's cache and
tokens, for prefill and for replay admission; and many streaming
materializations with hedging on, in fresh processes, never submit to a
pool that is shut down (the reference's race, ROADMAP C7).
"""
import functools
import glob as globmod
import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import CheckpointManager as JManager
from repro.core import OpLog as JOpLog
from repro.core import UpperHalf as JUpper
from repro.core.backends.localfs import LocalFSBackend as JLocal
from repro.core.backends.sharded import ShardedBackend as JSharded
from repro_torch.api import (CheckpointSession, Policy, PolicyError,
                             UpperHalf, parse_store_spec, register_app_kind,
                             resolve_backend)
from repro_torch.api.errors import RestoreError
from repro_torch.core import delta as deltamod
from repro_torch.core.backends.cached import CachedBackend
from repro_torch.core.backends.localfs import LocalFSBackend
from repro_torch.core.backends.sharded import ShardedBackend
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.oplog import OpLog
from repro_torch.core.streaming import (DEFAULT_HEDGE_S, DEFAULT_LAZY_KINDS,
                                        LazyLeaves, StreamingMaterializer)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _upper(seed=0, n=20_000):
    rng = np.random.RandomState(seed)
    up = UpperHalf()
    up.register("params", "params",
                {"w": rng.randn(n).astype(np.float32),
                 "b": rng.randn(128).astype(np.float32)})
    up.register("opt_state", "opt_state",
                {"m": rng.randn(n).astype(np.float32),
                 "v": rng.randn(n).astype(np.float32)})
    up.register("step", "step", np.int64(seed))
    return up


def _save_chain(backend, steps=3, base_interval=4):
    """A delta chain: steps after the base xor-encode against it."""
    mgr = CheckpointManager(backend, async_save=False,
                            delta_base_interval=base_interval)
    rng = np.random.RandomState(42)
    up = _upper(1)
    for s in range(1, steps + 1):
        # perturb a slice so deltas are small but real
        w = up.get("params")["w"]
        w[rng.randint(0, len(w), 64)] += 0.5
        up.register("step", "step", np.int64(s))
        mgr.save(s, up, OpLog())
    return mgr


def _bytes(v) -> bytes:
    return np.ascontiguousarray(np.asarray(v)).tobytes()


def _assert_same_entries(eager, streamed):
    for name, by_path in eager.entries.items():
        got = streamed.entries[name]
        assert set(got) == set(by_path)
        for path, want in by_path.items():
            np.testing.assert_array_equal(np.asarray(got[path]),
                                          np.asarray(want))


def test_defaults_are_the_reference_defaults():
    from repro.core import streaming as jstreaming
    assert DEFAULT_LAZY_KINDS == jstreaming.DEFAULT_LAZY_KINDS
    assert DEFAULT_HEDGE_S == jstreaming.DEFAULT_HEDGE_S


# --- bit-identity ------------------------------------------------------------

@pytest.mark.parametrize("step", [1, 3])
def test_streaming_matches_eager_across_delta_chain(tmp_path, step):
    """Base step and deepest xor step both restore bit-identically
    under the streaming schedule (localfs, chain=3)."""
    be = LocalFSBackend(str(tmp_path))
    mgr = _save_chain(be, steps=3)
    eager = mgr.restore(step)
    streamed = mgr.restore(step, streaming=True)
    assert isinstance(streamed.entries["opt_state"], LazyLeaves)
    assert isinstance(streamed.entries["params"], dict)  # hot: plain
    _assert_same_entries(eager, streamed)
    assert streamed.streamer.complete


def test_complete_once_every_value_is_read(tmp_path):
    """A leaf's accounting finishes before its value is published, so a
    reader holding every value finds the materializer complete (the
    reference publishes first: ``complete`` lagged the last value in
    about 2 restores of 5 of this loop)."""
    mgr = _save_chain(LocalFSBackend(str(tmp_path)), steps=3)
    for _ in range(100):
        streamed = mgr.restore(1, streaming=True)
        for by_path in streamed.entries.values():
            for path in by_path:
                np.asarray(by_path[path])
        assert streamed.streamer.complete


def test_streaming_custom_lazy_kinds(tmp_path):
    """lazy_kinds is a policy, not a hardcode: making params the cold
    tier flips which entries come back as lazy mappings — values
    unchanged either way."""
    be = LocalFSBackend(str(tmp_path))
    mgr = _save_chain(be)
    eager = mgr.restore(3)
    streamed = mgr.restore(3, streaming=True, lazy_kinds=("params",))
    assert isinstance(streamed.entries["params"], LazyLeaves)
    assert isinstance(streamed.entries["opt_state"], dict)
    _assert_same_entries(eager, streamed)


# --- the hot tier does not wait for the cold tier ---------------------------

class _GatedStore:
    """Blocks reads of a chosen blob set until the gate opens — the
    deterministic way to prove the hot tier binds while the cold tier
    is still in flight (no sleeps, no races)."""

    def __init__(self, inner, blocked):
        self._inner = inner
        self._blocked = set(blocked)
        self.gate = threading.Event()

    def get_blob(self, name):
        if name in self._blocked:
            assert self.gate.wait(20), "cold gate never opened"
        return self._inner.get_blob(name)

    def __getattr__(self, attr):
        return getattr(self._inner, attr)


def _entry_blobs(manifest, entry):
    out = set()
    for meta in manifest["entries"][entry]["leaves"].values():
        out |= set(deltamod.leaf_blob_names(meta))
    return out


def test_hot_tier_binds_while_cold_blobs_unreadable(tmp_path):
    be = LocalFSBackend(str(tmp_path))
    _save_chain(be, steps=1)
    m = be.get_manifest(1)
    cold_blobs = _entry_blobs(m, "opt_state") - _entry_blobs(m, "params")
    assert cold_blobs, "opt_state must own blobs for the gate to bite"

    gated = _GatedStore(be, cold_blobs)
    mgr = CheckpointManager(gated, async_save=False)
    t0 = time.monotonic()
    streamed = mgr.restore(1, streaming=True)
    assert time.monotonic() - t0 < 10, "hot tier waited on cold blobs"
    sm = streamed.streamer
    assert not sm.complete
    np.testing.assert_array_equal(
        np.asarray(streamed.entries["step"][""]), np.int64(1))

    cold = streamed.entries["opt_state"]
    assert not cold.ready("['m']")
    gated.gate.set()
    cold.wait()                      # bulk page-in
    sm.wait_all()
    assert sm.complete
    want = CheckpointManager(be, async_save=False).restore(1)
    _assert_same_entries(want, streamed)


def test_first_touch_fault_promotes_and_counts(tmp_path):
    """Indexing a cold leaf before the background fetch reaches it is a
    lazy fault: the value is served (promoted to the front of the fetch
    queue) and the fault is counted in the timings."""
    be = LocalFSBackend(str(tmp_path))
    _save_chain(be, steps=1)
    m = be.get_manifest(1)
    cold_blobs = _entry_blobs(m, "opt_state") - _entry_blobs(m, "params")
    gated = _GatedStore(be, cold_blobs)
    mgr = CheckpointManager(gated, async_save=False)
    streamed = mgr.restore(1, streaming=True)

    got = {}

    def touch():
        got["m"] = np.asarray(streamed.entries["opt_state"]["['m']"])
    t = threading.Thread(target=touch)
    t.start()
    deadline = time.monotonic() + 20
    while streamed.streamer.timings()["lazy_faults"] < 1:
        assert time.monotonic() < deadline, "the touch never faulted"
        time.sleep(0.005)            # the touch is now blocked on fetch
    gated.gate.set()
    t.join(20)
    assert not t.is_alive()
    want = CheckpointManager(be, async_save=False).restore(1)
    np.testing.assert_array_equal(got["m"],
                                  np.asarray(want.entries["opt_state"]
                                             ["['m']"]))
    assert streamed.streamer.timings()["lazy_faults"] >= 1


def test_missing_blob_fails_loudly_not_lazily(tmp_path):
    """A blob no source can serve fails the dependent leaves with a
    RestoreError carrying the cause — never a silent zero tensor."""
    be = LocalFSBackend(str(tmp_path))
    _save_chain(be, steps=1)
    m = be.get_manifest(1)
    victim = sorted(_entry_blobs(m, "params"))[0]
    (be.root / "blobs" / victim[:2] / victim).unlink()
    mgr = CheckpointManager(be, async_save=False)
    with pytest.raises(RestoreError):
        mgr.restore(1, streaming=True)


# --- failure-path accounting -------------------------------------------------
# a failed leaf must not leak bytes or keep fetching blobs nobody wants

def _w_chain_blobs(be):
    """(full blob of params['w'] at step 1, its xor-link blobs at 2)."""
    m1, m2 = be.get_manifest(1), be.get_manifest(2)
    full = deltamod.leaf_blob_names(
        m1["entries"]["params"]["leaves"]["['w']"])[0]
    sibs = set(deltamod.leaf_blob_names(
        m2["entries"]["params"]["leaves"]["['w']"]))
    assert sibs, "the xor link must own blobs for the regression to bite"
    return full, sibs


def _drain(sm):
    """Wait until every leaf resolved (value or error)."""
    for fut in sm._futures.values():
        try:
            fut.result(timeout=20)
        except Exception:
            pass
    deadline = time.monotonic() + 20
    while not sm.complete:
        assert time.monotonic() < deadline, "materializer never drained"
        time.sleep(0.01)


def test_failed_leaf_drops_queued_sibling_blobs(tmp_path):
    """When a leaf fails on one blob, its sibling blobs — owned by that
    leaf alone — must leave the fetch queue, not keep being read into
    bytes no decode will ever consume."""
    be = LocalFSBackend(str(tmp_path))
    _save_chain(be, steps=2)
    w_full, w_sibs = _w_chain_blobs(be)

    reads = []

    class _Failing:
        def get_blob(self, name):
            reads.append(name)
            if name == w_full:
                raise IOError("injected: every source lost this blob")
            return be.get_blob(name)

        def __getattr__(self, attr):
            return getattr(be, attr)

    sm = StreamingMaterializer(_Failing(), 2, fetch_workers=1,
                               decode_workers=1)
    sm.start()
    _drain(sm)
    with pytest.raises(RestoreError):
        sm._futures[("params", "['w']")].result()
    # the single fetch worker walked the queue in order: the xor link
    # sat behind the failed full blob and must have been dropped
    assert not (set(reads) & w_sibs), \
        f"orphaned sibling blobs still fetched: {set(reads) & w_sibs}"
    # every byte buffer found an owner or was freed
    assert not sm._blobs, f"leaked blob bytes: {sorted(sm._blobs)}"
    assert not sm._blob_refs and not sm._queue


def test_inflight_blob_of_failed_leaf_is_not_retained(tmp_path):
    """The in-flight variant: the sibling blob is already being read
    when its only owner fails — the landed bytes must be discarded, not
    stored ownerless in ``_blobs`` forever."""
    be = LocalFSBackend(str(tmp_path))
    _save_chain(be, steps=2)
    w_full, w_sibs = _w_chain_blobs(be)

    fail_gate, sib_gate = threading.Event(), threading.Event()

    class _Gated:
        def get_blob(self, name):
            if name == w_full:
                assert fail_gate.wait(20), "fail gate never opened"
                raise IOError("injected: every source lost this blob")
            if name in w_sibs:
                assert sib_gate.wait(20), "sibling gate never opened"
            return be.get_blob(name)

        def __getattr__(self, attr):
            return getattr(be, attr)

    sm = StreamingMaterializer(_Gated(), 2, fetch_workers=2,
                               decode_workers=1)
    sm.start()
    # one worker is now blocked inside the doomed read, the other holds
    # a sibling blob in flight; fail the leaf first, then land the
    # sibling bytes into a materializer that no longer wants them
    fail_gate.set()
    w_fut = sm._futures[("params", "['w']")]
    deadline = time.monotonic() + 20
    while not w_fut.done():
        assert time.monotonic() < deadline, "leaf never failed"
        time.sleep(0.01)
    sib_gate.set()
    _drain(sm)
    with pytest.raises(RestoreError):
        w_fut.result()
    assert not (w_sibs & set(sm._blobs)), \
        "ownerless sibling bytes retained after the leaf failed"
    assert not sm._blobs and not sm._blob_refs
    # unaffected leaves still decoded from the same pipeline
    want = CheckpointManager(be, async_save=False).restore(2)
    np.testing.assert_array_equal(
        np.asarray(sm._futures[("params", "['b']")].result()),
        np.asarray(want.entries["params"]["['b']"]))


def test_hot_ready_first_writer_wins(tmp_path):
    """``hot_ready_s`` is written once, under the lock: later
    ``hot_result()`` calls and ``timings()`` readers see one stable
    value (decode workers and the empty-hot fallback share the same
    first-writer-wins discipline)."""
    be = LocalFSBackend(str(tmp_path))
    mgr = _save_chain(be, steps=1)
    streamed = mgr.restore(1, streaming=True)
    sm = streamed.streamer
    sm.wait_all()
    t1 = sm.timings()["hot_ready_s"]
    time.sleep(0.02)
    sm.hot_result()                          # fallback must not rewrite
    assert sm.timings()["hot_ready_s"] == t1

    # empty hot tier: every entry is cold, so the value comes from the
    # hot_result fallback — N racing callers must agree on one value
    streamed2 = mgr.restore(1, streaming=True,
                            lazy_kinds=("params", "opt_state", "step"))
    sm2 = streamed2.streamer
    sm2.wait_all()
    seen = set()
    barrier = threading.Barrier(8)

    def racer():
        barrier.wait()
        sm2.hot_result()
        seen.add(sm2.timings()["hot_ready_s"])

    threads = [threading.Thread(target=racer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert len(seen) == 1, f"hot_ready_s rewritten under race: {seen}"


# --- chains written by someone else ------------------------------------------

def test_entry_introduced_mid_chain_matches_eager(tmp_path):
    """An entry that first appears in a non-base link (the writer
    encodes its first appearance as ``full``) streams bit-identically
    to the eager restore — the planner's run-start walk stops at the
    introduction instead of KeyError-ing off the chain's base."""
    be = LocalFSBackend(str(tmp_path))
    mgr = CheckpointManager(be, async_save=False, delta_base_interval=8)
    rng = np.random.RandomState(7)
    up = _upper(1)
    mgr.save(1, up, OpLog())
    up.register("late", "opt_state", {"z": rng.randn(256).astype(np.float32)})
    for s in (2, 3):
        up.get("params")["w"][rng.randint(0, 20_000, 64)] += 0.5
        up.get("late")["z"][rng.randint(0, 256, 16)] += 1.0
        up.register("step", "step", np.int64(s))
        mgr.save(s, up, OpLog())
    m3 = be.get_manifest(3)
    assert m3["entries"]["late"]["leaves"]["['z']"].get("mode") == "xor", \
        "the introduced entry must ride a delta link for the cell to bite"
    eager = mgr.restore(3)
    streamed = mgr.restore(3, streaming=True)
    _assert_same_entries(eager, streamed)


def test_foreign_chain_missing_mid_link_fails_loudly_per_leaf(tmp_path):
    """A chain whose mid manifest lacks an entry a later link xor's
    against (a foreign writer, a hand-damaged store) must not KeyError
    the whole streaming plan before any leaf decodes: planning succeeds,
    unaffected entries restore, and only the broken leaf surfaces a
    RestoreError naming what it needed."""
    be = LocalFSBackend(str(tmp_path))
    mgr = _save_chain(be, steps=3)
    mid = sorted(globmod.glob(str(be.root / "manifests" / "step_*.json")))[1]
    with open(mid) as f:
        m = json.load(f)
    del m["entries"]["opt_state"]
    with open(mid, "w") as f:
        json.dump(m, f)

    # eager: a loud RestoreError (the xor link has no base), not KeyError
    with pytest.raises(RestoreError, match="base-step"):
        mgr.restore(3)

    # streaming: the plan builds, the hot tier restores, only the broken
    # cold entry faults loudly on touch
    streamed = mgr.restore(3, streaming=True)
    want = CheckpointManager(be, async_save=False).restore(
        3, skip_entries=("opt_state",))
    np.testing.assert_array_equal(
        np.asarray(streamed.entries["params"]["['w']"]),
        np.asarray(want.entries["params"]["['w']"]))
    with pytest.raises(RestoreError, match="base-step"):
        np.asarray(streamed.entries["opt_state"]["['m']"])


# --- multi-source fetch ------------------------------------------------------

def test_streaming_fetches_from_multiple_hosts(tmp_path):
    """Against a sharded store the fetcher reads per-placement sources,
    not the backend's serialized get_blob: the per-source byte counters
    show more than one host serving."""
    be = ShardedBackend(str(tmp_path), n_hosts=3, replicate=True)
    mgr = _save_chain(be, steps=2)
    eager = mgr.restore(2)
    streamed = mgr.restore(2, streaming=True)
    _assert_same_entries(eager, streamed)
    served = streamed.streamer.timings()["fetch_bytes_per_source"]
    assert len(served) >= 2, f"single-source fetch: {served}"


# --- workers= threads through the public API --------------------------------

def test_session_threads_workers_and_streaming(tmp_path, monkeypatch):
    import repro_torch.core.checkpoint as ckpt
    seen = {}
    orig = ckpt.CheckpointManager.restore

    def spy(self, *a, **kw):
        seen.update(kw)
        return orig(self, *a, **kw)

    monkeypatch.setattr(ckpt.CheckpointManager, "restore", spy)
    with CheckpointSession(f"localfs:{tmp_path}",
                           Policy(streaming_restore=True)) as sess:
        app = sess.attach(_TinyOpt())
        app.step()
        sess.snapshot(block=True)
        del app
        app2 = sess.restore("latest", workers=3)
    assert seen["workers"] == 3
    assert seen["streaming"] is True      # policy default applied
    assert app2.n == 1
    assert app2.incarnation.stream_timings()["cold_leaves"] == 1

    with CheckpointSession(f"localfs:{tmp_path}", Policy()) as sess:
        seen.clear()
        app3 = sess.restore("latest", decode_workers=2, streaming=False)
        assert app3.n == 1
        assert seen["workers"] == 2       # alias folds into workers
        assert not seen.get("streaming", False)
        assert app3.incarnation.stream_timings() is None
        with pytest.raises(PolicyError, match="same knob"):
            sess.restore("latest", workers=1, decode_workers=4)


class _TinyOpt:
    """Protocol citizen with a cold-tier entry (opt_state)."""
    kind = "torch-tinyopt"

    def __init__(self):
        self.x = np.zeros(8, np.float64)
        self.m = np.zeros(8, np.float64)
        self.n = 0

    def step(self):
        self.x += 1.0
        self.m = 0.9 * self.m + self.x
        self.n += 1

    def checkpoint_state(self):
        up = UpperHalf()
        up.register("x", "params", self.x.copy())
        up.register("opt_state", "opt_state", {"m": self.m.copy()})
        up.register("n", "step", np.int64(self.n))
        return up

    def checkpoint_step(self):
        return self.n

    def job_meta(self):
        return {"kind": self.kind}

    def bind(self, restore):
        self.x = np.asarray(restore.tree("x"), np.float64).copy()
        self.m = np.asarray(restore.tree("opt_state")["m"],
                            np.float64).copy()
        self.n = int(restore.scalar("n"))
        self.incarnation = restore.incarnation()
        restore.release()


@register_app_kind("torch-tinyopt", replace=True)
def _restore_tinyopt(restore):
    app = _TinyOpt()
    app.bind(restore)
    return app


def test_policy_validation():
    p = Policy(streaming_restore=True, lazy_kinds=["cache"])
    assert p.lazy_kinds == ("cache",)     # coerced to tuple
    with pytest.raises(PolicyError, match="streaming_restore"):
        Policy(lazy_kinds=("opt_state",))
    with pytest.raises(PolicyError):
        Policy(streaming_restore=True, lazy_kinds="opt_state")


# --- the cached: tier --------------------------------------------------------

def test_parse_store_spec_nested_over():
    scheme, path, params = parse_store_spec(
        "cached:/ssd/cache?over=sharded:/remote?hosts=4&replicate=1")
    assert (scheme, path) == ("cached", "/ssd/cache")
    # everything after over= belongs to the inner spec, verbatim
    assert params == {"over": "sharded:/remote?hosts=4&replicate=1"}


def test_cached_needs_over():
    with pytest.raises(PolicyError, match="cached"):
        resolve_backend("cached:/tmp/nowhere")


def test_cached_warms_then_serves_locally(tmp_path):
    """First restore reads through (misses, warms); second restore is
    served from the cache — the inner store sees no blob reads."""
    remote = tmp_path / "remote"
    cache = tmp_path / "cache"
    _save_chain(LocalFSBackend(str(remote)), steps=1)

    spec = f"cached:{cache}?over=localfs:{remote}"
    cb = resolve_backend(spec)
    assert isinstance(cb, CachedBackend)
    mgr = CheckpointManager(cb, async_save=False)
    first = mgr.restore(1, streaming=True)
    first.streamer.wait_all()        # cold tier warmed too
    assert cb.stats["warmed"] > 0 and cb.stats["hits"] == 0

    class _Dead:
        def get_blob(self, name):
            raise AssertionError(f"cache miss leaked to remote: {name}")

        def __getattr__(self, attr):
            return getattr(cb.inner, attr)

    cb2 = CachedBackend(str(cache), _Dead())
    second = CheckpointManager(cb2, async_save=False).restore(
        1, streaming=True)
    _assert_same_entries(first, second)
    assert cb2.stats["hits"] > 0 and cb2.stats["misses"] == 0
    served = second.streamer.timings()["fetch_bytes_per_source"]
    assert set(served) == {"cache"}


def test_cached_writes_through(tmp_path):
    """Snapshots taken through the cached front land durably in the
    inner store (cache loss must never lose data); the inner store alone
    serves the streamed restore."""
    spec = (f"cached:{tmp_path / 'c'}?over=sharded:{tmp_path / 'r'}"
            "?hosts=2&replicate=1")
    cb = resolve_backend(spec)
    mgr = CheckpointManager(cb, async_save=False)
    mgr.save(1, _upper(9), OpLog())
    inner_only = CheckpointManager(cb.inner, async_save=False)
    got = inner_only.restore(1, streaming=True)
    np.testing.assert_array_equal(
        np.asarray(got.entries["step"][""]), np.int64(9))
    _assert_same_entries(inner_only.restore(1), got)


# --- across packages -----------------------------------------------------------

_SIZES = dict(w=30_000, h=5_000, m=12_000)


def _mixed_state(seed, upper_cls, bf16):
    """params: an f32 and a bfloat16 leaf; opt_state: f32 moments (int8
    under the codec); a step scalar. ``bf16`` turns a float32 array into
    the package's bfloat16 leaf."""
    rng = np.random.RandomState(seed)
    up = upper_cls()
    up.register("params", "params", {
        "w": rng.randn(_SIZES["w"]).astype(np.float32),
        "h": bf16(rng.randn(_SIZES["h"]).astype(np.float32))})
    up.register("opt_state", "opt_state", {
        "m": rng.randn(_SIZES["m"]).astype(np.float32),
        "v": np.abs(rng.randn(_SIZES["m"])).astype(np.float32) * 1e-3})
    up.register("step", "step", np.int64(seed))
    return up


def _j_bf16(a):
    return a.astype(ml_dtypes.bfloat16)


def _t_bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _perturb(up, rng, bf16):
    p = up.get("params")
    p["w"][rng.randint(0, _SIZES["w"], 64)] += 0.5
    h = np.asarray(p["h"].float().numpy() if isinstance(p["h"], torch.Tensor)
                   else p["h"].astype(np.float32))
    h[rng.randint(0, _SIZES["h"], 16)] += 1.0
    p["h"] = bf16(h)
    up.get("opt_state")["m"][rng.randint(0, _SIZES["m"], 32)] -= 0.25


def _write_chain(mgr, upper_cls, bf16, oplog):
    rng = np.random.RandomState(5)
    up = _mixed_state(3, upper_cls, bf16)
    for s in (1, 2, 3):
        _perturb(up, rng, bf16)
        up.register("step", "step", np.int64(s))
        mgr.save(s, up, oplog)
    mgr.wait()


def _same_bytes(want, got):
    assert sorted(want) == sorted(got)
    for name in want:
        assert sorted(want[name]) == sorted(got[name]), name
        for path in want[name]:
            x, y = want[name][path], got[name][path]
            assert tuple(np.shape(x)) == tuple(np.shape(y)), (name, path)
            assert _bytes(x) == _bytes(y), (name, path)


_STORES = {
    "localfs": (lambda d: JLocal(d), lambda d: LocalFSBackend(d)),
    "sharded": (lambda d: JSharded(d, n_hosts=3, replicate=True),
                lambda d: ShardedBackend(d, n_hosts=3, replicate=True)),
}


@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("store", sorted(_STORES))
def test_jax_chain_streams_under_the_port(tmp_path, store, codec):
    """A delta chain written by the JAX package restores streamed in the
    port to the bytes of the JAX package's eager restore — at the base
    and at the deepest link; an int8 codec leaf arrives coded and reads
    as the host decode."""
    j_be, t_be = _STORES[store]
    codecs = {"opt_state": codec} if codec else None
    jm = JManager(j_be(str(tmp_path)), async_save=False,
                  delta_base_interval=4, codec_by_kind=codecs)
    _write_chain(jm, JUpper, _j_bf16, JOpLog())
    tm = CheckpointManager(t_be(str(tmp_path)), async_save=False)
    for step in (1, 3):
        want = jm.restore(step).entries
        streamed = tm.restore(step, streaming=True)
        assert isinstance(streamed.entries["opt_state"], LazyLeaves)
        if codec:
            assert isinstance(streamed.entries["opt_state"]["['m']"],
                              deltamod.Int8Leaf)
        _same_bytes(want, streamed.entries)
        _same_bytes(tm.restore(step).entries, streamed.entries)
        assert streamed.streamer.complete
    jm.close()


@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("store", sorted(_STORES))
def test_port_chain_streams_under_jax(tmp_path, store, codec):
    """The other way round: a port-written chain under the JAX package's
    streaming restore gives the bytes of the port's eager restore."""
    j_be, t_be = _STORES[store]
    codecs = {"opt_state": codec} if codec else None
    tm = CheckpointManager(t_be(str(tmp_path)), async_save=False,
                           delta_base_interval=4, codec_by_kind=codecs)
    _write_chain(tm, UpperHalf, _t_bf16, OpLog())
    jm = JManager(j_be(str(tmp_path)), async_save=False)
    for step in (1, 3):
        want = tm.restore(step).entries
        # one fetch worker: with more, the JAX package's start() can
        # submit a fetch loop to a pool its own decode worker has just
        # shut down (ROADMAP C7; the port's start() holds the lock)
        streamed = jm.restore(step, workers=1, streaming=True)
        _same_bytes(want, streamed.entries)
        streamed.streamer.wait_all()
    tm.close()


# --- the serving engine's deferred cache merge --------------------------------

_SERVE = {
    # arch family: prefill admission (attention) and replay admission
    "phi4-mini-3.8b-smoke": "prefill",
    "mamba2-780m-smoke": "replay",
}


@functools.lru_cache(maxsize=None)
def _serve_params(arch):
    from repro_torch.configs import resolve_config
    from repro_torch.models import model as M
    return M.init_params(resolve_config(arch), seed=2, device="cpu")


def _serve_requests(vocab):
    from repro_torch.serving.engine import Request
    rng = np.random.RandomState(4)
    # budgets that free a slot at the snapshot step while the queue still
    # holds a request: the first step after restore admits into the free
    # slot while the checkpointed cache is still pending
    return [Request(rid=i, prompt=rng.randint(0, vocab, size=n)
                    .astype(np.int32), max_new=b)
            for i, (n, b) in enumerate([(5, 3), (7, 9), (4, 6), (6, 5)])]


def _cache_bytes(eng):
    from repro_torch.tree import flatten_with_paths
    return {p: _tensor_bytes(t) for p, t in flatten_with_paths(eng.cache)}


def _tensor_bytes(t) -> bytes:
    return t.detach().contiguous().reshape(-1).view(torch.uint8) \
        .numpy().tobytes()


@pytest.mark.parametrize("arch", sorted(_SERVE))
def test_engine_streamed_restore_matches_eager(tmp_path, arch):
    """Restore the same serving step eagerly and streamed: the streamed
    engine admits the queued request into the free slot while its cache
    is still the cold tier, lands the restored bytes around that slot
    (``_ensure_cache``), and then holds the eager engine's cache bytes
    after every step, and its tokens."""
    from repro_torch.configs import resolve_config
    from repro_torch.serving.engine import ServingEngine
    cfg = resolve_config(arch)
    params = _serve_params(arch)
    sess = CheckpointSession(f"localfs:{tmp_path}",
                             Policy(interval=1, chain=3,
                                    sparse_chunk_bytes=1024,
                                    sparse_min_bytes=2048))
    eng = ServingEngine.create(arch, params, n_slots=2, max_seq=32,
                               manager=sess.manager, device="cpu")
    sess.attach(eng)
    for r in _serve_requests(cfg.vocab_size):
        eng.submit(r)
    kill = None
    while kill is None:
        eng.step()
        sess.maybe_snapshot()
        if eng.queue and any(r is None for r in eng.slot_req):
            kill = eng.steps
    sess.wait()
    sess.close()
    del eng

    engines = {}
    for streaming in (False, True):
        s = CheckpointSession(f"localfs:{tmp_path}")
        e = s.restore(kill, params=params, device="cpu",
                      streaming=streaming)
        assert e.steps == kill
        engines[streaming] = (s, e)
    eager, streamed = engines[False][1], engines[True][1]
    assert streamed._pending_cache is not None        # the cold tier
    assert eager._pending_cache is None
    free = [s for s, r in enumerate(streamed.slot_req) if r is None]
    assert free and streamed.queue
    stream = streamed.incarnation.stream_timings()
    assert stream["cold_leaves"] == len(_cache_bytes(streamed))
    steps = 0
    while eager.queue or any(eager.slot_req):
        eager.step()
        streamed.step()
        steps += 1
        if steps == 1:
            assert streamed._pending_cache is None
            assert streamed._touched_slots == set()
        assert _cache_bytes(streamed) == _cache_bytes(eager), steps
    assert not (streamed.queue or any(streamed.slot_req))
    for s, _ in engines.values():
        s.close()


def test_engine_snapshot_lands_a_pending_cache(tmp_path):
    """A snapshot taken right after a streamed restore, before any step,
    captures the restored cache, not the fresh one."""
    from repro_torch.serving.engine import ServingEngine
    arch = "phi4-mini-3.8b-smoke"
    params = _serve_params(arch)
    sess = CheckpointSession(f"localfs:{tmp_path}",
                             Policy(async_save=False))
    eng = ServingEngine.create(arch, params, n_slots=2, max_seq=32,
                               manager=sess.manager, device="cpu")
    sess.attach(eng)
    for r in _serve_requests(256):
        eng.submit(r)
    for _ in range(3):
        eng.step()
    want = _cache_bytes(eng)
    sess.snapshot(block=True)
    sess.close()
    s2 = CheckpointSession(f"localfs:{tmp_path}", Policy(async_save=False))
    e2 = s2.restore("latest", params=params, device="cpu", streaming=True)
    up = e2.session_state()
    assert e2._pending_cache is None
    from repro_torch.tree import flatten_with_paths
    got = {p: _tensor_bytes(t)
           for p, t in flatten_with_paths(up.get("kv_cache"))}
    assert got == want
    s2.close()


# --- no submit after shutdown (ROADMAP C7) --------------------------------------

class _RacingPool:
    """A pool whose every submit first lets another thread run the
    materializer's ``_shutdown_pools`` and waits up to 0.2 s for it: the
    widest possible window between a closed check and its submit."""

    def __init__(self, sm):
        self._sm = sm
        self._pool = ThreadPoolExecutor(max_workers=2)
        self.shutdowns_first = 0
        self.racers = []

    def submit(self, fn, *args):
        racer = threading.Thread(target=self._sm._shutdown_pools)
        self.racers.append(racer)
        racer.start()
        racer.join(0.2)
        self.shutdowns_first += not racer.is_alive()
        return self._pool.submit(fn, *args)

    def shutdown(self, wait=True):
        self._pool.shutdown(wait=wait)


@pytest.mark.parametrize("site", ["start", "hedge", "decode"])
def test_a_submit_cannot_interleave_with_shutdown(tmp_path, monkeypatch,
                                                  site):
    """The submits that raced the pools' shutdown in the reference (the
    fetch loops ``start()`` submits one at a time, a hedge read, a
    leaf's decode) hold the lock that ``_shutdown_pools`` takes: a
    shutdown that arrives mid-submit waits for the submit, so it never
    meets a pool that is already shut down ("cannot schedule new futures
    after shutdown")."""
    be = ShardedBackend(str(tmp_path), n_hosts=3, replicate=True)
    _save_chain(be, steps=1)
    sm = StreamingMaterializer(be, 1, fetch_workers=2, decode_workers=1)
    key = ("params", "['b']")
    racing = _RacingPool(sm)
    if site == "start":
        real = ThreadPoolExecutor

        def pools(max_workers, thread_name_prefix):
            if thread_name_prefix == "stream-fetch":
                return racing
            return real(max_workers=max_workers,
                        thread_name_prefix=thread_name_prefix)
        monkeypatch.setattr(sys.modules[StreamingMaterializer.__module__],
                            "ThreadPoolExecutor", pools)
        sm.start()
        assert len(racing.racers) == 2
    elif site == "hedge":
        sm._started, sm._t0 = True, time.monotonic()
        sm._hedge_pool = racing
        name = sm._leaf_blobs[key][0]
        label, data = sm._fetch_one(name)
        assert data == be.get_blob(name)
    else:
        sm._started, sm._t0 = True, time.monotonic()
        sm._decode_pool = racing
        for b in sm._leaf_blobs[key]:
            sm._blob_done(b, "store", be.get_blob(b))
        want = CheckpointManager(be, async_save=False).restore(1)
        np.testing.assert_array_equal(
            np.asarray(sm._futures[key].result(timeout=20)),
            np.asarray(want.entries["params"]["['b']"]))
    assert racing.shutdowns_first == 0
    for racer in racing.racers:
        racer.join(20)
        assert not racer.is_alive()
    assert sm._closed           # the racing shutdown ran, after the submit
    racing.shutdown()


_C7_SCRIPT = r"""
import os, sys, threading, time
import numpy as np
sys.path.insert(0, sys.argv[1])
from repro_torch.api.errors import RestoreError
from repro_torch.core.backends.sharded import ShardedBackend
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.oplog import OpLog
from repro_torch.core.split_state import UpperHalf
from repro_torch.core.streaming import StreamingMaterializer

root, seed = sys.argv[2], int(sys.argv[3])
rng = np.random.RandomState(seed)
sys.setswitchinterval(1e-6)     # switch threads as often as possible
be = ShardedBackend(root, n_hosts=3, replicate=True)
mgr = CheckpointManager(be, async_save=False, delta_base_interval=8,
                        sparse_capture=False)
up = UpperHalf()
up.register("params", "params", {f"p{i}": rng.randn(3000 + 97 * i)
                                 .astype(np.float32) for i in range(6)})
up.register("opt_state", "opt_state", {f"m{i}": rng.randn(2000 + 31 * i)
                                       .astype(np.float32) for i in range(6)})
for s in (1, 2, 3):
    for v in up.get("params").values():
        v[rng.randint(0, v.size, 8)] += 1.0
    mgr.save(s, up, OpLog())
want = {(n, p): np.asarray(v).tobytes()
        for n, e in mgr.restore(3).entries.items() for p, v in e.items()}


class Jittery:
    # every read sleeps a little, so hedges fire; the first placement of
    # one blob of one leaf always fails, so a leaf can fail while reads
    # and hedges of its siblings are still in flight
    def __init__(self, inner, fail):
        self._inner, self._fail = inner, fail

    def blob_sources(self, name):
        from repro_torch.core.replication import blob_sources
        out = []
        for i, (label, read) in enumerate(blob_sources(self._inner, name)):
            def jitter(read=read, i=i, label=label):
                time.sleep(rng.uniform(0, 0.004))
                if name in self._fail and (i == 0 or rng.rand() < 0.5):
                    raise IOError("injected")
                return read()
            out.append((label, jitter))
        return out

    def __getattr__(self, attr):
        return getattr(self._inner, attr)


errors, bad = [], []
def one(k):
    fail = set(rng.choice(sorted(want_blobs), 2)) if k % 2 else set()
    sm = StreamingMaterializer(Jittery(be, fail), 3, hedge_s=0.0005,
                               fetch_workers=4, decode_workers=2)
    sm.start()
    deadline = time.monotonic() + 60
    for key, fut in sm._futures.items():
        try:
            got = fut.result(timeout=max(0.1, deadline - time.monotonic()))
            if np.asarray(got).tobytes() != want[key]:
                bad.append(key)
        except RestoreError as e:
            if "cannot schedule" in str(e) or not fail:
                errors.append(repr(e))
        except Exception as e:
            errors.append(repr(e))
    while not sm.complete and time.monotonic() < deadline:
        time.sleep(0.005)
    if not sm.complete:
        errors.append("never drained")

want_blobs = set()
from repro_torch.core import delta as D
m3 = [be.get_manifest(s) for s in (1, 2, 3)]
for m in m3:
    for e in m["entries"].values():
        for meta in e["leaves"].values():
            want_blobs |= set(D.leaf_blob_names(meta))
threads = [threading.Thread(target=one, args=(k,)) for k in range(24)]
for t in threads:
    t.start()
for t in threads:
    t.join(120)
print("ERRORS", len(errors), errors[:3], "BAD", len(bad), flush=True)
sys.exit(1 if errors or bad else 0)
"""


def test_concurrent_hedged_materializations_never_submit_after_shutdown(
        tmp_path):
    """Many streaming materializations at once, in fresh processes, with
    hedging on (every read jitters, the hedge fires after 0.5 ms), the
    interpreter switching threads every microsecond, and leaves failing
    while their siblings' reads and hedges are in flight: every leaf
    resolves to the eager bytes or to the injected failure, no error
    says a pool was shut down, and every materializer drains."""
    script = tmp_path / "c7.py"
    script.write_text(_C7_SCRIPT)
    procs = [subprocess.Popen(
        [sys.executable, str(script), os.path.join(REPO, "src"),
         str(tmp_path / f"s{i}"), str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(3)]
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out[-3000:]
        assert "ERRORS 0" in out and "BAD 0" in out, out[-3000:]
