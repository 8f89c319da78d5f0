"""The port's ``sharded:`` and ``cached:`` stores and replica repair
against the JAX package's.

The same blob lands on the same virtual host in both packages (the
FNV-1a placement), the same state saved through either package leaves
the same files, and a checkpoint written by one restores in the other.
Then the JAX package's replication scenarios (``tests/test_replication
.py``) and its ``cached:`` scenarios (``tests/test_streaming_restore
.py``, eagerly and streamed) on the port: repair of a lost host from peer replicas, scan of degraded
and unrecoverable blobs, the commit refused on lost writes, the scan
CLI's JSON and exit codes, read-through and write-through caching.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from repro.core import CheckpointManager as JManager
from repro.core import OpLog as JOpLog
from repro.core import UpperHalf as JUpper
from repro.core import replication as jreplication
from repro.core.backends.sharded import ShardedBackend as JSharded
from repro.core.backends.sharded import _host_of as j_host_of
from repro_torch.api import CheckpointSession, Policy
from repro_torch.api.errors import PolicyError
from repro_torch.api.registry import parse_store_spec, resolve_backend
from repro_torch.core import replication
from repro_torch.core.backends import make_backend
from repro_torch.core.backends.cached import CachedBackend
from repro_torch.core.backends.localfs import LocalFSBackend
from repro_torch.core.backends.sharded import ShardedBackend, _host_of
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.delta import referenced_hashes
from repro_torch.core.incarnation import Incarnation
from repro_torch.core.oplog import OpLog
from repro_torch.core.split_state import UpperHalf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(seed=0, n=60_000):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(n).astype(np.float32),
            "b": rng.randn(256).astype(np.float32)}


def _mk_upper(seed=0, n=60_000, upper_cls=UpperHalf):
    up = upper_cls()
    up.register("params", "params", _state(seed, n))
    up.register("step", "step", np.int64(seed))
    return up


def _census(root, n_hosts):
    """{host: {file name: bytes}} across a sharded store."""
    out = {}
    for h in range(n_hosts):
        d = os.path.join(root, f"host_{h:03d}")
        out[h] = ({p: open(os.path.join(d, p), "rb").read()
                   for p in os.listdir(d)} if os.path.isdir(d) else {})
    return out


# --- the same store in both packages ---------------------------------------

def test_blob_placement_matches_jax():
    rng = np.random.RandomState(3)
    names = ["".join(rng.choice(list("0123456789abcdef"), 40))
             for _ in range(500)] + ["", "a", "replica_x"]
    for n_hosts in (1, 2, 3, 4, 7):
        assert [_host_of(n, n_hosts) for n in names] == \
            [j_host_of(n, n_hosts) for n in names]


@pytest.mark.parametrize("replicate", [False, True])
def test_same_state_writes_the_same_files_as_jax(tmp_path, replicate):
    tm = CheckpointManager(ShardedBackend(str(tmp_path / "t"), n_hosts=3,
                                          replicate=replicate),
                           async_save=False)
    jm = JManager(JSharded(str(tmp_path / "j"), n_hosts=3,
                           replicate=replicate), async_save=False)
    tm.save(1, _mk_upper(1), OpLog())
    jm.save(1, _mk_upper(1, upper_cls=JUpper), JOpLog())
    got, want = _census(tmp_path / "t", 3), _census(tmp_path / "j", 3)
    assert got == want and sum(map(len, got.values())) > 0
    assert tm.backend.get_manifest(1) == jm.backend.get_manifest(1)
    for m in (tm, jm):
        m.close()


def test_sharded_checkpoints_restore_across_packages(tmp_path):
    tm = CheckpointManager(resolve_backend(
        f"sharded:{tmp_path / 't'}?hosts=4&replicate=1"), async_save=False)
    tm.save(2, _mk_upper(2), OpLog())
    jm = JManager(JSharded(str(tmp_path / "j"), n_hosts=4, replicate=True),
                  async_save=False)
    jm.save(3, _mk_upper(3, upper_cls=JUpper), JOpLog())
    from_port = JManager(JSharded(str(tmp_path / "t"), n_hosts=4,
                                  replicate=True)).restore(2)
    from_jax = CheckpointManager(ShardedBackend(
        str(tmp_path / "j"), n_hosts=4, replicate=True)).restore(3)
    for got, seed in ((from_port, 2), (from_jax, 3)):
        for k, v in _state(seed).items():
            np.testing.assert_array_equal(
                np.asarray(got.entries["params"][f"[{k!r}]"]), v)
    for m in (tm, jm):
        m.close()


def test_the_stores_are_accepted_by_spec_and_by_name(tmp_path):
    sharded = resolve_backend(f"sharded:{tmp_path / 's'}?hosts=2"
                              "&replicate=1&writers=2&fsync=0")
    assert isinstance(sharded, ShardedBackend)
    assert (sharded.n_hosts, sharded.replicate, sharded.fsync) == \
        (2, True, False)
    cached = resolve_backend(f"cached:{tmp_path / 'c'}?over=sharded:"
                             f"{tmp_path / 'r'}?hosts=3")
    assert isinstance(cached, CachedBackend)
    assert isinstance(cached.inner, ShardedBackend) \
        and cached.inner.n_hosts == 3
    assert isinstance(make_backend("sharded", str(tmp_path / "m"),
                                   n_hosts=2), ShardedBackend)
    sess = CheckpointSession(f"sharded:{tmp_path / 'p'}?hosts=2",
                             Policy(replicate=True))
    assert sess.backend.replicate
    sess.close()
    for bad in ("hosts=0", "writers=0", "hosts=x"):
        with pytest.raises(PolicyError):
            resolve_backend(f"sharded:{tmp_path / 'b'}?{bad}")
    with pytest.raises(PolicyError, match="replicate"):
        CheckpointSession(f"localfs:{tmp_path / 'l'}",
                          Policy(replicate=True))


# --- repair -----------------------------------------------------------------

def _blob_census(be):
    return {h: set(names) for h, names in
            _census(be.root, be.n_hosts).items()}


def test_repair_rebuilds_lost_host_from_peers(tmp_path):
    be = ShardedBackend(str(tmp_path), n_hosts=4, replicate=True)
    mgr = CheckpointManager(be, async_save=False)
    mgr.save(1, _mk_upper(1), OpLog())
    before = _census(tmp_path, 4)
    lost = 2
    assert before[lost], "host 2 must own something for the test to bite"
    be.fail_host(lost)
    shutil.rmtree(be.root / f"host_{lost:03d}")
    rep = replication.repair(be, host=lost)
    assert rep.restored == len(before[lost])
    assert not rep.unrecoverable
    assert _census(tmp_path, 4) == before
    assert lost not in be._failed_hosts
    assert not replication.scan(be).degraded


def test_repair_then_incarnation_restore(tmp_path):
    be = ShardedBackend(str(tmp_path), n_hosts=3, replicate=True)
    mgr = CheckpointManager(be, async_save=False)
    mgr.save(5, _mk_upper(2), OpLog())
    be.fail_host(0)
    shutil.rmtree(be.root / "host_000")
    replication.repair(be, host=0)
    inc = Incarnation(mgr)
    state = inc.materialize()
    np.testing.assert_array_equal(state.entries["params"]["['w']"],
                                  _state(2)["w"])
    assert int(inc.scalar("step")) == 2


def test_scan_reports_degradation_and_unrecoverable(tmp_path):
    be = ShardedBackend(str(tmp_path), n_hosts=4, replicate=True)
    mgr = CheckpointManager(be, async_save=False)
    mgr.save(1, _mk_upper(3), OpLog())
    assert not replication.scan(be).degraded
    census = _blob_census(be)
    h, name = next((h, n) for h, names in sorted(census.items())
                   for n in sorted(names) if not n.startswith("replica_"))
    (be.root / f"host_{h:03d}" / name).unlink()
    rep = replication.scan(be)
    assert rep.missing_primaries == 1 and not rep.unrecoverable
    # the JAX package's scan of the same store says the same
    jrep = jreplication.scan(JSharded(str(tmp_path), n_hosts=4,
                                      replicate=True))
    assert replication.report_json(rep) == jreplication.report_json(jrep)
    r = (h + 1) % be.n_hosts
    (be.root / f"host_{r:03d}" / f"replica_{name}").unlink()
    rep = replication.repair(be)
    assert rep.unrecoverable == [name]


def test_repair_without_replication_cannot_invent_data(tmp_path):
    be = ShardedBackend(str(tmp_path), n_hosts=3, replicate=False)
    mgr = CheckpointManager(be, async_save=False)
    mgr.save(1, _mk_upper(4), OpLog())
    lost_names = _blob_census(be)[1]
    assert lost_names
    shutil.rmtree(be.root / "host_001")
    rep = replication.repair(be, host=1)
    assert set(rep.unrecoverable) == lost_names
    assert rep.restored == 0


# --- loud commit ------------------------------------------------------------

def test_commit_refuses_manifest_with_lost_writes(tmp_path):
    be = ShardedBackend(str(tmp_path), n_hosts=4, replicate=False)
    mgr = CheckpointManager(be, async_save=False)
    mgr.save(1, _mk_upper(5), OpLog())
    m = be.get_manifest(1)
    name = sorted(referenced_hashes(m))[0]
    shutil.rmtree(be.root / f"host_{_host_of(name, be.n_hosts):03d}")
    with pytest.raises(RuntimeError, match="unservable"):
        be.commit_manifest(2, m)
    assert be.list_steps() == [1]


def test_put_blob_to_down_host_raises(tmp_path):
    be = ShardedBackend(str(tmp_path), n_hosts=2, replicate=False)
    name = "aaaa"
    while _host_of(name, 2) != 1:
        name += "a"
    be.fail_host(1)
    with pytest.raises(IOError, match="host 1 down"):
        be.put_blob(name, b"payload")
    be.heal_host(1)
    be.put_blob(name, b"payload")
    assert be.get_blob(name) == b"payload"


def test_save_through_manager_fails_loudly_on_down_host(tmp_path):
    be = ShardedBackend(str(tmp_path), n_hosts=2, replicate=False)
    mgr = CheckpointManager(be, async_save=False)
    be.fail_host(1)
    with pytest.raises(IOError, match="down"):
        mgr.save(1, _mk_upper(6), OpLog())
    assert be.list_steps() == []


def test_a_replicated_store_reads_around_a_down_host(tmp_path):
    be = ShardedBackend(str(tmp_path), n_hosts=3, replicate=True)
    mgr = CheckpointManager(be, async_save=False)
    mgr.save(1, _mk_upper(7), OpLog())
    be.fail_host(1)
    got = mgr.restore(1)
    np.testing.assert_array_equal(got.entries["params"]["['w']"],
                                  _state(7)["w"])
    sources = replication.blob_sources(
        be, sorted(referenced_hashes(be.get_manifest(1)))[0])
    assert sources and all(label != "host_001" for label, _ in sources)


# --- the scan CLI -----------------------------------------------------------

def test_scan_cli_json_contract(tmp_path, capsys):
    spec = f"sharded:{tmp_path}?hosts=3&replicate=1"
    be = ShardedBackend(str(tmp_path), n_hosts=3, replicate=True)
    mgr = CheckpointManager(be, async_save=False)
    mgr.save(1, _mk_upper(8), OpLog())
    rc = replication.main([spec, "--json"])
    rep = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert set(rep) == {"hosts", "blobs", "missing_primaries",
                        "missing_replicas", "restored", "unrecoverable",
                        "degraded"}
    assert rep["degraded"] is False and rep["blobs"] > 0
    census = _blob_census(be)
    h, name = next((h, n) for h, names in sorted(census.items())
                   for n in sorted(names) if not n.startswith("replica_"))
    (be.root / f"host_{h:03d}" / name).unlink()
    rc = replication.main([spec, "--json"])
    rep = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert rep["degraded"] is True and rep["missing_primaries"] == 1
    assert jreplication.main([spec, "--json"]) == 1    # the JAX CLI agrees
    assert json.loads(capsys.readouterr().out) == rep
    rc = replication.main([spec, "--repair", "--json"])
    rep = json.loads(capsys.readouterr().out)
    assert rc == 0 and rep["restored"] == 1


def test_scan_cli_rejects_non_sharded_store(tmp_path, capsys):
    rc = replication.main([f"localfs:{tmp_path}", "--json"])
    err = capsys.readouterr().err
    assert rc == 2 and "sharded" in err


def test_scan_cli_runs_as_a_module_and_sees_through_cached(tmp_path):
    """``python -m repro_torch.core.replication`` on a ``cached:`` front
    scans the sharded store under it."""
    inner = f"sharded:{tmp_path / 'r'}?hosts=2&replicate=1"
    mgr = CheckpointManager(resolve_backend(inner), async_save=False)
    mgr.save(1, _mk_upper(9), OpLog())
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.replication",
         f"cached:{tmp_path / 'c'}?over={inner}", "--json"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    rep = json.loads(proc.stdout)
    assert rep["hosts"] == 2 and rep["blobs"] > 0 and not rep["degraded"]


# --- the cached: tier -------------------------------------------------------

def test_parse_store_spec_nested_over():
    scheme, path, params = parse_store_spec(
        "cached:/ssd/cache?over=sharded:/remote?hosts=4&replicate=1")
    assert (scheme, path) == ("cached", "/ssd/cache")
    assert params == {"over": "sharded:/remote?hosts=4&replicate=1"}


def test_cached_needs_over():
    with pytest.raises(PolicyError, match="cached"):
        resolve_backend("cached:/tmp/nowhere")


def test_cached_warms_then_serves_locally(tmp_path):
    """The first restore reads through (misses, warms); the second is
    served from the cache alone — the inner store sees no blob reads."""
    remote, cache = tmp_path / "remote", tmp_path / "cache"
    CheckpointManager(LocalFSBackend(str(remote)), async_save=False).save(
        1, _mk_upper(10), OpLog())
    cb = resolve_backend(f"cached:{cache}?over=localfs:{remote}")
    assert isinstance(cb, CachedBackend)
    first = CheckpointManager(cb, async_save=False).restore(1, workers=1)
    assert cb.stats["warmed"] > 0 and cb.stats["hits"] == 0

    class _Dead:
        def get_blob(self, name):
            raise AssertionError(f"cache miss leaked to remote: {name}")

        def __getattr__(self, attr):
            return getattr(cb.inner, attr)

    cb2 = CachedBackend(str(cache), _Dead())
    second = CheckpointManager(cb2, async_save=False).restore(1, workers=1)
    for name, by_path in first.entries.items():
        for path, v in by_path.items():
            np.testing.assert_array_equal(np.asarray(second.entries[name]
                                                     [path]), np.asarray(v))
    assert cb2.stats["hits"] > 0 and cb2.stats["misses"] == 0
    name = sorted(referenced_hashes(cb2.get_manifest(1)))[0]
    labels = [label for label, _ in cb2.blob_sources(name)]
    assert labels == ["cache", "store"]
    assert cb2.blob_sources(name)[0][1]() == cb.get_blob(name)


def test_cached_warms_then_serves_locally_streamed(tmp_path):
    """The same under the streaming restore: the first streamed restore
    warms every blob (the cold tier too), the second is served by the
    cache source alone, with the eager restore's bytes."""
    remote, cache = tmp_path / "remote", tmp_path / "cache"
    up = _mk_upper(10)
    up.register("opt_state", "opt_state", _state(12, 20_000))
    CheckpointManager(LocalFSBackend(str(remote)), async_save=False).save(
        1, up, OpLog())
    cb = resolve_backend(f"cached:{cache}?over=localfs:{remote}")
    first = CheckpointManager(cb, async_save=False).restore(1, streaming=True)
    first.streamer.wait_all()
    assert cb.stats["warmed"] > 0 and cb.stats["hits"] == 0

    class _Dead:
        def get_blob(self, name):
            raise AssertionError(f"cache miss leaked to remote: {name}")

        def __getattr__(self, attr):
            return getattr(cb.inner, attr)

    cb2 = CachedBackend(str(cache), _Dead())
    second = CheckpointManager(cb2, async_save=False).restore(
        1, streaming=True)
    want = CheckpointManager(LocalFSBackend(str(remote))).restore(1)
    for got in (first, second):
        for name, by_path in want.entries.items():
            assert sorted(got.entries[name]) == sorted(by_path)
            for path, v in by_path.items():
                np.testing.assert_array_equal(
                    np.asarray(got.entries[name][path]), np.asarray(v))
    assert cb2.stats["hits"] > 0 and cb2.stats["misses"] == 0
    assert set(second.streamer.timings()["fetch_bytes_per_source"]) == \
        {"cache"}


def test_cached_writes_through_and_streams_from_the_inner_store(tmp_path):
    """A snapshot through the cached front restores streamed from the
    inner store alone, read around a down host of its replicas."""
    spec = (f"cached:{tmp_path / 'c'}?over=sharded:{tmp_path / 'r'}"
            "?hosts=2&replicate=1")
    cb = resolve_backend(spec)
    CheckpointManager(cb, async_save=False).save(1, _mk_upper(11), OpLog())
    cb.inner.fail_host(0)
    got = CheckpointManager(cb.inner, async_save=False).restore(
        1, streaming=True, lazy_kinds=("params",))
    for k, v in _state(11).items():
        np.testing.assert_array_equal(
            np.asarray(got.entries["params"][f"[{k!r}]"]), v)
    assert set(got.streamer.timings()["fetch_bytes_per_source"]) == \
        {"host_001"}


def test_cached_writes_through(tmp_path):
    spec = (f"cached:{tmp_path / 'c'}?over=sharded:{tmp_path / 'r'}"
            "?hosts=2&replicate=1")
    cb = resolve_backend(spec)
    mgr = CheckpointManager(cb, async_save=False)
    mgr.save(1, _mk_upper(11), OpLog())
    inner_only = CheckpointManager(cb.inner, async_save=False)
    got = inner_only.restore(1)
    np.testing.assert_array_equal(np.asarray(got.entries["step"][""]),
                                  np.int64(11))
    labels = [label for label, _ in cb.blob_sources(
        sorted(referenced_hashes(cb.get_manifest(1)))[0])]
    assert labels[0] == "cache" and len(labels) == 3   # + both replicas
    # GC keeps the cache in lockstep with the store
    assert cb.gc_blobs(set()) > 0
    assert not list((tmp_path / "c" / "blobs").glob("*/*"))
