"""The port's snapshot encode spread over a pack pool writes exactly what
the one-thread encode writes.

The same state is saved twice, once with ``encode_workers()`` at 1 (the
chunks packed on the encode thread itself) and once at 4 (probe,
compression and hash on the pack pool, dedup and queueing back on the
encode thread in chunk order). Both runs must leave the same manifests,
the same blob files with the same bytes, and the same ``bytes_written``
and ``bytes_encoded``: for dense leaves (raw, compressible, repeated
chunks), a dense XOR chain link, a sparse (dirty-chunk) chain link, an
``int8`` codec leaf, and the ``localfs:``, ``sharded:`` and ``cached:``
stores. The chunk size is cut to 64 KiB so a small state spans many
chunks (one case keeps the real 4 MiB).
"""
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch.api.registry import resolve_backend
from repro_torch.core import async_snapshot
from repro_torch.core import delta as deltamod
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.oplog import OpLog
from repro_torch.core.split_state import UpperHalf

SMALL_CHUNK = 64 * 1024
PACK = deltamod.pack_chunk


def _params(seed):
    """Leaves whose chunks take every path of the pack step: float noise
    (stays raw), zeros and a repeating pattern (deflate), a bf16 tensor,
    and chunks repeated inside a leaf and across leaves (deduped)."""
    rng = np.random.RandomState(seed)
    noise = rng.randn(300_000).astype(np.float32)
    tile = rng.randn(SMALL_CHUNK // 4).astype(np.float32)
    return {
        "noise": noise,
        "zeros": np.zeros(70_000, np.float32),
        "pattern": np.tile(np.arange(64, dtype=np.float32), 4_000),
        "repeat": np.concatenate([tile] * 5 + [noise[:1000]]),
        "again": np.concatenate([tile] * 2),
        "bf16": torch.from_numpy(rng.randn(90_000).astype(np.float32))
        .to(torch.bfloat16),
        "small": rng.randn(17).astype(np.float32),
    }


def _moments(seed):
    rng = np.random.RandomState(100)
    mu = rng.randn(200_000).astype(np.float32) * 1e-3
    mu[:50 * seed] += 1e-3                    # the next step moves a few
    return {"mu": mu,
            "nu": np.abs(rng.randn(200_000)).astype(np.float32) * 1e-6}


def _upper(step, params, moments):
    up = UpperHalf()
    up.register("params", "params", params)
    up.register("opt_state", "opt_state", moments)
    up.register("step", "step", np.int64(step))
    return up


def _advance(params, seed):
    """The next step's state: a few chunks of two leaves change."""
    rng = np.random.RandomState(seed)
    out = dict(params)
    noise = params["noise"].copy()
    noise[5_000:5_100] += rng.randn(100).astype(np.float32)
    noise[250_000:250_010] = 0.0
    out["noise"] = noise
    pattern = params["pattern"].copy()
    pattern[-3:] = 7.0
    out["pattern"] = pattern
    return out


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _save_run(tmp_path, monkeypatch, workers, store, *, codecs=None,
              chain=1, sparse=True):
    """Two snapshots (steps 1 and 2) of the same states through a fresh
    manager whose pack pool has ``workers`` threads; returns (manifests,
    files under the store's root, stats, pack-step thread names)."""
    monkeypatch.setattr(async_snapshot, "encode_workers", lambda: workers)
    threads = set()

    def traced(chunk, compress):
        threads.add(threading.current_thread().name)
        return PACK(chunk, compress)

    monkeypatch.setattr(deltamod, "pack_chunk", traced)
    root = tmp_path / f"w{workers}"
    spec = store.format(root=root)
    mgr = CheckpointManager(
        resolve_backend(spec), codec_by_kind=codecs,
        delta_base_interval=chain, sparse_capture=sparse,
        sparse_chunk_bytes=8192, sparse_min_bytes=16384)
    params = _params(0)
    mgr.save(1, _upper(1, params, _moments(0)), OpLog(), block=True)
    mgr.save(2, _upper(2, _advance(params, 1), _moments(1)), OpLog(),
             block=True)
    manifests = {s: mgr.backend.get_manifest(s) for s in (1, 2)}
    stats = dict(mgr.stats)
    mgr.close()
    return manifests, _files(root), stats, threads


STORES = {"localfs": "localfs:{root}",
          "sharded": "sharded:{root}?hosts=4&replicate=1",
          "cached": "cached:{root}/cache?over=localfs:{root}/inner"}
CASES = {
    # two full snapshots: raw, deflated and deduped chunks
    "dense": dict(chain=1),
    # a base and a dense XOR link (no dirty-chunk capture)
    "xor": dict(chain=4, sparse=False),
    # a base and a sparse (dirty-chunk) link
    "sparse": dict(chain=4, sparse=True),
    # the optimizer moments under the int8 codec
    "int8": dict(chain=1, codecs={"opt_state": "int8"}),
}


@pytest.mark.parametrize("store", sorted(STORES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_pool_writes_what_one_thread_writes(tmp_path, monkeypatch,
                                                 store, case):
    monkeypatch.setattr(deltamod, "CHUNK_BYTES", SMALL_CHUNK)
    kw = CASES[case]
    one = _save_run(tmp_path, monkeypatch, 1, STORES[store], **kw)
    many = _save_run(tmp_path, monkeypatch, 4, STORES[store], **kw)
    assert many[0] == one[0]
    assert many[1] == one[1] and len(one[1]) > 10
    for key in ("bytes_written", "bytes_encoded", "bytes_logical",
                "chain_links", "sparse_leaves"):
        assert many[2][key] == one[2][key], key
    assert one[2]["bytes_written"] > 0
    # the pool really packed: one thread each time, four threads the
    # second time, none of them the encode thread
    assert one[3] == {"snap-encode_0"}
    assert len(many[3]) > 1 and all(n.startswith("snap-pack")
                                    for n in many[3])
    leaves = many[0][2]["entries"]["params"]["leaves"]
    modes = {m.get("mode") for m in leaves.values()}
    want = {"dense": {"full"}, "int8": {"full"}, "xor": {"xor"},
            "sparse": {"xor"}}[case]
    assert want <= modes
    if case == "sparse":
        assert any("dirty" in m["parts"]["raw"] for m in leaves.values())
    if case == "int8":
        mom = many[0][1]["entries"]["opt_state"]["leaves"]
        assert {m["mode"] for m in mom.values()} == {"codec"}
    encs = {e for m in leaves.values() for p in m["parts"].values()
            for e in p.get("enc", [])}
    if case == "dense":
        assert encs == {"raw", "zlib"}


def test_pack_pool_at_the_real_chunk_size(tmp_path, monkeypatch):
    """At the shipped 4 MiB chunks: a leaf of 2.5 chunks of noise and one
    of zeros, the same manifests, blobs and counts either way."""
    rng = np.random.RandomState(9)
    n = deltamod.CHUNK_BYTES * 5 // 8
    state = {"noise": rng.randn(n).astype(np.float32),
             "zeros": np.zeros(n, np.float32)}
    runs = []
    for workers in (1, 4):
        monkeypatch.setattr(async_snapshot, "encode_workers",
                            lambda w=workers: w)
        root = tmp_path / f"w{workers}"
        mgr = CheckpointManager(resolve_backend(f"localfs:{root}"))
        up = UpperHalf()
        up.register("params", "params", state)
        mgr.save(3, up, OpLog(), block=True)
        runs.append((mgr.backend.get_manifest(3), _files(root),
                     mgr.stats["bytes_written"]))
        mgr.close()
    assert runs[0] == runs[1]
    chunks = runs[0][0]["entries"]["params"]["leaves"]["['noise']"]["parts"][
        "raw"]["chunks"]
    assert len(chunks) == 3


def test_a_pack_failure_fails_the_snapshot_and_leaves_no_manifest(
        tmp_path, monkeypatch):
    monkeypatch.setattr(deltamod, "CHUNK_BYTES", SMALL_CHUNK)
    monkeypatch.setattr(async_snapshot, "encode_workers", lambda: 4)
    calls = []

    def failing(chunk, compress):
        calls.append(1)
        if len(calls) == 7:
            raise OSError("disk on fire")
        return PACK(chunk, compress)

    monkeypatch.setattr(deltamod, "pack_chunk", failing)
    mgr = CheckpointManager(resolve_backend(f"localfs:{tmp_path / 's'}"))
    with pytest.raises(OSError, match="disk on fire"):
        mgr.save(1, _upper(1, _params(0), _moments(0)), OpLog(), block=True)
    assert mgr.backend.list_steps() == []
    # the pipeline is still usable: the next snapshot commits
    monkeypatch.setattr(deltamod, "pack_chunk", PACK)
    mgr.save(2, _upper(2, _params(0), _moments(0)), OpLog(), block=True)
    assert mgr.backend.list_steps() == [2]
    mgr.close()
