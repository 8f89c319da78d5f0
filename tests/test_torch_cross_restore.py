"""Cross-package restore: the strongest check of the port against the
reference. A snapshot chain written by ``repro_torch`` is materialized
by the JAX package's ``CheckpointManager`` into the same host bytes as
the port's own restore (and the engine's live state at the snapshot),
and a chain written by the JAX engine restores under ``repro_torch`` to
identical bytes — same manifest format 3, leaf paths and dtype strings.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax

from repro.configs import get_smoke_config
from repro.core import delta as jdelta
from repro.core.backends.localfs import LocalFSBackend as JBackend
from repro.core.checkpoint import CheckpointManager as JManager
from repro.models import model as JM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import convert
from repro_torch.api import CheckpointSession, Policy
from repro_torch.core.backends.localfs import LocalFSBackend
from repro_torch.core import delta as tdelta
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.serving.engine import Request, ServingEngine

ARCH = "phi4-mini-3.8b-smoke"
CHUNK, MIN = 1024, 2048      # small sparse chunks: the smoke cache is tiny


def _prompts():
    rng = np.random.RandomState(9)
    return [rng.randint(0, 256, size=rng.randint(3, 14)).astype(np.int32)
            for _ in range(5)]


def _bytes(v) -> bytes:
    return np.ascontiguousarray(np.asarray(v)).tobytes()


def _assert_same_entries(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        assert sorted(a[name]) == sorted(b[name]), name
        for path in a[name]:
            x, y = a[name][path], b[name][path]
            assert tuple(np.shape(x)) == tuple(np.shape(y)), (name, path)
            assert _bytes(x) == _bytes(y), (name, path)


def _jax_params():
    cfg = get_smoke_config("phi4-mini-3.8b")
    return jax.tree.map(np.asarray,
                        JM.init_params(cfg, jax.random.PRNGKey(0)))


def test_port_chain_restores_bit_identically_under_jax(tmp_path):
    params = convert.params_from_numpy(_jax_params(), "cpu")
    policy = Policy(interval=3, chain=4, sparse_chunk_bytes=CHUNK,
                    sparse_min_bytes=MIN)
    sess = CheckpointSession(f"localfs:{tmp_path}", policy)
    eng = ServingEngine.create(ARCH, params, n_slots=2, max_seq=48,
                               manager=sess.manager, device="cpu")
    sess.attach(eng)
    for i, p in enumerate(_prompts()):
        eng.submit(Request(rid=i, prompt=p, max_new=8))
    live = {}
    for _ in range(12):
        eng.step()
        if sess.maybe_snapshot() is not None:
            live[eng.steps] = convert.tree_to_numpy(eng.cache)
    sess.close()
    steps = JBackend(str(tmp_path)).list_steps()
    assert steps == [3, 6, 9, 12]
    formats = [JBackend(str(tmp_path)).get_manifest(s)["format"]
               for s in steps]
    assert formats == [2, 3, 3, 3]      # a base, then sparse links
    jm = JManager(JBackend(str(tmp_path)))
    tm = CheckpointManager(LocalFSBackend(str(tmp_path)))
    for step in steps:
        jr = jm.restore(step)
        tr = tm.restore(step)
        _assert_same_entries(jr.entries, tr.entries)
        assert jr.manifest == tr.manifest
        for name, want in live[step].items():
            path = f"[{name!r}]"
            assert _bytes(jr.entries["kv_cache"][path]) == _bytes(want)
    for m in (jm, tm):
        m.close()


def test_jax_chain_restores_bit_identically_under_the_port(tmp_path):
    jparams = JM.init_params(get_smoke_config("phi4-mini-3.8b"),
                             jax.random.PRNGKey(0))
    jm = JManager(JBackend(str(tmp_path)), async_save=False,
                  delta_base_interval=4, sparse_chunk_bytes=CHUNK,
                  sparse_min_bytes=MIN)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    jeng = JEngine(get_smoke_config("phi4-mini-3.8b"), jparams, mesh,
                   n_slots=2, max_seq=48, manager=jm, arch=ARCH)
    for i, p in enumerate(_prompts()):
        jeng.submit(JRequest(rid=i, prompt=p, max_new=8))
    for _ in range(12):
        jeng.step()
        if jeng.steps % 3 == 0:
            jeng.snapshot()
    jm.wait()
    steps = jm.backend.list_steps()
    assert steps == [3, 6, 9, 12]
    tm = CheckpointManager(LocalFSBackend(str(tmp_path)))
    for step in steps:
        _assert_same_entries(tm.restore(step).entries,
                             jm.restore(step).entries)

    # and the port's engine comes back from the JAX engine's checkpoint
    # with the same cache bytes and the same sessions
    eng = CheckpointSession(f"localfs:{tmp_path}").restore(
        "latest", params=convert.params_from_numpy(
            jax.tree.map(np.asarray, jparams), "cpu"), device="cpu")
    want = jm.restore(12).entries["kv_cache"]
    got = convert.tree_to_numpy(eng.cache)
    for name in ("k", "v", "pos"):
        assert _bytes(got[name]) == _bytes(want[f"[{name!r}]"])
    assert eng.steps == jeng.steps
    np.testing.assert_array_equal(eng.slot_pos, jeng.slot_pos)
    np.testing.assert_array_equal(eng.slot_tok, jeng.slot_tok)
    assert [(r.rid, r.out) for r in eng.live_requests()] == \
        [(r.rid, r.out) for r in jeng.live_requests()]
    for m in (jm, tm):
        m.close()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int32",
                                   "float32-int8", "float16-int8"])
def test_single_leaf_formats_agree(tmp_path, dtype):
    """One leaf per dtype through both packages' delta codecs: the same
    blobs, the same manifest meta; ``-int8`` leaves under the int8
    codec, which the port decodes to a coded leaf reading as the JAX
    package's decode."""
    rng = np.random.RandomState(1)
    base = rng.randn(3, 1000).astype(np.float32)
    dtype, _, codec = dtype.partition("-")
    codec = codec or None
    if dtype == "bfloat16":
        a = base.astype(ml_dtypes.bfloat16)
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        a = base.astype(dtype) if dtype != "int32" else \
            (base * 1000).astype(np.int32)
        t = torch.from_numpy(a.copy())
    blobs_j, blobs_t = {}, {}
    mj = jdelta.encode_leaf(a, blobs_j.__setitem__, blobs_j.__contains__,
                            codec=codec)
    mt = tdelta.encode_leaf(t, blobs_t.__setitem__, blobs_t.__contains__,
                            codec=codec)
    assert mj == mt and blobs_j == blobs_t
    assert mt["mode"] == ("codec" if codec else "full")
    back = tdelta.decode_leaf(mj, blobs_j.__getitem__)
    want = jdelta.decode_leaf(mj, blobs_j.__getitem__) if codec else a
    assert _bytes(back) == _bytes(want)
