"""The port's serving engine under live-session checkpointing.

* its greedy tokens equal the JAX engine's (smoke model, float32, the
  same params carried across by ``repro_torch.convert``);
* snapshot -> kill -> ``restore("latest")`` continues token-identically,
  with sparse dirty-chunk capture on and with ``sparse=False``, onto the
  same slot count and re-slotted 2 -> 1 and 2 -> 3;
* tensors are mutated in place, so a chained snapshot must see an
  in-place write to a leaf it captured before (the identity skip keys
  on the tensor's version counter, not on the object alone), and a
  capture must copy, so a write right after ``snapshot()`` returns
  cannot reach the checkpoint.

Small sparse chunks (1 KiB, leaves from 2 KiB) make the smoke model's
KV cache take the dirty-chunk path it takes at full size.
"""
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_smoke_config
from repro.models import model as JM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import convert
from repro_torch.api import CheckpointSession, Policy, PolicyError, UpperHalf
from repro_torch.api.registry import register_app_kind
from repro_torch.configs import get_smoke_config as t_smoke_config
from repro_torch.kernels.ckpt_codec import ops
from repro_torch.models import model as TM
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.tree import flatten_with_paths

ARCH = "phi4-mini-3.8b-smoke"
SPARSE = Policy(interval=4, chain=4, sparse_chunk_bytes=1024,
                sparse_min_bytes=2048)
DENSE = Policy(interval=4, chain=4, sparse=False)


@functools.lru_cache(maxsize=None)
def _params():
    cfg = get_smoke_config("phi4-mini-3.8b")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    return convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _prompts(n=5, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=rng.randint(3, 14)).astype(np.int32)
            for _ in range(n)]


def _run(eng, prompts, max_new=6):
    reqs = [Request(rid=i, prompt=p.copy(), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_steps=400)
    return {r.rid: list(r.out) for r in reqs}


def test_greedy_tokens_equal_the_jax_engine():
    jcfg = get_smoke_config("phi4-mini-3.8b").replace(dtype="float32")
    tcfg = t_smoke_config("phi4-mini-3.8b").replace(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    prompts = _prompts(4, seed=5)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    jeng = JEngine(jcfg, jparams, mesh, n_slots=2, max_seq=32)
    jreqs = [JRequest(rid=i, prompt=p.copy(), max_new=6)
             for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_drained(max_steps=400)
    got = _run(ServingEngine(tcfg, tparams, "cpu", n_slots=2, max_seq=32),
               prompts)
    assert got == {r.rid: list(r.out) for r in jreqs}
    assert all(len(v) == 6 for v in got.values())


@pytest.mark.parametrize("policy", [SPARSE, DENSE], ids=["sparse", "dense"])
@pytest.mark.parametrize("new_slots", [2, 1, 3])
def test_kill_restore_continues_token_identically(tmp_path, policy,
                                                  new_slots):
    params = _params()
    prompts = _prompts()
    ref = _run(ServingEngine.create(ARCH, params, n_slots=2, max_seq=48,
                                    device="cpu"), prompts)

    sess = CheckpointSession(f"localfs:{tmp_path}", policy)
    eng = ServingEngine.create(ARCH, params, n_slots=2, max_seq=48,
                               manager=sess.manager, device="cpu")
    sess.attach(eng)
    reqs = [Request(rid=i, prompt=p.copy(), max_new=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    for _ in range(10):
        eng.step()
        sess.maybe_snapshot()
    sess.wait()
    assert eng.queue and any(eng.slot_req), "kill must be mid-flight"
    st = dict(sess.stats)
    assert st["saves"] == 2 and st["chain_links"] == 1
    if policy.sparse:
        assert st["sparse_leaves"] > 0 and st["dirty_chunks"] > 0
    else:
        assert st["sparse_leaves"] == 0
    done = {r.rid: list(r.out) for r in reqs if r.done}
    sess.close()
    del eng, sess                                  # the kill

    sess2 = CheckpointSession(f"localfs:{tmp_path}", policy)
    eng2 = sess2.restore("latest", params=params, device="cpu",
                         n_slots=new_slots)
    assert eng2.n_slots == new_slots and eng2.steps == 8
    assert sess2.backend.get_manifest(8)["format"] == \
        (3 if policy.sparse else 2)
    live = eng2.live_requests()
    assert {r.rid for r in live} | set(done) == set(ref)
    eng2.run_until_drained(max_steps=400)
    got = dict(done)
    got.update({r.rid: list(r.out) for r in live})
    assert got == ref
    sess2.close()


@pytest.mark.parametrize("new_slots", [1, 3])
def test_reslot_carries_each_sessions_cache_column(tmp_path, new_slots):
    """A re-slot restore lands each former in-flight session's
    checkpointed cache column in its new slot (no prefill of its
    history: a prefill's rounding differs from the decode steps' that
    wrote the cache, ROADMAP C23); only a request that never held a slot
    is admitted by prefill."""
    params = _params()
    sess = CheckpointSession(f"localfs:{tmp_path}", DENSE)
    eng = ServingEngine.create(ARCH, params, n_slots=2, max_seq=48,
                               manager=sess.manager, device="cpu")
    sess.attach(eng)
    for i, p in enumerate(_prompts()):
        eng.submit(Request(rid=i, prompt=p.copy(), max_new=6))
    for _ in range(3):
        eng.step()
    sess.snapshot(block=True)
    axes = dict(flatten_with_paths(TM.batch_axes(eng.cfg)))
    cols = {r.rid: {p: t.narrow(axes[p], s, 1).clone()
                    for p, t in flatten_with_paths(eng.cache)}
            for s, r in enumerate(eng.slot_req) if r is not None}
    queued = {r.rid for r in eng.queue}
    sess.close()
    del eng, sess
    prefills = []
    real = ServingEngine._prefill_slot

    def counted(self, s, hist):
        prefills.append(len(hist))
        return real(self, s, hist)
    sess2 = CheckpointSession(f"localfs:{tmp_path}", DENSE)
    with mock.patch.object(ServingEngine, "_prefill_slot", counted):
        eng2 = sess2.restore("latest", params=params, device="cpu",
                             n_slots=new_slots)
    seated = {r.rid: s for s, r in enumerate(eng2.slot_req) if r is not None}
    carried = {rid: s for rid, s in seated.items() if rid in cols}
    assert len(cols) == 2 and len(carried) == min(new_slots, 2)
    assert len(prefills) == len(set(seated) & queued) == max(new_slots - 2, 0)
    for rid, s in carried.items():
        for p, t in flatten_with_paths(eng2.cache):
            assert torch.equal(t.narrow(axes[p], s, 1),
                               cols[rid][p]), (rid, p)
    sess2.close()


def _reslot_onto_one(store):
    """Five requests on 2 slots, snapshotted at step 3 with both slots
    in flight, killed, and restored onto 1 slot: one former in-flight
    session is seated, the other waits in the queue with its carried
    cache column. Returns (the restored engine, its session)."""
    params = _params()
    sess = CheckpointSession(store, SPARSE)
    eng = ServingEngine.create(ARCH, params, n_slots=2, max_seq=48,
                               manager=sess.manager, device="cpu")
    sess.attach(eng)
    for i, p in enumerate(_prompts()):
        eng.submit(Request(rid=i, prompt=p.copy(), max_new=6))
    for _ in range(3):
        eng.step()
    sess.snapshot(block=True)
    sess.close()
    del eng, sess                                  # the kill
    sess2 = CheckpointSession(store, SPARSE)
    eng2 = sess2.restore("latest", params=params, device="cpu", n_slots=1)
    assert len(eng2.live_requests()) == 5
    assert list(eng2._carried) == [eng2.queue[0].rid]
    return eng2, sess2


@pytest.mark.parametrize("streaming", [False, True])
def test_snapshot_after_a_reslot_keeps_the_waiting_columns(tmp_path,
                                                           streaming):
    """Re-slotted 2 -> 1, a former in-flight session waits with its
    carried cache column; a snapshot then holds the column (the
    ``carried`` entry), so after a second kill and a restore, eager or
    streamed, the same bits land when its turn comes (no prefill of its
    history) and every request finishes with the uninterrupted run's
    tokens."""
    store = f"localfs:{tmp_path}"
    ref = _run(ServingEngine.create(ARCH, _params(), n_slots=2, max_seq=48,
                                    device="cpu"), _prompts())
    eng2, sess2 = _reslot_onto_one(store)
    waiting = eng2.queue[0].rid
    col = dict(flatten_with_paths(eng2._carried[waiting]))
    live2 = eng2.live_requests()
    eng2.step()
    assert list(eng2._carried) == [waiting]
    sess2.snapshot(block=True)
    assert "carried" in sess2.backend.get_manifest(eng2.steps)["entries"]
    sess2.close()
    del eng2, sess2                                # the second kill
    sess3 = CheckpointSession(store, SPARSE)
    eng3 = sess3.restore("latest", params=_params(), device="cpu",
                         streaming=streaming)
    assert list(eng3._carried) == [waiting]
    for p, t in flatten_with_paths(eng3._carried[waiting]):
        assert torch.equal(t, col[p]), p
    live3 = eng3.live_requests()
    seen = []
    bind = ServingEngine._bind_slot

    def admitted(self, s, req):
        seen.append((req.rid, req.rid in self._carried))
        return bind(self, s, req)
    with mock.patch.object(ServingEngine, "_bind_slot", admitted):
        eng3.run_until_drained(max_steps=400)
    assert (waiting, True) in seen and eng3._carried == {}
    got = {r.rid: list(r.out) for r in live2 if r.done}
    got.update({r.rid: list(r.out) for r in live3})
    assert got == ref
    sess3.close()


def test_extract_sessions_drops_the_carried_columns_it_takes(tmp_path):
    """A full drain of a re-slotted engine takes the waiting session's
    carried column with it: a later request under the same rid is
    admitted by prefill of its own prompt, never given that column."""
    eng, sess = _reslot_onto_one(f"localfs:{tmp_path}")
    waiting = eng.queue[0].rid
    taken = eng.extract_sessions(include_queue=True)
    assert len(taken) == 5 and eng._carried == {}
    prefills = []
    real = ServingEngine._prefill_slot

    def counted(self, s, hist):
        prefills.append(len(hist))
        return real(self, s, hist)
    prompt = np.arange(7, dtype=np.int32)
    with mock.patch.object(ServingEngine, "_prefill_slot", counted):
        eng.submit(Request(rid=waiting, prompt=prompt, max_new=2))
        eng.step()
    assert prefills == [len(prompt) - 1]
    sess.close()


def test_restore_without_a_card_needs_the_cpu_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine.create(ARCH, _params(), n_slots=1, max_seq=16)
    sess = CheckpointSession(f"localfs:{tmp_path}", DENSE)
    eng = ServingEngine.create(ARCH, _params(), n_slots=1, max_seq=16,
                               manager=sess.manager, device="cpu")
    sess.attach(eng)
    sess.snapshot(block=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sess.restore("latest", params=_params())
    sess.close()


def test_unported_features_name_their_roadmap_item(tmp_path):
    """Migration and supervision (ROADMAP A7) are ported: ``migrate``
    asks for an app, ``supervise`` hands back a supervisor whose restore
    hook takes one device or a ``DeviceMesh`` and refuses several
    devices that are no mesh, naming the process group they need. The
    streaming restore (A4) is ported: ``restore(streaming=True)`` and
    ``Policy(streaming_restore=True)`` bring the engine back with its
    cache as the cold tier."""
    from repro_torch.core.supervisor import restore_mesh
    sess = CheckpointSession(f"localfs:{tmp_path}", DENSE)
    with pytest.raises(PolicyError, match="no app attached"):
        sess.migrate(None)
    assert sess.supervise([0, 1]).world == [0, 1]
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        restore_mesh(["cpu", "cpu"])
    eng = ServingEngine.create(ARCH, _params(), n_slots=1, max_seq=16,
                               manager=sess.manager, device="cpu")
    sess.attach(eng)
    eng.submit(Request(rid=0, prompt=_prompts(1)[0][:4], max_new=3))
    eng.step()
    sess.snapshot(block=True)
    sess.close()
    for sess2, kw in (
            (CheckpointSession(f"localfs:{tmp_path}", DENSE),
             {"streaming": True}),
            (CheckpointSession(f"localfs:{tmp_path}",
                               Policy(streaming_restore=True)), {})):
        eng2 = sess2.restore("latest", params=_params(), device="cpu", **kw)
        assert eng2.steps == 1
        assert eng2.incarnation.stream_timings()["cold_leaves"] > 0
        sess2.close()


# ---------------------------------------------------------------------------
# in-place mutation (the identity skip) and capture copies
# ---------------------------------------------------------------------------

class _TensorApp:
    """A CheckpointableApp holding one tensor it mutates in place."""

    def __init__(self, t: torch.Tensor):
        self.t = t
        self.step = 0

    def checkpoint_state(self):
        up = UpperHalf()
        up.register("state", "params", {"t": self.t})
        return up

    def checkpoint_step(self):
        return self.step

    def job_meta(self):
        return {"kind": "torch-tensor-app"}

    def bind(self, restore):
        self.t = restore.tree("state", {"t": torch.empty_like(self.t)})["t"]
        self.step = restore.step


register_app_kind("torch-tensor-app", replace=True)(
    lambda ctx, like: _bind_app(ctx, like))


def _bind_app(ctx, like):
    app = _TensorApp(like)
    app.bind(ctx)
    return app


def _app_session(tmp_path):
    return CheckpointSession(f"localfs:{tmp_path}", SPARSE)


def test_unchanged_tensor_is_skipped_without_a_read(tmp_path):
    t = torch.arange(4096, dtype=torch.float32)
    app = _TensorApp(t)
    sess = _app_session(tmp_path)
    sess.attach(app)
    sess.snapshot(block=True)
    app.step = 1
    sess.snapshot(block=True)
    assert sess.stats["identity_skips"] == 1
    got = _app_session(tmp_path).restore("latest", like=t.clone())
    assert torch.equal(got.t, t)
    sess.close()


@pytest.mark.parametrize("write", ["add_", "index", "view", "copy_"])
def test_in_place_write_between_chained_snapshots_is_captured(tmp_path,
                                                              write):
    """The same tensor object, written in place after the base snapshot,
    must be re-read: identity of the object alone would have skipped it
    and restored stale bytes."""
    t = torch.arange(4096, dtype=torch.float32)
    app = _TensorApp(t)
    sess = _app_session(tmp_path)
    sess.attach(app)
    sess.snapshot(block=True)
    if write == "add_":
        t.add_(1.0)
    elif write == "index":
        t[1000:1010] = -5.0
    elif write == "view":
        t.view(16, 256)[3].zero_()           # through a view
    else:
        t.copy_(torch.flip(t, [0]))
    app.step = 1
    sess.snapshot(block=True)
    assert sess.stats["identity_skips"] == 0
    assert sess.stats["dirty_chunks"] > 0
    got = _app_session(tmp_path).restore("latest", like=t.clone())
    assert torch.equal(got.t, t)
    sess.close()


def test_engine_cache_written_in_place_between_links_restores(tmp_path):
    """Trouble in practice: decode writes the KV cache in place. Write a
    cache leaf between two chained snapshots by hand and restore the
    mutated bytes."""
    params = _params()
    sess = CheckpointSession(f"localfs:{tmp_path}", SPARSE)
    eng = ServingEngine.create(ARCH, params, n_slots=2, max_seq=48,
                               manager=sess.manager, device="cpu")
    sess.attach(eng)
    for r in [Request(rid=i, prompt=p, max_new=20)
              for i, p in enumerate(_prompts(2))]:
        eng.submit(r)
    eng.step()
    sess.snapshot(block=True)
    k = eng.cache["k"]
    k.view(-1)[::97] = 3.0                    # in place; same object
    eng.steps += 1
    sess.snapshot(block=True)
    want = convert.tree_to_numpy(eng.cache)
    sess.close()
    eng2 = CheckpointSession(f"localfs:{tmp_path}", SPARSE).restore(
        "latest", params=params, device="cpu")
    got = convert.tree_to_numpy(eng2.cache)
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[name], want[name])


def test_capture_copies_before_snapshot_returns(tmp_path):
    """Capture copies every leaf: a write right after a non-blocking
    snapshot() returns must not reach the checkpoint."""
    t = torch.arange(4096, dtype=torch.float32)
    app = _TensorApp(t)
    sess = CheckpointSession(f"localfs:{tmp_path}", DENSE)
    sess.attach(app)
    before = t.clone()
    sess.snapshot()
    t.fill_(7.0)
    sess.wait()
    got = CheckpointSession(f"localfs:{tmp_path}", DENSE).restore(
        "latest", like=t.clone())
    assert torch.equal(got.t, before)
    sess.close()


def test_chained_engine_run_goes_through_the_capture_wrappers(tmp_path):
    """A chained run of the engine goes through the fingerprint and fused
    capture wrappers — on CPU tensors, their plain versions."""
    ops.reset_counts()
    test_engine_cache_written_in_place_between_links_restores(tmp_path)
    c = ops.counts("cpu")
    assert c["fingerprint"] > 0 and c["fused_capture"] > 0
    assert ops.counts("cuda") == dict.fromkeys(ops.KERNELS, 0)
    ops.reset_counts()
