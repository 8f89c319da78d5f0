"""Cross-package restore: the strongest check of the port against the
reference. A snapshot chain written by ``repro_torch`` is materialized
by the JAX package's ``CheckpointManager`` into the same host bytes as
the port's own restore (and the engine's live state at the snapshot),
and a chain written by the JAX engine restores under ``repro_torch`` to
identical bytes — same manifest format 3, leaf paths and dtype strings.
The same holds for whisper-base-smoke, the encoder-decoder: its trainer
chains (params and moments of the encoder and of the cross-attention)
and its engine chains (the cache's tuple leaves ``['cross'][0]``/``[1]``
beside ``['self']``), written by either package and restored by the
other; and for the moe family's trainer chains (llama4-scout-17b-a16e
and kimi-k2-1t-a32b at ``-smoke``: the f32 router, the experts stacked
``[L, E, ...]``, the shared expert). A JAX engine's checkpoint re-slotted
by either package finishes with the uninterrupted run's tokens, though
the JAX engine rebuilds each session's cache column by prefill and the
port lands the checkpointed one (ROADMAP C23).
"""
import functools

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.api import CheckpointSession as JSession
from repro.configs import get_smoke_config
from repro.configs import registry as jreg
from repro.core import LowerHalf as JLower
from repro.core import UpperHalf as JUpper
from repro.core import delta as jdelta
from repro.core.backends.localfs import LocalFSBackend as JBackend
from repro.core.checkpoint import CheckpointManager as JManager
from repro.models import model as JM
from repro.data.pipeline import DataConfig as JData
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.optim import AdamWConfig as JAdamW
from repro.optim import ScheduleConfig as JSchedule
from repro.optim import init_opt_state as jinit_opt
from repro.parallel.planner import make_plan as jmake_plan
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.api import CheckpointSession, Policy
from repro_torch.configs import registry as treg
from repro_torch.core.backends.localfs import LocalFSBackend
from repro_torch.core import delta as tdelta
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.train.loop import Trainer, TrainJob
from repro_torch.tree import flatten_with_paths

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


# --- whisper-base-smoke: the encoder-decoder's trainer and engine ------------

WHISPER = "whisper-base-smoke"
WHISPER_SHAPE = "train_s16_b4"
MESH = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                         ("data", "model"))


def _jax_params_of(arch):
    return JM.init_params(jreg.resolve_config(arch), jax.random.PRNGKey(0))


def _whisper_jax_params():
    return _jax_params_of(WHISPER)


def _port_training_chain(tmp_path, arch, shape_key, paths):
    """A chain of the port's trainer (a base at step 2, a link at 4)
    materializes under the JAX package to the port's own restore and to
    the trainer's live params and moments; ``paths`` must be among the
    params."""
    sess = CheckpointSession(f"localfs:{tmp_path}",
                             Policy(interval=2, chain=2,
                                    sparse_chunk_bytes=CHUNK,
                                    sparse_min_bytes=MIN))
    t = Trainer(TrainJob(arch, shape_key), manager=sess.manager,
                device="cpu")
    t.init_state()
    sess.attach(t)
    live = {}
    for _ in range(4):
        t.train_steps(1)
        if sess.maybe_snapshot() is not None:
            live[t.checkpoint_step()] = {
                e: dict(flatten_with_paths(
                    convert.tree_to_numpy(t.upper.get(e))))
                for e in ("params", "opt_state")}
    sess.close()
    jm = JManager(JBackend(str(tmp_path)))
    tm = CheckpointManager(LocalFSBackend(str(tmp_path)))
    assert jm.backend.list_steps() == [2, 4]
    assert jm.backend.get_manifest(4)["base_step"] == 2
    for step in (2, 4):
        jr, tr = jm.restore(step), tm.restore(step)
        _assert_same_entries(jr.entries, tr.entries)
        assert jr.manifest == tr.manifest
        for e, leaves in live[step].items():
            for path, want in leaves.items():
                assert _bytes(jr.entries[e][path]) == _bytes(want)
        for path in paths:
            assert path in jr.entries["params"]
    for m in (jm, tm):
        m.close()


def _jax_training_chain(tmp_path, arch, shape_key, params=None):
    """A chain written by the JAX package's CheckpointManager from its
    pure step (its Trainer fails on jax 0.9's Explicit-axis meshes,
    ROADMAP C4) comes back in the port with the same bytes, and the
    port's trainer steps on from it to the JAX step's loss within 2e-2
    (bf16 params). ``params``: the JAX params to start from (default:
    the JAX init's)."""
    cfg = jreg.resolve_config(arch)
    shape = jreg.get_shape(shape_key)
    jfn = jax.jit(jstep.make_train_step(
        cfg, jmake_plan(cfg, shape, MESH), JAdamW(), JSchedule(), mesh=None))
    if params is None:
        params = _jax_params_of(arch)
    opt = jinit_opt(params, JAdamW())
    lower = JLower(mesh_factory=lambda: MESH)
    lower.mesh_create((1, 1), ("data", "model"))
    lower.compile_step("train_step", arch, shape_key, "")
    jm = JManager(JBackend(str(tmp_path)), async_save=False,
                  delta_base_interval=2)
    pipe = JPipeline(JData(seed=1234, vocab_size=cfg.vocab_size,
                           seq_len=shape.seq_len,
                           global_batch=shape.global_batch,
                           n_shards=shape.global_batch,
                           frames=cfg.encoder_seq,
                           frame_dim=cfg.frontend_dim))
    meta = {"kind": "train", "arch": arch, "shape_key": shape_key,
            "plan_key": "", "init_seed": 0, "data_seed": 1234}
    for step in range(4):
        batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(step).items()}
        params, opt, _ = jfn(params, opt, batch, jnp.int32(step),
                             jnp.float32(1.0))
        lower.data_advance(1)
        if (step + 1) % 2 == 0:
            up = JUpper()
            up.register("params", "params", params, JM.logical_specs(cfg))
            up.register("opt_state", "opt_state", opt)
            up.register("step", "step", np.int64(step + 1))
            up.register("data_cursor", "data_cursor", np.int64(step + 1))
            up.register("rng_seed", "rng", np.int64(0))
            jm.save(step + 1, up, lower.oplog, job_meta=meta)
    jm.wait()
    tm = CheckpointManager(LocalFSBackend(str(tmp_path)))
    for step in (2, 4):
        _assert_same_entries(tm.restore(step).entries,
                             jm.restore(step).entries)
    t = CheckpointSession(f"localfs:{tmp_path}").restore(
        "latest", expect_kind="train", device="cpu")
    want = jm.restore(4).entries
    for e in ("params", "opt_state"):
        got = dict(flatten_with_paths(convert.tree_to_numpy(t.upper.get(e))))
        assert sorted(got) == sorted(want[e])
        for path, v in got.items():
            assert _bytes(v) == _bytes(want[e][path]), (e, path)
    assert t.checkpoint_step() == 4
    loss = t.train_steps(1)["loss"]
    batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(4).items()}
    _, _, jmet = jfn(params, opt, batch, jnp.int32(4), jnp.float32(1.0))
    assert abs(loss - float(jmet["loss"])) < 2e-2 * abs(float(jmet["loss"]))
    for m in (jm, tm):
        m.close()


def test_port_whisper_training_chain_restores_under_jax(tmp_path):
    _port_training_chain(tmp_path, WHISPER, WHISPER_SHAPE,
                         ["['enc_layers']['attn']['wq']",
                          "['layers']['cross']['wk']"])


def test_jax_whisper_training_chain_restores_under_the_port(tmp_path):
    _jax_training_chain(tmp_path, WHISPER, WHISPER_SHAPE)


MOE_ARCHS = ["llama4-scout-17b-a16e-smoke", "kimi-k2-1t-a32b-smoke"]
MOE_PATHS = ["['layers']['ffn']['router']", "['layers']['ffn']['w_gate']",
             "['layers']['ffn']['shared']['w_up']"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_port_moe_training_chain_restores_under_jax(tmp_path, arch):
    """The moe trainers' chains: the f32 router, the bf16 experts
    stacked [L, E, ...] and the shared expert, with their moments."""
    _port_training_chain(tmp_path, arch, "train_s16_b4", MOE_PATHS)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_jax_moe_training_chain_restores_under_the_port(tmp_path, arch):
    _jax_training_chain(tmp_path, arch, "train_s16_b4")


def test_port_whisper_engine_chain_restores_under_jax(tmp_path):
    params = convert.params_from_numpy(
        jax.tree.map(np.asarray, _whisper_jax_params()), "cpu")
    sess = CheckpointSession(f"localfs:{tmp_path}",
                             Policy(interval=3, chain=4,
                                    sparse_chunk_bytes=CHUNK,
                                    sparse_min_bytes=MIN))
    eng = ServingEngine.create(WHISPER, params, n_slots=2, max_seq=48,
                               manager=sess.manager, device="cpu")
    sess.attach(eng)
    for i, p in enumerate(_prompts()):
        eng.submit(Request(rid=i, prompt=p, max_new=8))
    live = {}
    for _ in range(12):
        eng.step()
        if sess.maybe_snapshot() is not None:
            live[eng.steps] = dict(flatten_with_paths(
                convert.tree_to_numpy(eng.cache)))
    sess.close()
    jm = JManager(JBackend(str(tmp_path)))
    tm = CheckpointManager(LocalFSBackend(str(tmp_path)))
    assert jm.backend.list_steps() == [3, 6, 9, 12]
    for step in (3, 6, 9, 12):
        jr, tr = jm.restore(step), tm.restore(step)
        _assert_same_entries(jr.entries, tr.entries)
        assert jr.manifest == tr.manifest
        assert sorted(live[step]) == sorted(jr.entries["kv_cache"])
        for path, want in live[step].items():
            assert _bytes(jr.entries["kv_cache"][path]) == _bytes(want)
    assert "['cross'][1]" in live[12]
    for m in (jm, tm):
        m.close()


def test_jax_whisper_engine_chain_restores_under_the_port(tmp_path):
    jparams = _whisper_jax_params()
    jm = JManager(JBackend(str(tmp_path)), async_save=False,
                  delta_base_interval=4, sparse_chunk_bytes=CHUNK,
                  sparse_min_bytes=MIN)
    jeng = JEngine(get_smoke_config("whisper-base"), jparams, MESH,
                   n_slots=2, max_seq=48, manager=jm, arch=WHISPER)
    for i, p in enumerate(_prompts()):
        jeng.submit(JRequest(rid=i, prompt=p, max_new=8))
    for _ in range(12):
        jeng.step()
        if jeng.steps % 3 == 0:
            jeng.snapshot()
    jm.wait()
    assert jm.backend.list_steps() == [3, 6, 9, 12]
    tm = CheckpointManager(LocalFSBackend(str(tmp_path)))
    for step in (3, 6, 9, 12):
        _assert_same_entries(tm.restore(step).entries,
                             jm.restore(step).entries)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       "cpu")
    eng = CheckpointSession(f"localfs:{tmp_path}").restore(
        "latest", params=params, device="cpu")
    want = jm.restore(12).entries["kv_cache"]
    got = dict(flatten_with_paths(convert.tree_to_numpy(eng.cache)))
    assert sorted(got) == sorted(want)
    for path, v in got.items():
        assert _bytes(v) == _bytes(want[path]), path
    assert eng.steps == jeng.steps
    np.testing.assert_array_equal(eng.slot_pos, jeng.slot_pos)
    np.testing.assert_array_equal(eng.slot_tok, jeng.slot_tok)
    assert [(r.rid, r.out) for r in eng.live_requests()] == \
        [(r.rid, r.out) for r in jeng.live_requests()]
    # both finish the restored sessions with the same tokens
    jeng.run_until_drained(max_steps=100)
    eng.run_until_drained(max_steps=100)
    assert [(r.rid, r.out) for r in eng.live_requests()] == []
    for m in (jm, tm):
        m.close()


def _column(cache, s, upto):
    """Slot ``s``'s column of a phi4-smoke cache ``[L, B, S, ...]`` (host
    arrays), positions below ``upto``: the ones its history wrote."""
    return {name: np.asarray(cache[name])[:, s, :upto]
            for name in ("k", "v")}


@pytest.mark.parametrize("new_slots", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_engine_checkpoint_reslots_to_the_same_tokens_in_both(
        tmp_path, monkeypatch, dtype, new_slots):
    """A JAX engine's checkpoint, taken with two sessions in flight and
    three waiting, re-slotted onto ``new_slots`` by each package: both
    finish every request with the uninterrupted run's tokens. The port
    lands each former in-flight session's checkpointed cache column bit
    for bit; the JAX engine rebuilds it by prefilling the history, which
    comes close to the decode steps' column and, in f32, not to its bits
    (ROADMAP C23)."""
    for reg in (jreg, treg):
        monkeypatch.setattr(reg, "resolve_config", functools.partial(
            lambda orig, arch: orig(arch).replace(dtype=dtype),
            reg.resolve_config))
    cfg = jreg.resolve_config(ARCH)
    jparams = JM.init_params(cfg, jax.random.PRNGKey(0))
    jm = JManager(JBackend(str(tmp_path)), async_save=False)
    jeng = JEngine(cfg, jparams, MESH, n_slots=2, max_seq=48, manager=jm,
                   arch=ARCH)
    for i, p in enumerate(_prompts()):
        jeng.submit(JRequest(rid=i, prompt=p, max_new=8))
    for _ in range(5):
        jeng.step()
    jeng.snapshot()
    jm.wait()
    seated = {r.rid: (s, int(jeng.slot_pos[s]))
              for s, r in enumerate(jeng.slot_req) if r is not None}
    cols = {rid: _column(jeng.cache, s, pos)
            for rid, (s, pos) in seated.items()}
    reqs = jeng.live_requests()
    assert len(seated) == 2 and len(reqs) == 5
    jeng.run_until_drained(max_steps=200)
    want = {r.rid: list(r.out) for r in reqs}

    j2 = JSession(f"localfs:{tmp_path}").restore(
        "latest", params=jparams, n_slots=new_slots, mesh=MESH)
    t2 = CheckpointSession(f"localfs:{tmp_path}").restore(
        "latest", params=convert.params_from_numpy(
            jax.tree.map(np.asarray, jparams), "cpu"),
        device="cpu", n_slots=new_slots)
    landed = {"jax": {}, "port": {}}
    for name, eng in (("jax", j2), ("port", t2)):
        for s, r in enumerate(eng.slot_req):
            if r is not None and r.rid in cols:
                landed[name][r.rid] = _column(
                    convert.tree_to_numpy(eng.cache) if name == "port"
                    else eng.cache, s, seated[r.rid][1])
    assert sorted(landed["jax"]) == sorted(landed["port"])
    assert len(landed["port"]) == min(new_slots, 2)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for rid, col in landed["port"].items():
        for name in ("k", "v"):
            assert _bytes(col[name]) == _bytes(cols[rid][name])
            rebuilt = np.asarray(landed["jax"][rid][name], np.float32)
            want_col = np.asarray(cols[rid][name], np.float32)
            assert np.linalg.norm(rebuilt - want_col) <= \
                tol * np.linalg.norm(want_col), (rid, name)
            if dtype == "float32":
                assert _bytes(rebuilt) != _bytes(want_col), (rid, name)
    got = {}
    for name, eng in (("jax", j2), ("port", t2)):
        live = eng.live_requests()
        assert len(live) == 5
        eng.run_until_drained(max_steps=200)
        got[name] = {r.rid: list(r.out) for r in live}
    assert got["jax"] == got["port"] == want
    jm.close()


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


# --- the third-party app: the JAX example and the port's twin ----------------------

def _jax_rl_example():
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples"))
    import rl_actor_learner   # registers its kind in the JAX package
    return rl_actor_learner


@pytest.mark.parametrize("store", ["localfs", "sharded"])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_rl_actor_learner_chain_restores_in_the_other_package(
        tmp_path, writer, store):
    """A delta chain of the RL actor-learner written by one package (the
    JAX package's ``examples/rl_actor_learner.py`` or the port's twin)
    restores in the other onto another actor pool, and continues to the
    uninterrupted run's digest."""
    from repro.api import Policy as JPolicy
    from repro_torch.examples import rl_actor_learner as trl
    jrl = _jax_rl_example()
    spec = f"{store}:{tmp_path}/rl" + ("?hosts=3" if store == "sharded"
                                       else "")
    ref = jrl.RLActorLearner(n_actors=1, n_streams=8, dim=16, seed=4)
    ref.collect_and_learn(12)
    w_sess, w_pol, w_rl, r_sess, r_pol = (
        (CheckpointSession, Policy, trl, JSession, JPolicy)
        if writer == "torch" else
        (JSession, JPolicy, jrl, CheckpointSession, Policy))
    with w_sess(spec, w_pol(interval=2, chain=3, keep_last=4)) as sess:
        app = sess.attach(w_rl.RLActorLearner(2, 8, dim=16, seed=4))
        for _ in range(7):
            app.collect_and_learn(1)
            sess.maybe_snapshot()
        sess.wait()
        assert sess.backend.get_manifest(6).get("base_step") is not None
    with r_sess(spec, r_pol()) as sess:
        back = sess.restore("latest", n_actors=3)
    assert type(back).__module__ != type(app).__module__
    assert (back.t, back.n_actors) == (6, 3)
    back.collect_and_learn(6)
    assert back.digest() == ref.digest()
