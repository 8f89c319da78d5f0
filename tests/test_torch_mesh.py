"""Training and serving over a device mesh and elastic restore across
meshes, on gloo CPU ranks (ROADMAP A9a, A9b steps 1 and 2).

Two ``spawn_ranks`` launches of four ranks each run side by side in one
module fixture (``torch_mesh_ranks`` holds their functions); each test
reads one scenario's results. Both launches' collectives go through
the collective shim's staging area (``parallel.collectives``, the
card's path) on CPU tensors, as every launch's do.
starcoder2-3b-smoke and kimi-k2-1t-a32b-smoke are float32 in both
packages here.

- Sharded steps at (2, 2), (4, 1) and (1, 4) against the port's
  one-device step: losses within 1e-5 relative, params within 1e-6
  absolute after two steps (the sums over the mesh reduce in another
  order; AdamW's first steps move a param by at most about the learning
  rate, 3e-5 or less at these steps of the warmup).
- The (2, 2) checkpoint (a base and a chain link, rank 0's commit)
  restored onto (4, 1) eagerly and streamed, (1, 4), (2, 2), one device
  here, and by the JAX package's ``Trainer.restore`` on its one-device
  mesh: every params
  digest the saved one, bit for bit, and each restore steps on. The
  same-mesh continuation gives the uninterrupted run's loss and state
  digest bit for bit. The checkpoint's params are the ranks' values
  gathered whole, byte for byte.
- A checkpoint the JAX package wrote restores onto (2, 2) with the JAX
  params' digest.
- kimi-k2's MoE layer at capacity factor 16 (nothing drops),
  expert-parallel at (2, 2), against the JAX package's local
  ``moe_forward`` within 1e-5 of the output's largest element.
- ``compressed_psum`` over the four ranks within 2 x scale of the exact
  mean (the reference's bound), its error carry the local residual.
- The GPipe pipeline (L 8, M 6, mb 4, D 16) over four stages against a
  jnp layer loop within 1e-6.
- phi4-mini-3.8b-smoke (float32, 2 KV heads) served on (2, 2) — slots
  and KV heads split — gives the one-device port engine's and the JAX
  engine's tokens on the same converted params and prompts, each
  step's logits within 1e-5 of the one-device engine's, the same on
  every rank. Its checkpoint of step 6 restores onto (2, 2) bit for bit
  (tokens, logits, cache digest), onto (1, 4) eagerly (the cache's
  sequence split over the model axis, decode combining the ranks'
  partial softmaxes) and onto (4, 1) streamed with the uninterrupted
  tokens and the saved cache digest, re-slotted onto 3 slots of (2, 2)
  carrying each session's column (C23), and in the JAX engine on one
  device; the JAX engine's checkpoint restores onto (2, 2) and goes on
  with the JAX engine's tokens. The sequence-split combine matches
  plain attention over the whole cache within 1e-6. kimi-k2-smoke served
  on (2, 2), expert-parallel, gives the one-device port engine's tokens,
  its logits within 1e-5.
- ``prefill`` and ``decode_step`` of mamba2, recurrentgemma and whisper
  on DTensor tokens raise, naming ROADMAP A9b step 4.
- The failure loop over the mesh (A9b step 2), one supervisor a rank:
  the (2, 2) checkpoint shrinks onto (2, 1) over ranks 0-1 (the saved
  digest, the next loss within 1e-5 of one device's; ranks 2-3 hold
  nothing), grows back onto (2, 2) and restarts there bit for bit,
  every rank logging the same incidents; a (2, 2) engine re-slots onto
  3 slots of (1, 2) with the one-device supervised engine's tokens; a
  mesh engine's ``session_columns`` are a one-device restore's bits and
  its sessions move onto one device token for token; the launcher's
  ``--supervise`` over (2, 2) prints the one-device run's incident line
  and hosts, its losses within 1e-5.
"""
import contextlib
import hashlib
import io
import re
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import kimi_k2_1t_a32b as jkimi
from repro.configs import phi4_mini_3_8b as jphi
from repro.configs import registry as jreg
from repro.configs import starcoder2_3b as jsc
from repro.core.backends.localfs import LocalFSBackend as JBackend
from repro.core.checkpoint import CheckpointManager as JManager
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.optim.compression import BLOCK as JBLOCK
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.api import CheckpointSession, Policy
from repro_torch.configs import kimi_k2_1t_a32b as tkimi
from repro_torch.configs import phi4_mini_3_8b as tphi
from repro_torch.configs import registry as treg
from repro_torch.configs import starcoder2_3b as tsc
from repro_torch.core.backends.localfs import LocalFSBackend
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.host import host_array
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.launch.serve import proportional_slots
from repro_torch.models import model as TM
from repro_torch.models.layers import dense_attention
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.train.loop import Trainer, TrainJob
from repro_torch.models.moe import moe_template
from repro_torch.tree import flatten_with_paths, tree_from_paths

import torch_mesh_ranks as R

STEPS = 2
SHAPES = ((2, 2), (4, 1), (1, 4))


def _auto_mesh(shape, axes, **_):
    return jax.sharding.Mesh(
        np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), axes)


def _digest(params) -> str:
    """The trainers' params digest of a {path: array} map."""
    h = hashlib.blake2b(digest_size=16)
    for path in sorted(params):
        h.update(path.encode())
        h.update(np.ascontiguousarray(params[path]).tobytes())
    return h.hexdigest()


def _moe_inputs():
    """kimi-k2-smoke's MoE layer (its template's shapes, numpy draws
    scaled by fan-in) and an input [4, 8, D], float32: (config, params
    tree, x, {path: array})."""
    cfg = jreg.resolve_config(R.MOE_ARCH).replace(capacity_factor=16.0)
    rng = np.random.RandomState(3)
    flat = {p: (rng.randn(*leaf.shape) / np.sqrt(leaf.fan_in or 1))
            .astype(np.float32)
            for p, leaf in flatten_with_paths(moe_template(
                treg.resolve_config(R.MOE_ARCH)))}
    x = rng.randn(4, 8, cfg.d_model).astype(np.float32)
    return cfg, tree_from_paths(flat), x, flat


def _serve_prompts():
    rng = np.random.RandomState(9)
    return [rng.randint(0, 256, size=rng.randint(3, 14)).astype(np.int32)
            for _ in range(6)]


def _combine_case():
    """A decode query against a 64-slot cache with empty slots and a
    window, for ``combine_case``'s (1, 4) split: q [2, 1, 2, 2, 16]
    (B, Sq, Hkv, G, hd), k/v [2, 64, 2, 16], positions."""
    rng = np.random.RandomState(5)
    kv_pos = np.tile(np.arange(64, dtype=np.int32), (2, 1))
    kv_pos[0, 40:] = -1                 # row 0 has filled 40 slots
    kv_pos[1, 20:30] = -1
    return dict(q=rng.randn(2, 1, 2, 2, 16).astype(np.float32),
                k=rng.randn(2, 64, 2, 16).astype(np.float32),
                v=rng.randn(2, 64, 2, 16).astype(np.float32),
                q_pos=np.array([[39], [63]], np.int32), kv_pos=kv_pos,
                window=np.int32(48))


def _jax_serving(jparams, prompts, jax_serve_store):
    """The JAX engine on one device: the prompts to the end with a
    snapshot every ``R.SERVE_EVERY`` steps into ``jax_serve_store``
    (then ``READY``). Returns each request's tokens."""
    cfg = jreg.resolve_config(R.SERVE_ARCH)
    jm = JManager(JBackend(str(jax_serve_store)), async_save=False)
    eng = JEngine(cfg, jparams, _auto_mesh((1, 1), R.AXES), manager=jm,
                  arch=R.SERVE_ARCH, **R.SERVE)
    reqs = [JRequest(rid=i, prompt=p.copy(), max_new=SERVE_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    while eng.queue or any(eng.slot_req):
        eng.step()
        if eng.steps % R.SERVE_EVERY == 0:
            eng.snapshot()
    jm.wait()
    jm.close()
    (jax_serve_store / "READY").touch()
    return {r.rid: list(r.out) for r in reqs}


def _port_one_device(params, prompts, cfg=None, max_new=None, **sizes):
    """The port's engine on one device (phi4-mini-3.8b-smoke at
    ``R.SERVE`` by default): (tokens, {step: logits})."""
    eng = ServingEngine(cfg or tphi.smoke_config(), params, "cpu",
                        **(sizes or R.SERVE))
    reqs = [Request(rid=i, prompt=p.copy(), max_new=max_new or SERVE_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    logits = {}
    while eng.queue or any(eng.slot_req):
        eng.step()
        logits[eng.steps] = eng.last_logits.numpy().copy()
    return {r.rid: list(r.out) for r in reqs}, logits


SERVE_NEW = 8
# the supervised engine: ``test_torch_supervisor.py``'s serving world
# (its prompts, 5 new tokens, the kill after 4 steps) on 4 slots
SUP_SERVE = dict(n_slots=4, max_seq=64)
SUP_NEW, SUP_KILL_AT = 5, 4
LAUNCH_STEPS, LAUNCH_KILL = 5, "2@1"


def _sup_prompts():
    rng = np.random.RandomState(3)
    vocab = tphi.smoke_config().vocab_size
    return [rng.randint(0, vocab, size=4) for _ in range(4)]


def _one_device_supervised(params, prompts, store):
    """The supervised engine on one device: ``prompts`` on 4 slots, a
    snapshot after ``SUP_KILL_AT`` steps, host 3 of 0-3 silent, the
    shrink re-slotted onto 3 slots, drained: each request's tokens."""
    sess = CheckpointSession(f"localfs:{store}", Policy(async_save=False))
    eng = sess.attach(ServingEngine.create(
        R.SERVE_ARCH, params, manager=sess.manager, device="cpu",
        **SUP_SERVE))
    reqs = [Request(rid=i, prompt=p.copy(), max_new=SUP_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    for _ in range(SUP_KILL_AT):
        eng.step()
    sess.snapshot(block=True)
    now = [0.0]
    sup = sess.supervise([0, 1, 2, 3], heartbeat_timeout=3.0,
                         clock=lambda: now[0], restore_kwargs=lambda t: {
                             "params": params, "device": "cpu",
                             "n_slots": proportional_slots(
                                 SUP_SERVE["n_slots"], 4, len(t.hosts))})
    target = R._beat_until_dead(sup, now, (0, 1, 2))
    assert target.action.value == "shrink" and sup.runner.n_slots == 3
    live = sup.runner.live_requests()
    sup.runner.run_until_drained(max_steps=200)
    tokens = {r.rid: list(r.out) for r in reqs if r.done}
    tokens.update({r.rid: list(r.out) for r in live})
    sess.close()
    return tokens


def _jax_tokens(jparams, prompts, max_new, sizes):
    """The JAX engine on one device, uninterrupted: each request's
    tokens."""
    eng = JEngine(jreg.resolve_config(R.SERVE_ARCH), jparams,
                  _auto_mesh((1, 1), R.AXES), **sizes)
    reqs = [JRequest(rid=i, prompt=p.copy(), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_steps=200)
    return {r.rid: list(r.out) for r in reqs}


def _one_device_launcher(store):
    """``launch.train.main`` on one device with the mesh launcher's
    supervised command line: (what it printed, each step's (step,
    loss))."""
    from repro_torch.train import loop
    seen, plain = [], loop.Trainer.train_steps

    def train_steps(self, n):
        m = plain(self, n)
        seen.append((int(m["step"]), float(m["loss"])))
        return m
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop.Trainer, "train_steps", train_steps)
        with contextlib.redirect_stdout(buf):
            assert ttrain.main(R.launch_argv(LAUNCH_STEPS, LAUNCH_KILL) + [
                "--store", f"localfs:{store}", "--device", "cpu"]) == 0
    return buf.getvalue(), seen


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    store = tmp_path_factory.mktemp("mesh_ckpt")
    jax_store = tmp_path_factory.mktemp("jax_ckpt")
    serve_store = tmp_path_factory.mktemp("mesh_serve")
    jax_serve_store = tmp_path_factory.mktemp("jax_serve")
    sup_root = tmp_path_factory.mktemp("mesh_supervised")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "make_mesh", _auto_mesh)
        for mod in (jsc, jkimi, jphi, tsc, tkimi, tphi):
            plain = mod.smoke_config
            mp.setattr(mod, "smoke_config",
                       lambda plain=plain: plain().replace(dtype="float32"))
        cfg, layer, x, flat = _moe_inputs()
        rng = np.random.RandomState(0)
        ef_in = {"g": rng.randn(4, 8, 1024).astype(np.float32)}
        pipe_in = {"W": (rng.randn(8, 16, 16) * 0.2).astype(np.float32),
                   "X": rng.randn(6, 4, 16).astype(np.float32)}
        jparams = JM.init_params(jreg.resolve_config(R.SERVE_ARCH),
                                 jax.random.PRNGKey(0))
        jparams_np = jax.tree.map(np.asarray, jparams)
        prompts = _serve_prompts()
        serve_in = dict(params=jparams_np, prompts=prompts,
                        max_new=SERVE_NEW, store=str(serve_store),
                        jax_store=str(jax_serve_store))
        case = _combine_case()
        moe_params = TM.init_params(tkimi.smoke_config(), seed=0,
                                    device="cpu")
        moe_in = dict(params=convert.tree_to_numpy(moe_params),
                      prompts=prompts[:3])
        sup_prompts = _sup_prompts()
        sup_in = dict(params=jparams_np, prompts=sup_prompts,
                      max_new=SUP_NEW, kill_at=SUP_KILL_AT, serve=SUP_SERVE,
                      store=str(sup_root / "engine"))
        launch_in = dict(store=str(sup_root / "launch"), steps=LAUNCH_STEPS,
                         kill=LAUNCH_KILL)
        out = {}

        def launch(key, fn, args):
            try:
                out[key] = spawn_ranks(fn, 4, device="cpu", args=args,
                                       threads=1, timeout_s=300)
            except BaseException as e:      # read in the test thread
                out[key] = e

        threads = [
            threading.Thread(target=launch, args=(
                "train", R.train_and_restore,
                (str(store), str(jax_store), STEPS,
                 {"params": flat, "x": x}, serve_in, sup_in, launch_in))),
            threading.Thread(target=launch, args=(
                "others", R.others,
                (SHAPES[1:], STEPS, str(store), ef_in, pipe_in, serve_in,
                 case, moe_in)))]
        for t in threads:
            t.start()
        # meanwhile: the JAX engine's tokens and checkpoint, the JAX
        # package's training checkpoint (its trainer, two steps, one
        # save), the one-device reference runs, the JAX MoE
        try:
            jax_tokens = _jax_serving(jparams, prompts, jax_serve_store)
        finally:
            (jax_serve_store / "READY").touch()
        one_tokens, one_logits = _port_one_device(
            convert.params_from_numpy(jparams_np, "cpu"), prompts)
        moe_one = _port_one_device(moe_params, prompts[:3],
                                   cfg=tkimi.smoke_config(), n_slots=2,
                                   max_seq=32, max_new=4)
        try:
            jm = JManager(JBackend(str(jax_store)), async_save=False)
            jt = jloop.Trainer(jloop.TrainJob(R.ARCH, R.SHAPE), (1, 1),
                               ("data", "model"), manager=jm)
            jt.init_state()
            jt.train_steps(2)
            jt.save(block=True)
            jax_digest = jt.params_digest()
            jm.close()
        finally:
            (jax_store / "READY").touch()
        one = Trainer(TrainJob(R.ARCH, R.SHAPE), device="cpu")
        one.init_state()
        one_losses = [one.train_steps(1)["loss"] for _ in range(STEPS)]
        one_params = {p: host_array(v)
                      for p, v in flatten_with_paths(one.upper.get("params"))}
        moe_want = JMOE.moe_forward(cfg, jax.tree.map(jnp.asarray, layer),
                                    jnp.asarray(x))
        serve_params = convert.params_from_numpy(jparams_np, "cpu")
        sup_one = _one_device_supervised(serve_params, sup_prompts,
                                         sup_root / "one_engine")
        sup_plain = _port_one_device(serve_params, sup_prompts,
                                     max_new=SUP_NEW, **SUP_SERVE)[0]
        sup_jax = _jax_tokens(jparams, sup_prompts, SUP_NEW, SUP_SERVE)
        launch_one = _one_device_launcher(sup_root / "one_launch")
        for t in threads:
            t.join(400)
            assert not t.is_alive()
        for v in out.values():
            if isinstance(v, BaseException):
                raise v
        # the (2, 2) checkpoint on one device, in both packages
        sess = CheckpointSession(f"localfs:{store}")
        t1 = Trainer.restore(sess.manager, device="cpu")
        on_one = dict(digest=t1.params_digest(), step=t1.checkpoint_step(),
                      loss=t1.train_steps(1)["loss"])
        sess.close()
        jm = JManager(JBackend(str(store)))
        with pytest.warns(DeprecationWarning):
            jt = jloop.Trainer.restore(
                jm, mesh_factory=lambda: _auto_mesh((1, 1), ("data",
                                                             "model")))
        in_jax = dict(digest=jt.params_digest(),
                      step=int(jt.upper.get("step")))
        jm.close()
        tm = CheckpointManager(LocalFSBackend(str(store)))
        saved = tm.restore(None)
        entries = {p: np.asarray(v) for p, v in
                   saved.entries["params"].items()}
        tm.close()
        # the supervised trainer's (2, 1) snapshot on one device
        sess = CheckpointSession(f"localfs:{store}-supervised")
        t1 = Trainer.restore(sess.manager, step=3, device="cpu")
        grow_want = dict(digest=t1.params_digest(),
                         loss=t1.train_steps(1)["loss"])
        sess.close()
        # the serving checkpoint's live columns on one device
        sess = CheckpointSession(f"localfs:{serve_store}")
        eng = sess.restore(R.SERVE_AT, params=serve_params, device="cpu")
        columns_one = {rid: {p: host_array(v) for p, v in
                             flatten_with_paths(col)}
                       for rid, col in eng.session_columns().items()}
        sess.close()
        # the mesh's serving checkpoint in the JAX engine, one device
        jm = JManager(JBackend(str(serve_store)))
        with pytest.warns(DeprecationWarning):
            jeng = JEngine.restore(jm, jparams, step=R.SERVE_AT,
                                   mesh=_auto_mesh((1, 1), R.AXES))
        live = jeng.live_requests()
        jeng.run_until_drained()
        serve_in_jax = {r.rid: list(r.out) for r in live}
        jm.close()
    return dict(one_losses=one_losses, one_params=one_params,
                train=out["train"], others=out["others"], on_one=on_one,
                in_jax=in_jax, jax_digest=jax_digest, entries=entries,
                moe_want=moe_want, ef_in=ef_in, pipe_in=pipe_in,
                jax_tokens=jax_tokens, one_tokens=one_tokens,
                one_logits=one_logits, serve_in_jax=serve_in_jax, case=case,
                moe_one=moe_one, sup_one=sup_one, sup_plain=sup_plain,
                sup_jax=sup_jax, launch_one=launch_one, grow_want=grow_want,
                columns_one=columns_one)


def _mesh_run(runs, shape):
    if shape == (2, 2):
        r = runs["train"][0]
        return r["losses"], r["params"]
    r = runs["others"][0]["steps"][shape]
    return r["losses"], r["params"]


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_steps_match_one_device(runs, shape):
    losses, params = _mesh_run(runs, shape)
    np.testing.assert_allclose(losses, runs["one_losses"], rtol=1e-5)
    assert sorted(params) == sorted(runs["one_params"])
    for path, want in runs["one_params"].items():
        np.testing.assert_allclose(params[path], want, rtol=0, atol=1e-6,
                                   err_msg=path)


def test_ranks_agree_and_the_plan_is_the_references(runs):
    r = runs["train"]
    assert len({x["digest"] for x in r}) == 1
    assert len({tuple(x["losses"]) for x in r}) == 1
    plan = r[0]["plan"]
    assert plan.seq_shard and plan.rules["embed"] == ("data",)
    assert plan.batch_axes == ("data",) and plan.model_axis == "model"


@pytest.mark.parametrize("shape", [(4, 1), (1, 4), "(4, 1) streamed"])
def test_checkpoint_restores_onto_another_mesh(runs, shape):
    r = runs["train"][0]
    got = runs["others"][0]["restores"][shape]
    assert got["digest"] == r["digest"] and got["step"] == r["step"]
    np.testing.assert_allclose(got["loss"], r["next_loss"], rtol=1e-5)


def test_checkpoint_restores_onto_one_device(runs):
    r = runs["train"][0]
    got = runs["on_one"]
    assert got["digest"] == r["digest"] and got["step"] == r["step"]
    np.testing.assert_allclose(got["loss"], r["next_loss"], rtol=1e-5)


def test_checkpoint_restores_in_the_jax_package(runs):
    r = runs["train"][0]
    got = runs["in_jax"]
    assert got["digest"] == r["digest"] and got["step"] == r["step"]


def test_same_mesh_continuation_is_bit_identical(runs):
    r = runs["train"][0]
    got = r["restores"][(2, 2)]
    assert got["loss"] == r["next_loss"]
    assert got["state_digest"] == r["state_digest"]


def test_checkpoint_holds_the_gathered_params(runs):
    r = runs["train"][0]
    assert sorted(runs["entries"]) == sorted(r["params"])
    for path, v in r["params"].items():
        assert runs["entries"][path].tobytes() == v.tobytes(), path
    assert _digest(runs["entries"]) == r["digest"]


def test_jax_checkpoint_restores_onto_a_mesh(runs):
    got = runs["train"][0]["jax_restore"]
    assert got["digest"] == runs["jax_digest"] and got["step"] == 2
    assert np.isfinite(got["loss"])


def test_expert_parallel_moe_matches_jax_local(runs):
    y_want, aux_want = runs["moe_want"]
    got = runs["train"][0]["moe"]
    assert got["local_experts"] < tkimi.smoke_config().n_experts
    y_want = np.asarray(y_want)
    np.testing.assert_allclose(got["y"], y_want, rtol=0,
                               atol=1e-5 * np.abs(y_want).max())
    np.testing.assert_allclose(got["aux"], float(aux_want), rtol=1e-5)


def test_compressed_psum_within_two_scales(runs):
    g = runs["ef_in"]["g"]
    exact = g.mean(axis=0)
    scale = np.abs(g).max() / 127
    for r in runs["others"]:
        err = np.abs(r["compress"]["red"] - exact).max()
        assert err < 2 * scale, (err, scale)
    # the carry is each rank's own quantization residual, under a block
    r0 = runs["others"][0]["compress"]["ef"]
    assert np.abs(r0).max() <= np.abs(g[0]).reshape(-1, JBLOCK).max() / 127


def test_pipeline_matches_layer_loop(runs):
    W, X = runs["pipe_in"]["W"], runs["pipe_in"]["X"]
    ref = jnp.asarray(X)
    for w in W:
        ref = jnp.tanh(ref @ jnp.asarray(w))
    for r in runs["others"]:
        np.testing.assert_allclose(r["pipeline"], np.asarray(ref), rtol=0,
                                   atol=1e-6)


def test_the_staged_launch_went_through_the_shim(runs):
    """Both launches: DTensor's collectives staged, the snapshot's and
    the digests' leaves gathered onto rank 0 alone, broadcast gloo's."""
    for key in ("train", "others"):
        stats = runs[key][0]["stats"]
        for name in ("all_gather", "reduce_scatter", "all_reduce",
                     "gather"):
            assert stats[name]["calls"] > 0 and stats[name]["staged"], \
                (key, name)
    # the pipeline's result broadcast: gloo's, as it is
    assert not runs["others"][0]["stats"]["broadcast"]["staged"]


def test_snapshot_state_is_gathered_onto_rank_zero_alone(runs):
    """checkpoint_state is rank 0's whole copy and None elsewhere, and
    ``gather_to`` places every block of each placement (sharded,
    replicated, a dim split over both mesh axes) on rank 0 only."""
    r = runs["train"]
    assert [x["checkpoint_state"] for x in r] == [True, False, False,
                                                   False]
    want = runs["others"][0]["gather_want"]
    for rank, x in enumerate(runs["others"]):
        for name, got in x["gather"].items():
            if rank == 0:
                assert got.tobytes() == want.tobytes(), name
            else:
                assert got is None, (rank, name)


# --- serving over a mesh (A9b step 1) ----------------------------------------

def test_mesh_engine_gives_the_one_device_and_jax_tokens(runs):
    """(2, 2): the one-device port engine's and the JAX engine's tokens,
    every step's logits within 1e-5 of the one-device engine's; the
    slots split over data and the KV heads over model."""
    got = runs["train"][0]["serve"]
    assert all(len(t) == SERVE_NEW for t in runs["jax_tokens"].values())
    assert got["tokens"] == runs["one_tokens"] == runs["jax_tokens"]
    assert sorted(got["logits"]) == sorted(runs["one_logits"])
    for step, want in runs["one_logits"].items():
        np.testing.assert_allclose(got["logits"][step], want, rtol=0,
                                   atol=1e-5, err_msg=str(step))
    assert got["plan"].cache_seq_axis is None
    n_layers = tphi.smoke_config().n_layers
    assert got["local_k"] == (n_layers, 2, 64, 1, 16)


def test_mesh_engine_ranks_agree(runs):
    ranks = [r["serve"] for r in runs["train"]]
    for r in ranks[1:]:
        assert r["tokens"] == ranks[0]["tokens"]
        assert r["digests"] == ranks[0]["digests"]
        for step, v in ranks[0]["logits"].items():
            assert r["logits"][step].tobytes() == v.tobytes(), step
    for r in runs["others"][1:]:
        assert {k: v["tokens"] for k, v in r["serve"].items()} == \
            {k: v["tokens"] for k, v in runs["others"][0]["serve"].items()}


def test_serving_restore_on_the_same_mesh_is_bit_identical(runs):
    """Kill -> restore of step 6 onto (2, 2): the saved cache digest,
    every request's tokens and every later step's logits bit for bit."""
    run = runs["train"][0]["serve"]
    got = run["restore"]
    assert got["step"] == R.SERVE_AT
    assert got["digest"] == run["digests"][R.SERVE_AT]
    assert got["tokens"] == run["tokens"]
    assert sorted(got["logits"]) == [s for s in sorted(run["logits"])
                                     if s > R.SERVE_AT]
    for step, v in got["logits"].items():
        assert v.tobytes() == run["logits"][step].tobytes(), step


@pytest.mark.parametrize("target", ["(1, 4) eager", "(4, 1) streamed"])
def test_serving_checkpoint_restores_onto_another_mesh(runs, target):
    """The (2, 2) checkpoint of step 6 onto (1, 4) — 2 KV heads over 4
    model ranks: the cache's sequence splits and decode combines the
    ranks' partial softmaxes — and onto (4, 1), streamed, one slot a data
    rank: the saved cache digest, the uninterrupted tokens."""
    run = runs["train"][0]["serve"]
    got = runs["others"][0]["serve"][target]
    assert got["step"] == R.SERVE_AT
    assert got["digest"] == run["digests"][R.SERVE_AT]
    assert len(got["tokens"]) == len(run["tokens"])
    assert got["tokens"] == run["tokens"]


def test_reslot_onto_a_mesh_carries_each_sessions_column(runs):
    """4 -> 3 slots on (2, 2) (3 slots do not split over 2 data ranks:
    every data rank holds them all): each former session lands with its
    checkpointed column and finishes with the uninterrupted tokens."""
    got = runs["others"][0]["serve"]["(2, 2) re-slotted"]
    assert got["n_slots"] == 3
    assert got["tokens"] == runs["train"][0]["serve"]["tokens"]


def test_jax_serving_checkpoint_restores_onto_a_mesh(runs):
    got = runs["others"][0]["serve"]["jax"]
    assert got["step"] == R.SERVE_AT
    assert got["tokens"] == runs["jax_tokens"]


def test_mesh_serving_checkpoint_restores_in_the_jax_engine(runs):
    want = runs["train"][0]["serve"]["tokens"]
    assert runs["serve_in_jax"] == want


def test_sequence_split_combine_matches_whole_cache_attention(runs):
    c = {k: torch.from_numpy(np.asarray(v)) for k, v in runs["case"].items()}
    want = dense_attention(c["q"], c["k"], c["v"], c["q_pos"], c["kv_pos"],
                           window=int(runs["case"]["window"])).numpy()
    for r in runs["others"]:
        np.testing.assert_allclose(r["combine"], want, rtol=0, atol=1e-6)


def test_moe_engine_over_a_mesh_gives_the_one_device_tokens(runs):
    """The moe decoder's decode and admission prefill through the
    expert-parallel branch (``moe._moe_forward_mesh``): the one-device
    engine's tokens, every step's logits within 1e-5."""
    tokens, logits = runs["moe_one"]
    for r in runs["others"]:
        got = r["moe_serve"]
        assert got["local_experts"] == tkimi.smoke_config().n_experts // 2
        assert got["tokens"] == tokens
        assert sorted(got["logits"]) == sorted(logits)
        for step, want in logits.items():
            np.testing.assert_allclose(got["logits"][step], want, rtol=0,
                                       atol=1e-5, err_msg=str(step))


@pytest.mark.parametrize("fn", ["prefill", "decode_step"])
@pytest.mark.parametrize("arch", R.FAMILY_ARCHS)
def test_other_families_refuse_serving_over_a_mesh(runs, arch, fn):
    """The ssm, hybrid and encoder-decoder families raise on DTensor
    tokens, naming the ROADMAP step they wait for."""
    msg = runs["others"][0]["family_raises"][(arch, fn)]
    assert msg is not None and "A9b step 4" in msg, msg


# --- the failure loop over a mesh (A9b step 2) -------------------------------

def test_supervised_shrink_onto_a_smaller_mesh(runs):
    """The port of ``tests/test_supervisor.py::
    test_shrink_onto_smaller_mesh_multidevice``: every rank runs the
    supervisor over hosts 0-3 on the (2, 2) checkpoint; host 3 dies and
    the shrink restores onto (2, 1) over ranks 0-1 with the decision's
    rewrite: the saved digest bit for bit, a data assignment of the
    survivors only, and the next loss within 1e-5 of the same
    checkpoint restored on one device."""
    r = runs["train"][0]
    for rank in (0, 1):
        got = runs["train"][rank]["supervise"]["shrink"]
        assert got["action"] == "shrink" and got["hosts"] == [0, 1, 2]
        assert got["step"] == r["step"] and got["digest"] == r["digest"]
        assert got["mesh"] == (2, 1) and got["ranks"] == [0, 1]
        assert {h for h, _ in got["assignment"]} <= {0, 1, 2}
        assert {s for _, s in got["assignment"]} == set(range(4))
        np.testing.assert_allclose(got["loss"], runs["on_one"]["loss"],
                                   rtol=1e-5)


def test_ranks_outside_the_survivors_mesh_hold_nothing(runs):
    """After the shrink, ranks 2-3 stand outside the (2, 1) mesh: no
    params and no moments, while ranks 0-1 hold the state between them
    (each up to half: the leaves the model axis shards split over two
    ranks instead of four); the grow spreads it over every rank again."""
    sup = [x["supervise"] for x in runs["train"]]
    held = [x["shrink"]["held"] for x in sup]
    assert [x["shrink"]["outside"] for x in sup] == [False, False, True,
                                                     True]
    assert held[2] == held[3] == 0 and held[0] == held[1] > 0
    grown = [x["grow"]["held"] for x in sup]
    assert len(set(grown)) == 1 and grown[0] < held[0] <= 2 * grown[0]


def test_supervised_grow_back_onto_the_whole_mesh(runs):
    """Host 3 returns: ``grow`` restores the (2, 1) mesh's snapshot onto
    (2, 2) over every rank with the saved digest, and its next loss lies
    within 1e-5 of that snapshot's on one device."""
    want = runs["grow_want"]
    saved = runs["train"][0]["supervise"]["shrink"]["saved"]
    assert want["digest"] == saved
    for x in runs["train"]:
        got = x["supervise"]["grow"]
        assert got["action"] == "grow" and got["hosts"] == [0, 1, 2, 3]
        assert got["step"] == 3 and got["mesh"] == (2, 2)
        assert got["digest"] == saved
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)


def test_supervised_restart_continues_bit_for_bit(runs):
    """The last host of a one-host world dies: a restart onto the same
    (2, 2) mesh from the latest step, whose next loss and state digest
    are the uninterrupted run's bits."""
    for x in runs["train"]:
        sup = x["supervise"]
        got, want = sup["restart"], sup["grow"]
        assert got["action"] == "restart_last_ckpt" and got["step"] == 3
        assert got["mesh"] == (2, 2)
        assert got["loss"] == want["loss"] and got["state"] == want["state"]


@pytest.mark.parametrize("launch", ["train", "engine"])
def test_every_rank_takes_the_same_decisions(runs, launch):
    """Every rank logs the same incidents — action, dead hosts, step and
    the mesh the runner came back on — and reads the same latest
    restorable step."""
    if launch == "train":
        sups = [x["supervise"] for x in runs["train"]]
        assert sups[0]["incidents"] == [
            ("shrink", [3], 2, (2, 1)), ("grow", [], 3, (2, 2)),
            ("restart_last_ckpt", [0], 3, (2, 2))]
        assert sups[0]["restorable"] == [2, 3, 3]
    else:
        sups = [x["supervise_engine"] for x in runs["train"]]
        assert sups[0]["incidents"] == [("shrink", [3], SUP_KILL_AT,
                                         (1, 2))]
    for x in sups[1:]:
        assert x["incidents"] == sups[0]["incidents"]
        assert x.get("restorable") == sups[0].get("restorable")


def test_supervised_mesh_engine_shrinks_token_for_token(runs):
    """The (2, 2) engine of 4 slots loses host 3: the shrink re-slots its
    sessions onto 3 slots of a (1, 2) mesh over ranks 0-1 (ranks 2-3
    hold nothing), and every request finishes with the one-device
    supervised engine's tokens, which are the uninterrupted run's and
    the JAX engine's."""
    assert runs["sup_one"] == runs["sup_plain"] == runs["sup_jax"]
    got = [x["supervise_engine"] for x in runs["train"]]
    assert [x["outside"] for x in got] == [False, False, True, True]
    for x in got[:2]:
        assert x["action"] == "shrink" and x["step"] == SUP_KILL_AT
        assert x["n_slots"] == 3 and x["mesh"] == (1, 2)
        assert x["tokens"] == runs["sup_one"]


def test_session_columns_of_a_mesh_engine(runs):
    """``session_columns`` on the (2, 2) engine restored at step 6: each
    live slot's column whole on rank 0 (batch axis 1), bit for bit the
    one-device engine's from the same checkpoint; nothing elsewhere."""
    want = runs["columns_one"]
    moves = [x["serve"]["move"] for x in runs["train"]]
    got = moves[0]["columns"]
    assert sorted(got) == sorted(want) and want
    for rid, col in want.items():
        assert sorted(got[rid]) == sorted(col)
        for path, v in col.items():
            assert v.shape[0] == tphi.smoke_config().n_layers
            assert got[rid][path].shape == v.shape, path
            assert got[rid][path].tobytes() == v.tobytes(), (rid, path)
    assert all(m["columns"] == {} for m in moves[1:])


def test_move_off_a_mesh_engine_finishes_token_for_token(runs):
    """``migrate_sessions`` from the (2, 2) engine onto a one-device
    engine on rank 0: every session leaves every rank's source, each
    begun one lands with its column, and all of them finish with the
    uninterrupted tokens."""
    moves = [x["serve"]["move"] for x in runs["train"]]
    want = runs["train"][0]["serve"]["tokens"]
    m = moves[0]
    assert m["carried"] == len(runs["columns_one"])
    assert sorted(m["tokens"]) == sorted(m["moved"])
    assert m["tokens"] == {rid: want[rid] for rid in m["moved"]}
    for x in moves:
        assert x["moved"] == m["moved"] and x["left"] == 0


def _launcher_lines(out):
    incidents = re.findall(r"\[supervisor\] incident (\S+): dead=(\[[^\]]*\]) "
                           r"step=(\S+)", out)
    hosts = re.findall(r"step +(\d+) loss \S+ hosts (\[[^\]]*\])", out)
    return incidents, hosts


def test_mesh_launcher_supervise_matches_one_device(runs):
    """``launch.train`` with ``--supervise`` on (2, 2): rank 0 prints the
    one-device run's incident line and hosts per step, the other ranks
    print nothing, and every step's loss lies within 1e-5 of the
    one-device run's."""
    one_out, one_losses = runs["launch_one"]
    got = [x["launcher"] for x in runs["train"]]
    inc, hosts = _launcher_lines(got[0]["out"])
    assert inc == [("shrink", "[2]", "4")]
    assert (inc, hosts) == _launcher_lines(one_out)
    assert "mesh=(2, 2)" in got[0]["out"]
    assert all(x["out"] == "" for x in got[1:])
    for x in got:
        assert [s for s, _ in x["losses"]] == [s for s, _ in one_losses]
        np.testing.assert_allclose([v for _, v in x["losses"]],
                                   [v for _, v in one_losses], rtol=1e-5)
