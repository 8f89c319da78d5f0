"""The port's training path on the CPU against the JAX package.

The same seeded inputs go through both packages: data batches (bit for
bit), the LR schedule (to 1 float32 ulp), the AdamW update (f32 and
int8 moments), the training forward, three train steps of two smoke
models against the JAX package's pure step function (the JAX
``Trainer`` itself fails on jax 0.9's Explicit-axis meshes, ROADMAP C4),
and the planner. Then the port's own C/R: kill -> ``restore("latest")``
-> continue with an identical digest, and training chains restored
across packages to identical bytes in both directions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import registry as jreg
from repro.core import CheckpointManager as JManager
from repro.core import LowerHalf as JLower
from repro.core import UpperHalf as JUpper
from repro.core.backends.localfs import LocalFSBackend as JBackend
from repro.data.pipeline import DataConfig as JData
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.models import model as JM
from repro.optim import AdamWConfig as JAdamW
from repro.optim import QMoment as JQMoment
from repro.optim import ScheduleConfig as JSchedule
from repro.optim import apply_updates as japply
from repro.optim import init_opt_state as jinit_opt
from repro.optim import schedule_lr as jschedule_lr
from repro.parallel.planner import make_plan as jmake_plan
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.api import CheckpointSession, Policy
from repro_torch.api.registry import resolve_app_kind
from repro_torch.configs import registry as treg
from repro_torch.core.backends.localfs import LocalFSBackend
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import model as M
from repro_torch.optim import (AdamWConfig, QMoment, ScheduleConfig,
                               apply_updates, init_opt_state, schedule_lr)
from repro_torch.parallel import planner
from repro_torch.parallel.planner import make_plan
from repro_torch.train import loop as tloop
from repro_torch.train import step as S
from repro_torch.train.loop import Trainer, TrainJob
from repro_torch.tree import flatten_with_paths

SHAPE = "train_s16_b4"
MESH = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bytes(v) -> bytes:
    return np.ascontiguousarray(np.asarray(v)).tobytes()


def _jax_tree_np(tree):
    return jax.tree.map(np.asarray, tree)


# --- data, schedule, optimizer ------------------------------------------------

@pytest.mark.parametrize("frames", [0, 3])
@pytest.mark.parametrize("cursor", [0, 1, 7, 123456])
def test_pipeline_batches_are_bit_identical(cursor, frames):
    kw = dict(seed=1234, vocab_size=49152, seq_len=64, global_batch=4,
              n_shards=4, frames=frames, frame_dim=8 if frames else 0)
    want = JPipeline(JData(**kw)).batch_at(cursor)
    got = TokenPipeline(DataConfig(**kw)).batch_at(cursor)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("kind", ["warmup_cosine", "warmup_linear",
                                  "constant"])
def test_schedule_lr_within_one_f32_ulp(kind):
    steps = list(range(0, 260)) + [5000, 9899, 9999, 10000, 12345]
    cfgs = (JSchedule(kind=kind), ScheduleConfig(kind=kind))
    want = np.array([np.float32(jschedule_lr(cfgs[0], s)) for s in steps])
    got = np.array([schedule_lr(cfgs[1], s).numpy() for s in steps])
    assert got.dtype == np.float32
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    lr_scaled = schedule_lr(cfgs[1], 150, {"lr_scale": 0.5})
    assert float(lr_scaled) == float(np.float32(
        jschedule_lr(cfgs[0], 150, {"lr_scale": 0.5})))


def _opt_inputs(seed):
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(3, 8, 300).astype(np.float32),   # stacked
              "m": rng.randn(16, 40).astype(np.float32),
              "b": rng.randn(40).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 0.1).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("quantize", [False, True])
def test_apply_updates_matches_jax(quantize):
    """Three AdamW steps (f32 or int8 moments, a stacked leaf updated
    slice by slice) from the same inputs. Tolerances: f32 1e-6 — the
    same elementwise ops, but the JAX step is one fused XLA program and
    pow/sqrt may differ in the last bit; int8 moments within one
    quantization level of each other, since such a last-bit difference
    can move a value across a rounding boundary."""
    params, grads = _opt_inputs(0)
    jcfg, tcfg = JAdamW(quantize_moments=quantize), \
        AdamWConfig(quantize_moments=quantize)
    jp = jax.tree.map(jnp.asarray, params)
    js = jinit_opt(jp, jcfg)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = init_opt_state(tp, tcfg)
    for i, g in enumerate(grads):
        lr = np.float32(1e-2 * (i + 1))
        jp, js, jm = japply(jp, jax.tree.map(jnp.asarray, g), js, jcfg,
                            jnp.float32(lr))
        tp, ts, tm = apply_updates(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts, tcfg,
            torch.tensor(lr))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(ts["count"]) == int(js["count"]) == 3
    for k in params:
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), rtol=1e-6,
                                   atol=1e-6)
        for mom in ("mu", "nu"):
            a, b = ts[mom][k], js[mom][k]
            if quantize:
                assert isinstance(a, QMoment) and isinstance(b, JQMoment)
                np.testing.assert_allclose(_np(a.scale), _np(b.scale),
                                           rtol=1e-6)
                assert np.abs(a.q.numpy().astype(int)
                              - np.asarray(b.q).astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5,
                                           atol=1e-9)


def test_opt_state_paths_and_conversion_match_jax():
    """opt_state keeps the JAX package's keystr paths (QMoment leaves
    as ``.q``/``.scale``, the 0-d ``count``), and a JAX state carried
    across with ``convert`` keeps its bits."""
    from repro.core.split_state import flatten_with_paths as jflat
    params, _ = _opt_inputs(1)
    for quantize in (False, True):
        js = _jax_tree_np(jinit_opt(jax.tree.map(jnp.asarray, params),
                                    JAdamW(quantize_moments=quantize)))
        ts = convert.opt_state_from_numpy(js, "cpu")
        jpaths = [(p, v.shape, str(v.dtype)) for p, v in jflat(js)]
        tpaths = [(p, tuple(v.shape), str(v.dtype).replace("torch.", ""))
                  for p, v in flatten_with_paths(ts)]
        assert tpaths == jpaths
        back = convert.tree_to_numpy(ts)
        assert [(p, _bytes(v)) for p, v in flatten_with_paths(back)] == \
            [(p, _bytes(v)) for p, v in jflat(js)]
        assert back["count"].shape == ()


@pytest.mark.parametrize("quantize", [False, True])
def test_train_state_structure_matches_jax(quantize):
    """What a training snapshot's manifest records about its state —
    leaf shapes, dtype strings and logical axes of params and
    opt_state — is the JAX package's, with f32 or int8 moments."""
    from repro.core import UpperHalf as JUpperHalf
    from repro.optim import opt_logical_specs as jopt_logical
    from repro_torch.core.split_state import UpperHalf
    from repro_torch.optim import opt_logical_specs
    cfg = jreg.get_smoke_config("starcoder2-3b")
    jparams = JM.init_params(cfg, jax.random.PRNGKey(0))
    jopt = jinit_opt(jparams, JAdamW(quantize_moments=quantize))
    want = JUpperHalf()
    want.register("params", "params", jparams, JM.logical_specs(cfg))
    want.register("opt_state", "opt_state", jopt, jopt_logical(
        JM.logical_specs(cfg), JAdamW(quantize_moments=quantize)))
    tcfg = treg.get_smoke_config("starcoder2-3b")
    got = UpperHalf()
    got.register("params", "params", convert.params_from_numpy(
        _jax_tree_np(jparams), "cpu"), M.logical_specs(tcfg))
    got.register("opt_state", "opt_state", convert.opt_state_from_numpy(
        _jax_tree_np(jopt), "cpu"), opt_logical_specs(
        M.logical_specs(tcfg), AdamWConfig(quantize_moments=quantize)))
    assert got.structure() == want.structure()


# --- model forward ------------------------------------------------------------

@pytest.mark.parametrize("arch", ["starcoder2-3b", "phi4-mini-3.8b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_logits_match_jax(arch, dtype):
    jcfg = jreg.get_smoke_config(arch).replace(dtype=dtype)
    tcfg = treg.get_smoke_config(arch).replace(dtype=dtype)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(_jax_tree_np(jparams), "cpu")
    toks = np.random.RandomState(2).randint(0, jcfg.vocab_size,
                                            (2, 24)).astype(np.int32)
    want, _ = JM.forward_train(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    for remat in ("none", "full"):
        got, aux = M.forward_train(tcfg, params,
                                   {"tokens": torch.from_numpy(toks)},
                                   M.CallOptions(remat=remat))
        assert got.dtype == (torch.float32 if dtype == "float32"
                             else torch.bfloat16)
        a, b = _np(got), _np(want)
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        else:   # bf16 rounds at other places in the two frameworks (C8)
            assert np.linalg.norm(a - b) / np.linalg.norm(b) < 2e-2
        assert float(aux["moe_aux"]) == 0.0


def test_other_families_name_their_roadmap_item():
    """Every family the port runs now trains (the hybrid's step builds);
    what one card cannot hold names its roadmap item: full-depth
    recurrentgemma-9b's params and f32 moments past an 80 GB card's
    budget raise before anything is allocated, naming A9."""
    cfg = treg.get_smoke_config("recurrentgemma-9b")
    assert callable(S.make_train_step(
        cfg, make_plan(cfg, treg.get_shape("train_s16_b4")), AdamWConfig(),
        ScheduleConfig()))
    with pytest.raises(MemoryError, match="A9"):
        planner.card_plan(treg.resolve_config("recurrentgemma-9b"),
                          treg.get_shape("train_s4096_b2"), 80e9)


def test_a_depth_cut_arch_keeps_the_published_width():
    """``<id>-layers<N>``: the published config cut to N layers, the
    string a depth-cut job's checkpoint carries and its restore
    resolves; anything past the published depth is refused."""
    full = treg.resolve_config("starcoder2-3b")
    cut = treg.resolve_config("starcoder2-3b-layers15")
    assert cut == full.replace(n_layers=15) and cut.n_layers == 15
    assert cut.d_model == full.d_model and cut.vocab_size == full.vocab_size
    planned = treg.get_shape("train_s4096_b2")
    assert make_plan(cut, planned).remat == make_plan(full, planned).remat
    for bad in ("starcoder2-3b-layers0", "starcoder2-3b-layers31",
                "nope-layers2", "starcoder2-3b-layersx"):
        with pytest.raises(KeyError, match="layers"):
            treg.resolve_config(bad)


def test_a_depth_cut_checkpoint_restores_in_the_port_only(tmp_path):
    """ROADMAP C17: the JAX package resolves no ``<id>-layers<N>`` arch,
    so a training checkpoint written under one restores in the port
    (its op-log replays the cut model's train step) and the JAX package
    refuses it, naming the arch, before it builds any model."""
    from repro.api import CheckpointSession as JSession
    from repro_torch.core.incarnation import Incarnation
    from repro_torch.core.split_state import LowerHalf, UpperHalf
    arch, shape = "starcoder2-3b-layers15", "train_s4096_b2"
    lower = LowerHalf(mesh_factory=lambda: torch.device("cpu"))
    lower.mesh_create((1, 1), ("data", "model"))
    lower.compile_step("train_step", arch, shape, "")
    up = UpperHalf()
    up.register("step", "step", np.int64(1))
    tm = CheckpointManager(LocalFSBackend(str(tmp_path)), async_save=False)
    tm.save(1, up, lower.oplog, job_meta={
        "kind": "train", "arch": arch, "shape_key": shape, "plan_key": "",
        "init_seed": 0, "data_seed": 1234})
    tm.close()
    inc = Incarnation(CheckpointManager(LocalFSBackend(str(tmp_path))),
                      step=1, mesh_factory=lambda: torch.device("cpu"))
    inc.materialize()
    inc.build_lower()
    assert inc.last_compile("train_step") is not None
    with pytest.raises(KeyError, match="layers15"):
        jreg.resolve_config(arch)
    with pytest.raises(KeyError, match="layers15"):
        JSession(f"localfs:{tmp_path}").restore("latest",
                                                expect_kind="train")


# --- train steps against the pure JAX step function -------------------------

def _jax_step(cfg, shape, accum):
    plan = jmake_plan(cfg, shape, MESH).with_(grad_accum=accum)
    return jax.jit(jstep.make_train_step(cfg, plan, JAdamW(), JSchedule(),
                                         mesh=None))


@pytest.mark.parametrize("arch,accum", [("starcoder2-3b", 1),
                                        ("phi4-mini-3.8b", 1),
                                        ("starcoder2-3b", 2)])
def test_three_train_steps_match_the_jax_step(arch, accum):
    """Three f32 steps from the same params and batches. Loss and
    grad_norm to 1e-5 relative (the same math summed in another order
    by XLA and by PyTorch's CPU kernels); params to 1e-6 absolute (lr is
    at most 6e-6 in these warmup steps, so a step moves a param by
    ~1e-6); mu and nu to 1e-4 relative, 1e-7 absolute (they carry the
    gradients' own relative differences)."""
    jcfg = jreg.get_smoke_config(arch).replace(dtype="float32")
    tcfg = treg.get_smoke_config(arch).replace(dtype="float32")
    shape = jreg.get_shape(SHAPE)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    jopt = jinit_opt(jparams, JAdamW())
    params = convert.params_from_numpy(_jax_tree_np(jparams), "cpu")
    opt = init_opt_state(params, AdamWConfig())
    tstep = S.make_train_step(
        tcfg, make_plan(tcfg, treg.get_shape(SHAPE)).with_(
            grad_accum=accum), AdamWConfig(), ScheduleConfig())
    jfn = _jax_step(jcfg, shape, accum)
    pipe = TokenPipeline(DataConfig(seed=5, vocab_size=tcfg.vocab_size,
                                    seq_len=16, global_batch=4, n_shards=4))
    for step in range(3):
        batch = pipe.batch_at(step)
        jparams, jopt, jm = jfn(jparams, jopt,
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                jnp.int32(step), jnp.float32(1.0))
        params, opt, tm = tstep(params, opt,
                                {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                                step, torch.tensor(1.0))
        for key in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
        assert tm["step"] == int(jm["step"]) == step + 1
    for (path, a), (_, b) in zip(flatten_with_paths(params),
                                 flatten_with_paths(
                                     convert.tree_to_numpy(
                                         _jax_tree_np(jparams)))):
        np.testing.assert_allclose(_np(a), b, rtol=0, atol=1e-6,
                                   err_msg=path)
    jo = _jax_tree_np(jopt)
    for mom in ("mu", "nu"):
        for (path, a), (_, b) in zip(flatten_with_paths(opt[mom]),
                                     flatten_with_paths(jo[mom])):
            np.testing.assert_allclose(_np(a), b, rtol=1e-4, atol=1e-7,
                                       err_msg=mom + path)
    assert int(opt["count"]) == int(jo["count"]) == 3


def test_eval_step_and_input_specs():
    cfg = treg.get_smoke_config("starcoder2-3b")
    shape = treg.get_shape(SHAPE)
    specs = S.train_input_specs(cfg, shape)
    assert specs["tokens"] == M.TensorSpec((4, 16), torch.int32)
    params = M.init_params(cfg, seed=0, device="cpu")
    batch = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in specs.items()}
    out = S.make_eval_step(cfg, make_plan(cfg, shape))(params, batch)
    assert set(out) == {"loss", "ce", "moe_aux"}
    assert np.isfinite(float(out["loss"]))


@pytest.mark.parametrize("arch", ["starcoder2-3b", "phi4-mini-3.8b",
                                  "qwen2.5-32b", "whisper-base",
                                  "starcoder2-3b-smoke"])
@pytest.mark.parametrize("shape", ["train_s4096_b2", "train_4k",
                                   "train_s16_b4", "train_s2048_b16"])
def test_make_plan_matches_jax_on_one_device(arch, shape):
    want = jmake_plan(jreg.resolve_config(arch), jreg.get_shape(shape), MESH)
    got = make_plan(treg.resolve_config(arch), treg.get_shape(shape))
    assert (got.grad_accum, got.remat) == (want.grad_accum, want.remat)


def test_make_plan_refuses_serving_shapes():
    """Serving shapes no longer raise (ROADMAP A9b step 1): on one device
    a decode shape gets the reference's serving plan."""
    want = jmake_plan(jreg.resolve_config("starcoder2-3b"),
                      jreg.get_shape("decode_32k"), MESH)
    got = make_plan(treg.resolve_config("starcoder2-3b"),
                    treg.get_shape("decode_32k"))
    assert (got.rules, got.remat, got.cache_seq_axis, got.notes) == \
        (want.rules, want.remat, want.cache_seq_axis, want.notes)


# --- the port's trainer: kill -> restore -> continue -----------------------------

ARCH = "starcoder2-3b-smoke"
SMALL = dict(sparse_chunk_bytes=1024, sparse_min_bytes=2048)


@pytest.mark.parametrize("label,policy", [
    ("chain2", Policy(interval=2, chain=2, **SMALL)),
    ("chain1", Policy(interval=2, chain=1)),
    ("dense", Policy(interval=2, chain=2, sparse=False)),
])
def test_trainer_kill_restore_continues_bit_identically(tmp_path, label,
                                                        policy):
    sess = CheckpointSession(f"localfs:{tmp_path}", policy)
    t = Trainer(TrainJob(ARCH, SHAPE), manager=sess.manager, device="cpu")
    t.init_state()
    sess.attach(t)
    losses = []
    for _ in range(7):
        losses.append(t.train_steps(1)["loss"])
        sess.maybe_snapshot()
    sess.wait()
    want = t.state_digest()
    want_params = t.params_digest()
    assert sess.restorable_steps() == [2, 4, 6]
    sess.close()
    del t                                        # the kill
    sess2 = CheckpointSession(f"localfs:{tmp_path}", policy)
    t2 = sess2.restore("latest", expect_kind="train", device="cpu")
    assert isinstance(t2, Trainer) and sess2.app is t2
    assert t2.checkpoint_step() == 6
    assert int(t2.upper.get("data_cursor")) == 6
    assert t2.train_steps(1)["loss"] == losses[6]
    assert t2.state_digest() == want
    assert t2.params_digest() == want_params
    assert t2.incarnation.timings["materialize_s"] >= 0
    sess2.close()


def test_train_kind_resolves_to_the_port_binder():
    assert resolve_app_kind("train") is tloop._restore_trainer


def test_trainer_logs_its_runtime_and_replays_it(tmp_path):
    """job_meta is the JAX package's; a restore replays the logged
    device, step build and data advances, and a logged reassignment."""
    sess = CheckpointSession(f"localfs:{tmp_path}", Policy(interval=1))
    t = Trainer(TrainJob(ARCH, SHAPE, init_seed=3, data_seed=9),
                manager=sess.manager, device="cpu")
    t.init_state()
    sess.attach(t)
    assert t.job_meta() == {"kind": "train", "arch": ARCH,
                            "shape_key": SHAPE, "plan_key": "",
                            "init_seed": 3, "data_seed": 9}
    t.apply_reassignment([(0, 0), (0, 1), (1, 2), (1, 3)])
    t.train(2, snapshot_every=1)
    sess.close()
    t2 = CheckpointSession(f"localfs:{tmp_path}").restore(device="cpu")
    assert t2.lower.data_cursor_replayed == 2
    assert t2.pipeline.assignment == [(0, 0), (0, 1), (1, 2), (1, 3)]
    assert t2.device == torch.device("cpu")
    assert t2.state_digest() == t.state_digest()


# --- training chains across packages ------------------------------------------

def _assert_same_entries(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        assert sorted(a[name]) == sorted(b[name]), name
        for path in a[name]:
            x, y = a[name][path], b[name][path]
            assert tuple(np.shape(x)) == tuple(np.shape(y)), (name, path)
            assert _bytes(x) == _bytes(y), (name, path)


def test_port_training_chain_restores_bit_identically_under_jax(tmp_path):
    sess = CheckpointSession(f"localfs:{tmp_path}",
                             Policy(interval=2, chain=2, **SMALL))
    t = Trainer(TrainJob(ARCH, SHAPE), manager=sess.manager, device="cpu")
    t.init_state()
    sess.attach(t)
    live = {}
    for _ in range(6):
        t.train_steps(1)
        if sess.maybe_snapshot() is not None:
            live[t.checkpoint_step()] = {
                e: dict(flatten_with_paths(
                    convert.tree_to_numpy(t.upper.get(e))))
                for e in ("params", "opt_state")}
    sess.close()
    jm = JManager(JBackend(str(tmp_path)))
    tm = CheckpointManager(LocalFSBackend(str(tmp_path)))
    steps = jm.backend.list_steps()
    assert steps == [2, 4, 6]
    assert jm.backend.get_manifest(4)["base_step"] == 2
    for step in steps:
        jr, tr = jm.restore(step), tm.restore(step)
        _assert_same_entries(jr.entries, tr.entries)
        for e, leaves in live[step].items():
            for path, want in leaves.items():
                assert _bytes(jr.entries[e][path]) == _bytes(want)
        assert int(jr.entries["step"][""]) == step
    for m in (jm, tm):
        m.close()


def test_jax_training_chain_restores_bit_identically_under_the_port(
        tmp_path):
    """A chain written by the JAX package's CheckpointManager from the
    pure JAX step (params, opt_state and a logged op-log: device,
    Compile("train_step"), data advances) comes back in the port with
    the same bytes, and the port trainer steps on from it."""
    cfg = jreg.resolve_config(ARCH)
    shape = jreg.get_shape(SHAPE)
    jfn = _jax_step(cfg, shape, 1)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    opt = jinit_opt(params, JAdamW())
    lower = JLower(mesh_factory=lambda: MESH)
    lower.mesh_create((1, 1), ("data", "model"))
    lower.compile_step("train_step", ARCH, SHAPE, "")
    jm = JManager(JBackend(str(tmp_path)), async_save=False,
                  delta_base_interval=2)
    pipe = JPipeline(JData(seed=1234, vocab_size=cfg.vocab_size, seq_len=16,
                           global_batch=4, n_shards=4))
    meta = {"kind": "train", "arch": ARCH, "shape_key": SHAPE,
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
    assert t.lower.data_cursor_replayed == 4
    loss = t.train_steps(1)["loss"]
    batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(4).items()}
    _, _, jmet = jfn(params, opt, batch, jnp.int32(4), jnp.float32(1.0))
    assert abs(loss - float(jmet["loss"])) < 2e-2 * abs(float(jmet["loss"]))
    for m in (jm, tm):
        m.close()
