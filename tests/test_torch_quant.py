"""The int8 snapshot codec of the port against the JAX package.

On the CPU the port's ``quantize`` / ``dequantize`` wrappers run their
plain PyTorch versions (the CUDA kernels are held against those on the
card, ``tests/test_torch_cuda.py`` and ``chip_smoke.py``). They must
give the numpy oracle's bits exactly (``quantize_ref`` /
``dequantize_ref``, in both packages' copies). The JAX package's Pallas
kernels in interpret mode give the same codes, but their scale may sit
one float32 ulp off the oracle's (XLA may divide by 127 as a multiply by
its reciprocal; ``tests/test_kernels.py`` holds them to rtol 1e-6), so
they are held to that: q equal, scale within 1e-6.

Then the codec through the snapshot format: a leaf quantized at capture
(an ``Int8Leaf``) writes the host codec's manifest meta and blobs, a
decoded codec leaf stays coded until it is bound onto its device, and
mamba2-780m-smoke training snapshots taken with ``codecs={"opt_state":
"int8"}`` restore across the two packages in both directions.
"""
import zlib

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
from repro.core import delta as jdelta
from repro.core.backends.localfs import LocalFSBackend as JBackend
from repro.data.pipeline import DataConfig as JData
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.kernels.ckpt_codec import ops as jops
from repro.kernels.ckpt_codec import ref as jref
from repro.models import model as JM
from repro.optim import AdamWConfig as JAdamW
from repro.optim import ScheduleConfig as JSchedule
from repro.optim import init_opt_state as jinit_opt
from repro.parallel.planner import make_plan as jmake_plan
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.api import CheckpointSession, Policy, register_codec
from repro_torch.configs import get_smoke_config as t_smoke_config
from repro_torch.core import delta as tdelta
from repro_torch.core.backends.localfs import LocalFSBackend
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.oplog import OpLog
from repro_torch.core.split_state import UpperHalf
from repro_torch.host import dtype_name, nbytes, numel, to_tensor
from repro_torch.kernels.ckpt_codec import ops
from repro_torch.kernels.ckpt_codec import ref as tref
from repro_torch.train.loop import Trainer, TrainJob
from repro_torch.tree import flatten_with_paths

ARCH = "mamba2-780m-smoke"
SHAPE = "train_s16_b4"
MESH = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
CODEC = {"opt_state": "int8"}


def _ties() -> np.ndarray:
    """Two blocks whose amax makes the scale exact (1.0 and 3.0), with
    codes that land on exact halves: half to even must show."""
    x = np.zeros(512, np.float32)
    x[0] = 127.0
    x[1:11] = [0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 3.5, -3.5, 126.5, -126.5]
    x[256] = 381.0
    x[257:262] = [1.5, 4.5, -7.5, 10.5, -379.5]
    return x


def _case(name: str) -> np.ndarray:
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    if name == "exact":
        return (rng.randn(4, 512) * 3).astype(np.float32)
    if name == "ragged":                     # numel and nb both odd
        return (rng.randn(70001) * 3).astype(np.float32)
    if name == "zeros":                      # fresh moments
        return np.zeros((3, 300), np.float32)
    if name == "mixed_zero_blocks":
        x = (rng.randn(2048) * 1e3).astype(np.float32)
        x[256:768] = 0.0
        return x
    if name == "ties":
        return _ties()
    if name == "adamw_nu":                   # non-negative, ~1e-14..1e-6
        return np.exp(rng.uniform(np.log(1e-14), np.log(1e-6),
                                  size=9000)).astype(np.float32)
    if name == "tiny_and_subnormal":
        return (rng.randn(1000) * 1e-39).astype(np.float32)
    if name == "float16":
        return (rng.randn(3000) * 5).astype(np.float16)
    if name == "float64":
        return rng.randn(2, 777) * 3.0
    raise KeyError(name)


CASES = ["exact", "ragged", "zeros", "mixed_zero_blocks", "ties",
         "adamw_nu", "tiny_and_subnormal", "float16", "float64"]


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


@pytest.mark.parametrize("case", CASES)
def test_plain_quantize_is_the_oracle_bit_for_bit(case):
    x = _case(case)
    ops.reset_counts()
    q, scale = ops.quantize(torch.from_numpy(x.copy()))
    assert ops.counts("cpu")["quantize"] == 1
    assert ops.counts("cuda")["quantize"] == 0
    for oracle in (tref.quantize_ref, jref.quantize_ref):
        qr, sr = oracle(x)
        assert q.dtype == torch.int8 and scale.dtype == torch.float32
        assert tuple(q.shape) == qr.shape and tuple(scale.shape) == sr.shape
        assert _bits(q.numpy()) == _bits(qr)
        assert _bits(scale.numpy()) == _bits(sr)
    if case == "ties":
        assert q[0, :11].tolist() == [127, 0, 0, 2, -2, 2, -2, 4, -4,
                                      126, -126]
        assert q[1, :6].tolist() == [127, 0, 2, -2, 4, -126]


@pytest.mark.parametrize("case", CASES)
def test_plain_dequantize_is_the_oracle_bit_for_bit(case):
    qr, sr = tref.quantize_ref(_case(case))
    got = ops.dequantize(torch.from_numpy(qr), torch.from_numpy(sr))
    assert _bits(got.numpy()) == _bits(tref.dequantize_ref(qr, sr))
    assert _bits(got.numpy()) == _bits(jref.dequantize_ref(qr, sr))


@pytest.mark.parametrize("case", CASES)
def test_plain_versions_against_the_pallas_kernels_in_interpret_mode(case):
    x = _case(case)
    q, scale = ops.quantize(torch.from_numpy(x.copy()))
    jq, js = jops.quantize(jnp.asarray(x.astype(np.float32)), interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(scale.numpy(), np.asarray(js), rtol=1e-6)
    jd = jops.dequantize(jnp.asarray(q.numpy()), jnp.asarray(scale.numpy()),
                         interpret=True)
    assert _bits(ops.dequantize(q, scale).numpy()) == _bits(np.asarray(jd))


def test_a_nan_block_differs_between_the_oracle_and_the_kernel_rule():
    """Finite input is the contract. With a NaN in a block numpy's max
    keeps the NaN, so the oracle's scale is NaN and its codes are cast
    from NaN; the plain version gives the same here. The CUDA kernel's
    fmaxf drops the NaN instead (ROADMAP C15), which this pins on the
    oracle's side only."""
    x = np.ones(512, np.float32)
    x[3] = np.nan
    with np.errstate(invalid="ignore"):
        qr, sr = tref.quantize_ref(x)
    q, scale = ops.quantize(torch.from_numpy(x))
    assert np.isnan(sr[0]) and np.isnan(scale[0].item())
    assert _bits(q.numpy()[1]) == _bits(qr[1])      # the finite block
    assert sr[1] == scale[1].item() == np.float32(1.0) / np.float32(127.0)


def test_wrappers_refuse_other_devices():
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.quantize(torch.zeros(256, device="meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.dequantize(torch.zeros((1, 256), dtype=torch.int8,
                                   device="meta"),
                       torch.zeros(1, device="meta"))


# ---------------------------------------------------------------------------
# the coded leaf through the snapshot format
# ---------------------------------------------------------------------------

def _coded(x: np.ndarray) -> tdelta.Int8Leaf:
    t = torch.from_numpy(x.copy())
    q, scale = ops.quantize(t)
    return tdelta.Int8Leaf(q, scale, t.shape, dtype_name(t))


@pytest.mark.parametrize("case", ["exact", "ragged", "zeros", "float16",
                                  "float64", "adamw_nu"])
def test_a_precoded_leaf_writes_the_host_codecs_meta_and_blobs(case):
    x = _case(case)
    host_b, pre_b, jax_b = {}, {}, {}
    m_host = tdelta.encode_leaf(torch.from_numpy(x.copy()),
                                host_b.__setitem__, host_b.__contains__,
                                codec="int8")
    m_pre = tdelta.encode_leaf(_coded(x), pre_b.__setitem__,
                               pre_b.__contains__, codec="int8")
    m_jax = jdelta.encode_leaf(x, jax_b.__setitem__, jax_b.__contains__,
                               codec="int8")
    assert m_pre["mode"] == "codec" and m_pre["codec"] == "int8"
    assert m_pre["dtype"] == str(x.dtype) and m_pre["shape"] == list(x.shape)
    for m in (m_host, m_pre, m_jax):
        m.pop("bytes_encoded")
    assert m_pre == m_host == m_jax
    assert pre_b == host_b == jax_b


def test_a_coded_leaf_refuses_another_codec():
    with pytest.raises(ValueError, match="int8-coded"):
        tdelta.encode_leaf(_coded(_case("exact")), {}.__setitem__,
                           {}.__contains__, codec=None)


@pytest.mark.parametrize("case", ["ragged", "float16", "float64"])
def test_a_decoded_codec_leaf_stays_coded_and_reads_as_the_host_decode(case):
    x = _case(case)
    blobs = {}
    meta = tdelta.encode_leaf(x, blobs.__setitem__, blobs.__contains__,
                              codec="int8")
    leaf = tdelta.decode_leaf(meta, blobs.__getitem__)
    assert isinstance(leaf, tdelta.Int8Leaf)
    want = jdelta.decode_leaf(meta, blobs.__getitem__)
    assert np.shape(leaf) == want.shape == x.shape
    assert str(np.asarray(leaf).dtype) == str(want.dtype) == str(x.dtype)
    assert _bits(leaf) == _bits(want)
    # bound onto a device, it is the same values in the template's dtype
    ops.reset_counts()
    t = to_tensor(leaf, torch.float32, torch.device("cpu"))
    assert ops.counts("cpu")["dequantize"] == 1
    assert _bits(t.numpy()) == _bits(want.astype(np.float32))
    assert to_tensor(leaf, torch.float64, "cpu").dtype == torch.float64
    # with no device named it is refused, never decoded on the host
    with pytest.raises(ValueError, match="device"):
        to_tensor(leaf, torch.float32, None)


def test_host_helpers_read_a_coded_leaf_without_decoding_it(monkeypatch):
    leaf = _coded(_case("ragged"))

    def boom(*a, **k):
        raise AssertionError("decoded on the host")

    monkeypatch.setattr(tref, "dequantize_ref", boom)
    assert dtype_name(leaf) == "float32"
    assert numel(leaf) == 70001 and nbytes(leaf) == 4 * 70001
    assert tdelta.codec_applicable(leaf, "int8")


def test_only_the_built_in_int8_codec_runs_where_the_leaf_lives():
    t = torch.ones(512)
    assert tdelta.device_codec(t, "int8")
    assert not tdelta.device_codec(t.numpy(), "int8")       # numpy: host
    assert not tdelta.device_codec(torch.ones(100), "int8")  # too small
    assert not tdelta.device_codec(t.to(torch.bfloat16), "int8")
    assert not tdelta.device_codec(t, None)
    enc, dec = tdelta.CODECS["int8"]
    register_codec("int8_host_copy", lambda a: enc(a), dec)
    try:
        assert not tdelta.device_codec(t, "int8_host_copy")
    finally:
        del tdelta.CODECS["int8_host_copy"]


def test_capture_stages_only_the_codes_and_copies_them(tmp_path):
    """A tensor leaf under the codec is quantized at capture: the stats
    count its codes and scales, not its float32 bytes, and an in-place
    write right after ``save`` returns cannot reach the snapshot."""
    m = torch.from_numpy(_case("ragged").reshape(-1)).clone()
    up = UpperHalf()
    up.register("opt_state", "opt_state", {"m": m})
    mgr = CheckpointManager(LocalFSBackend(str(tmp_path)),
                            codec_by_kind=CODEC)
    ops.reset_counts()
    mgr.save(1, up, OpLog())
    m.mul_(-3.0)                                 # the next optimizer step
    mgr.wait()
    nb = -(-m.numel() // 256)
    assert mgr.stats["capture_bytes"] == nb * 256 + 4 * nb
    assert ops.counts("cpu")["quantize"] == 1
    got = JManager(JBackend(str(tmp_path))).restore(1)
    qr, sr = jref.quantize_ref(_case("ragged"))
    want = jref.dequantize_ref(qr, sr)[:m.numel()]
    assert _bits(got.entries["opt_state"]["['m']"]) == _bits(want)
    mgr.close()


def test_a_coded_serving_cache_is_dequantized_where_the_engine_lives(
        tmp_path):
    """A serving engine snapshotted under ``codecs={"cache": "int8"}``:
    its float32 scan states are quantized at capture, and the restore
    dequantizes them on the engine's own device (one plain call a leaf
    here, the kernel on the card) into ``dequantize(quantize(state))``;
    the restored engine then serves every request to its end."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request, ServingEngine
    arch, policy = "mamba2-780m-smoke", Policy(interval=3, chain=1,
                                               codecs={"cache": "int8"})
    params = M.init_params(t_smoke_config("mamba2-780m"), seed=0, device="cpu")
    sess = CheckpointSession(f"localfs:{tmp_path}", policy)
    eng = ServingEngine.create(arch, params, n_slots=2, max_seq=48,
                               manager=sess.manager, device="cpu")
    sess.attach(eng)
    rng = np.random.RandomState(0)
    for i in range(3):
        eng.submit(Request(rid=i, prompt=rng.randint(0, 256, size=9)
                           .astype(np.int32), max_new=6))
    for _ in range(3):
        eng.step()
    coded = {p: v.clone() for p, v in flatten_with_paths(eng.cache)
             if tdelta.device_codec(v, "int8")}
    assert coded
    ops.reset_counts()
    sess.maybe_snapshot()
    sess.wait()
    assert ops.counts("cpu")["quantize"] == len(coded)
    sess.close()
    del eng
    ops.reset_counts()
    eng2 = CheckpointSession(f"localfs:{tmp_path}", policy).restore(
        "latest", params=params, device="cpu")
    assert ops.counts("cpu")["dequantize"] == len(coded)
    for p, v in flatten_with_paths(eng2.cache):
        if p in coded:
            want = ops.dequantize_plain(*ops.quantize_plain(coded[p]))
            assert _bits(v.numpy()) == _bits(
                want[:v.numel()].view(v.shape).numpy()), p
    live = eng2.live_requests()
    eng2.run_until_drained(max_steps=400)
    assert live and all(r.done and len(r.out) == 6 for r in live)


# ---------------------------------------------------------------------------
# coded training snapshots across the packages
# ---------------------------------------------------------------------------

def _moment_leaves(entries):
    return {p: v for p, v in entries["opt_state"].items()
            if p.startswith(("['mu']", "['nu']"))}


def _assert_coded_moments(entries, moments):
    """Every codec-sized moment restored as dequantize(quantize(m)) of
    ``moments`` (path -> float32 array); the others byte for byte."""
    coded = 0
    for path, m in moments.items():
        got = np.asarray(entries["opt_state"][path])
        if m.size >= 256:
            q, s = jref.quantize_ref(m)
            want = jref.dequantize_ref(q, s)[:m.size].reshape(m.shape)
            coded += 1
        else:
            want = m
        assert _bits(got) == _bits(want), path
    assert coded


def test_port_coded_training_snapshot_restores_under_jax(tmp_path):
    sess = CheckpointSession(f"localfs:{tmp_path}",
                             Policy(interval=2, chain=1, codecs=CODEC))
    t = Trainer(TrainJob(ARCH, SHAPE), manager=sess.manager, device="cpu")
    t.init_state()
    sess.attach(t)
    for _ in range(2):
        t.train_steps(1)
    moments = {p: v.numpy().copy() for p, v in _moment_leaves(
        {"opt_state": dict(flatten_with_paths(t.upper.get("opt_state")))})
        .items()}
    ops.reset_counts()
    sess.maybe_snapshot()
    sess.close()
    n_coded = sum(1 for m in moments.values() if m.size >= 256)
    assert ops.counts("cpu")["quantize"] == n_coded
    jm = JManager(JBackend(str(tmp_path)))
    tm = CheckpointManager(LocalFSBackend(str(tmp_path)))
    jr, tr = jm.restore(2), tm.restore(2)
    leaves = jr.manifest["entries"]["opt_state"]["leaves"]
    assert sum(m.get("mode") == "codec" for m in leaves.values()) == n_coded
    assert jr.manifest == tr.manifest
    for name in jr.entries:
        for path, want in jr.entries[name].items():
            assert _bits(tr.entries[name][path]) == _bits(want), path
    _assert_coded_moments(jr.entries, moments)
    for m in (jm, tm):
        m.close()


def test_jax_coded_training_snapshot_restores_under_the_port(tmp_path):
    cfg = jreg.resolve_config(ARCH)
    shape = jreg.get_shape(SHAPE)
    jfn = jax.jit(jstep.make_train_step(
        cfg, jmake_plan(cfg, shape, MESH), JAdamW(), JSchedule(),
        mesh=None))
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    opt = jinit_opt(params, JAdamW())
    lower = JLower(mesh_factory=lambda: MESH)
    lower.mesh_create((1, 1), ("data", "model"))
    lower.compile_step("train_step", ARCH, SHAPE, "")
    pipe = JPipeline(JData(seed=1234, vocab_size=cfg.vocab_size, seq_len=16,
                           global_batch=4, n_shards=4))
    for step in range(2):
        batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(step).items()}
        params, opt, _ = jfn(params, opt, batch, jnp.int32(step),
                             jnp.float32(1.0))
        lower.data_advance(1)
    jm = JManager(JBackend(str(tmp_path)), async_save=False,
                  codec_by_kind=CODEC)
    up = JUpper()
    up.register("params", "params", params, JM.logical_specs(cfg))
    up.register("opt_state", "opt_state", opt)
    up.register("step", "step", np.int64(2))
    up.register("data_cursor", "data_cursor", np.int64(2))
    up.register("rng_seed", "rng", np.int64(0))
    jm.save(2, up, lower.oplog, job_meta={
        "kind": "train", "arch": ARCH, "shape_key": SHAPE, "plan_key": "",
        "init_seed": 0, "data_seed": 1234})
    jm.wait()
    moments = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
               jax.tree_util.tree_flatten_with_path(
                   {"mu": opt["mu"], "nu": opt["nu"]})[0]}
    assert any(m.size >= 256 for m in moments.values())
    ops.reset_counts()
    t = CheckpointSession(f"localfs:{tmp_path}").restore(
        "latest", expect_kind="train", device="cpu")
    n_coded = sum(1 for m in moments.values() if m.size >= 256)
    assert ops.counts("cpu")["dequantize"] == n_coded
    got = dict(flatten_with_paths(convert.tree_to_numpy(
        t.upper.get("opt_state"))))
    _assert_coded_moments({"opt_state": got}, moments)
    want_params = jm.restore(2).entries["params"]
    for path, v in flatten_with_paths(convert.tree_to_numpy(
            t.upper.get("params"))):
        assert _bits(v) == _bits(want_params[path]), path
    assert t.checkpoint_step() == 2
    assert np.isfinite(t.train_steps(1)["loss"])
    jm.close()
