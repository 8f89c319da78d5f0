"""The port's ssm family (Mamba-2) on the CPU against the JAX package.

The same seeded numpy inputs go through both packages: the SSD scan's
plain versions against ``repro.models.ssm.ssd_chunked``, the literal
recurrence and the Pallas kernel in interpret mode; their gradients
against ``jax.grad``; the autograd ``Function`` over the kernels (its
CPU route); the block, the model's forward, prefill and decode; three
f32 train steps against the JAX package's pure step function; the
planner; the ``ssm_a``/``ssm_dt`` inits; the port's own kill ->
``restore("latest")``; training chains across packages both ways.

Tolerances: the scan 1e-4 against the chunked JAX function and the
Pallas kernel (the same f32 math summed in another order), 2e-3 against
the sequential recurrence (another algorithm: the decays multiply step
by step instead of exponentiating a cumsum); gradients 1e-4; model
logits 1e-5 in float32 and 2e-2 relative in the 2-norm in bfloat16
(ROADMAP C8); train steps as ``test_torch_train.py`` states them.
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
from repro.kernels.ssd_scan.ops import ssd_scan as jssd_scan
from repro.kernels.ssd_scan.ref import ssd_sequential as jssd_sequential
from repro.models import model as JM
from repro.models import ssm as JSSM
from repro.optim import AdamWConfig as JAdamW
from repro.optim import ScheduleConfig as JSchedule
from repro.optim import init_opt_state as jinit_opt
from repro.parallel.planner import estimate_serve_memory as jserve_memory
from repro.parallel.planner import make_plan as jmake_plan
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.api import CheckpointSession, Policy
from repro_torch.configs import registry as treg
from repro_torch.core.backends.localfs import LocalFSBackend
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as R
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM
from repro_torch.optim import AdamWConfig, ScheduleConfig, init_opt_state
from repro_torch.parallel.planner import estimate_serve_memory, make_plan
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.train import step as S
from repro_torch.train.loop import Trainer, TrainJob
from repro_torch.tree import flatten_with_paths, tree_map

ARCH = "mamba2-780m-smoke"
SHAPE = "train_s16_b4"
MESH = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
# B, S, H, hd, N, chunk: tests/test_kernels.py's SSD shapes
SCAN_SHAPES = [(2, 256, 3, 32, 16, 64), (1, 128, 2, 64, 128, 128),
               (2, 100, 2, 32, 16, 64)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bytes(v) -> bytes:
    return np.ascontiguousarray(np.asarray(v)).tobytes()


def _jax_tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _scan_inputs(B, S, H, hd, N, seed=0, a_scale=0.3, init=False):
    """x, dt, A, Bm, Cm (and init_state) as float32 numpy, the way
    ``tests/test_kernels.py`` draws them: dt = softplus(normal),
    A = -exp(0.3 normal)."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    out = [f(B, S, H, hd), np.logaddexp(f(B, S, H), 0).astype(np.float32),
           -np.exp(f(H) * a_scale).astype(np.float32), f(B, S, N), f(B, S, N)]
    if init:
        out.append(f(B, H, hd, N))
    return out


def _model_chunk(S, chunk):
    return chunk if S % chunk == 0 else S


# --- the scan: plain versions against the JAX package ------------------------

@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_ssd_chunked_plain_matches_jax(shape, init):
    B, S, H, hd, N, chunk = shape
    chunk = _model_chunk(S, chunk)
    ins = _scan_inputs(B, S, H, hd, N, seed=S, init=init)
    init_state = ins[5] if init else None
    jy, jfin = JSSM.ssd_chunked(*map(jnp.asarray, ins[:5]), chunk=chunk,
                                init_state=None if init_state is None
                                else jnp.asarray(init_state))
    y, fin = R.ssd_chunked_plain(*map(torch.from_numpy, ins[:5]), chunk,
                                 None if init_state is None
                                 else torch.from_numpy(init_state))
    assert y.dtype == fin.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(jy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(fin), _np(jfin), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_ssd_scan_matches_the_pallas_kernel_and_the_recurrence(shape):
    """The port's ``ssd_scan`` (CPU route: pad with dt = 0, plain scan,
    cut) against the Pallas kernel in interpret mode (1e-4) and against
    the sequential recurrence of both packages (2e-3); the final state
    of the scan over the dt = 0 padding is the state at S."""
    B, S, H, hd, N, chunk = shape
    ins = _scan_inputs(B, S, H, hd, N, seed=1)
    jins = list(map(jnp.asarray, ins))
    tins = list(map(torch.from_numpy, ins))
    want = _np(jssd_scan(*jins, chunk=chunk, interpret=True))
    seq = _np(jssd_sequential(*jins))
    ssd_ops.reset_counts()
    y = ssd_ops.ssd_scan(*tins, chunk=chunk)
    assert ssd_ops.counts("cpu")["ssd_fwd"] == 1
    assert y.dtype == torch.float32 and tuple(y.shape) == (B, S, H, hd)
    np.testing.assert_allclose(_np(y), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(y), seq, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(R.ssd_sequential_plain(*tins)), seq,
                               rtol=1e-4, atol=1e-4)
    c = min(chunk, S)
    pad = (-S) % c
    x, dt, A, Bm, Cm = tins
    padded = [torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
              for t in (x, dt, Bm, Cm)]
    _, fin = ssd_ops.ssd_chunked(*padded[:2], A, *padded[2:], c)
    _, jfin = JSSM.ssd_chunked(*jins, chunk=S)
    np.testing.assert_allclose(_np(fin), _np(jfin), rtol=1e-4, atol=1e-4)


def test_ssd_scan_keeps_the_input_dtype():
    ins = _scan_inputs(1, 40, 2, 16, 8, seed=2)
    x = torch.from_numpy(ins[0]).to(torch.bfloat16)
    Bm, Cm = (torch.from_numpy(a).to(torch.bfloat16) for a in ins[3:5])
    y = ssd_ops.ssd_scan(x, torch.from_numpy(ins[1]),
                         torch.from_numpy(ins[2]), Bm, Cm, chunk=16)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (1, 40, 2, 16)


# --- gradients ---------------------------------------------------------------

GRAD_SHAPES = [(2, 64, 3, 16, 16, 32, False), (1, 96, 2, 32, 64, 48, True)]


def _jax_grads(ins, dy, dfinal, chunk, init_state=None, fn=None):
    fn = fn or JSSM.ssd_chunked

    def loss(x, dt, A, Bm, Cm):
        y, fin = fn(x, dt, A, Bm, Cm, chunk=chunk, init_state=init_state)
        out = jnp.sum(y * dy)
        if dfinal is not None:
            out = out + jnp.sum(fin * dfinal)
        return out

    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, ins))


@pytest.mark.parametrize("case", GRAD_SHAPES)
def test_plain_gradients_match_jax_grad(case):
    """``ssd_grads_plain`` (autograd) and the CPU route of
    ``ops.ssd_bwd`` (from the chunk-start states ``ops.ssd_fwd`` saved)
    against ``jax.grad`` of the JAX ``ssd_chunked``, with a cotangent on
    the final state and, in the second case, an initial state held
    constant."""
    B, S, H, hd, N, chunk, init = case
    ins = _scan_inputs(B, S, H, hd, N, seed=3, init=init)
    rng = np.random.RandomState(4)
    dy = rng.randn(B, S, H, hd).astype(np.float32)
    dfinal = rng.randn(B, H, hd, N).astype(np.float32)
    s0 = ins[5] if init else None
    want = _jax_grads(ins[:5], jnp.asarray(dy), jnp.asarray(dfinal), chunk,
                      None if s0 is None else jnp.asarray(s0))
    assert all(np.isfinite(_np(g)).all() for g in want)
    tins = list(map(torch.from_numpy, ins[:5]))
    ts0 = None if s0 is None else torch.from_numpy(s0)
    auto = R.ssd_grads_plain(*tins, torch.from_numpy(dy), chunk,
                             torch.from_numpy(dfinal), ts0)
    _, _, states = ssd_ops.ssd_fwd(*tins, chunk, ts0)
    routed = ssd_ops.ssd_bwd(*tins, states, torch.from_numpy(dy),
                             torch.from_numpy(dfinal), chunk)
    for name, a, e, w in zip(("dx", "ddt", "dA", "dB", "dC"), auto, routed,
                             want):
        scale = max(float(np.abs(_np(w)).max()), 1.0)
        np.testing.assert_allclose(_np(a), _np(w), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)
        np.testing.assert_allclose(_np(e), _np(w), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


def _masked_ssd_chunked(x, dt, A, Bm, Cm, chunk, init_state=None):
    """The JAX ``ssd_chunked`` with the decay masked before the
    exponential (``repro.models.ssm._segsum``): the same forward, a
    finite gradient."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    q = min(chunk, S)
    nc = S // q
    xf = x.reshape(Bsz, nc, q, H, P).transpose(1, 0, 2, 3, 4)
    dtf = dt.reshape(Bsz, nc, q, H).transpose(1, 0, 2, 3)
    Bf = Bm.reshape(Bsz, nc, q, N).transpose(1, 0, 2, 3)
    Cf = Cm.reshape(Bsz, nc, q, N).transpose(1, 0, 2, 3)

    def body(s, inp):
        xc, dtc, bc, cc = inp
        dA = dtc * A
        cum = jnp.cumsum(dA, axis=1)
        xdt = xc * dtc[..., None]
        L = jnp.exp(JSSM._segsum(dA.transpose(0, 2, 1)))
        scores = jnp.einsum("bin,bjn->bij", cc, bc)
        y = jnp.einsum("bhij,bjhp->bihp", scores[:, None] * L, xdt)
        y = y + jnp.einsum("bqn,bhpn,bqh->bqhp", cc, s, jnp.exp(cum))
        st = jnp.einsum("bqn,bqhp,bqh->bhpn", bc, xdt,
                        jnp.exp(cum[:, -1:, :] - cum))
        return s * jnp.exp(cum[:, -1, :])[:, :, None, None] + st, y

    s0 = jnp.zeros((Bsz, H, P, N), jnp.float32) if init_state is None \
        else init_state
    fin, ys = jax.lax.scan(body, s0, (xf, dtf, Bf, Cf))
    return ys.transpose(1, 0, 2, 3, 4).reshape(Bsz, S, H, P), fin


def test_gradient_stays_finite_where_the_reference_overflows():
    """ROADMAP C10: once a chunk's decay passes e^88 the JAX function's
    masked-out exp overflows and ``jax.grad`` turns NaN; the port masks
    before the exponential. Its gradients are finite and equal
    ``jax.grad`` of the JAX function with the reference's own masked
    segment sum (``_segsum``), which has the same forward."""
    B, S, H, hd, N, chunk = 1, 128, 2, 16, 16, 128
    ins = _scan_inputs(B, S, H, hd, N, seed=5)
    ins[2] = np.array([-4.0, -8.0], np.float32)       # |dA| ~ 3-6 a step
    dy = np.random.RandomState(6).randn(B, S, H, hd).astype(np.float32)
    ref_grads = _jax_grads(ins, jnp.asarray(dy), None, chunk)
    assert not all(np.isfinite(_np(g)).all() for g in ref_grads)
    want = _jax_grads(ins, jnp.asarray(dy), None, chunk,
                      fn=_masked_ssd_chunked)
    jy, _ = JSSM.ssd_chunked(*map(jnp.asarray, ins), chunk=chunk)
    my, _ = _masked_ssd_chunked(*map(jnp.asarray, ins), chunk=chunk)
    np.testing.assert_array_equal(_np(jy), _np(my))
    got = R.ssd_grads_plain(*map(torch.from_numpy, ins),
                            torch.from_numpy(dy), chunk)
    for a, w in zip(got, want):
        assert np.isfinite(_np(a)).all()
        scale = max(float(np.abs(_np(w)).max()), 1.0)
        np.testing.assert_allclose(_np(a), _np(w), rtol=1e-4,
                                   atol=1e-4 * scale)


@pytest.mark.parametrize("with_final", [False, True])
def test_ssd_scan_function_gradients_on_the_cpu_route(with_final):
    """``SSDScan`` on CPU tensors: its forward and backward take the
    plain route (one count each) and its gradients equal
    ``ssd_grads_plain``'s."""
    ins = _scan_inputs(2, 96, 3, 16, 16, seed=7)
    tins = [torch.from_numpy(a) for a in ins]
    rng = np.random.RandomState(8)
    dy = torch.from_numpy(rng.randn(2, 96, 3, 16).astype(np.float32))
    dfin = torch.from_numpy(rng.randn(2, 3, 16, 16).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in tins]
    ssd_ops.reset_counts()
    y, fin = ssd_ops.ssd_chunked(*leaves, 32)
    outs, cots = ([y, fin], [dy, dfin]) if with_final else ([y], [dy])
    got = torch.autograd.grad(outs, leaves, cots)
    assert ssd_ops.counts("cpu") == {"ssd_fwd": 1, "ssd_bwd": 1}
    assert ssd_ops.counts("cuda") == {"ssd_fwd": 0, "ssd_bwd": 0}
    want = R.ssd_grads_plain(*tins, dy, 32, dfin if with_final else None)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4)


def test_ssd_scan_function_refuses_an_init_state_gradient():
    ins = [torch.from_numpy(a) for a in _scan_inputs(1, 32, 2, 8, 8,
                                                     init=True)]
    s0 = ins[5].requires_grad_(True)
    x = ins[0].requires_grad_(True)
    y, _ = ssd_ops.ssd_chunked(x, *ins[1:5], 16, s0)
    with pytest.raises(NotImplementedError, match="init_state"):
        y.sum().backward()


def test_wrapper_refuses_what_it_cannot_take():
    ins = [torch.from_numpy(a) for a in _scan_inputs(1, 30, 2, 8, 8)]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_ops.ssd_fwd(*ins, 16)
    with pytest.raises(TypeError, match="share one dtype"):
        ssd_ops.ssd_fwd(ins[0].double(), *ins[1:], 15)
    with pytest.raises(ValueError, match="no kernel for device"):
        ssd_ops.ssd_fwd(*(t.to("meta") for t in ins), 15)
    y, _, states = ssd_ops.ssd_fwd(*ins, 15)
    with pytest.raises(ValueError, match="dy must be"):
        ssd_ops.ssd_bwd(*ins, states, y[:, :10].contiguous(), None, 15)
    with pytest.raises(ValueError, match="init_state must be"):
        ssd_ops.ssd_fwd(*ins, 15, torch.zeros(1, 2, 8, 9))


# --- the block and the model -------------------------------------------------

def _pair(dtype):
    jcfg = jreg.get_smoke_config("mamba2-780m").replace(dtype=dtype)
    tcfg = treg.get_smoke_config("mamba2-780m").replace(dtype=dtype)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    # the smoke init's out_norm / dt_bias are constants; perturb the
    # zero-init leaves so the comparison sees every parameter
    rng = np.random.RandomState(11)
    jnp_params = _jax_tree_np(jparams)
    lay = jnp_params["layers"]
    for k in ("out_norm", "conv_bx", "conv_bB", "conv_bC"):
        lay[k] = (lay[k].astype(np.float32)
                  + 0.1 * rng.randn(*lay[k].shape)).astype(lay[k].dtype)
    jparams = jax.tree.map(jnp.asarray, jnp_params)
    tparams = convert.params_from_numpy(jnp_params, "cpu")
    return jcfg, tcfg, jparams, tparams


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:   # bf16 rounds at other places in the two frameworks (C8)
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-2


def test_param_template_and_cache_spec_match_the_reference():
    jcfg, tcfg, jparams, tparams = _pair("bfloat16")
    from repro.core.split_state import flatten_with_paths as jflat
    want = [(p, tuple(v.shape), str(v.dtype)) for p, v in jflat(jparams)]
    got = [(p, tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for p, v in flatten_with_paths(M.init_params(tcfg, 0, "cpu"))]
    assert got == want
    assert M.logical_specs(tcfg) == JM.logical_specs(jcfg)
    assert M.param_count(tcfg) == sum(int(np.prod(v.shape))
                                      for _, v in jflat(jparams))
    jspec = JM.cache_spec(jcfg, 3, 40)
    tspec = M.cache_spec(tcfg, 3, 40)
    assert sorted(jspec) == sorted(tspec)
    for k, s in jspec.items():
        assert tspec[k].shape == tuple(s.shape)
        assert str(tspec[k].dtype).replace("torch.", "") == str(s.dtype)
    cache = M.init_cache(tcfg, 3, 40, device="cpu")
    assert all(float(t.abs().sum()) == 0 for t in cache.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_forward_and_decode_step_match(dtype):
    jcfg, tcfg, jparams, tparams = _pair(dtype)
    jp = jax.tree.map(lambda t: t[0], jparams["layers"])
    tp = tree_map(lambda t: t[0], tparams["layers"])
    rng = np.random.RandomState(12)
    x = rng.randn(2, 20, tcfg.d_model).astype(np.float32)
    tx = torch.from_numpy(x).to(M.torch_dtype(dtype))
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    jout, _ = JSSM.ssm_block_forward(jcfg, jp, jx)
    tout, none = SSM.ssm_block_forward(tcfg, tp, tx)
    assert none is None and tout.dtype == tx.dtype
    _close(tout, jout, dtype)
    # with a cache: prefill 20 tokens, then one decode step
    jc = jax.tree.map(lambda t: t[0], JM.init_cache(jcfg, 2, 32))
    tc = {k: v[0] for k, v in M.init_cache(tcfg, 2, 32, "cpu").items()}
    jout, jc = JSSM.ssm_block_forward(jcfg, jp, jx, jc)
    tout, tc = SSM.ssm_block_forward(tcfg, tp, tx, tc)
    _close(tout, jout, dtype)
    for k in jc:
        _close(tc[k], jc[k], dtype)
    one = rng.randn(2, 1, tcfg.d_model).astype(np.float32)
    jout, jc = JSSM.ssm_block_forward(jcfg, jp, jnp.asarray(one).astype(
        jnp.dtype(dtype)), jc)
    tout, tc = SSM.ssm_block_forward(tcfg, tp, torch.from_numpy(one).to(
        M.torch_dtype(dtype)), tc)
    _close(tout, jout, dtype)
    _close(tc["state"], jc["state"], dtype)
    # the decode step alone, f32
    ins = _scan_inputs(2, 1, 3, 8, 16, seed=13, init=True)
    jy, js = JSSM.ssd_decode_step(*map(jnp.asarray, ins))
    ty, ts = SSM.ssd_decode_step(*map(torch.from_numpy, ins))
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ts), _np(js), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_logits_match_jax(dtype):
    jcfg, tcfg, jparams, tparams = _pair(dtype)
    toks = np.random.RandomState(2).randint(0, jcfg.vocab_size,
                                            (2, 24)).astype(np.int32)
    want, _ = JM.forward_train(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    for remat in ("none", "full"):
        got, aux = M.forward_train(tcfg, tparams,
                                   {"tokens": torch.from_numpy(toks)},
                                   M.CallOptions(remat=remat))
        assert got.dtype == M.torch_dtype(dtype)
        assert float(aux["moe_aux"]) == 0.0
        _close(got, want, dtype)


def test_prefill_and_decode_match_jax():
    jcfg, tcfg, jparams, tparams = _pair("float32")
    toks = np.random.RandomState(3).randint(0, jcfg.vocab_size,
                                            (2, 20)).astype(np.int32)
    jlast, jc = JM.prefill(jcfg, jparams, jnp.asarray(toks),
                           JM.init_cache(jcfg, 2, 32))
    tc = M.init_cache(tcfg, 2, 32, device="cpu")
    tlast, tc2 = M.prefill(tcfg, tparams, torch.from_numpy(toks), tc)
    assert tc2 is tc                                 # written in place
    _close(tlast, jlast, "float32")
    for k in jc:
        _close(tc[k], jc[k], "float32")
    nxt = np.array([[5], [7]], np.int32)
    pos = np.array([20, 20], np.int32)
    jl, jc = JM.decode_step(jcfg, jparams, jc, jnp.asarray(nxt),
                            jnp.asarray(pos))
    tl, tc = M.decode_step(tcfg, tparams, tc, torch.from_numpy(nxt),
                           torch.from_numpy(pos))
    _close(tl, jl, "float32")
    _close(tc["state"], jc["state"], "float32")


# --- inits -------------------------------------------------------------------

def test_ssm_inits_follow_the_reference_formulas():
    """A_log = log U[1, 16); dt_bias = softplus^-1 of a log-uniform
    [1e-3, 1e-1) draw; each leaf from its own seeded generator."""
    cfg = treg.get_config("mamba2-780m")
    p = M.init_params(cfg.replace(n_layers=4), seed=0, device="cpu")
    a, dtb = p["layers"]["A_log"], p["layers"]["dt_bias"]
    assert a.dtype == dtb.dtype == torch.float32
    assert tuple(a.shape) == tuple(dtb.shape) == (4, 48)
    u = torch.exp(a)
    assert float(u.min()) >= 1.0 and float(u.max()) < 16.0
    dt = torch.nn.functional.softplus(dtb)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) < 1e-1 * (1 + 1e-5)
    # spread over the range, not stuck at one end
    assert float(u.mean()) == pytest.approx(8.5, abs=1.5)
    assert float(torch.log(dt).mean()) == pytest.approx(
        np.log(1e-2), abs=0.5)
    again = M.init_params(cfg.replace(n_layers=4), seed=0, device="cpu")
    assert torch.equal(again["layers"]["A_log"], a)
    other = M.init_params(cfg.replace(n_layers=4), seed=1, device="cpu")
    assert not torch.equal(other["layers"]["A_log"], a)
    assert torch.equal(p["layers"]["D"], torch.ones(4, 48))


def test_kernel_check_inputs_follow_the_ssm_inits():
    """``model_dt_A`` (the kernel checks' dt and A) draws as the model's
    inits do: A = -uniform[1, 16], and per head the median of
    softplus^-1(dt) is dt_bias, whose softplus lies in [1e-3, 0.1]."""
    g = torch.Generator().manual_seed(0)
    dt, A = R.model_dt_A(2, 4096, 48, g, "cpu")
    assert dt.dtype == A.dtype == torch.float32
    assert tuple(dt.shape) == (2, 4096, 48) and tuple(A.shape) == (48,)
    assert bool((A <= -1).all()) and bool((A >= -16).all())
    bias = torch.log(torch.expm1(dt.double())).flatten(0, 1).median(0).values
    soft = torch.nn.functional.softplus(bias)
    assert bool((soft > 0.9e-3).all()) and bool((soft < 0.11).all())
    assert float(soft.min()) < 3e-3 and float(soft.max()) > 3e-2


def test_rglru_init_still_names_its_roadmap_item():
    """The ``rglru_a`` init (ROADMAP B8's hybrid family) is ported:
    softplus^-1(-log u), u ~ U[0.9, 0.999), from the leaf's own seeded
    generator; an init the reference does not know raises as there."""
    from repro_torch.models.params import P, init_concrete
    lam = init_concrete({"a": P((4096,), (None,), init="rglru_a")},
                        "float32", 0, "cpu")["a"]
    a = torch.exp(-torch.nn.functional.softplus(lam.double()))
    assert lam.dtype == torch.float32
    assert float(a.min()) >= 0.9 * (1 - 1e-6)
    assert float(a.max()) <= 0.999 * (1 + 1e-6)
    assert float(a.mean()) == pytest.approx(0.9495, abs=0.01)
    with pytest.raises(ValueError, match="unknown init"):
        init_concrete({"a": P((4,), (None,), init="nope")}, "float32", 0,
                      "cpu")


# --- training ----------------------------------------------------------------

def _jax_step(cfg, shape):
    plan = jmake_plan(cfg, shape, MESH)
    return jax.jit(jstep.make_train_step(cfg, plan, JAdamW(), JSchedule(),
                                         mesh=None))


def test_three_train_steps_match_the_jax_step():
    """Three f32 steps of the smoke model from the same params and
    batches; tolerances as in ``test_torch_train.py``."""
    jcfg = jreg.get_smoke_config("mamba2-780m").replace(dtype="float32")
    tcfg = treg.get_smoke_config("mamba2-780m").replace(dtype="float32")
    shape = jreg.get_shape(SHAPE)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    jopt = jinit_opt(jparams, JAdamW())
    params = convert.params_from_numpy(_jax_tree_np(jparams), "cpu")
    opt = init_opt_state(params, AdamWConfig())
    tstep = S.make_train_step(tcfg, make_plan(tcfg, treg.get_shape(SHAPE)),
                              AdamWConfig(), ScheduleConfig())
    jfn = _jax_step(jcfg, shape)
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
    for (path, a), (_, b) in zip(flatten_with_paths(params),
                                 flatten_with_paths(_jax_tree_np(jparams))):
        np.testing.assert_allclose(_np(a), b, rtol=0, atol=1e-6,
                                   err_msg=path)
    jo = _jax_tree_np(jopt)
    for mom in ("mu", "nu"):
        for (path, a), (_, b) in zip(flatten_with_paths(opt[mom]),
                                     flatten_with_paths(jo[mom])):
            np.testing.assert_allclose(_np(a), b, rtol=1e-4, atol=1e-7,
                                       err_msg=mom + path)
    assert int(opt["count"]) == int(jo["count"]) == 3


@pytest.mark.parametrize("arch", ["mamba2-780m", "mamba2-780m-smoke"])
@pytest.mark.parametrize("shape", ["train_s4096_b8", "train_4k",
                                   "train_s16_b4"])
def test_make_plan_matches_jax_for_ssm(arch, shape):
    want = jmake_plan(jreg.resolve_config(arch), jreg.get_shape(shape), MESH)
    got = make_plan(treg.resolve_config(arch), treg.get_shape(shape))
    assert (got.grad_accum, got.remat) == (want.grad_accum, want.remat)


SERVE_SHAPES = ["decode_32k", "prefill_32k", "train_s4096_b8"]


@pytest.mark.parametrize("arch", ["mamba2-780m", "mamba2-780m-smoke"])
@pytest.mark.parametrize("shape", SERVE_SHAPES)
def test_serve_memory_estimate_matches_jax(arch, shape):
    want = jserve_memory(jreg.resolve_config(arch), jreg.get_shape(shape),
                         MESH, depth=1, cache_seq_shard=False)
    got = estimate_serve_memory(treg.resolve_config(arch),
                                treg.get_shape(shape))
    assert got.kv_cache == pytest.approx(want.kv_cache, rel=1e-12)
    assert got.total == pytest.approx(want.total, rel=1e-12)


@pytest.mark.parametrize("shape", SERVE_SHAPES)
def test_serve_memory_estimate_of_other_families_waits_for_a9(shape):
    """The other families' serving estimate is ported now (ROADMAP A9b
    step 1): phi4-mini-3.8b's equals the reference's on one device."""
    want = jserve_memory(jreg.resolve_config("phi4-mini-3.8b"),
                         jreg.get_shape(shape), MESH, depth=1,
                         cache_seq_shard=False)
    got = estimate_serve_memory(treg.resolve_config("phi4-mini-3.8b"),
                                treg.get_shape(shape))
    assert (got.params, got.kv_cache, got.activations, got.total) == \
        (want.params, want.kv_cache, want.activations, want.total)


SMALL = dict(sparse_chunk_bytes=1024, sparse_min_bytes=2048)


def test_engine_admits_by_replay_as_the_jax_engine():
    """The port's engine on mamba2-780m-smoke (f32, 2 slots) gives the
    JAX engine's greedy tokens: a recurrent request is admitted by
    replaying its history through batch-1 decode, never by a padded
    prefill, whose pad tokens would advance the state."""
    jcfg = jreg.get_smoke_config("mamba2-780m").replace(dtype="float32")
    tcfg = treg.get_smoke_config("mamba2-780m").replace(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(_jax_tree_np(jparams), "cpu")
    rng = np.random.RandomState(4)
    prompts = [np.array([3, 7, 11, 5, 9], np.int32)] + [
        rng.randint(0, 256, size=rng.randint(2, 12)).astype(np.int32)
        for _ in range(3)]
    jeng = JEngine(jcfg, jparams, MESH, n_slots=2, max_seq=64)
    teng = ServingEngine(tcfg, tparams, "cpu", n_slots=2, max_seq=64)
    jreqs = [JRequest(rid=i, prompt=p.copy(), max_new=6)
             for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p.copy(), max_new=6)
             for i, p in enumerate(prompts)]
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    jeng.run_until_drained(max_steps=200)
    teng.run_until_drained(max_steps=200)
    want = {r.rid: list(r.out) for r in jreqs}
    assert {r.rid: list(r.out) for r in treqs} == want
    assert all(len(v) == 6 for v in want.values())


@pytest.mark.parametrize("label,policy", [
    ("chain2", Policy(interval=2, chain=2, **SMALL)),
    ("chain1", Policy(interval=2, chain=1)),
])
def test_trainer_kill_restore_continues_bit_identically(tmp_path, label,
                                                        policy):
    sess = CheckpointSession(f"localfs:{tmp_path}", policy)
    t = Trainer(TrainJob(ARCH, "train_s32_b2"), manager=sess.manager,
                device="cpu")
    t.init_state()
    sess.attach(t)
    losses = []
    for _ in range(5):
        losses.append(t.train_steps(1)["loss"])
        sess.maybe_snapshot()
    sess.wait()
    want = t.state_digest()
    assert sess.restorable_steps() == [2, 4]
    sess.close()
    del t                                        # the kill
    sess2 = CheckpointSession(f"localfs:{tmp_path}", policy)
    t2 = sess2.restore("latest", expect_kind="train", device="cpu")
    assert t2.checkpoint_step() == 4
    assert t2.train_steps(1)["loss"] == losses[4]
    assert t2.state_digest() == want
    sess2.close()


def _assert_same_entries(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        assert sorted(a[name]) == sorted(b[name]), name
        for path in a[name]:
            x, y = a[name][path], b[name][path]
            assert tuple(np.shape(x)) == tuple(np.shape(y)), (name, path)
            assert str(np.asarray(x).dtype) == str(np.asarray(y).dtype) \
                or "bfloat16" in (str(np.asarray(x).dtype),
                                  str(np.asarray(y).dtype)), (name, path)
            assert _bytes(x) == _bytes(y), (name, path)


def test_port_training_chain_restores_bit_identically_under_jax(tmp_path):
    sess = CheckpointSession(f"localfs:{tmp_path}",
                             Policy(interval=2, chain=2, **SMALL))
    t = Trainer(TrainJob(ARCH, SHAPE), manager=sess.manager, device="cpu")
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
        for e, leaves in live[step].items():
            for path, want in leaves.items():
                assert _bytes(jr.entries[e][path]) == _bytes(want)
        # the f32 leaves of the block keep their dtype across packages
        assert str(jr.entries["params"]["['layers']['A_log']"].dtype) \
            == "float32"
    for m in (jm, tm):
        m.close()


def test_jax_training_chain_restores_bit_identically_under_the_port(
        tmp_path):
    cfg = jreg.resolve_config(ARCH)
    shape = jreg.get_shape(SHAPE)
    jfn = _jax_step(cfg, shape)
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
    assert t.upper.get("params")["layers"]["dt_bias"].dtype == torch.float32
    assert t.checkpoint_step() == 4
    loss = t.train_steps(1)["loss"]
    batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(4).items()}
    _, _, jmet = jfn(params, opt, batch, jnp.int32(4), jnp.float32(1.0))
    assert abs(loss - float(jmet["loss"])) < 2e-2 * abs(float(jmet["loss"]))
    for m in (jm, tm):
        m.close()
