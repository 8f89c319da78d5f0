"""The port's hybrid training (Griffin/RecurrentGemma) on the CPU against
the JAX package.

The same seeded numpy inputs go through both packages: the RG-LRU
gradients (``rg_lru_bwd_plain``, the CUDA backward's algebra, and
autograd through the port's ``rg_lru``) against ``jax.vjp`` of
``repro.models.hybrid.rg_lru``, with and without an initial state; the
flash plain versions at head dim 256 (recurrentgemma-9b's), causal with
a window, against the Pallas kernels in interpret mode;
``forward_train``'s gradients of recurrentgemma-9b-smoke (one block
group and two remainder blocks) and -matrix (one group) at sequences
past their attention windows (32 and 8) against ``jax.grad``, and three
train steps of -matrix against the pure JAX step. The trainer's kill ->
restore, the training chains across packages and the card's plan are in
``test_torch_hybrid_train_restore.py``.

Tolerances: the RG-LRU gradients 1e-5 x the largest element (the same
f32 recurrence, blocked and summed in another order); the flash plain
versions ``tests/test_kernels.py``'s (2e-5 forward, 5e-4 backward); the
model's gradients 1e-4 in each leaf's relative 2-norm, the train steps
as ``tests/test_torch_ssm.py`` holds the ssm family's (loss, grad norm
and lr 1e-5 relative, params 1e-6 absolute, moments 1e-4 relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import registry as jreg
from repro.kernels.flash_attention.backward import flash_attention_bwd
from repro.kernels.flash_attention.kernel import flash_attention_fwd
from repro.models import hybrid as JHY
from repro.models import model as JM
from repro.optim import AdamWConfig as JAdamW
from repro.optim import ScheduleConfig as JSchedule
from repro.optim import init_opt_state as jinit_opt
from repro.parallel.planner import make_plan as jmake_plan
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rg_lru import ops as rg_ops
from repro_torch.kernels.rg_lru import ref as R
from repro_torch.models import hybrid as HY
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, ScheduleConfig, init_opt_state
from repro_torch.parallel import planner
from repro_torch.train import step as S
from repro_torch.tree import flatten_with_paths

SMOKE = "recurrentgemma-9b-smoke"
MATRIX = "recurrentgemma-9b-matrix"
MESH = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
INIT, NEAR_ONE = (0.9, 0.999), (0.99999, 0.999999)
# the smoke window is 32 tokens, the matrix's 8: each sequence crosses it
SEQ = {SMOKE: 48, MATRIX: 24}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close_scaled(got, want, tol, name=""):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=name)


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --- the RG-LRU gradients ----------------------------------------------------

# B, S, W, initial state, the rglru_a init's range: several 256-token
# chunks of the kernel, a ragged last chunk, one shorter than a chunk
RGLRU_CASES = [(2, 700, 24, True, INIT), (1, 100, 8, False, INIT),
               (1, 513, 16, True, NEAR_ONE)]


@jax.jit
def _jax_vjp(x, r, i, lam, h0, dy):
    args = (x, r, i, lam) + (() if h0 is None else (h0,))
    _, vjp = jax.vjp(lambda *a: JHY.rg_lru(*a)[0], *args)
    return vjp(dy)


@pytest.mark.parametrize("case", RGLRU_CASES)
def test_rg_lru_bwd_plain_matches_jax_vjp(case):
    B, S, W, init, u_range = case
    g = torch.Generator().manual_seed(S + W)
    x, r, i, lam = R.model_inputs(B, S, W, g, "cpu", u_range)
    h0 = torch.randn((B, W), generator=g) if init else None
    dy = torch.randn((B, S, W), generator=g)
    h = R.rg_lru_plain(x, r, i, lam, h0)
    got = R.rg_lru_bwd_plain(x, r, i, lam, h, dy, h0)
    want = _jax_vjp(*(None if t is None else jnp.asarray(t.numpy())
                      for t in (x, r, i, lam, h0, dy)))
    names = ("dx", "dr", "di", "dlam", "dh0")
    assert [tuple(t.shape) for t in got] == [
        (B, S, W)] * 3 + [(W,), (B, W)]
    for name, a, b in zip(names, got, want):
        _close_scaled(a, b, 1e-5, name)


@pytest.mark.parametrize("init", [False, True])
def test_autograd_through_rg_lru_matches_jax_grad(init):
    """``HY.rg_lru`` (the port's ``ops.RGLRU``) differentiated by
    autograd, through both outputs (h and h_last), against ``jax.grad``
    of the same loss; its backward is one ``rg_lru_bwd`` call."""
    g = torch.Generator().manual_seed(11)
    x, r, i, lam = R.model_inputs(2, 300, 16, g, "cpu")
    h0 = torch.randn((2, 16), generator=g) if init else None
    dy = torch.randn((2, 300, 16), generator=g)
    leaves = [t.clone().requires_grad_(True)
              for t in (x, r, i, lam) + ((h0,) if init else ())]
    rg_ops.reset_counts()
    h, last = HY.rg_lru(*leaves[:4], leaves[4] if init else None)
    ((h * dy).sum() + last.sum()).backward()
    assert rg_ops.counts("cpu") == {"rg_lru_fwd": 1, "rg_lru_bwd": 1}
    assert rg_ops.counts("cuda") == {"rg_lru_fwd": 0, "rg_lru_bwd": 0}
    jdy = jnp.asarray(dy.numpy())

    def loss(*a):
        jh, jlast = JHY.rg_lru(*a)
        return (jh * jdy).sum() + jlast.sum()

    want = jax.jit(jax.grad(loss, argnums=tuple(range(len(leaves)))))(
        *(jnp.asarray(t.detach().numpy()) for t in leaves))
    for t, w in zip(leaves, want):
        _close_scaled(t.grad, w, 1e-5)


def test_rg_lru_bwd_wrapper_refuses_what_it_cannot_take():
    g = torch.Generator().manual_seed(0)
    x, r, i, lam = R.model_inputs(1, 8, 4, g, "cpu")
    with pytest.raises(ValueError, match="do not agree"):
        rg_ops.rg_lru_bwd(x, r, i, lam, x, x[:, :4])
    with pytest.raises(TypeError, match="float32"):
        rg_ops.rg_lru_bwd(x, r, i, lam, x, x.double())
    with pytest.raises(ValueError, match="no kernel for device"):
        rg_ops.rg_lru_bwd(*(t.to("meta") for t in (x, r, i, lam, x, x)))


# --- flash attention at head dim 256 -----------------------------------------

@pytest.mark.parametrize("S,window", [(160, 48)])
def test_flash_plain_at_head_dim_256_matches_pallas(S, window):
    """recurrentgemma-9b's attention (head dim 256, MQA, a window) at a
    small size: the plain forward, LSE, dq and dk/dv against the Pallas
    kernels in interpret mode."""
    rng = np.random.RandomState(S)
    q, k, v, do = (rng.randn(*s).astype(np.float32) for s in (
        (1, 4, S, 256), (1, 1, S, 256), (1, 1, S, 256), (1, 4, S, 256)))
    kw = dict(causal=True, window=window)
    jout, jlse = flash_attention_fwd(*map(jnp.asarray, (q, k, v)),
                                     block_q=32, block_k=32, interpret=True,
                                     return_lse=True, **kw)
    jdq, jdk, jdv = flash_attention_bwd(
        *map(jnp.asarray, (q, k, v)), jout, jlse, jnp.asarray(do),
        block_q=32, block_k=32, interpret=True, **kw)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = fa.flash_fwd(tq, tk, tv, **kw)
    np.testing.assert_allclose(_np(out), _np(jout), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(lse), _np(jlse), rtol=2e-5, atol=2e-5)
    delta = fa.attention_delta(torch.from_numpy(np.array(jout)), tdo)
    jl = torch.from_numpy(np.array(jlse))
    dq = fa.flash_dq(tq, tk, tv, tdo, jl, delta, **kw)
    dk, dv = fa.flash_dkv(tq, tk, tv, tdo, jl, delta, **kw)
    for a, b in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=5e-4, atol=5e-4)
    assert 256 in fa.HEAD_DIMS


# --- the model ----------------------------------------------------------------

def _pair(arch):
    """f32 configs of both packages and the same params in each: the
    port's seeded init, handed to the JAX package as arrays."""
    jcfg = jreg.resolve_config(arch).replace(dtype="float32")
    tcfg = treg.resolve_config(arch).replace(dtype="float32")
    tparams = M.init_params(tcfg, seed=3, device="cpu")
    jparams = jax.tree.map(jnp.asarray, convert.tree_to_numpy(tparams))
    return jcfg, tcfg, jparams, tparams


def _batch(cfg, seq, step=0):
    return TokenPipeline(DataConfig(
        seed=5, vocab_size=cfg.vocab_size, seq_len=seq, global_batch=2,
        n_shards=2)).batch_at(step)


@pytest.mark.parametrize("arch", [SMOKE, MATRIX])
def test_forward_train_gradients_match_jax(arch):
    """The loss and each leaf's gradient of one f32 batch, remat on, at a
    sequence past the window: the recurrence's backward is the plain
    ``rg_lru_bwd`` (once per recurrent layer), the attention's the
    model's dense attention."""
    jcfg, tcfg, jparams, tparams = _pair(arch)
    batch = _batch(tcfg, SEQ[arch])
    jloss = jstep.make_loss_fn(jcfg, JM.CallOptions(remat="full"))
    (jl, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss = S.make_loss_fn(tcfg, M.CallOptions(remat="full"))
    rg_ops.reset_counts()
    (tl, _), tg = S.value_and_grad(
        tloss, tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    n_rec = sum(k == "rglru" for k in tcfg.block_pattern) \
        * (tcfg.n_layers // len(tcfg.block_pattern)) \
        + sum(k == "rglru" for k in
              tcfg.block_pattern[:tcfg.n_layers % len(tcfg.block_pattern)])
    # under remat each block group's forward runs again in the backward
    assert rg_ops.counts("cpu")["rg_lru_bwd"] == n_rec
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    want = dict(flatten_with_paths(jax.tree.map(np.asarray, jg)))
    got = dict(flatten_with_paths(tg))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        assert _rel(g, want[path]) < 1e-4, path


def _jax_step(cfg, shape):
    plan = jmake_plan(cfg, shape, MESH)
    return jax.jit(jstep.make_train_step(cfg, plan, JAdamW(), JSchedule(),
                                         mesh=None))


@pytest.mark.parametrize("arch", [MATRIX])
def test_three_train_steps_match_the_jax_step(arch):
    jcfg, tcfg, jparams, params = _pair(arch)
    shape_key = f"train_s{SEQ[arch]}_b2"
    jopt = jinit_opt(jparams, JAdamW())
    opt = init_opt_state(params, AdamWConfig())
    tstep = S.make_train_step(tcfg, planner.make_plan(
        tcfg, treg.get_shape(shape_key)), AdamWConfig(), ScheduleConfig())
    jfn = _jax_step(jcfg, jreg.get_shape(shape_key))
    for step in range(3):
        batch = _batch(tcfg, SEQ[arch], step)
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
    want = dict(flatten_with_paths(jax.tree.map(np.asarray, jparams)))
    for path, a in flatten_with_paths(params):
        np.testing.assert_allclose(_np(a), want[path], rtol=0, atol=1e-6,
                                   err_msg=path)
    jo = jax.tree.map(np.asarray, jopt)
    for mom in ("mu", "nu"):
        want = dict(flatten_with_paths(jo[mom]))
        for path, a in flatten_with_paths(opt[mom]):
            np.testing.assert_allclose(_np(a), want[path], rtol=1e-4,
                                       atol=1e-7, err_msg=mom + path)
    assert int(opt["count"]) == int(jo["count"]) == 3
