"""The SSD forward's four phases and the backward's three, in plain
tensors, on the CPU.

``ref.ssd_fwd_phased_plain`` is the algebra of the CUDA forward: C.B^T
once per chunk for every head, each chunk's end state from a zero
start, the pass over chunks that turns them into chunk-start states,
then the outputs. It is held, in float32 at rtol 1e-5 (and an atol of
1e-5 x the largest element), against ``ref.ssd_fwd_plain`` (y, the
final state and every chunk-start state), the JAX package's
``repro.models.ssm.ssd_chunked`` (y and the final state) and its Pallas
``ssd_scan`` in interpret mode (y from a zero state: the Pallas kernel
takes none), over the backward's cases and one whose decays are near
one, so that the state carries across every chunk.

``ref.ssd_bwd_phased_plain`` is the algebra of the CUDA backward: the
chunk-state gradients W_c, the reverse pass over chunks, then every
gradient of a chunk from its end-state gradient, with C.B^T shared by
the heads and dB / dC summed per head group in a fixed order. Here it
is held, in float32 at rtol 1e-5 (and an atol of 1e-5 x the largest
element), against ``ref.ssd_grads_plain`` (autograd through the plain
forward) and against ``jax.grad`` of the JAX package's
``repro.models.ssm.ssd_chunked``, with several chunks, a sequence that
is no multiple of 64, a chunk equal to the sequence, an initial state,
a cotangent on the final state, and head counts that are no multiple of
the kernel's head group of 8 (one ragged group, and whole groups with a
ragged last one).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as jssd_scan
from repro.models import ssm as JSSM
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as R

RTOL = 1e-5
# B, S, H, P, N, chunk, initial state, final-state cotangent
CASES = [
    (2, 128, 3, 16, 16, 32, False, True),      # 4 chunks, one head group
    (1, 100, 5, 8, 32, 100, True, True),       # chunk = S, ragged tiles
    (2, 96, 10, 32, 64, 24, True, False),      # a group of 8, then of 2
    (1, 300, 19, 16, 16, 75, True, True),      # 4 chunks of 75; 8, 8, 3
]


def _inputs(B, S, H, P, N, seed, a_scale=1.0):
    """Inputs as the model makes them (dt a softplus, A < 0), numpy; the
    decays stay small enough that the reference's exponential of the
    masked-out upper triangle does not overflow into a NaN gradient
    (ROADMAP C10)."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    return [f(B, S, H, P),
            np.logaddexp(f(B, S, H) - 2.0, 0).astype(np.float32),
            -a_scale * np.exp(f(H) * 0.3).astype(np.float32),
            f(B, S, N), f(B, S, N), f(B, H, P, N),
            f(B, S, H, P), f(B, H, P, N)]


def _jax_grads(ins, dy, dfinal, chunk, init_state):
    def loss(x, dt, A, Bm, Cm):
        y, fin = JSSM.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk,
                                  init_state=init_state)
        out = jnp.sum(y * dy)
        if dfinal is not None:
            out = out + jnp.sum(fin * dfinal)
        return out
    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, ins))


def _close(got, want, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_phased_backward_matches_autograd_and_jax_grad(case):
    B, S, H, P, N, chunk, init, with_final = case
    x, dt, A, Bm, Cm, s0, dy, dfin = _inputs(B, S, H, P, N, seed=S + H)
    s0 = s0 if init else None
    dfin = dfin if with_final else None
    t = lambda a: None if a is None else torch.from_numpy(a)
    tins = [t(a) for a in (x, dt, A, Bm, Cm)]
    _, _, states = ssd_ops.ssd_fwd(*tins, chunk, t(s0))
    got = R.ssd_bwd_phased_plain(*tins, states, t(dy), t(dfin), chunk)
    auto = R.ssd_grads_plain(*tins, t(dy), chunk, t(dfin), t(s0))
    want = _jax_grads((x, dt, A, Bm, Cm), jnp.asarray(dy),
                      None if dfin is None else jnp.asarray(dfin), chunk,
                      None if s0 is None else jnp.asarray(s0))
    names = ("dx", "ddt", "dA", "dB", "dC")
    for name, a, b, w in zip(names, got, auto, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.isfinite(np.asarray(w)).all(), name
        _close(a.numpy(), b.numpy(), f"{name} vs autograd")
        _close(a.numpy(), np.asarray(w), f"{name} vs jax.grad")


def test_phased_backward_keeps_the_input_dtypes():
    """bf16 x, B, C give bf16 dx, dB, dC (f32 ddt, dA), as ``ssd_bwd``."""
    x, dt, A, Bm, Cm, _, dy, _ = _inputs(1, 64, 2, 8, 8, seed=1)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    tins = [bf(x), torch.from_numpy(dt), torch.from_numpy(A), bf(Bm),
            bf(Cm)]
    _, _, states = ssd_ops.ssd_fwd(*tins, 32)
    got = R.ssd_bwd_phased_plain(*tins, states, torch.from_numpy(dy), None,
                                 32)
    want = ssd_ops.ssd_bwd(*tins, states, torch.from_numpy(dy), None, 32)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape


# B, S, H, P, N, chunk, initial state, A's scale (1e-3: decays near one)
FWD_CASES = [case[:7] + (1.0,) for case in CASES] + [
    (2, 256, 9, 16, 32, 64, True, 1e-3),
    (1, 512, 3, 16, 16, 256, True, 1.0)]     # 4 tiles a chunk, 6 below


@pytest.mark.parametrize("case", FWD_CASES)
def test_phased_forward_matches_the_plain_scan_jax_and_pallas(case):
    B, S, H, P, N, chunk, init, a_scale = case
    x, dt, A, Bm, Cm, s0, _, _ = _inputs(B, S, H, P, N, seed=S + H,
                                         a_scale=a_scale)
    s0 = s0 if init else None
    t = lambda a: None if a is None else torch.from_numpy(a)
    tins = [t(a) for a in (x, dt, A, Bm, Cm)]
    got = R.ssd_fwd_phased_plain(*tins, chunk, t(s0))
    plain = R.ssd_fwd_plain(*tins, chunk, t(s0))
    for name, a, b in zip(("y", "final", "states"), got, plain):
        assert a.dtype == b.dtype == torch.float32, name
        assert a.shape == b.shape, name
        _close(a.numpy(), b.numpy(), f"{name} vs ssd_fwd_plain")
    jins = list(map(jnp.asarray, (x, dt, A, Bm, Cm)))
    jy, jfin = JSSM.ssd_chunked(*jins, chunk=chunk, init_state=None
                                if s0 is None else jnp.asarray(s0))
    _close(got[0].numpy(), jy, "y vs ssd_chunked")
    _close(got[1].numpy(), jfin, "final vs ssd_chunked")
    y0 = got[0] if s0 is None else R.ssd_fwd_phased_plain(*tins, chunk)[0]
    _close(y0.numpy(), jssd_scan(*jins, chunk=chunk, interpret=True),
           "y vs the Pallas kernel")
