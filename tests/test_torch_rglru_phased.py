"""The RG-LRU kernel's three phases, in plain tensors, on the CPU.

``ref.rg_lru_phased_plain`` is the algebra of the CUDA kernel: every
chunk of time but the last run from a zero state (its decay product
and end value), the carry pass over chunks, then every chunk again from
its carry-in. It is held, in float32 at rtol 1e-5 (and an atol of 1e-5
x the largest element), against ``ref.rg_lru_plain``, the JAX package's
``repro.models.hybrid.rg_lru`` (its associative scan, from the same
initial state) and its Pallas ``rg_lru_scan`` in interpret mode (from a
zero state: the Pallas kernel takes none), with several chunks, a
sequence that is no multiple of the chunk, one shorter than a chunk,
and decays near one, where the carry crosses every chunk almost
undiminished.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rg_lru.ops import rg_lru_scan as jrg_lru_scan
from repro.models import hybrid as JHY
from repro_torch.kernels.rg_lru import ref as R

RTOL = 1e-5
INIT, NEAR_ONE = (0.9, 0.999), (0.99999, 0.999999)
# B, S, W, initial state, the rglru_a init's range; chunks of R.TIME_CHUNK
CASES = [
    (2, 1024, 48, True, INIT),         # 4 whole chunks
    (2, 700, 40, True, INIT),          # 3 chunks, the last of 188
    (1, 100, 33, False, INIT),         # shorter than a chunk
    (2, 1000, 32, True, NEAR_ONE),
    (1, 2051, 16, True, NEAR_ONE),     # 9 chunks, the last of 3
]


def _inputs(B, S, W, u_range, seed):
    """x, r, i, lam and h0 as numpy, drawn as a fresh block makes them
    (``ref.model_inputs``)."""
    g = torch.Generator().manual_seed(seed)
    ins = R.model_inputs(B, S, W, g, "cpu", u_range)
    h0 = torch.randn((B, W), generator=g)
    return [t.numpy() for t in (*ins, h0)]


def _close(got, want, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_phased_recurrence_matches_the_plain_version_jax_and_pallas(case):
    B, S, W, init, u_range = case
    x, r, i, lam, h0 = _inputs(B, S, W, u_range, seed=S + W)
    h0 = h0 if init else None
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = R.rg_lru_phased_plain(*map(t, (x, r, i, lam, h0)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, W)
    _close(got.numpy(), R.rg_lru_plain(*map(t, (x, r, i, lam, h0))).numpy(),
           "vs rg_lru_plain")
    want, _ = JHY.rg_lru(*map(jnp.asarray, (x, r, i, lam)),
                         None if h0 is None else jnp.asarray(h0))
    _close(got.numpy(), want, "vs hybrid.rg_lru")
    h = got if h0 is None else R.rg_lru_phased_plain(*map(t, (x, r, i, lam)))
    _close(h.numpy(), jrg_lru_scan(*map(jnp.asarray, (x, r, i, lam)),
                                   interpret=True), "vs the Pallas kernel")


def test_the_carry_crosses_every_chunk():
    """With decays near one a dropped carry-in moves every later chunk:
    the phased version from h0 differs from the one from zero well past
    the limit in the last chunk."""
    x, r, i, lam, h0 = map(torch.from_numpy,
                           _inputs(1, 600, 8, NEAR_ONE, seed=3))
    a = R.rg_lru_phased_plain(x, r, i, lam, h0)[:, -88:]
    b = R.rg_lru_phased_plain(x, r, i, lam)[:, -88:]
    assert float((a - b).abs().min()) > 100 * RTOL * float(a.abs().max())
