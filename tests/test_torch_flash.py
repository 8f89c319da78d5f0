"""The port's flash attention on the CPU against the JAX package.

The plain versions of the three kernels (forward + LSE, ``dq``,
``dk/dv``) are what a CPU tensor takes and what ``chip_smoke.py`` holds
the CUDA kernels against on the card, so here they are held against
the JAX package's Pallas kernels (interpret mode, as
``tests/test_kernels.py`` runs them) and its ``ref.attention_ref``,
with ``tests/test_kernels.py``'s tolerances. The autograd ``Function``
is held against autograd through the plain forward, and the model's
no-cache route through the kernels' layouts against the model's own
dense and chunked attention.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.backward import flash_attention_bwd
from repro.kernels.flash_attention.kernel import flash_attention_fwd
from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import layers as L

SWEEP = [   # tests/test_kernels.py's forward sweep
    (2, 4, 2, 128, 128, 64),
    (1, 8, 1, 256, 256, 32),     # MQA
    (2, 4, 4, 96, 96, 64),       # MHA, ragged seq
    (1, 6, 2, 64, 320, 128),     # cross-length
]
BWD = [     # tests/test_kernels.py's backward cases
    (1, 4, 2, 128, 32, True, 0),    # GQA
    (2, 2, 1, 96, 64, True, 0),     # MQA, ragged
    (1, 4, 4, 64, 32, True, 16),    # windowed
    (1, 2, 2, 64, 32, False, 0),    # bidirectional
]


def _inputs(seed, B, H, Hkv, Sq, Skv, hd):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, Sq, hd).astype(np.float32),
            rng.randn(B, Hkv, Skv, hd).astype(np.float32),
            rng.randn(B, Hkv, Skv, hd).astype(np.float32),
            rng.randn(B, H, Sq, hd).astype(np.float32))


def _both(arrays, dtype):
    """The same values as jax arrays and torch tensors of ``dtype``
    (bf16 rounds identically on both sides: round to nearest even)."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,hd", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_matches_pallas_and_ref(B, H, Hkv, Sq, Skv, hd,
                                              dtype):
    (jq, jk, jv, _), (q, k, v, _) = _both(
        _inputs(0, B, H, Hkv, Sq, Skv, hd), dtype)
    out, _ = fa.flash_fwd(q, k, v, causal=True)
    tol = 2e-5 if dtype == "float32" else 2e-2
    for want in (jflash(jq, jk, jv, causal=True, block_q=64, block_k=64,
                        interpret=True),
                 attention_ref(jq, jk, jv, causal=True)):
        np.testing.assert_allclose(_np(out), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("window", [16, 64])
def test_plain_forward_window_matches_pallas(window):
    (jq, jk, jv, _), (q, k, v, _) = _both(
        _inputs(1, 1, 4, 2, 128, 128, 64), "float32")
    out, _ = fa.flash_fwd(q, k, v, causal=True, window=window)
    want = jflash(jq, jk, jv, causal=True, window=window, block_q=32,
                  block_k=32, interpret=True)
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,hd", SWEEP)
def test_plain_lse_matches_pallas(B, H, Hkv, Sq, Skv, hd):
    (jq, jk, jv, _), (q, k, v, _) = _both(
        _inputs(2, B, H, Hkv, Sq, Skv, hd), "float32")
    _, lse = fa.flash_fwd(q, k, v, causal=True)
    _, jlse = flash_attention_fwd(jq, jk, jv, causal=True, block_q=64,
                                  block_k=64, interpret=True,
                                  return_lse=True)
    np.testing.assert_allclose(_np(lse), _np(jlse), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,H,Hkv,S,hd,causal,win", BWD)
def test_plain_backward_matches_pallas(B, H, Hkv, S, hd, causal, win):
    """dq and dk/dv from the same (out, lse, do) as the Pallas backward
    kernels (interpret), at tests/test_kernels.py's 5e-4."""
    (jq, jk, jv, jdo), (q, k, v, do) = _both(
        _inputs(3, B, H, Hkv, S, S, hd), "float32")
    kw = dict(causal=causal, window=win)
    jout, jlse = flash_attention_fwd(jq, jk, jv, block_q=32, block_k=32,
                                     interpret=True, return_lse=True, **kw)
    jdq, jdk, jdv = flash_attention_bwd(jq, jk, jv, jout, jlse, jdo,
                                        block_q=32, block_k=32,
                                        interpret=True, **kw)
    out = torch.from_numpy(np.array(jout))
    lse = torch.from_numpy(np.array(jlse))
    delta = fa.attention_delta(out, do)
    dq = fa.flash_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, **kw)
    for a, b in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("B,H,Hkv,S,hd,causal,win", BWD)
def test_function_grads_match_jax_grad_of_ref(B, H, Hkv, S, hd, causal,
                                              win):
    """The autograd Function (plain versions on the CPU) against
    ``jax.grad`` of the naive oracle, as tests/test_kernels.py holds the
    Pallas custom_vjp."""
    arrays = _inputs(4, B, H, Hkv, S, S, hd)[:3]
    (jq, jk, jv), (q, k, v) = _both(arrays, "float32")
    gr = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(attention_ref(
        q, k, v, causal=causal, window=win))), (0, 1, 2))(jq, jk, jv)
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    torch.sin(fa.flash_attention(*ts, causal=causal, window=win)) \
        .sum().backward()
    for t, b in zip(ts, gr):
        np.testing.assert_allclose(_np(t.grad), _np(b), rtol=5e-4,
                                   atol=5e-4)


@pytest.mark.parametrize("causal,win", [(True, 0), (True, 24), (False, 0)])
def test_function_matches_autograd_through_the_plain_forward(causal, win):
    """The Function's backward (the dq and dk/dv formulas) against
    PyTorch's own autograd through the plain forward's ops: the same
    gradient to f32 rounding."""
    q, k, v, _ = (torch.from_numpy(a) for a in
                  _inputs(5, 2, 6, 2, 80, 80, 16))
    fa.reset_counts()
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    b = [t.clone().requires_grad_(True) for t in (q, k, v)]
    w = torch.from_numpy(np.random.RandomState(6).randn(2, 6, 80, 16)
                         .astype(np.float32))
    (fa.flash_attention(*a, causal=causal, window=win) * w).sum().backward()
    (fa.flash_fwd_plain(*b, causal=causal, window=win)[0] * w).sum() \
        .backward()
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-5, atol=1e-5)
    assert fa.counts("cpu") == {"flash_fwd": 1, "flash_dq": 1,
                                "flash_dkv": 1}
    assert fa.counts("cuda") == dict.fromkeys(fa.KERNELS, 0)


@pytest.mark.parametrize("S,window,chunk", [(48, 0, 16), (64, 20, 24)])
def test_model_route_matches_dense_and_chunked_attention(S, window, chunk):
    """The no-cache branch's route through the kernels' [B,H,S,hd]
    layout (index masks) equals the model's position-masked dense and
    chunked attention over positions arange(S), values and grads."""
    rng = np.random.RandomState(7)
    B, Hkv, G, hd = 2, 2, 3, 16
    q = torch.from_numpy(rng.randn(B, S, Hkv * G, hd).astype(np.float32))
    k = torch.from_numpy(rng.randn(B, S, Hkv, hd).astype(np.float32))
    v = torch.from_numpy(rng.randn(B, S, Hkv, hd).astype(np.float32))
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    outs, grads = [], []
    for route in ("flash", "dense", "chunked"):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        if route == "flash":
            o = L._flash_no_cache(*ts, causal=True, window=window)
        else:
            qg = ts[0].reshape(B, S, Hkv, G, hd)
            fn = L.dense_attention if route == "dense" else \
                lambda *a, **kw: L.chunked_attention(*a, chunk=chunk, **kw)
            o = fn(qg, ts[1], ts[2], pos, pos, causal=True, window=window)
            o = o.reshape(B, S, Hkv * G, hd)
        torch.sin(o).sum().backward()
        outs.append(o.detach())
        grads.append([t.grad for t in ts])
    for o, g in zip(outs[1:], grads[1:]):
        torch.testing.assert_close(outs[0], o, rtol=2e-5, atol=2e-5)
        for a, b in zip(grads[0], g):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_cpu_paths_never_take_the_kernel_route():
    """On the CPU the model keeps its plain attention everywhere —
    training forward, prefill and decode — so serving's proven token
    identity is untouched by the training route."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    cfg = get_smoke_config("starcoder2-3b").replace(dtype="float32")
    params = M.init_params(cfg, seed=0, device="cpu")
    toks = torch.arange(24, dtype=torch.int32).reshape(2, 12) % 200
    fa.reset_counts()
    M.forward_train(cfg, params, {"tokens": toks})
    cache = M.init_cache(cfg, 2, 16, device="cpu")
    M.prefill(cfg, params, toks, cache)
    M.decode_step(cfg, params, cache, toks[:, :1],
                  torch.tensor([12, 12], dtype=torch.int32))
    for route in ("cpu", "cuda"):
        assert fa.counts(route) == dict.fromkeys(fa.KERNELS, 0)


def test_wrapper_validates_shapes_and_dtypes():
    q = torch.zeros(1, 3, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="GQA"):
        fa.flash_fwd(q, k, k)
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_fwd(q.double(), k.double(), k.double())
    with pytest.raises(TypeError, match="mixed"):
        fa.flash_fwd(torch.zeros(1, 2, 8, 16), k.bfloat16(), k.bfloat16())


@pytest.mark.parametrize("H,Hkv,want", [(24, 2, 4), (12, 1, 4), (24, 4, 3),
                                        (4, 2, 2), (8, 8, 1), (7, 1, 1),
                                        (10, 1, 2)])
def test_dkv_splits_divide_the_group(H, Hkv, want):
    """The bf16 dk/dv kernel splits each kv head's GQA group over blocks
    that each take whole heads: the largest divisor of the group up to
    ``DKV_MAX_SPLIT`` (starcoder2-3b's 12 heads: 4 blocks of 3)."""
    n = fa.dkv_splits(H, Hkv)
    assert n == want
    assert (H // Hkv) % n == 0 and 1 <= n <= fa.DKV_MAX_SPLIT
