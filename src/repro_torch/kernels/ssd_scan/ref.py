"""Plain PyTorch versions of the Mamba-2 SSD chunked scan — what the CPU
route of ``ops.ssd_fwd`` / ``ops.ssd_bwd`` runs, what the CPU tests hold
against the JAX package, and what ``chip_smoke.py`` holds the CUDA
kernels against on the card.

* :func:`ssd_fwd_plain` / :func:`ssd_chunked_plain` — a copy of
  ``repro.models.ssm.ssd_chunked``: the same chunk blocking, float32
  math, one chunk at a time with the state carried across chunks.
  ``ssd_fwd_plain`` also returns the state at the start of every chunk
  (what the backward reads).
* :func:`ssd_sequential_plain` — the literal O(S) recurrence
  (``repro.kernels.ssd_scan.ref.ssd_sequential``).
* :func:`ssd_grads_plain` — ``torch.autograd.grad`` through
  ``ssd_chunked_plain``: the gradient ``jax.grad`` takes of the JAX
  function.
* :func:`model_dt_A` — dt and A drawn the way the model makes them, for
  the kernel checks.

One difference from the JAX function, in the gradient only: the JAX
package builds the intra-chunk decay as ``where(causal, exp(diff), 0)``.
Above the diagonal ``diff`` is positive and ``exp`` overflows to inf
once a chunk's decay passes e^88; the forward selects 0 there, but
``jax.grad`` multiplies the zero cotangent by that inf and every
gradient becomes NaN. Here the mask is applied before the exponential
(``exp(-inf) = 0``), which gives the same forward values and a finite
gradient (ROADMAP C10).

Every exponential of the chunked scan is :func:`exp_f32`, not
``torch.exp``, so that the same inputs give the same bits in every
process (ROADMAP C16). On the CPU ``torch.exp`` of a large float32
tensor is split over threads and handed to MKL's vector math, and in
some processes one thread's share came back with errors up to ~1e-4
relative, which the intra-chunk sum carried into ``y`` (2.7e-3 apart
at |y| ~ 50). The contractions gave the same bits in every process.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

F32 = torch.float32

# exp(x) = 2^k * e^r with k = round(x / ln 2) and r = x - k ln 2 split in
# two parts (ln 2's high part has few enough bits that k * _LN2_HI is
# exact), e^r from a degree-7 polynomial (SLEEF's expf coefficients);
# all of them float32 values
_LOG2E = 1.44269502162933349609375
_LN2_HI = 0.693145751953125
_LN2_LO = 1.428606765330187045e-06
_EXP_POLY = (1.98527617612853646278381e-4, 1.39304355252534151077271e-3,
             8.33336077630519866943359e-3, 4.16664853692054748535156e-2,
             1.66666671633720397949219e-1, 0.5)


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2^k for integer-valued float32 k in [-126, 127], from its bits."""
    return ((k.to(torch.int32) + 127) << 23).view(F32)


def _exp_values(x: torch.Tensor) -> torch.Tensor:
    xc = x.clamp(-104.0, 89.0)
    k = torch.round(xc * _LOG2E)
    r = (xc - k * _LN2_HI) - k * _LN2_LO
    u = torch.full_like(r, _EXP_POLY[0])
    for c in _EXP_POLY[1:]:
        u = u * r + c
    e = (r * r) * u + r + 1.0
    k1 = torch.floor(k * 0.5)
    e = e * _pow2(k1) * _pow2(k - k1)
    e = e.masked_fill(x < -104.0, 0.0)     # past 88.7 the product is inf
    return torch.where(torch.isnan(x), x, e)


class _Exp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = _exp_values(x)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        out, = ctx.saved_tensors
        return g * out


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp of a float32 tensor from IEEE multiplies, adds, rounding and
    bit shifts alone: each element's bits depend on its value only, not
    on the thread split, the alignment or the device (within ~1 ulp of
    ``torch.exp``; -inf gives 0). Its gradient is ``g * exp_f32(x)``."""
    return _Exp.apply(x)


def _chunked(t: torch.Tensor, nc: int, q: int) -> torch.Tensor:
    """[B, S, ...] float32 -> [B, nc, q, ...]."""
    return t.to(F32).reshape(t.shape[0], nc, q, *t.shape[2:])


def _num_chunks(S: int, chunk: int) -> Tuple[int, int]:
    q = min(chunk, S)
    if S % q:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {q}")
    return q, S // q


def _decay(cum: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
    """exp(cum_i - cum_j) on and below the diagonal, 0 above it.
    cum: [B, q, H] -> [B, H, q, q]; masked before the exponential."""
    seg = cum.transpose(1, 2)
    diff = seg[..., :, None] - seg[..., None, :]
    return exp_f32(diff.masked_fill(~causal, float("-inf")))


def ssd_fwd_plain(x, dt, A, Bm, Cm, chunk: int,
                  init_state: Optional[torch.Tensor] = None):
    """x [B,S,H,P], dt [B,S,H], A [H], Bm/Cm [B,S,N], init_state
    [B,H,P,N] -> (y f32 [B,S,H,P], final_state f32 [B,H,P,N], the state
    at the start of each chunk f32 [B,H,nc,P,N])."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    q, nc = _num_chunks(S, chunk)
    xf, dtf = _chunked(x, nc, q), _chunked(dt, nc, q)
    Bf, Cf = _chunked(Bm, nc, q), _chunked(Cm, nc, q)
    Af = A.to(F32)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    s = (torch.zeros((Bsz, H, P, N), dtype=F32, device=x.device)
         if init_state is None else init_state.to(F32))
    ys, starts = [], []
    for c in range(nc):
        starts.append(s)
        xc, dtc, bc, cc = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        cum = torch.cumsum(dtc * Af, dim=1)                  # [B,q,H]
        xdt = xc * dtc[..., None]
        L = _decay(cum, causal)                              # [B,H,q,q]
        scores = torch.einsum("bin,bjn->bij", cc, bc)        # [B,q,q]
        y_intra = torch.einsum("bhij,bjhp->bihp", scores[:, None] * L, xdt)
        y_inter = torch.einsum("bqn,bhpn,bqh->bqhp", cc, s, exp_f32(cum))
        decay_to_end = exp_f32(cum[:, -1:, :] - cum)
        st = torch.einsum("bqn,bqhp,bqh->bhpn", bc, xdt, decay_to_end)
        s = s * exp_f32(cum[:, -1, :])[:, :, None, None] + st
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bsz, S, H, P)
    return y, s, torch.stack(starts, dim=2)


def ssd_chunked_plain(x, dt, A, Bm, Cm, chunk: int,
                      init_state: Optional[torch.Tensor] = None):
    """(y f32 [B,S,H,P], final_state f32 [B,H,P,N]) — ``ssd_chunked``."""
    y, final, _ = ssd_fwd_plain(x, dt, A, Bm, Cm, chunk, init_state)
    return y, final


def ssd_sequential_plain(x, dt, A, Bm, Cm) -> torch.Tensor:
    """The O(S) recurrence h_t = h_{t-1} e^{dt A} + dt x_t B_t^T,
    y_t = h_t C_t; y f32 [B,S,H,P]."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Af = A.to(F32)
    h = torch.zeros((Bsz, H, P, N), dtype=F32, device=x.device)
    ys = []
    for t in range(S):
        xt, dtt = x[:, t].to(F32), dt[:, t].to(F32)
        bt, ct = Bm[:, t].to(F32), Cm[:, t].to(F32)
        upd = torch.einsum("bhp,bn->bhpn", xt * dtt[..., None], bt)
        h = h * torch.exp(dtt * Af)[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, ct))
    return torch.stack(ys, dim=1)


def ssd_grads_plain(x, dt, A, Bm, Cm, dy, chunk: int,
                    dfinal: Optional[torch.Tensor] = None,
                    init_state: Optional[torch.Tensor] = None):
    """(dx, ddt, dA, dB, dC), each in its input's dtype: autograd of
    ``<y, dy> + <final_state, dfinal>`` through ``ssd_chunked_plain``
    (``init_state`` held constant)."""
    leaves = [t.detach().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    with torch.enable_grad():
        y, final = ssd_chunked_plain(*leaves, chunk, init_state)
        outs, cots = [y], [dy.to(F32)]
        if dfinal is not None:
            outs.append(final)
            cots.append(dfinal.to(F32))
        return torch.autograd.grad(outs, leaves, cots)


def model_dt_A(B: int, S: int, H: int, generator: torch.Generator,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt f32 [B,S,H] and A f32 [H] drawn the way a freshly initialised
    Mamba-2 block makes them: dt = softplus(N(0,1) + dt_bias), with
    softplus(dt_bias) log-uniform on [1e-3, 0.1] per head (the
    ``ssm_dt`` init), and A = -uniform[1, 16] (the ``ssm_a`` init). The
    slow heads then decay by O(1) over a whole 256-token chunk and
    across chunks, so every tile of a chunk and the carried state weigh
    in the result."""
    kw = dict(generator=generator, device=device)
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.exp(lo + (hi - lo) * torch.rand(H, **kw))
    dt_bias = u + torch.log(-torch.expm1(-u))
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), **kw) + dt_bias)
    A = -(1.0 + 15.0 * torch.rand(H, **kw))
    return dt, A


def blocking_spread(a: Sequence[torch.Tensor],
                    b: Sequence[torch.Tensor]) -> list:
    """For each pair of outputs of the same function blocked two ways
    (the plain version at two chunk lengths), the largest elementwise
    ``|a - b| / (|a| + rms(a))``: the rounding spread that reblocking
    alone causes, from which the kernels' tolerances are set."""
    out = []
    for u, v in zip(a, b):
        u, v = u.to(F32), v.to(F32)
        rms = u.square().mean().sqrt()
        out.append(float(((u - v).abs() / (u.abs() + rms + 1e-30)).max()))
    return out


def tolerance(spread: float) -> float:
    """The rtol a kernel is held to against the plain version: 4 x the
    plain version's own blocking spread (:func:`blocking_spread`), and
    at least 1e-4."""
    return max(4 * spread, 1e-4)


def within(got: torch.Tensor, want: torch.Tensor, rtol: float) -> float:
    """The worst element's share of its limit ``rtol * (|want| +
    rms(want))`` — the elementwise rule ``rtol*|plain| + atol`` with
    ``atol = rtol * rms(plain)``; at most 1 passes."""
    g, w = got.to(F32), want.to(F32)
    lim = rtol * (w.abs() + w.square().mean().sqrt()) + 1e-30
    return float(((g - w).abs() / lim).max())
