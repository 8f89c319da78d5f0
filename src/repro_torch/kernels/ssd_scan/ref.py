"""Plain PyTorch versions of the Mamba-2 SSD chunked scan — what the CPU
route of ``ops.ssd_fwd`` / ``ops.ssd_bwd`` runs, what the CPU tests hold
against the JAX package, and what ``chip_smoke.py`` holds the CUDA
kernels against on the card.

* :func:`ssd_fwd_plain` / :func:`ssd_chunked_plain` — a copy of
  ``repro.models.ssm.ssd_chunked``: the same chunk blocking, float32
  math, one chunk at a time with the state carried across chunks.
  ``ssd_fwd_plain`` also returns the state at the start of every chunk
  (what the backward reads).
* :func:`ssd_fwd_phased_plain` — the same forward in the four phases
  the CUDA forward takes (``csrc/ssd_scan.cu``): C.B^T shared by the
  heads, every chunk's end state from a zero start, the pass over
  chunks, then the outputs. Nothing on the model's path calls it.
* :func:`ssd_sequential_plain` — the literal O(S) recurrence
  (``repro.kernels.ssd_scan.ref.ssd_sequential``).
* :func:`ssd_grads_plain` — ``torch.autograd.grad`` through
  ``ssd_chunked_plain``: the gradient ``jax.grad`` takes of the JAX
  function.
* :func:`ssd_bwd_phased_plain` — the same gradient in the three phases
  the CUDA backward takes (``csrc/ssd_scan.cu``), from the chunk-start
  states: the algebra of the kernel, held against the two above on the
  CPU. Nothing on the model's path calls it.
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

Every exponential of the chunked scan is ``numerics.exp_f32``, not
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

# exp_f32 stays importable from here (it was first written for this scan)
from repro_torch.kernels.numerics import exp_f32

F32 = torch.float32


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


TILE = 64          # tokens per tile of a chunk: csrc/ssd_scan.cu BT


def ssd_fwd_phased_plain(x, dt, A, Bm, Cm, chunk: int,
                         init_state: Optional[torch.Tensor] = None):
    """(y, final_state, states) as :func:`ssd_fwd_plain` returns them,
    computed in the four phases the CUDA forward takes. Per chunk c, with
    cum the in-chunk cumsum of dt * A:

    0. G = C . B^T once per (batch, chunk): no head axis;
    1. per (batch, chunk, head), every chunk independently: the chunk's
       end state from a zero start, dS_c = sum_j exp(cum_{q-1} - cum_j)
       dt_j x_j B_j^T;
    2. per (batch, head), the chunks in order: the chunk-start states
       S_0 = init_state (or 0), S_{c+1} = exp(cum_{q-1,c}) S_c + dS_c;
    3. per (batch, chunk, head): y_i = sum_{j <= i} (G_ij exp(cum_i -
       cum_j) dt_j) x_j + exp(cum_i) C_i . S_c^T, in tiles of ``TILE``
       tokens: on the diagonal tiles the decay masked before the
       exponential; below them, since cum falls through a chunk, factored
       through the last token e of the column tile, exp(cum_i - cum_e)
       exp(cum_e - cum_j), each at most 1.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    q, nc = _num_chunks(S, chunk)
    xf, dtf = _chunked(x, nc, q), _chunked(dt, nc, q)
    Bf, Cf = _chunked(Bm, nc, q), _chunked(Cm, nc, q)
    cum = torch.cumsum(dtf * A.to(F32), dim=2)               # [B,nc,q,H]
    # phase 0
    G = torch.einsum("bcin,bcjn->bcij", Cf, Bf)              # [B,nc,q,q]
    # phase 1
    scale = dtf * exp_f32(cum[:, :, -1:] - cum)
    dS = torch.einsum("bcjhp,bcjh,bcjn->bchpn", xf, scale, Bf)
    # phase 2
    g = exp_f32(cum[:, :, -1])                               # [B,nc,H]
    starts = torch.empty_like(dS)
    s = (torch.zeros((Bsz, H, P, N), dtype=F32, device=x.device)
         if init_state is None else init_state.to(F32))
    for c in range(nc):
        starts[:, c] = s
        s = g[:, c, :, None, None] * s + dS[:, c]
    # phase 3
    tile = torch.arange(q, device=x.device) // TILE
    diag = (tile[:, None] == tile[None, :]) & torch.ones(
        (q, q), dtype=torch.bool, device=x.device).tril()
    below = tile[:, None] > tile[None, :]
    last = torch.clamp((tile + 1) * TILE - 1, max=q - 1)     # e of column j
    seg = cum.permute(0, 1, 3, 2)                            # [B,nc,H,q]
    dtj = dtf.permute(0, 1, 3, 2)
    inf = float("-inf")
    L_diag = exp_f32((seg[..., :, None] - seg[..., None, :])
                     .masked_fill(~diag, inf)) * dtj[..., None, :]
    w = dtj * exp_f32(seg[..., last] - seg)                  # per column j
    L_below = exp_f32((seg[..., :, None] - seg[..., last][..., None, :])
                      .masked_fill(~below, inf)) * w[..., None, :]
    M = G[:, :, None] * (L_diag + L_below)                   # [B,nc,H,i,j]
    y = torch.einsum("bchij,bcjhp->bcihp", M, xf) + exp_f32(cum)[..., None] \
        * torch.einsum("bcin,bchpn->bcihp", Cf, starts)
    return y.reshape(Bsz, S, H, P), s, starts.permute(0, 2, 1, 3, 4)


HEAD_GROUP = 8     # heads per owner of the dB / dC sums: csrc/ssd_scan.cu HG


def ssd_bwd_phased_plain(x, dt, A, Bm, Cm, states, dy,
                         dfinal: Optional[torch.Tensor], chunk: int):
    """(dx, ddt, dA, dB, dC), each in its input's dtype — the gradient of
    ``ssd_fwd_plain`` from its chunk-start ``states`` [B,H,nc,P,N], as the
    CUDA backward decomposes it. Per chunk c, with cum the in-chunk
    cumsum of dt * A, e_i = exp(cum_i), g_c = exp(cum_{q-1}),
    e'_j = exp(cum_{q-1} - cum_j) and dS_c the gradient of the chunk's
    end state:

    0. G = C . B^T once per (batch, chunk): no head axis;
    1. W_c = sum_i e_i dy_i C_i^T per (batch, chunk, head), chunk by
       chunk independently;
    2. dS_{c-1} = g_c dS_c + W_c, dS_{nc-1} = dfinal: a reverse pass per
       (batch, head) over [P, N] tiles;
    3. every gradient of chunk c from dS_c and the chunk's start state:
       per head dx, ddt and the head's share of dA; per owner of
       ``HEAD_GROUP`` heads (the last group ragged) the sums over its
       heads of the in-chunk term dG = (dy . x^T) dt_j L (L the masked
       decay), the inter-chunk term of dC and the state term of dB,
       which give that group's dB and dC; the groups' shares summed in
       group order.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    q, nc = _num_chunks(S, chunk)
    xf, dtf, dyf = _chunked(x, nc, q), _chunked(dt, nc, q), _chunked(dy, nc, q)
    Bf, Cf = _chunked(Bm, nc, q), _chunked(Cm, nc, q)
    Af = A.to(F32)
    S0 = states.to(F32).permute(0, 2, 1, 3, 4)               # [B,nc,H,P,N]
    cum = torch.cumsum(dtf * Af, dim=2)                      # [B,nc,q,H]
    e_in = exp_f32(cum)
    e_out = exp_f32(cum[:, :, -1:] - cum)
    g = exp_f32(cum[:, :, -1])                               # [B,nc,H]

    # phase 0
    G = torch.einsum("bcin,bcjn->bcij", Cf, Bf)              # [B,nc,q,q]
    # phase 1
    W = torch.einsum("bcih,bcihp,bcin->bchpn", e_in, dyf, Cf)
    # phase 2
    dS = torch.empty_like(W)
    carry = torch.zeros_like(W[:, 0]) if dfinal is None else dfinal.to(F32)
    for c in reversed(range(nc)):
        dS[:, c] = carry
        carry = g[:, c, :, None, None] * carry + W[:, c]
    # phase 3, per head
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    seg = cum.permute(0, 1, 3, 2)                            # [B,nc,H,q]
    L = exp_f32((seg[..., :, None] - seg[..., None, :])
                .masked_fill(~causal, float("-inf")))        # [B,nc,H,i,j]
    M = torch.einsum("bcihp,bcjhp->bchij", dyf, xf)
    dG = M * dtf.permute(0, 1, 3, 2)[:, :, :, None, :] * L
    GL = G[:, :, None] * L
    dS_B = torch.einsum("bcjn,bchpn->bcjhp", Bf, dS)
    dxdt = torch.einsum("bchij,bcihp->bcjhp", GL, dyf) \
        + e_out[..., None] * dS_B
    GdG = G[:, :, None] * dG
    dcum = (GdG.sum(-1) - GdG.sum(-2)).permute(0, 1, 3, 2)   # [B,nc,q,H]
    S0_C = torch.einsum("bcin,bchpn->bcihp", Cf, S0)
    dcum = dcum + e_in * (dyf * S0_C).sum(-1)
    u = e_out * (xf * dtf[..., None] * dS_B).sum(-1)
    dcum = dcum - u
    dcum[:, :, -1] += u.sum(2) + g * (S0 * dS).sum((-1, -2))
    run = dcum.flip(2).cumsum(2).flip(2)
    dx = (dxdt * dtf[..., None]).reshape(Bsz, S, H, P)
    ddt = (run * Af + (dxdt * xf).sum(-1)).reshape(Bsz, S, H)
    dA = (run * dtf).sum((0, 1, 2))
    # phase 3, per head group: the sums over heads, in a fixed order
    dB = torch.zeros((Bsz, nc, q, N), dtype=F32, device=x.device)
    dC = torch.zeros_like(dB)
    for h0 in range(0, H, HEAD_GROUP):
        hs = range(h0, min(h0 + HEAD_GROUP, H))
        dGs = dG[:, :, h0]
        for h in hs[1:]:
            dGs = dGs + dG[:, :, h]
        hsl = slice(h0, hs[-1] + 1)
        dC_g = torch.einsum("bcij,bcjn->bcin", dGs, Bf) + torch.einsum(
            "bcih,bcihp,bchpn->bcin", e_in[..., hsl], dyf[..., hsl, :],
            S0[:, :, hsl])
        dB_g = torch.einsum("bcij,bcin->bcjn", dGs, Cf) + torch.einsum(
            "bcjh,bcjhp,bchpn->bcjn", e_out[..., hsl],
            (xf * dtf[..., None])[..., hsl, :], dS[:, :, hsl])
        dB, dC = dB + dB_g, dC + dC_g
    return (dx.to(x.dtype), ddt, dA, dB.reshape(Bsz, S, N).to(Bm.dtype),
            dC.reshape(Bsz, S, N).to(Cm.dtype))


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
