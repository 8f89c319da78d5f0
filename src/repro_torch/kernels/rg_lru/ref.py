"""Plain PyTorch version of the RG-LRU recurrence — what the CPU route of
``ops.rg_lru_fwd`` runs, what the CPU tests hold against the JAX
package's ``repro.models.hybrid.rg_lru`` and Pallas ``rg_lru_scan``, and
what ``chip_smoke.py`` holds the CUDA kernel against on the card.

* :func:`rg_lru_plain` — the recurrence ``h_t = a_t h_{t-1} + gate_t
  (i_t x_t)`` blocked in chunks of at most ``CHUNK`` tokens: inside a
  chunk every ``h_t`` is the sum of its inputs weighted by the decay
  products ``exp(cum_t - cum_s)`` (``s <= t``, masked before the
  exponential), and the state is carried from chunk to chunk in order.
  The decay is never a product over the whole sequence: at the model's
  inits ``log_a`` reaches -0.84 a token, so over 32,768 tokens
  ``exp(cumsum(log_a))`` underflows to 0 and a division by it gives 0/0.
  The in-chunk cumsum is taken in float64. Its exponentials are
  ``numerics.exp_f32`` (``exp_stable`` in :func:`softplus`, which the
  card's decode step also runs), so the same inputs give the same bits
  in every process (ROADMAP C18).
* :func:`rg_lru_phased_plain` — the same recurrence in the three phases
  the CUDA kernel takes (``csrc/rg_lru.cu``), chunks of ``TIME_CHUNK``
  tokens: each chunk but the last run from a zero state, the carry pass
  over chunks, each chunk run again from its carry-in. Nothing on the
  model's path calls it.
* :func:`rg_lru_bwd_plain` — the gradients, in the phases of the CUDA
  backward ``rg_lru_bwd``: the forward's mirrored in time (each chunk's
  reverse scan from a zero carry, the carry pass from the last chunk
  down, each chunk again from its carry). What the CPU route of the
  autograd ``ops.RGLRU`` runs and what ``chip_smoke.py`` holds the
  kernel against.
* :func:`model_inputs` — x, r, i and lam drawn the way a freshly
  initialised RG-LRU block makes them, for the kernel checks.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.numerics import exp_f32, exp_stable

F32 = torch.float32
GATE_C = 8.0        # Griffin's gate sharpness constant (hybrid._C)
CHUNK = 64
TIME_CHUNK = 256    # tokens per chunk of the CUDA kernel: csrc/rg_lru.cu TCHUNK


def softplus(v: torch.Tensor) -> torch.Tensor:
    """The stable form ``jax.nn.softplus`` takes (``logaddexp(v, 0)``):
    ``max(v, 0) + log1p(exp(-|v|))``."""
    return torch.clamp(v, min=0) + torch.log1p(exp_stable(-v.abs()))


def gates(r: torch.Tensor, lam: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log_a, gate): ``log_a = -8 softplus(lam) r`` and ``gate =
    sqrt(1 - a^2)`` through ``expm1``, which keeps its digits as ``a``
    approaches 1."""
    log_a = -GATE_C * softplus(lam) * r
    return log_a, torch.sqrt(-torch.expm1(2.0 * log_a))


def _linear_scan(log_a: torch.Tensor, b: torch.Tensor, h: torch.Tensor,
                 chunk: int = CHUNK) -> torch.Tensor:
    """h_t = exp(log_a_t) h_{t-1} + b_t over t of log_a, b f32 [B,S,W]
    from h f32 [B,W], blocked in chunks of at most ``chunk`` tokens (see
    the module docstring). Returns h f32 [B,S,W]."""
    B, S, W = b.shape
    out = torch.empty((B, S, W), dtype=F32, device=b.device)
    for lo in range(0, S, chunk):
        hi = min(lo + chunk, S)
        q = hi - lo
        cum = torch.cumsum(log_a[:, lo:hi].double(), dim=1)     # [B,q,W]
        diff = cum[:, :, None] - cum[:, None, :]                # [B,t,s,W]
        causal = torch.ones(q, q, dtype=torch.bool,
                            device=b.device).tril()[None, :, :, None]
        decay = exp_f32(diff.masked_fill(~causal, -math.inf).to(F32))
        out[:, lo:hi] = torch.einsum("btsw,bsw->btw", decay, b[:, lo:hi]) \
            + exp_f32(cum.to(F32)) * h[:, None]
        h = out[:, hi - 1]
    return out


def rg_lru_plain(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
                 lam: torch.Tensor, h0: Optional[torch.Tensor] = None,
                 chunk: int = CHUNK) -> torch.Tensor:
    """x, r, i f32 [B,S,W]; lam f32 [W]; h0 f32 [B,W] or None (zero).
    Returns h f32 [B,S,W]."""
    B, S, W = x.shape
    log_a, gate = gates(r.to(F32), lam.to(F32))
    b = gate * (i.to(F32) * x.to(F32))
    h = torch.zeros((B, W), dtype=F32, device=x.device) if h0 is None \
        else h0.to(F32)
    return _linear_scan(log_a, b, h, chunk)


def rg_lru_phased_plain(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
                        lam: torch.Tensor, h0: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """h f32 [B,S,W] as :func:`rg_lru_plain` returns it, in the CUDA
    kernel's three phases over chunks of ``TIME_CHUNK`` tokens (the last
    one ragged):

    1. every chunk c but the last, from a zero state: its decay product
       A_c = exp(sum of its log_a, summed in float64) and its end value;
    2. the carry into each chunk, in order: h_in_0 = h0 (or 0),
       h_in_{c+1} = A_c h_in_c + end_c;
    3. every chunk again from its carry-in.
    """
    B, S, W = x.shape
    log_a = gates(r.to(F32), lam.to(F32))[0]
    spans = [slice(lo, min(lo + TIME_CHUNK, S))
             for lo in range(0, S, TIME_CHUNK)]
    zero = torch.zeros((B, W), dtype=F32, device=x.device)
    # phase 1
    local = [(exp_f32(log_a[:, t].double().sum(1).to(F32)),
              rg_lru_plain(x[:, t], r[:, t], i[:, t], lam, zero)[:, -1])
             for t in spans[:-1]]
    # phase 2
    carry = [zero if h0 is None else h0.to(F32)]
    for dec, end in local:
        carry.append(dec * carry[-1] + end)
    # phase 3
    return torch.cat([rg_lru_plain(x[:, t], r[:, t], i[:, t], lam, h_in)
                      for t, h_in in zip(spans, carry)], dim=1)


def _reverse_scan(log_a: torch.Tensor, dy: torch.Tensor,
                  q: torch.Tensor) -> torch.Tensor:
    """The gradient reaching each h_t of one span of n tokens, from the
    right: g_t = dy_t + a_{t+1} g_{t+1}, g_{n-1} = dy_{n-1} + q, where q
    is what reaches h_{n-1} from past the span (a_n g_n) and log_a
    [B,n,W] is the span's own. :func:`_linear_scan` over the span
    reversed, its decays shifted by one token (the first one 1)."""
    shifted = torch.cat([torch.zeros_like(log_a[:, :1]),
                         log_a[:, 1:].flip(1)], dim=1)
    return _linear_scan(shifted, dy.flip(1), q).flip(1)


def rg_lru_bwd_plain(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
                     lam: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                     h0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, ...]:
    """The RG-LRU gradients, the algebra of the CUDA kernel
    ``rg_lru_bwd`` (``csrc/rg_lru.cu``) in plain tensors. x, r, i, h (the
    forward's output) and dh (the gradient of the loss with respect to
    h) f32 [B,S,W]; lam f32 [W]; h0 f32 [B,W] or None. Returns (dx, dr,
    di, dlam, dh0): dlam [W], dh0 [B,W] (the gradient with respect to
    the initial state, zero or given).

    With g_t the whole gradient reaching h_t (the reverse scan g_t = dy_t
    + a_{t+1} g_{t+1}): dx = g gate i, di = g gate x, d log_a = g (h_{t-1}
    a - i x a^2 / gate) (d gate / d log_a = -a^2 / gate, what ``jax.grad``
    of the reference's gate gives), dr = -8 softplus(lam) d log_a, dlam =
    -8 sigmoid(lam) sum over (b, t) of d log_a r, dh0 = a_0 g_0. The
    forward's phases mirrored in time, chunks of ``TIME_CHUNK`` tokens:

    1. every chunk c but the first, from a zero carry: its decay product
       A_c (as the forward's) and a_lo g_lo, what it passes to its left;
    2. the carry into each chunk from its right, from the last chunk
       (zero) down: q_{c-1} = A_c q_c + end_c;
    3. every chunk again from its carry, emitting the gradients and its
       share of dlam's sum; the shares are summed in float64 over
       (b, chunk).
    """
    B, S, W = x.shape
    x, r, i, lam, h, dh = (t.to(F32) for t in (x, r, i, lam, h, dh))
    log_a, gate = gates(r, lam)
    a = exp_stable(log_a)
    spans = [slice(lo, min(lo + TIME_CHUNK, S))
             for lo in range(0, S, TIME_CHUNK)]
    zero = torch.zeros((B, W), dtype=F32, device=x.device)
    # phase 1
    local = [(exp_f32(log_a[:, t].double().sum(1).to(F32)),
              a[:, t.start] * _reverse_scan(log_a[:, t], dh[:, t], zero)[:, 0])
             for t in spans[1:]]
    # phase 2
    carry = [zero]
    for dec, end in reversed(local):
        carry.append(dec * carry[-1] + end)
    carry.reverse()
    # phase 3
    g = torch.cat([_reverse_scan(log_a[:, t], dh[:, t], q)
                   for t, q in zip(spans, carry)], dim=1)
    h_prev = torch.cat([(zero if h0 is None else h0.to(F32))[:, None],
                        h[:, :-1]], dim=1)
    gg = g * gate
    dlog_a = g * (h_prev * a - (i * x) * (a * a) / gate)
    shares = torch.stack([(dlog_a[:, t] * r[:, t]).sum(1) for t in spans],
                         dim=1)                                # [B,nc,W]
    dlam = shares.double().sum((0, 1)).to(F32) \
        * (-GATE_C * torch.sigmoid(lam))
    return (gg * i, -GATE_C * softplus(lam) * dlog_a, gg * x, dlam,
            a[:, 0] * g[:, 0])


def model_inputs(B: int, S: int, W: int, generator: torch.Generator,
                 device, u_range: Tuple[float, float] = (0.9, 0.999)
                 ) -> Tuple[torch.Tensor, ...]:
    """(x, r, i, lam) f32 as a freshly initialised RG-LRU block feeds the
    recurrence: x ~ N(0, 1) for the conv output; r and i =
    sigmoid(x w + b) with the gate inits w ~ N(0, 0.1^2), b = 0; lam from
    the ``rglru_a`` init, softplus^-1(-log u) with u ~ U[0.9, 0.999]. The
    decays are then 0.66-0.996 a token, so the state carries over
    hundreds of tokens and a dropped carry shows. A ``u_range`` nearer 1
    gives the slow channels a trained model grows, whose decays are so
    near 1 that ``1 - a^2`` loses its digits in f32 (the gate must take
    ``expm1``)."""
    kw = dict(generator=generator, device=device, dtype=F32)
    x = torch.randn((B, S, W), **kw)
    r = torch.sigmoid(x * (0.1 * torch.randn(W, **kw)))
    i = torch.sigmoid(x * (0.1 * torch.randn(W, **kw)))
    lo, hi = u_range
    u = lo + (hi - lo) * torch.rand(W, **kw)
    lam = torch.log(torch.expm1(-torch.log(u)))
    return x, r, i, lam

