"""Elementwise math whose bits depend on the values alone.

On the CPU, ``torch.exp`` of a large float32 tensor is split over
threads and handed to MKL's vector math, and in some processes one
thread's share came back with errors up to ~1e-4 relative (ROADMAP C16,
C18): the same inputs then gave other bits from one process to the
next. The port's plain versions — what the CPU tests hold against the
JAX package and what ``chip_smoke.py`` holds the kernels against — take
their exponentials from here instead:

* :func:`exp_f32` — exp from IEEE adds, multiplies, rounding and bit
  shifts, the same bits on every thread split, alignment and device;
* :func:`exp_stable` — :func:`exp_f32` on a CPU tensor and ``torch.exp``
  on any other, for model code that also runs on the card, where
  ``torch.exp`` is deterministic and ~20 elementwise passes would slow
  the timed paths.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.trace import on_card

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


def exp_stable(x: torch.Tensor) -> torch.Tensor:
    """exp of a float32 tensor with the same bits in every process:
    :func:`exp_f32` on the CPU, ``torch.exp`` elsewhere (and on the dry
    run's fake tensors that take the card's routes, ``trace.on_card``)."""
    return exp_f32(x) if x.device.type == "cpu" and not on_card(x) \
        else torch.exp(x)
