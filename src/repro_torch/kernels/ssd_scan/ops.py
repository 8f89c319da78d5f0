"""The Mamba-2 SSD chunked scan: the forward, its gradient and the
autograd ``Function`` over them — the port of
``repro.kernels.ssd_scan`` (``kernel.ssd_scan_fwd``, ``ops.ssd_scan``),
plus the backward the JAX package leaves to ``jax.grad``.

Each kernel has two implementations behind one wrapper:

* on a CUDA tensor, the hand-written CUDA kernel of
  ``csrc/ssd_scan.cu`` (built and bound through
  ``repro_torch.kernels.nvcc``), launched on the current stream; a
  refused launch raises. Both run chunk-parallel on the tensor cores.
  The forward is four launches (C.B^T once per chunk for every head,
  each chunk's end state from a zero start, the pass over chunks that
  makes them chunk-start states, the outputs; ``ref.ssd_fwd_phased_plain``
  is its algebra), counted as one ``ssd_fwd``; its scratch (the chunks'
  cum and C.B^T, and the states where the caller does not keep them) is
  allocated here. The backward is six launches in three phases
  (``ref.ssd_bwd_phased_plain`` is its algebra), counted as one
  ``ssd_bwd``; its scratch and the partials it leaves (dB / dC per group
  of ``HEAD_GROUP`` heads, dA per batch and chunk) are allocated here
  and summed here in a fixed order;
* on a CPU tensor, its plain PyTorch version (``ref.ssd_fwd_plain``;
  for the backward ``ref.ssd_grads_plain``, autograd through the plain
  forward from the first chunk-start state).

A CUDA tensor never takes the plain version. Every kernel launch adds
one to its count (``counts("cuda")``), every plain call one to
``counts("cpu")``. A fake tensor of the dry run (``kernels.trace``)
takes a third route: the CUDA route's checks, its outputs and scratch
allocated at the same shapes (and its partials summed), no launch, one
added to ``counts("fake")`` and the launch recorded for the roofline
analyzer.

Layouts are the model's: x ``[B,S,H,P]`` and Bm/Cm ``[B,S,N]`` in float32
or bfloat16 (one dtype for the three), dt ``[B,S,H]`` and A ``[H]``
float32; states float32. The kernels take P <= 64, N <= 128 and a chunk
of at most 1024 tokens that divides S. The forward kernel also takes
dt >= 0 and A <= 0, as the model makes them (softplus dt, A = -exp): it
splits each decay below the diagonal into two factors of at most 1, and
with a cumsum that rises inside a chunk a factor can overflow where the
plain version's single exponential stays finite. Nothing checks this on
the card, since that would cost a sync.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.nvcc import CudaLibrary
from repro_torch.kernels.trace import fake_route, note_launch
from repro_torch.kernels.ssd_scan.ref import (HEAD_GROUP, ssd_fwd_plain,
                                              ssd_grads_plain)

KERNELS = ("ssd_fwd", "ssd_bwd")
MAX_HEAD_DIM, MAX_STATE, MAX_CHUNK = 64, 128, 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_VP, _INT = ctypes.c_void_p, ctypes.c_int
_DIMS = [_INT] * 6 + [_VP]                       # B S H P N Q stream
LIB = CudaLibrary("ssd_scan", {
    "ssd_fwd": [_INT] + [_VP] * 11 + _DIMS,
    "ssd_bwd": [_INT] + [_VP] * 17 + _DIMS,
}, error_fn="ssd_error_string")

_count_lock = threading.Lock()
_counts: Dict[str, Dict[str, int]] = {
    "cuda": dict.fromkeys(KERNELS, 0), "cpu": dict.fromkeys(KERNELS, 0),
    "fake": dict.fromkeys(KERNELS, 0)}


def counts(route: str = "cuda") -> Dict[str, int]:
    """Calls per kernel since the last reset: CUDA kernel launches
    (``"cuda"``), plain-version calls on CPU tensors (``"cpu"``) or the
    dry run's launches on fake tensors (``"fake"``)."""
    with _count_lock:
        return dict(_counts[route])


def reset_counts() -> None:
    with _count_lock:
        for table in _counts.values():
            for k in table:
                table[k] = 0


def _count(route: str, name: str) -> None:
    with _count_lock:
        _counts[route][name] += 1


def _route(name: str, x, dt, A, Bm, Cm, chunk: int, *rest) -> str:
    """Validate a call's tensors; returns "cuda", "cpu" or "fake"."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3:
        raise ValueError(f"{name}: x must be [B,S,H,P], dt [B,S,H], A [H] "
                         f"and Bm/Cm [B,S,N]; got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,) \
            or tuple(Bm.shape) != (Bsz, S, N) or Cm.shape != Bm.shape:
        raise ValueError(f"{name}: shapes do not agree: x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    if x.dtype not in _DTYPE_CODE or Bm.dtype != x.dtype \
            or Cm.dtype != x.dtype:
        raise TypeError(f"{name}: x, Bm and Cm must share one dtype, float32 "
                        f"or bfloat16; got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    for t in (dt, A, *rest):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dt, A and the states must be float32, "
                            f"got {t.dtype}")
    for t in (dt, A, Bm, Cm, *rest):
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {x.device} and {t.device}")
    q = min(chunk, S)
    if S % q:
        raise ValueError(f"{name}: sequence {S} is not a multiple of the "
                         f"chunk {q}")
    dev = x.device.type
    fake = fake_route(x)
    if dev == "cpu" and not fake:
        return "cpu"
    if dev != "cuda" and not fake:
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if P > MAX_HEAD_DIM or N > MAX_STATE or q > MAX_CHUNK:
        raise ValueError(f"{name}: head dim {P}, state {N}, chunk {q} (the "
                         f"kernels take at most {MAX_HEAD_DIM}, {MAX_STATE}, "
                         f"{MAX_CHUNK})")
    for t in (x, dt, A, Bm, Cm, *rest):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return "fake" if fake else "cuda"


def _check_shape(name: str, what: str, t: Optional[torch.Tensor],
                 shape: Tuple[int, ...]) -> None:
    if t is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name}: {what} must be {shape}, got "
                         f"{tuple(t.shape)}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _note(name: str, x: torch.Tensor, N: int, q: int, plain, *args,
          **kwargs) -> None:
    """The fake route's launch of ``name``, whose plain version is
    ``plain(*args, **kwargs)``, passed to the roofline analyzer."""
    Bsz, S, H, P = x.shape
    note_launch(name, functools.partial(plain, *args, **kwargs), B=Bsz,
                S=S, H=H, P=P, N=N, q=q, esz=x.element_size())


def _dims(x: torch.Tensor, N: int, q: int):
    Bsz, S, H, P = x.shape
    return (Bsz, S, H, P, N, q,
            torch.cuda.current_stream(x.device).cuda_stream)


def ssd_fwd(x, dt, A, Bm, Cm, chunk: int,
            init_state: Optional[torch.Tensor] = None, *,
            save_states: bool = True):
    """(y f32 [B,S,H,P], final_state f32 [B,H,P,N], the chunk-start
    states f32 [B,H,nc,P,N] or None if not ``save_states``).

    On the card dt must be >= 0 and A <= 0 (see the module docstring);
    the plain CPU route takes any sign."""
    extra = () if init_state is None else (init_state,)
    route = _route("ssd_fwd", x, dt, A, Bm, Cm, chunk, *extra)
    Bsz, S, H, P = x.shape
    _check_shape("ssd_fwd", "init_state", init_state,
                 (Bsz, H, P, Bm.shape[-1]))
    _count(route, "ssd_fwd")
    if route == "cpu":
        y, final, states = ssd_fwd_plain(x, dt, A, Bm, Cm, chunk, init_state)
        return y, final, states if save_states else None
    N, q = Bm.shape[-1], min(chunk, S)
    nc, qp = S // q, -(-q // 64) * 64
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((Bsz, S, H, P), **f32)
    final = torch.empty((Bsz, H, P, N), **f32)
    # the pass over chunks needs the states: scratch if not saved
    states = torch.empty((Bsz, H, nc, P, N), **f32)
    # scratch: the chunks' cum and C.B^T per chunk
    cum = torch.empty((Bsz, H, S), **f32)
    gt = torch.empty((Bsz, nc, qp, qp), **f32)
    if route == "fake":
        _note("ssd_fwd", x, N, q, ssd_fwd_plain, x, dt, A, Bm, Cm, chunk,
              init_state)
        return y, final, states if save_states else None
    code = LIB.library().ssd_fwd(
        _DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), _ptr(init_state), y.data_ptr(),
        final.data_ptr(), states.data_ptr(), cum.data_ptr(), gt.data_ptr(),
        *_dims(x, N, q))
    LIB.check(code, "ssd_fwd")
    return y, final, states if save_states else None


def ssd_bwd(x, dt, A, Bm, Cm, states, dy, dfinal: Optional[torch.Tensor],
            chunk: int):
    """(dx, ddt, dA, dB, dC), each in its input's dtype: the gradient of
    ``ssd_fwd`` for the cotangents ``dy`` [B,S,H,P] and ``dfinal``
    [B,H,P,N] (None: zero), from the chunk-start ``states`` it saved."""
    extra = (states, dy) + (() if dfinal is None else (dfinal,))
    route = _route("ssd_bwd", x, dt, A, Bm, Cm, chunk, *extra)
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    _check_shape("ssd_bwd", "states", states,
                 (Bsz, H, S // min(chunk, S), P, N))
    _check_shape("ssd_bwd", "dy", dy, (Bsz, S, H, P))
    _check_shape("ssd_bwd", "dfinal", dfinal, (Bsz, H, P, N))
    _count(route, "ssd_bwd")
    if route == "cpu":
        return ssd_grads_plain(x, dt, A, Bm, Cm, dy, chunk, dfinal,
                               init_state=states[:, :, 0])
    q = min(chunk, S)
    nc, qp = S // q, -(-q // 64) * 64
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    ddt = torch.empty((Bsz, S, H), **f32)
    dA_part = torch.empty((Bsz, H, nc), **f32)
    groups = -(-H // HEAD_GROUP)
    dB_part = torch.empty((Bsz, groups, S, N), **f32)
    dC_part = torch.empty((Bsz, groups, S, N), **f32)
    # scratch: the chunks' cum, C.B^T per chunk, W_c then dS in place, and
    # each head's in-chunk dG tile pairs (the chunk kernel's, for dB / dC)
    cum = torch.empty((Bsz, H, S), **f32)
    gt = torch.empty((Bsz, nc, qp, qp), **f32)
    w = torch.empty((Bsz, H, nc, P, N), **f32)
    nt = qp // 64
    dg = torch.empty((Bsz, nc, H, nt * (nt + 1) // 2, 64, 64), **f32)
    if route == "fake":
        _note("ssd_bwd", x, N, q, ssd_grads_plain, x, dt, A, Bm, Cm, dy,
              chunk, dfinal, init_state=states[:, :, 0])
    else:
        code = LIB.library().ssd_bwd(
            _DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            Bm.data_ptr(), Cm.data_ptr(), states.data_ptr(), dy.data_ptr(),
            _ptr(dfinal), dx.data_ptr(), ddt.data_ptr(), dA_part.data_ptr(),
            dB_part.data_ptr(), dC_part.data_ptr(), cum.data_ptr(),
            gt.data_ptr(), w.data_ptr(), dg.data_ptr(), *_dims(x, N, q))
        LIB.check(code, "ssd_bwd")
    # the partials of the head groups and of the (batch, chunk) pairs,
    # summed in a fixed order (no atomics)
    return (dx, ddt, dA_part.sum((0, 2)), dB_part.sum(1).to(Bm.dtype),
            dC_part.sum(1).to(Cm.dtype))


class SSDScan(torch.autograd.Function):
    """Differentiable ``ssd_chunked``: the forward kernel saves the
    chunk-start states; the backward kernel takes the gradient of y and
    of the final state. ``init_state`` (prefill continuing a cache) is a
    constant: a gradient for it is refused. Under
    ``torch.utils.checkpoint`` the forward runs again in the backward
    pass (a second ``ssd_fwd`` launch per layer). On the card it takes
    dt >= 0 and A <= 0, as :func:`ssd_fwd` does."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, init_state, chunk):
        needs = any(ctx.needs_input_grad[:5])
        y, final, states = ssd_fwd(x, dt, A, Bm, Cm, chunk, init_state,
                                   save_states=needs)
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        if needs:
            ctx.save_for_backward(x, dt, A, Bm, Cm, states)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        if ctx.needs_input_grad[5]:
            raise NotImplementedError(
                "ssd_chunked: no gradient for init_state (prefill runs "
                "without gradients)")
        x, dt, A, Bm, Cm, states = ctx.saved_tensors
        dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device) \
            if dy is None else dy.contiguous()
        if dfinal is not None:
            dfinal = dfinal.contiguous()
        grads = ssd_bwd(x, dt, A, Bm, Cm, states, dy, dfinal, ctx.chunk)
        return (*grads, None, None)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable (y f32 [B,S,H,P], final_state f32 [B,H,P,N])."""
    return SSDScan.apply(x, dt, A, Bm, Cm, init_state, chunk)


def ssd_scan(x, dt, A, Bm, Cm, chunk: int = 128):
    """The JAX package's ``ssd_scan`` contract: pad S to a multiple of the
    chunk (dt = 0 on the padding, so padded steps neither decay nor
    update the state), scan, return y in x's dtype cut to S."""
    S = x.shape[1]
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        x, dt, Bm, Cm = (torch.nn.functional.pad(
            t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, Bm, Cm))
    y, _ = ssd_chunked(x, dt, A, Bm, Cm, c)
    return y[:, :S].to(x.dtype)
