"""The RG-LRU gated linear recurrence, forward and backward — the port
of ``repro.kernels.rg_lru`` (``kernel.rg_lru_fwd``, ``ops.rg_lru_scan``)
and of the gradient the JAX package takes with ``jax.grad`` of its
associative scan (``repro.models.hybrid.rg_lru``).

Each of the two wrappers, ``rg_lru_fwd`` and ``rg_lru_bwd``, has two
implementations:

* on a CUDA tensor, the hand-written kernel of ``csrc/rg_lru.cu`` (built
  and bound through ``repro_torch.kernels.nvcc``), launched on the
  current stream; a refused launch raises. It cuts time into chunks and
  takes three launches (each chunk from a zero state, the carry pass
  over chunks, each chunk from its carry-in; ``ref.rg_lru_phased_plain``
  is its algebra), counted as one ``rg_lru_fwd``; their scratch (each
  chunk's decay product and end value) is allocated here. The backward
  takes four launches (the forward's phases mirrored in time, then the
  fixed-order sum of dlam's per-chunk shares; ``ref.rg_lru_bwd_plain``
  is its algebra), counted as one ``rg_lru_bwd``;
* on a CPU tensor, its plain PyTorch version (``ref.rg_lru_plain``,
  ``ref.rg_lru_bwd_plain``).

A CUDA tensor never takes the plain version. Every kernel launch adds
one to ``counts("cuda")``, every plain call one to ``counts("cpu")``. A
fake tensor of the dry run (``kernels.trace``) takes a third route: the
CUDA route's checks, its outputs and scratch allocated at the same
shapes (the chunk count from ``ref.TIME_CHUNK``, the kernel's
``TCHUNK``), no launch, one added to ``counts("fake")`` and the launch
recorded for the roofline analyzer.
``rg_lru`` is the differentiable recurrence (``RGLRU``): its backward is
``rg_lru_bwd``, on the card and on the CPU alike, so the CPU tests run
the kernel's algebra.

Inputs: x, r, i f32 ``[B,S,W]``, lam f32 ``[W]``, h0 f32 ``[B,W]`` or
None (a zero state). Output: h f32 ``[B,S,W]``.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.nvcc import CudaLibrary
from repro_torch.kernels.rg_lru.ref import (TIME_CHUNK, rg_lru_bwd_plain,
                                            rg_lru_plain)
from repro_torch.kernels.trace import fake_route, note_launch

KERNELS = ("rg_lru_fwd", "rg_lru_bwd")

_VP, _INT = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary("rg_lru", {
    "rg_lru_fwd": [_VP] * 8 + [_INT] * 3 + [_VP],
    "rg_lru_bwd": [_VP] * 15 + [_INT] * 3 + [_VP],
    "rg_lru_chunks": [_INT],
}, error_fn="rg_lru_error_string")

_count_lock = threading.Lock()
_counts: Dict[str, Dict[str, int]] = {
    "cuda": dict.fromkeys(KERNELS, 0), "cpu": dict.fromkeys(KERNELS, 0),
    "fake": dict.fromkeys(KERNELS, 0)}


def counts(route: str = "cuda") -> Dict[str, int]:
    """Calls since the last reset: CUDA kernel launches (``"cuda"``),
    plain-version calls on CPU tensors (``"cpu"``) or the dry run's
    launches on fake tensors (``"fake"``)."""
    with _count_lock:
        return dict(_counts[route])


def reset_counts() -> None:
    with _count_lock:
        for table in _counts.values():
            for k in table:
                table[k] = 0


def _route(name, x, r, i, lam, h0, *more) -> str:
    """Validate a call's tensors (``more``: further [B,S,W] inputs);
    returns "cuda", "cpu" or "fake"."""
    if x.dim() != 3 or lam.dim() != 1:
        raise ValueError(f"{name}: x, r, i must be [B,S,W] and lam [W]; "
                         f"got {tuple(x.shape)}, {tuple(lam.shape)}")
    B, S, W = x.shape
    if any(t.shape != x.shape for t in (r, i, *more)) \
            or tuple(lam.shape) != (W,) \
            or (h0 is not None and tuple(h0.shape) != (B, W)):
        raise ValueError(
            f"{name}: shapes do not agree: x {tuple(x.shape)}, r "
            f"{tuple(r.shape)}, i {tuple(i.shape)}, lam {tuple(lam.shape)}"
            + ("" if h0 is None else f", h0 {tuple(h0.shape)}")
            + "".join(f", {tuple(t.shape)}" for t in more))
    given = (x, r, i, lam, *more) + (() if h0 is None else (h0,))
    for t in given:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: every input must be float32, got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {x.device} and "
                             f"{t.device}")
    fake = fake_route(x)
    if x.device.type == "cpu" and not fake:
        return "cpu"
    if x.device.type != "cuda" and not fake:
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if any(not t.is_contiguous() for t in given):
        raise ValueError(f"{name}: inputs must be contiguous")
    return "fake" if fake else "cuda"


def _chunks(route: str, S: int) -> int:
    """The kernel's chunks of a sequence of S tokens: the library's
    count, or on the fake route the same count from ``TIME_CHUNK``."""
    if route == "fake":
        return -(-S // TIME_CHUNK)
    return LIB.library().rg_lru_chunks(S)


def _note(name: str, plain, x: torch.Tensor, *args) -> None:
    """The fake route's launch of ``name``, whose plain version is
    ``plain(x, *args)``, passed to the roofline analyzer."""
    B, S, W = x.shape
    note_launch(name, functools.partial(plain, x, *args), B=B, S=S, W=W)


def _scratch(S: int, shape, device, route: str = "cuda"
             ) -> Optional[torch.Tensor]:
    """The carry passes' scratch: f32 [2, *shape[:1], nc - 1, *shape[1:]]
    for the chunks but one of a sequence of S tokens, or None where there
    is one chunk."""
    nl = _chunks(route, S) - 1
    if nl <= 0:
        return None
    return torch.empty((2, shape[0], nl, shape[1]), dtype=torch.float32,
                       device=device)


def rg_lru_fwd(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
               lam: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h f32 [B,S,W]: the recurrence over the whole sequence from h0."""
    route = _route("rg_lru_fwd", x, r, i, lam, h0)
    with _count_lock:
        _counts[route]["rg_lru_fwd"] += 1
    if route == "cpu":
        return rg_lru_plain(x, r, i, lam, h0)
    B, S, W = x.shape
    h = torch.empty_like(x)
    # scratch: each chunk but the last's decay product and end value
    sc = _scratch(S, (B, W), x.device, route)
    if route == "fake":
        _note("rg_lru_fwd", rg_lru_plain, x, r, i, lam, h0)
        return h
    lib = LIB.library()
    dec, loc = (None, None) if sc is None else sc
    code = lib.rg_lru_fwd(
        x.data_ptr(), r.data_ptr(), i.data_ptr(), lam.data_ptr(),
        None if h0 is None else h0.data_ptr(), h.data_ptr(),
        None if dec is None else dec.data_ptr(),
        None if loc is None else loc.data_ptr(), B, S, W,
        torch.cuda.current_stream(x.device).cuda_stream)
    LIB.check(code, "rg_lru_fwd")
    return h


def rg_lru_bwd(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
               lam: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, ...]:
    """(dx, dr, di f32 [B,S,W], dlam f32 [W], dh0 f32 [B,W]): the
    gradients of ``rg_lru_fwd`` given its output h and the gradient dh
    with respect to it. dh0 is the gradient with respect to the initial
    state (zero or ``h0``)."""
    route = _route("rg_lru_bwd", x, r, i, lam, h0, h, dh)
    with _count_lock:
        _counts[route]["rg_lru_bwd"] += 1
    if route == "cpu":
        return rg_lru_bwd_plain(x, r, i, lam, h, dh, h0)
    B, S, W = x.shape
    dx, dr, di = (torch.empty_like(x) for _ in range(3))
    dlam = torch.empty_like(lam)
    dh0 = torch.empty((B, W), dtype=torch.float32, device=x.device)
    # scratch: each chunk but the first's decay product and carry, and
    # every chunk's share of dlam's sum
    sc = _scratch(S, (B, W), x.device, route)
    dlp = torch.empty((B, _chunks(route, S), W), dtype=torch.float32,
                      device=x.device)
    if route == "fake":
        _note("rg_lru_bwd", rg_lru_bwd_plain, x, r, i, lam, h, dh, h0)
        return dx, dr, di, dlam, dh0
    lib = LIB.library()
    dec, loc = (None, None) if sc is None else sc
    ptr = lambda t: None if t is None else t.data_ptr()
    code = lib.rg_lru_bwd(
        x.data_ptr(), r.data_ptr(), i.data_ptr(), lam.data_ptr(),
        h.data_ptr(), ptr(h0), dh.data_ptr(), dx.data_ptr(), dr.data_ptr(),
        di.data_ptr(), dlam.data_ptr(), dh0.data_ptr(), ptr(dec), ptr(loc),
        dlp.data_ptr(), B, S, W,
        torch.cuda.current_stream(x.device).cuda_stream)
    LIB.check(code, "rg_lru_bwd")
    return dx, dr, di, dlam, dh0


class RGLRU(torch.autograd.Function):
    """The differentiable recurrence: the forward saves x, r, i, lam, h0
    and its output h; the backward is ``rg_lru_bwd`` (the CUDA kernel on
    the card, its plain version on the CPU). Under
    ``torch.utils.checkpoint`` the forward runs again in the backward
    pass (a second ``rg_lru_fwd`` per layer)."""

    @staticmethod
    def forward(ctx, x, r, i, lam, h0):
        h = rg_lru_fwd(x, r, i, lam, h0)
        ctx.save_for_backward(x, r, i, lam, h0, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        x, r, i, lam, h0, h = ctx.saved_tensors
        dx, dr, di, dlam, dh0 = rg_lru_bwd(x, r, i, lam, h, dh.contiguous(),
                                           h0)
        return dx, dr, di, dlam, None if h0 is None else dh0


def rg_lru(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
           lam: torch.Tensor, h0: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """h f32 [B,S,W], differentiable in x, r, i, lam and h0."""
    return RGLRU.apply(x, r, i, lam, h0)


def rg_lru_scan(x, r, i, lam, *, chunk: int = 256, block_w: int = 512,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's ``rg_lru_scan`` contract: h [B,S,W] with any
    padding removed. ``chunk`` and ``block_w`` are the Pallas kernel's
    time and channel tiles; the CUDA kernel cuts time into chunks of its
    own and needs no padding, so they only have to be positive."""
    if chunk <= 0 or block_w <= 0:
        raise ValueError(f"rg_lru_scan: chunk {chunk} and block_w {block_w} "
                         "must be positive")
    return rg_lru_fwd(x, r, i, lam, h0)
