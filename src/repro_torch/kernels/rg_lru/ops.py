"""The RG-LRU gated linear recurrence (forward) — the port of
``repro.kernels.rg_lru`` (``kernel.rg_lru_fwd``, ``ops.rg_lru_scan``).

One wrapper, two implementations:

* on a CUDA tensor, the hand-written kernel of ``csrc/rg_lru.cu`` (built
  and bound through ``repro_torch.kernels.nvcc``), launched on the
  current stream; a refused launch raises. It cuts time into chunks and
  takes three launches (each chunk from a zero state, the carry pass
  over chunks, each chunk from its carry-in; ``ref.rg_lru_phased_plain``
  is its algebra), counted as one ``rg_lru_fwd``; their scratch (each
  chunk's decay product and end value) is allocated here;
* on a CPU tensor, its plain PyTorch version (``ref.rg_lru_plain``).

A CUDA tensor never takes the plain version. Every kernel launch adds
one to ``counts("cuda")``, every plain call one to ``counts("cpu")``.
There is no backward kernel yet (hybrid training waits for it, ROADMAP
Next slices 1), so a CUDA input that requires grad is refused rather
than given a silent zero gradient; on the CPU autograd runs through the
plain version.

Inputs: x, r, i f32 ``[B,S,W]``, lam f32 ``[W]``, h0 f32 ``[B,W]`` or
None (a zero state). Output: h f32 ``[B,S,W]``.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

from repro_torch.kernels.nvcc import CudaLibrary
from repro_torch.kernels.rg_lru.ref import rg_lru_plain

KERNELS = ("rg_lru_fwd",)

_VP, _INT = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary("rg_lru", {
    "rg_lru_fwd": [_VP] * 8 + [_INT] * 3 + [_VP],
    "rg_lru_chunks": [_INT],
}, error_fn="rg_lru_error_string")

_count_lock = threading.Lock()
_counts: Dict[str, Dict[str, int]] = {
    "cuda": dict.fromkeys(KERNELS, 0), "cpu": dict.fromkeys(KERNELS, 0)}


def counts(route: str = "cuda") -> Dict[str, int]:
    """Calls since the last reset: CUDA kernel launches (``"cuda"``) or
    plain-version calls on CPU tensors (``"cpu"``)."""
    with _count_lock:
        return dict(_counts[route])


def reset_counts() -> None:
    with _count_lock:
        for table in _counts.values():
            for k in table:
                table[k] = 0


def _route(x, r, i, lam, h0) -> str:
    """Validate a call's tensors; returns "cuda" or "cpu"."""
    if x.dim() != 3 or lam.dim() != 1:
        raise ValueError(f"rg_lru_fwd: x, r, i must be [B,S,W] and lam [W]; "
                         f"got {tuple(x.shape)}, {tuple(lam.shape)}")
    B, S, W = x.shape
    if r.shape != x.shape or i.shape != x.shape or tuple(lam.shape) != (W,) \
            or (h0 is not None and tuple(h0.shape) != (B, W)):
        raise ValueError(
            f"rg_lru_fwd: shapes do not agree: x {tuple(x.shape)}, r "
            f"{tuple(r.shape)}, i {tuple(i.shape)}, lam {tuple(lam.shape)}"
            + ("" if h0 is None else f", h0 {tuple(h0.shape)}"))
    given = (x, r, i, lam) + (() if h0 is None else (h0,))
    for t in given:
        if t.dtype != torch.float32:
            raise TypeError(f"rg_lru_fwd: every input must be float32, got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"rg_lru_fwd: tensors on {x.device} and "
                             f"{t.device}")
    if x.device.type == "cpu":
        return "cpu"
    if x.device.type != "cuda":
        raise ValueError(f"rg_lru_fwd: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in given):
        raise NotImplementedError(
            "rg_lru_fwd: the CUDA kernel has no backward yet (hybrid "
            "training, ROADMAP Next slices 1); run it under no_grad")
    if any(not t.is_contiguous() for t in given):
        raise ValueError("rg_lru_fwd: inputs must be contiguous")
    return "cuda"


def rg_lru_fwd(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
               lam: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h f32 [B,S,W]: the recurrence over the whole sequence from h0."""
    route = _route(x, r, i, lam, h0)
    with _count_lock:
        _counts[route]["rg_lru_fwd"] += 1
    if route == "cpu":
        return rg_lru_plain(x, r, i, lam, h0)
    lib = LIB.library()
    B, S, W = x.shape
    h = torch.empty_like(x)
    # scratch: each chunk but the last's decay product and end value
    nl = lib.rg_lru_chunks(S) - 1
    dec, loc = torch.empty((2, B, nl, W), dtype=torch.float32,
                           device=x.device) if nl > 0 else (None, None)
    code = lib.rg_lru_fwd(
        x.data_ptr(), r.data_ptr(), i.data_ptr(), lam.data_ptr(),
        None if h0 is None else h0.data_ptr(), h.data_ptr(),
        None if dec is None else dec.data_ptr(),
        None if loc is None else loc.data_ptr(), B, S, W,
        torch.cuda.current_stream(x.device).cuda_stream)
    LIB.check(code, "rg_lru_fwd")
    return h


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
