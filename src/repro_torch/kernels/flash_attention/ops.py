"""Flash attention: the forward with its row log-sum-exp, the backward's
``dq`` and ``dk/dv``, and the autograd ``Function`` over them — the port
of ``repro.kernels.flash_attention`` (``kernel.py``, ``backward.py``,
``ops.flash_attention_diff``).

Each kernel has two implementations behind one wrapper:

* on a CUDA tensor, the hand-written CUDA kernel of
  ``csrc/flash_attention.cu`` (built and bound through
  ``repro_torch.kernels.nvcc``), launched on the current stream; a
  refused launch raises. bfloat16 runs on the tensor cores (``mma.sync``
  with P and dS fed as two bf16 terms, ``cp.async`` double buffering;
  ``dk/dv`` splits each GQA group over :func:`dkv_splits` blocks whose
  f32 partials a second kernel sums in a fixed order, in scratch this
  wrapper allocates); float32 runs f32 FMAs on the CUDA cores;
* on a CPU tensor, its plain PyTorch version below: the math of the JAX
  package's ``ref.attention_ref`` plus the LSE for the forward, and the
  explicit backward formulas of ``backward.py`` for ``dq`` and ``dk/dv``
  — what the CPU tests hold against the JAX Pallas kernels (interpret
  mode) and what ``chip_smoke.py`` holds the CUDA kernels against. Their
  exponentials are ``numerics.exp_f32``, so the same inputs give the
  same bits in every process (ROADMAP C18).

A CUDA tensor never takes the plain version: the wrapper launches the
kernel or raises, and it refuses what the kernels cannot take (a head
dim outside ``HEAD_DIMS``, a tensor that is not contiguous or not
16-byte aligned, which the 16-byte ``cp.async`` copies need). Every
wrapper call on the card adds one to its count (``counts("cuda")``; the
bf16 ``dk/dv`` call is two launches, the kernel and its sum), every
plain call one to ``counts("cpu")``.

Layouts are the JAX kernels': q, out, dout ``[B, H, Sq, hd]``; k, v
``[B, Hkv, Skv, hd]``; lse and delta float32 ``[B, H, Sq]``. Masks are on
indices (query i sees key j iff j < Skv, causal j <= i, window
i - j < window), which equal the model's position masks whenever the
positions are ``arange(S)`` — the no-cache (training) branch of
``models.layers.attention_forward``.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels.numerics import exp_f32
from repro_torch.kernels.nvcc import CudaLibrary

NEG_INF = -1e30
KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
HEAD_DIMS = (16, 32, 64, 128, 256)  # the head dims the CUDA kernels take
ALIGN = 16                         # bytes: the kernels' cp.async copies
DKV_MAX_SPLIT = 4                  # blocks sharing one kv tile's group
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_VP, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DIMS = [_INT] * 5 + [_F32, _INT, _INT, _VP]   # B H Hkv Sq Skv scale
LIB = CudaLibrary("flash_attention", {            # causal window stream
    "flash_fwd": [_INT, _INT] + [_VP] * 5 + _DIMS,
    "flash_dq": [_INT, _INT] + [_VP] * 7 + _DIMS,
    "flash_dkv": [_INT, _INT] + [_VP] * 9 + [_INT] + _DIMS,
}, error_fn="flash_error_string")

_count_lock = threading.Lock()
_counts: Dict[str, Dict[str, int]] = {
    "cuda": dict.fromkeys(KERNELS, 0), "cpu": dict.fromkeys(KERNELS, 0)}


def counts(route: str = "cuda") -> Dict[str, int]:
    """Calls per kernel since the last reset: CUDA kernel launches
    (``"cuda"``) or plain-version calls on CPU tensors (``"cpu"``)."""
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


def softmax_scale(hd: int) -> float:
    """``1/sqrt(hd)`` as the float32 the JAX kernels multiply by."""
    return float(np.float32(1.0 / np.sqrt(hd)))


def _route(name: str, q: torch.Tensor, *rest: torch.Tensor) -> str:
    """Validate a call's tensors; returns "cuda" or "cpu"."""
    if q.dim() != 4 or rest[0].dim() != 4:
        raise ValueError(f"{name}: q must be [B,H,Sq,hd] and k/v "
                         f"[B,Hkv,Skv,hd], got {tuple(q.shape)} and "
                         f"{tuple(rest[0].shape)}")
    B, H, _, hd = q.shape
    Bk, Hkv, _, hdk = rest[0].shape
    if Bk != B or hdk != hd or Hkv == 0 or H % Hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(rest[0].shape)} do not form GQA heads")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {q.dtype} (float32 or bfloat16)")
    for t in rest:
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {q.device} and {t.device}")
    dev = q.device.type
    if dev == "cpu":
        return "cpu"
    if dev != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} (the kernels take "
                         f"{HEAD_DIMS})")
    for t in (q, *rest):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name}: inputs must start {ALIGN}-byte "
                             f"aligned (data_ptr {t.data_ptr():#x})")
    return "cuda"


def dkv_splits(H: int, Hkv: int) -> int:
    """How many blocks share one kv tile's GQA group in the bf16 dk/dv
    kernel: the largest divisor of the group up to ``DKV_MAX_SPLIT``.
    Under a causal mask the first kv tile sees every q tile of every
    head of its group (12 heads at starcoder2-3b); split 4 ways, its
    block does a quarter of that, near the mean per SM."""
    group = H // Hkv
    return max(d for d in range(1, min(group, DKV_MAX_SPLIT) + 1)
               if group % d == 0)


def _same_dtype(name: str, dtype: torch.dtype, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {dtype} and {t.dtype}")


def _f32(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: lse/delta must be float32")


def _dims(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int):
    B, H, Sq, hd = q.shape
    return (B, H, k.shape[1], Sq, k.shape[2], softmax_scale(hd),
            int(bool(causal)), int(window),
            torch.cuda.current_stream(q.device).cuda_stream)


# ---------------------------------------------------------------------------
# plain versions (float32 math, one (batch, kv head) group at a time so the
# [group, Sq, Skv] score tensors stay bounded at long sequences)
# ---------------------------------------------------------------------------

def _index_mask(sq: int, skv: int, causal: bool, window: int,
                device) -> torch.Tensor:
    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & (qp - kp < window)
    return mask


def _groups(q: torch.Tensor, k: torch.Tensor):
    B, H = q.shape[:2]
    Hkv = k.shape[1]
    g = H // Hkv
    for b in range(B):
        for hk in range(Hkv):
            yield b, hk, slice(hk * g, (hk + 1) * g)


def _probs(qs, kf, mask, lse_rows):
    s = torch.einsum("gqd,cd->gqc", qs, kf).masked_fill(~mask, NEG_INF)
    return exp_f32(s - lse_rows[..., None])


def flash_fwd_plain(q, k, v, *, causal: bool = True, window: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, H, Sq, hd = q.shape
    scale = softmax_scale(hd)
    mask = _index_mask(Sq, k.shape[2], causal, window, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    for b, hk, hs in _groups(q, k):
        qs = q[b, hs].float() * scale
        s = torch.einsum("gqd,cd->gqc", qs, k[b, hk].float())
        s = s.masked_fill(~mask, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = exp_f32(s - m)
        l = p.sum(dim=-1)
        out[b, hs] = torch.einsum("gqc,cd->gqd", p / l[..., None],
                                  v[b, hk].float()).to(q.dtype)
        lse[b, hs] = m[..., 0] + torch.log(torch.clamp(l, min=1e-30))
    return out, lse


def flash_dq_plain(q, k, v, dout, lse, delta, *, causal: bool = True,
                   window: int = 0) -> torch.Tensor:
    Sq, hd = q.shape[2:]
    scale = softmax_scale(hd)
    mask = _index_mask(Sq, k.shape[2], causal, window, q.device)
    dq = torch.empty_like(q)
    for b, hk, hs in _groups(q, k):
        kf = k[b, hk].float()
        p = _probs(q[b, hs].float() * scale, kf, mask, lse[b, hs])
        dp = torch.einsum("gqd,cd->gqc", dout[b, hs].float(), v[b, hk].float())
        ds = p * (dp - delta[b, hs][..., None]) * scale
        dq[b, hs] = torch.einsum("gqc,cd->gqd", ds, kf).to(q.dtype)
    return dq


def flash_dkv_plain(q, k, v, dout, lse, delta, *, causal: bool = True,
                    window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    Sq, hd = q.shape[2:]
    scale = softmax_scale(hd)
    mask = _index_mask(Sq, k.shape[2], causal, window, q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for b, hk, hs in _groups(q, k):
        qs = q[b, hs].float() * scale
        dof = dout[b, hs].float()
        p = _probs(qs, k[b, hk].float(), mask, lse[b, hs])
        dp = torch.einsum("gqd,cd->gqc", dof, v[b, hk].float())
        ds = p * (dp - delta[b, hs][..., None]) * scale
        dv[b, hk] = torch.einsum("gqc,gqd->cd", p, dof).to(v.dtype)
        dk[b, hk] = (torch.einsum("gqc,gqd->cd", ds, qs) / scale).to(k.dtype)
    return dk, dv


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def flash_fwd(q, k, v, *, causal: bool = True, window: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,H,Sq,hd] in q's dtype, lse float32 [B,H,Sq])."""
    route = _route("flash_fwd", q, k, v)
    _same_dtype("flash_fwd", q.dtype, k, v)
    _count(route, "flash_fwd")
    if route == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, window=window)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    code = LIB.library().flash_fwd(
        _DTYPE_CODE[q.dtype], q.shape[3], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        *_dims(q, k, causal, window))
    LIB.check(code, "flash_fwd")
    return out, lse


def flash_dq(q, k, v, dout, lse, delta, *, causal: bool = True,
             window: int = 0) -> torch.Tensor:
    """dq [B,H,Sq,hd] in q's dtype; ``delta = rowsum(dout * out)``."""
    route = _route("flash_dq", q, k, v, dout, lse, delta)
    _same_dtype("flash_dq", q.dtype, k, v, dout)
    _f32("flash_dq", lse, delta)
    _count(route, "flash_dq")
    if route == "cpu":
        return flash_dq_plain(q, k, v, dout, lse, delta, causal=causal,
                              window=window)
    dq = torch.empty_like(q)
    code = LIB.library().flash_dq(
        _DTYPE_CODE[q.dtype], q.shape[3], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), *_dims(q, k, causal, window))
    LIB.check(code, "flash_dq")
    return dq


def flash_dkv(q, k, v, dout, lse, delta, *, causal: bool = True,
              window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B,Hkv,Skv,hd], each summed over its kv head's group."""
    route = _route("flash_dkv", q, k, v, dout, lse, delta)
    _same_dtype("flash_dkv", q.dtype, k, v, dout)
    _f32("flash_dkv", lse, delta)
    _count(route, "flash_dkv")
    if route == "cpu":
        return flash_dkv_plain(q, k, v, dout, lse, delta, causal=causal,
                               window=window)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    nsplit, part = 1, None
    if q.dtype == torch.bfloat16:   # f32 partials: [nsplit, dK|dV, *k.shape]
        nsplit = dkv_splits(q.shape[1], k.shape[1])
        part = torch.empty((nsplit, 2, *k.shape), dtype=torch.float32,
                           device=k.device)
    code = LIB.library().flash_dkv(
        _DTYPE_CODE[q.dtype], q.shape[3], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), None if part is None
        else part.data_ptr(), nsplit, *_dims(q, k, causal, window))
    LIB.check(code, "flash_dkv")
    return dk, dv


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``rowsum(dout * out)`` in float32 (``backward.py``'s delta)."""
    return (dout.float() * out.float()).sum(dim=-1)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (``flash_attention_diff``): saves
    q, k, v, out and the LSE; its backward is the ``dq`` and ``dk/dv``
    kernels. Under ``torch.utils.checkpoint`` the forward runs again in
    the backward pass (a second ``flash_fwd`` launch per layer)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = attention_delta(out, dout)
        kw = dict(causal=ctx.causal, window=ctx.window)
        dq = flash_dq(q, k, v, dout, lse, delta, **kw)
        dk, dv = flash_dkv(q, k, v, dout, lse, delta, **kw)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0
                    ) -> torch.Tensor:
    """Differentiable attention [B,H,Sq,hd] -> [B,H,Sq,hd]."""
    return FlashAttention.apply(q, k, v, causal, window)
