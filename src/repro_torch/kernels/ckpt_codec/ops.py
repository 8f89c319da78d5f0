"""Wrappers for the checkpoint codec kernels: chunk fingerprints, the
fused dirty-chunk capture, the byte XOR of chained snapshots, and the
int8 snapshot codec's block quantize and dequantize.

Each kernel has two implementations behind one wrapper:

* on a CUDA tensor, the hand-written CUDA kernel of
  ``csrc/ckpt_codec.cu`` (built and bound through
  ``repro_torch.kernels.nvcc``), launched on the current stream of the
  calling thread; a refused launch raises;
* on a CPU tensor, its plain PyTorch version below — the same integer
  arithmetic (int64 products masked to 32 bits) — which the CPU tests
  hold against the numpy oracle ``ref.py`` and the JAX package's Pallas
  kernels, and which ``chip_smoke.py`` holds against the CUDA kernel
  (the codec pair in IEEE float32: a true division, never a multiply by
  the reciprocal, so every version gives ``quantize_ref``'s bits).

A CUDA tensor never takes the plain version: the wrapper launches the
kernel or raises. Every kernel launch adds one to its launch count
(``counts("cuda")``); every plain call adds one to ``counts("cpu")``,
so a run can show which route it went through.

The wrapper contracts are those of ``repro.kernels.ckpt_codec.ops``:
``chunk_fingerprints``, ``fused_capacity`` (same numbers),
``fused_dirty_chunk_capture`` -> ``(fp, dirty_idx, dirty_bytes)`` with
the overflow fallback, ``dirty_chunk_capture``, ``delta_encode``,
``delta_decode``, ``quantize`` and ``dequantize``.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.host import host_np_dtype, resolve_device
from repro_torch.kernels.ckpt_codec.ref import BLOCK, FP_CHUNK_BYTES
from repro_torch.kernels.nvcc import CudaLibrary

# fingerprint mixing constants — shared with ref.fingerprint_ref
_FP_XOR_C = 0x5BD1E995
_FP_MUL_C = 0x9E3779B1
_MASK32 = 0xFFFFFFFF

KERNELS = ("fingerprint", "fused_capture", "xor", "quantize", "dequantize")

_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
LIB = CudaLibrary("ckpt_codec", {
    "ckpt_fingerprint": [_VP, _LL, _LL, _VP, _VP],
    "ckpt_fused_capture": [_VP, _LL, _LL, _VP, _INT, _VP, _VP, _VP, _VP,
                           _VP, _VP],
    "ckpt_xor": [_VP, _VP, _VP, _LL, _VP],
    "ckpt_quantize": [_VP, _LL, _VP, _VP, _VP],
    "ckpt_dequantize": [_VP, _VP, _LL, _VP, _VP],
}, error_fn="ckpt_error_string")

_count_lock = threading.Lock()
_counts: Dict[str, Dict[str, int]] = {
    "cuda": dict.fromkeys(KERNELS, 0), "cpu": dict.fromkeys(KERNELS, 0)}
# how fused captures ended: within the compaction buffer ("hits") or
# past it, finished by the gather fallback ("overflows")
_fused_outcomes: Dict[str, int] = {"hits": 0, "overflows": 0}


def counts(route: str = "cuda") -> Dict[str, int]:
    """Calls per kernel since the last reset: CUDA kernel launches
    (``"cuda"``) or plain-version calls on CPU tensors (``"cpu"``)."""
    with _count_lock:
        return dict(_counts[route])


def fused_outcomes() -> Dict[str, int]:
    """Fused captures that fit their compaction buffer (``hits``) and
    those that overflowed it (``overflows``), since the last reset."""
    with _count_lock:
        return dict(_fused_outcomes)


def reset_counts() -> None:
    with _count_lock:
        for table in (*_counts.values(), _fused_outcomes):
            for k in table:
                table[k] = 0


def _count(route: str, name: str) -> None:
    with _count_lock:
        _counts[route][name] += 1


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"checkpoint codec kernels run on CUDA or CPU "
                     f"tensors, not {t.device}")


def _u8(x: torch.Tensor) -> torch.Tensor:
    """Flat uint8 view of a tensor's bytes (a copy only when ``x`` is
    not contiguous)."""
    x = x.detach()
    if not x.is_contiguous():
        x = x.contiguous()
    return x.reshape(-1).view(torch.uint8)


def _n_chunks(nbytes: int, chunk_bytes: int) -> int:
    return -(-nbytes // chunk_bytes)


def _check_u8(t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.uint8 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{what} must be a flat contiguous uint8 tensor")


def _check_fp(fp: torch.Tensor, n_chunks: int, device) -> None:
    if fp.dtype != torch.int32 or tuple(fp.shape) != (n_chunks, 2) \
            or not fp.is_contiguous() or fp.device != device:
        raise ValueError(
            f"prev_fp must be a contiguous int32 [{n_chunks}, 2] tensor on "
            f"{device}, got {fp.dtype} {tuple(fp.shape)} on {fp.device}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# plain PyTorch versions (any device; the wrappers use them on the CPU)
# ---------------------------------------------------------------------------

def _signed32(v: torch.Tensor) -> torch.Tensor:
    """int64 holding a value mod 2^32 -> the same bits as signed int32,
    still in int64 (so products of two stay below 2^62)."""
    v = v & _MASK32
    return v - ((v >> 31) << 32)


def _padded_chunks(u8: torch.Tensor, chunk_bytes: int) -> torch.Tensor:
    """uint8 [n_chunks, chunk_bytes], the tail chunk zero-padded."""
    n = u8.numel()
    total = _n_chunks(n, chunk_bytes) * chunk_bytes
    if total == n:
        return u8.view(-1, chunk_bytes)
    out = torch.zeros(total, dtype=torch.uint8, device=u8.device)
    out[:n] = u8
    return out.view(-1, chunk_bytes)


# chunks hashed per step of the plain fingerprint: bounds its int64
# temporaries to ~8x this many chunks' bytes
_PLAIN_FP_GROUP = 64


def fingerprint_plain(u8: torch.Tensor, chunk_bytes: int) -> torch.Tensor:
    """Plain version of the fingerprint kernel: int32 [n_chunks, 2].
    ``h1 = Σ x·(2p+1)`` and ``h2 = Σ (x ⊕ 0x5BD1E995)·(2p + 0x9E3779B1)``
    over each chunk's int32 lanes, modulo 2^32."""
    chunks = _padded_chunks(u8, chunk_bytes)
    ce = chunk_bytes // 4
    p = torch.arange(ce, dtype=torch.int64, device=u8.device)
    m1 = _signed32(2 * p + 1)
    m2 = _signed32(2 * p + _FP_MUL_C)
    xor_c = _signed32(torch.tensor(_FP_XOR_C, dtype=torch.int64))
    out = torch.empty((chunks.shape[0], 2), dtype=torch.int32,
                      device=u8.device)
    for lo in range(0, chunks.shape[0], _PLAIN_FP_GROUP):
        x = chunks[lo:lo + _PLAIN_FP_GROUP].view(torch.int32) \
            .to(torch.int64)
        h1 = ((x * m1) & _MASK32).sum(dim=1) & _MASK32
        h2 = (((x ^ xor_c.to(x.device)) * m2) & _MASK32).sum(dim=1) \
            & _MASK32
        out[lo:lo + _PLAIN_FP_GROUP, 0] = _signed32(h1).to(torch.int32)
        out[lo:lo + _PLAIN_FP_GROUP, 1] = _signed32(h2).to(torch.int32)
    return out


def _fused_layout(capacity: int, chunk_bytes: int) -> Tuple[int, int]:
    """(header bytes, total bytes) of the fused capture's one output
    buffer: int32 count, int32 idx [capacity], then the 16-byte-aligned
    compaction buffer [capacity, chunk_bytes] — one allocation, so the
    host fetches count, indices and payload in ONE device->host copy."""
    hdr = -(-4 * (1 + capacity) // 16) * 16
    return hdr, hdr + capacity * chunk_bytes


def _fused_views(buf: torch.Tensor, capacity: int, chunk_bytes: int):
    hdr, _ = _fused_layout(capacity, chunk_bytes)
    return (buf[:4].view(torch.int32), buf[4:4 + 4 * capacity]
            .view(torch.int32), buf[hdr:].view(capacity, chunk_bytes))


def fused_unpack(buf: np.ndarray, capacity: int, chunk_bytes: int
                 ) -> Tuple[int, np.ndarray, np.ndarray]:
    """Host view of a fused output buffer: (count, idx [capacity],
    compact [capacity, chunk_bytes]); only the first ``min(count,
    capacity)`` rows of idx and compact are defined."""
    hdr, _ = _fused_layout(capacity, chunk_bytes)
    count = int(buf[:4].view(np.int32)[0])
    idx = buf[4:4 + 4 * capacity].view(np.int32)
    return count, idx, buf[hdr:].reshape(capacity, chunk_bytes)


def gather_chunks(u8: torch.Tensor, idx: np.ndarray,
                  chunk_bytes: int) -> torch.Tensor:
    """uint8 [k, chunk_bytes] holding chunks ``idx`` (ascending) of a
    leaf's bytes, the partial tail chunk zero-padded."""
    n = u8.numel()
    n_full = n // chunk_bytes
    k = int(idx.size)
    out = torch.empty((k, chunk_bytes), dtype=torch.uint8, device=u8.device)
    k_full = int(np.searchsorted(idx, n_full))
    if k_full:
        sel = torch.as_tensor(np.asarray(idx[:k_full], np.int64),
                              device=u8.device)
        out[:k_full] = u8[:n_full * chunk_bytes].view(n_full, chunk_bytes) \
            .index_select(0, sel)
    if k_full < k:   # at most one partial tail chunk, always last
        tail = n - n_full * chunk_bytes
        out[k_full, :tail] = u8[n_full * chunk_bytes:]
        out[k_full, tail:] = 0
    return out


def fused_capture_plain(u8: torch.Tensor, prev_fp: torch.Tensor,
                        chunk_bytes: int, capacity: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused capture kernel: (fp, packed buffer),
    the buffer laid out as ``_fused_layout`` says."""
    fp = fingerprint_plain(u8, chunk_bytes)
    dirty = torch.nonzero((fp != prev_fp).any(dim=1)).flatten().cpu() \
        .numpy()
    _, total = _fused_layout(capacity, chunk_bytes)
    buf = torch.zeros(total, dtype=torch.uint8, device=u8.device)
    cnt, idx, compact = _fused_views(buf, capacity, chunk_bytes)
    kept = dirty[:capacity]
    cnt[0] = int(dirty.size)
    if kept.size:
        idx[:kept.size] = torch.as_tensor(kept.astype(np.int32),
                                          device=u8.device)
        compact[:kept.size] = gather_chunks(u8, kept, chunk_bytes)
    return fp, buf


def xor_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the XOR kernel."""
    return torch.bitwise_xor(a, b)


def _f32_blocks(x: torch.Tensor) -> torch.Tensor:
    """f32 [nb, BLOCK]: ``x`` flattened, cast to float32 where it lives
    (rounding as numpy's ``astype`` does) and zero-padded to a BLOCK
    multiple."""
    flat = x.detach().reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(-1, BLOCK)


def quantize_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the quantize kernel: per 256-element block,
    ``scale = max(amax, 1e-12) / 127`` and ``q = clip(round(x / scale),
    ±127)`` in float32, half to even. Both divisions divide by a tensor
    on ``x``'s device: a divisor held as a Python or CPU scalar lets
    PyTorch's CUDA kernel multiply by its reciprocal instead, which is
    not numpy's result."""
    xb = _f32_blocks(x)
    amax = xb.abs().amax(dim=1)
    scale = torch.div(amax.clamp_min(1e-12), torch.full_like(amax, 127.0))
    q = torch.div(xb, scale[:, None]).round_().clamp_(-127, 127)
    return q.to(torch.int8), scale


def dequantize_plain(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of the dequantize kernel: flat f32 ``q · scale``."""
    return (q.to(torch.float32) * scale[:, None]).reshape(-1)


# ---------------------------------------------------------------------------
# kernel launches (CUDA tensors)
# ---------------------------------------------------------------------------

def _fingerprint_cuda(u8: torch.Tensor, chunk_bytes: int) -> torch.Tensor:
    _check_u8(u8, "x")
    fp = torch.empty((_n_chunks(u8.numel(), chunk_bytes), 2),
                     dtype=torch.int32, device=u8.device)
    with torch.cuda.device(u8.device):
        code = LIB.library().ckpt_fingerprint(
            u8.data_ptr(), u8.numel(), chunk_bytes, fp.data_ptr(),
            _stream(u8.device))
    LIB.check(code, "ckpt_fingerprint")
    _count("cuda", "fingerprint")
    return fp


def _fused_capture_cuda(u8: torch.Tensor, prev_fp: torch.Tensor,
                        chunk_bytes: int, capacity: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_u8(u8, "x")
    n_chunks = _n_chunks(u8.numel(), chunk_bytes)
    _check_fp(prev_fp, n_chunks, u8.device)
    if capacity < 1:
        raise ValueError(f"capacity={capacity} must be >= 1")
    fp = torch.empty((n_chunks, 2), dtype=torch.int32, device=u8.device)
    flags = torch.empty(max(n_chunks, 1), dtype=torch.int32,
                        device=u8.device)
    buf = torch.empty(_fused_layout(capacity, chunk_bytes)[1],
                      dtype=torch.uint8, device=u8.device)
    cnt, idx, compact = _fused_views(buf, capacity, chunk_bytes)
    with torch.cuda.device(u8.device):
        code = LIB.library().ckpt_fused_capture(
            u8.data_ptr(), u8.numel(), chunk_bytes, prev_fp.data_ptr(),
            capacity, fp.data_ptr(), flags.data_ptr(), cnt.data_ptr(),
            idx.data_ptr(), compact.data_ptr(), _stream(u8.device))
    LIB.check(code, "ckpt_fused_capture")
    _count("cuda", "fused_capture")
    return fp, buf


def _xor_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check_u8(a, "a")
    _check_u8(b, "b")
    if a.numel() != b.numel() or a.device != b.device:
        raise ValueError("XOR operands need equal length on one device")
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        code = LIB.library().ckpt_xor(a.data_ptr(), b.data_ptr(),
                                        out.data_ptr(), a.numel(),
                                        _stream(a.device))
    LIB.check(code, "ckpt_xor")
    _count("cuda", "xor")
    return out


def _quantize_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if not x.is_floating_point():
        raise ValueError(f"quantize takes a float tensor, not {x.dtype}")
    flat = x.detach().reshape(-1)
    if flat.dtype != torch.float32:
        flat = flat.to(torch.float32)
    flat = flat.contiguous()
    nb = -(-flat.numel() // BLOCK)
    q = torch.empty((nb, BLOCK), dtype=torch.int8, device=x.device)
    scale = torch.empty(nb, dtype=torch.float32, device=x.device)
    if nb == 0:                     # nothing to launch, nothing counted
        return q, scale
    with torch.cuda.device(x.device):
        code = LIB.library().ckpt_quantize(flat.data_ptr(), flat.numel(),
                                           q.data_ptr(), scale.data_ptr(),
                                           _stream(x.device))
    LIB.check(code, "ckpt_quantize")
    _count("cuda", "quantize")
    return q, scale


def _dequantize_cuda(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    nb = q.shape[0]
    if q.dtype != torch.int8 or tuple(q.shape) != (nb, BLOCK) \
            or scale.dtype != torch.float32 or tuple(scale.shape) != (nb,) \
            or scale.device != q.device:
        raise ValueError(
            f"dequantize takes int8 [nb, {BLOCK}] codes and float32 [nb] "
            f"scales on one device, got {q.dtype} {tuple(q.shape)} on "
            f"{q.device} and {scale.dtype} {tuple(scale.shape)} on "
            f"{scale.device}")
    q = q.contiguous()
    if q.data_ptr() % 8:            # the kernel loads 8 codes a thread
        q = q.clone()
    scale = scale.contiguous()
    out = torch.empty(nb * BLOCK, dtype=torch.float32, device=q.device)
    if nb == 0:
        return out
    with torch.cuda.device(q.device):
        code = LIB.library().ckpt_dequantize(q.data_ptr(), scale.data_ptr(),
                                             nb, out.data_ptr(),
                                             _stream(q.device))
    LIB.check(code, "ckpt_dequantize")
    _count("cuda", "dequantize")
    return out


# ---------------------------------------------------------------------------
# kernel-level wrappers: the CUDA kernel on a CUDA tensor, the plain
# version on a CPU tensor (counterparts of kernel.py's *_blocks)
# ---------------------------------------------------------------------------

def fingerprint_blocks(x: torch.Tensor, chunk_bytes: int) -> torch.Tensor:
    u8 = _u8(x)
    if _route(u8) == "cuda":
        return _fingerprint_cuda(u8, chunk_bytes)
    _count("cpu", "fingerprint")
    return fingerprint_plain(u8, chunk_bytes)


def fused_capture_blocks(x: torch.Tensor, prev_fp: torch.Tensor,
                         chunk_bytes: int, capacity: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    u8 = _u8(x)
    if _route(u8) == "cuda":
        return _fused_capture_cuda(u8, prev_fp, chunk_bytes, capacity)
    _check_fp(prev_fp, _n_chunks(u8.numel(), chunk_bytes), u8.device)
    _count("cpu", "fused_capture")
    return fused_capture_plain(u8, prev_fp, chunk_bytes, capacity)


def xor_blocks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _route(a) == "cuda":
        return _xor_cuda(a, b)
    _count("cpu", "xor")
    return xor_plain(a, b)


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Int8 block quantization of a float tensor where it lives: any
    shape (float16/64 cast to float32 first) -> ``(q int8 [nb, BLOCK],
    scale float32 [nb])``, zero-padded to a BLOCK multiple — the
    contract of ``repro.kernels.ckpt_codec.ops.quantize`` and the bits
    of ``ref.quantize_ref``."""
    if _route(x) == "cuda":
        return _quantize_cuda(x)
    _count("cpu", "quantize")
    return quantize_plain(x)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q · scale`` per block -> flat float32 ``[nb * BLOCK]`` (the
    caller slices to the logical size)."""
    if _route(q) == "cuda":
        return _dequantize_cuda(q, scale)
    _count("cpu", "dequantize")
    return dequantize_plain(q, scale)


# ---------------------------------------------------------------------------
# delta XOR of host buffers
# ---------------------------------------------------------------------------

def _host_u8(x) -> np.ndarray:
    a = np.ascontiguousarray(x).reshape(-1).view(np.uint8)
    return a if a.flags.writeable else a.copy()


def delta_encode(x: np.ndarray, prev: np.ndarray, *,
                 device=None) -> np.ndarray:
    """Byte XOR of two equal-length host buffers through the XOR kernel
    on ``device`` (default: the CUDA card). Returns uint8[len]."""
    a, b = _host_u8(x), _host_u8(prev)
    if a.size != b.size:
        raise ValueError(f"delta_encode of {a.size} vs {b.size} bytes")
    dev = resolve_device(device)
    out = xor_blocks(torch.from_numpy(a).to(dev),
                     torch.from_numpy(b).to(dev))
    return out.cpu().numpy()


def delta_decode(delta: np.ndarray, prev: np.ndarray, dtype, shape, *,
                 device=None) -> np.ndarray:
    """XOR is its own inverse; reinterpret the result (bfloat16 as its
    uint16 bit view)."""
    raw = delta_encode(delta, prev, device=device)
    name = dtype if isinstance(dtype, str) else str(np.dtype(dtype))
    return raw.view(host_np_dtype(name)).reshape(shape)


# ---------------------------------------------------------------------------
# dirty-chunk capture
# ---------------------------------------------------------------------------

def _prev_fp_tensor(prev_fp, device) -> torch.Tensor:
    if isinstance(prev_fp, np.ndarray):  # ref-twin callers hold u32
        prev_fp = torch.from_numpy(
            np.ascontiguousarray(prev_fp).view(np.int32))
    return prev_fp.to(device)


def chunk_fingerprints(x: torch.Tensor,
                       chunk_bytes: int = FP_CHUNK_BYTES) -> torch.Tensor:
    """Per-chunk fingerprints of a tensor, computed where it lives:
    int32 [n_chunks, 2] on ``x.device``. The leaf is read once; only the
    fingerprints are small enough to keep resident and compare.
    chunk_bytes must be a multiple of 4*BLOCK (one i32 lane row)."""
    if chunk_bytes % (4 * BLOCK):
        raise ValueError(f"chunk_bytes={chunk_bytes} must be a multiple "
                         f"of {4 * BLOCK}")
    return fingerprint_blocks(x, chunk_bytes)


def dirty_chunk_capture(x: torch.Tensor, prev_fp,
                        chunk_bytes: int = FP_CHUNK_BYTES
                        ) -> Tuple[torch.Tensor, np.ndarray,
                                   Optional[np.ndarray]]:
    """The two-launch incremental capture of one leaf (fingerprint,
    mask sync, gather, payload sync): ``(new_fp [device], dirty_idx
    [host i64], dirty_bytes [host u8 [k, chunk_bytes] or None])``."""
    fp = chunk_fingerprints(x, chunk_bytes)
    prev = _prev_fp_tensor(prev_fp, fp.device)
    return _gather_dirty(_u8(x), fp, prev, chunk_bytes)


def _gather_dirty(u8: torch.Tensor, fp: torch.Tensor, prev: torch.Tensor,
                  chunk_bytes: int):
    mask = (fp != prev).any(dim=1).cpu().numpy()
    idx = np.nonzero(mask)[0]
    if idx.size == 0:
        return fp, idx.astype(np.int64), None
    host = gather_chunks(u8, idx, chunk_bytes).cpu().numpy()
    return fp, idx.astype(np.int64), host


# the JAX kernel's compaction buffer stays VMEM-resident for its whole
# grid, so its size is bounded; 8 MB left room for the input tile and
# fingerprints inside a 16 MB VMEM. The CUDA kernel's buffer lies in
# device memory, but the policy is kept so the host contract — and the
# numbers the contract tests pin — are unchanged.
_FUSED_VMEM_BUDGET = 8 << 20
# capacity floor: below this the power-of-two bucketing would chase
# every tiny dirty-count fluctuation
_FUSED_MIN_CAPACITY = 8


def fused_capacity(n_chunks: int, chunk_bytes: int,
                   hint: Optional[int] = None) -> int:
    """Compaction-buffer capacity (in chunks) for one fused launch.

    2x the caller's hint (the leaf's dirty count last snapshot — change
    rates are stable step to step), clamped to the leaf and to the
    budget, then rounded up to a power of two."""
    cap = max(_FUSED_MIN_CAPACITY,
              2 * (hint if hint is not None else _FUSED_MIN_CAPACITY))
    cap = min(cap, n_chunks, max(1, _FUSED_VMEM_BUDGET // chunk_bytes))
    return 1 << (cap - 1).bit_length()


def fused_dirty_chunk_capture(
        x: torch.Tensor, prev_fp, chunk_bytes: int = FP_CHUNK_BYTES, *,
        capacity_hint: Optional[int] = None
        ) -> Tuple[torch.Tensor, np.ndarray, Optional[np.ndarray]]:
    """Single-pass incremental capture of one leaf: ONE fused kernel
    call (three CUDA launches on one stream) and ONE blocking
    device->host copy of ``(count, idx, compact)``.

    Returns ``(new_fp [device], dirty_idx [host i64], dirty_bytes [host
    u8 [k, chunk_bytes] or None])``, the contract of
    :func:`dirty_chunk_capture`, which stays the fallback: when more
    than ``capacity`` chunks are dirty (the kernel keeps counting past
    the buffer so the host can tell), the gather path finishes the job,
    reusing the fingerprints already computed.

    ``capacity_hint`` sizes the compaction buffer (chunks dirty last
    snapshot); see :func:`fused_capacity`."""
    if chunk_bytes % (4 * BLOCK):
        raise ValueError(f"chunk_bytes={chunk_bytes} must be a multiple "
                         f"of {4 * BLOCK}")
    u8 = _u8(x)
    prev = _prev_fp_tensor(prev_fp, u8.device)
    n_chunks = _n_chunks(u8.numel(), chunk_bytes)
    capacity = fused_capacity(n_chunks, chunk_bytes, capacity_hint)
    fp, buf = fused_capture_blocks(u8, prev, chunk_bytes, capacity)
    # the one blocking hop: count + indices + compacted payload together
    k, idx_h, compact_h = fused_unpack(buf.cpu().numpy(), capacity,
                                       chunk_bytes)
    with _count_lock:
        _fused_outcomes["overflows" if k > capacity else "hits"] += 1
    if k == 0:
        return fp, np.empty(0, np.int64), None
    if k > capacity:
        # overflow: the change rate outran the buffer. Finish via the
        # gather fallback, reusing the fingerprints (the caller's next
        # hint is k)
        return _gather_dirty(u8, fp, prev, chunk_bytes)
    return fp, idx_h[:k].astype(np.int64), compact_h[:k]
