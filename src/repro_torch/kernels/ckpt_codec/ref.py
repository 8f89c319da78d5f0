"""Pure reference for the checkpoint codec: int8 block quantization
(256-lane blocks, symmetric, per-block scale) + delta encoding +
per-chunk fingerprints for dirty-chunk detection.

numpy implementations (host checkpoint path) are the oracle the CUDA
kernels and their plain PyTorch versions are validated against. This
is the JAX package's oracle carried over unchanged, minus its jnp
twins (the port imports no JAX).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

BLOCK = 256

# --- dirty-chunk fingerprint geometry --------------------------------------
# A leaf is fingerprinted in fixed-size chunks; capture transfers only the
# chunks whose fingerprint changed since the previous snapshot. 256 KiB
# balances detection granularity against per-chunk metadata (16 B of
# fingerprint per chunk on device -> 1/16384 overhead).
FP_CHUNK_BYTES = 256 * 1024
# host fingerprint: one u64 lane per segment; 8 KiB segments keep the
# reduction SIMD-friendly while bounding the blind span (see below)
FP_SEG_BYTES = 8 * 1024

# kernel fingerprint mixing constants (odd multipliers: a single changed
# int32 lane always flips the hash — (x'-x)*odd is nonzero mod 2^32)
_FP_XOR_C = 0x5BD1E995
_FP_MUL_C = 0x9E3779B1


def quantize_ref(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """x: f32 any-shape -> (q int8 [nb, BLOCK], scale f32 [nb]).
    Padded with zeros to a BLOCK multiple."""
    flat = np.asarray(x, np.float32).reshape(-1)
    n = flat.size
    pad = (-n) % BLOCK
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    xb = flat.reshape(-1, BLOCK)
    scale = np.maximum(np.abs(xb).max(axis=1), 1e-12) / 127.0
    q = np.clip(np.rint(xb / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def dequantize_ref(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """-> f32 flat [nb * BLOCK] (caller slices to logical size)."""
    return (q.astype(np.float32) * scale[:, None].astype(np.float32)).reshape(-1)


def delta_encode_ref(x: np.ndarray, prev: np.ndarray) -> np.ndarray:
    """Byte-level XOR delta (runs of zeros compress well downstream)."""
    a = np.frombuffer(np.ascontiguousarray(x).tobytes(), np.uint8)
    b = np.frombuffer(np.ascontiguousarray(prev).tobytes(), np.uint8)
    assert a.size == b.size
    return np.bitwise_xor(a, b)


def delta_decode_ref(delta: np.ndarray, prev: np.ndarray, dtype, shape):
    b = np.frombuffer(np.ascontiguousarray(prev).tobytes(), np.uint8)
    raw = np.bitwise_xor(delta, b).tobytes()
    return np.frombuffer(raw, dtype=dtype).reshape(shape)


# ---------------------------------------------------------------------------
# chunk fingerprints (dirty detection for sparse capture)
# ---------------------------------------------------------------------------

def _as_bytes(buf) -> np.ndarray:
    a = np.ascontiguousarray(buf)
    return a.reshape(-1).view(np.uint8)


def fingerprint_ref(buf, chunk_bytes: int = FP_CHUNK_BYTES) -> np.ndarray:
    """Oracle for the Pallas fingerprint kernel: two positional
    multiply-mix hashes per chunk over the int32 lanes, int32-wraparound
    arithmetic. Returns uint32 [n_chunks, 2].

    Computed in uint64 and truncated: 2^32 divides 2^64, so uint64
    wraparound then ``& 0xFFFFFFFF`` equals the kernel's int32
    wraparound exactly.
    """
    assert chunk_bytes % 4 == 0
    b = _as_bytes(buf)
    n = b.size
    pad = (-n) % chunk_bytes
    if pad:
        b = np.concatenate([b, np.zeros(pad, np.uint8)])
    ce = chunk_bytes // 4
    x = b.view(np.uint32).reshape(-1, ce).astype(np.uint64)
    pos = np.arange(ce, dtype=np.uint64)
    m1 = 2 * pos + 1
    m2 = 2 * pos + np.uint64(_FP_MUL_C)
    h1 = (x * m1).sum(axis=1) & 0xFFFFFFFF
    h2 = ((x ^ np.uint64(_FP_XOR_C)) * m2).sum(axis=1) & 0xFFFFFFFF
    return np.stack([h1, h2], axis=1).astype(np.uint32)


def fused_capture_ref(buf, prev_fp, chunk_bytes: int = FP_CHUNK_BYTES,
                      capacity: Optional[int] = None
                      ) -> Tuple[np.ndarray, int, np.ndarray, np.ndarray]:
    """Bit-identical host twin of the fused single-pass capture kernel
    (``kernel.fused_capture_blocks`` / ``ops.fused_dirty_chunk_capture``).

    Returns ``(fp u32 [n_chunks, 2], count, dirty_idx i64 [k],
    compact u8 [k, chunk_bytes])`` where ``count`` is the TOTAL dirty
    count (it may exceed ``capacity``, mirroring the kernel's overflow
    signal) and ``dirty_idx``/``compact`` hold the first
    ``min(count, capacity)`` dirty chunks in chunk order — exactly the
    rows the kernel's running-count compaction emits. The tail chunk is
    zero-padded to ``chunk_bytes``, matching the kernel's padded read.
    """
    fp = fingerprint_ref(buf, chunk_bytes)
    pf = np.ascontiguousarray(prev_fp).view(np.uint32).reshape(fp.shape)
    idx = np.nonzero(np.any(fp != pf, axis=1))[0]
    count = int(idx.size)
    kept = idx if capacity is None else idx[:capacity]
    b = _as_bytes(buf)
    pad = (-b.size) % chunk_bytes
    if pad:
        b = np.concatenate([b, np.zeros(pad, np.uint8)])
    compact = b.reshape(-1, chunk_bytes)[kept]
    return fp, count, kept.astype(np.int64), compact


def fingerprint_host(buf, chunk_bytes: int = FP_CHUNK_BYTES,
                     seg_bytes: int = FP_SEG_BYTES) -> np.ndarray:
    """Fast host fingerprint: per-segment uint64 wraparound sums,
    grouped per chunk. Returns uint64 [n_chunks, segs_per_chunk].

    ~1 SIMD read pass (vs ~3 memory ops for the multiply-mix oracle),
    which is what lets sparse capture beat a plain copy on the caller
    thread when no accelerator is attached. Detection model: any change
    to a segment's u64 word-sum is caught; blind to byte permutations
    *within* one 8 KiB segment and to exactly-compensating multi-word
    edits — neither occurs for real float/optimizer updates, and the
    device kernel path uses the positional hash instead.
    """
    seg_bytes = min(seg_bytes, chunk_bytes)
    assert chunk_bytes % seg_bytes == 0 and seg_bytes % 8 == 0
    b = _as_bytes(buf)
    n = b.size
    se = seg_bytes // 8
    n_full = (n // seg_bytes) * seg_bytes
    sums = b[:n_full].view(np.uint64).reshape(-1, se).sum(
        axis=1, dtype=np.uint64)
    if n_full < n:  # partial tail segment, zero-padded
        tail = np.zeros(seg_bytes, np.uint8)
        tail[:n - n_full] = b[n_full:]
        sums = np.concatenate(
            [sums, tail.view(np.uint64).sum(dtype=np.uint64)[None]])
    spc = chunk_bytes // seg_bytes
    pad = (-sums.size) % spc
    if pad:
        sums = np.concatenate([sums, np.zeros(pad, np.uint64)])
    return sums.reshape(-1, spc)

