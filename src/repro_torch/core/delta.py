"""Delta codec: chunked, content-addressed, optionally chained snapshot
payloads (the record-prune-replay idea of paper §VI applied to bytes).

Three leaf encodings, chosen per tensor by the snapshot pipeline:

``full``   raw bytes, split into fixed-size chunks, each stored under its
           blake2b hash. Unchanged data (frozen embeddings, stale
           optimizer slots) re-uses existing blobs for free.
``codec``  lossy int8 block quantization (kernels/ckpt_codec) applied
           before chunking; used for error-tolerant entries (optimizer
           moments), ~4x smaller. A tensor leaf is quantized where it
           lives — by the CUDA kernel at capture for a leaf on the card,
           so only the int8 codes and scales cross to the host — and
           arrives here as an ``Int8Leaf``; a numpy leaf is quantized on
           the host (``quantize_ref``). Restore keeps the codes until the
           leaf lands on its device, where ``dequantize`` rebuilds it.
``xor``    byte-level XOR against the *previous snapshot's* copy of the
           same leaf (through the ckpt_codec CUDA kernel when a card
           is attached, numpy on host), forming a delta
           chain back to a full base snapshot.
           All-zero chunks (unchanged regions) are elided entirely, and
           non-zero chunks are zlib-compressed when that shrinks them, so
           the marginal cost of a snapshot is proportional to the entropy
           of what actually changed.

The encode API is *streaming*: ``encode_leaf`` walks a tensor one chunk
at a time (no whole-tensor XOR materialization) and hands each chunk to a
``put_blob`` callable, which the async snapshot pipeline backs with a
writer thread pool. ``decode_leaf`` inverts one link; chain walking lives
in ``core.async_snapshot.materialize_manifest_chain``.

Manifest leaf format (format 2) — format-1 metas (no "mode" key) are
still decoded for old checkpoints:

    {"shape": [...], "dtype": "f32", "mode": "full|codec|xor",
     "codec": "int8"|None,
     "parts": {part: {"dtype", "shape", "chunks": [hash|None, ...],
                      "enc": ["raw"|"zlib", ...]}}}

Format 3 adds *sparse* xor parts, produced by the dirty-chunk capture
path (``encode_leaf_sparse``): instead of a dense chunk list with None
placeholders, the part records only the chunks that changed —

    {"dtype", "shape", "chunk_bytes": int, "n_chunks": int,
     "dirty": [[chunk_idx, hash, enc], ...]}

Decoding a sparse part copies the base value and XOR-patches the dirty
chunks, so chain application cost also scales with the delta. Formats
1-3 are all decoded by this module (compatibility matrix in README).

Host leaves are numpy arrays or CPU tensors (``repro_torch.host``);
decoded leaves are numpy arrays, a bfloat16 leaf as its uint16 bit
view, and codec leaves ``Int8Leaf`` holders that read as the host
decode's array. Manifests are byte-for-byte the JAX package's format:
the same dtype strings ("bfloat16"), shapes, chunking and blob hashes.
"""
from __future__ import annotations

import hashlib
import zlib
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import (Any, Callable, Deque, Dict, Iterable, Iterator, List,
                    Optional, Tuple)

import numpy as np
import torch

from repro_torch.api.errors import RestoreError
from repro_torch.host import (dtype_name, host_np_dtype, nbytes, numel,
                              torch_dtype)

CHUNK_BYTES = 4 * 1024 * 1024

# chunk-level storage encodings
ENC_RAW = "raw"
ENC_ZLIB = "zlib"
# zlib level 1: ~GB/s on mostly-zero XOR streams, which is the case that
# matters; random float chunks fail the "did it shrink" test and stay raw
_ZLIB_LEVEL = 1


def _hash(data: bytes) -> str:
    return hashlib.blake2b(data, digest_size=20).hexdigest()


def _flat_bytes(arr) -> np.ndarray:
    """Flat uint8 view of a host leaf; a view (not a copy) whenever the
    leaf is contiguous, so the sparse encoder can patch it in place."""
    if isinstance(arr, torch.Tensor):
        return arr.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)


def _same_geometry(a, b) -> bool:
    return tuple(a.shape) == tuple(b.shape) and dtype_name(a) == dtype_name(b)


# ---------------------------------------------------------------------------
# codecs (lossy, pre-chunking)
# ---------------------------------------------------------------------------

def _as_np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Int8Leaf:
    """One leaf held as the int8 codec's parts: ``q`` int8 [nb, BLOCK]
    and ``scale`` float32 [nb] (numpy arrays or tensors) of a leaf of
    ``shape`` and manifest dtype ``dtype`` (float16, float32 or
    float64).

    Capture makes one from a tensor leaf (``quantize`` where the leaf
    lives), ``encode_leaf`` writes its parts as the host codec would,
    and the decoder returns one, which ``tensor`` dequantizes on the
    device the leaf is restored to. Read as an array (``np.asarray``) it
    is the host decode: ``dequantize_ref``'s values in ``dtype``."""

    codec = "int8"

    def __init__(self, q, scale, shape, dtype: str) -> None:
        self.q = q
        self.scale = scale
        self.shape = tuple(int(d) for d in shape)
        self.dtype = host_np_dtype(dtype)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize

    def parts(self) -> Dict[str, Any]:
        return {"q": self.q, "scale": self.scale}

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        from repro_torch.kernels.ckpt_codec.ref import dequantize_ref
        out = dequantize_ref(_as_np(self.q), _as_np(self.scale))
        out = out[:self.size].reshape(self.shape).astype(self.dtype)
        return out if dtype is None else out.astype(dtype)

    def tensor(self, device) -> torch.Tensor:
        """The leaf rebuilt on ``device``: the codes and scales are
        copied there and dequantized there (the kernel on the card, the
        plain version on the CPU), then cast to the leaf's dtype."""
        from repro_torch.kernels.ckpt_codec import ops
        q, scale = (torch.as_tensor(_writable(_as_np(p)), device=device)
                    for p in (self.q, self.scale))
        flat = ops.dequantize(q, scale)
        return flat[:self.size].view(self.shape).to(
            torch_dtype(self.dtype.name))


def _writable(a: np.ndarray) -> np.ndarray:
    return a if a.flags.writeable else a.copy()


def _int8_encode(arr: np.ndarray) -> Dict[str, np.ndarray]:
    from repro_torch.kernels.ckpt_codec.ref import quantize_ref
    if isinstance(arr, torch.Tensor):
        arr = arr.to(torch.float32).numpy()
    q, scale = quantize_ref(np.asarray(arr, np.float32))
    return {"q": q, "scale": scale}


def _int8_decode(parts: Dict[str, np.ndarray], dtype: np.dtype,
                 shape: Tuple[int, ...]) -> Int8Leaf:
    return Int8Leaf(parts["q"], parts["scale"], shape, np.dtype(dtype).name)


CODECS: Dict[str, Tuple[Callable, Callable]] = {
    "int8": (_int8_encode, _int8_decode),
}


# numpy's float kind "f"; bfloat16 is not among them — the JAX package
# holds it as an ml_dtypes type of kind "V", so it never takes a codec
_CODEC_DTYPES = ("float16", "float32", "float64")


def codec_applicable(arr, codec: Optional[str]) -> bool:
    return (codec is not None and dtype_name(arr) in _CODEC_DTYPES
            and numel(arr) >= 256)


def device_codec(arr, codec: Optional[str]) -> bool:
    """Whether capture quantizes ``arr`` where it lives: a tensor leaf
    under the built-in ``int8`` codec (a codec registered through
    ``register_codec`` always encodes on the host)."""
    return (isinstance(arr, torch.Tensor)
            and CODECS.get(codec, (None,))[0] is _int8_encode
            and codec_applicable(arr, codec))


# ---------------------------------------------------------------------------
# streaming chunk encode/decode
# ---------------------------------------------------------------------------

def iter_chunk_views(arr) -> Iterator[memoryview]:
    """Yield CHUNK_BYTES-sized byte views of a tensor without copying the
    whole thing (one contiguous materialization at most)."""
    flat = _flat_bytes(arr)
    n = flat.nbytes
    if n == 0:
        yield memoryview(b"")
        return
    mv = memoryview(flat)
    for off in range(0, n, CHUNK_BYTES):
        yield mv[off:off + CHUNK_BYTES]


_PROBE_BYTES = 64 * 1024


def pack_chunk(chunk, compress: bool) -> Tuple[str, str, bytes]:
    """The pure half of storing one chunk: probe, compress, hash.
    Returns (hash, enc, payload). No store is touched, so chunks pack
    on any thread (zlib and blake2b release the GIL on buffers this
    large)."""
    chunk = bytes(chunk)
    enc = ENC_RAW
    if compress and len(chunk) > 0:
        # probe a prefix first: full-chunk zlib on incompressible float
        # noise costs real encode-thread CPU for nothing, and snapshot
        # payloads are bimodal (sparse XOR deltas ~ all compressible,
        # fresh random weights ~ not at all)
        probe = chunk[:_PROBE_BYTES]
        if len(zlib.compress(probe, _ZLIB_LEVEL)) < len(probe) * 9 // 10:
            packed = zlib.compress(chunk, _ZLIB_LEVEL)
            if len(packed) < len(chunk) * 9 // 10:
                chunk, enc = packed, ENC_ZLIB
    return _hash(chunk), enc, chunk


def _put_packed(packed: Tuple[str, str, bytes], put_blob,
                has_blob) -> Tuple[str, str, int]:
    """The ordered half: dedup against what is stored or queued, then
    store. Returns (hash, enc, bytes_written)."""
    h, enc, payload = packed
    if has_blob(h):
        return h, enc, 0
    put_blob(h, payload)
    return h, enc, len(payload)


def _store_chunks(chunks: Iterable[Optional[Any]], put_blob, has_blob,
                  compress: bool, pool: Optional[ThreadPoolExecutor] = None
                  ) -> Iterator[Optional[Tuple[str, str, int]]]:
    """Store each chunk (a bytes-like view, or None for an elided one)
    and yield (hash, enc, bytes_written), or None, in input order.

    With a ``pool`` the pack step runs on its workers, two chunks a
    worker ahead (so a worker never waits for the next one), and the
    calling thread takes the results back in chunk order for the
    ``has``/``put`` dedup: the blobs, their bytes, the dedup and the
    counts are the one-thread encode's. ``chunks`` is pulled lazily, so
    at most that window of payloads is held beside the blob writer's
    queue."""
    if pool is None:
        for c in chunks:
            yield None if c is None else _put_packed(
                pack_chunk(c, compress), put_blob, has_blob)
        return
    window: Deque[Optional[Future]] = deque()
    limit = 2 * pool._max_workers
    try:
        for c in chunks:
            window.append(None if c is None
                          else pool.submit(pack_chunk, c, compress))
            if len(window) >= limit:
                f = window.popleft()
                yield None if f is None else _put_packed(f.result(),
                                                         put_blob, has_blob)
        while window:
            f = window.popleft()
            yield None if f is None else _put_packed(f.result(), put_blob,
                                                     has_blob)
    finally:
        # a failure (or an abandoned generator) must not leave workers
        # reading a staging buffer that is about to be reused
        for f in window:
            if f is not None and not f.cancel():
                f.exception()


def _load_chunk(entry: Optional[str], enc: str, length: int,
                get_blob) -> bytes:
    if entry is None:  # elided all-zero chunk
        return bytes(length)
    data = get_blob(entry)
    if enc == ENC_ZLIB:
        data = zlib.decompress(data)
    return data


_DEVICE_XOR_MIN_BYTES = 1 << 20


def _use_device_xor() -> bool:
    """XOR through the CUDA kernel when a card is attached
    (kernels/ckpt_codec); the host path stays pure numpy so the encode
    thread never initializes CUDA on CPU-only deployments."""
    return torch.cuda.is_available()


def _encode_part(p, put_blob, has_blob, *,
                 prev=None,
                 compress: bool = True,
                 pool: Optional[ThreadPoolExecutor] = None
                 ) -> Tuple[Dict[str, Any], int]:
    """Chunk one part array; XOR against `prev` chunk-by-chunk when given
    (streaming — never materializes the full delta). Chunks pack on
    ``pool`` when one is given (``_store_chunks``)."""
    # the device-vs-host XOR decision is per-part, not per-chunk: the
    # backend probe is hoisted out of the chunk loop
    if prev is not None and _use_device_xor():
        from repro_torch.kernels.ckpt_codec import ops

        def xor(a, b):
            if a.nbytes >= _DEVICE_XOR_MIN_BYTES:
                return ops.delta_encode(a, b)
            return np.bitwise_xor(a, b)
    else:
        xor = np.bitwise_xor

    def payloads():
        prev_iter = iter_chunk_views(p if prev is None else prev)
        for view in iter_chunk_views(p):
            if prev is None:
                yield view
                continue
            delta = xor(np.frombuffer(view, np.uint8),
                        np.frombuffer(next(prev_iter), np.uint8))
            # an unchanged region costs nothing
            yield delta if delta.any() else None

    chunks: List[Optional[str]] = []
    encs: List[str] = []
    written = 0
    for res in _store_chunks(payloads(), put_blob, has_blob, compress, pool):
        if res is None:
            chunks.append(None)
            encs.append(ENC_RAW)
            continue
        chunks.append(res[0])
        encs.append(res[1])
        written += res[2]
    meta = {"dtype": dtype_name(p), "shape": list(p.shape),
            "chunks": chunks, "enc": encs}
    return meta, written


def _decode_part(pmeta: Dict[str, Any], get_blob,
                 prev: Optional[np.ndarray] = None) -> np.ndarray:
    if "dirty" in pmeta:  # format-3 sparse dirty-chunk part
        if prev is None:
            raise RestoreError("sparse xor part needs its base-step value")
        return _decode_part_sparse(pmeta, get_blob, prev)
    dt = host_np_dtype(pmeta["dtype"])
    shape = pmeta["shape"]
    total = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
    encs = pmeta.get("enc") or [ENC_RAW] * len(pmeta["chunks"])
    out = np.empty(total, np.uint8)
    off = 0
    for entry, enc in zip(pmeta["chunks"], encs):
        length = min(CHUNK_BYTES, total - off) if total else 0
        data = _load_chunk(entry, enc, length, get_blob)
        buf = np.frombuffer(data, np.uint8)
        out[off:off + len(buf)] = buf
        off += len(buf)
    if prev is not None:
        np.bitwise_xor(out, _flat_bytes(prev), out=out)
    return out.view(dt).reshape(shape)


# ---------------------------------------------------------------------------
# sparse (dirty-chunk) encode/decode — manifest format 3 leaves
# ---------------------------------------------------------------------------

def encode_leaf_sparse(
    shape: Tuple[int, ...],
    dtype: str,
    chunk_bytes: int,
    n_chunks: int,
    dirty_idx: np.ndarray,
    dirty_bytes: np.ndarray,
    prev,
    put_blob: Callable[[str, bytes], None],
    has_blob: Callable[[str], bool],
    *,
    compress: bool = True,
    patch_prev: bool = True,
    pool: Optional[ThreadPoolExecutor] = None,
) -> Dict[str, Any]:
    """Encode one leaf from a sparse dirty-chunk capture.

    ``dirty_bytes`` is the gather-compacted [k, chunk_bytes] uint8 payload
    from capture (tail chunk zero-padded); ``prev`` is the previous
    snapshot's full value of this leaf (the XOR base). Only the dirty
    chunks are XORed, hashed and stored — encode work scales with what
    changed, not with the leaf.

    When ``patch_prev`` (the pipeline's mode), ``prev`` is updated IN
    PLACE chunk by chunk, so after the leaf is encoded the buffer holds
    the *current* snapshot's bytes — the pipeline keeps one full host
    mirror alive instead of two. The dirty chunks' deltas pack on
    ``pool`` when one is given (``_store_chunks``).
    """
    dtype = str(dtype)
    total = int(np.prod(shape, dtype=np.int64)) * \
        host_np_dtype(dtype).itemsize
    prev_b = _flat_bytes(prev)
    if prev_b.size != total:
        raise ValueError(f"sparse base holds {prev_b.size} bytes, the "
                         f"leaf {total}")
    dirty: List[List[Any]] = []
    written = encoded = 0
    idxs = np.asarray(dirty_idx, np.int64)
    if idxs.size and np.any(np.diff(idxs) < 0):  # capture emits sorted;
        order = np.argsort(idxs)                 # guard other callers
        idxs = idxs[order]
        dirty_bytes = dirty_bytes[order]
    # one vectorized XOR + fancy-index patch over every full dirty chunk
    # (the hot path: k SIMD row ops instead of a k-iteration Python
    # loop); only a partial tail chunk — at most one, and only when the
    # leaf isn't a chunk multiple — takes the scalar path below. idxs
    # arrive in ascending chunk order from capture, so the tail (the
    # largest index) is last and the manifest order is unchanged.
    n_full = total // chunk_bytes
    k_full = int(np.searchsorted(idxs, n_full))
    todo: List[Tuple[int, np.ndarray]] = []   # (chunk index, XOR delta)
    if k_full:
        grid = prev_b[:n_full * chunk_bytes].reshape(n_full, chunk_bytes)
        fi = idxs[:k_full]
        cur_rows = dirty_bytes[:k_full]
        deltas = np.bitwise_xor(cur_rows, grid[fi])
        changed = deltas.any(axis=1)
        if patch_prev:
            grid[fi] = cur_rows  # in-place mirror advance, one scatter
        encoded += k_full * chunk_bytes
        todo.extend((int(idxs[j]), deltas[j]) for j in np.nonzero(changed)[0])
    for j in range(k_full, idxs.size):  # partial tail chunk
        off = int(idxs[j]) * chunk_bytes
        ln = total - off
        cur = dirty_bytes[j, :ln]
        pv = prev_b[off:off + ln]
        delta = np.bitwise_xor(cur, pv)
        encoded += ln
        if patch_prev:
            pv[:] = cur
        if delta.any():  # else a conservative dirty mark: nothing changed
            todo.append((int(idxs[j]), delta))
    for (idx, _), (h, enc, w) in zip(todo, _store_chunks(
            (d for _, d in todo), put_blob, has_blob, compress, pool)):
        dirty.append([idx, h, enc])
        written += w
    return {
        "shape": list(shape),
        "dtype": dtype,
        "codec": None,
        "mode": "xor",
        "parts": {"raw": {"dtype": dtype, "shape": list(shape),
                          "chunk_bytes": int(chunk_bytes),
                          "n_chunks": int(n_chunks),
                          "dirty": dirty}},
        "bytes_written": written,
        "bytes_encoded": encoded,
    }


def _decode_part_sparse(pmeta: Dict[str, Any], get_blob,
                        prev) -> np.ndarray:
    """Sparse chain link: copy the base value and XOR-patch only the
    dirty chunks — chain application cost scales with the delta."""
    dt = host_np_dtype(pmeta["dtype"])
    shape = pmeta["shape"]
    cb = pmeta["chunk_bytes"]
    total = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
    out = _flat_bytes(prev).copy()
    if out.size != total:
        raise RestoreError(f"sparse base holds {out.size} bytes, the "
                           f"leaf {total}")
    for idx, entry, enc in pmeta["dirty"]:
        off = idx * cb
        ln = min(cb, total - off)
        data = _load_chunk(entry, enc, ln, get_blob)
        np.bitwise_xor(out[off:off + ln], np.frombuffer(data, np.uint8),
                       out=out[off:off + ln])
    return out.view(dt).reshape(shape)


# ---------------------------------------------------------------------------
# leaf encode/decode (one tensor, one chain link)
# ---------------------------------------------------------------------------

def encode_leaf(
    arr,
    put_blob: Callable[[str, bytes], None],
    has_blob: Callable[[str], bool],
    *,
    codec: Optional[str] = None,
    prev=None,
    compress: bool = True,
    pool: Optional[ThreadPoolExecutor] = None,
) -> Dict[str, Any]:
    """Encode one tensor (numpy array or CPU tensor) into blobs + leaf
    manifest.

    ``prev`` (same shape/dtype tensor from the previous snapshot) selects
    xor mode; ``codec`` selects the lossy codec (mutually exclusive with
    xor — quantized entries rely on chunk dedup instead, so requantization
    noise never accumulates along a chain). An ``Int8Leaf`` arrives
    already quantized and is written exactly as the host codec would
    write its leaf. With a ``pool`` the chunks pack on its workers; the
    manifest, blobs and counts are the one-thread encode's."""
    if isinstance(arr, Int8Leaf):
        if codec != arr.codec:
            raise ValueError(f"an int8-coded leaf under codec {codec!r}")
        parts = arr.parts()
    else:
        if not isinstance(arr, torch.Tensor):
            arr = np.asarray(arr)
        parts = (CODECS[codec][0](arr) if codec_applicable(arr, codec)
                 else None)
    meta: Dict[str, Any] = {
        "shape": list(arr.shape),
        "dtype": dtype_name(arr),
        "codec": None,
        "parts": {},
    }
    written = 0
    if parts is not None:
        meta["mode"] = "codec"
        meta["codec"] = codec
        for pname, p in parts.items():
            pmeta, w = _encode_part(p, put_blob, has_blob,
                                    compress=compress, pool=pool)
            meta["parts"][pname] = pmeta
            written += w
    elif prev is not None and _same_geometry(prev, arr):
        meta["mode"] = "xor"
        pmeta, w = _encode_part(arr, put_blob, has_blob, prev=prev,
                                compress=compress, pool=pool)
        meta["parts"]["raw"] = pmeta
        written += w
    else:
        meta["mode"] = "full"
        pmeta, w = _encode_part(arr, put_blob, has_blob, compress=compress,
                                pool=pool)
        meta["parts"]["raw"] = pmeta
        written += w
    meta["bytes_written"] = written
    # dense modes read + process the whole leaf regardless of how little
    # changed; the sparse encoder reports only its dirty-chunk bytes here
    meta["bytes_encoded"] = nbytes(arr)
    return meta


def decode_leaf(meta: Dict[str, Any],
                get_blob: Callable[[str], bytes],
                prev=None):
    """Decode one leaf: a numpy array, or for an int8 codec leaf an
    ``Int8Leaf`` still holding its codes. xor-mode leaves need ``prev``
    — the decoded value of the same leaf at the manifest's base step."""
    dtype = host_np_dtype(meta["dtype"])
    shape = tuple(meta["shape"])
    mode = meta.get("mode")
    if mode is None:  # format-1 manifest
        mode = "codec" if meta.get("codec") else "full"
    if mode == "xor":
        if prev is None:
            raise RestoreError("xor leaf needs its base-step value")
        return _decode_part(meta["parts"]["raw"], get_blob,
                            prev=prev).reshape(shape)
    parts = {pname: _decode_part(pmeta, get_blob)
             for pname, pmeta in meta["parts"].items()}
    if mode == "codec":
        return CODECS[meta["codec"]][1](parts, dtype, shape)
    return np.asarray(parts["raw"], dtype).reshape(shape)


def leaf_blob_names(meta: Dict[str, Any]) -> List[str]:
    """Every blob hash one leaf's manifest meta references, in decode
    order (elided zero chunks excluded). The streaming-restore fetch
    planner sizes its per-leaf dependency counters from this — a leaf
    becomes decodable the moment the last of exactly these blobs lands."""
    out: List[str] = []
    for pmeta in meta["parts"].values():
        if "dirty" in pmeta:
            out.extend(h for _, h, _ in pmeta["dirty"])
        else:
            out.extend(h for h in pmeta["chunks"] if h is not None)
    return out


def referenced_hashes(manifest: Dict[str, Any]) -> set:
    out = set()
    for entry in manifest.get("entries", {}).values():
        for leaf in entry["leaves"].values():
            out.update(leaf_blob_names(leaf))
    return out
