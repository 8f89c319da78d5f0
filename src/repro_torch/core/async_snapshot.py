"""Asynchronous snapshot pipeline: overlap checkpointing with the step
loop (paper §I's "periodic snapshots in the background", made real).

A snapshot moves through three phases:

  capture   (caller thread, blocking, fast) device arrays are copied into
            a *staging slot* — preallocated, reusable host buffers — at a
            step boundary. This is the only stall the train/serve loop
            pays; everything the checkpoint needs (host bytes, structure,
            pruned op-log, job metadata) is frozen here, so the caller may
            mutate its state immediately after ``snapshot()`` returns.
  encode    (single encode thread, ordered) each leaf runs through the
            delta codec (core.delta / kernels.ckpt_codec): int8
            quantization for error-tolerant kinds (done at capture, on
            the card, for tensor leaves), XOR against the
            previous snapshot's staging slot when delta chaining is on,
            content-addressed chunking always. Each chunk's probe,
            compression and hash run on a pack pool of
            ``encode_workers()`` threads; the encode thread takes them
            back in chunk order and does the dedup and the blob queueing
            itself, so manifests, blobs and byte counts are the
            one-thread encode's (the JAX package packs on its encode
            thread: a difference of scheduling, not of bytes).
  commit    chunk blobs stream to the backend on a writer pool
            (``put_blob`` fan-out, bounded in-flight bytes); once every
            blob is durable the manifest is committed by the backend's
            fsync+rename protocol. A checkpoint exists iff its manifest
            does — a crash anywhere earlier leaves only invisible garbage
            blobs, never a corrupt "latest".

Double buffering: with chaining off, two slots (one encoding, one free to
capture) give full overlap. With chaining on, the previous snapshot's
slot stays pinned as the XOR base until its successor commits, so a third
slot keeps capture overlapped. If every slot is pinned when ``snapshot()``
is called, backpressure applies: ``"block"`` waits for the pipeline to
drain a slot, ``"skip"`` drops the request (counted in ``stats``) — a
snapshot cadence faster than the storage can absorb degrades to the
storage's rate instead of queueing unboundedly.

Delta chains: every ``delta_base_interval``-th snapshot is a full base;
the ones between store XOR deltas whose manifest records ``base_step``.
``materialize_manifest_chain`` walks base links back to the full base and
re-applies deltas forward. GC keeps the transitive base closure of every
retained manifest, so a kept checkpoint is always restorable.

Sparse (dirty-chunk) capture: with chaining on, capture no longer pays a
full device->host copy of every leaf. Each tensor leaf's previous-
snapshot fingerprints (per-chunk hashes from the kernels/ckpt_codec
fingerprint kernel, kept as an int32 tensor on the leaf's device) are
compared against the current value; only the chunks whose fingerprint
changed are compacted and transferred. On the card this is ONE fused
kernel call per leaf (``ops.fused_dirty_chunk_capture``: fingerprint,
compare against the device-resident baseline, and chunk-ordered
compaction into a bounded buffer, in a single read of the leaf)
followed by ONE blocking device->host copy — vs the two-launch path
(fingerprint, mask sync, gather, payload sync), which remains the
fallback when a step dirties more chunks than the compaction buffer
holds. On a CPU tensor the same calls run the kernels' plain PyTorch
versions; numpy leaves use host segment-sum fingerprints. The buffer is
sized adaptively from each leaf's previous dirty count. A tensor that
is the same object as last capture, at the same address and with an
unchanged version counter (no in-place write since), is skipped without
reading a byte — tensors, unlike jax Arrays, are mutated in place (the
serving engine writes its KV cache that way), so object identity alone
would be unsound.
The encode thread then XORs only those dirty chunks against the pinned
previous-snapshot host mirror (``encode_leaf_sparse``, manifest format
3) and patches the mirror in place, so exactly one full host copy stays
alive. Capture stall AND encode work scale with the per-step change
rate, not the model size. Snapshots are assumed to be requested from one
caller thread (fingerprint state is advanced at capture time).
"""
from __future__ import annotations

import os
import threading
import time
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FuturesTimeout
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.errors import PolicyError, RestoreError, SnapshotError
from repro_torch.core.backends.base import CheckpointBackend
from repro_torch.core import delta as deltamod
from repro_torch.core.oplog import OpLog
from repro_torch.core.split_state import UpperHalf
from repro_torch.host import byte_view, dtype_name, host_copy, nbytes
from repro_torch.kernels.ckpt_codec import ops
from repro_torch.kernels.ckpt_codec.ref import FP_CHUNK_BYTES, FP_SEG_BYTES
from repro_torch.tree import flatten_with_paths

MANIFEST_FORMAT = 2         # dense manifests (no sparse leaves)
SPARSE_MANIFEST_FORMAT = 3  # at least one dirty-chunk (sparse) leaf

# bound on blob bytes queued to the writer pool per snapshot; keeps the
# encode thread from racing ahead of a slow backend unboundedly
MAX_PENDING_WRITES = 32


def encode_workers() -> int:
    """Threads that pack a snapshot's chunks: the restore's decode pool
    rule (``materialize_manifest_chain``). 1 packs on the encode thread
    itself."""
    return min(8, os.cpu_count() or 1)


# ---------------------------------------------------------------------------
# sparse capture machinery
# ---------------------------------------------------------------------------

def _identity(v) -> Optional[Tuple[weakref.ref, int, int]]:
    """Identity token of a tensor leaf: (the object, its storage address,
    its version counter). Views share the counter, and every in-place
    op bumps it, so an equal token means no byte changed."""
    if isinstance(v, torch.Tensor):
        return weakref.ref(v), v.data_ptr(), v._version
    return None


def _unchanged(token, v) -> bool:
    return (token is not None and isinstance(v, torch.Tensor)
            and token[0]() is v and token[1] == v.data_ptr()
            and token[2] == v._version)


@dataclass
class _LeafFP:
    """Per-leaf fingerprint state from the last capture: the baseline
    the next capture's dirty detection compares against. ``fp`` is an
    int32 [n_chunks, 2] tensor on the leaf's own device for tensor
    leaves (impl "device") and a host uint64 segment-sum array for
    numpy leaves (impl "host"). ``ident`` is the identity token of
    ``_identity``."""
    impl: str                 # "device" | "host"
    chunk_bytes: int
    shape: Tuple[int, ...]
    dtype: str
    nbytes: int
    fp: Any
    ident: Optional[Tuple[weakref.ref, int, int]] = None
    # chunks dirty at the last capture: sizes the fused kernel's
    # compaction buffer next time (change rates are stable step-to-step)
    last_dirty: Optional[int] = None


@dataclass
class _SparseLeaf:
    """Capture product for one dirty-chunk leaf: the compacted dirty
    payload plus enough geometry for the encode thread to XOR it against
    the previous snapshot's host mirror."""
    shape: Tuple[int, ...]
    dtype: str
    nbytes: int
    chunk_bytes: int
    n_chunks: int
    dirty_idx: np.ndarray                 # [k] int64
    dirty_bytes: Optional[np.ndarray]     # [k, chunk_bytes] u8, tail padded
    base_step: int


@dataclass
class _SparseCtx:
    """Everything the capture needs for dirty detection this snapshot.
    ``fp`` is the pipeline's fingerprint store — touched only by the
    caller thread (snapshots are caller-serial)."""
    fp: Dict[Tuple[str, str], _LeafFP]
    chain: bool               # will this snapshot be a chain link?
    base_step: Optional[int]
    chunk_bytes: int
    min_bytes: int
    pool: Optional[ThreadPoolExecutor]
    workers: int
    seen: set = field(default_factory=set)

    def eligible(self, v, codec: Optional[str]) -> bool:
        if not isinstance(v, (np.ndarray, torch.Tensor)):
            return False
        if deltamod.codec_applicable(v, codec):
            return False  # lossy-codec leaves never chain (see encode_leaf)
        return nbytes(v) >= self.min_bytes

    def _fingerprint(self, v, host_bytes: Optional[np.ndarray]):
        """-> (impl, fp). Reads the leaf exactly once: a tensor where it
        lives, through the fingerprint kernel (its plain version on a
        CPU tensor); a numpy leaf in one threaded SIMD pass over the
        host bytes."""
        if isinstance(v, torch.Tensor):
            return "device", ops.chunk_fingerprints(v, self.chunk_bytes)
        if host_bytes is None:
            host_bytes = _leaf_bytes(v)
        return "host", _fp_host_threaded(host_bytes, self.chunk_bytes,
                                         self.pool, self.workers)

    def record(self, name: str, path: str, v,
               host_bytes: Optional[np.ndarray] = None) -> None:
        """Refresh the fingerprint baseline after a dense capture."""
        impl, fp = self._fingerprint(v, host_bytes)
        self.fp[(name, path)] = _LeafFP(
            impl=impl, chunk_bytes=self.chunk_bytes,
            shape=tuple(v.shape), dtype=dtype_name(v), nbytes=nbytes(v),
            fp=fp, ident=_identity(v))

    def prune(self) -> None:
        """Drop baselines for leaves absent from this capture, so a leaf
        that vanishes and later reappears can't match a stale baseline
        against a mirror that no longer holds it."""
        for key in [k for k in self.fp if k not in self.seen]:
            del self.fp[key]


def _leaf_bytes(v) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(v)).reshape(-1).view(np.uint8)


# below this leaf size the executor handoff + GIL wakeups cost more
# than the single SIMD reduction pass they would split
_FP_THREAD_MIN_BYTES = 32 << 20


def _fp_host_threaded(buf: np.ndarray, chunk_bytes: int,
                      pool: Optional[ThreadPoolExecutor],
                      workers: int) -> np.ndarray:
    """fingerprint_host fanned out over chunk-aligned ranges — numpy
    releases the GIL inside the reductions, so for leaves large enough
    to amortize the handoff the read pass scales with cores and
    undercuts the full copy the dense path would pay."""
    from repro_torch.kernels.ckpt_codec.ref import fingerprint_host
    n = buf.nbytes
    if pool is None or workers <= 1 or n < _FP_THREAD_MIN_BYTES:
        return fingerprint_host(buf, chunk_bytes)
    n_chunks = -(-n // chunk_bytes)
    per = -(-n_chunks // workers) * chunk_bytes
    ranges = [(lo, min(n, lo + per)) for lo in range(0, n, per)]
    parts = pool.map(
        lambda r: fingerprint_host(buf[r[0]:r[1]], chunk_bytes), ranges)
    return np.vstack(list(parts))


# page-locked staging at or above this size is an exact-size buffer
# registered with cudaHostRegister: ``pin_memory=True`` goes through
# PyTorch's caching host allocator, which rounds every block up to a
# power of two — 53 GB of page-locked memory for starcoder2-3b's 30.3 GB
# of params and moments. Allocations this large come from their own
# mmap, so no two registered ranges share a page.
_REGISTER_MIN_BYTES = 64 << 20


def _pinned_empty(shape, dtype: torch.dtype) -> torch.Tensor:
    """An empty page-locked host tensor of exactly its own size."""
    nbytes = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    if nbytes < _REGISTER_MIN_BYTES:
        return torch.empty(shape, dtype=dtype, pin_memory=True)
    buf = torch.empty(shape, dtype=dtype)
    rt = torch.cuda.cudart()
    ptr = buf.data_ptr()
    err = int(rt.cudaHostRegister(ptr, nbytes, 0))
    if err != 0:
        raise SnapshotError(f"cudaHostRegister of a {nbytes} B staging "
                            f"buffer failed (CUDA error {err})")
    # unpin before the allocator frees the pages
    weakref.finalize(buf, rt.cudaHostUnregister, ptr)
    return buf


class _StagingSlot:
    """Reusable host buffers for one in-flight snapshot (page-locked for
    leaves on the card, so the device->host copy runs at full rate)."""

    def __init__(self) -> None:
        self.buffers: Dict[str, Dict[str, Any]] = {}
        self.busy = False

    @staticmethod
    def _stage(pool: Dict[str, Any], path: str, v) -> Any:
        """Copy one leaf into this slot's preallocated buffer — always a
        copy: ``.cpu()`` and ``.numpy()`` alias a CPU source, and the
        caller mutates its state the moment ``snapshot()`` returns. For
        a leaf on the card, ``copy_`` into host memory blocks until the
        bytes have landed, so the next decode step cannot write the
        cache before the copy has read it."""
        buf = pool.get(path)
        if isinstance(v, torch.Tensor):
            src = v.detach()
            if not isinstance(buf, torch.Tensor) \
                    or buf.shape != src.shape or buf.dtype != src.dtype:
                buf = (_pinned_empty(tuple(src.shape), src.dtype)
                       if src.is_cuda else
                       torch.empty(src.shape, dtype=src.dtype))
                pool[path] = buf
            buf.copy_(src)
            return buf
        a = np.asarray(v)
        if not isinstance(buf, np.ndarray) or buf.shape != a.shape \
                or buf.dtype != a.dtype:
            buf = np.empty(a.shape, a.dtype)
            pool[path] = buf
        np.copyto(buf, a)
        return buf

    @staticmethod
    def _stage_coded(pool: Dict[str, Any], path: str,
                     v: torch.Tensor) -> deltamod.Int8Leaf:
        """Quantize a tensor leaf where it lives (the CUDA kernel on the
        card, on the current stream) and stage only its codes and
        scales, about a quarter of a float32 leaf's bytes. The codes are
        fresh buffers and the blocking copy lands them before
        ``snapshot()`` returns, so a later in-place write of the leaf
        cannot reach what was captured."""
        q, scale = ops.quantize(v.detach())
        if v.is_cuda:
            bufs = pool.get(path)
            if not (isinstance(bufs, tuple)
                    and tuple(bufs[0].shape) == tuple(q.shape)):
                bufs = (_pinned_empty(tuple(q.shape), q.dtype),
                        _pinned_empty(tuple(scale.shape), scale.dtype))
                pool[path] = bufs
            bufs[0].copy_(q)
            bufs[1].copy_(scale)
            q, scale = bufs
        return deltamod.Int8Leaf(q, scale, v.shape, dtype_name(v))

    def capture(self, upper: UpperHalf, ctx: Optional[_SparseCtx] = None,
                codec_by_kind: Optional[Dict[str, str]] = None,
                ) -> Tuple[Dict[str, Dict[str, Any]], Dict[str, int]]:
        """Copy-on-snapshot: every leaf is copied into this slot's
        preallocated host buffers (``_stage``).

        A tensor leaf under the ``int8`` codec is quantized where it
        lives and only its codes cross (``_stage_coded``). With a sparse
        context, eligible leaves take the dirty-chunk path instead of a
        full copy (``_try_sparse``); everything else falls through to
        the dense copy and refreshes its fingerprint baseline for the
        next capture."""
        out: Dict[str, Dict[str, Any]] = {}
        st = {"capture_bytes": 0, "dirty_chunks": 0, "clean_chunks": 0,
              "identity_skips": 0, "sparse_leaves": 0}
        codec_by_kind = codec_by_kind or {}
        for name, e in upper.items():
            pool = self.buffers.setdefault(name, {})
            taken: Dict[str, Any] = {}
            codec = codec_by_kind.get(e.kind)
            for path, v in flatten_with_paths(e.tree):
                if deltamod.device_codec(v, codec):
                    a = self._stage_coded(pool, path, v)
                    taken[path] = a
                    st["capture_bytes"] += nbytes(a.q) + nbytes(a.scale)
                    continue
                elig = ctx is not None and ctx.eligible(v, codec)
                if elig:
                    ctx.seen.add((name, path))
                    sp = self._try_sparse(name, path, v, ctx, st)
                    if sp is not None:
                        taken[path] = sp
                        continue
                a = self._stage(pool, path, v)
                taken[path] = a
                st["capture_bytes"] += nbytes(a)
                if elig:
                    # fingerprint the *staged* copy: for an in-place-
                    # mutated numpy leaf only the staged bytes are
                    # guaranteed to be this snapshot's
                    ctx.record(name, path, v, host_bytes=byte_view(a))
            out[name] = taken
        if ctx is not None:
            ctx.prune()
        return out, st

    def _try_sparse(self, name: str, path: str, v, ctx: _SparseCtx,
                    st: Dict[str, int]) -> Optional[_SparseLeaf]:
        """Dirty-chunk capture for one leaf; None -> take the dense path
        (no baseline yet, geometry changed, or not a chain snapshot)."""
        fpe = ctx.fp.get((name, path))
        if (not ctx.chain or fpe is None
                or fpe.chunk_bytes != ctx.chunk_bytes
                or fpe.shape != tuple(v.shape) or fpe.dtype != dtype_name(v)):
            return None
        cb = ctx.chunk_bytes
        n_chunks = -(-nbytes(v) // cb)
        common = dict(shape=tuple(v.shape), dtype=dtype_name(v),
                      nbytes=nbytes(v), chunk_bytes=cb, n_chunks=n_chunks,
                      base_step=ctx.base_step)
        if _unchanged(fpe.ident, v):
            # same tensor, no in-place write since -> zero reads
            st["identity_skips"] += 1
            st["sparse_leaves"] += 1
            st["clean_chunks"] += n_chunks
            return _SparseLeaf(dirty_idx=np.empty(0, np.int64),
                               dirty_bytes=None, **common)
        if fpe.impl == "device" and isinstance(v, torch.Tensor) \
                and fpe.fp.device == v.device:
            # fused single pass: 1 kernel call + 1 blocking D2H (the
            # two-launch gather path is its internal overflow fallback)
            fp_new, idx, compact = ops.fused_dirty_chunk_capture(
                v, fpe.fp, cb, capacity_hint=fpe.last_dirty)
        elif fpe.impl == "host" and isinstance(v, np.ndarray):
            buf = _leaf_bytes(v)
            fp_new = _fp_host_threaded(buf, cb, ctx.pool, ctx.workers)
            idx = np.nonzero(np.any(fp_new != fpe.fp, axis=1))[0]
            compact = None
            if idx.size:
                # one sliced gather for every full chunk (idx is sorted,
                # so the split point is a searchsorted); only a partial
                # tail chunk — at most one, the last index — is copied
                # scalar and zero-padded
                compact = np.empty((idx.size, cb), np.uint8)
                n_full = buf.size // cb
                k_full = int(np.searchsorted(idx, n_full))
                np.take(buf[:n_full * cb].reshape(n_full, cb),
                        idx[:k_full], axis=0, out=compact[:k_full])
                for j in range(k_full, idx.size):
                    off = int(idx[j]) * cb
                    ln = buf.size - off
                    compact[j, :ln] = buf[off:]
                    compact[j, ln:] = 0
        else:
            return None  # baseline impl doesn't match this leaf anymore
        ctx.fp[(name, path)] = _LeafFP(
            impl=fpe.impl, chunk_bytes=cb, shape=tuple(v.shape),
            dtype=dtype_name(v), nbytes=nbytes(v), fp=fp_new,
            ident=_identity(v), last_dirty=int(idx.size))
        st["sparse_leaves"] += 1
        st["dirty_chunks"] += int(idx.size)
        st["clean_chunks"] += n_chunks - int(idx.size)
        st["capture_bytes"] += int(idx.size) * cb
        return _SparseLeaf(dirty_idx=np.asarray(idx, np.int64),
                           dirty_bytes=compact, **common)


@dataclass
class _Captured:
    """Everything frozen at the capture point."""
    step: int
    slot: _StagingSlot
    host_state: Dict[str, Dict[str, np.ndarray]]
    structure: Dict[str, Any]
    kinds: Dict[str, str]
    log_json: Any
    job_meta: Dict[str, Any]
    capture_seconds: float
    sparse_committed: bool = False  # set by encode: mirror was patched


class SnapshotHandle:
    """Caller's view of one snapshot moving through the pipeline."""

    def __init__(self, step: int) -> None:
        self.step = step
        self._future: Future = Future()
        self.timings: Dict[str, float] = {}

    def done(self) -> bool:
        return self._future.done()

    def result(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """Block until committed; returns the manifest. Raises the
        builtin ``TimeoutError`` when the encode thread hasn't committed
        within ``timeout`` — never a partial result. (On Python < 3.11
        ``concurrent.futures.TimeoutError`` is a distinct type that a
        caller's ``except TimeoutError`` would silently miss.)"""
        try:
            return self._future.result(timeout)
        except _FuturesTimeout:
            if self._future.done():
                # the snapshot itself failed with a TimeoutError (e.g. a
                # storage timeout) — that is the real cause, not us
                raise
            raise TimeoutError(
                f"snapshot for step {self.step} not committed within "
                f"{timeout}s") from None

    # Future-compatible alias so legacy callers treating save()'s return
    # value as a concurrent.futures.Future keep working
    def add_done_callback(self, fn) -> None:
        self._future.add_done_callback(fn)


class AsyncSnapshotter:
    """The capture/encode/commit pipeline (see module docstring)."""

    def __init__(
        self,
        backend: CheckpointBackend,
        *,
        codec_by_kind: Optional[Dict[str, str]] = None,
        delta_base_interval: int = 1,
        backpressure: str = "block",
        writers: int = 4,
        compress: bool = True,
        keep_last: Optional[int] = None,
        prune_oplog: bool = True,
        depth: Optional[int] = None,
        sparse_capture: bool = True,
        sparse_chunk_bytes: int = FP_CHUNK_BYTES,
        sparse_min_bytes: Optional[int] = None,
    ) -> None:
        assert backpressure in ("block", "skip"), backpressure
        assert delta_base_interval >= 1
        self.backend = backend
        self.codec_by_kind = codec_by_kind or {}
        self.delta_base_interval = delta_base_interval
        self.backpressure = backpressure
        self.compress = compress
        self.keep_last = keep_last
        self.prune_oplog = prune_oplog
        if depth is None:  # +1 slot to keep capture overlapped while the
            depth = 2 if delta_base_interval == 1 else 3  # base is pinned
        self._slots = [_StagingSlot() for _ in range(depth)]
        self._cond = threading.Condition()
        self._encode_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="snap-encode")  # ordered
        self._writer_pool = ThreadPoolExecutor(
            max_workers=writers, thread_name_prefix="snap-write")
        packers = encode_workers()
        self._pack_pool: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(max_workers=packers,
                               thread_name_prefix="snap-pack")
            if packers > 1 else None)
        self._inflight: List[SnapshotHandle] = []
        self._last_error: Optional[BaseException] = None
        # previous snapshot kept as the XOR base: (step, host_state, slot)
        self._prev: Optional[Tuple[int, Dict[str, Dict[str, np.ndarray]],
                                   _StagingSlot]] = None
        self._chain_len = 0
        # dirty-chunk capture state (caller thread; see module docstring)
        self.sparse_capture = sparse_capture and delta_base_interval > 1
        if self.sparse_capture:
            cb = sparse_chunk_bytes
            # the kernels need whole i32 lane rows (4*BLOCK); the host
            # fingerprint needs chunks to be whole segments — fail at
            # construction, not deep inside the first chained save
            if cb <= 0 or cb % 1024 or (cb > FP_SEG_BYTES
                                        and cb % FP_SEG_BYTES):
                raise PolicyError(
                    f"sparse_chunk_bytes={cb} must be a positive multiple "
                    f"of 1024, and of {FP_SEG_BYTES} once above it")
        self.sparse_chunk_bytes = sparse_chunk_bytes
        self.sparse_min_bytes = (sparse_min_bytes if sparse_min_bytes
                                 is not None else 2 * sparse_chunk_bytes)
        self._fp: Dict[Tuple[str, str], _LeafFP] = {}
        self._fp_step: Optional[int] = None
        self._cap_chain_len = 0
        self._fp_invalid = False          # set by encode-thread failures
        self._fp_pool: Optional[ThreadPoolExecutor] = None
        self._fp_workers = 1
        if self.sparse_capture:
            self._fp_workers = min(4, os.cpu_count() or 1)
            if self._fp_workers > 1:
                self._fp_pool = ThreadPoolExecutor(
                    max_workers=self._fp_workers,
                    thread_name_prefix="snap-fp")
        self.stats: Dict[str, Any] = {
            "saves": 0, "skipped": 0, "failed": 0, "chain_links": 0,
            "bytes_written": 0, "bytes_logical": 0, "bytes_encoded": 0,
            "capture_bytes": 0, "sparse_leaves": 0, "identity_skips": 0,
            "dirty_chunks": 0, "clean_chunks": 0,
            "save_seconds": 0.0, "capture_seconds": 0.0,
            "encode_commit_seconds": 0.0,
        }

    # --- capture (caller thread) ------------------------------------------

    def _acquire_slot(self, must_take: bool = False
                      ) -> Optional[_StagingSlot]:
        with self._cond:
            while True:
                for s in self._slots:
                    if not s.busy:
                        s.busy = True
                        return s
                if self.backpressure == "skip" and not must_take:
                    return None
                self._cond.wait()

    def _release_slot(self, slot: _StagingSlot) -> None:
        with self._cond:
            slot.busy = False
            self._cond.notify_all()

    def snapshot(self, step: int, upper: UpperHalf, oplog: OpLog,
                 job_meta: Optional[Dict[str, Any]] = None,
                 must_take: bool = False) -> Optional[SnapshotHandle]:
        """Capture now; encode + commit in the background. Returns None
        iff the pipeline is saturated and backpressure policy is "skip".
        ``must_take`` overrides a "skip" policy (a caller that asked to
        block has said it will wait — dropping would lose e.g. the final
        checkpoint of a run)."""
        slot = self._acquire_slot(must_take=must_take)
        if slot is None:
            self.stats["skipped"] += 1
            return None
        ctx: Optional[_SparseCtx] = None
        if self.sparse_capture:
            with self._cond:
                if self._fp_invalid:  # an encode failure broke the chain
                    self._fp.clear()
                    self._fp_step = None
                    self._cap_chain_len = 0
                    self._fp_invalid = False
            ctx = _SparseCtx(
                fp=self._fp,
                chain=(self._fp_step is not None and
                       self._cap_chain_len < self.delta_base_interval - 1),
                base_step=self._fp_step,
                chunk_bytes=self.sparse_chunk_bytes,
                min_bytes=self.sparse_min_bytes,
                pool=self._fp_pool,
                workers=self._fp_workers,
            )
        t0 = time.monotonic()
        try:
            host_state, cap_st = slot.capture(upper, ctx,
                                              self.codec_by_kind)
            cap = _Captured(
                step=step,
                slot=slot,
                host_state=host_state,
                structure=upper.structure(),
                kinds={name: e.kind for name, e in upper.items()},
                log_json=(oplog.prune() if self.prune_oplog
                          else oplog).to_json(),
                job_meta=job_meta or {},
                capture_seconds=time.monotonic() - t0,
            )
        except BaseException:
            if ctx is not None:
                # a partial capture may have advanced some leaves'
                # baselines: comparing against them next time would
                # silently mark truly-changed chunks clean
                self._fp.clear()
                self._fp_step = None
                self._cap_chain_len = 0
            self._release_slot(slot)
            raise
        if ctx is not None:
            self._cap_chain_len = self._cap_chain_len + 1 if ctx.chain else 0
            self._fp_step = step
        handle = SnapshotHandle(step)
        handle.timings["capture"] = cap.capture_seconds
        self.stats["capture_seconds"] += cap.capture_seconds
        for k, n in cap_st.items():
            self.stats[k] += n
        with self._cond:
            self._inflight.append(handle)
        self._encode_pool.submit(self._encode_and_commit, cap, handle)
        return handle

    # --- encode + commit (pipeline threads) -------------------------------

    def _encode_and_commit(self, cap: _Captured,
                           handle: SnapshotHandle) -> None:
        t0 = time.monotonic()
        try:
            manifest = self._do_encode_commit(cap)
        except BaseException as e:
            with self._cond:
                self._last_error = e   # drain() re-raises even if the
                self.stats["failed"] += 1  # handle is retired by then
                # the chain base (and possibly a half-patched mirror) is
                # gone; the next capture must re-baseline and the next
                # snapshot will be a full base
                self._fp_invalid = True
            self._retire(cap.slot, handle, keep_as_prev=False)
            handle._future.set_exception(e)
            return
        dt = time.monotonic() - t0
        handle.timings["encode_commit"] = dt
        self.stats["saves"] += 1
        self.stats["encode_commit_seconds"] += dt
        self.stats["save_seconds"] += cap.capture_seconds + dt
        self._retire(cap.slot, handle,
                     keep_as_prev=self.delta_base_interval > 1,
                     step=cap.step, host_state=cap.host_state,
                     reuse_prev=getattr(cap, "sparse_committed", False))
        handle._future.set_result(manifest)

    def _do_encode_commit(self, cap: _Captured) -> Dict[str, Any]:
        chain = (self.delta_base_interval > 1 and self._prev is not None
                 and self._chain_len < self.delta_base_interval - 1)
        base_step = self._prev[0] if chain else None
        base_state = self._prev[1] if chain else {}

        has_sparse = any(isinstance(x, _SparseLeaf)
                         for leaves in cap.host_state.values()
                         for x in leaves.values())
        if has_sparse and not chain:
            # capture predicted a chain link that encode can't honor
            # (the previous snapshot failed after this capture ran);
            # the sparse payload alone can't produce a full base
            raise SnapshotError(
                "sparse capture lost its chain base (a preceding "
                "snapshot failed); this snapshot cannot be encoded")

        writer = _BlobWriter(self.backend, self._writer_pool)
        entries_manifest: Dict[str, Any] = {}
        written = logical = encoded = 0
        for name, leaves in cap.host_state.items():
            codec = self.codec_by_kind.get(cap.kinds[name])
            leaf_metas: Dict[str, Any] = {}
            for path, arr in leaves.items():
                if isinstance(arr, _SparseLeaf):
                    if arr.base_step != base_step:
                        raise SnapshotError(
                            f"sparse capture of {name}:{path} is relative "
                            f"to step {arr.base_step}, but the encode "
                            f"chain base is {base_step}")
                    prev_arr = base_state.get(name, {}).get(path)
                    if prev_arr is None:
                        raise SnapshotError(
                            f"sparse capture of {name}:{path} has no "
                            "previous value in the pinned mirror")
                    m = deltamod.encode_leaf_sparse(
                        arr.shape, arr.dtype, arr.chunk_bytes,
                        arr.n_chunks, arr.dirty_idx,
                        arr.dirty_bytes if arr.dirty_bytes is not None
                        else np.empty((0, arr.chunk_bytes), np.uint8),
                        prev_arr, writer.put, writer.has,
                        compress=self.compress, pool=self._pack_pool)
                    logical += arr.nbytes
                else:
                    prev_arr = None
                    if chain and not deltamod.codec_applicable(arr, codec):
                        prev_arr = base_state.get(name, {}).get(path)
                    m = deltamod.encode_leaf(
                        arr, writer.put, writer.has, codec=codec,
                        prev=prev_arr, compress=self.compress,
                        pool=self._pack_pool)
                    logical += nbytes(arr)
                    if has_sparse and isinstance(arr, deltamod.Int8Leaf):
                        # codec leaves never serve as an XOR base
                        base_state.setdefault(name, {}).pop(path, None)
                    elif has_sparse:
                        # the old prev slot stays pinned as the mirror;
                        # fold this dense leaf's bytes into it so the
                        # mirror is the complete current snapshot (the
                        # staged copy belongs to a slot about to be
                        # freed, so take a private copy)
                        mirror = base_state.setdefault(name, {})
                        old = mirror.get(path)
                        if old is not None and type(old) is type(arr) \
                                and tuple(old.shape) == tuple(arr.shape) \
                                and dtype_name(old) == dtype_name(arr):
                            byte_view(old)[:] = byte_view(arr)
                        else:
                            mirror[path] = host_copy(arr)
                written += m.pop("bytes_written", 0)
                encoded += m.pop("bytes_encoded", 0)
                leaf_metas[path] = m
            entries_manifest[name] = {"kind": cap.kinds[name],
                                      "leaves": leaf_metas}
        if has_sparse:
            # leaves absent from this snapshot must leave the mirror too
            for name in list(base_state):
                cur = cap.host_state.get(name)
                if cur is None:
                    del base_state[name]
                    continue
                for path in [p for p in base_state[name] if p not in cur]:
                    del base_state[name][path]
        writer.drain()  # every blob durable before the manifest commits
        manifest = {
            "format": (SPARSE_MANIFEST_FORMAT if has_sparse
                       else MANIFEST_FORMAT),
            "step": cap.step,
            "base_step": base_step,
            "entries": entries_manifest,
            "oplog": cap.log_json,
            "structure": cap.structure,
            "job": cap.job_meta,
        }
        cap.sparse_committed = has_sparse
        self.backend.commit_manifest(cap.step, manifest)
        self._chain_len = self._chain_len + 1 if chain else 0
        if chain:
            self.stats["chain_links"] += 1
        self.stats["bytes_written"] += written
        self.stats["bytes_logical"] += logical
        self.stats["bytes_encoded"] += encoded
        if self.keep_last is not None:
            try:
                self.gc(self.keep_last)
            except Exception:  # noqa: BLE001 — snapshot IS committed;
                # a transient retention failure must not report it lost
                self.stats["gc_failures"] = \
                    self.stats.get("gc_failures", 0) + 1
        return manifest

    def _retire(self, slot: _StagingSlot, handle: SnapshotHandle,
                keep_as_prev: bool, step: int = -1,
                host_state=None, reuse_prev: bool = False) -> None:
        """Slot bookkeeping after a snapshot leaves the pipeline: the
        committed slot becomes the next XOR base (when chaining); the
        base it replaced is freed. A sparse commit (``reuse_prev``)
        instead advanced the pinned mirror in place — the old prev slot
        *stays* prev (now holding this snapshot's bytes) and the capture
        slot's spent dirty payload is freed. The handle's result is set
        by the caller right after — anyone blocked on it wakes with the
        slots already released."""
        with self._cond:
            old_prev = self._prev
            if reuse_prev:
                assert old_prev is not None  # encode validated the base
                self._prev = (step, old_prev[1], old_prev[2])
                slot.busy = False
            else:
                if keep_as_prev:
                    self._prev = (step, host_state, slot)
                else:
                    self._prev = None
                    slot.busy = False
                if old_prev is not None and old_prev[2] is not slot:
                    old_prev[2].busy = False
            self._inflight = [h for h in self._inflight if h is not handle]
            self._cond.notify_all()

    # --- drain / shutdown --------------------------------------------------

    def drain(self) -> None:
        """Block until every in-flight snapshot committed (or failed),
        then re-raise the most recent failure since the last drain —
        including one that completed before drain was called, so
        fire-and-forget callers (snapshot(); ...; wait()) cannot
        silently lose checkpoints."""
        with self._cond:
            pending = list(self._inflight)
        for h in pending:
            try:
                h.result()
            except BaseException:  # noqa: BLE001 — raised via _last_error
                pass
        with self._cond:
            err, self._last_error = self._last_error, None
        if err is not None:
            raise err

    def consume_error(self, err: BaseException) -> None:
        """A caller that already received `err` from a handle (blocking
        save) takes ownership of it, so a later unrelated drain() does
        not re-raise a failure that was handled and possibly retried."""
        with self._cond:
            if self._last_error is err:
                self._last_error = None

    def close(self) -> None:
        try:
            self.drain()
        finally:
            self._encode_pool.shutdown(wait=True)
            self._writer_pool.shutdown(wait=True)
            if self._pack_pool is not None:
                self._pack_pool.shutdown(wait=True)
            if self._fp_pool is not None:
                self._fp_pool.shutdown(wait=True)

    # --- gc ----------------------------------------------------------------

    def gc(self, keep_last: int) -> None:
        """Drop all but the last `keep_last` checkpoints — plus the
        transitive base closure of the kept ones, so every survivor's
        delta chain stays restorable — then GC unreferenced blobs."""
        steps = self.backend.list_steps()
        have = set(steps)
        # keep_last <= 0 means "no retention limit", never "drop all"
        keep = set(steps[-keep_last:]) if keep_last > 0 else set(steps)
        frontier = list(keep)
        manifests: Dict[int, Dict[str, Any]] = {}
        while frontier:
            s = frontier.pop()
            m = manifests.get(s) or self.backend.get_manifest(s)
            manifests[s] = m
            b = m.get("base_step")
            if b is not None and b in have and b not in keep:
                keep.add(b)
                frontier.append(b)
        for s in steps:
            if s not in keep:
                self.backend.delete_step(s)
        referenced: set = set()
        for s in keep:
            referenced |= deltamod.referenced_hashes(manifests[s])
        self.backend.gc_blobs(referenced)


class _BlobWriter:
    """Fans blob writes out to the writer pool with a bounded in-flight
    window; drain() rejoins before the manifest commit.

    ``has`` answers "is this blob durable or already queued by me" —
    the backend alone can't, because a queued write hasn't landed yet,
    and asking it directly would re-write (and re-count) every repeated
    chunk within one snapshot (e.g. zero-initialized weights)."""

    def __init__(self, backend: CheckpointBackend,
                 pool: ThreadPoolExecutor,
                 max_pending: int = MAX_PENDING_WRITES) -> None:
        self._backend = backend
        self._pool = pool
        self._sem = threading.Semaphore(max_pending)
        self._futures: List[Future] = []
        self._queued: set = set()  # touched only by the encode thread

    def has(self, name: str) -> bool:
        return name in self._queued or self._backend.has_blob(name)

    def put(self, name: str, data: bytes) -> None:
        self._queued.add(name)
        self._sem.acquire()
        self._futures.append(self._pool.submit(self._write, name, data))

    def _write(self, name: str, data: bytes) -> None:
        try:
            self._backend.put_blob(name, data)
        finally:
            self._sem.release()

    def drain(self) -> None:
        for f in self._futures:
            f.result()
        self._futures.clear()


# ---------------------------------------------------------------------------
# restore side: delta chain -> full state
# ---------------------------------------------------------------------------

# manifest formats this build can decode (1: whole-tree, 2: delta chain,
# 3: sparse dirty-chunk links); a newer format means a newer build wrote
# the checkpoint and silently misreading it would be worse than failing
KNOWN_MANIFEST_FORMATS = (1, 2, 3)


def check_manifest_format(manifest: Dict[str, Any]) -> None:
    fmt = manifest.get("format", 1)
    if fmt not in KNOWN_MANIFEST_FORMATS:
        raise RestoreError(
            f"checkpoint manifest format {fmt} is newer than this build "
            f"understands (known: {KNOWN_MANIFEST_FORMATS})")


def manifest_chain_steps(backend: CheckpointBackend, step: int) -> List[int]:
    """base-first list of steps whose manifests `step` depends on."""
    chain = []
    s: Optional[int] = step
    while s is not None:
        m = backend.get_manifest(s)
        check_manifest_format(m)
        chain.append(s)
        s = m.get("base_step")
    chain.reverse()
    return chain


def leaf_chain_start(manifests: List[Dict[str, Any]], name: str,
                     path: str) -> int:
    """Index of the manifest where ``(name, path)``'s decode run starts:
    walk base links back only as far as its run of xor modes reaches (a
    full or codec leaf needs no predecessor). An entry or leaf first
    introduced mid-chain bounds the walk — the predecessor manifest
    simply doesn't carry it — so the run starts at the introduction
    instead of raising KeyError. Every manifest in ``[start:]`` is
    guaranteed to carry the leaf; this is the single definition of a
    leaf's chain shared by the eager decoder and the streaming planner
    (which is what makes their blob plans identical by construction)."""
    i = len(manifests) - 1
    while i > 0 and (manifests[i]["entries"][name]["leaves"][path]
                     .get("mode") == "xor"):
        prev = manifests[i - 1]["entries"].get(name, {}) \
            .get("leaves", {}).get(path)
        if prev is None:
            break   # first introduced here: nothing earlier to walk to
        i -= 1  # xor decodes against the predecessor's value
    return i


def _decode_chain_leaf(manifests: List[Dict[str, Any]], backend,
                       name: str, path: str) -> np.ndarray:
    """Decode one leaf of the final manifest from the start of its xor
    run (``leaf_chain_start``) forward, XOR-applying each link."""
    i = leaf_chain_start(manifests, name, path)
    val: Optional[np.ndarray] = None
    for m in manifests[i:]:
        val = deltamod.decode_leaf(
            m["entries"][name]["leaves"][path], backend.get_blob, prev=val)
    return val


# below this leaf count a worker pool costs more than it hides; tiny
# checkpoints (scalars + a couple of tensors) decode inline
_PARALLEL_DECODE_MIN_LEAVES = 4


def materialize_manifest_chain(
    backend: CheckpointBackend, step: int, workers: Optional[int] = None,
    skip_entries=(),
) -> Tuple[Dict[str, Any], Dict[str, Dict[str, np.ndarray]]]:
    """Delta chain -> full state. Each leaf decodes independently (its
    own xor-run walk), so leaves fan out across a worker pool — restore
    latency is bounded by the largest leaf's chain, not the sum of all
    of them. Leaves that exist only in intermediate manifests — or are
    non-xor there — are never decoded, so restore cost per leaf stays
    O(xor-run length), not O(chain length). Sparse (format-3) links
    apply as copy + dirty-chunk patch rather than a full-buffer XOR, so
    chain application also scales with what each link changed.

    ``workers``: decode pool size; default scales with the host, 1
    forces the serial path (both orders produce identical arrays).
    ``skip_entries``: entry names to leave undecoded (absent from the
    result) — a caller that rebuilds an entry from scratch, like the
    serving engine re-slotting its KV cache, shouldn't pay its chain.
    Codec leaves stay coded (``delta.Int8Leaf``) until they are bound
    onto their device."""
    manifests = [backend.get_manifest(s)
                 for s in manifest_chain_steps(backend, step)]
    final = manifests[-1]
    skip = set(skip_entries)
    tasks = [(name, path) for name, e in final["entries"].items()
             if name not in skip for path in e["leaves"]]
    if workers is None:
        workers = min(8, os.cpu_count() or 1)
    if workers > 1 and len(tasks) >= _PARALLEL_DECODE_MIN_LEAVES:
        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix="chain-decode") as pool:
            vals = list(pool.map(
                lambda t: _decode_chain_leaf(manifests, backend, *t), tasks))
    else:
        vals = [_decode_chain_leaf(manifests, backend, name, path)
                for name, path in tasks]
    entries: Dict[str, Dict[str, np.ndarray]] = {}
    for (name, path), val in zip(tasks, vals):
        entries.setdefault(name, {})[path] = val
    # entries present in the manifest but empty of leaves (e.g. an empty
    # request queue) must still appear in the restored state
    for name in final["entries"]:
        if name not in skip:
            entries.setdefault(name, {})
    return final, entries
