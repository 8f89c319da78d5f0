"""Roofline analyzer over a traced step — the port of
``repro.launch.hlo_analysis``.

PyTorch has no HLO. The counterpart sees the aten ops that one call of
a step dispatches, through a ``TorchDispatchMode`` (:class:`Analyzer`),
and derives the reference's three roofline terms from them, for one
rank (a DTensor op is counted at the local ops it runs on this rank's
blocks, as the reference's post-SPMD HLO is per device):

  flops            — mm / addmm / bmm / baddbmm / convolution (and its
                     backward) by ``torch.utils.flop_counter``'s
                     formulas: 2 x result elements x contracted size, the
                     reference's dot rule. An eager loop is traced once
                     per trip, so no trip count is needed.
  hbm bytes        — operand plus result bytes of every op that reads or
                     writes device memory. Views and layout ops are left
                     out, as the reference leaves them out: a view moves
                     nothing, and a layout copy (clone, cat, stack) or a
                     fill of fresh memory (empty, arange) is what XLA
                     fuses into its neighbours.
  collective bytes — the ``_c10d_functional`` ops that DTensor issues,
                     per-rank wire bytes of each op's result with the
                     reference's ring factors: all-reduce 2(n-1)/n,
                     all-gather and all-to-all (n-1)/n, reduce-scatter
                     (n-1), a permute (here: a broadcast) 1; each also
                     reads and writes its result once in device memory.

The reference counts f32 collective payloads at bf16 width when the
model computes in bf16 (its ``_BF16_COLLECTIVE_FIX``): that corrects an
XLA:CPU artifact, whose partitioner moves the f32 operands of XLA:CPU's
upcast bf16 dots where the TPU moves bf16. DTensor moves the dtype the
program uses, so the port counts each payload as it is.

Kernel launches take the place of the reference's fusable loops. A
kernel wrapper's fake route (a ``FakeTensor``: the dry run) launches
nothing and passes its shapes and its plain version to
``kernels.trace.note_launch``; every active analyzer, which listens
there, records the launch's work twice: at the kernel's own operations
and bytes (the formulas below, which ``chip_smoke.py``'s bounds use) and
at what the plain version moves in its place — the wrapper's own plain
version (the one ``chip_smoke.py`` times as ``plain_ms``) traced by an
analyzer of its own on the launch's fake inputs, once for each shape.
``roofline`` counts the launches at the plain version's work: the card
route's program with each kernel's plain version in its place, the plain
eager program, as the reference's ``roofline`` counts XLA's;
``roofline_kernel_adjusted`` at the kernels' own, as the reference
charges a fusable loop at the bytes its Pallas kernel streams. On the
CPU no kernel launches: the model's own plain route is traced op by op
(attention there is the dense product, as JAX's is).

The analyzer also follows the bytes alive in the traced call: every
storage an op makes, from its first op to its last reference (CPython
frees a tensor when its last reference goes, as the card's caching
allocator then frees its block). The arguments the caller names
(``hold``) are counted apart from the rest, whose peak is the call's
temporary memory.

The hardware constants are an NVIDIA H100 SXM's (``DEVICE``). NVLink
joins the 8 GPUs of one node: a mesh axis of 16 spans two nodes over a
slower link, so there the collective term is a lower bound.
"""
from __future__ import annotations

import functools
import threading
import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels.trace import is_fake, launches_to

# --- hardware: one NVIDIA H100 SXM ------------------------------------------

DEVICE = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS = 989e12            # dense bf16 on the tensor cores
HBM_BW = 3.35e12               # device memory, bytes/s
NVLINK_BW = 450e9              # NVLink 4 each way (in place of ICI_BW)
CUDA_CORE_OPS_PER_S = 67e12    # f32 outside the tensor cores
# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 (700 W limit), read by chip_smoke.py
HBM_BYTES = 85_017_493_504

DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.uint16: 2, torch.bfloat16: 2, torch.float16: 2, torch.int32: 4,
    torch.uint32: 4, torch.float32: 4, torch.int64: 8, torch.uint64: 8,
    torch.float64: 8, torch.complex64: 8, torch.complex128: 16,
    torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of a tensor's elements (not of its storage)."""
    return int(t.numel()) * DTYPE_BYTES.get(t.dtype, t.element_size())


# --- each kernel's work: the bounds and the analyzer's launches -----------

def attended_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave visible — the work the
    attention kernels must do for these inputs."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i + 1, skv) if causal else np.full(sq, skv)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(sq,
                                                                   np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash_work(B: int, H: int, Hkv: int, Sq: int, Skv: int, hd: int,
               esz: int, causal: bool, window: int
               ) -> Dict[str, Tuple[int, int]]:
    """(bytes, operations) of flash_fwd, flash_dq and flash_dkv: each
    input read once and each output written once (q and out ``esz``
    bytes an element, the LSE and delta f32), and 2 x hd operations a
    product over the attended pairs — two products in the forward (S,
    PV), three in dq (S, dP, dQ), four in dk/dv (S, dP, dV, dK)."""
    pairs = B * H * attended_pairs(Sq, Skv, causal, window)
    qb, kvb = B * H * Sq * hd * esz, B * Hkv * Skv * hd * esz
    st = B * H * Sq * 4
    return {"flash_fwd": (2 * qb + 2 * kvb + st, 2 * 2 * hd * pairs),
            "flash_dq": (3 * qb + 2 * kvb + 2 * st, 3 * 2 * hd * pairs),
            "flash_dkv": (2 * qb + 4 * kvb + 2 * st, 4 * 2 * hd * pairs)}


def ssd_work(B, S, H, P, N, q, esz):
    """(bytes, operations) of ssd_fwd and ssd_bwd on these shapes: each
    input read once and each output written once, and the products of
    the model's chunk-q algorithm as the reference does them (C.B^T for
    every head) over the causal pairs j <= i only, as ``attended_pairs``
    counts flash attention's. The forward's outputs include the
    chunk-start states it writes for the backward, which reads them: the
    path's forward cannot skip them. The backward takes the gradient of
    each product with respect to both its operands, twice the forward."""
    blocks = B * H * (S // q)
    pairs = q * (q + 1) // 2
    fwd_ops = blocks * (2 * pairs * (N + P) + 4 * q * P * N)
    x, bc = B * S * H * P * esz, 2 * B * S * N * esz
    small = B * S * H * 4 + H * 4                  # dt, A
    y, state = B * S * H * P * 4, B * H * P * N * 4
    states = state * (S // q)
    fwd_bytes = x + bc + small + y + state + states
    bwd_bytes = (x + bc + small + states + y) + (x + bc + small)
    return {"ssd_fwd": (fwd_bytes, fwd_ops),
            "ssd_bwd": (bwd_bytes, 2 * fwd_ops)}


def rg_lru_work(B: int, S: int, W: int) -> Dict[str, Tuple[int, int]]:
    """(bytes, operations) of rg_lru_fwd and rg_lru_bwd from a zero
    state: each input read once and each output written once (x, r, i
    and h f32; lam W floats; the backward also reads h and dh and writes
    dx, dr, di, dlam and dh0), ~10 operations an element in the forward
    (the gate's product, exp, expm1, sqrt, i * x, two multiplies and the
    carry's FMA) and ~20 in the backward."""
    n = B * S * W
    return {"rg_lru_fwd": (16 * n + 4 * W, 10 * n),
            "rg_lru_bwd": (32 * n + 8 * W + 4 * B * W, 20 * n)}


# bytes an element the RG-LRU kernels' designs move: the forward's three
# phases read x, r, i twice; the backward reads r and dh twice
RG_LRU_DESIGN_BYTES = {"rg_lru_fwd": 28, "rg_lru_bwd": 40}


@dataclass
class Launch:
    """One kernel launch of a traced call: its own work and the plain
    version's in its place. ``flops`` counts products only (the dot
    rule): an RG-LRU launch has none."""
    kernel: str
    flops: float
    hbm_bytes: float
    plain_flops: float
    plain_bytes: float


def kernel_work(kernel: str, **d) -> Tuple[int, int]:
    """(bytes, operations) of one launch of ``kernel`` at a wrapper's
    dims: flash (B, H, Hkv, Sq, Skv, hd, esz, causal, window) and SSD (B,
    S, H, P, N, q, esz) at the bounds' work, RG-LRU (B, S, W) at the
    bytes its design moves."""
    if kernel.startswith("flash_"):
        return flash_work(d["B"], d["H"], d["Hkv"], d["Sq"], d["Skv"],
                          d["hd"], d["esz"], d["causal"],
                          d["window"])[kernel]
    if kernel.startswith("ssd_"):
        return ssd_work(d["B"], d["S"], d["H"], d["P"], d["N"], d["q"],
                        d["esz"])[kernel]
    if kernel.startswith("rg_lru_"):
        return RG_LRU_DESIGN_BYTES[kernel] * d["B"] * d["S"] * d["W"], 0
    raise ValueError(f"no work formula for kernel {kernel!r}")


def _call_key(value):
    """What a plain version's work depends on: tensors by shape, dtype
    and device, anything else by value."""
    if isinstance(value, torch.Tensor):
        return (tuple(value.shape), value.dtype, value.device.type)
    if isinstance(value, (tuple, list)):
        return tuple(_call_key(v) for v in value)
    return value


_PLAIN: Dict[Any, Tuple[float, float]] = {}
_PLAIN_LOCK = threading.Lock()


def plain_work(plain: functools.partial) -> Tuple[float, float]:
    """(flops, hbm bytes) of the plain version ``plain`` (a partial over
    the launch's inputs): the plain version traced by an
    :class:`Analyzer` once for each shape of its inputs."""
    key = (plain.func.__module__, plain.func.__qualname__,
           _call_key(plain.args),
           tuple(sorted((k, _call_key(v)) for k, v in
                        plain.keywords.items())))
    with _PLAIN_LOCK:
        hit = _PLAIN.get(key)
    if hit is None:
        a = Analyzer()
        with a, torch.no_grad():
            plain()
        hit = (a.counts.flops, a.counts.hbm_bytes)
        with _PLAIN_LOCK:
            _PLAIN[key] = hit
    return hit


# --- collectives -----------------------------------------------------------

_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
          "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
          "broadcast": "collective-permute"}


def ring_wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Per-rank wire bytes of one collective over ``n`` ranks whose
    result is ``result_bytes``: the reference's ring factors."""
    if kind == "all-reduce":
        return result_bytes * 2 * (n - 1) / n
    if kind in ("all-gather", "all-to-all"):
        return result_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)
    if kind == "collective-permute":
        return result_bytes
    raise ValueError(f"no collective kind {kind!r}")


def _collective_kind(op: str) -> Optional[str]:
    """The reference's kind of a ``_c10d_functional`` op (by its name),
    or None for one that moves nothing (``wait_tensor``)."""
    for prefix, kind in _KINDS.items():
        if op.startswith(prefix):
            return kind
    return None


def _group_size(args, kwargs) -> int:
    """The ranks of a functional collective's group (its last argument
    names the group)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = kwargs.get("group_name", args[-1])
    return int(_resolve_process_group(name).size())


# --- the counts -------------------------------------------------------------

@dataclass
class RooflineCounts:
    """One traced call's terms for one rank (``launches``: each kernel
    launch's record, in place of the reference's ``loops``)."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_breakdown: Dict[str, float] = field(default_factory=dict)
    n_collectives: int = 0
    launches: List[Launch] = field(default_factory=list)
    n_ops: int = 0
    # ops whose output size depends on the data (nonzero, indexing by a
    # boolean mask), taken at their upper bound (every element) on fake
    # tensors
    upper_bound_ops: int = 0

    def add_launch(self, rec: Launch) -> None:
        self.launches.append(rec)
        self.flops += rec.plain_flops
        self.hbm_bytes += rec.plain_bytes

    def launch_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for rec in self.launches:
            out[rec.kernel] = out.get(rec.kernel, 0) + 1
        return out

    def flops_kernel_adjusted(self) -> float:
        """Products if the launches ran at their kernels' own work."""
        return max(self.flops + sum(r.flops - r.plain_flops
                                    for r in self.launches), 0.0)

    def hbm_bytes_kernel_adjusted(self) -> float:
        """Memory traffic if the launches ran at their kernels' own
        bytes, in place of what the plain version moves."""
        return max(self.hbm_bytes + sum(r.hbm_bytes - r.plain_bytes
                                        for r in self.launches), 0.0)


def roofline_terms(counts: RooflineCounts,
                   kernel_adjusted: bool = False) -> Dict[str, float]:
    flops = counts.flops_kernel_adjusted() if kernel_adjusted \
        else counts.flops
    t_c = flops / PEAK_FLOPS
    hbm = counts.hbm_bytes_kernel_adjusted() if kernel_adjusted \
        else counts.hbm_bytes
    t_m = hbm / HBM_BW
    t_x = counts.collective_bytes / NVLINK_BW
    dom = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))
    bound = max(t_c, t_m, t_x)
    return {
        "compute_s": t_c,
        "memory_s": t_m,
        "collective_s": t_x,
        "dominant": dom[1],
        "bound_s": bound,
        "roofline_fraction": (t_c / bound) if bound > 0 else 0.0,
    }


# --- the analyzer -----------------------------------------------------------

_FLOP_PACKETS = ("mm", "addmm", "bmm", "baddbmm", "convolution",
                 "_convolution", "convolution_backward")
# ops that move no element of device memory: views are found by their
# schema; these allocate without writing, copy a layout, or read metadata
_NO_TRAFFIC = frozenset((
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "clone", "cat", "stack", "arange", "detach",
    "alias", "lift_fresh", "lift_fresh_copy", "_unsafe_view", "device",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_contiguous", "is_same_size", "_local_scalar_dense", "set_",
    "resize_", "_has_compatible_shallow_copy_type"))

# indexing ops whose boolean-mask indices select a number of elements
# that depends on the data
_MASK_INDEXED = frozenset(("index", "index_put", "index_put_",
                           "_index_put_impl_"))


def _is_mask(ix) -> bool:
    return isinstance(ix, torch.Tensor) and ix.dtype in (torch.bool,
                                                         torch.uint8)


def _upper_bound(indices):
    """Boolean-mask indices as integer ones that select every element
    (the upper bound of what a mask selects), for fake tensors."""
    out = []
    for ix in indices:
        if _is_mask(ix):
            out.extend(torch.zeros(ix.numel(), dtype=torch.int64,
                                   device=ix.device) for _ in range(ix.dim()))
        else:
            out.append(ix)
    return out


def _local(t):
    """A DTensor's local block, else the tensor."""
    inner = getattr(t, "_local_tensor", None)
    return inner if isinstance(inner, torch.Tensor) else t


class Analyzer(TorchDispatchMode):
    """Counts one traced call's roofline terms and follows its live
    bytes. Use as a context manager around the call, after naming its
    arguments with :meth:`hold`; ``counts``, ``argument_bytes`` and
    ``temp_bytes`` hold the results."""

    def __init__(self) -> None:
        super().__init__()
        self.counts = RooflineCounts()
        self.argument_bytes = 0
        self.temp_bytes = 0
        self._live = 0
        self._seen: Dict[int, int] = {}       # id(storage) -> bytes
        self._lock = threading.Lock()
        self._suspended = 0
        from torch.distributed.tensor import DTensor
        self._dtensor = DTensor
        self._undo: List[Any] = []

    # -- live bytes --

    def hold(self, *trees) -> int:
        """Name the call's arguments (any pytree of tensors and
        DTensors): their storages count as ``argument_bytes``, not as
        temporaries. Returns the bytes added."""
        added = 0
        leaves, _ = tree_flatten(trees)
        for t in leaves:
            if not isinstance(t, torch.Tensor):
                continue
            st = _local(t).untyped_storage()
            if id(st) in self._seen:
                continue
            n = int(st.nbytes())
            self._seen[id(st)] = -1          # an argument: never dropped
            weakref.finalize(st, self._seen.pop, id(st), None)
            added += n
        self.argument_bytes += added
        return added

    def _track(self, out) -> None:
        leaves, _ = tree_flatten(out)
        for t in leaves:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            with self._lock:
                if key in self._seen:
                    continue
                n = int(st.nbytes())
                self._seen[key] = n
                self._live += n
                self.temp_bytes = max(self.temp_bytes, self._live)
            weakref.finalize(st, self._drop, key)

    def _drop(self, key: int) -> None:
        with self._lock:
            n = self._seen.pop(key, 0)
            if n > 0:
                self._live -= n

    @property
    def live_bytes(self) -> int:
        return self.argument_bytes + self.temp_bytes

    # -- the mode --

    def _on_launch(self, kernel: str, plain, dims) -> None:
        """A fake launch (``kernels.trace.note_launch``): the kernel's
        own work by :func:`kernel_work`, the plain version's by
        :func:`plain_work`, whose trace this analyzer does not count."""
        b, f = kernel_work(kernel, **dims)
        with self.suspended():
            pf, pb = plain_work(plain)
        self.counts.add_launch(Launch(kernel, float(f), float(b), float(pf),
                                      float(pb)))

    def __enter__(self):
        listen = launches_to(self._on_launch)
        listen.__enter__()
        self._undo.append(lambda: listen.__exit__(None, None, None))
        self._patch_dtensor_propagation()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for undo in reversed(self._undo):
                undo()
            self._undo.clear()

    @contextmanager
    def suspended(self):
        """Ops inside are not counted (DTensor's sharding propagation
        runs each op once more at global shapes, to learn the output's
        metadata: not part of the rank's work)."""
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1

    def _patch_dtensor_propagation(self) -> None:
        from torch.distributed.tensor import _sharding_prop as sp
        cls, name = sp.ShardingPropagator, "_propagate_tensor_meta_non_cached"
        orig = cls.__dict__.get(name)
        if orig is None:
            raise RuntimeError(f"DTensor's ShardingPropagator has no {name}: "
                               "its shadow ops at global shapes would be "
                               "counted")

        def wrapped(*a, **k):
            with self.suspended():
                return orig(*a, **k)
        setattr(cls, name, wrapped)
        self._undo.append(lambda: setattr(cls, name, orig))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._suspended:
            return func(*args, **kwargs)
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented          # count the DTensor's local ops
        packet = func._overloadpacket.__name__
        if packet == "nonzero" and args and is_fake(args[0]):
            x = args[0]
            self.counts.upper_bound_ops += 1
            out = torch.empty((x.numel(), x.dim()), dtype=torch.int64,
                              device=x.device)
        elif packet in _MASK_INDEXED and args and is_fake(args[0]) and \
                any(_is_mask(ix) for ix in args[1]):
            self.counts.upper_bound_ops += 1
            out = func(args[0], _upper_bound(args[1]), *args[2:], **kwargs)
        else:
            out = func(*args, **kwargs)
        self._count(func, packet, args, kwargs, out)
        self._track(out)
        return out

    def _count(self, func, packet: str, args, kwargs, out) -> None:
        c = self.counts
        ns = func.namespace
        if ns.startswith("_c10d_functional"):
            kind = _collective_kind(packet)
            if kind is None:
                return
            outs = [t for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)]
            rbytes = float(sum(tensor_bytes(t) for t in outs))
            wire = ring_wire_bytes(kind, rbytes, _group_size(args, kwargs))
            c.collective_bytes += wire
            c.collective_breakdown[kind] = \
                c.collective_breakdown.get(kind, 0.0) + wire
            c.n_collectives += 1
            c.hbm_bytes += 2 * rbytes
            return
        if ns != "aten" or func.is_view or packet in _NO_TRAFFIC:
            return
        c.n_ops += 1
        if packet in _FLOP_PACKETS:
            from torch.utils.flop_counter import flop_registry
            c.flops += float(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        c.hbm_bytes += float(sum(tensor_bytes(t) for t in ins + outs))


def analyze(fn, *args, hold=(), **kwargs):
    """(fn's result, its :class:`Analyzer`): one call of ``fn`` traced,
    with ``hold`` (a pytree) named as its arguments."""
    a = Analyzer()
    a.hold(hold)
    with a:
        out = fn(*args, **kwargs)
    return out, a
