"""Collectives between ranks that share one card, and the one shim that
stages a collective through pinned host memory where gloo refuses it.

NCCL will not put two ranks on one GPU, so the port's ranks on a
one-card machine talk through gloo. gloo takes CUDA tensors for some
collectives and not for others: on an H100 machine (PyTorch 2.11) its
all-reduce and broadcast ran on CUDA tensors as they were, while
DTensor's functional all-gather over CUDA tensors crashed the rank
(SIGSEGV) and a point-to-point send of a CUDA tensor aborted it (gloo's
TCP transport wrote from a device pointer: "writev ... Bad address").

``install_card_shim`` registers a kernel for each functional collective
DTensor issues (``_c10d_functional``: all-reduce, all-gather,
reduce-scatter, all-to-all, broadcast and their coalesced forms) under
the dispatch key of the ranks' device: ``launch.mesh.spawn_ranks``
installs it in every rank it starts, so the card's ranks and gloo CPU
ranks run the same collectives. Each runs synchronously on the group
DTensor names:

- broadcast through gloo on the tensors as they are;
- all-gather, reduce-scatter, all-reduce and all-to-all staged: each
  rank copies its input into its own slot of one page-locked host area
  that every rank of the launch maps (``Staging``, made by
  ``launch.mesh.spawn_ranks``), the group meets at a gloo barrier, each
  rank copies what it needs from the group's slots back to the card (a
  reduce-scatter sums the parts there, in group-rank order, so every
  run gives the same bits; an all-reduce is a reduce-scatter and an
  all-gather), and the group meets again before a slot is reused. A
  payload larger than a slot goes in pieces. gloo carries only the
  barriers. gloo does take an all-reduce of CUDA tensors, but through
  its TCP transport: on the H100 machine 0.650 s for 256 MB over four
  ranks, against 0.102 s staged (``PERF.md`` §6).

``gather_to`` is the snapshot's and the digests' gather: the same slots
and barriers, but only the destination rank copies the blocks back and
builds the whole tensor; the others hold no more than their own block.

The pipeline's point-to-point hand-offs (``send_recv``) are staged
through pinned host buffers and gloo's isend/irecv. Compute never leaves
the card: only the bytes a collective moves go through the host.

Every collective the shim runs is named and counted in ``STATS``: calls,
bytes (the input's, per rank), seconds, and whether it was staged —
``chip_smoke.py``'s mesh phase prints them.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# name -> {"calls", "bytes", "seconds", "staged"}
STATS: Dict[str, Dict[str, float]] = {}

_COMBINE = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum,
            "product": torch.mul}


class Staging:
    """One slot of ``area.numel() / world`` bytes per rank of the launch
    in a host area every rank maps (a shared-memory uint8 tensor handed
    to each rank), page-locked where ``pin`` (a rank on a card)."""

    def __init__(self, area: torch.Tensor, world: int, pin: bool) -> None:
        self.area = area
        self.slot_bytes = area.numel() // world
        if pin:
            rt = torch.cuda.cudart()
            err = int(rt.cudaHostRegister(area.data_ptr(), area.numel(), 0))
            if err != 0:
                raise RuntimeError(f"cudaHostRegister of the {area.numel()} "
                                   f"B staging area failed (CUDA error "
                                   f"{err})")

    def slot(self, rank: int, nbytes: int) -> torch.Tensor:
        lo = rank * self.slot_bytes
        return self.area[lo:lo + nbytes]


_STATE: Dict[str, object] = {"lib": None, "staging": None}


def _staging() -> Staging:
    st = _STATE["staging"]
    if st is None:
        raise RuntimeError(
            "no staging area in this process: ranks that run collectives "
            "are started by repro_torch.launch.mesh.spawn_ranks, which "
            "installs the shim")
    return st


def reset_stats() -> None:
    STATS.clear()


def _count(name: str, nbytes: int, seconds: float, staged: bool) -> None:
    s = STATS.setdefault(name, {"calls": 0, "bytes": 0, "seconds": 0.0,
                                "staged": staged})
    s["calls"] += 1
    s["bytes"] += nbytes
    s["seconds"] += seconds


def _group(name):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name)


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(-1).view(torch.uint8)


def _timed(name: str, staged: bool, x: torch.Tensor,
           fn: Callable[[], Optional[torch.Tensor]]
           ) -> Optional[torch.Tensor]:
    t0 = time.perf_counter()
    out = fn()
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    _count(name, x.numel() * x.element_size(), time.perf_counter() - t0,
           staged)
    return out


def _spans(n: int, size: int):
    """(offset, length) pieces of ``n`` bytes, each at most ``size``."""
    return [(lo, min(size, n - lo)) for lo in range(0, n, size)] or [(0, 0)]


def _rounds(group, pieces: Sequence[Sequence[torch.Tensor]],
            read: Callable[[int, List[torch.Tensor]], None]) -> None:
    """For each round ``i``: this rank's ``pieces[i]`` (byte tensors laid
    end to end, at most a slot) into its slot, a barrier, ``read(i,
    [each group rank's slot, in group-rank order])``, a barrier."""
    st = _staging()
    me = dist.get_rank()
    members = dist.get_process_group_ranks(group) if group is not None \
        else list(range(dist.get_world_size()))
    for i, parts in enumerate(pieces):
        n = sum(p.numel() for p in parts)
        if n > st.slot_bytes:
            raise ValueError(f"a {n} B round past the {st.slot_bytes} B "
                             "staging slot")
        off = 0
        mine = st.slot(me, n)
        for p in parts:
            mine[off:off + p.numel()].copy_(p)
            off += p.numel()
        dist.barrier(group=group)
        read(i, [st.slot(r, n) for r in members])
        dist.barrier(group=group)


def _all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """Staged as a reduce-scatter and an all-gather of the flat tensor,
    padded to the group size: every rank gets the same bits."""
    n = dist.get_world_size(group)
    if op == "avg":
        return _all_reduce(x, "sum", group) / n

    def run():
        flat = x.contiguous().reshape(-1)
        pad = (-flat.numel()) % n
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        part = _reduce_scatter_raw(flat.view(n, -1), op, n, group)
        whole = _all_gather_raw(part, n, group).reshape(-1)
        return whole[:x.numel()].view(x.shape)
    return _timed("all_reduce", True, x, run)


def _broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    def run():
        out = x.clone()
        dist.broadcast(out, src, group=group)
        return out
    return _timed("broadcast", False, x, run)


def _all_gather_raw(x: torch.Tensor, group_size: int, group
                    ) -> torch.Tensor:
    src = _bytes(x)
    n = src.numel()
    out = torch.empty(group_size * n, dtype=torch.uint8, device=x.device)
    spans = _spans(n, _staging().slot_bytes)

    def read(i, slots):
        lo, size = spans[i]
        for j, s in enumerate(slots):
            out[j * n + lo:j * n + lo + size].copy_(s)
    _rounds(group, [[src[lo:lo + size]] for lo, size in spans], read)
    return out.view(x.dtype).view((group_size * x.shape[0],)
                                  + tuple(x.shape[1:]))


def _all_gather(x: torch.Tensor, group_size: int, group) -> torch.Tensor:
    return _timed("all_gather", True, x,
                  lambda: _all_gather_raw(x, group_size, group))


def _reduce_scatter_raw(x: torch.Tensor, op: str, group_size: int,
                        group) -> torch.Tensor:
    """x [group_size * c, ...] -> this rank's [c, ...] of the sum over
    the group, the parts added in group-rank order."""
    me = dist.get_rank(group)
    chunks = [_bytes(c) for c in x.contiguous().chunk(group_size)]
    n = chunks[0].numel()
    out = torch.empty(n, dtype=torch.uint8, device=x.device)
    # a round carries the same span of every rank's chunk
    span = max(x.element_size(), _staging().slot_bytes // group_size)
    span -= span % x.element_size()
    spans = _spans(n, span)

    def read(i, slots):
        lo, size = spans[i]
        acc = None
        for s in slots:
            part = s[me * size:(me + 1) * size].to(x.device).view(x.dtype)
            acc = part if acc is None else _COMBINE[op](acc, part)
        out[lo:lo + size].copy_(acc.view(torch.uint8))
    _rounds(group, [[c[lo:lo + size] for c in chunks] for lo, size in spans],
            read)
    return out.view(x.dtype).view((x.shape[0] // group_size,)
                                  + tuple(x.shape[1:]))


def _reduce_scatter(x: torch.Tensor, op: str, group_size: int,
                    group) -> torch.Tensor:
    if op == "avg":
        return _reduce_scatter(x, "sum", group_size, group) / group_size
    return _timed("reduce_scatter", True, x,
                  lambda: _reduce_scatter_raw(x, op, group_size, group))


def _all_to_all(x: torch.Tensor, out_splits, in_splits, group
                ) -> torch.Tensor:
    """Even splits only (DTensor's reshards of an even dim)."""
    n = dist.get_world_size(group)
    if len(set(list(in_splits) + list(out_splits))) > 1:
        raise NotImplementedError(
            f"an all-to-all of uneven splits {list(in_splits)} -> "
            f"{list(out_splits)}")

    def run():
        me = dist.get_rank(group)
        per = _bytes(x).numel() // n           # bytes to each destination
        src = _bytes(x)
        out = torch.empty(n * per, dtype=torch.uint8, device=x.device)
        spans = _spans(per, _staging().slot_bytes)
        # one destination's rows a round (in pieces): every rank writes
        # its rows for that destination, the destination reads them
        rounds = [(dst, lo, size) for dst in range(n) for lo, size in spans]

        def read(i, slots):
            dst, lo, size = rounds[i]
            if dst == me:
                for j, sl in enumerate(slots):
                    out[j * per + lo:j * per + lo + size].copy_(sl)
        _rounds(group, [[src[dst * per + lo:dst * per + lo + size]]
                        for dst, lo, size in rounds], read)
        return out.view(x.dtype).view(x.shape)
    return _timed("all_to_all", True, x, run)


def _coordinate(grid: torch.Tensor, rank: int) -> List[int]:
    """Global ``rank``'s coordinate in a mesh's grid of ranks."""
    return [int(c) for c in (grid == rank).nonzero()[0]]


def gather_to(x, dst: int = 0) -> Optional[torch.Tensor]:
    """``x`` (a DTensor of ``Shard``/``Replicate`` placements over a mesh
    of the whole world, or a plain tensor) whole on global rank ``dst``,
    None on the other ranks; collective. Each rank writes its block into
    its staging slot; ``dst`` alone copies one holder of each distinct
    block (the rank at coordinate 0 on every replicating mesh dim) to
    its device and places it, while the other ranks only wait at the
    barriers. A plain tensor is every rank's own: ``dst`` returns it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.parallel.sharding import block_narrows
    me = dist.get_rank()
    if not isinstance(x, DTensor):
        return x if me == dst else None
    places = tuple(x.placements)
    if not all(isinstance(p, (Shard, Replicate)) for p in places):
        raise ValueError(f"gather_to takes Shard/Replicate placements, "
                         f"not {places}")
    grid = x.device_mesh.mesh
    if grid.numel() != dist.get_world_size():
        raise ValueError(f"gather_to needs a mesh of the whole world "
                         f"({dist.get_world_size()} ranks), not "
                         f"{tuple(grid.shape)}")
    local = x.to_local().contiguous()
    src = _bytes(local)
    n = src.numel()
    holders = [r for r in range(grid.numel())
               if all(c == 0 for c, p in zip(_coordinate(grid, r), places)
                      if not isinstance(p, Shard))]

    def run():
        spans = _spans(n, _staging().slot_bytes)
        blocks = {r: torch.empty(n, dtype=torch.uint8, device=local.device)
                  for r in holders} if me == dst else {}

        def read(i, slots):
            lo, size = spans[i]
            for r, b in blocks.items():
                b[lo:lo + size].copy_(slots[r])
        _rounds(None, [[src[lo:lo + size]] for lo, size in spans], read)
        if me != dst:
            return None
        out = torch.empty(tuple(x.shape), dtype=x.dtype,
                          device=local.device)
        for r, b in blocks.items():
            view = out
            for d, start, size in block_narrows(
                    tuple(x.shape), tuple(grid.shape),
                    _coordinate(grid, r), places):
                view = view.narrow(d, start, size)
            view.copy_(b.view(x.dtype).view(local.shape))
        return out
    return _timed("gather", True, local, run)


def install_card_shim(staging: Staging, dispatch_key: str = "CUDA"
                      ) -> None:
    """Register the shim's kernels for DTensor's functional collectives
    under ``dispatch_key`` (once per process, after
    ``init_process_group``): ``launch.mesh.spawn_ranks`` registers them
    under the ranks' device, ``"CUDA"`` on the card and ``"CPU"`` on gloo
    CPU ranks, so both run the same staging."""
    if _STATE["lib"] is not None:
        return
    _STATE["staging"] = staging
    lib = torch.library.Library("_c10d_functional", "IMPL")

    def reg(name, fn):
        lib.impl(name, fn, dispatch_key)

    reg("all_reduce", lambda x, op, g: _all_reduce(x, op, _group(g)))
    reg("all_reduce_", lambda x, op, g: x.copy_(
        _all_reduce(x, op, _group(g))))
    reg("all_reduce_coalesced", lambda xs, op, g: [
        _all_reduce(x, op, _group(g)) for x in xs])
    reg("all_gather_into_tensor",
        lambda x, n, g: _all_gather(x, n, _group(g)))
    reg("all_gather_into_tensor_coalesced", lambda xs, n, g: [
        _all_gather(x, n, _group(g)) for x in xs])
    reg("reduce_scatter_tensor",
        lambda x, op, n, g: _reduce_scatter(x, op, n, _group(g)))
    reg("reduce_scatter_tensor_coalesced", lambda xs, op, n, g: [
        _reduce_scatter(x, op, n, _group(g)) for x in xs])
    reg("all_to_all_single",
        lambda x, o, i, g: _all_to_all(x, o, i, _group(g)))
    reg("broadcast", lambda x, src, g: _broadcast(x, src, _group(g)))
    _STATE["lib"] = lib


def send_recv(send: Optional[torch.Tensor], dst: Optional[int],
              recv: Optional[torch.Tensor], src: Optional[int],
              group=None) -> None:
    """One hand-off step of a ring: send ``send`` to global rank ``dst``
    and receive into ``recv`` from global rank ``src`` (either may be
    None), both posted before either is waited on. CUDA tensors are
    staged through pinned host memory (gloo's transport reads host
    pointers only)."""
    t0 = time.perf_counter()
    dev = (send if send is not None else recv).device
    staged = dev.type == "cuda"
    s = send
    if staged and send is not None:
        s = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
        s.copy_(send)
    r = torch.empty(recv.shape, dtype=recv.dtype, pin_memory=True) \
        if staged and recv is not None else recv
    reqs: List = []
    if s is not None:
        reqs.append(dist.isend(s.contiguous(), dst, group=group))
    if r is not None:
        reqs.append(dist.irecv(r, src, group=group))
    for q in reqs:
        q.wait()
    if staged and recv is not None:
        recv.copy_(r)
    nbytes = 0 if send is None else send.numel() * send.element_size()
    _count("send_recv", nbytes, time.perf_counter() - t0, staged)


def all_reduce(x: torch.Tensor, group=None, op: str = "sum"
               ) -> torch.Tensor:
    """A counted all-reduce of ``x`` over ``group`` (a new tensor)."""
    return _all_reduce(x, op, group)


def broadcast(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """A counted broadcast of ``x`` from global rank ``src`` (a new
    tensor)."""
    return _broadcast(x, src, group)
