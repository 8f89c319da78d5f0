"""Mesh construction and rank spawning — the port of
``repro.launch.mesh``.

A mesh is a ``torch.distributed`` ``DeviceMesh`` with named dims over
the ranks of the default process group; its size must equal the world
size. Functions, not module-level constants: importing this module
touches no device and starts no process.

``spawn_ranks`` is the one way the tests, ``chip_smoke.py`` and the
launcher start ranks: ``torch.multiprocessing`` with the spawn method,
rendezvous through a ``FileStore`` in a fresh temp directory (no port,
so concurrent test workers cannot collide), gloo as the backend — on a
one-card machine every rank shares the card, and NCCL will not put two
ranks on one GPU. Every rank installs the collective shim
(``parallel.collectives``) over one host staging area that all of them
map, caps its CPU threads, returns its function's result by pickle to
the parent, and tears its process group down.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.host import resolve_device


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device=None):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    world's ranks, on the card unless ``device="cpu"``. Raises unless the
    process group's world size equals the mesh's size."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = int(np.prod(shape))
    if not dist.is_initialized() or world_size() != n:
        raise ValueError(
            f"a {shape} mesh over {axes} needs a process group of {n} "
            f"ranks; this process has {world_size()} "
            f"({'initialized' if dist.is_initialized() else 'none'})")
    dev = resolve_device(device)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production shapes: (16, 16) over (data, model),
    (2, 16, 16) over (pod, data, model) — on a world of that size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(n_data: Optional[int] = None,
                   n_model: Optional[int] = None, device=None):
    """A (data, model) mesh over the world's ranks, all of them on the
    data axis unless told otherwise."""
    n = world_size()
    if n_data is None and n_model is None:
        n_data, n_model = n, 1
    elif n_data is None:
        n_data = n // n_model
    elif n_model is None:
        n_model = n // n_data
    if n_data * n_model != n:
        raise ValueError(f"({n_data}, {n_model}) is no mesh of {n} ranks")
    return make_mesh((n_data, n_model), ("data", "model"), device)


def mesh_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def batch_axes_of(mesh) -> Tuple[str, ...]:
    """Data-parallel axes: pod (if present) folded into data."""
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def mesh_devices(mesh) -> int:
    return int(np.prod(list(mesh.shape)))


def is_device_mesh(mesh) -> bool:
    return getattr(mesh, "mesh_dim_names", None) is not None \
        and hasattr(mesh, "device_type")


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on: a mesh's (its card, or the
    CPU), or ``mesh`` itself when it is one device."""
    if is_device_mesh(mesh):
        if mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(mesh.device_type)
    return torch.device(mesh)


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

def _rank_main(fn: Callable, rank: int, world: int, device: str,
               args: Sequence[Any], threads: int, workdir: str,
               timeout_s: float, staging: torch.Tensor) -> None:
    torch.set_num_threads(threads)
    out = os.path.join(workdir, f"rank{rank}.pkl")
    try:
        store = dist.FileStore(os.path.join(workdir, "store"), world)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        card = torch.device(device).type == "cuda"
        if card:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        from repro_torch.parallel import collectives
        collectives.install_card_shim(
            collectives.Staging(staging, world, pin=card),
            "CUDA" if card else "CPU")
        result = ("ok", fn(rank, world, *args))
    except BaseException:
        result = ("error", traceback.format_exc())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".tmp", out)
    if result[0] != "ok":
        raise SystemExit(1)


STAGING_SLOT_BYTES = 64 << 20      # a rank's slot of the staging area


def spawn_ranks(fn: Callable, world: int, *, device: str = "cuda",
                args: Sequence[Any] = (), threads: int = 2,
                timeout_s: float = 900.0) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned ranks of one
    gloo process group on ``device`` ("cuda": every rank on the card;
    "cpu"); returns the ranks' results in rank order. ``fn`` and
    ``args`` are pickled (``fn`` by import path). A rank that raises
    makes this raise with its traceback, after the other ranks are
    stopped; so does a run past ``timeout_s``.

    Every rank installs the collective shim (``parallel.collectives``)
    under its device's dispatch key, over one shared staging area of
    ``STAGING_SLOT_BYTES`` a rank made here (the ranks all run on this
    host)."""
    ctx = torch.multiprocessing.get_context("spawn")
    area = torch.empty(world * STAGING_SLOT_BYTES, dtype=torch.uint8) \
        .share_memory_()
    with tempfile.TemporaryDirectory(prefix="repro_ranks_") as workdir:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, str(device), tuple(args),
                                   threads, workdir, timeout_s, area))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0)]
                if bad:
                    failed = bad[0]
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world} ranks of {fn.__name__} still running "
                        f"after {timeout_s:.0f} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r in range(world):
            path = os.path.join(workdir, f"rank{r}.pkl")
            if not os.path.exists(path):
                if failed is None:
                    failed = r
                results.append(("error", f"rank {r} exited with code "
                                f"{procs[r].exitcode} and no result"))
                continue
            with open(path, "rb") as f:
                results.append(pickle.load(f))
    errors = [(r, res[1]) for r, res in enumerate(results)
              if res[0] != "ok"]
    if errors:
        first = next((e for e in errors if e[0] == failed), errors[0])
        raise RuntimeError(f"rank {first[0]} of {world} failed "
                           f"({len(errors)} failed):\n{first[1]}")
    return [res[1] for res in results]
