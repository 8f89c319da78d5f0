"""Ambient mesh context — the port of ``repro.parallel.context``.

Models are plain functions, but the pieces that drop to local tensors
under a mesh (attention on each rank's heads, expert-parallel dispatch,
the vocab-parallel cross-entropy) need to know the mesh and which of
its axes carry data and model parallelism. Rather than threading mesh
handles through every call (which would also poison the upper-half
state with lower-half objects — see core.split_state), the train step
installs a ``MeshContext`` for the duration of its forward; models read
it here. There is no ``shard_map``: under a ``DeviceMesh`` the model's
tensors are DTensors, and the local pieces map them to each rank's
shard and back (``to_local`` / ``from_local``).
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MeshContext:
    mesh: object                      # torch.distributed DeviceMesh
    data_axes: Tuple[str, ...]        # ("data",) or ("pod", "data")
    model_axis: Optional[str]         # "model" (None = no tensor parallelism)

    @property
    def batch_spec_axes(self):
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    def size(self, axis: str) -> int:
        names = tuple(self.mesh.mesh_dim_names)
        return int(self.mesh.shape[names.index(axis)])

    def model_size(self) -> int:
        return 1 if self.model_axis is None else self.size(self.model_axis)

    def data_size(self) -> int:
        n = 1
        for a in self.data_axes:
            n *= self.size(a)
        return n

    def model_rank(self) -> int:
        """This rank's coordinate on the model axis."""
        if self.model_axis is None:
            return 0
        return int(self.mesh.get_local_rank(self.model_axis))

    def group(self, axis: str):
        """The process group of one mesh axis."""
        return self.mesh.get_group(axis)

    def placements(self, data, model) -> tuple:
        """One DTensor placement per mesh dim: ``data`` on the data
        axes, ``model`` on the model axis, Replicate elsewhere."""
        from torch.distributed.tensor import Replicate
        return tuple(data if a in self.data_axes else
                     model if a == self.model_axis else Replicate()
                     for a in self.mesh.mesh_dim_names)


_ctx: contextvars.ContextVar[Optional[MeshContext]] = contextvars.ContextVar(
    "repro_torch_mesh_context", default=None)


def current() -> Optional[MeshContext]:
    return _ctx.get()


def for_mesh(mesh) -> MeshContext:
    """The installed context, or — where none is, as in a remat
    recompute that autograd runs on its device thread — the plan's
    convention read off the mesh's dim names: ``pod``/``data`` carry the
    batch, ``model`` the tensor parallelism."""
    ctx = _ctx.get()
    if ctx is not None and ctx.mesh is mesh:
        return ctx
    names = tuple(mesh.mesh_dim_names)
    return MeshContext(mesh, tuple(a for a in names if a in ("pod", "data")),
                       "model" if "model" in names else None)


def batch_placement(x):
    """The placement of DTensor ``x``'s batch dim over the data axes:
    ``Shard(0)`` where its rows are split (training; a decode whose slots
    divide the data axes), ``Replicate()`` where every data rank holds
    them all (a batch-1 admission prefill)."""
    from torch.distributed.tensor import Replicate, Shard
    ctx = for_mesh(x.device_mesh)
    names = tuple(x.device_mesh.mesh_dim_names)
    split = any(isinstance(x.placements[names.index(a)], Shard)
                and x.placements[names.index(a)].dim == 0
                for a in ctx.data_axes)
    return Shard(0) if split else Replicate()


@contextlib.contextmanager
def mesh_context(mesh, data_axes=("data",), model_axis="model"):
    tok = _ctx.set(MeshContext(mesh, tuple(data_axes), model_axis))
    try:
        yield _ctx.get()
    finally:
        _ctx.reset(tok)
