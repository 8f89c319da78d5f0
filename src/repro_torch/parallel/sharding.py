"""Logical-axis sharding — the port of ``repro.parallel.sharding``:
rules map logical axis names (declared once in the parameter templates)
to mesh axes, yielding partition specs, and here DTensor placements.

This is the boundary the paper's split-state design depends on: the
upper half stores *logical* axes only; binding them to a concrete mesh
happens here, at init and at restore, so a checkpoint taken on one
topology materializes on another (elastic restart).

The spec functions are the reference's, tuple for tuple: a mesh axis is
used at most once per spec, an assignment that does not divide its
dimension falls back to replication (e.g. 8 KV heads over a model axis
of 16), and trailing replicated dims are dropped. They take any mesh
object whose ``shape`` is a mapping from axis name to size (the JAX
package's ``Mesh``, a test's fake mesh) or a ``DeviceMesh`` with
``mesh_dim_names``. ``placements_for`` turns a spec into one DTensor
placement per mesh dimension: ``Shard(d)`` on each mesh dim that shards
tensor dim ``d`` (a dim sharded over several mesh axes is split in
mesh-dim order, as DTensor splits it), ``Replicate()`` elsewhere.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple, Union

AxisTarget = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One mesh-axis target per tensor dim (None: replicated), trailing
    Nones dropped — the counterpart of ``jax.sharding.PartitionSpec``
    (a tuple, so the two compare equal element for element)."""

    def __new__(cls, *parts: AxisTarget) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(tuple(self))


@dataclass(frozen=True)
class ParallelPlan:
    """A complete distribution decision for one (arch, shape, mesh) cell."""

    rules: Dict[str, AxisTarget]          # logical axis -> mesh axis target
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: Optional[str] = "model"
    remat: str = "full"                   # none | full
    seq_shard: bool = False               # sequence parallelism on residual
    cache_seq_axis: Optional[str] = None  # shard KV-cache seq dim (decode)
    grad_accum: int = 1
    # the reference's opt-in Megatron interior resharding; the port
    # carries the field for plan equality and reads it nowhere
    interior_tp: bool = False
    notes: str = ""

    def rule(self, name: Optional[str]) -> AxisTarget:
        if name is None:
            return None
        return self.rules.get(name)

    def with_(self, **kw) -> "ParallelPlan":
        return replace(self, **kw)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of any object whose
    ``shape`` is such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {a: int(s) for a, s in dict(mesh.shape).items()}


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(axis_sizes(mesh))


def spec_for_axes(plan: ParallelPlan, axes: Sequence[Optional[str]],
                  shape: Optional[Sequence[int]] = None,
                  mesh=None) -> PartitionSpec:
    """logical axes tuple -> PartitionSpec, dropping assignments that do
    not divide the dimension (e.g. kv_heads=8 over model=16 falls back to
    replication, the standard GQA choice)."""
    sizes = axis_sizes(mesh) if mesh is not None else None
    used = set()
    out: List[AxisTarget] = []
    for i, name in enumerate(axes):
        tgt = plan.rule(name)
        if tgt is None:
            out.append(None)
            continue
        tgt_tuple = (tgt,) if isinstance(tgt, str) else tuple(tgt)
        # drop already-used axes (a mesh axis may appear once per spec)
        tgt_tuple = tuple(a for a in tgt_tuple if a not in used)
        if not tgt_tuple:
            out.append(None)
            continue
        if shape is not None and sizes is not None:
            div = 1
            for a in tgt_tuple:
                div *= sizes[a]
            if shape[i] % div != 0:
                out.append(None)
                continue
        used.update(tgt_tuple)
        out.append(tgt_tuple[0] if len(tgt_tuple) == 1 else tgt_tuple)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def is_axes(x) -> bool:
    """A logical-axes leaf: a tuple of axis names (or None)."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        a is None or isinstance(a, str) for a in x)


def _map_axes(fn, logical, abstract):
    """Map ``fn(axes, abstract_leaf)`` over a logical-axes tree and its
    abstract tree (leaves with a ``shape``) — nested dicts and named
    tuples (a quantized moment), whose axes tuples are leaves."""
    if is_axes(logical):
        return fn(logical, abstract)
    if isinstance(logical, dict):
        return {k: _map_axes(fn, logical[k], abstract[k]) for k in logical}
    if isinstance(logical, tuple) and hasattr(logical, "_fields"):
        return type(logical)(*(_map_axes(fn, a, b)
                               for a, b in zip(logical, abstract)))
    raise TypeError(f"not a logical-axes tree node: {logical!r}")


def tree_specs(plan: ParallelPlan, logical_tree, abstract_tree, mesh):
    """(logical-axes tree, abstract tree) -> PartitionSpec tree."""
    return _map_axes(lambda axes, ab: spec_for_axes(plan, axes, ab.shape,
                                                    mesh),
                     logical_tree, abstract_tree)


def placements_for(spec: Sequence[AxisTarget], mesh) -> tuple:
    """A PartitionSpec -> one DTensor placement per mesh dimension."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for dim, tgt in enumerate(spec):
        if tgt is None:
            continue
        for a in ((tgt,) if isinstance(tgt, str) else tuple(tgt)):
            out[names.index(a)] = Shard(dim)
    return tuple(out)


def leaf_placements(plan: ParallelPlan, template, mesh):
    """{leaf path: placements} of a parameter template (leaves with
    ``axes`` and ``shape``, ``models.params.P``) on ``mesh``."""
    from repro_torch.tree import flatten_with_paths
    return {path: placements_for(spec_for_axes(plan, leaf.axes, leaf.shape,
                                               mesh), mesh)
            for path, leaf in flatten_with_paths(template)}


def tree_placements(plan: ParallelPlan, logical_tree, abstract_tree, mesh):
    """(logical-axes tree, abstract tree) -> placements tree."""
    return _map_axes(lambda axes, ab: placements_for(
        spec_for_axes(plan, axes, ab.shape, mesh), mesh),
        logical_tree, abstract_tree)


# ---------------------------------------------------------------------------
# standard rule sets
# ---------------------------------------------------------------------------

def train_rules(fsdp: bool, batch_axes: Tuple[str, ...]
                ) -> Dict[str, AxisTarget]:
    """Megatron-style TP (+ optional ZeRO-3 FSDP over the data axes)."""
    emb: AxisTarget = tuple(batch_axes) if fsdp else None
    return {
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",     # falls back to replication if indivisible
        "ff": "model",
        "experts": "model",
        "embed": emb,
        "layers": None,
    }


def serve_rules(depth: int, batch_axes: Tuple[str, ...]
                ) -> Dict[str, AxisTarget]:
    """depth 1: TP only. depth 2: 2D weight sharding (TP + weight
    sharding over the data axes)."""
    emb: AxisTarget = tuple(batch_axes) if depth >= 2 else None
    return {
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "experts": "model",
        "embed": emb,
        "layers": None,
    }


# ---------------------------------------------------------------------------
# activation / batch specs
# ---------------------------------------------------------------------------

def _batch_target(plan: ParallelPlan) -> AxisTarget:
    return plan.batch_axes[0] if len(plan.batch_axes) == 1 \
        else tuple(plan.batch_axes)


def batch_spec(plan: ParallelPlan) -> PartitionSpec:
    """[B, S] token batches: batch over data(+pod)."""
    return PartitionSpec(_batch_target(plan), None)


def activation_spec(plan: ParallelPlan) -> PartitionSpec:
    """Residual stream [B, S, D]."""
    seq = plan.model_axis if plan.seq_shard else None
    return PartitionSpec(_batch_target(plan), seq, None)


def logits_spec(plan: ParallelPlan) -> PartitionSpec:
    return PartitionSpec(_batch_target(plan), None, "model")


def cache_entry_spec(plan: ParallelPlan, entry_shape, kv_heads: int, mesh
                     ) -> PartitionSpec:
    """KV cache [B, S, Hkv, hd] (+leading layer dim handled by caller)."""
    sizes = axis_sizes(mesh)
    b = _batch_target(plan)
    bdiv = 1
    for a in plan.batch_axes:
        bdiv *= sizes[a]
    if entry_shape[0] % bdiv != 0:
        b = None
    m = plan.model_axis
    if m is not None and kv_heads % sizes[m] == 0 \
            and plan.cache_seq_axis is None:
        return PartitionSpec(b, None, m, None)
    if plan.cache_seq_axis is not None:
        return PartitionSpec(b, plan.cache_seq_axis, None, None)
    return PartitionSpec(b, None, None, None)


def cache_specs(plan: ParallelPlan, mesh, spec_tree, slot_axes
                ) -> Dict[str, PartitionSpec]:
    """{leaf path: PartitionSpec} of a decode-state tree ``spec_tree``
    (``models.model.cache_spec``'s), one entry per dim, whose leaves
    have their slot axis ``b`` at ``slot_axes``' leaf of the same path
    (``models.model.batch_axes``'s tree). Relative to ``b``:

      k/v, cross k/v  [.., B, S, Hkv, hd] -> heads over model when they
                      divide and the plan splits no cache sequence, else
                      the sequence over ``cache_seq_axis`` when it
                      divides
      pos             [.., B, S]          -> batch only
      ssm state       [.., B, H, hd, ds]  -> heads over model
      rg state        [.., B, W]          -> width over model
      conv windows    [...]               -> batch only

    and the batch over the data axes wherever the slots divide — the
    reference's ``serving.kv_cache.cache_shardings``, leaf by leaf."""
    import re
    from repro_torch.tree import flatten_with_paths
    sizes = axis_sizes(mesh)
    b_axes = _batch_target(plan)
    m = plan.model_axis
    bdiv = 1
    for a in plan.batch_axes:
        bdiv *= int(sizes[a])
    msize = int(sizes[m]) if m else 1
    axes_of = dict(flatten_with_paths(slot_axes))

    def leaf_spec(path: str, leaf) -> PartitionSpec:
        shape, bx = tuple(leaf.shape), axes_of[path]
        rest = len(shape) - bx            # dims from the slot axis on
        keys = re.findall(r"'(\w+)'", path)
        name = keys[-1] if keys else ""
        out = [None] * len(shape)
        out[bx] = b_axes if shape[bx] % bdiv == 0 else None
        if name == "state" and rest in (2, 4):       # ssm, rg
            if m and shape[bx + 1] % msize == 0:
                out[bx + 1] = m
        elif name == "pos":
            pass
        elif name in ("k", "v") or rest == 4:        # [B, S, Hkv, hd]
            if m and shape[bx + 2] % msize == 0 \
                    and plan.cache_seq_axis is None:
                out[bx + 2] = m
            elif plan.cache_seq_axis and shape[bx + 1] % msize == 0:
                out[bx + 1] = plan.cache_seq_axis
        return PartitionSpec(*out)

    return {p: leaf_spec(p, leaf) for p, leaf in flatten_with_paths(spec_tree)}


# ---------------------------------------------------------------------------
# binding to a DeviceMesh
# ---------------------------------------------------------------------------

def block_narrows(shape, mesh_shape, coord, placements
                  ) -> List[Tuple[int, int, int]]:
    """The (dim, start, size) narrows that cut the block of the mesh
    coordinate ``coord`` out of a whole tensor of ``shape``: each mesh
    dim that shards tensor dim ``d`` narrows it to the coordinate, in
    mesh-dim order (DTensor's split of even dims)."""
    sizes, out = list(shape), []
    for i, pl in enumerate(placements):
        d = getattr(pl, "dim", None)
        if d is None:
            continue
        size = sizes[d] // int(mesh_shape[i])
        out.append((d, int(coord[i]) * size, size))
        sizes[d] = size
    return out


def contiguous_strides(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (a DTensor built
    from its blocks is given its whole shape's)."""
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= int(d)
    return tuple(reversed(out))


def local_shard(full, mesh, placements):
    """This rank's block of ``full`` under ``placements`` on ``mesh``."""
    coord = [int(mesh.get_local_rank(i)) for i in range(mesh.ndim)]
    out = full
    for d, start, size in block_narrows(full.shape, tuple(mesh.shape),
                                        coord, placements):
        out = out.narrow(d, start, size)
    return out


def shard_tensor(full, mesh, placements, device=None):
    """A DTensor on ``mesh`` holding this rank's block of ``full`` (the
    same full tensor on every rank) on ``device`` (default: ``full``'s),
    with no communication. A 0-d tensor stays a plain tensor."""
    from torch.distributed.tensor import DTensor
    if full.dim() == 0:
        return full if device is None else full.to(device)
    local = local_shard(full, mesh, placements).contiguous()
    if device is not None:
        local = local.to(device)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=full.shape, stride=full.stride())
