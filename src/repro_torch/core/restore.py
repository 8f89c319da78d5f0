"""Restore primitives (paper §II-III): the per-phase building blocks of
the restart sequence.

The lifecycle that *orders* these — materialize the delta chain, fresh
LowerHalf + ``new_incarnation()``, op-log replay, upper-half rebinding
onto the replayed device — is owned by ``core.incarnation.Incarnation``;
the serving engine resumes through it. This module keeps the phase
primitives it calls (``materialize_entry``, ``restore_scalar``) plus
operator-facing queries over a checkpoint directory
(``restorable_steps``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.checkpoint import RestoredState
from repro_torch.host import to_tensor
from repro_torch.parallel.sharding import shard_tensor
from repro_torch.tree import fill_like, tree_map


def restorable_steps(backend) -> List[int]:
    """Committed steps whose full delta chain is still present — a step
    whose base manifest was GC'd (or never landed) is excluded. What an
    operator should consult before picking a restore target.

    Each manifest is read exactly once: one ascending pass memoizes the
    ``base_step`` links, and chain validity propagates base-first (a
    sorted step's base is always <= it, so its verdict is already
    known). O(n) manifest reads, not O(n * chain length)."""
    have = set(backend.list_steps())
    base: Dict[int, Optional[int]] = {}
    for s in sorted(have):
        try:
            base[s] = backend.get_manifest(s).get("base_step")
        except FileNotFoundError:
            continue  # raced a concurrent GC; treat as not restorable
    ok: Dict[int, bool] = {}
    for s in sorted(base):
        b = base[s]
        ok[s] = b is None or ok.get(b, False)
    return [s for s in sorted(have) if ok.get(s, False)]


def materialize_entry(restored: RestoredState, name: str, template,
                      device, plan=None, logical=None):
    """Step 3 for one entry: path-matched host leaves -> tensors on
    ``device`` with the dtypes of ``template`` (a tree of tensors; a
    bfloat16 leaf's host bytes arrive as their uint16 bit view; an
    ``int8`` codec leaf is dequantized on ``device`` as it lands).

    ``device`` may be a ``DeviceMesh``: each leaf's logical axes
    (``logical``) then bind through ``spec_for_axes`` under ``plan`` onto
    that mesh, and each rank keeps only its block, as a DTensor (a leaf
    with no axes, or a 0-d one, replicated). The checkpoint holds whole
    leaves, whatever mesh wrote it, so any mesh can read it; a streamed
    entry is waited for whole first, then sharded, as the reference
    does."""
    by_path = restored.entries[name]
    # a streaming restore hands us a LazyLeaves Mapping: binding a whole
    # entry is a bulk page-in, so wait for it as one promoted batch
    # instead of faulting leaf-by-leaf through fill_like
    waiter = getattr(by_path, "wait", None)
    if callable(waiter):
        waiter()
    from repro_torch.launch.mesh import is_device_mesh
    if is_device_mesh(device):
        return _materialize_on_mesh(fill_like(template, by_path), template,
                                    device, plan, logical)
    host_tree = fill_like(template, by_path)
    return tree_map(lambda t, v: to_tensor(v, t.dtype, device),
                    template, host_tree)


def _materialize_on_mesh(host_tree, template, mesh, plan, logical):
    from repro_torch.core.delta import Int8Leaf
    from repro_torch.launch.mesh import mesh_device
    from repro_torch.parallel.sharding import tree_placements
    from torch.distributed.tensor import Replicate
    dev = mesh_device(mesh)
    places = tree_placements(plan, logical, template, mesh) \
        if logical is not None else tree_map(
            lambda t: (Replicate(),) * mesh.ndim, template)

    def bind(t, v, pl):
        if isinstance(v, Int8Leaf):     # dequantized where it lands
            return shard_tensor(to_tensor(v, t.dtype, dev), mesh, pl)
        return shard_tensor(to_tensor(v, t.dtype, None), mesh, pl, dev)

    return tree_map(bind, template, host_tree, places)


def restore_scalar(restored: RestoredState, name: str):
    """Entries that are plain scalars/int trees (step counters, cursors)."""
    by_path = restored.entries[name]
    if list(by_path) == [""]:
        v = by_path[""]
        return v.item() if hasattr(v, "item") and v.ndim == 0 else v
    return by_path
