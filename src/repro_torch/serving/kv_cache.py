"""Decode-state allocation (KV caches, SSM states, RG-LRU states) and
its layout over a device mesh — the port of ``repro.serving.kv_cache``.

Caches are lower-half resources: allocated through the logged runtime
API (CacheAlloc), referenced by virtual ids, re-allocated fresh at
restore by replay. For *serving* restores the cache contents are also
checkpointed as an upper-half entry (they are semantic: the
conversation's context) — see ``ServingEngine.session_state``.

Over a ``DeviceMesh`` each cache leaf is a DTensor whose placements
follow ``parallel.sharding.cache_specs``, the reference's layout rules
leaf by leaf (batch over the data axes where the slots divide; KV heads
over the model axis where they divide, else — the plan's
``cache_seq_axis`` — the cache's sequence), and each rank allocates
only its own block.
The slot axis of every leaf is ``models.model.batch_axes``'s; the
reference reads it off the leaf's rank, which differs only on the
hybrid's unstacked remainder blocks (ROADMAP C25).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs import registry as cfg_registry
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.parallel.sharding import (ParallelPlan, block_narrows,
                                           cache_specs, contiguous_strides,
                                           placements_for)
from repro_torch.tree import fill_like, flatten_with_paths


def cache_shardings(cfg: ModelConfig, plan: ParallelPlan, mesh,
                    spec_tree) -> Dict[str, tuple]:
    """{leaf path: DTensor placements} of ``spec_tree`` on ``mesh``
    (``parallel.sharding.cache_specs`` bound to the mesh's dims, each
    leaf's slot axis ``M.batch_axes``')."""
    return {p: placements_for(s, mesh) for p, s in cache_specs(
        plan, mesh, spec_tree, M.batch_axes(cfg)).items()}


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int):
    return M.cache_spec(cfg, batch, max_seq)


def sharded_cache(cfg: ModelConfig, batch: int, max_seq: int, mesh,
                  plan: ParallelPlan):
    """An empty cache on ``mesh`` as DTensors with ``cache_shardings``'
    placements: each rank allocates only its own block (float leaves
    zeros, ``pos`` -1) on its device."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import mesh_device
    tree = M.cache_spec(cfg, batch, max_seq)
    places = cache_shardings(cfg, plan, mesh, tree)
    dev = mesh_device(mesh)
    coord = [int(mesh.get_local_rank(i)) for i in range(mesh.ndim)]

    def make(path, s):
        local = list(s.shape)
        for d, _, size in block_narrows(s.shape, tuple(mesh.shape), coord,
                                        places[path]):
            local[d] = size
        t = torch.full(local, -1, dtype=torch.int32, device=dev) \
            if s.dtype == torch.int32 else \
            torch.zeros(local, dtype=s.dtype, device=dev)
        return DTensor.from_local(t, mesh, places[path], run_check=False,
                                  shape=torch.Size(s.shape),
                                  stride=contiguous_strides(s.shape))

    return fill_like(tree, {p: make(p, s)
                            for p, s in flatten_with_paths(tree)})


def allocate_cache(arch: str, batch: int, max_seq: int, lower) -> Any:
    """An empty cache on the lower half's device, or sharded over its
    mesh by the serving plan of a ``batch`` x ``max_seq`` decode
    (CacheAlloc)."""
    from repro_torch.launch.mesh import is_device_mesh
    from repro_torch.parallel.planner import make_plan
    cfg = cfg_registry.resolve_config(arch)
    if not is_device_mesh(lower.mesh):
        return M.init_cache(cfg, batch, max_seq, device=lower.mesh)
    plan = make_plan(cfg, ShapeConfig("alloc", max_seq, batch, "decode"),
                     lower.mesh)
    return sharded_cache(cfg, batch, max_seq, lower.mesh, plan)
