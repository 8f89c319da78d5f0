"""Rank functions of ``test_torch_mesh.py``: each runs in a gloo CPU rank
that ``repro_torch.launch.mesh.spawn_ranks`` starts, imports no JAX
(the ranks only need the port), and returns plain Python and numpy
values for the test process to hold against the JAX package.

The smoke configs are float32 in every rank (``_f32``), as the test
process patches them for both packages.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

AXES = ("data", "model")
SHAPE = "train_s16_b4"
ARCH = "starcoder2-3b-smoke"
MOE_ARCH = "kimi-k2-1t-a32b-smoke"


def _f32():
    from repro_torch.configs import kimi_k2_1t_a32b, starcoder2_3b
    for mod in (starcoder2_3b, kimi_k2_1t_a32b):
        plain = mod.smoke_config
        if getattr(plain, "f32", False):
            continue
        f32 = lambda plain=plain: plain().replace(dtype="float32")
        f32.f32 = True
        mod.smoke_config = f32


def _whole(tree):
    """{path: numpy array} of a tree of (D)tensors, gathered whole
    (collective on a mesh)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.host import host_array
    from repro_torch.tree import flatten_with_paths
    return {p: host_array(v.full_tensor() if isinstance(v, DTensor) else v)
            for p, v in flatten_with_paths(tree)}


def _mesh_factory(shape):
    from repro_torch.launch.mesh import make_mesh
    return lambda: make_mesh(shape, AXES, "cpu")


def _restore(store, shape):
    from repro_torch.api import CheckpointSession
    from repro_torch.train.loop import Trainer
    sess = CheckpointSession(f"localfs:{store}")
    t = Trainer.restore(sess.manager, mesh_factory=_mesh_factory(shape))
    return t, sess


def _wait_for(path, timeout_s=300.0):
    """Block until the file ``path`` exists (another launch's signal)."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {timeout_s:.0f} s")
        time.sleep(0.05)


def _restore_and_step(store, shape):
    r, rs = _restore(store, shape)
    got = dict(digest=r.params_digest(), step=r.checkpoint_step())
    got["loss"] = r.train_steps(1)["loss"]
    got["state_digest"] = r.state_digest()
    rs.close()
    return got


def train_and_restore(rank, world, store, jax_store, steps, moe_in):
    """(2, 2): ``steps`` steps, a base snapshot after the second to last
    and a link after the last (rank 0 commits them, then writes
    ``<store>/READY``), one more step; then the checkpoint restored onto
    (2, 2) again and stepped once, and — once the test process has
    written ``<jax_store>/READY`` — the JAX package's checkpoint restored
    onto (2, 2)."""
    from repro_torch.api import CheckpointSession, Policy
    from repro_torch.train.loop import Trainer, TrainJob
    _f32()
    sess = CheckpointSession(f"localfs:{store}", Policy(chain=2)) \
        if rank == 0 else None
    t = Trainer(TrainJob(ARCH, SHAPE), (2, 2), AXES,
                manager=sess and sess.manager, device="cpu")
    t.init_state()
    losses = []
    for i in range(steps):
        losses.append(t.train_steps(1)["loss"])
        if i >= steps - 2:
            t.save(block=True)
    if sess is not None:
        sess.close()
        open(os.path.join(store, "READY"), "w").close()
    out = dict(losses=losses, params=_whole(t.upper.get("params")),
               digest=t.params_digest(), step=t.checkpoint_step(),
               plan=t.plan,
               checkpoint_state=t.checkpoint_state() is not None)
    out["next_loss"] = t.train_steps(1)["loss"]
    out["state_digest"] = t.state_digest()
    del t
    out["restores"] = {(2, 2): _restore_and_step(store, (2, 2))}
    _wait_for(os.path.join(jax_store, "READY"))
    r, rs = _restore(jax_store, (2, 2))
    out["jax_restore"] = dict(digest=r.params_digest(),
                              step=r.checkpoint_step(),
                              loss=r.train_steps(1)["loss"])
    rs.close()
    out["moe"] = moe_layer(rank, world, moe_in)
    out["stats"] = _stats()
    return out


def _stats():
    from repro_torch.parallel import collectives
    return {k: dict(v) for k, v in collectives.STATS.items()}


def gather_cases(rank, world):
    """``collectives.gather_to`` of one [8, 12] tensor under placements
    on a (2, 2) mesh: {name: the whole on rank 0, None elsewhere}."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.collectives import gather_to
    from repro_torch.parallel.sharding import shard_tensor
    mesh = make_mesh((2, 2), AXES, "cpu")
    full = torch.arange(96, dtype=torch.float32).reshape(8, 12)
    cases = {"rows_cols": (Shard(0), Shard(1)),
             "cols_rows": (Shard(1), Shard(0)),
             "rows_twice": (Shard(0), Shard(0)),
             "replicated_cols": (Replicate(), Shard(1)),
             "replicated": (Replicate(), Replicate())}
    out = {}
    for name, places in cases.items():
        got = gather_to(shard_tensor(full, mesh, places), 0)
        out[name] = None if got is None else got.numpy()
    return out


def steps_on(rank, world, shapes, steps):
    """``steps`` steps from the seed on each mesh of ``shapes``: the
    losses and the params gathered whole."""
    from repro_torch.train.loop import Trainer, TrainJob
    _f32()
    out = {}
    for shape in shapes:
        t = Trainer(TrainJob(ARCH, SHAPE), shape, AXES, device="cpu")
        t.init_state()
        t0 = time.monotonic()
        losses = [t.train_steps(1)["loss"] for _ in range(steps)]
        out[shape] = dict(losses=losses, params=_whole(t.upper.get("params")),
                          seconds=time.monotonic() - t0)
    return out


def moe_layer(rank, world, moe_in):
    """The expert-parallel MoE layer of ``moe_in`` on a (2, 2) mesh: its
    output and aux loss gathered whole."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import registry as treg
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.models.moe import moe_template
    from repro_torch.parallel import context as pctx
    from repro_torch.parallel.planner import make_plan
    from repro_torch.parallel.sharding import (leaf_placements,
                                               placements_for, shard_tensor)
    from repro_torch.tree import tree_from_paths
    _f32()
    cfg = treg.resolve_config(MOE_ARCH).replace(capacity_factor=16.0)
    mesh = make_mesh((2, 2), AXES, "cpu")
    plan = make_plan(cfg, treg.get_shape(SHAPE), mesh)
    places = leaf_placements(plan, moe_template(cfg), mesh)
    p = tree_from_paths({
        path: shard_tensor(torch.from_numpy(v), mesh, places[path])
        for path, v in moe_in["params"].items()})
    x = distribute_tensor(torch.from_numpy(moe_in["x"]), mesh,
                          placements_for(("data",), mesh),
                          src_data_rank=None)
    with pctx.mesh_context(mesh, plan.batch_axes, plan.model_axis):
        y, aux = MOE.moe_forward(cfg, p, x)
    return dict(y=y.full_tensor().numpy(), aux=float(aux.full_tensor()),
                local_experts=p["w_gate"].to_local().shape[0])


def compress_and_pipeline(rank, world, ef_in, pipe_in):
    """``compressed_psum`` of this rank's row of ``ef_in["g"]`` over the
    world; ``pipeline_forward`` of ``pipe_in`` over all ranks as
    stages."""
    from repro_torch.optim.compression import (compressed_psum,
                                               init_error_feedback)
    from repro_torch.parallel.pipeline import pipeline_forward
    g = torch.from_numpy(ef_in["g"][rank])
    red, ef = compressed_psum({"w": g}, init_error_feedback({"w": g}))
    W = torch.from_numpy(pipe_in["W"])
    X = torch.from_numpy(pipe_in["X"])
    return dict(compress=dict(red=red["w"].numpy(), ef=ef["w"].numpy()),
                pipeline=pipeline_forward(
                    lambda q, h: torch.tanh(h @ q["w"]), {"w": W},
                    X).numpy())


def others(rank, world, shapes, steps, store, ef_in, pipe_in):
    """``steps_on`` the meshes of ``shapes``, ``compress_and_pipeline``;
    then, once ``train_and_restore`` has committed its checkpoint, that
    checkpoint restored onto each of ``shapes`` and stepped once."""
    out = dict(steps=steps_on(rank, world, shapes, steps),
               gather=gather_cases(rank, world),
               gather_want=np.arange(96, dtype=np.float32).reshape(8, 12),
               **compress_and_pipeline(rank, world, ef_in, pipe_in))
    _wait_for(os.path.join(store, "READY"))
    out["restores"] = {shape: _restore_and_step(store, shape)
                       for shape in shapes}
    out["stats"] = _stats()
    return out
