"""Trainer: split-state C/R around the training loop — the port of
``repro.train.loop``.

Normal operation:  every runtime-mutating call (device, step function,
data advance, schedule touch) goes through the logged LowerHalf API;
semantic state (params, optimizer moments, step, data cursor) lives in
the UpperHalf, which a ``CheckpointSession`` snapshots in the
background.

Restore:           the "train" binder below = fresh LowerHalf + op-log
replay (rebuilds the step function, reapplies schedule/data ops) + the
upper half rebound onto the replayed device. Continuation is
bit-identical to the uninterrupted run — the step is deterministic (the
flash and SSD kernels use no atomics), so the same state gives the same
bits.

The trainer runs on the CUDA card unless the caller passes
``device="cpu"``: on one device for a mesh of one, else on a
``DeviceMesh`` of ``mesh_shape`` over the process group's ranks (one
rank a device; ``launch.mesh.spawn_ranks`` starts them). Its params and
moments are updated in place by every step (``optim.apply_updates``);
the snapshot pipeline keys its identity skip on tensor version
counters, so in-place updates are always seen.

Over a mesh every rank builds the same trainer: the params and moments
are DTensors with the plan's placements, each rank drawing every leaf
from the seed and keeping its block; the data stream is the mesh's
business nowhere (every rank reads the full batch; the step splits it).
A snapshot is collective: each leaf's shards are gathered, one leaf at
a time, onto rank 0 alone (``collectives.gather_to``; the other ranks
write their blocks to the staging area and wait), and rank 0 hands the
whole state to its manager — the capture kernels, encode and commit
then run as they do for one device, so the manifest's leaves and blobs
are those of a one-device trainer holding the same values. Rank 0's
device holds that whole copy until the capture has staged it
(``planner.card_plan`` counts it). The digests hash the leaves gathered
the same way, one at a time, so they compare across meshes and across
packages.
"""
from __future__ import annotations

import hashlib
import json
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.api import register_app_kind
from repro_torch.api.app import RestoreContext
from repro_torch.api.errors import RestoreError
from repro_torch.configs import registry as cfg_registry
from repro_torch.core.oplog import OpLog
from repro_torch.core.split_state import LowerHalf, UpperHalf
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.host import host_array, resolve_device
from repro_torch.launch.mesh import is_device_mesh, make_mesh, mesh_device
from repro_torch.models import model as M
from repro_torch.optim import (abstract_opt_state, init_opt_state,
                               opt_logical_specs)
from repro_torch.parallel.collectives import gather_to
from repro_torch.parallel.sharding import leaf_placements, shard_tensor
from repro_torch.train import step as step_lib
from repro_torch.tree import flatten_with_paths, tree_map


@dataclass
class TrainJob:
    arch: str                  # registry id, or "<id>-smoke"
    shape_key: str
    init_seed: int = 0
    data_seed: int = 1234
    plan_overrides: Optional[Dict[str, Any]] = None

    @property
    def plan_key(self) -> str:
        return json.dumps(self.plan_overrides) if self.plan_overrides else ""


class Trainer:
    def __init__(self, job: TrainJob, mesh_shape=(1, 1),
                 mesh_axes=("data", "model"), manager=None, *,
                 device=None, _restored=None):
        self.job = job
        self.cfg = cfg_registry.resolve_config(job.arch)
        self.shape = cfg_registry.get_shape(job.shape_key)
        self.manager = manager

        if _restored is None:
            dev = resolve_device(device)
            if int(np.prod(mesh_shape)) == 1:
                factory = lambda: dev
            else:
                factory = lambda: make_mesh(mesh_shape, mesh_axes, dev)
            self.lower = LowerHalf(mesh_factory=factory)
            self.lower.mesh_create(mesh_shape, mesh_axes)
            self.vexec = self.lower.compile_step(
                "train_step", job.arch, job.shape_key, job.plan_key)
        else:
            self.lower, self.vexec = _restored
        self.mesh = self.lower.mesh
        self.device = mesh_device(self.mesh)
        self.on_mesh = is_device_mesh(self.mesh)

        self.plan = step_lib.plan_from_key(self.cfg, self.shape, self.mesh,
                                           job.plan_key)
        self.opt_cfg = step_lib.default_opt_config(self.cfg)

        # n_shards is a DATA-layout constant (one shard per batch row),
        # never a topology property: batches are bit-identical across
        # device counts, so a restore never changes the data stream
        dcfg = DataConfig(
            seed=job.data_seed, vocab_size=self.cfg.vocab_size,
            seq_len=self.shape.seq_len, global_batch=self.shape.global_batch,
            n_shards=self.shape.global_batch,
            frames=self.cfg.encoder_seq if self.cfg.is_encoder_decoder else 0,
            frame_dim=self.cfg.frontend_dim)
        self.pipeline = TokenPipeline(dcfg)
        if self.lower.data_assignment:
            self.pipeline.reassign(self.lower.data_assignment)
        self.upper = UpperHalf()

    # --- state construction ---------------------------------------------

    def init_state(self) -> None:
        """Fresh start: seeded params and zero moments on the device,
        registered in the upper half."""
        logical = M.logical_specs(self.cfg)
        leaf_fn = None
        if self.on_mesh:
            places = leaf_placements(self.plan, M.param_template(self.cfg),
                                     self.mesh)

            def leaf_fn(path, t):
                return shard_tensor(t, self.mesh, places[path])
        params = M.init_params(self.cfg, seed=self.job.init_seed,
                               device=self.device, leaf_fn=leaf_fn)
        opt_state = init_opt_state(params, self.opt_cfg)
        self.upper.register("params", "params", params, logical)
        self.upper.register("opt_state", "opt_state", opt_state,
                            opt_logical_specs(logical, self.opt_cfg))
        self.upper.register("step", "step", np.int64(0))
        self.upper.register("data_cursor", "data_cursor", np.int64(0))
        self.upper.register("rng_seed", "rng", np.int64(self.job.init_seed))

    # --- stepping ----------------------------------------------------------

    def _device_batch(self, batch_np: Dict[str, np.ndarray]):
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch_np.items()}

    def train_steps(self, n: int) -> Dict[str, float]:
        fn = self.lower.executable(self.vexec)
        params = self.upper.get("params")
        opt_state = self.upper.get("opt_state")
        step = int(self.upper.get("step"))
        cursor = int(self.upper.get("data_cursor"))
        lr_scale = torch.tensor(
            self.lower.schedule_overrides.get("lr_scale", 1.0),
            dtype=torch.float32)
        metrics: Dict[str, Any] = {}
        for _ in range(n):
            batch = self._device_batch(self.pipeline.batch_at(cursor))
            params, opt_state, metrics = fn(params, opt_state, batch, step,
                                            lr_scale)
            step += 1
            cursor += 1
            self.lower.data_advance(1)
        self.upper.update("params", params)
        self.upper.update("opt_state", opt_state)
        self.upper.update("step", np.int64(step))
        self.upper.update("data_cursor", np.int64(cursor))
        return {k: float(v) for k, v in metrics.items()}

    # --- CheckpointableApp protocol (repro_torch.api) ----------------------

    def checkpoint_state(self) -> Optional[UpperHalf]:
        """The upper half; over a mesh (collective: every rank calls it)
        rank 0's copy whose DTensor leaves are gathered whole, leaf by
        leaf, and None on the other ranks."""
        if not self.on_mesh:
            return self.upper
        out = UpperHalf() if self._writes() else None
        for name, e in self.upper.items():
            tree = tree_map(lambda v: gather_to(v, 0), e.tree)
            if out is not None:
                out.register(name, e.kind, tree, e.logical)
        return out

    def _writes(self) -> bool:
        """Whether this rank commits snapshots: rank 0 of a mesh."""
        return not self.on_mesh or torch.distributed.get_rank() == 0

    def checkpoint_step(self) -> int:
        return int(self.upper.get("step"))

    def runtime_log(self) -> OpLog:
        return self.lower.oplog

    def job_meta(self) -> Dict[str, Any]:
        return {"kind": "train",
                "arch": self.job.arch, "shape_key": self.job.shape_key,
                "plan_key": self.job.plan_key,
                "init_seed": self.job.init_seed,
                "data_seed": self.job.data_seed}

    def bind(self, restore: RestoreContext) -> None:
        """Rebind the upper half onto this incarnation's device from a
        materialized, replayed restore context (the "train" binder
        orders the phases). Under a streaming restore ``opt_state`` is
        the cold tier: ``inc.bind`` waits for it as one promoted batch
        after the params have bound (``core.restore.materialize_entry``),
        and nothing reads the moments before that."""
        inc = restore.incarnation()
        ab_params = M.init_abstract(self.cfg)
        logical = M.logical_specs(self.cfg)
        olog = opt_logical_specs(logical, self.opt_cfg)
        params = inc.bind("params", ab_params, plan=self.plan,
                          logical=logical)
        opt_state = inc.bind("opt_state",
                             abstract_opt_state(ab_params, self.opt_cfg),
                             plan=self.plan, logical=olog)
        self.upper.register("params", "params", params, logical)
        self.upper.register("opt_state", "opt_state", opt_state, olog)
        self.upper.register("step", "step", np.int64(inc.scalar("step")))
        self.upper.register("data_cursor", "data_cursor",
                            np.int64(inc.scalar("data_cursor")))
        self.upper.register("rng_seed", "rng",
                            np.int64(inc.scalar("rng_seed")))
        inc.release()   # host payload rebound on the device; don't hold
        self.incarnation = inc  # the checkpoint's RAM for the whole run

    # --- checkpoint ----------------------------------------------------------

    def save(self, block: bool = True) -> None:
        state = self.checkpoint_state()
        if self._writes():
            assert self.manager is not None
            self.manager.save(self.checkpoint_step(), state,
                              self.runtime_log(), block=block,
                              job_meta=self.job_meta())

    def snapshot(self):
        """Non-blocking checkpoint at the current step boundary: pays
        only the device->staging capture; encode and writes overlap the
        next steps. Returns the SnapshotHandle (None if dropped under
        "skip" backpressure). The trainer holds no session of its own:
        one session owns an app's lifecycle, and it is the caller's."""
        state = self.checkpoint_state()
        if not self._writes():
            return None
        assert self.manager is not None
        return self.manager.save(self.checkpoint_step(), state,
                                 self.runtime_log(), block=False,
                                 job_meta=self.job_meta())

    def apply_reassignment(self, assignment) -> None:
        """Move data-shard ownership between hosts as one logged op (a
        restart replays it); batch contents are unchanged."""
        self.lower.data_reassign(assignment)
        self.pipeline.reassign(list(map(tuple, assignment)))

    def train(self, n_steps: int, snapshot_every: Optional[int] = None,
              ) -> Dict[str, float]:
        """Step loop with overlapped snapshots at step boundaries."""
        metrics: Dict[str, float] = {}
        for i in range(1, n_steps + 1):
            metrics = self.train_steps(1)
            if snapshot_every and self.manager is not None \
                    and i % snapshot_every == 0:
                self.snapshot()
        if self.manager is not None and snapshot_every and self._writes():
            self.manager.wait()
        return metrics

    @classmethod
    def restore(cls, manager, mesh_factory=None, step=None, device=None,
                **kw) -> "Trainer":
        """Restore through the public session API
        (``CheckpointSession.restore``), onto ``mesh_factory()``'s mesh or
        device where given (elastic: any mesh reads any checkpoint),
        else onto ``device`` (default: the card)."""
        from repro_torch.api.session import CheckpointSession
        extra = {} if mesh_factory is not None else {"device": device}
        return CheckpointSession.from_manager(manager).restore(
            step=step, expect_kind="train", mesh_factory=mesh_factory,
            **extra, **kw)

    # --- observability ---------------------------------------------------------

    def params_digest(self) -> str:
        """blake2b over the params' paths and bytes (the JAX package's
        digest; bfloat16 hashed as its bits). Over a mesh, collective:
        each leaf gathered onto rank 0 in turn and hashed there, every
        rank returns rank 0's digest."""
        leaves = sorted(flatten_with_paths(self.upper.get("params")),
                        key=lambda pv: pv[0])
        h = hashlib.blake2b(digest_size=16)
        for path, arr in leaves:
            whole = gather_to(arr, 0) if self.on_mesh else arr
            if whole is not None:
                h.update(path.encode())
                h.update(np.ascontiguousarray(host_array(whole)).tobytes())
        return self._from_rank0(h.hexdigest())

    def _from_rank0(self, value: str) -> str:
        """``value`` as rank 0 of the mesh has it (one device: itself)."""
        if not self.on_mesh:
            return value
        box = [value]
        torch.distributed.broadcast_object_list(box, src=0)
        return box[0]

    def state_digest(self, workers: int = 8) -> str:
        """The complete semantic state — params, optimizer moments and
        count, step and data cursor — as one digest: blake2b over each
        leaf's path and the blake2b of its bytes, leaves hashed in
        parallel (hashlib releases the GIL on large buffers). Over a
        mesh, collective, as ``params_digest``."""
        leaves = [(f"['{e}']{p}", v) for e in ("params", "opt_state")
                  for p, v in flatten_with_paths(self.upper.get(e))]

        def leaf_hash(v) -> bytes:
            return hashlib.blake2b(np.ascontiguousarray(
                host_array(v)).tobytes(), digest_size=16).digest()

        # one leaf at a time (collective on a mesh): rank 0 gathers a
        # leaf and hands its host copy to the pool while the next gathers
        hashes: List[Any] = []
        with ThreadPoolExecutor(max_workers=workers) as ex:
            for _, v in leaves:
                whole = gather_to(v, 0) if self.on_mesh else v
                if whole is not None:
                    hashes.append(ex.submit(leaf_hash, host_array(whole)))
                    del whole
        if not self._writes():
            return self._from_rank0("")
        h = hashlib.blake2b(digest_size=16)
        for (path, _), lh in zip(leaves, hashes):
            h.update(path.encode())
            h.update(lh.result())
        h.update(str(int(self.upper.get("step"))).encode())
        h.update(str(int(self.upper.get("data_cursor"))).encode())
        return self._from_rank0(h.hexdigest())



@register_app_kind("train")
def _restore_trainer(restore: RestoreContext, device=None) -> Trainer:
    """The "train" restore binder: materialize the delta chain, fresh
    lower half + op-log replay (rebuild the step, reapply runtime ops),
    then ``Trainer.bind`` rebinds the upper half on the replayed device
    (``device``, default: the card)."""
    dev = None if restore.mesh_factory is not None \
        else resolve_device(device)
    inc = restore.incarnation(
        mesh_factory=restore.mesh_factory or (lambda: dev))
    inc.materialize()
    jm = restore.job
    job = TrainJob(arch=jm["arch"], shape_key=jm["shape_key"],
                   init_seed=jm.get("init_seed", 0),
                   data_seed=jm.get("data_seed", 1234),
                   plan_overrides=json.loads(jm["plan_key"])
                   if jm.get("plan_key") else None)
    lower = inc.build_lower()
    vexec = inc.last_compile("train_step")
    if vexec is None:
        raise RestoreError("no train_step Compile in the checkpoint's "
                           "op-log; cannot rebuild the step")
    t = Trainer(job, manager=restore.manager, _restored=(lower, vexec))
    t.bind(restore)
    return t
