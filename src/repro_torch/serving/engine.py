"""Serving: a continuous-batching engine whose live sessions are
checkpointable — the port of ``repro.serving.engine``.

The decode step is registered in the C/R function registry, so a
serving process restores through one ``core.incarnation.Incarnation``:
fresh lower half, replay binds the device, the decode step function and
a fresh (empty) cache, then the *complete* session state rebinds: cache
contents, request queue, per-slot in-flight requests (prompt, generated
tokens, budget), slot positions and pending tokens. This is the paper's
§IV demo — the artist reopens Maya and the scene is still there — for
inference sessions.

Restore is *elastic* in the serving dimension: a checkpoint taken on an
N-slot engine lands on an M-slot engine (re-slotting). Each former
in-flight session keeps its checkpointed decode state — its column of
the cache — which lands in whichever new slot admits it, so it decodes
on from the bits it stopped at; a column still waiting for a slot is
part of the session state a snapshot takes. (The JAX engine instead
rebuilds it by prefilling the full token history, which comes close to
the column the decode steps wrote but not always to its bits, ROADMAP
C23.) The carried session then decodes the uninterrupted run's tokens
wherever a decode row's bits do not depend on how many rows share the
step: on an H100 that was shown at 2 to 4 slots, not at 1 (C23). A
request that never held a slot is admitted from its prompt: through a batch-1 prefill for the decoder-only
attention families, through batch-1 decode steps for the recurrent ones
(ssm, hybrid), whose state padding would corrupt, and for the
encoder-decoder, as the JAX engine does: it never runs the encoder, so
its cross-attention cache stays at its zero init (ROADMAP C21).

The engine runs on one device — the CUDA card unless the caller passes
``device="cpu"`` — or over a ``DeviceMesh`` (``create(mesh_shape=...)``
in every rank ``launch.mesh.spawn_ranks`` starts, or a restore through a
``mesh_factory``), for the dense and moe decoders. Its KV cache is
updated in place by every decode step and admission
(``models.layers``), never reallocated.

Over a mesh every rank builds the same engine and keeps the same host
bookkeeping (slots, positions, pending tokens, queue). The params are
DTensors with the serving plan's placements (``parallel.planner``,
placed here from whole tensors where the caller holds them), the cache
DTensors with ``serving.kv_cache.cache_shardings``' (each rank allocates
its own block), and the steps are plain callables bound to the plan and
the mesh context (``sharded_prefill``, ``sharded_decode_step``): a
decode's slots split over the data axes where they divide, a batch-1
admission prefill replicated over them;
attention runs on each rank's heads or cache block; the vocab-parallel
logits are gathered whole before the argmax, so every rank picks the
same token. An admitted or carried column lands only in the data rank
that owns its slot, a restored cache as each rank's block
(``parallel.sharding.local_shard``). A snapshot or a cache digest
gathers the cache onto the mesh's lead rank one leaf at a time
(``collectives.gather_to``); the lead alone holds the session and
commits, so the manifest's leaves are a one-device engine's. The mesh
may be part of the world (a supervised shrink restores onto the
survivors' ranks): its ranks alone hold the engine. A live move reads
each chosen slot's column whole onto the lead (``session_columns``).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.api import register_app_kind
from repro_torch.api.app import RestoreContext
from repro_torch.api.errors import MigrationError, RestoreError
from repro_torch.configs import registry as cfg_registry
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.oplog import CacheAlloc, Compile, OpLog
from repro_torch.core.split_state import (LowerHalf, UpperHalf,
                                          register_step_fn)
from repro_torch.host import host_array, resolve_device, to_tensor
from repro_torch.launch.mesh import (is_device_mesh, lead_rank, make_mesh,
                                     mesh_device, mesh_group)
from repro_torch.models import model as M
from repro_torch.models.layers import is_dtensor, local_of
from repro_torch.parallel import context as pctx
from repro_torch.parallel.collectives import gather_block, gather_to
from repro_torch.parallel.planner import make_plan
from repro_torch.parallel.sharding import (ParallelPlan, axis_sizes,
                                           block_narrows, leaf_placements,
                                           local_shard, shard_tensor)
from repro_torch.serving.kv_cache import abstract_cache, sharded_cache
from repro_torch.tree import (fill_like, flatten_with_paths,
                               tree_from_paths, tree_map)


def _resolve_cfg(arch: str) -> ModelConfig:
    return cfg_registry.resolve_config(arch)


# ---------------------------------------------------------------------------
# serving steps over a mesh (the reference's jit_prefill / jit_decode_step)
# ---------------------------------------------------------------------------

def serve_param_placements(cfg: ModelConfig, plan: ParallelPlan, mesh):
    """{param path: DTensor placements} under the serving ``plan``."""
    return leaf_placements(plan, M.param_template(cfg), mesh)


def place_params(cfg: ModelConfig, params, plan: ParallelPlan, mesh):
    """``params`` as DTensors with the serving plan's placements on
    ``mesh``: a whole tensor (on any device; the same on every rank) is
    cut to this rank's block on the mesh's device, a DTensor of ``mesh``
    is resharded where its placements differ."""
    places = serve_param_placements(cfg, plan, mesh)
    dev = mesh_device(mesh)

    def one(path, t):
        if not is_dtensor(t):
            return shard_tensor(t, mesh, places[path], dev)
        if t.device_mesh != mesh:
            raise ValueError(f"{path} lives on another mesh; pass whole "
                             "params or DTensors of the engine's mesh")
        return t if tuple(t.placements) == tuple(places[path]) \
            else t.redistribute(mesh, places[path])
    return fill_like(params, {p: one(p, t)
                              for p, t in flatten_with_paths(params)})


def _data_size(plan: ParallelPlan, mesh) -> int:
    sizes = axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in plan.batch_axes]))


@dataclass(frozen=True)
class ShardedStep:
    """A serving step bound to a serving plan and a mesh: the counterpart
    of the reference's jitted steps (there is no jit). The tokens come
    whole on every rank and split over the data axes where the batch
    divides them (else every data rank takes them all, as a batch-1
    admission prefill does); the residual stream keeps that split with
    its model axis whole; the step runs under the mesh context and
    returns the vocab-parallel logits gathered whole [B, V] on every
    rank, and the cache written in place."""
    cfg: ModelConfig
    mesh: Any
    plan: ParallelPlan

    def _run(self, tokens, step):
        """``step(tokens as a DTensor, CallOptions)`` under the mesh
        context, its logits gathered whole."""
        from torch.distributed.tensor import Replicate, Shard, \
            distribute_tensor
        n = _data_size(self.plan, self.mesh)
        # a data axis of one replicates: DTensor refuses to reshape a dim
        # sharded even over one rank
        rows = Shard(0) if n > 1 and tokens.shape[0] % n == 0 \
            else Replicate()
        with pctx.mesh_context(self.mesh, self.plan.batch_axes,
                               self.plan.model_axis) as ctx:
            act = ctx.placements(rows, Replicate())
            opts = M.CallOptions(act_constraint=lambda x: x.redistribute(
                self.mesh, act))
            logits, cache = step(distribute_tensor(
                tokens, self.mesh, act, src_data_rank=None), opts)
            return logits.full_tensor(), cache


class ShardedPrefill(ShardedStep):
    """(params, tokens [B, S], cache) -> (logits, cache)"""

    def __call__(self, params, tokens, cache):
        return self._run(tokens, lambda toks, opts: M.prefill(
            self.cfg, params, toks, cache, opts=opts))


class ShardedDecode(ShardedStep):
    """(params, cache, tokens [B, 1], pos [B]) -> (logits, cache)"""

    def __call__(self, params, cache, tokens, pos):
        return self._run(tokens, lambda toks, opts: M.decode_step(
            self.cfg, params, cache, toks, pos, opts))


def sharded_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    plan: Optional[ParallelPlan] = None) -> ShardedPrefill:
    """The prefill step over ``mesh`` under ``plan`` (default: the
    serving plan of ``shape``)."""
    return ShardedPrefill(cfg, mesh, plan or make_plan(cfg, shape, mesh))


def sharded_decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                        plan: Optional[ParallelPlan] = None) -> ShardedDecode:
    """The decode step over ``mesh`` under ``plan`` (default: the
    serving plan of ``shape``)."""
    return ShardedDecode(cfg, mesh, plan or make_plan(cfg, shape, mesh))


def serve_input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Meta-device stand-ins for a serving step's inputs."""
    b = shape.global_batch

    def meta(s):
        return torch.empty(s.shape, dtype=s.dtype, device="meta")
    if shape.kind == "prefill":
        specs = {"tokens": torch.empty((b, shape.seq_len), dtype=torch.int32,
                                       device="meta"),
                 "cache": tree_map(meta, abstract_cache(cfg, b,
                                                        shape.seq_len))}
        if cfg.is_encoder_decoder:
            specs["frames"] = torch.empty(
                (b, cfg.encoder_seq, cfg.frontend_dim), dtype=torch.float32,
                device="meta")
        return specs
    return {"tokens": torch.empty((b, 1), dtype=torch.int32, device="meta"),
            "pos": torch.empty((b,), dtype=torch.int32, device="meta"),
            "cache": tree_map(meta, abstract_cache(cfg, b, shape.seq_len))}


def _no_plan_override(plan_key: str) -> None:
    """Over a mesh the cache a logged ``CacheAlloc`` allocates takes the
    serving plan ``make_plan`` gives, so a step may not take another."""
    if plan_key:
        raise ValueError(f"a serving step over a mesh takes the serving "
                         f"plan of its shape, not {plan_key!r}: the "
                         "cache's layout follows that plan")


@register_step_fn("prefill_step")
def _build_prefill(arch, shape_key, plan_key, lower):
    """The prefill step function a logged ``Compile`` binds: on one
    device the model's eager ``prefill`` for the arch — (params, tokens,
    cache) -> (last logits, cache filled in place); over a mesh
    ``sharded_prefill``'s."""
    cfg = _resolve_cfg(arch)
    if not is_device_mesh(lower.mesh):
        return functools.partial(M.prefill, cfg)
    _no_plan_override(plan_key)
    return sharded_prefill(cfg, cfg_registry.get_shape(shape_key),
                           lower.mesh)


@register_step_fn("decode_step")
def _build_decode(arch, shape_key, plan_key, lower):
    """The decode step function a logged ``Compile`` binds: on one
    device the model's eager ``decode_step`` for the arch — (params,
    cache, tokens, pos); over a mesh ``sharded_decode_step``'s."""
    cfg = _resolve_cfg(arch)
    if not is_device_mesh(lower.mesh):
        return functools.partial(M.decode_step, cfg)
    _no_plan_override(plan_key)
    return sharded_decode_step(cfg, cfg_registry.get_shape(shape_key),
                               lower.mesh)


# ---------------------------------------------------------------------------
# continuous batching engine (host-side scheduler)
# ---------------------------------------------------------------------------

@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [P] int32
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False


def _request_tree(r: Request) -> Dict[str, np.ndarray]:
    """A Request as a checkpointable tree of arrays."""
    return {"rid": np.int64(r.rid), "max_new": np.int64(r.max_new),
            "prompt": np.asarray(r.prompt, np.int32),
            "out": np.asarray(r.out, np.int32)}


def _request_from_tree(t: Dict[str, Any]) -> Request:
    return Request(rid=int(t["rid"]), max_new=int(t["max_new"]),
                   prompt=np.asarray(t["prompt"], np.int32),
                   out=[int(x) for x in np.asarray(t["out"]).ravel()])


def _by_rid(by_path) -> Dict[int, Dict[str, Any]]:
    """A "carried" entry's {path: leaf} split into {rid: {the column's
    cache path: leaf}}."""
    out: Dict[int, Dict[str, Any]] = {}
    for p, v in by_path.items():
        m = re.match(r"\['(-?\d+)'\]", p)
        out.setdefault(int(m.group(1)), {})[p[m.end():]] = v
    return out


def _reslot_rewriter(n_old: int, n_new: int) -> Callable:
    """Op-log rewrite for elastic re-slotting: the logged CacheAlloc and
    decode Compile carry the old slot count; replay them at the new one
    (same virtual ids — the vid/handle indirection is what makes the
    rewrite invisible to everything above the table)."""
    def rewrite(op):
        if isinstance(op, CacheAlloc) and op.batch == n_old:
            return dataclasses.replace(op, batch=n_new)
        if isinstance(op, Compile) and op.fn_name == "decode_step":
            return dataclasses.replace(op, shape_key=re.sub(
                rf"_b{n_old}$", f"_b{n_new}", op.shape_key))
        return op
    return rewrite


def _on(t: torch.Tensor, device: torch.device) -> bool:
    return t.device.type == device.type and (
        device.index is None or t.device.index in (None, device.index))


class ServingEngine:
    """Slot-based continuous batching over fixed-shape decode steps.

    Decode always runs the full slot batch; finished slots are refilled
    from the queue between steps. Admission lands a re-slotted session's
    carried cache column in its slot; any other request has its slot's
    decode state rebuilt from its full token history — prompt plus any
    tokens already generated, so a request resumed from a checkpoint
    re-enters mid-generation — through a batch-1 prefill of the history,
    right-padded into a power-of-two bucket (decoder-only attention
    families), or a batch-1 decode replay of it (recurrent families,
    where the pad tokens would advance the state, and the
    encoder-decoder).
    """

    def __init__(self, cfg: ModelConfig, params, device, n_slots: int,
                 max_seq: int, manager=None, lower=None,
                 arch: Optional[str] = None,
                 _adopt: Optional[Dict[str, Any]] = None):
        """``device``: one device, or a ``DeviceMesh`` to serve over (the
        params are then placed by the serving plan)."""
        self.cfg = cfg
        self.mesh = device if is_device_mesh(device) else None
        self.device = mesh_device(device)
        self.plan = None
        self._admit_prefill = None
        if self.mesh is not None:
            shape = ShapeConfig("engine", max_seq, n_slots, "decode")
            self.plan = getattr((_adopt or {}).get("decode"), "plan",
                                None) or make_plan(cfg, shape, self.mesh)
            params = place_params(cfg, params, self.plan, self.mesh)
            self._admit_prefill = sharded_prefill(
                cfg, ShapeConfig("admit", max_seq, 1, "prefill"), self.mesh,
                self.plan)
        elif not _on(params["tok_emb"], self.device):
            raise ValueError(f"params live on {params['tok_emb'].device}, "
                             f"the engine on {self.device}; move them first")
        self.params = params
        self.arch = arch
        if _adopt is not None:
            # runtime resources already exist (built or replayed through
            # the logged lower half) — adopt instead of re-creating
            self.decode = _adopt["decode"]
            self.cache = _adopt["cache"]
            self.vexec = _adopt.get("vexec")
            self.vcache = _adopt.get("vcache")
        elif self.mesh is not None:
            self.decode = sharded_decode_step(cfg, shape, self.mesh,
                                              self.plan)
            self.cache = self._new_cache(n_slots, max_seq)
            self.vexec = self.vcache = None
        else:
            self.decode = functools.partial(M.decode_step, cfg)
            self.cache = M.init_cache(cfg, n_slots, max_seq, self.device)
            self.vexec = self.vcache = None
        # the last decode step's logits [n_slots, V], whole on every rank
        self.last_logits: Optional[torch.Tensor] = None
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int32)
        self.slot_tok = np.zeros((n_slots, 1), np.int32)
        self.queue: List[Request] = []
        self.steps = 0
        # streaming restore: the checkpointed KV cache still decoding in
        # the background (LazyLeaves), and the slots admission filled
        # while it was in flight — see _ensure_cache()
        self._pending_cache = None
        self._touched_slots: set = set()
        # re-slot restore: each former in-flight request's checkpointed
        # cache column (batch 1, on the engine's device), by rid, until a
        # slot admits it; snapshotted as the "carried" entry
        self._carried: Dict[int, Any] = {}
        self._prefill_admission = (cfg.family not in ("ssm", "hybrid")
                                   and not cfg.is_encoder_decoder)
        # the axis of each cache leaf that holds the slot index
        self._batch_axes = M.batch_axes(cfg)
        # optional live-session checkpointing (core.async_snapshot):
        # manager drains snapshots in the background, lower's op-log (if
        # the engine was built through the logged runtime) rides along so
        # a restore can replay CacheAlloc/Compile. The engine does NOT
        # hold a CheckpointSession of its own — one session owns an
        # app's lifecycle, and that session is the caller's.
        self.manager = manager
        self.lower = lower

    @classmethod
    def create(cls, arch: str, params, mesh_shape=(1, 1),
               mesh_axes=("data", "model"), *, n_slots: int, max_seq: int,
               manager=None, device=None) -> "ServingEngine":
        """Build an engine through the logged C/R runtime: MeshCreate +
        decode Compile + CacheAlloc all flow through a LowerHalf, so a
        snapshot of this engine carries the op-log a restore replays.
        ``device`` defaults to the CUDA card; pass ``"cpu"`` to run on
        the CPU. A ``mesh_shape`` of more than one device serves over a
        ``DeviceMesh`` of the process group's ranks (every rank calls
        this; ``manager`` only on rank 0, which commits)."""
        dev = resolve_device(device)
        if int(np.prod(mesh_shape)) == 1:
            factory = lambda: dev
        else:
            factory = lambda: make_mesh(mesh_shape, mesh_axes, dev)
        lower = LowerHalf(mesh_factory=factory)
        lower.mesh_create(mesh_shape, mesh_axes)
        vexec = lower.compile_step("decode_step", arch,
                                   f"decode_s{max_seq}_b{n_slots}")
        vcache = lower.cache_alloc(arch, n_slots, max_seq)
        return cls(_resolve_cfg(arch), params, lower.mesh, n_slots=n_slots,
                   max_seq=max_seq, manager=manager, lower=lower, arch=arch,
                   _adopt={"decode": lower.executable(vexec),
                           "cache": lower.cache(vcache),
                           "vexec": vexec, "vcache": vcache})

    # --- live-session checkpointing ------------------------------------

    def session_state(self) -> UpperHalf:
        """The engine's *complete* semantic (upper-half) state: cache
        contents, slot bookkeeping (positions + pending tokens), every
        in-flight request (prompt, generated tokens, budget, identity),
        the waiting queue and the cache columns that re-slotted sessions
        in it carry (an entry only while one waits). Params are the
        trainer's job, not ours."""
        self._ensure_cache()   # never snapshot a half-paged-in cache
        cache = self.cache
        if self.mesh is not None:
            # collective: every rank gathers, the lead alone keeps them
            lead = lead_rank(self.mesh)
            cache = tree_map(lambda t: gather_to(t, lead), cache)
            if not self.commits():
                return None
        up = UpperHalf()
        up.register("kv_cache", "cache", cache)
        up.register("sessions", "sessions", {
            "slot_pos": np.array(self.slot_pos),
            "slot_tok": np.array(self.slot_tok),
        })
        sched: Dict[str, Dict[str, Any]] = {"queue": {}, "slots": {}}
        for i, r in enumerate(self.queue):
            sched["queue"][f"{i:06d}"] = _request_tree(r)
        for s, r in enumerate(self.slot_req):
            if r is not None:
                sched["slots"][f"{s:06d}"] = _request_tree(r)
        up.register("sched", "sched", sched)
        up.register("steps", "step", np.int64(self.steps))
        if self._carried:
            up.register("carried", "cache",
                        {str(rid): col for rid, col in self._carried.items()})
        return up

    def job_meta(self) -> Dict[str, Any]:
        return {"kind": "serving", "arch": self.arch,
                "n_slots": self.n_slots, "max_seq": self.max_seq}

    def commits(self) -> bool:
        """Whether this rank commits snapshots: a mesh's lead rank."""
        return self.mesh is None or \
            torch.distributed.get_rank() == lead_rank(self.mesh)

    def cache_digest(self) -> str:
        """blake2b over the cache's leaf paths and bytes (bfloat16 hashed
        as its bits), the same for a cache of one device and one of any
        mesh holding the same values. Over a mesh, collective: each leaf
        gathered onto the lead rank in turn, every rank of the mesh
        returns the lead's digest."""
        self._ensure_cache()
        h = hashlib.blake2b(digest_size=16)
        for path, t in sorted(flatten_with_paths(self.cache),
                              key=lambda pv: pv[0]):
            whole = t if self.mesh is None else \
                gather_to(t, lead_rank(self.mesh))
            if whole is not None:
                h.update(path.encode())
                h.update(np.ascontiguousarray(host_array(whole)).tobytes())
        if self.mesh is None:
            return h.hexdigest()
        box = [h.hexdigest()]
        torch.distributed.broadcast_object_list(
            box, src=lead_rank(self.mesh), group=mesh_group(self.mesh))
        return box[0]

    # --- CheckpointableApp protocol (repro_torch.api) ------------------

    def checkpoint_state(self) -> UpperHalf:
        # session_state() is the dynamic hook the session prefers; this
        # satisfies the protocol's required method with the same answer
        return self.session_state()

    def checkpoint_step(self) -> int:
        return self.steps

    def runtime_log(self) -> OpLog:
        return self.lower.oplog if self.lower is not None else OpLog()

    def snapshot(self, block: bool = False):
        """Snapshot of live sessions at an engine-step boundary;
        non-blocking by default — decode keeps running while the
        pipeline encodes and writes. Returns the SnapshotHandle (None
        when blocking, or if dropped under "skip" backpressure). Over a
        mesh every rank of it calls it (the cache is gathered onto the
        lead rank) and only the lead needs the manager; the others
        return None."""
        if self.manager is None and self.commits():
            raise RuntimeError("construct the engine with manager= to "
                               "snapshot it")
        state = self.session_state()
        if not self.commits():
            return None
        return self.manager.save(self.checkpoint_step(), state,
                                 self.runtime_log(), block=block,
                                 job_meta=self.job_meta())

    # --- restore (the Incarnation lifecycle, serving flavor) -----------

    def bind(self, restore: RestoreContext) -> None:
        """CheckpointableApp.bind: rebind the *complete* session state —
        cache contents, slot bookkeeping, in-flight requests, waiting
        queue, carried columns — from a materialized restore context. On
        a re-slot restore (this engine's slot count differs from the
        checkpoint's) every former in-flight session re-enters through
        admission with its checkpointed cache column, which lands in its
        new slot; the slot bookkeeping is rebuilt from the requests."""
        inc = restore.incarnation()
        reslot = self.n_slots != int(restore.job["n_slots"])
        self.steps = int(inc.scalar("steps")) if inc.has_entry("steps") \
            else 0

        sched = (tree_from_paths(inc.entry_paths("sched"))
                 if inc.has_entry("sched") else {})
        slot_reqs = [(int(k), _request_from_tree(v))
                     for k, v in sorted(sched.get("slots", {}).items())]
        queue_reqs = [_request_from_tree(v)
                      for _, v in sorted(sched.get("queue", {}).items())]
        self._carried = (self._columns_from(inc.entry_paths("carried"))
                         if inc.has_entry("carried") else {})

        if not reslot:
            kv = inc.entry_paths("kv_cache")
            if callable(getattr(kv, "wait", None)):
                # streaming restore: the KV cache is the cold tier.
                # Keep serving on the fresh cache — admission can fill
                # free slots while the checkpointed contents stream in —
                # and land the restored bytes just before the next
                # full-batch decode (_ensure_cache), the first moment
                # anything reads other slots' columns.
                self._pending_cache = kv
                self._touched_slots = set()
            else:
                tree_map(lambda t, v, ax: self._land(t, v, ax, ()),
                         self.cache, fill_like(self.cache, kv),
                         self._batch_axes)
            sess = tree_from_paths(inc.entry_paths("sessions"))
            self.slot_pos = np.asarray(sess["slot_pos"], np.int32).copy()
            self.slot_tok = np.asarray(
                sess["slot_tok"], np.int32).copy().reshape(self.n_slots, 1)
            for s, r in slot_reqs:
                self.slot_req[s] = r
            self.queue = queue_reqs
        else:
            # elastic re-slot: former in-flight sessions (slot order)
            # lead the queue, then the waiting requests; admission lands
            # each one's checkpointed column in its new slot. Sessions
            # beyond the new slot count wait their turn — nothing drops.
            # A streamed restore waits for the whole cache here.
            kv = inc.entry_paths("kv_cache")
            if callable(getattr(kv, "wait", None)):
                kv.wait()
            host = fill_like(self.cache, kv)
            for s, r in slot_reqs:
                self._carried[r.rid] = tree_map(
                    lambda v, t, ax, s=s: to_tensor(
                        np.take(np.asarray(v), [s], axis=ax), t.dtype,
                        t.device),
                    host, self.cache, self._batch_axes)
            self.queue = [r for _, r in slot_reqs] + queue_reqs
            self._admit()
        inc.release()   # every entry is rebound or rebuilt; drop the
        self.incarnation = inc  # host payload, keep timings + manifest

    def _columns_from(self, by_path) -> Dict[int, Any]:
        """A "carried" entry back as {rid: cache column on the engine's
        device}; its paths are the column's cache paths under ``[rid]``."""
        if callable(getattr(by_path, "wait", None)):
            by_path.wait()
        out: Dict[int, Any] = {}
        for rid, mine in _by_rid(by_path).items():
            col = fill_like(self.cache, mine)
            out[rid] = tree_map(
                lambda v, t: to_tensor(np.asarray(v), t.dtype, t.device),
                col, self.cache)
        return out

    def column_shapes(self) -> Dict[str, tuple]:
        """Each cache leaf's path and its shape with the batch axis 1:
        the shapes a carried column must have to land in this engine."""
        return {p: tuple(1 if i == ax else n for i, n in enumerate(t.shape))
                for (p, t), (_, ax) in zip(
                    flatten_with_paths(self.cache),
                    flatten_with_paths(self._batch_axes))}

    # --- live migration (core.migration) --------------------------------

    def session_columns(self, slots: Optional[List[int]] = None, *,
                        include_queue: bool = False) -> Dict[int, Any]:
        """The decode state a live move carries with its sessions: each
        chosen occupied slot's cache column (batch 1, a copy) by rid,
        and with ``include_queue`` the columns that queued re-slotted
        sessions still carry. Call it before ``extract_sessions`` frees
        the slots. (The JAX package's move carries no cache and
        re-prefills each history, which need not give the decode steps'
        bits, ROADMAP C23.) Over a mesh, collective: every rank of the
        mesh calls it, each column is gathered whole onto the lead rank
        (``_column``) and the other ranks return {}."""
        self._ensure_cache()
        chosen = range(self.n_slots) if slots is None else slots
        out: Dict[int, Any] = {}
        for s in chosen:
            r = self.slot_req[s]
            if r is not None:
                col = tree_map(lambda t, ax, s=s: self._column(t, ax, s),
                               self.cache, self._batch_axes)
                if self.commits():
                    out[r.rid] = col
        if include_queue and self.commits():
            out.update({r.rid: self._carried[r.rid] for r in self.queue
                        if r.rid in self._carried})
        return out

    def _column(self, t, ax: int, s: int):
        """Slot ``s``'s column of cache leaf ``t`` (batch axis ``ax``, a
        copy of extent 1 there). Over a mesh, whole on the lead rank and
        None elsewhere: each rank stages one column of its block — the
        slot's where it holds the slot, any other of the same shape where
        it does not — and the lead places only the holders' blocks
        (``collectives.gather_block``), so no rank gathers the cache."""
        if self.mesh is None:
            return t.narrow(ax, s, 1).clone()
        from torch.distributed.tensor import Replicate, Shard
        places = list(t.placements)
        split = [d for d, p in enumerate(places)
                 if isinstance(p, Shard) and p.dim == ax]
        for d in split:
            places[d] = Replicate()
        lo, n = self._rows(t, ax)
        local = local_of(t).narrow(ax, s - lo if lo <= s < lo + n else 0, 1)
        shape = tuple(1 if i == ax else int(x) for i, x in enumerate(t.shape))
        return gather_block(local, shape, self.mesh, places,
                            lead_rank(self.mesh),
                            at=self._slot_holder(t, ax, s, split))

    def _slot_holder(self, t, ax: int, s: int, split: List[int]
                     ) -> Dict[int, int]:
        """The coordinates, on the mesh dims ``split`` that shard leaf
        ``t``'s batch axis ``ax``, of the ranks whose block holds slot
        ``s``."""
        import itertools
        shape = tuple(self.mesh.shape)
        for coord in itertools.product(*(range(shape[d]) for d in split)):
            full = [0] * len(shape)
            for d, c in zip(split, coord):
                full[d] = c
            lo, n = 0, int(t.shape[ax])
            for d, start, size in block_narrows(
                    tuple(t.shape), shape, full, t.placements):
                if d == ax:
                    lo, n = lo + start, size
            if lo <= s < lo + n:
                return dict(zip(split, coord))
        return {}

    def carry(self, by_path) -> List[int]:
        """Adopt the cache columns a move brought (the "carried" entry's
        layout: each column's cache paths under ``[rid]``) for sessions
        about to be submitted: each lands in the slot that admits its
        request, as a re-slotted session's does. Raises MigrationError
        if a column does not fit this engine's cache (another model or
        ``max_seq``): its session could only re-enter by re-prefilling
        its history, which need not give the decode steps' bits (ROADMAP
        C23). Returns the rids adopted."""
        if callable(getattr(by_path, "wait", None)):
            by_path.wait()
        want = self.column_shapes()
        bad = sorted(rid for rid, col in _by_rid(by_path).items()
                     if {p: tuple(np.shape(v)) for p, v in col.items()}
                     != want)
        if bad:
            raise MigrationError(
                f"the cache columns of sessions {bad} do not fit this "
                f"engine's cache ({self.cfg.name}, max_seq "
                f"{self.max_seq}); a move lands each begun session with "
                "its column (ROADMAP C23)")
        cols = self._columns_from(by_path)
        self._carried.update(cols)
        return sorted(cols)

    def live_requests(self) -> List[Request]:
        """In-flight requests (slot order) + the waiting queue."""
        return [r for r in self.slot_req if r is not None] + list(self.queue)

    def extract_sessions(self, slots: Optional[List[int]] = None, *,
                         include_queue: bool = False) -> List[Request]:
        """Freeze and REMOVE live sessions — the migration source hook.

        The chosen ``slots`` (None = every occupied slot) give up their
        requests; each request carries its complete history (prompt +
        generated tokens + budget), which is all a target engine needs
        to rebuild the session's KV state through admission replay (a
        live move sends the cache columns too, read first with
        ``session_columns``); a queued request's carried column stays
        behind and is dropped. The freed slots zero their bookkeeping
        and refill from the queue on the next step. ``include_queue``
        also drains the waiting queue (a full drain of this engine)."""
        chosen = range(self.n_slots) if slots is None else slots
        out: List[Request] = []
        for s in chosen:
            if not 0 <= s < self.n_slots:
                raise IndexError(f"slot {s} out of range "
                                 f"(engine has {self.n_slots})")
            r = self.slot_req[s]
            if r is None:
                continue
            out.append(r)
            self.slot_req[s] = None
            self.slot_pos[s] = 0
            self.slot_tok[s, 0] = 0
        if include_queue:
            for r in self.queue:
                self._carried.pop(r.rid, None)
            out.extend(self.queue)
            self.queue = []
        return out

    # --- admission ------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for s in range(self.n_slots):
            if self.slot_req[s] is None and self.queue:
                self._bind_slot(s, self.queue.pop(0))

    def _bind_slot(self, s: int, req: Request) -> None:
        """Admit ``req`` into slot ``s``: its carried cache column lands
        there if it has one, else the slot's decode state is rebuilt
        from the request's full token history. The last history token
        becomes the slot's pending token, so the next engine step
        produces the request's next output token."""
        seq = np.concatenate([np.asarray(req.prompt).ravel(),
                              np.asarray(req.out).ravel()]).astype(np.int32)
        hist = seq[:-1]
        carried = self._carried.pop(req.rid, None)
        if carried is not None:
            self._merge_slot(s, carried)
        elif len(hist):
            if self._prefill_admission:
                self._prefill_slot(s, hist)
            else:
                self._merge_slot(s, self.replay(hist)[1])
        self.slot_req[s] = req
        self.slot_tok[s, 0] = int(seq[-1])
        self.slot_pos[s] = len(seq) - 1
        if self._pending_cache is not None:
            # admitted while the checkpointed cache is still streaming:
            # this slot's column now holds fresh admission state that
            # the deferred merge must not overwrite
            self._touched_slots.add(s)

    def _prefill_slot(self, s: int, hist: np.ndarray) -> None:
        """One batch-1 prefill call instead of O(len) full-slot decodes:
        the history is right-padded into a power-of-two bucket and
        prefilled into a fresh single-slot cache, which then lands in
        slot ``s``. Pad garbage beyond the history writes cache entries
        at positions the causal mask hides until decode overwrites them
        (each decode step rewrites its own position before attending)."""
        width = max(8, 1 << (int(len(hist)) - 1).bit_length())
        width = min(width, self.max_seq)
        if len(hist) > width:
            raise ValueError(f"history of {len(hist)} tokens does not fit "
                             f"max_seq={self.max_seq}")
        toks = np.zeros((1, width), np.int32)
        toks[0, :len(hist)] = hist
        toks = torch.tensor(toks, device=self.device)
        if self.mesh is None:
            one = M.init_cache(self.cfg, 1, self.max_seq, self.device)
            M.prefill(self.cfg, self.params, toks, one)
        else:
            # batch 1, replicated over the data axes
            one = self._new_cache(1, self.max_seq)
            self._admit_prefill(self.params, toks, one)
        self._merge_slot(s, one)

    def _new_cache(self, batch: int, max_seq: int):
        """An empty cache laid out by the engine's plan on its mesh."""
        return sharded_cache(self.cfg, batch, max_seq, self.mesh, self.plan)

    def replay(self, hist: np.ndarray):
        """Recurrent families (ssm, hybrid): the state is order-sensitive,
        so no padding — replay the history through batch-1 decode steps
        into a fresh single-slot cache (no other slot's state moves). The
        encoder-decoder is admitted the same way, as the JAX engine
        admits it: its cross cache keeps the fresh cache's zeros.
        Returns (the last step's logits [1, V], the single-slot cache)."""
        one = M.init_cache(self.cfg, 1, self.max_seq, self.device)
        logits = None
        for i, t in enumerate(np.asarray(hist).ravel()):
            logits, one = M.decode_step(
                self.cfg, self.params, one,
                torch.tensor([[int(t)]], dtype=torch.int32,
                             device=self.device),
                torch.tensor([i], dtype=torch.int32, device=self.device))
        return logits, one

    def _merge_slot(self, s: int, one) -> None:
        """Land a single-slot cache in slot ``s`` of the engine cache, in
        place, along each leaf's batch axis (``M.batch_axes``). Over a
        mesh only the data rank that holds slot ``s`` writes it, each
        model rank its block: ``one``'s own (a DTensor column laid out by
        the same plan) or the block of a whole column (a carried one)."""
        tree_map(lambda full, col, ax: self._put_column(full, col, ax, s),
                 self.cache, one, self._batch_axes)

    def _narrows(self, t):
        """This rank's (dim, start, size) narrows of DTensor ``t``."""
        coord = [int(self.mesh.get_local_rank(i))
                 for i in range(self.mesh.ndim)]
        return block_narrows(tuple(t.shape), tuple(self.mesh.shape), coord,
                             t.placements)

    def _rows(self, t, ax: int):
        """(first slot, slots) of this rank's block of cache leaf ``t``."""
        for d, start, size in self._narrows(t):
            if d == ax:
                return start, size
        return 0, int(t.shape[ax])

    def _put_column(self, full, col, ax: int, s: int) -> None:
        if self.mesh is None:
            full.narrow(ax, s, 1).copy_(col)
            return
        lo, n = self._rows(full, ax)
        if not lo <= s < lo + n:
            return
        if is_dtensor(col):
            block = local_of(col)
        else:
            block = col
            for d, start, size in self._narrows(full):
                if d != ax:
                    block = block.narrow(d, start, size)
        local_of(full).narrow(ax, s - lo, 1).copy_(block)

    def _land(self, cur, v, ax: int, keep) -> None:
        """Land the whole host leaf ``v`` in cache leaf ``cur`` in place
        (over a mesh, this rank's block of it), except the slot columns
        ``keep``, which hold fresh admission state."""
        if self.mesh is None:
            loc, lo, whole = cur, 0, to_tensor(v, cur.dtype, cur.device)
        else:
            loc, (lo, n) = local_of(cur), self._rows(cur, ax)
            keep = [s for s in keep if lo <= s < lo + n]
            whole = local_shard(to_tensor(v, cur.dtype, None), self.mesh,
                                cur.placements)
        kept = [loc.narrow(ax, s - lo, 1).clone() for s in keep]
        loc.copy_(whole)
        for s, col in zip(keep, kept):
            loc.narrow(ax, s - lo, 1).copy_(col)

    def _ensure_cache(self) -> None:
        """Land the streamed KV cache (first-touch page-in of the cold
        tier). Admission runs *before* this in ``step()`` on purpose:
        its prefill or replay runs while the restored cache is still
        fetching and decoding in the background. The restored bytes land
        in place (``copy_``, on the engine's device); slot columns that
        admission already rewrote keep their fresh state — exactly the
        state the eager path reaches by restoring first and letting
        admission overwrite, so the two paths stay bit-identical."""
        if self._pending_cache is None:
            return
        pending, self._pending_cache = self._pending_cache, None
        pending.wait()
        touched = sorted(self._touched_slots)
        self._touched_slots = set()
        tree_map(lambda cur, v, ax: self._land(cur, v, ax, touched),
                 self.cache, fill_like(self.cache, pending),
                 self._batch_axes)

    def step(self) -> int:
        """One engine iteration; returns #active slots."""
        self._admit()
        self._ensure_cache()
        active = [s for s in range(self.n_slots) if self.slot_req[s]]
        if not active:
            return 0
        toks = torch.tensor(self.slot_tok, device=self.device)
        poss = torch.tensor(self.slot_pos, device=self.device)
        logits, self.cache = self.decode(self.params, self.cache, toks, poss)
        self.last_logits = logits
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for s in active:
            req = self.slot_req[s]
            tok = int(nxt[s])
            req.out.append(tok)
            self.slot_tok[s, 0] = tok
            self.slot_pos[s] += 1
            if len(req.out) >= req.max_new or self.slot_pos[s] >= self.max_seq - 1:
                req.done = True
                self.slot_req[s] = None
        self.steps += 1
        return len(active)

    def run_until_drained(self, max_steps: int = 10_000,
                          snapshot_every: Optional[int] = None) -> None:
        # over a mesh the ranks without a manager still join the gather
        snaps = self.manager is not None or not self.commits()
        while (self.queue or any(self.slot_req)) and max_steps > 0:
            self.step()
            if snapshot_every and self.steps % snapshot_every == 0 \
                    and snaps:
                self.snapshot()
            max_steps -= 1
        if snapshot_every and self.manager is not None:
            self.manager.wait()


@register_app_kind("serving")
def _restore_engine(restore: RestoreContext, params,
                    n_slots: Optional[int] = None,
                    device=None) -> ServingEngine:
    """The "serving" restore binder: the Incarnation lifecycle, serving
    flavor. ``device`` is where the engine comes back (default: the
    card), or the ``mesh_factory``'s mesh: any mesh reads any serving
    checkpoint, whose leaves are whole. On a re-slot restore the slot
    bookkeeping is rebuilt from the requests, so its entry is skipped
    at decode, and the KV cache's columns travel with their requests;
    the op-log replays with CacheAlloc/Compile rewritten to the new slot
    count (composed with any session-level rewrite)."""
    job = restore.job
    arch = job.get("arch")
    if arch is None:
        raise RestoreError("checkpoint predates engine arch metadata; "
                           "cannot rebuild the engine from it")
    n_old, max_seq = int(job["n_slots"]), int(job["max_seq"])
    n_new = int(n_slots) if n_slots is not None else n_old
    reslot = n_new != n_old

    rewriters = [r for r in (restore.rewrite_op,
                             _reslot_rewriter(n_old, n_new) if reslot
                             else None) if r is not None]
    rewrite = None
    if rewriters:
        rewrite = rewriters[0] if len(rewriters) == 1 else \
            (lambda op: rewriters[1](rewriters[0](op)))
    dev = None if restore.mesh_factory is not None \
        else resolve_device(device)
    mesh_factory = restore.mesh_factory or (lambda: dev)

    inc = restore.incarnation(
        skip_entries=("sessions",) if reslot else None,
        rewrite_op=rewrite, mesh_factory=mesh_factory)
    inc.materialize()
    lower = inc.build_lower()
    cfg = _resolve_cfg(arch)
    use_device = inc.mesh_or_none()
    if use_device is None:
        # an op-log that bound no device (an engine built outside the
        # logged runtime): the caller's mesh or device
        use_device = restore.mesh_factory() \
            if restore.mesh_factory is not None else dev
    if use_device is None:
        raise RestoreError("op-log bound no device (engine was built "
                           "outside the logged runtime); pass device=")
    vexec = inc.last_compile("decode_step")
    adopt = None
    if vexec is not None:
        vcache = inc.last_cache_alloc()
        if vcache is not None:
            cache = lower.cache(vcache)
        elif is_device_mesh(use_device):
            from repro_torch.serving.kv_cache import allocate_cache
            cache = allocate_cache(arch, n_new, max_seq, lower)
        else:
            cache = M.init_cache(cfg, n_new, max_seq, use_device)
        adopt = {"decode": lower.executable(vexec), "cache": cache,
                 "vexec": vexec, "vcache": vcache}
    eng = ServingEngine(cfg, params, use_device, n_slots=n_new,
                        max_seq=max_seq, manager=restore.manager,
                        lower=lower, arch=arch, _adopt=adopt)
    eng.bind(restore)
    return eng
