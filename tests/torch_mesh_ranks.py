"""Rank functions of ``test_torch_mesh.py``: each runs in a gloo CPU rank
that ``repro_torch.launch.mesh.spawn_ranks`` starts, imports no JAX
(the ranks only need the port), and returns plain Python and numpy
values for the test process to hold against the JAX package.

The smoke configs are float32 in every rank (``_f32``), as the test
process patches them for both packages.

Serving (``serve_and_restore`` in the first launch, ``serve_restores``
in the second): phi4-mini-3.8b-smoke on 4 slots x 64, snapshots every
``SERVE_EVERY`` steps by rank 0's session, the checkpoint of step
``SERVE_AT`` restored onto (2, 2), (1, 4) eagerly, (4, 1) streamed,
re-slotted onto 3 slots of (2, 2), and the JAX engine's checkpoint onto
(2, 2); ``combine_case`` holds the sequence-split decode's combine;
``family_raises`` calls the families that still refuse a mesh.

The failure loop over a mesh (in the first launch): ``supervise_trainer``
(shrink onto (2, 1) over ranks 0-1, grow back, restart),
``supervise_engine`` (4 slots of (2, 2) re-slotted onto 3 of (1, 2)),
``move_off_mesh`` (``session_columns`` and ``migrate_sessions`` off the
(2, 2) engine) and ``supervised_launcher`` (``launch.train._mesh_rank``
with ``--supervise``). Every rank runs the same supervisor with the
world as its ``process_group``.
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
SERVE_ARCH = "phi4-mini-3.8b-smoke"
SERVE = dict(n_slots=4, max_seq=64)
SERVE_EVERY = 3          # a snapshot every 3 engine steps
SERVE_AT = 6             # the step every serving restore comes back at
SMALL = dict(sparse_chunk_bytes=1024, sparse_min_bytes=2048)
# the families whose serving over a mesh waits for ROADMAP A9b step 4
FAMILY_ARCHS = ("mamba2-780m-smoke", "recurrentgemma-9b-smoke",
                "whisper-base-smoke")


def _f32():
    from repro_torch.configs import (kimi_k2_1t_a32b, phi4_mini_3_8b,
                                     starcoder2_3b)
    for mod in (starcoder2_3b, kimi_k2_1t_a32b, phi4_mini_3_8b):
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


def _restore(store, shape, **kw):
    from repro_torch.api import CheckpointSession
    from repro_torch.train.loop import Trainer
    sess = CheckpointSession(f"localfs:{store}")
    t = Trainer.restore(sess.manager, mesh_factory=_mesh_factory(shape),
                        **kw)
    return t, sess


def _wait_for(path, timeout_s=300.0):
    """Block until the file ``path`` exists (another launch's signal)."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {timeout_s:.0f} s")
        time.sleep(0.05)


def _restore_and_step(store, shape, **kw):
    r, rs = _restore(store, shape, **kw)
    got = dict(digest=r.params_digest(), step=r.checkpoint_step())
    got["loss"] = r.train_steps(1)["loss"]
    got["state_digest"] = r.state_digest()
    rs.close()
    return got


def _serve_params(serve_in):
    from repro_torch import convert
    return convert.params_from_numpy(serve_in["params"], "cpu")


def _drain(eng):
    """Step ``eng`` until every request is done: {step: its logits}."""
    logits = {}
    while eng.queue or any(eng.slot_req):
        eng.step()
        logits[eng.steps] = eng.last_logits.numpy().copy()
    return logits


def _serve_restore(store, shape, params, step, **kw):
    """The serving checkpoint ``step`` of ``store`` restored onto a
    ``shape`` mesh and run to the end: its cache digest on return, each
    live request's tokens, each later step's logits."""
    from repro_torch.api import CheckpointSession
    sess = CheckpointSession(f"localfs:{store}")
    eng = sess.restore(step, params=params,
                       mesh_factory=_mesh_factory(shape), **kw)
    live = eng.live_requests()
    out = dict(step=eng.steps, digest=eng.cache_digest(),
               n_slots=eng.n_slots, logits=_drain(eng))
    out["tokens"] = {r.rid: list(r.out) for r in live}
    sess.close()
    return out


def serve_and_restore(rank, world, serve_in):
    """(2, 2): serve ``serve_in``'s prompts to the end with a snapshot
    every ``SERVE_EVERY`` steps (rank 0 commits them, then writes
    ``<store>/READY``), each step's logits and each snapshot step's cache
    digest; then the checkpoint of ``SERVE_AT`` restored onto (2, 2)
    and run to the end."""
    from repro_torch.api import CheckpointSession, Policy
    from repro_torch.serving.engine import Request, ServingEngine
    _f32()
    store = serve_in["store"]
    sess = CheckpointSession(f"localfs:{store}", Policy(chain=4, **SMALL)) \
        if rank == 0 else None
    params = _serve_params(serve_in)
    eng = ServingEngine.create(SERVE_ARCH, params, (2, 2), AXES,
                               manager=sess and sess.manager, device="cpu",
                               **SERVE)
    reqs = [Request(rid=i, prompt=p.copy(), max_new=serve_in["max_new"])
            for i, p in enumerate(serve_in["prompts"])]
    for r in reqs:
        eng.submit(r)
    logits, digests = {}, {}
    while eng.queue or any(eng.slot_req):
        eng.step()
        logits[eng.steps] = eng.last_logits.numpy().copy()
        if eng.steps % SERVE_EVERY == 0:
            eng.snapshot()
            digests[eng.steps] = eng.cache_digest()
    if sess is not None:
        sess.close()
        open(os.path.join(store, "READY"), "w").close()
    out = dict(tokens={r.rid: list(r.out) for r in reqs}, logits=logits,
               digests=digests, plan=eng.plan,
               local_k=tuple(eng.cache["k"].to_local().shape))
    del eng
    out["restore"] = _serve_restore(store, (2, 2), params, SERVE_AT)
    out["move"] = move_off_mesh(rank, store, params,
                                store.rstrip("/") + "-moves")
    return out


def combine_case(rank, world, case):
    """The sequence-split decode on a (1, 4) mesh: each rank's block of
    ``case``'s keys (``partial_attention``), gathered over the model
    axis and combined in rank order (``combine_partials``)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.parallel import context as pctx
    from torch.distributed.tensor import Replicate
    mesh = make_mesh((1, 4), AXES, "cpu")
    ctx = pctx.for_mesh(mesh)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in case.items()}
    n = t["k"].shape[1] // 4
    lo = ctx.model_rank() * n
    pm, pl, pacc = L.partial_attention(
        t["q"], t["k"][:, lo:lo + n], t["v"][:, lo:lo + n], t["q_pos"],
        t["kv_pos"][:, lo:lo + n], window=int(case["window"]))
    every = L._gather_model(torch.cat([pm[..., None], pl[..., None], pacc],
                                      dim=-1), ctx, Replicate())
    return L.combine_partials(every[..., 0], every[..., 1],
                              every[..., 2:]).numpy()


def moe_serve(rank, world, moe_in):
    """kimi-k2-1t-a32b-smoke served on (2, 2), expert-parallel (4 of its
    8 experts a model rank): each request's tokens and each step's
    logits."""
    from repro_torch.serving.engine import Request, ServingEngine
    _f32()
    eng = ServingEngine.create(MOE_ARCH, _serve_params(moe_in), (2, 2), AXES,
                               n_slots=2, max_seq=32, device="cpu")
    reqs = [Request(rid=i, prompt=p.copy(), max_new=4)
            for i, p in enumerate(moe_in["prompts"])]
    for r in reqs:
        eng.submit(r)
    logits = _drain(eng)
    return dict(tokens={r.rid: list(r.out) for r in reqs}, logits=logits,
                local_experts=eng.params["layers"]["ffn"]["w_gate"]
                .to_local().shape[1])


def serve_restores(rank, world, serve_in):
    """Once ``serve_and_restore`` has committed: its checkpoint of
    ``SERVE_AT`` onto (1, 4) eagerly, onto (4, 1) streamed and onto 3
    slots of (2, 2); then the JAX engine's checkpoint of ``SERVE_AT``
    (``<jax_store>/READY``) onto (2, 2)."""
    _f32()
    params = _serve_params(serve_in)
    _wait_for(os.path.join(serve_in["store"], "READY"))
    out = {"(1, 4) eager": _serve_restore(serve_in["store"], (1, 4), params,
                                         SERVE_AT),
           "(4, 1) streamed": _serve_restore(serve_in["store"], (4, 1),
                                             params, SERVE_AT,
                                             streaming=True),
           "(2, 2) re-slotted": _serve_restore(serve_in["store"], (2, 2),
                                               params, SERVE_AT, n_slots=3)}
    _wait_for(os.path.join(serve_in["jax_store"], "READY"))
    out["jax"] = _serve_restore(serve_in["jax_store"], (2, 2), params,
                                SERVE_AT)
    return out


def train_and_restore(rank, world, store, jax_store, steps, moe_in,
                      serve_in, sup_in, launch_in):
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
    out["supervise"] = supervise_trainer(rank, world, store,
                                         store.rstrip("/") + "-supervised")
    out["supervise_engine"] = supervise_engine(rank, world, sup_in)
    out["launcher"] = supervised_launcher(rank, world, **launch_in)
    _wait_for(os.path.join(jax_store, "READY"))
    r, rs = _restore(jax_store, (2, 2))
    out["jax_restore"] = dict(digest=r.params_digest(),
                              step=r.checkpoint_step(),
                              loss=r.train_steps(1)["loss"])
    rs.close()
    out["moe"] = moe_layer(rank, world, moe_in)
    out["serve"] = serve_and_restore(rank, world, serve_in)
    out["stats"] = _stats()
    return out


# --- the failure loop over a mesh (A9b step 2) ------------------------------

def _beat_until_dead(sup, now, alive, step=0):
    """Seven ticks of the supervisor's clock with only ``alive`` beating,
    then one poll: the executed decision's target."""
    for _ in range(7):
        now[0] += 1.0
        for h in alive:
            sup.beat(h, step)
    return sup.poll()


def _survivor_mesh(shape_of, device="cpu"):
    """A restore hook's mesh factory for a target: ``shape_of(n)`` is the
    mesh over the first ranks of the n surviving hosts (host h backs
    rank h)."""
    from repro_torch.launch.mesh import make_mesh

    def kwargs(target):
        shape = shape_of(len(target.hosts))
        n = int(np.prod(shape))
        return lambda: make_mesh(shape, AXES, device,
                                 ranks=sorted(target.hosts)[:n])
    return kwargs


def _held_bytes(runner) -> int:
    """Bytes of params and moments this rank holds (its blocks)."""
    from repro_torch.models.layers import is_dtensor
    from repro_torch.tree import flatten_with_paths
    upper = getattr(runner, "upper", None)
    if upper is None:
        return 0
    blocks = [v.to_local() if is_dtensor(v) else v
              for e in ("params", "opt_state")
              for _, v in flatten_with_paths(upper.get(e))]
    return sum(b.numel() * b.element_size() for b in blocks
               if isinstance(b, torch.Tensor))


def _incidents(sup):
    return [(i.action, list(i.dead), i.step, i.mesh) for i in sup.incidents]


def supervise_trainer(rank, world, store, sup_store):
    """Every rank runs one ``ClusterSupervisor`` over hosts 0-3 on a copy
    of the (2, 2) checkpoint (its latest step): host 3 goes silent and
    the shrink restores onto (2, 1) over ranks 0-1 (ranks 2-3 hold
    nothing), which steps once and snapshots; host 3 comes back and
    ``grow`` restores that snapshot onto (2, 2), which steps once; then
    a supervisor over host 0 alone loses it and restarts the same step
    on (2, 2), which steps once."""
    import shutil
    import torch.distributed as dist
    from repro_torch.api import CheckpointSession, Policy
    from repro_torch.core.supervisor import OutsideMesh
    _f32()
    if rank == 0:
        shutil.copytree(store, sup_store)
    dist.barrier()
    sess = CheckpointSession(f"localfs:{sup_store}", Policy(async_save=False))
    hook = _survivor_mesh(lambda n: (2, 2) if n == 4 else (2, 1))
    now = [0.0]
    sup = sess.supervise([0, 1, 2, 3], heartbeat_timeout=3.0,
                         clock=lambda: now[0], n_shards=4,
                         restore_kwargs=lambda t: {"mesh_factory": hook(t)},
                         process_group=dist.group.WORLD)
    out = {"restorable": [sup.latest_restorable_step()]}
    target = _beat_until_dead(sup, now, (0, 1, 2))
    r = sup.runner
    shrink = dict(action=target.action.value, hosts=target.hosts,
                  step=target.step, outside=isinstance(r, OutsideMesh),
                  held=_held_bytes(r))
    if not shrink["outside"]:
        shrink.update(digest=r.params_digest(),
                      mesh=tuple(r.mesh.shape),
                      ranks=[int(x) for x in r.mesh.mesh.flatten()],
                      assignment=r.lower.data_assignment,
                      loss=r.train_steps(1)["loss"])
    sess.snapshot(block=True)       # the (2, 1) state, gathered on rank 0
    if not shrink["outside"]:
        shrink["saved"] = r.params_digest()
    del r
    out["shrink"] = shrink
    out["restorable"].append(sup.latest_restorable_step())
    sup.policy.spares.append(3)
    target = sup.grow()
    r = sup.runner
    out["grow"] = dict(action=target.action.value, hosts=target.hosts,
                       step=target.step, digest=r.params_digest(),
                       mesh=tuple(r.mesh.shape), held=_held_bytes(r),
                       loss=r.train_steps(1)["loss"],
                       state=r.state_digest())
    del r
    out["incidents"] = _incidents(sup)
    out["restorable"].append(sup.latest_restorable_step())
    sup = sess.supervise([0], heartbeat_timeout=3.0, clock=lambda: now[0],
                         restore_kwargs=lambda t: {
                             "mesh_factory": _mesh_factory((2, 2))},
                         process_group=dist.group.WORLD)
    target = _beat_until_dead(sup, now, ())
    r = sup.runner
    out["restart"] = dict(action=target.action.value, step=target.step,
                          mesh=tuple(r.mesh.shape),
                          loss=r.train_steps(1)["loss"],
                          state=r.state_digest())
    out["incidents"] += _incidents(sup)
    del r
    sess.close()
    return out


def supervise_engine(rank, world, sup_in):
    """phi4-mini-3.8b-smoke served on (2, 2) with 4 slots by every rank
    under one ``ClusterSupervisor`` over hosts 0-3: ``sup_in``'s prompts,
    a snapshot after ``sup_in["kill_at"]`` steps, host 3 goes silent and
    the shrink re-slots the sessions onto 3 slots of a (1, 2) mesh over
    ranks 0-1 (``launch.serve.proportional_slots``), which drains them:
    each request's tokens."""
    import torch.distributed as dist
    from repro_torch.api import CheckpointSession, Policy
    from repro_torch.core.supervisor import OutsideMesh
    from repro_torch.launch.serve import proportional_slots
    from repro_torch.serving.engine import Request, ServingEngine
    _f32()
    params = _serve_params(sup_in)
    sess = CheckpointSession(f"localfs:{sup_in['store']}",
                             Policy(async_save=False))
    eng = sess.attach(ServingEngine.create(
        SERVE_ARCH, params, (2, 2), AXES, manager=sess.manager,
        device="cpu", **sup_in["serve"]))
    reqs = [Request(rid=i, prompt=p.copy(), max_new=sup_in["max_new"])
            for i, p in enumerate(sup_in["prompts"])]
    for r in reqs:
        eng.submit(r)
    for _ in range(sup_in["kill_at"]):
        eng.step()
    sess.snapshot(block=True)
    digest = eng.cache_digest()
    del eng
    hook = _survivor_mesh(lambda n: (1, 2))
    slots = sup_in["serve"]["n_slots"]
    now = [0.0]
    sup = sess.supervise([0, 1, 2, 3], heartbeat_timeout=3.0,
                         clock=lambda: now[0], restore_kwargs=lambda t: {
                             "params": params, "mesh_factory": hook(t),
                             "n_slots": proportional_slots(
                                 slots, 4, len(t.hosts))},
                         process_group=dist.group.WORLD)
    target = _beat_until_dead(sup, now, (0, 1, 2))
    e2 = sup.runner
    out = dict(action=target.action.value, step=target.step,
               incidents=_incidents(sup), digest=digest,
               outside=isinstance(e2, OutsideMesh))
    if not out["outside"]:
        live = e2.live_requests()
        out.update(n_slots=e2.n_slots, mesh=tuple(e2.mesh.shape))
        e2.run_until_drained(max_steps=200)
        tokens = {r.rid: list(r.out) for r in reqs if r.done}
        tokens.update({r.rid: list(r.out) for r in live})
        out["tokens"] = tokens
    del e2
    sess.close()
    return out


def move_off_mesh(rank, store, params, moves):
    """The serving checkpoint of ``SERVE_AT`` restored onto (2, 2): each
    live slot's cache column (``session_columns``, gathered whole onto
    rank 0), then every session moved onto a one-device engine on rank
    0 (``migrate_sessions``, the columns carried through ``moves``),
    which drains them."""
    from repro_torch.api import CheckpointSession
    from repro_torch.core.migration import migrate_sessions
    from repro_torch.serving.engine import ServingEngine
    sess = CheckpointSession(f"localfs:{store}")
    eng = sess.restore(SERVE_AT, params=params,
                       mesh_factory=_mesh_factory((2, 2)))
    cols = eng.session_columns()
    out = dict(columns={rid: _whole(c) for rid, c in cols.items()})
    target = ServingEngine.create(SERVE_ARCH, params, device="cpu",
                                  **SERVE) if rank == 0 else None
    res = migrate_sessions(eng, target, via=f"localfs:{moves}",
                           include_queue=True)
    out.update(moved=res.moved, left=len(eng.live_requests()))
    if target is not None:
        target.run_until_drained()
        out.update(carried=res.carried,
                   tokens={r.rid: list(r.out) for r in res.requests})
    sess.close()
    return out


def supervised_launcher(rank, world, store, steps, kill):
    """``launch.train._mesh_rank`` with ``--supervise`` on (2, 2): the
    command line ``launch_argv`` gives, parsed as ``main`` parses it;
    what the rank printed and each step's (step, loss)."""
    import contextlib
    import io
    from repro_torch.launch import train as LT
    from repro_torch.train import loop
    from repro_torch.launch.supervise import (parse_churn_args,
                                              parse_drain_arg,
                                              parse_supervise_args)
    _f32()
    args = LT.build_parser().parse_args(
        launch_argv(steps, kill) + ["--store", f"localfs:{store}",
                                    "--data-mesh", "2", "--model-mesh", "2",
                                    "--device", "cpu"])
    kill_at, _ = parse_supervise_args(args, "launch")
    drain, _ = parse_drain_arg(args, "launch")
    trace, _ = parse_churn_args(args, "launch", horizon=args.steps)
    buf, seen = io.StringIO(), []
    plain = loop.Trainer.train_steps

    def train_steps(self, n):
        m = plain(self, n)
        seen.append((int(m["step"]), float(m["loss"])))
        return m
    loop.Trainer.train_steps = train_steps
    try:
        with contextlib.redirect_stdout(buf):
            LT._mesh_rank(rank, world, args, f"localfs:{store}", False,
                          None, (2, 2), kill_at, drain, trace)
    finally:
        loop.Trainer.train_steps = plain
    return dict(out=buf.getvalue(), losses=seen)


def launch_argv(steps, kill):
    """The supervised training command line both launcher runs take."""
    return ["--arch", ARCH, "--shape", "train_s32_b4", "--steps",
            str(steps), "--ckpt-every", "2", "--supervise", "--hosts", "4",
            "--spares", "0", "--kill-host", kill]


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


def family_raises(rank, world):
    """``prefill`` and ``decode_step`` of the ssm, hybrid and
    encoder-decoder families with DTensor tokens on a (2, 2) mesh:
    {(arch, function): the ``NotImplementedError``'s message}."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.configs import registry as treg
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    mesh = make_mesh((2, 2), AXES, "cpu")
    toks = distribute_tensor(torch.zeros(4, 1, dtype=torch.int32), mesh,
                             (Replicate(), Replicate()), src_data_rank=None)
    pos = torch.zeros(4, dtype=torch.int32)
    out = {}
    for arch in FAMILY_ARCHS:
        cfg = treg.resolve_config(arch)
        calls = {"prefill": lambda: M.prefill(cfg, None, toks, None),
                 "decode_step": lambda: M.decode_step(cfg, None, None, toks,
                                                      pos)}
        for fn, call in calls.items():
            try:
                call()
            except NotImplementedError as e:
                out[(arch, fn)] = str(e)
            else:
                out[(arch, fn)] = None
    return out


def others(rank, world, shapes, steps, store, ef_in, pipe_in, serve_in,
           case, moe_in):
    """``steps_on`` the meshes of ``shapes``, ``compress_and_pipeline``,
    ``combine_case``, ``moe_serve``, ``family_raises``; then, once
    ``train_and_restore`` has committed its checkpoint, that checkpoint
    restored onto each of ``shapes`` and onto (4, 1) streamed, and
    stepped once; then ``serve_restores``."""
    out = dict(steps=steps_on(rank, world, shapes, steps),
               gather=gather_cases(rank, world),
               gather_want=np.arange(96, dtype=np.float32).reshape(8, 12),
               combine=combine_case(rank, world, case),
               moe_serve=moe_serve(rank, world, moe_in),
               family_raises=family_raises(rank, world),
               **compress_and_pipeline(rank, world, ef_in, pipe_in))
    _wait_for(os.path.join(store, "READY"))
    out["restores"] = {shape: _restore_and_step(store, shape)
                       for shape in shapes}
    out["restores"]["(4, 1) streamed"] = _restore_and_step(
        store, (4, 1), streaming=True)
    out["serve"] = serve_restores(rank, world, serve_in)
    out["stats"] = _stats()
    return out
