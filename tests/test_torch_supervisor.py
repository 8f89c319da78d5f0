"""The failure loop of the port (``repro_torch.core.supervisor``):

* against the JAX package's, on the RL actor-learner app (the JAX
  package's ``examples/rl_actor_learner.py`` and the port's twin), which
  holds numpy state only: five policies — hot spare, shrink, restart
  from the last checkpoint, planned move (onto a spare, then a drain
  with none) and grow after a shrink — give the same event stream
  (virtual-clock time, kind, detail), the same incidents (action, dead
  hosts, step; wall-clock fields left out) and the same final digest;
* the six cases of ``tests/test_supervisor.py`` that fail in the JAX
  package under jax 0.9 (ROADMAP C4), on the port's trainer, each held
  against the port's own uninterrupted run;
* the other cases of that file, on the port: loud failures, storage
  repair, stragglers, serving shrink and grow, and the one-device
  refusal of a larger mesh (ROADMAP A9).
"""
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from repro.api import CheckpointSession as JSession
from repro.api import Policy as JPolicy
from repro_torch.api import CheckpointSession, Policy
from repro_torch.configs import get_smoke_config
from repro_torch.core import replication
from repro_torch.core.backends.localfs import LocalFSBackend
from repro_torch.core.backends.sharded import ShardedBackend
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.failure import FailureAction, FailurePolicy
from repro_torch.core.failure import rebalance_shards
from repro_torch.core.oplog import DataReassign
from repro_torch.core.supervisor import (ClusterSupervisor, SupervisorError,
                                         one_device_mesh)
from repro_torch.core.virtual_ids import StaleHandleError
from repro_torch.examples import rl_actor_learner as trl
from repro_torch.models import model as M
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.train.loop import Trainer, TrainJob

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import rl_actor_learner as jrl  # noqa: E402  (registers its app kind)


# --- five policies on the RL app, in both packages -------------------------------

RL_STEPS = 20


def _rl_policy_run(session_cls, policy_cls, rl, store, policy):
    """One supervised RL run; ``policy`` picks the world, the spares, the
    shrink permission and the scripted incidents. Returns what both
    packages must agree on."""
    spares = [7] if policy in ("hot_spare", "planned_move") else []
    sess = session_cls(store, policy_cls(interval=4, async_save=False))
    app = sess.attach(rl.RLActorLearner(n_actors=4, n_streams=8, dim=16,
                                        seed=5))
    now = [0.0]
    sup = sess.supervise([0, 1, 2, 3], spares=spares, heartbeat_timeout=3.0,
                         clock=lambda: now[0], n_shards=8,
                         allow_shrink=policy != "restart",
                         restore_kwargs=lambda t: {"n_actors": len(t.hosts)})
    sess.snapshot(block=True)
    down = set()
    while sup.runner.t < RL_STEPS:
        app = sup.runner
        app.collect_and_learn(1)
        sess.maybe_snapshot()
        now[0] += 1.0
        if app.t == 6 and policy in ("hot_spare", "shrink", "restart",
                                     "grow"):
            down.add(2)
        if policy == "planned_move" and app.t == 6:
            sup.planned_move(1)                 # onto the spare
        if policy == "planned_move" and app.t == 11 and 3 in sup.world:
            sup.policy.spares.remove(1)         # host 1 leaves for repair
            sess.snapshot(block=True)
            sup.planned_move(3)                 # no spare left: a drain
        for h in sup.world:
            if h not in down:
                sup.beat(h, app.t)
        sup.poll()
        if policy == "grow" and app.t == 13 and 2 not in sup.world:
            down.discard(2)
            sess.snapshot(block=True)           # grow loses no step
            sup.policy.spares.append(2)         # the host came back
            sup.grow()
    sess.close()
    return {"events": sup.events,
            "incidents": [(i.action, i.dead, i.step) for i in sup.incidents],
            "world": sup.world, "spares": sup.policy.spares,
            "actors": sup.runner.n_actors, "digest": sup.runner.digest()}


@pytest.mark.parametrize("policy", ["hot_spare", "shrink", "restart",
                                    "planned_move", "grow"])
def test_policy_on_the_rl_app_matches_jax(tmp_path, policy):
    got = _rl_policy_run(CheckpointSession, Policy, trl,
                         f"sharded:{tmp_path}/t?hosts=4&replicate=1", policy)
    want = _rl_policy_run(JSession, JPolicy, jrl,
                          f"sharded:{tmp_path}/j?hosts=4&replicate=1",
                          policy)
    assert got == want
    actions = {a for a, _, _ in got["incidents"]}
    assert actions == {"hot_spare": {"hot_spare"}, "shrink": {"shrink"},
                       "restart": {"restart_last_ckpt"},
                       "planned_move": {"planned_move", "planned_drain"},
                       "grow": {"shrink", "grow"}}[policy]
    ref = trl.RLActorLearner(n_actors=1, n_streams=8, dim=16, seed=5)
    ref.collect_and_learn(RL_STEPS)
    assert got["digest"] == ref.digest()


# --- the JAX package's C4 cases, on the port's trainer ----------------------------

JOB = TrainJob(arch="starcoder2-3b-smoke", shape_key="train_s32_b4")
STEPS = 5


@pytest.fixture(scope="module")
def reference():
    t = Trainer(JOB, device="cpu")
    t.init_state()
    for _ in range(STEPS):
        m = t.train_steps(1)
    return t.params_digest(), m


class _World:
    """Deterministic heartbeat driver: one virtual-clock tick per step;
    hosts in ``down`` stay silent and die of timeout."""

    def __init__(self):
        self._t = 0.0
        self.down = set()
        self.sup = None

    def clock(self) -> float:
        return self._t

    def tick(self, step: int) -> None:
        self._t += 1.0
        for h in self.sup.world:
            if h not in self.down:
                self.sup.beat(h, step)


def _restore_of(mgr):
    """A restore hook for a bare manager: the session's registry binder,
    on the CPU, with the decision's op rewrite."""
    def restore(target):
        return CheckpointSession.from_manager(mgr).restore(
            step=target.step, rewrite_op=target.rewrite_op(), device="cpu")
    return restore


def _make(world_hosts, mgr, runner, *, spares=(), allow_shrink=True,
          restore=None, n_shards=4, timeout=3.0):
    w = _World()
    sup = ClusterSupervisor(
        list(world_hosts), manager=mgr, spares=list(spares),
        heartbeat_timeout=timeout, clock=w.clock,
        allow_shrink=allow_shrink, n_shards=n_shards,
        restore=restore, runner=runner)
    w.sup = sup
    return sup, w


def _drive_to_death(sup, w, dead_host, step, ticks=6):
    for _ in range(2):
        w.tick(step)
    assert sup.poll() is None
    w.down.add(dead_host)
    for _ in range(ticks):
        w.tick(step)
    return sup.poll()


def _trainer(mgr):
    tr = Trainer(JOB, manager=mgr, device="cpu")
    tr.init_state()
    return tr


def test_restart_policy_token_identical(tmp_path, reference):
    """Port counterpart of ``tests/test_supervisor.py::
    test_restart_policy_token_identical`` (C4): restart from the last
    checkpoint after the dead host's storage is deleted — peer-replica
    repair, the runner's own uneven reassignment replayed verbatim, and
    the continuation bit-identical to the port's uninterrupted run."""
    ref_digest, ref_metrics = reference
    be = ShardedBackend(str(tmp_path), n_hosts=4, replicate=True)
    mgr = CheckpointManager(be, async_save=False)
    tr = _trainer(mgr)
    custom = ((3, 0), (3, 1), (0, 2), (0, 3))
    tr.apply_reassignment(custom)
    tr.train_steps(2)
    tr.save(block=True)
    tr.train_steps(1)           # uncommitted progress, lost in the crash
    hook = _restore_of(mgr)

    def restore(target):
        assert target.action is FailureAction.RESTART_LAST_CKPT
        assert target.step == 2
        assert target.rewrite_op() is None
        return hook(target)

    sup, w = _make([0, 1, 2, 3], mgr, tr, allow_shrink=False,
                   restore=restore)
    shutil.rmtree(be.root / "host_001")
    be.fail_host(1)
    target = _drive_to_death(sup, w, dead_host=1, step=3)

    assert target.action is FailureAction.RESTART_LAST_CKPT
    t2 = sup.runner
    assert t2 is not tr
    assert int(t2.upper.get("step")) == 2
    assert t2.lower.data_assignment == custom
    m = {}
    for _ in range(STEPS - 2):
        m = t2.train_steps(1)
    assert t2.params_digest() == ref_digest
    assert m["loss"] == ref_metrics["loss"]
    assert sup.mttr().get("restart_last_ckpt", -1.0) >= 0.0
    assert not replication.scan(be).degraded


def test_hot_spare_policy_token_identical(tmp_path, reference):
    """Port counterpart of ``tests/test_supervisor.py::
    test_hot_spare_policy_token_identical`` (C4): the dead host's
    logical coordinate rebinds to the spare, a rebalanced DataReassign
    is logged on the live trainer (no restore), training continues
    bit-identically, and the logged decision survives a later restore."""
    ref_digest, _ = reference
    mgr = CheckpointManager(LocalFSBackend(str(tmp_path)), async_save=False)
    tr = _trainer(mgr)
    tr.train_steps(2)
    tr.save(block=True)

    sup, w = _make([0, 1, 2, 3], mgr, tr, spares=[7],
                   restore=lambda t: pytest.fail("hot spare must not "
                                                 "restore"))
    target = _drive_to_death(sup, w, dead_host=1, step=2)

    assert target.action is FailureAction.HOT_SPARE
    assert target.mapping == {1: 7}
    assert sup.runner is tr
    assert sup.world == [0, 7, 2, 3]
    assert sup.hostmap.physical(1) == 7
    assert sup.policy.spares == []
    assert 7 in sup.monitor.hosts and 1 not in sup.monitor.hosts
    reassigns = [op for op in tr.lower.oplog.ops
                 if isinstance(op, DataReassign)]
    assert reassigns and reassigns[-1].assignment == \
        tuple(rebalance_shards(4, [0, 7, 2, 3]))
    assert tr.pipeline.assignment == list(reassigns[-1].assignment)

    for _ in range(STEPS - 2):
        tr.train_steps(1)
    assert tr.params_digest() == ref_digest

    tr.save(block=True)
    t2 = CheckpointSession.from_manager(mgr).restore(device="cpu")
    assert t2.lower.data_assignment == reassigns[-1].assignment
    assert t2.pipeline.assignment == list(reassigns[-1].assignment)


def test_shrink_policy_token_identical(tmp_path, reference):
    """Port counterpart of ``tests/test_supervisor.py::
    test_shrink_policy_token_identical`` (C4): the dead logical host
    leaves the world, the trainer restores with the logged DataReassign
    rewritten onto the survivors, and continues bit-identically."""
    ref_digest, _ = reference
    mgr = CheckpointManager(LocalFSBackend(str(tmp_path)), async_save=False)
    tr = _trainer(mgr)
    tr.apply_reassignment(rebalance_shards(4, [0, 1, 2]))
    tr.train_steps(2)
    tr.save(block=True)
    hook = _restore_of(mgr)

    def restore(target):
        assert target.action is FailureAction.SHRINK
        assert target.hosts == [0, 1]
        return hook(target)

    sup, w = _make([0, 1, 2], mgr, tr, restore=restore)
    target = _drive_to_death(sup, w, dead_host=2, step=2)

    assert target.action is FailureAction.SHRINK
    assert sup.world == [0, 1]
    assert sup.hostmap.logical_of(2) is None
    with pytest.raises(StaleHandleError):
        sup.hostmap.physical(2)
    t2 = sup.runner
    assert t2 is not tr
    want = tuple(rebalance_shards(4, [0, 1]))
    assert t2.lower.data_assignment == want
    assert t2.pipeline.assignment == list(want)
    for _ in range(STEPS - 2):
        t2.train_steps(1)
    assert t2.params_digest() == ref_digest


def test_grow_after_shrink_token_identical(tmp_path, reference):
    """Port counterpart of ``tests/test_supervisor.py::
    test_grow_after_shrink_token_identical`` (C4): after a shrink the
    recovered host re-enters through ``grow`` (its vacated logical slot
    revives), the trainer rebuilds from the fresh checkpoint with the
    grown assignment, and continues bit-identically."""
    ref_digest, _ = reference
    mgr = CheckpointManager(LocalFSBackend(str(tmp_path)), async_save=False)
    tr = _trainer(mgr)
    tr.apply_reassignment(rebalance_shards(4, [0, 1, 2]))
    tr.train_steps(2)
    tr.save(block=True)

    sup, w = _make([0, 1, 2], mgr, tr, restore=_restore_of(mgr))
    target = _drive_to_death(sup, w, dead_host=2, step=2)
    assert target.action is FailureAction.SHRINK
    t2 = sup.runner
    t2.train_steps(1)
    t2.save(block=True)

    sup.policy.spares.append(2)
    gt = sup.grow()
    assert gt.action is FailureAction.GROW
    assert gt.step == 3
    assert sup.world == [0, 1, 2]
    assert sup.hostmap.logical_of(2) == 2
    assert sup.policy.spares == []
    assert 2 in sup.monitor.hosts
    assert sup.incidents[-1].action == "grow"
    t3 = sup.runner
    assert t3 is not t2
    want = tuple(rebalance_shards(4, [0, 1, 2]))
    assert t3.lower.data_assignment == want
    assert t3.pipeline.assignment == list(want)
    for _ in range(STEPS - 3):
        t3.train_steps(1)
    assert t3.params_digest() == ref_digest


def test_planned_move_without_spare_is_deliberate_shrink(tmp_path,
                                                         reference):
    """Port counterpart of ``tests/test_supervisor.py::
    test_planned_move_without_spare_is_deliberate_shrink`` (C4): a drain
    with nobody to land on shrinks the world on purpose through the
    shrink's recovery path, and training continues bit-identically."""
    ref_digest, _ = reference
    mgr = CheckpointManager(LocalFSBackend(str(tmp_path)), async_save=False)
    tr = _trainer(mgr)
    tr.apply_reassignment(rebalance_shards(4, [0, 1, 2]))
    tr.train_steps(2)
    tr.save(block=True)
    hook = _restore_of(mgr)

    def restore(target):
        assert target.action is FailureAction.PLANNED_MOVE
        assert target.hosts == [0, 1]
        return hook(target)

    sup, _ = _make([0, 1, 2], mgr, tr, restore=restore)
    sup.planned_move(2)
    assert sup.world == [0, 1]
    assert sup.hostmap.logical_of(2) is None
    assert 2 not in sup.monitor.hosts
    assert sup.incidents[-1].action == "planned_drain"
    t2 = sup.runner
    assert t2 is not tr
    assert t2.lower.data_assignment == tuple(rebalance_shards(4, [0, 1]))
    for _ in range(STEPS - 2):
        t2.train_steps(1)
    assert t2.params_digest() == ref_digest


def test_drained_host_readmitted_by_later_failure(tmp_path, reference):
    """Port counterpart of ``tests/test_supervisor.py::
    test_drained_host_readmitted_by_later_failure`` (C4): a drained host
    returns to the spare pool and a later death's hot spare consumes it;
    training continues bit-identically with no restore."""
    ref_digest, _ = reference
    mgr = CheckpointManager(LocalFSBackend(str(tmp_path)), async_save=False)
    tr = _trainer(mgr)
    tr.train_steps(2)
    tr.save(block=True)

    sup, w = _make([0, 1], mgr, tr, spares=[7],
                   restore=lambda t: pytest.fail("hot paths must not "
                                                 "restore"))
    moved = sup.planned_move(1)
    assert moved.mapping == {1: 7}
    assert sup.world == [0, 7]
    assert sup.policy.spares == [1]

    target = _drive_to_death(sup, w, dead_host=7, step=2)
    assert target.action is FailureAction.HOT_SPARE
    assert target.mapping == {7: 1}
    assert sup.world == [0, 1]
    assert sup.policy.spares == []
    for _ in range(STEPS - 2):
        tr.train_steps(1)
    assert tr.params_digest() == ref_digest


# --- the other cases, on the port -------------------------------------------------

def test_restart_without_checkpoint_fails_loudly(tmp_path):
    mgr = CheckpointManager(LocalFSBackend(str(tmp_path)), async_save=False)
    sup, w = _make([0, 1], mgr, object(), allow_shrink=False,
                   restore=lambda t: pytest.fail("must not restore"))
    w.down.add(1)
    for _ in range(6):
        w.tick(0)
    with pytest.raises(SupervisorError, match="no restorable"):
        sup.poll()


def test_last_host_death_restarts_not_shrinks(tmp_path):
    action, _ = FailurePolicy(allow_shrink=True).decide([0], world=[0])
    assert action is FailureAction.RESTART_LAST_CKPT
    mgr = CheckpointManager(LocalFSBackend(str(tmp_path)), async_save=False)
    tr = _trainer(mgr)
    tr.save(block=True)
    sup, w = _make([0], mgr, tr, restore=_restore_of(mgr))
    target = _drive_to_death(sup, w, dead_host=0, step=0)
    assert target.action is FailureAction.RESTART_LAST_CKPT
    assert target.step == 0 and sup.runner is not tr


def test_recovery_absorbs_casualty_snapshot_failure(tmp_path):
    """A snapshot whose writer died with the host is part of the
    incident: recovery restores the last committed step, and the healed
    store takes the next snapshot."""
    be = ShardedBackend(str(tmp_path), n_hosts=2, replicate=True)
    mgr = CheckpointManager(be, async_save=True)
    tr = _trainer(mgr)
    tr.train_steps(1)
    tr.save(block=True)
    be.fail_host(1)
    tr.train_steps(1)
    handle = tr.snapshot()
    if handle is not None:
        with pytest.raises(IOError):
            handle.result()
    sup, w = _make([0, 1], mgr, tr, allow_shrink=False,
                   restore=_restore_of(mgr))
    shutil.rmtree(be.root / "host_001")
    target = _drive_to_death(sup, w, dead_host=1, step=2)
    assert target.action is FailureAction.RESTART_LAST_CKPT
    assert int(sup.runner.upper.get("step")) == 1
    assert any(kind == "casualty_snapshot" for _, kind, _ in sup.events)
    sup.runner.train_steps(1)
    sup.runner.save(block=True)
    assert mgr.backend.latest_step() == 2


def test_hot_spare_repairs_colocated_storage(tmp_path):
    be = ShardedBackend(str(tmp_path), n_hosts=4, replicate=True)
    mgr = CheckpointManager(be, async_save=False)
    tr = _trainer(mgr)
    tr.train_steps(1)
    tr.save(block=True)
    sup, w = _make([0, 1, 2, 3], mgr, tr, spares=[7],
                   restore=lambda t: pytest.fail("hot spare must not "
                                                 "restore"))
    shutil.rmtree(be.root / "host_001")
    be.fail_host(1)
    target = _drive_to_death(sup, w, dead_host=1, step=1)
    assert target.action is FailureAction.HOT_SPARE
    assert not replication.scan(be).degraded
    tr.train_steps(1)
    tr.save(block=True)
    assert mgr.backend.latest_step() == 2


def test_grow_refusals(tmp_path):
    mgr = CheckpointManager(LocalFSBackend(str(tmp_path)), async_save=False)
    sup, _ = _make([0, 1], mgr, object())
    with pytest.raises(SupervisorError, match="spare pool is empty"):
        sup.grow()
    with pytest.raises(SupervisorError, match="already serves"):
        sup.grow(1)
    sup, _ = _make([0], mgr, object(),
                   restore=lambda t: pytest.fail("must not restore"))
    with pytest.raises(SupervisorError, match="no restorable"):
        sup.grow(5)


def test_straggler_triggers_logged_rebalance(tmp_path):
    mgr = CheckpointManager(LocalFSBackend(str(tmp_path)), async_save=False)
    tr = _trainer(mgr)
    sup, w = _make([0, 1, 2, 3], mgr, tr, n_shards=8, timeout=1000.0)
    w.down.add(3)
    for step in range(1, 10):
        w.tick(step)
        if step % 3 == 0:
            sup.beat(3, step // 3)
    assert sup.check_stragglers() == [3]
    reassigns = [op for op in tr.lower.oplog.ops
                 if isinstance(op, DataReassign)]
    assert len(reassigns) == 1
    assert all(h != 3 for h, _ in reassigns[-1].assignment)
    assert {s for _, s in reassigns[-1].assignment} == set(range(8))
    assert sup.check_stragglers() == [3]
    assert sum(isinstance(op, DataReassign)
               for op in tr.lower.oplog.ops) == 1


def _serving_world(tmp_path):
    cfg = get_smoke_config("phi4-mini-3.8b")
    params = M.init_params(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, size=4) for _ in range(4)]

    def fresh():
        return [Request(rid=i, prompt=p.copy(), max_new=5)
                for i, p in enumerate(prompts)]
    ref_eng = ServingEngine.create("phi4-mini-3.8b-smoke", params,
                                   n_slots=2, max_seq=32, device="cpu")
    ref = fresh()
    for r in ref:
        ref_eng.submit(r)
    ref_eng.run_until_drained(max_steps=200)
    sess = CheckpointSession(f"localfs:{tmp_path}", Policy(async_save=False))
    eng = sess.attach(ServingEngine.create(
        "phi4-mini-3.8b-smoke", params, n_slots=2, max_seq=32,
        manager=sess.manager, device="cpu"))
    reqs = fresh()
    for r in reqs:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    sess.snapshot(block=True)
    assert any(eng.slot_req)
    now = [0.0]
    sup = sess.supervise([0, 1], heartbeat_timeout=3.0,
                         clock=lambda: now[0],
                         restore_kwargs=lambda t: {
                             "params": params, "n_slots": len(t.hosts),
                             "device": "cpu"})
    for t in range(1, 8):
        now[0] = float(t)
        sup.beat(0, 4)
        if t < 3:
            sup.beat(1, 4)
    target = sup.poll()
    assert target.action is FailureAction.SHRINK
    return sess, sup, reqs, {r.rid: list(r.out) for r in ref}


def test_serving_shrink_reslot_token_identical(tmp_path):
    """A host death shrinks a 2-slot engine onto 1 slot through the
    re-slot restore; every request finishes with the uninterrupted run's
    tokens (the CPU's decode rows do not depend on the slot count)."""
    sess, sup, reqs, want = _serving_world(tmp_path)
    eng2 = sup.runner
    assert eng2.n_slots == 1
    finished = {r.rid: list(r.out) for r in reqs if r.done}
    live = eng2.live_requests()
    assert {r.rid for r in live} | set(finished) == set(want)
    eng2.run_until_drained(max_steps=200)
    assert {r.rid: list(r.out) for r in live} == \
        {rid: want[rid] for rid in (r.rid for r in live)}
    assert all(out == want[rid] for rid, out in finished.items())


def test_serving_grow_reslot_token_identical(tmp_path):
    """After the shrink onto 1 slot, the recovered host rejoins through
    ``grow`` and the sessions re-slot back onto 2 slots, token for
    token."""
    sess, sup, reqs, want = _serving_world(tmp_path)
    eng2 = sup.runner
    eng2.step()
    sess.snapshot(block=True)
    sup.policy.spares.append(1)
    gt = sup.grow()
    assert gt.action is FailureAction.GROW and gt.hosts == [0, 1]
    eng3 = sup.runner
    assert eng3.n_slots == 2
    finished = {r.rid: list(r.out) for r in reqs if r.done}
    finished.update({r.rid: list(r.out)
                     for r in eng2.live_requests() if r.done})
    live = eng3.live_requests()
    eng3.run_until_drained(max_steps=200)
    for r in live:
        assert r.done and r.out == want[r.rid], (r.rid, r.out, want[r.rid])
    assert all(out == want[rid] for rid, out in finished.items())


def test_a_restore_onto_a_larger_device_mesh_names_a9(tmp_path):
    """The port's runners live on one device: a restore hook whose
    ``mesh_factory`` builds more than one device raises
    ``NotImplementedError`` naming ROADMAP A9; one device passes."""
    assert one_device_mesh(lambda: torch.device("cpu"))() == \
        torch.device("cpu")
    assert one_device_mesh(lambda: [torch.device("cpu")])() == \
        torch.device("cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        one_device_mesh(lambda: np.empty((2, 1), object))()
    sess = CheckpointSession(f"localfs:{tmp_path}", Policy(async_save=False))
    tr = sess.attach(_trainer(sess.manager))
    sess.snapshot(block=True)
    now = [0.0]
    sup = sess.supervise([0, 1], heartbeat_timeout=3.0,
                         clock=lambda: now[0], restore_kwargs={
                             "mesh_factory": lambda: ["cpu", "cpu"]})
    for t in range(1, 8):
        now[0] = float(t)
        sup.beat(0, 0)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        sup.poll()
    assert tr.checkpoint_step() == 0


def test_supervised_restore_needs_the_card_unless_the_cpu_is_asked(
        tmp_path, monkeypatch):
    """``CheckpointSession.supervise`` rebuilds on the card by default:
    with no card and no ``device`` in the restore kwargs, the restore
    raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sess = CheckpointSession(f"localfs:{tmp_path}", Policy(async_save=False))
    sess.attach(_trainer(sess.manager))
    sess.snapshot(block=True)
    now = [0.0]
    sup = sess.supervise([0, 1], heartbeat_timeout=3.0,
                         clock=lambda: now[0])
    for t in range(1, 8):
        now[0] = float(t)
        sup.beat(0, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sup.poll()
