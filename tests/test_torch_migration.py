"""Live migration and traffic in the port (``repro_torch.core.migration``,
``repro_torch.serving.traffic``) against the JAX package's:

* a ``SessionBundle`` written by either package restores in the other
  (the same app kind ``serving-move`` and entries; the port's also
  carries each session's cache column, ROADMAP C23, which the JAX
  package reads past);
* ``FleetRouter`` migrate (whole and batched) and drain, with requests
  held for the draining engine, at phi4-mini-3.8b-smoke in float32 on
  the CPU, over the port's engines (params converted from the JAX init)
  and the JAX package's: the same tokens for every request, none
  dropped or duplicated, the same moves and replays;
* ``TrafficGenerator`` draws the same arrivals for the same seed, and
  the same seeded traffic through both fleets with a drain mid-way
  gives the same completed requests;
* the JAX package's other migration cases on the port (source
  liveness, a move racing the periodic snapshot chain, deadlines,
  refusals, planned moves), and the fleet launcher against the JAX
  package's with the same arguments.
"""
import re

import jax
import numpy as np
import pytest
import torch

import repro.configs.phi4_mini_3_8b as jphi
import repro_torch.configs.phi4_mini_3_8b as tphi
from repro.api import CheckpointSession as JSession
from repro.api import Policy as JPolicy
from repro.configs import get_smoke_config as j_smoke_config
from repro.core import migration as jmig
from repro.launch import fleet as jfleet
from repro.models import model as JM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving import traffic as jtraffic
from repro_torch import convert
from repro_torch.api import (CheckpointSession, FleetRouter, MigrationError,
                             Policy, PolicyError, UpperHalf,
                             register_app_kind)
from repro_torch.configs import get_smoke_config
from repro_torch.core import migration as tmig
from repro_torch.core.migration import SessionBundle, migrate_sessions
from repro_torch.core.supervisor import ClusterSupervisor, SupervisorError
from repro_torch.launch import fleet as tfleet
from repro_torch.models import model as TM
from repro_torch.serving import traffic as ttraffic
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.tree import flatten_with_paths

ARCH = "phi4-mini-3.8b"
MESH = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                         ("data", "model"))


@pytest.fixture(scope="module")
def models():
    """phi4-mini-3.8b-smoke in float32: the JAX init, and the same params
    converted for the port."""
    jcfg = j_smoke_config(ARCH).replace(dtype="float32")
    tcfg = get_smoke_config(ARCH).replace(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    return {"jax": (jcfg, jparams), "torch": (tcfg, tparams)}


def _engines(models, pkg, slots, max_seq=32):
    cfg, params = models[pkg]
    if pkg == "jax":
        return {n: JEngine(cfg, params, MESH, n_slots=s, max_seq=max_seq)
                for n, s in slots.items()}
    return {n: ServingEngine(cfg, params, "cpu", n_slots=s, max_seq=max_seq)
            for n, s in slots.items()}


def _router(models, pkg, slots, via, **kw):
    cls = jmig.FleetRouter if pkg == "jax" else tmig.FleetRouter
    return cls(_engines(models, pkg, slots), via=via, **kw)


def _prompts(vocab, n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=int(rng.randint(3, 8))).astype(
        np.int32) for _ in range(n)]


def _drain_all(router, rounds=200):
    for _ in range(rounds):
        if not router.inflight and not router._held:
            break
        router.step()
    assert router.dropped() == [] and router.duplicates == 0
    return {rid: list(r.out) for rid, r in sorted(router.completed.items())}


def _move_run(models, pkg, via, *, batch=None):
    """4 requests pinned to a 3-slot engine, 3 steps, then every live
    session (queue included) moved onto a 2-slot engine."""
    router = _router(models, pkg, {"a": 3, "b": 2}, via,
                     migrate_batch=batch)
    vocab = models[pkg][0].vocab_size
    rids = [router.submit(p, 6, engine="a") for p in _prompts(vocab, 4)]
    for _ in range(3):
        router.step()
    res = router.migrate("a", "b", include_queue=True)
    assert sorted(res.moved) == sorted(rids)
    assert not router.engines["a"].live_requests()
    out = _drain_all(router)
    return out, [int(b["n"]) for b in res.batches], res.replayed


@pytest.mark.parametrize("batch", [None, 1], ids=["whole", "batched"])
def test_fleet_migrate_matches_jax(models, tmp_path, batch):
    got = _move_run(models, "torch", f"localfs:{tmp_path}/t", batch=batch)
    want = _move_run(models, "jax", f"localfs:{tmp_path}/j", batch=batch)
    assert got == want
    assert all(len(v) == 6 for v in got[0].values())
    # and the same as the port's run with no move at all
    eng = _engines(models, "torch", {"a": 3})["a"]
    reqs = [Request(rid=i + 1, prompt=p, max_new=6) for i, p in
            enumerate(_prompts(models["torch"][0].vocab_size, 4))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_steps=200)
    assert got[0] == {r.rid: list(r.out) for r in reqs}


def _drain_run(models, pkg, via):
    router = _router(models, pkg, {"a": 2, "b": 2}, via)
    rid0 = router.submit(np.array([3, 5, 7], np.int32), 4, engine="a")
    router.step()
    router.drain("a", "b")
    rid1 = router.submit(np.array([2, 4], np.int32), 3, engine="a")
    held = router.stats()["held"]
    rid2 = router.submit(np.array([9, 9], np.int32), 3)
    res = router.migrate("a", "b")
    out = _drain_all(router)
    assert {rid0, rid1, rid2} <= set(out)
    return out, held, res.replayed, router.owner, sorted(router.draining)


def test_fleet_drain_matches_jax(models, tmp_path):
    got = _drain_run(models, "torch", f"localfs:{tmp_path}/t")
    want = _drain_run(models, "jax", f"localfs:{tmp_path}/j")
    assert got == want
    assert got[1] == 1 and got[2] == 1


@pytest.mark.parametrize("rate,seed,limit", [(2.0, 5, 9), (0.7, 1, 12),
                                             (3.5, 9, 20)])
def test_traffic_arrivals_match_jax(rate, seed, limit):
    class _Sink:
        def __init__(self):
            self.calls = []

        def submit(self, prompt, max_new):
            self.calls.append((list(prompt), max_new))
            return len(self.calls)

    a = ttraffic.TrafficGenerator(rate, seed=seed, vocab=256, limit=limit)
    b = jtraffic.TrafficGenerator(rate, seed=seed, vocab=256, limit=limit)
    sa, sb, ticks = _Sink(), _Sink(), []
    while not a.drained():
        ticks.append((a.tick(sa), b.tick(sb)))
    assert sa.calls == sb.calls and len(sa.calls) == limit
    assert all(x == y for x, y in ticks)
    assert {k: (list(v["prompt"]), v["max_new"]) for k, v in
            a.emitted.items()} == {k: (list(v["prompt"]), v["max_new"])
                                   for k, v in b.emitted.items()}


def _traffic_run(models, pkg, via):
    tmod = jtraffic if pkg == "jax" else ttraffic
    router = _router(models, pkg, {"e0": 2, "e1": 2}, via)
    gen = tmod.TrafficGenerator(1.5, seed=3, vocab=models[pkg][0].vocab_size,
                                limit=7, max_new=(4, 8))
    for step in range(1, 200):
        gen.tick(router)
        router.step()
        if step == 3:
            router.drain("e0", "e1")
        if gen.drained() and not router.inflight and not router._held:
            break
    return _drain_all(router), router.stats()["moves"]


def test_seeded_traffic_through_a_drain_matches_jax(models, tmp_path):
    got = _traffic_run(models, "torch", f"localfs:{tmp_path}/t")
    assert got == _traffic_run(models, "jax", f"localfs:{tmp_path}/j")
    assert len(got[0]) == 7 and got[1] == 1


# --- the bundle, across packages ---------------------------------------------------

BUNDLE = [(7, [3, 5, 8], 9, [2, 4]), (9, [1], 3, [])]


def _same(reqs):
    return [(int(r.rid), int(r.max_new), [int(x) for x in r.prompt],
             [int(x) for x in r.out]) for r in reqs]


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_session_bundle_restores_in_both_packages(tmp_path, writer, small):
    pol = dict(chain=1, async_save=False)
    store = f"localfs:{tmp_path}/chan"
    col = _engine(small, 1).session_columns()     # an empty engine: none
    if writer == "torch":
        reqs = [Request(rid=r, prompt=np.array(p, np.int32), max_new=m,
                        out=o) for r, p, m, o in BUNDLE]
        eng = _engine(small, 2)
        for r in reqs:
            eng.submit(Request(rid=r.rid, prompt=r.prompt, max_new=9))
        eng.step()
        col = eng.session_columns()
        assert sorted(col) == [7, 9]
        with CheckpointSession(store, Policy(**pol)) as chan:
            chan.attach(SessionBundle(reqs, source_step=42, columns=col))
            chan.snapshot(block=True)
    else:
        reqs = [JRequest(rid=r, prompt=np.array(p, np.int32), max_new=m,
                         out=o) for r, p, m, o in BUNDLE]
        with JSession(store, JPolicy(**pol)) as chan:
            chan.attach(jmig.SessionBundle(reqs, source_step=42))
            chan.snapshot(block=True)
    for session in (CheckpointSession, JSession):
        with session(store, (Policy if session is CheckpointSession
                             else JPolicy)(**pol)) as chan:
            back = chan.restore("latest", expect_kind="serving-move")
        assert back.source_step == 42
        assert _same(back.requests) == _same(reqs)
        if session is CheckpointSession:
            assert sorted(_engine(small, 3).carry(back.carried)) == \
                sorted(col)


# --- the JAX package's other migration cases, on the port -------------------------

@pytest.fixture(scope="module")
def small(models):
    return models["torch"]


def _engine(small, n_slots, max_seq=32):
    cfg, params = small
    return ServingEngine(cfg, params, "cpu", n_slots=n_slots,
                         max_seq=max_seq)


def test_source_serves_unaffected_slots_during_move(small):
    eng = _engine(small, 2)
    r0 = Request(rid=1, prompt=np.array([3, 5, 7], np.int32), max_new=20)
    r1 = Request(rid=2, prompt=np.array([2, 4, 6], np.int32), max_new=20)
    eng.submit(r0)
    eng.submit(r1)
    for _ in range(2):
        eng.step()
    s1 = eng.slot_req.index(r1)
    assert eng.extract_sessions([1 - s1]) == [r0]
    assert eng.slot_req[1 - s1] is None
    assert eng.slot_pos[1 - s1] == 0 and eng.slot_tok[1 - s1, 0] == 0
    before, moved_out = len(r1.out), list(r0.out)
    eng.step()
    assert len(r1.out) == before + 1 and r0.out == moved_out


def test_move_and_periodic_snapshot_share_the_engine(small, tmp_path):
    cfg, params = small
    sess = CheckpointSession(f"localfs:{tmp_path}/src",
                             Policy(interval=2, chain=3))
    src = ServingEngine.create(f"{ARCH}-smoke", params, n_slots=2,
                               max_seq=32, manager=sess.manager,
                               device="cpu")
    sess.attach(src)
    dst = _engine(small, 2)
    reqs = [Request(rid=i + 1, prompt=p, max_new=8)
            for i, p in enumerate(_prompts(cfg.vocab_size, 3, seed=1))]
    for r in reqs:
        src.submit(r)
    for _ in range(3):
        src.step()
        sess.maybe_snapshot()
    sess.snapshot()                      # async capture in flight...
    res = sess.migrate(dst, slots=[0])   # ...races the move
    assert len(res.moved) == 1
    moved_rid = res.moved[0]
    sess.wait()
    for _ in range(100):
        if not (src.live_requests() or dst.live_requests()):
            break
        src.step()
        dst.step()
        sess.maybe_snapshot()
    assert all(r.done for r in reqs if r.rid != moved_rid)
    assert all(r.done for r in res.requests)
    sess.wait()
    eng2 = sess.restore("latest", expect_kind="serving", params=params,
                        n_slots=2, device="cpu")
    assert moved_rid not in [r.rid for r in eng2.live_requests()]


def _moved_run(small, tmp_path):
    """3 requests served 3 steps on a 2-slot engine, then moved (queue
    included, unsettled) onto a 3-slot engine."""
    src, dst = _engine(small, 2), _engine(small, 3)
    reqs = [Request(rid=i + 1, prompt=p, max_new=6) for i, p in
            enumerate(_prompts(small[0].vocab_size, 3, seed=2))]
    for r in reqs:
        src.submit(r)
    for _ in range(3):
        src.step()
    before = src.session_columns([0, 1])
    res = migrate_sessions(src, dst, via=f"localfs:{tmp_path}",
                           include_queue=True, settle=False)
    return src, dst, reqs, before, res


def test_a_move_carries_each_sessions_cache_column(small, tmp_path):
    """The port's bundle carries every in-flight session's cache column
    (ROADMAP C23): it lands on the target with the source's bits, and
    the moved requests finish with the unmoved run's tokens."""
    src, dst, reqs, before, res = _moved_run(small, tmp_path)
    assert res.carried == 2 and sorted(before) == sorted(dst._carried)
    for rid, col in before.items():
        for (p, a), (_, b) in zip(flatten_with_paths(col),
                                  flatten_with_paths(dst._carried[rid])):
            assert torch.equal(a, b), (rid, p)
    ref = _engine(small, 2)
    want = [Request(rid=r.rid, prompt=r.prompt, max_new=6) for r in reqs]
    for r in want:
        ref.submit(r)
    ref.run_until_drained(max_steps=200)
    dst.run_until_drained(max_steps=200)
    assert {r.rid: list(r.out) for r in res.requests} == \
        {r.rid: list(r.out) for r in want}


def test_columns_that_do_not_fit_the_target_are_left_behind(small,
                                                             tmp_path):
    """A target with another ``max_seq`` cannot take the columns, and
    re-prefilling the histories instead need not give the decode steps'
    bits (ROADMAP C23): the move raises before the source gives anything
    up, and the source still finishes every request with the unmoved
    run's tokens."""
    src, dst = _engine(small, 2), _engine(small, 3, max_seq=48)
    reqs = [Request(rid=i + 1, prompt=p, max_new=6) for i, p in
            enumerate(_prompts(small[0].vocab_size, 3, seed=2))]
    for r in reqs:
        src.submit(r)
    for _ in range(3):
        src.step()
    with pytest.raises(MigrationError, match="do not fit"):
        migrate_sessions(src, dst, via=f"localfs:{tmp_path}",
                         include_queue=True, settle=False)
    assert not dst.live_requests() and not dst._carried
    assert [r.rid for r in src.live_requests()] == [1, 2, 3]
    ref = _engine(small, 2)
    want = [Request(rid=r.rid, prompt=r.prompt, max_new=6) for r in reqs]
    for r in want:
        ref.submit(r)
    ref.run_until_drained(max_steps=200)
    src.run_until_drained(max_steps=200)
    assert {r.rid: list(r.out) for r in reqs} == \
        {r.rid: list(r.out) for r in want}


@pytest.mark.parametrize("target_seq", [32, 48])
def test_carry_refuses_a_column_that_does_not_fit(small, tmp_path,
                                                  target_seq):
    """A bundle the port wrote carries its sessions' columns; restored
    onto an engine of another ``max_seq``, ``carry`` raises instead of
    re-admitting them from their histories; onto the same geometry it
    adopts every column."""
    eng = _engine(small, 2)
    reqs = [Request(rid=r, prompt=np.array([3, 5, 7], np.int32), max_new=9)
            for r in (4, 6)]
    for r in reqs:
        eng.submit(r)
    eng.step()
    pol = Policy(chain=1, async_save=False)
    with CheckpointSession(f"localfs:{tmp_path}/chan", pol) as chan:
        chan.attach(SessionBundle(reqs, source_step=1,
                                  columns=eng.session_columns()))
        chan.snapshot(block=True)
        back = chan.restore("latest", expect_kind="serving-move")
    dst = _engine(small, 3, max_seq=target_seq)
    if target_seq == 32:
        assert dst.carry(back.carried) == [4, 6]
    else:
        with pytest.raises(MigrationError, match=r"sessions \[4, 6\]"):
            dst.carry(back.carried)
        assert not dst._carried


def test_move_deadline_is_reported_not_silent(small, tmp_path):
    src, dst = _engine(small, 1), _engine(small, 1)
    src.submit(Request(rid=1, prompt=np.array([3, 5], np.int32), max_new=6))
    src.step()
    res = migrate_sessions(src, dst, via=f"localfs:{tmp_path}",
                           deadline_s=1e-9)
    assert not res.within_deadline and res.deadline_s == 1e-9


def test_policy_migration_knob_validation():
    with pytest.raises(PolicyError, match="drain_deadline_s"):
        Policy(drain_deadline_s=0)
    with pytest.raises(PolicyError, match="migrate_batch"):
        Policy(migrate_batch=0)
    p = Policy(drain_deadline_s=0.5, migrate_batch=2)
    assert (p.drain_deadline_s, p.migrate_batch) == (0.5, 2)


def test_migration_error_paths(small, tmp_path):
    sess = CheckpointSession(f"localfs:{tmp_path}/s")
    with pytest.raises(PolicyError, match="no app attached"):
        sess.migrate(_engine(small, 1))
    eng = _engine(small, 1)
    with pytest.raises(MigrationError, match="extract_sessions"):
        migrate_sessions(object(), eng, via=f"localfs:{tmp_path}")
    with pytest.raises(MigrationError, match="unknown engine"):
        FleetRouter({"a": eng}, via=f"localfs:{tmp_path}") \
            .migrate("a", "nope")
    with pytest.raises(MigrationError, match="itself"):
        FleetRouter({"a": eng}, via=f"localfs:{tmp_path}") \
            .migrate("a", "a")
    with pytest.raises(MigrationError, match="at least one engine"):
        FleetRouter({}, via=f"localfs:{tmp_path}")


def test_planned_move_keeps_vid_stable_and_recycles_the_host():
    sup = ClusterSupervisor([0, 1, 2], spares=[7])
    logical = sup.hostmap.logical_of(1)
    vid = sup.hostmap.vid(logical)
    target = sup.planned_move(1)
    assert sup.world == [0, 7, 2]
    assert sup.hostmap.logical_of(7) == logical
    assert sup.hostmap.logical_of(1) is None
    assert sup.hostmap.vid(logical) is vid
    assert sup.policy.spares == [1]
    assert sorted(sup.monitor.hosts) == [0, 2, 7]
    assert target.mapping == {1: 7}
    inc = sup.incidents[-1]
    assert inc.action == "planned_move" and inc.dead == []


def test_planned_move_rejects_bad_worlds():
    sup = ClusterSupervisor([0, 1], spares=[5])
    with pytest.raises(SupervisorError, match="not part of this job"):
        sup.planned_move(9)
    with pytest.raises(SupervisorError, match="already serves"):
        sup.planned_move(0, to=1)
    with pytest.raises(SupervisorError, match="empty the world"):
        ClusterSupervisor([0]).planned_move(0)


class _Counter:
    """Minimal CheckpointableApp for the planned-drain (shrink) path."""
    kind = "torch-migration-test-counter"

    def __init__(self, step=0):
        self.step = step

    def checkpoint_state(self):
        up = UpperHalf()
        up.register("step", "step", np.int64(self.step))
        return up

    def checkpoint_step(self):
        return self.step

    def job_meta(self):
        return {"kind": self.kind}

    def bind(self, restore):
        self.step = int(restore.scalar("step"))
        restore.release()


@register_app_kind(_Counter.kind, replace=True)
def _restore_counter(restore):
    app = _Counter()
    app.bind(restore)
    return app


def test_planned_drain_without_spare_shrinks_on_purpose(tmp_path):
    sess = CheckpointSession(f"localfs:{tmp_path}/job",
                             Policy(async_save=False))
    app = sess.attach(_Counter(step=3))
    sess.snapshot(block=True)
    sup = sess.supervise([0, 1], spares=[], heartbeat_timeout=3.0)
    target = sup.planned_move(1)
    assert sup.world == [0]
    assert target.hosts == [0] and target.step == 3
    assert sup.runner is not app and sup.runner.step == 3
    assert sup.incidents[-1].action == "planned_drain"


def test_fleet_launcher_matches_jax(monkeypatch, capsys, tmp_path):
    """``repro_torch.launch.fleet --migrate`` against the JAX package's
    launcher with the same arguments (phi4-mini-3.8b-smoke in float32,
    the port's launcher building the JAX init's params in place of its
    seeded init): the same moves and the same
    completed, dropped and duplicated counts."""
    for mod in (jphi, tphi):
        plain = mod.smoke_config
        monkeypatch.setattr(mod, "smoke_config",
                            lambda plain=plain: plain().replace(
                                dtype="float32"))
    argv = ["--arch", "phi4-mini-3.8b-smoke", "--engines", "2", "--slots",
            "2", "--max-seq", "32", "--rate", "1.5", "--requests", "5",
            "--seed", "3", "--migrate", "e0:e1@3"]
    assert jfleet.main(argv + ["--store", f"localfs:{tmp_path}/j"]) == 0
    jout = capsys.readouterr().out
    params = convert.params_from_numpy(jax.tree.map(
        np.asarray, JM.init_params(jphi.smoke_config(),
                                   jax.random.PRNGKey(3))), "cpu")
    monkeypatch.setattr(TM, "init_params", lambda cfg, seed, device: params)
    assert tfleet.main(argv + ["--store", f"localfs:{tmp_path}/t",
                               "--device", "cpu"]) == 0
    tout = capsys.readouterr().out

    def summary(out):
        moved = re.findall(r"migrate e0 -> e1: (\d+) sessions moved", out)
        tail = re.findall(r"\[fleet\] (\d+) requests, (\d+) tokens in .* "
                          r"\((\d+) completed, (\d+) dropped, (\d+) "
                          r"duplicated, (\d+) moves", out)
        return moved, tail
    assert summary(tout) == summary(jout)
    assert summary(tout)[1][0][3:5] == ("0", "0")
