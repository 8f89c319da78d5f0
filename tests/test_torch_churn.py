"""The churn subsystem of the port (``repro_torch.core.churn``) against
the JAX package's (``repro.core.churn``), and on the port's trainer:

* ``ChurnTrace.poisson``, ``correlated_racks`` and ``from_spec`` write
  byte-equal JSONL in both packages for the same seeds, and
  ``parse_churn_spec`` parses (and refuses) alike;
* a ``ChurnEngine`` run over the RL actor-learner app (the JAX
  package's ``examples/rl_actor_learner.py`` and the port's twin
  ``repro_torch.examples.rl_actor_learner``) writes byte-equal incident
  logs and an equal ``GoodputReport`` (wall-clock fields left out), and
  ends on the same app digest;
* the four cases of ``tests/test_churn.py`` that fail in the JAX
  package under jax 0.9 (ROADMAP C4) run on the port's trainer, each
  held against the port's own uninterrupted run.
"""
import json
import os
import sys

import pytest

from repro.api import CheckpointSession as JSession
from repro.api import Policy as JPolicy
from repro.core import churn as jc
from repro_torch.api import CheckpointSession, Policy
from repro_torch.core import churn as tc
from repro_torch.core.churn import (ChurnEngine, ChurnEvent, ChurnTrace,
                                    IncidentLog, read_incident_log)
from repro_torch.examples import rl_actor_learner as trl
from repro_torch.train.loop import Trainer, TrainJob

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import rl_actor_learner as jrl  # noqa: E402  (registers its app kind)

HOSTS = [0, 1, 2, 3]


# --- traces: byte-equal in both packages ----------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 11])
@pytest.mark.parametrize("kw", [
    dict(rate=0.4, horizon=50, preempt=0.5, grace=3.0, return_after=6.0),
    dict(rate=0.25, horizon=14, preempt=0.5, grace=3.0, return_after=5.0),
    dict(rate=2.0, horizon=10_000, max_events=50),
    dict(rate=0.1, horizon=100, preempt=1.0, return_after=None),
], ids=["mixed", "short", "capped", "preempt-only"])
def test_poisson_trace_is_byte_equal(seed, kw):
    a = tc.ChurnTrace.poisson(HOSTS, seed=seed, **kw).to_jsonl()
    assert a and a == jc.ChurnTrace.poisson(HOSTS, seed=seed, **kw).to_jsonl()


@pytest.mark.parametrize("seed", [0, 5, 9])
@pytest.mark.parametrize("rack_size", [1, 2, 3])
def test_correlated_racks_trace_is_byte_equal(seed, rack_size):
    kw = dict(rate=0.2, rack_size=rack_size, seed=seed, horizon=40)
    hosts = [0, 1, 2, 3, 4, 5]
    a = tc.ChurnTrace.correlated_racks(hosts, **kw).to_jsonl()
    assert a and a == jc.ChurnTrace.correlated_racks(hosts, **kw).to_jsonl()


SPECS = ["poisson:rate=0.1,seed=1", "poisson:rate=0.3,seed=4,preempt=0.2,"
         "grace=2,return=5,events=12", "racks:rate=0.05,size=2,seed=1",
         "racks:rate=0.5,size=3,seed=2,horizon=30,return=4"]


@pytest.mark.parametrize("spec", SPECS)
def test_from_spec_is_byte_equal(spec):
    assert tc.parse_churn_spec(spec) == jc.parse_churn_spec(spec)
    a = tc.ChurnTrace.from_spec(spec, HOSTS, horizon=60.0).to_jsonl()
    assert a == jc.ChurnTrace.from_spec(spec, HOSTS, horizon=60.0).to_jsonl()


@pytest.mark.parametrize("spec", ["storm:rate=1", "poisson:seed=1",
                                  "poisson:rate=x", "racks:rate=1,grace=2",
                                  "poisson:rate"])
def test_bad_specs_are_refused_alike(spec):
    with pytest.raises(ValueError) as te:
        tc.parse_churn_spec(spec)
    with pytest.raises(ValueError) as je:
        jc.parse_churn_spec(spec)
    assert str(te.value) == str(je.value)


def test_trace_jsonl_roundtrips_across_packages(tmp_path):
    trace = tc.ChurnTrace([
        tc.ChurnEvent(t=3, kind="preempt", host=1, grace_s=2.5),
        tc.ChurnEvent(t=1, kind="die", host=0),
        tc.ChurnEvent(t=9, kind="return", host=0),
        tc.ChurnEvent(t=5, kind="drain", host=2)])
    trace.save(tmp_path / "t.jsonl")
    back = jc.ChurnTrace.load(tmp_path / "t.jsonl")
    assert back.to_jsonl() == trace.to_jsonl()
    assert tc.ChurnTrace.from_jsonl(back.to_jsonl()).to_jsonl() == \
        trace.to_jsonl()


# --- the engine over the RL app, in both packages --------------------------------

RL_STEPS = 24
RL_TRACES = {
    "preempt-die-return-drain": lambda m: m.ChurnTrace([
        m.ChurnEvent(t=3, kind="preempt", host=2, grace_s=3.0),
        m.ChurnEvent(t=6, kind="die", host=1),
        m.ChurnEvent(t=10, kind="return", host=1),
        m.ChurnEvent(t=14, kind="drain", host=0),
        m.ChurnEvent(t=16, kind="preempt", host=3, grace_s=0.5)]),
    # seed 1 hot-spares, shrinks, drains and grows; seed 5 also restarts
    "poisson-1": lambda m: m.ChurnTrace.poisson(
        HOSTS, rate=0.3, seed=1, horizon=RL_STEPS, preempt=0.5, grace=3.0,
        return_after=5.0),
    "poisson-5": lambda m: m.ChurnTrace.poisson(
        HOSTS, rate=0.3, seed=5, horizon=RL_STEPS, preempt=0.5, grace=3.0,
        return_after=5.0),
    "racks": lambda m: m.ChurnTrace.correlated_racks(
        HOSTS, rate=0.15, rack_size=2, seed=2, horizon=RL_STEPS,
        return_after=4.0),
}


def _rl_churn(session_cls, policy_cls, mod, rl, store, log, trace, spares):
    sess = session_cls(store, policy_cls(interval=4, async_save=False))
    app = sess.attach(rl.RLActorLearner(n_actors=4, n_streams=8, dim=16,
                                        seed=5))
    engine = mod.ChurnEngine(trace, snapshot=lambda: sess.snapshot(
        block=True))
    sink = mod.IncidentLog(log)
    sup = sess.supervise(list(HOSTS), spares=list(spares),
                         heartbeat_timeout=3.0, clock=engine.clock,
                         n_shards=8, event_sink=sink,
                         restore_kwargs=lambda t: {"n_actors": len(t.hosts)})
    engine.attach(sup)
    sess.snapshot(block=True)
    step = app.t
    while step < RL_STEPS:
        app = sup.runner
        app.collect_and_learn(1)
        step = app.t
        sess.maybe_snapshot()
        if engine.tick(step):
            step = sup.runner.t
    sink.close()
    sess.close()
    rep = engine.report().to_json()
    for k in ("wall_s", "steps_per_s"):
        rep.pop(k)
    for row in rep["incidents"]:
        row.pop("wall_s")
    return rep, sup.runner.digest(), sup.world, sup.policy.spares


@pytest.mark.parametrize("spares", [[], [7]], ids=["no-spare", "one-spare"])
@pytest.mark.parametrize("name", sorted(RL_TRACES))
def test_churn_engine_on_the_rl_app_matches_jax(tmp_path, name, spares):
    """The same trace through both packages' supervisor, churn engine and
    RL app: byte-equal incident logs, the same goodput report and the
    same final weights."""
    got = _rl_churn(CheckpointSession, Policy, tc, trl,
                    f"localfs:{tmp_path}/t", tmp_path / "t.jsonl",
                    RL_TRACES[name](tc), spares)
    want = _rl_churn(JSession, JPolicy, jc, jrl,
                     f"localfs:{tmp_path}/j", tmp_path / "j.jsonl",
                     RL_TRACES[name](jc), spares)
    assert got == want
    assert got[0]["incidents"], "the trace must exercise the failure loop"
    assert (tmp_path / "t.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()
    ref = trl.RLActorLearner(n_actors=1, n_streams=8, dim=16, seed=5)
    ref.collect_and_learn(RL_STEPS)
    assert got[1] == ref.digest()


# --- the JAX package's C4 cases, on the port's trainer -----------------------------

JOB = TrainJob(arch="starcoder2-3b-matrix", shape_key="train_s8_b2")
STEPS = 14


@pytest.fixture(scope="module")
def oracle():
    t = Trainer(JOB, device="cpu")
    t.init_state()
    for _ in range(STEPS):
        t.train_steps(1)
    return t.params_digest()


def _supervised(tmp_path, trace, *, hosts, spares=(), steps=STEPS,
                sink=None, min_grace=1.0):
    sess = CheckpointSession(f"localfs:{tmp_path}",
                             Policy(interval=4, async_save=False))
    tr = sess.attach(Trainer(JOB, manager=sess.manager, device="cpu"))
    tr.init_state()
    engine = ChurnEngine(trace, min_grace=min_grace,
                         snapshot=lambda: sess.snapshot(block=True))
    sup = sess.supervise(list(hosts), spares=list(spares),
                         heartbeat_timeout=3.0, clock=engine.clock,
                         n_shards=tr.shape.global_batch, event_sink=sink,
                         restore_kwargs={"device": "cpu"})
    engine.attach(sup)
    sess.snapshot(block=True)
    step = tr.checkpoint_step()
    while step < steps:
        tr = sup.runner
        tr.train_steps(1)
        step = tr.checkpoint_step()
        sess.maybe_snapshot(final=step == steps)
        if engine.tick(step):
            step = sup.runner.checkpoint_step()
    sess.wait()
    return sess, sup, engine


def test_graceful_preempt_avoids_timeout_and_grow_reuses_return(
        tmp_path, oracle):
    """Port counterpart of ``tests/test_churn.py::
    test_graceful_preempt_avoids_timeout_and_grow_reuses_return`` (C4):
    a preemption with enough grace drains proactively, a death shrinks
    the world, the returned host is grown back in, and the trainer ends
    bit-identical to its uninterrupted run."""
    trace = ChurnTrace([
        ChurnEvent(t=3, kind="preempt", host=2, grace_s=3.0),
        ChurnEvent(t=6, kind="die", host=1),
        ChurnEvent(t=10, kind="return", host=1),
    ])
    sess, sup, engine = _supervised(tmp_path, trace, hosts=[0, 1, 2])
    rep = engine.report()
    actions = [r["action"] for r in rep.incidents]
    assert rep.proactive_preempts == 1
    assert "planned_drain" in actions
    assert all(2 not in r["dead"] for r in rep.incidents)
    assert any(r["dead"] == [1] for r in rep.incidents)
    assert rep.grows >= 1
    assert 1 in sup.world
    assert sup.runner.params_digest() == oracle
    assert rep.useful_steps == STEPS
    assert rep.attempted_steps >= rep.useful_steps
    assert rep.lost_steps == rep.attempted_steps - rep.useful_steps
    assert 0.0 < rep.goodput <= 1.0
    sess.close()


def test_insufficient_grace_degrades_to_timeout_death(tmp_path, oracle):
    """Port counterpart of ``tests/test_churn.py::
    test_insufficient_grace_degrades_to_timeout_death`` (C4): a notice
    shorter than ``min_grace`` is a death at its deadline, counted as a
    degraded preemption; the trainer ends bit-identical."""
    trace = ChurnTrace([
        ChurnEvent(t=4, kind="preempt", host=1, grace_s=0.25),
    ])
    sess, sup, engine = _supervised(tmp_path, trace, hosts=[0, 1])
    rep = engine.report()
    assert rep.degraded_preempts == 1
    assert rep.proactive_preempts == 0
    assert any(r["dead"] == [1] for r in rep.incidents)
    assert sup.runner.params_digest() == oracle
    sess.close()


def test_seeded_poisson_trace_end_to_end(tmp_path, oracle):
    """Port counterpart of ``tests/test_churn.py::
    test_seeded_poisson_trace_end_to_end`` (C4): the same seeded Poisson
    trace over 3 hosts and a spare; the trainer ends bit-identical to
    its uninterrupted run."""
    trace = ChurnTrace.poisson([0, 1, 2], rate=0.25, seed=7,
                               horizon=STEPS, preempt=0.5, grace=3.0,
                               return_after=5.0)
    assert len(trace) > 0
    sess, sup, engine = _supervised(tmp_path, trace, hosts=[0, 1, 2],
                                    spares=[7])
    assert sup.runner.params_digest() == oracle
    assert engine.report().useful_steps == STEPS
    sess.close()


def test_incident_log_matches_event_stream(tmp_path, oracle):
    """Port counterpart of ``tests/test_churn.py::
    test_incident_log_matches_event_stream`` (C4): the JSONL sink holds
    the supervisor's event stream event for event, in order."""
    trace = ChurnTrace([
        ChurnEvent(t=3, kind="die", host=1),
        ChurnEvent(t=9, kind="return", host=1),
    ])
    path = tmp_path / "incidents.jsonl"
    sink = IncidentLog(path)
    sess, sup, engine = _supervised(tmp_path / "store", trace,
                                    hosts=[0, 1], sink=sink)
    sink.close()
    logged = read_incident_log(path)
    assert len(logged) == len(sup.events)
    for row, (t, kind, detail) in zip(logged, sup.events):
        assert row["t"] == t
        assert row["event"] == kind
        for k, v in detail.items():
            got = row[k]
            got = tuple(map(tuple, got)) if k == "assignment" else got
            assert got == v or str(v) == got, (kind, k, got, v)
    kinds = [r["event"] for r in logged]
    assert "decision" in kinds and "host_return" in kinds \
        and "restored" in kinds
    assert sup.runner.params_digest() == oracle
    sess.close()


def test_engine_spare_death_and_absent_drain_are_absorbed(tmp_path):
    """A spare dying leaves the pool, draining an absent host is a
    logged no-op, preempting a spare reclaims it (as the JAX package's
    case of the same name)."""
    trace = ChurnTrace([
        ChurnEvent(t=2, kind="die", host=7),
        ChurnEvent(t=3, kind="drain", host=9),
        ChurnEvent(t=4, kind="preempt", host=8, grace_s=5.0),
    ])
    sess, sup, engine = _supervised(tmp_path, trace, hosts=[0, 1],
                                    spares=[7, 8], steps=8)
    assert sup.policy.spares == []
    assert sup.world == [0, 1]
    kinds = [k for _, k, _ in sup.events]
    assert {"spare_lost", "drain_skipped", "spare_preempted"} <= set(kinds)
    assert engine.report().incidents == []
    sess.close()


def test_incident_log_lines_are_json(tmp_path):
    log = IncidentLog(tmp_path / "l.jsonl")
    log(1.0, "decision", {"action": "shrink", "dead": [2]})
    log.close()
    assert [json.loads(x) for x in
            (tmp_path / "l.jsonl").read_text().splitlines()] == \
        [{"t": 1.0, "event": "decision", "action": "shrink", "dead": [2]}]
