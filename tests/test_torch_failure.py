"""The failure-detection layer of the port (``repro_torch.core.failure``)
against the JAX package's (``repro.core.failure``), on the same inputs:

* ``FailurePolicy.decide`` over a grid of worlds, spare pools, shrink
  permissions and dead sets — the same action and detail;
* ``HeartbeatMonitor`` under an injected fake clock, fed the same
  seeded beat script — the same dead and alive hosts and per-host state
  after every tick;
* ``StragglerDetector.stragglers`` over the same monitors;
* ``rebalance_shards`` over a grid of shard counts and worlds.
"""
import itertools

import numpy as np
import pytest

from repro.core import failure as jf
from repro_torch.core import failure as tf

WORLDS = [[0], [0, 1], [0, 1, 2], [0, 1, 2, 3], [3, 5, 7, 9, 11]]
SPARES = [[], [20], [20, 21]]


def _dead_sets(world):
    """Every dead set of size 0 to 3, plus the whole world."""
    out = [list(c) for n in range(min(3, len(world)) + 1)
           for c in itertools.combinations(world, n)]
    return out + ([list(world)] if len(world) > 3 else [])


@pytest.mark.parametrize("allow_shrink", [True, False])
@pytest.mark.parametrize("spares", SPARES, ids=lambda s: f"spares{len(s)}")
@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"world{len(w)}")
def test_decide_matches_jax(world, spares, allow_shrink):
    jp = jf.FailurePolicy(spares=list(spares), allow_shrink=allow_shrink)
    tp = tf.FailurePolicy(spares=list(spares), allow_shrink=allow_shrink)
    for dead in _dead_sets(world):
        ja, ji = jp.decide(list(dead), world=list(world))
        ta, ti = tp.decide(list(dead), world=list(world))
        assert (ta.value, ti) == (ja.value, ji), (world, spares, dead)


def test_failure_actions_match_jax():
    assert [a.value for a in tf.FailureAction] == \
        [a.value for a in jf.FailureAction]


def _beat_script(seed, hosts, ticks):
    """Which hosts beat at each tick (a slow host beats every third
    tick, one host falls silent half way), and the step each reports."""
    rng = np.random.RandomState(seed)
    slow = hosts[int(rng.randint(len(hosts)))]
    silent = hosts[int(rng.randint(len(hosts)))]
    script, steps = [], dict.fromkeys(hosts, 0)
    for t in range(ticks):
        beats = []
        for h in hosts:
            if h == silent and t >= ticks // 2:
                continue
            if h == slow and t % 3:
                continue
            if rng.random_sample() < 0.9:
                steps[h] += 1 + int(rng.randint(2))
                beats.append((h, steps[h]))
        script.append(beats)
    return script


def _state(mon):
    return {h: (s.last_heartbeat, s.last_step, s.step_ewma, s.alive)
            for h, s in mon.hosts.items()}


@pytest.mark.parametrize("timeout", [1.0, 3.0, 60.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_heartbeat_monitor_and_stragglers_match_jax(seed, timeout):
    hosts = [0, 1, 2, 3, 4]
    now = [0.0]
    clock = lambda: now[0]           # noqa: E731 — the injected clock
    jm = jf.HeartbeatMonitor(hosts, timeout=timeout, clock=clock)
    tm = tf.HeartbeatMonitor(hosts, timeout=timeout, clock=clock)
    dets = [(jf.StragglerDetector(jm, k=k), tf.StragglerDetector(tm, k=k))
            for k in (1.5, 2.0)]
    flagged = 0
    for beats in _beat_script(seed, hosts, ticks=30):
        now[0] += 1.0
        for h, step in beats:
            jm.beat(h, step)
            tm.beat(h, step)
        assert tm.dead_hosts() == jm.dead_hosts()
        assert tm.alive_hosts() == jm.alive_hosts()
        assert _state(tm) == _state(jm)
        for jd, td in dets:
            assert td.stragglers() == jd.stragglers()
            flagged += len(jd.stragglers())
    if timeout < 15:                 # the host silent since tick 15
        assert jm.dead_hosts()
    assert flagged > 0               # the script does make a straggler


@pytest.mark.parametrize("n_shards", [1, 2, 4, 7, 8, 16])
def test_rebalance_shards_matches_jax(n_shards):
    for hosts in ([0], [0, 1], [2, 0, 1], [0, 7, 2, 3], [5, 4, 3, 2, 1]):
        assert tf.rebalance_shards(n_shards, list(hosts)) == \
            jf.rebalance_shards(n_shards, list(hosts))
