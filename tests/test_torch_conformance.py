"""The reference conformance matrix's failure modes on the port.

``tests/conformance`` holds the JAX package to five modes through its
public API; this file runs the same sequences (the reference's function
for each in parentheses) through ``repro_torch.api`` alone, for the
attention, moe (top-1 with a shared expert, and top-k), ssm and
encoder-decoder families (their ``Trainer`` at ``-smoke``; whisper's
batches carry encoder frames) and the rglru family (its serving engine
at ``-smoke``; its trainer's chains are in ``test_torch_hybrid_train.py``),
plus the serving engines of the moe family (prefill
admission, whose bucket sets the experts' capacity), of the ssm family
and of the encoder-decoder (whose cache holds the cross-attention tuple
``['cross'][0]``/``[1]``), whose admissions replay:

  kill      snapshot cadence -> drop the app -> restore latest ->
            continue -> the uninterrupted run's digest; then the same
            step restored *streamed* (hot tier eager, cold leaves paged
            in on first touch) -> the same digest (``run_kill``)
  commit    the last commit torn between its blob writes and its
            manifest rename, byte for byte (``tear_last_commit``) ->
            reopen -> the torn step is invisible, the one before
            restores and continues bit-identically, the store still
            commits (``run_commit``)
  swap      the kill sequence under ``localfs:`` and ``sharded:`` —
            one spec string apart — with equal digests (``run_swap``)
  degraded  one host of a replicated ``sharded:`` store lost after the
            commit; the streamed restore reads around it, and the eager
            restore agrees (``run_degraded``)
  midchain  an app whose state grows mid-run, so an entry first appears
            in a delta link, restores eager and streamed
            (``run_midchain``)
  reslot    an engine snapshotted with work in flight, hard-killed and
            restored onto 3 slots from 2 (each former in-flight session
            lands its checkpointed cache column in its new slot, a
            waiting request is admitted from its prompt) -> every
            request's tokens as the uninterrupted run's
            (``run_reslot``), for every engine drive; the third-party
            app restored onto 3 actors from 2 -> the uninterrupted
            digest
  shrink    ``CheckpointSession.supervise`` over 3 virtual hosts detects
            a silent host, decides SHRINK and restores onto the 2
            survivors — a trainer with its logged data reassignment
            rewritten onto them, an engine onto ``len(hosts)`` slots, the
            third-party app onto as many actors — and the continuation
            is bit-identical (``run_shrink``)
  churn-grow the same shrink, one step of progress snapshotted on the
            survivors, then ``grow`` re-admits the host: the rebuild
            from the newer step continues bit-identically (an engine,
            re-slotted onto 3 slots, to the uninterrupted run's tokens)
            (``run_churn_grow``)

The JAX families (``tests/conformance/families.py``) build JAX apps, so
the port builds its own specs here. The ``thirdparty`` family is the
port's twin of the JAX package's ``examples/rl_actor_learner.py``
(``repro_torch.examples.rl_actor_learner``), whose uninterrupted digest
is the JAX example's.
Every digest covers the complete semantic state: a trainer's params,
moments, step and data cursor; an engine's cache bytes, slot
bookkeeping, every request's tokens and its step count.
"""
import functools
import glob
import hashlib
import os
import sys
from dataclasses import dataclass
from typing import Any, Callable, Dict

import numpy as np
import pytest
import torch

from repro_torch.api import (CheckpointSession, Policy, UpperHalf,
                             parse_store_spec, register_app_kind)
from repro_torch.configs import resolve_config
from repro_torch.examples import rl_actor_learner as trl
from repro_torch.models import model as M
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.train.loop import Trainer, TrainJob
from repro_torch.tree import flatten_with_paths

SHAPE_KEY = "train_s8_b2"
N_SHARDS = 2                          # == global_batch (data-layout law)


@dataclass(frozen=True)
class Drive:
    """How to run one family's stateful workload (the reference's
    ``TrainDrive``): ``advance`` is deterministic given the app's state
    alone; ``digest`` hashes every semantic entry."""
    family: str
    fresh: Callable[[], Any]
    advance: Callable[[Any, int], None]
    digest: Callable[[Any], str]
    step_of: Callable[[Any], int]
    restore_kwargs: Callable[[], Dict[str, Any]]
    total: int = 6
    interval: int = 2
    # the shrink modes (the reference's ``ShrinkDrive``): the binder's
    # kwargs for a target's surviving hosts, the data shards the
    # supervisor balances, a hook before the run and a check after the
    # shrink's rebuild
    shrink_kwargs: Callable[[Any], Dict[str, Any]] = lambda target: {}
    n_shards: Any = None
    prepare: Any = None
    check: Any = None


# --- trainer side ---------------------------------------------------------------

def _trainer_drive(family: str, arch: str) -> Drive:
    def fresh():
        t = Trainer(TrainJob(arch=arch, shape_key=SHAPE_KEY), device="cpu")
        t.init_state()
        return t
    return Drive(family=family, fresh=fresh,
                 advance=lambda t, n: t.train_steps(n),
                 digest=lambda t: t.state_digest(),
                 step_of=lambda t: t.checkpoint_step(),
                 restore_kwargs=lambda: {"device": "cpu"},
                 n_shards=N_SHARDS,
                 prepare=lambda t: t.apply_reassignment(
                     _round_robin((0, 1, 2))),
                 check=_check_shrink_assignment)


def _round_robin(hosts):
    return [(hosts[i % len(hosts)], i) for i in range(N_SHARDS)]


def _check_shrink_assignment(t2, target) -> None:
    # the logged DataReassign was rewritten onto the survivors on replay
    got = sorted(map(tuple, t2.lower.data_assignment))
    want = sorted(_round_robin(tuple(target.hosts)))
    assert got == want, f"shard assignment {got}, wanted {want}"


# --- serving side -----------------------------------------------------------------

_SLOTS, _MAX_SEQ, _N_REQS, _MAX_NEW = 2, 32, 3, 6


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    return M.init_params(resolve_config(arch), seed=0, device="cpu")


def _fresh_engine(arch: str) -> ServingEngine:
    eng = ServingEngine.create(arch, _params(arch), n_slots=_SLOTS,
                               max_seq=_MAX_SEQ, device="cpu")
    rng = np.random.RandomState(7)
    vocab = resolve_config(arch).vocab_size
    for i in range(_N_REQS):
        eng.submit(Request(rid=i, prompt=rng.randint(
            0, vocab, size=4 + 2 * i).astype(np.int32), max_new=_MAX_NEW))
    return eng


def _advance_engine(eng: ServingEngine, n: int) -> None:
    for _ in range(n):
        eng.step()


def _digest_engine(eng: ServingEngine) -> str:
    h = hashlib.blake2b(digest_size=16)
    for path, t in sorted(flatten_with_paths(eng.cache)):
        h.update(path.encode())
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    h.update(np.asarray(eng.slot_pos, np.int32).tobytes())
    h.update(np.asarray(eng.slot_tok, np.int32).tobytes())
    for where, reqs in (("slots", eng.slot_req), ("queue", eng.queue)):
        for r in reqs:
            h.update(where.encode())
            h.update(b"-" if r is None else
                     f"{r.rid}:{r.max_new}:{list(r.out)}".encode())
    h.update(str(eng.steps).encode())
    return h.hexdigest()


def _check_slots(eng, target) -> None:
    assert eng.n_slots == len(target.hosts), \
        f"restored onto {eng.n_slots} slots, wanted {len(target.hosts)}"


def _engine_drive(family: str, arch: str) -> Drive:
    return Drive(family=family, fresh=lambda: _fresh_engine(arch),
                 advance=_advance_engine, digest=_digest_engine,
                 step_of=lambda e: e.steps,
                 restore_kwargs=lambda: {"params": _params(arch),
                                         "device": "cpu"},
                 shrink_kwargs=lambda target: {"n_slots": len(target.hosts)},
                 check=_check_slots)


# --- the third-party app ---------------------------------------------------------

def _fresh_rl():
    return trl.RLActorLearner(n_actors=2, n_streams=8, dim=16, seed=5)


def _check_actors(app, target) -> None:
    assert app.n_actors == len(target.hosts), \
        f"restored onto {app.n_actors} actors, wanted {len(target.hosts)}"


THIRD_PARTY = Drive(family="thirdparty", fresh=_fresh_rl,
                    advance=lambda a, n: a.collect_and_learn(n),
                    digest=lambda a: a.digest(), step_of=lambda a: a.t,
                    restore_kwargs=dict,
                    shrink_kwargs=lambda target: {
                        "n_actors": len(target.hosts)},
                    check=_check_actors)


DRIVES = {
    "attention": _trainer_drive("attention", "starcoder2-3b-smoke"),
    "moe": _trainer_drive("moe", "llama4-scout-17b-a16e-smoke"),
    "moe-topk": _trainer_drive("moe-topk", "kimi-k2-1t-a32b-smoke"),
    "moe-serving": _engine_drive("moe-serving",
                                 "llama4-scout-17b-a16e-smoke"),
    "ssm": _trainer_drive("ssm", "mamba2-780m-smoke"),
    "rglru": _engine_drive("rglru", "recurrentgemma-9b-smoke"),
    "ssm-serving": _engine_drive("ssm-serving", "mamba2-780m-smoke"),
    "encdec": _trainer_drive("encdec", "whisper-base-smoke"),
    "encdec-serving": _engine_drive("encdec-serving", "whisper-base-smoke"),
    "thirdparty": THIRD_PARTY,
}


@functools.lru_cache(maxsize=None)
def reference_digest(family: str) -> str:
    """The uninterrupted run's digest, once per family."""
    dr = DRIVES[family]
    app = dr.fresh()
    dr.advance(app, dr.total)
    return dr.digest(app)


def _store(backend: str, tmp_path, tag: str = "s") -> str:
    if backend == "localfs":
        return f"localfs:{tmp_path}/{tag}"
    if backend == "sharded":
        return f"sharded:{tmp_path}/{tag}?hosts=3"
    return f"sharded:{tmp_path}/{tag}?hosts=3&replicate=1"


# --- the modes ------------------------------------------------------------------

def tear_last_commit(store: str) -> int:
    """Recreate the crash-during-commit disk state, byte for byte: blobs
    are written first, then the manifest through temp file + fsync +
    rename, so a crash between them leaves the manifest as an
    uncommitted temp file. Renaming the newest committed manifest to a
    temp-style name is that state (the stores' startup sweep ignores
    young temp files). Returns the torn step."""
    _, path, _ = parse_store_spec(store)
    cands = []
    for sub in ("manifests", "coordinator"):    # localfs / sharded layout
        cands += glob.glob(os.path.join(path, sub, "step_*.json"))
    assert cands, f"no committed manifests under {path}"
    latest = max(cands)                  # zero-padded: lexicographic order
    d, name = os.path.split(latest)
    os.rename(latest, os.path.join(d, ".tmp_crash_" + name))
    return int(name[len("step_"):-len(".json")])


def run_kill(dr: Drive, store: str) -> str:
    """snapshot -> hard kill -> restore -> continue -> bit-identical; then
    the same step restored streamed -> the same digest."""
    want = reference_digest(dr.family)
    policy = Policy(interval=dr.interval, chain=3, keep_last=4)
    with CheckpointSession(store, policy) as sess:
        app = sess.attach(dr.fresh())
        half = dr.total // 2
        for _ in range(half):
            dr.advance(app, 1)
            sess.maybe_snapshot()
        sess.wait()
        boundary = (half // dr.interval) * dr.interval
        assert 0 < boundary < half
        del app                                   # hard kill
        app2 = sess.restore("latest", **dr.restore_kwargs())
        assert dr.step_of(app2) == boundary
        dr.advance(app2, dr.total - boundary)
        got = dr.digest(app2)

        app3 = sess.restore("latest", streaming=True, **dr.restore_kwargs())
        assert dr.step_of(app3) == boundary
        if dr.family != "thirdparty":   # an app without a cold tier
            timings = app3.incarnation.stream_timings()
            assert timings is not None and timings["cold_leaves"] > 0
        dr.advance(app3, dr.total - boundary)
        got_streamed = dr.digest(app3)
    assert got == want, f"{dr.family}: post-restore {got} != {want}"
    assert got_streamed == want, \
        f"{dr.family}: streamed restore {got_streamed} != {want}"
    return got


def run_degraded(dr: Drive, store: str) -> str:
    """A replicated store loses a host after the commit: the streamed
    restore reads the surviving copies, the eager restore agrees."""
    want = reference_digest(dr.family)
    policy = Policy(interval=dr.interval, chain=3, keep_last=4)
    with CheckpointSession(store, policy) as sess:
        app = sess.attach(dr.fresh())
        half = dr.total // 2
        for _ in range(half):
            dr.advance(app, 1)
            sess.maybe_snapshot()
        sess.wait()
        boundary = (half // dr.interval) * dr.interval
        del app                               # hard kill
        sess.backend.fail_host(1)             # ... and a dead peer
        app2 = sess.restore("latest", streaming=True, **dr.restore_kwargs())
        assert dr.step_of(app2) == boundary
        if dr.family != "thirdparty":   # keeps no incarnation
            served = app2.incarnation.stream_timings()[
                "fetch_bytes_per_source"]
            assert "host_001" not in served and served, served
        dr.advance(app2, dr.total - boundary)
        got = dr.digest(app2)
        app3 = sess.restore("latest", **dr.restore_kwargs())
        dr.advance(app3, dr.total - boundary)
        got_eager = dr.digest(app3)
    assert got == want, f"{dr.family}: degraded streamed {got} != {want}"
    assert got_eager == got, f"{dr.family}: degraded eager {got_eager}"
    return got


def run_commit(dr: Drive, store: str) -> None:
    """Crash during commit -> reopen -> torn step invisible, previous
    step restores, continuation bit-identical, store still writable."""
    want = reference_digest(dr.family)
    policy = Policy(chain=2, keep_last=4, async_save=False)
    with CheckpointSession(store, policy) as sess:
        app = sess.attach(dr.fresh())
        dr.advance(app, dr.interval)
        sess.snapshot(block=True)
        survivor = dr.step_of(app)
        dr.advance(app, dr.interval)
        sess.snapshot(block=True)
        assert sess.latest_step() == dr.step_of(app)
        del app

    torn = tear_last_commit(store)

    with CheckpointSession(store, policy) as sess:
        steps = sess.restorable_steps()
        assert torn not in steps and survivor in steps, steps
        app2 = sess.restore("latest", **dr.restore_kwargs())
        assert dr.step_of(app2) == survivor
        dr.advance(app2, dr.total - survivor)
        got = dr.digest(app2)
        assert got == want, f"{dr.family}: post-reopen {got} != {want}"
        sess.snapshot(block=True)        # the torn file is inert: the
        assert sess.latest_step() == dr.total  # store still commits


def run_reslot(dr: Drive, store: str) -> None:
    """Snapshot with work in flight -> hard kill -> restore onto 3 slots
    from 2 -> every request finishes with the uninterrupted run's
    tokens."""
    want = reference_outcome(dr.family)
    with CheckpointSession(store, Policy(async_save=False)) as sess:
        app = sess.attach(dr.fresh())
        dr.advance(app, 3)                   # 3 of 6 tokens: mid-flight
        assert app.queue and all(app.slot_req)
        sess.snapshot(block=True)
        del app                              # hard kill mid-flight
        app2 = sess.restore("latest", n_slots=3, **dr.restore_kwargs())
        assert app2.n_slots == 3
        live = app2.live_requests()
        assert len(live) == _N_REQS, "re-slot dropped sessions"
        app2.run_until_drained(max_steps=500)
        got = {r.rid: tuple(r.out) for r in live}
    assert got == want, f"{dr.family}: re-slotted {got} != {want}"


def run_rl_reslot(store: str) -> None:
    """The third-party app snapshotted 3 steps in on 2 actors, hard-killed
    and restored onto 3 actors, then 3 more steps -> the uninterrupted
    digest (the reference's ``ElasticDrive`` for this family)."""
    dr = DRIVES["thirdparty"]
    want = _rl_digest(6)
    with CheckpointSession(store, Policy(async_save=False)) as sess:
        app = sess.attach(dr.fresh())
        app.collect_and_learn(3)
        sess.snapshot(block=True)
        del app
        app2 = sess.restore("latest", n_actors=3)
        assert app2.n_actors == 3 and app2.t == 3
        app2.collect_and_learn(3)
        assert app2.digest() == want


def _supervised(sess, dr: Drive, half: int):
    """``sess.supervise`` over hosts 0, 1, 2 on a virtual clock; host 0
    falls silent until a poll decides. Returns (supervisor, target)."""
    clock = [0.0]
    sup = sess.supervise([0, 1, 2], heartbeat_timeout=3.0,
                         clock=lambda: clock[0], n_shards=dr.n_shards,
                         restore_kwargs=lambda target: {
                             **dr.restore_kwargs(),
                             **dr.shrink_kwargs(target)})

    def tick(alive):
        clock[0] += 1.0
        for h in alive:
            sup.beat(h, half)
    tick([0, 1, 2])
    tick([0, 1, 2])
    assert sup.poll() is None, "healthy world produced a decision"
    target = None
    for _ in range(8):
        tick([1, 2])
        target = sup.poll()
        if target is not None:
            break
    assert target is not None, f"{dr.family}: silent host never detected"
    assert target.action.name == "SHRINK", target.action
    assert sorted(target.hosts) == [1, 2]
    return sup, target


def run_shrink(dr: Drive, store: str, grow: bool = False) -> None:
    """Detect a silent host, decide SHRINK, restore onto the survivors,
    continue -> bit-identical (``run_shrink``); with ``grow``, one step
    on the survivors is snapshotted and ``grow`` re-admits the host ->
    the rebuild from that step continues bit-identically
    (``run_churn_grow``), an engine re-slotted onto 3 slots to the
    uninterrupted run's tokens."""
    want = reference_digest(dr.family)
    with CheckpointSession(store, Policy(async_save=False)) as sess:
        app = sess.attach(dr.fresh())
        if dr.prepare is not None:
            dr.prepare(app)
        half = dr.total // 2
        dr.advance(app, half)
        sess.snapshot(block=True)
        sup, target = _supervised(sess, dr, half)
        app2 = sess.app
        assert app2 is not app, "shrink must rebuild the runner"
        assert dr.step_of(app2) == half
        if dr.check is not None:
            dr.check(app2, target)
        if not grow:
            dr.advance(app2, dr.total - half)
            got = dr.digest(app2)
            assert got == want, f"{dr.family}: post-shrink {got} != {want}"
            return
        dr.advance(app2, 1)
        sess.snapshot(block=True)
        gt = sup.grow(0)                          # the host came back
        assert gt.action.name == "GROW" and sorted(sup.world) == [0, 1, 2]
        app3 = sess.app
        assert app3 is not app2, "grow must rebuild the runner"
        assert dr.step_of(app3) == half + 1
        if dr.check is not None:
            dr.check(app3, gt)
        if dr.digest is _digest_engine:           # 3 slots now: tokens
            live = app3.live_requests()
            assert len(live) == _N_REQS
            app3.run_until_drained(max_steps=500)
            got = {r.rid: tuple(r.out) for r in live}
            assert got == reference_outcome(dr.family), dr.family
            return
        dr.advance(app3, dr.total - half - 1)
        got = dr.digest(app3)
    assert got == want, f"{dr.family}: post-grow {got} != {want}"


@functools.lru_cache(maxsize=None)
def _rl_digest(steps: int) -> str:
    """The JAX package's example after ``steps`` steps (its digest)."""
    app = _jax_rl().RLActorLearner(n_actors=2, n_streams=8, dim=16, seed=5)
    app.collect_and_learn(steps)
    return app.digest()


def _jax_rl():
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples"))
    import rl_actor_learner   # registers its kind in the JAX package
    return rl_actor_learner


@functools.lru_cache(maxsize=None)
def reference_outcome(family: str):
    """Each request's tokens in the uninterrupted run of an engine
    drive."""
    eng = DRIVES[family].fresh()
    reqs = eng.live_requests()
    eng.run_until_drained(max_steps=500)
    return {r.rid: tuple(r.out) for r in reqs}


FAMILIES = sorted(DRIVES)
ENGINES = sorted(f for f, dr in DRIVES.items()
                 if dr.digest is _digest_engine)


@pytest.mark.parametrize("backend", ["localfs", "sharded"])
@pytest.mark.parametrize("family", FAMILIES)
def test_kill(family, backend, tmp_path):
    run_kill(DRIVES[family], _store(backend, tmp_path))


@pytest.mark.parametrize("backend", ["localfs", "sharded"])
@pytest.mark.parametrize("family", FAMILIES)
def test_commit(family, backend, tmp_path):
    run_commit(DRIVES[family], _store(backend, tmp_path))


@pytest.mark.parametrize("family", FAMILIES)
def test_swap(family, tmp_path):
    """The full kill sequence under both store packages — swapping is
    one spec string — with digests identical across them."""
    dr = DRIVES[family]
    da = run_kill(dr, _store("localfs", tmp_path, "a"))
    db = run_kill(dr, _store("sharded", tmp_path, "b"))
    assert da == db == reference_digest(family)


@pytest.mark.parametrize("family", FAMILIES)
def test_degraded(family, tmp_path):
    run_degraded(DRIVES[family], _store("replicated", tmp_path, "d"))


@pytest.mark.parametrize("backend", ["localfs", "sharded"])
@pytest.mark.parametrize("family", ENGINES + ["thirdparty"])
def test_reslot(family, backend, tmp_path):
    if family == "thirdparty":
        run_rl_reslot(_store(backend, tmp_path))
    else:
        run_reslot(DRIVES[family], _store(backend, tmp_path))


@pytest.mark.parametrize("family", FAMILIES)
def test_shrink(family, tmp_path):
    run_shrink(DRIVES[family], _store("replicated", tmp_path))


@pytest.mark.parametrize("family", FAMILIES)
def test_churn_grow(family, tmp_path):
    run_shrink(DRIVES[family], _store("localfs", tmp_path), grow=True)


def test_thirdparty_reference_is_the_jax_examples():
    """The twin's uninterrupted digest, which every thirdparty mode is
    held to, is the JAX package's example's on the same steps."""
    assert reference_digest("thirdparty") == \
        _rl_digest(DRIVES["thirdparty"].total)


# --- an entry introduced mid-chain ------------------------------------------------

class _GrowingApp:
    """Protocol citizen whose semantic state grows mid-run: a cold-tier
    entry first exists at step 3, so inside a delta chain its first
    appearance is a non-base manifest (the reference matrix's app, on
    the port's API)."""
    kind = "torch-conformance-growing"

    def __init__(self) -> None:
        self.step = 0
        self.base = np.zeros(64, np.float64)
        self.late = None

    def advance(self, n: int) -> None:
        for _ in range(n):
            self.step += 1
            self.base += float(self.step)
            if self.step >= 3:
                z = self.late if self.late is not None \
                    else np.full(32, 7.0)
                self.late = z * 1.25 + self.step

    def digest(self) -> str:
        h = hashlib.sha256(self.base.tobytes())
        if self.late is not None:
            h.update(self.late.tobytes())
        h.update(str(self.step).encode())
        return h.hexdigest()

    def checkpoint_state(self):
        up = UpperHalf()
        up.register("base", "params", {"b": self.base.copy()})
        if self.late is not None:
            up.register("late", "opt_state", {"z": self.late.copy()})
        up.register("step", "step", np.int64(self.step))
        return up

    def checkpoint_step(self) -> int:
        return self.step

    def job_meta(self) -> Dict[str, Any]:
        return {"kind": self.kind}

    def bind(self, restore) -> None:
        self.base = np.asarray(restore.tree("base")["b"],
                               np.float64).copy()
        self.late = (np.asarray(restore.tree("late")["z"],
                                np.float64).copy()
                     if restore.has("late") else None)
        self.step = int(restore.scalar("step"))
        restore.release()


@register_app_kind(_GrowingApp.kind, replace=True)
def _restore_growing(restore) -> _GrowingApp:
    app = _GrowingApp()
    app.bind(restore)
    return app


@pytest.mark.parametrize("backend", ["localfs", "sharded"])
def test_midchain(backend, tmp_path):
    """An entry first introduced mid-chain checkpoints and restores
    bit-identically, eager and streamed, through the public API alone."""
    ref = _GrowingApp()
    ref.advance(6)
    want = ref.digest()
    store = _store(backend, tmp_path)
    with CheckpointSession(store, Policy(interval=1, chain=8,
                                         keep_last=8)) as sess:
        app = sess.attach(_GrowingApp())
        for _ in range(4):
            app.advance(1)
            sess.maybe_snapshot()
        sess.wait()
        assert app.late is not None
        link = sess.backend.get_manifest(4)
        assert link.get("base_step") is not None and \
            link["entries"]["late"]["leaves"]["['z']"].get("mode") == "xor"
        del app                                   # hard kill
        for streaming in (False, True):
            app2 = sess.restore("latest", streaming=streaming)
            assert app2.step == 4
            app2.advance(2)
            got = app2.digest()
            assert got == want, (streaming, got, want)
