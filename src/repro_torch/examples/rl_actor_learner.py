"""An elastic RL actor-learner workload, written ONLY against
``repro_torch.api`` — the port's twin of ``examples/rl_actor_learner.py``
(the same app kind, entries and job metadata, so a checkpoint written
by either package restores in the other).

A second third-party kind for the agnosticism proof (alongside
``checkpointable_pipeline.py``), this one exercising the *elastic*
restore surface: ``n_actors`` is topology, not state. Experience
streams are a data constant — stream ``s`` at environment step ``t``
yields a transition derived from ``(seed, s, t)`` alone — and the
learner consumes transitions in fixed stream-major order, so the
learned weights are bit-identical no matter how many actors collected
them. Restore onto more (or fewer) actors by passing ``n_actors=`` to
``CheckpointSession.restore``, exactly like ``n_slots=`` re-slots the
serving engine; actor→stream ownership is rebuilt round-robin and can
be moved later through ``apply_reassignment`` (the supervisor's hook).

    PYTHONPATH=src python -m repro_torch.examples.rl_actor_learner \
        [--steps 120] [--actors 2] [--restore-actors 3] \
        [--store sharded:/tmp/rl?hosts=4]

The demo trains halfway, "crashes" (drops the app object), restores
onto a different actor count through the app-kind registry, finishes,
and verifies the policy weights match an uninterrupted run bit for bit.
"""
from __future__ import annotations

import argparse
import hashlib
import tempfile
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.api import (CheckpointSession, Policy, RestoreContext,
                       UpperHalf, register_app_kind)


class RLActorLearner:
    """TD(0)-flavored linear learner over deterministic experience
    streams.

    Durable state is the learner's weights, per-stream visit counts and
    the global environment step — what ``checkpoint_state`` declares.
    Actor count and stream ownership are topology: they shape who
    *collects*, never what is *learned*."""

    KIND = "rl-actor-learner"

    def __init__(self, n_actors: int = 2, n_streams: int = 8,
                 dim: int = 16, seed: int = 0) -> None:
        if n_actors < 1:
            raise ValueError(f"n_actors={n_actors} must be >= 1")
        self.n_actors = n_actors
        self.n_streams = n_streams
        self.dim = dim
        self.seed = seed
        self.lr = 0.05
        self.t = 0
        self.weights = np.zeros(dim, np.float64)
        self.visits = np.zeros(n_streams, np.int64)
        self.owner = {s: s % n_actors for s in range(n_streams)}
        self.quiesced = 0
        self.reassigned = 0

    # --- the workload ---------------------------------------------------

    def _transition(self, stream: int, t: int) -> Tuple[np.ndarray, float]:
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + stream * 9_973 + t) % (2 ** 31 - 1))
        x = rng.standard_normal(self.dim)
        reward = float(np.tanh(x[:4].sum()))
        return x, reward

    def collect_and_learn(self, n: int = 1) -> None:
        """n environment steps: every actor collects from its owned
        streams, the learner applies the transitions in stream order —
        the same sequence of updates for any ownership layout."""
        for _ in range(n):
            for s in range(self.n_streams):
                x, r = self._transition(s, self.t)
                td = r - float(self.weights @ x)
                self.weights = self.weights + self.lr * td * x
                self.visits[s] += 1
            self.t += 1

    def digest(self) -> str:
        h = hashlib.blake2b(digest_size=16)
        h.update(np.ascontiguousarray(self.weights).tobytes())
        h.update(np.ascontiguousarray(self.visits).tobytes())
        h.update(str(self.t).encode())
        return h.hexdigest()

    # --- CheckpointableApp protocol ------------------------------------

    def checkpoint_state(self) -> UpperHalf:
        up = UpperHalf()
        up.register("learner", "params", {"weights": self.weights.copy()})
        up.register("visits", "agg", {"visits": self.visits.copy()})
        up.register("t", "step", np.int64(self.t))
        return up

    def checkpoint_step(self) -> int:
        return self.t

    def job_meta(self) -> Dict[str, Any]:
        # n_actors rides along as the *last* topology, a default the
        # restore binder uses when the caller doesn't re-slot
        return {"kind": self.KIND, "n_streams": self.n_streams,
                "dim": self.dim, "seed": self.seed,
                "n_actors": self.n_actors}

    def bind(self, restore: RestoreContext) -> None:
        self.weights = np.asarray(restore.tree("learner")["weights"],
                                  np.float64).copy()
        self.visits = np.asarray(restore.tree("visits")["visits"],
                                 np.int64).copy()
        self.t = int(restore.scalar("t"))
        restore.release()

    def quiesce(self) -> None:
        # actors have no buffered transitions (collect == learn here);
        # the hook proves the optional surface for supervisor teardown
        self.quiesced += 1

    def apply_reassignment(
            self, assignment: Sequence[Tuple[int, int]]) -> None:
        """Adopt (actor, stream) ownership pairs — a supervisor moving
        collection off a dead actor. Ownership is topology: the learned
        trajectory is unchanged by construction."""
        for actor, stream in assignment:
            self.owner[int(stream)] = int(actor)
        self.reassigned += 1


@register_app_kind(RLActorLearner.KIND)
def _restore_rl(restore: RestoreContext,
                n_actors: int = None) -> RLActorLearner:
    """Elastic binder: ``n_actors`` re-slots collection onto a larger or
    smaller actor pool; omitted, the checkpoint's own topology is
    reused."""
    jm = restore.job
    app = RLActorLearner(
        n_actors=int(n_actors if n_actors is not None
                     else jm.get("n_actors", 1)),
        n_streams=int(jm["n_streams"]), dim=int(jm["dim"]),
        seed=int(jm["seed"]))
    app.bind(restore)
    return app


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--actors", type=int, default=2)
    ap.add_argument("--restore-actors", type=int, default=3)
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--store", default=None,
                    help="store spec (default: localfs:<tmpdir>)")
    args = ap.parse_args(argv)
    store = args.store or f"localfs:{tempfile.mkdtemp(prefix='rl_')}"

    # uninterrupted reference (actor count deliberately different: the
    # trajectory must not depend on it)
    ref = RLActorLearner(1, args.streams, seed=args.seed)
    ref.collect_and_learn(args.steps)

    policy = Policy(interval=10, chain=4, keep_last=4)
    with CheckpointSession(store, policy) as sess:
        app = sess.attach(RLActorLearner(args.actors, args.streams,
                                         seed=args.seed))
        for _ in range(args.steps // 2):
            app.collect_and_learn(1)
            sess.maybe_snapshot()
        sess.wait()
        print(f"trained to env step {app.t} on {app.n_actors} actors, "
              f"snapshots at {sess.backend.list_steps()}")
        del app                       # crash: the process state is gone

        app = sess.restore("latest", n_actors=args.restore_actors)
        print(f"restored at env step {app.t} onto {app.n_actors} actors")
        app.collect_and_learn(args.steps - app.t)
        ok = app.digest() == ref.digest()
        print(f"weights identical to uninterrupted run: {ok}")
        assert ok


if __name__ == "__main__":
    main()
