"""The third-party family on the port: ``repro_torch.examples.
rl_actor_learner``, the twin of the JAX package's
``examples/rl_actor_learner.py``, written against ``repro_torch.api``
alone (an AST scan: no other import but numpy and the standard
library). Its learning steps give the JAX example's digests step for
step, its demo runs as ``python -m repro_torch.examples.rl_actor_learner``,
and its elastic restore onto another actor pool keeps the trajectory.
Checkpoints across packages: ``tests/test_torch_cross_restore.py``; the
conformance modes: ``tests/test_torch_conformance.py``."""
import ast
import os
import subprocess
import sys

import pytest

from repro_torch.api import CheckpointSession, Policy
from repro_torch.examples import rl_actor_learner as trl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))
import rl_actor_learner as jrl  # noqa: E402  (registers its app kind)


def test_the_twin_imports_only_the_port_api_and_numpy():
    path = os.path.join(REPO, "src", "repro_torch", "examples",
                        "rl_actor_learner.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert names == {"__future__", "argparse", "hashlib", "tempfile",
                     "typing", "numpy", "repro_torch.api"}, names


def test_the_twin_keeps_the_kind_and_job_meta():
    a = trl.RLActorLearner(n_actors=3, n_streams=5, dim=7, seed=2)
    b = jrl.RLActorLearner(n_actors=3, n_streams=5, dim=7, seed=2)
    assert trl.RLActorLearner.KIND == jrl.RLActorLearner.KIND
    assert a.job_meta() == b.job_meta()


@pytest.mark.parametrize("seed,actors", [(0, 1), (5, 2), (9, 4)])
def test_steps_give_the_jax_examples_digests(seed, actors):
    a = trl.RLActorLearner(n_actors=actors, n_streams=8, dim=16, seed=seed)
    b = jrl.RLActorLearner(n_actors=1, n_streams=8, dim=16, seed=seed)
    for _ in range(5):
        a.collect_and_learn(3)
        b.collect_and_learn(3)
        assert a.digest() == b.digest()


@pytest.mark.parametrize("store", ["localfs", "sharded"])
def test_elastic_restore_keeps_the_trajectory(tmp_path, store):
    spec = f"{store}:{tmp_path}/s" + ("?hosts=4" if store == "sharded"
                                      else "")
    ref = trl.RLActorLearner(1, 8, seed=3)
    ref.collect_and_learn(30)
    with CheckpointSession(spec, Policy(interval=5, chain=3)) as sess:
        app = sess.attach(trl.RLActorLearner(2, 8, seed=3))
        for _ in range(17):
            app.collect_and_learn(1)
            sess.maybe_snapshot()
        sess.wait()
        del app
        app = sess.restore("latest", n_actors=5)
        assert (app.t, app.n_actors) == (15, 5)
        app.collect_and_learn(30 - app.t)
    assert app.digest() == ref.digest()


def test_the_demo_runs_as_a_module(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.rl_actor_learner",
         "--steps", "40", "--store", f"localfs:{tmp_path}/rl"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "weights identical to uninterrupted run: True" in proc.stdout
