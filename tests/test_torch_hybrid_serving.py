"""The port's hybrid family (Griffin/RecurrentGemma) serving on the CPU
against the JAX package: the serving engine's greedy tokens against the
JAX engine (``-matrix``) and against a JAX batch-1 decode loop
(``-smoke``, which the JAX engine cannot admit into: ROADMAP C11); the
port's own serving kill -> ``restore("latest")`` and re-slot; serving
chains across packages both ways. The models and helpers are
``test_torch_hybrid.py``'s."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.backends.localfs import LocalFSBackend as JBackend
from repro.core.checkpoint import CheckpointManager as JManager
from repro.models import model as JM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import convert
from repro_torch.api import CheckpointSession, Policy
from repro_torch.core.backends.localfs import LocalFSBackend
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.tree import flatten_with_paths
from test_torch_hybrid import (DENSE, MATRIX, MESH, SMOKE, SPARSE, _bytes,
                               _pair, _pair_np)


def _prompts(n=5, seed=3, lo=3, hi=14):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=rng.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _run(eng, prompts, max_new=6):
    reqs = [Request(rid=i, prompt=p.copy(), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_steps=400)
    return {r.rid: list(r.out) for r in reqs}


def test_engine_tokens_equal_the_jax_engine_on_matrix():
    jcfg, tcfg, jparams, tparams = _pair(MATRIX)
    prompts = [p % jcfg.vocab_size for p in _prompts(4, seed=5)]
    jeng = JEngine(jcfg, jparams, MESH, n_slots=2, max_seq=32)
    jreqs = [JRequest(rid=i, prompt=p.copy(), max_new=12)
             for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_drained(max_steps=400)
    got = _run(ServingEngine(tcfg, tparams, "cpu", n_slots=2, max_seq=32),
               prompts, max_new=12)
    assert got == {r.rid: list(r.out) for r in jreqs}
    assert all(len(v) == 12 for v in got.values())


def _jax_decode_loop(jcfg, jparams, prompt, max_new, max_seq):
    """Greedy generation through the JAX package's batch-1 decode_step:
    the history replayed token by token, then ``max_new`` tokens."""
    dec = jax.jit(functools.partial(JM.decode_step, jcfg))
    cache = JM.init_cache(jcfg, 1, max_seq)
    for pos, t in enumerate(prompt[:-1]):
        _, cache = dec(jparams, cache, jnp.asarray([[t]], jnp.int32),
                       jnp.asarray([pos], jnp.int32))
    tok, out = int(prompt[-1]), []
    for pos in range(len(prompt) - 1, len(prompt) - 1 + max_new):
        logits, cache = dec(jparams, cache, jnp.asarray([[tok]], jnp.int32),
                            jnp.asarray([pos], jnp.int32))
        tok = int(jnp.argmax(logits[0]))
        out.append(tok)
    return out


def test_engine_tokens_equal_a_jax_decode_loop_on_smoke():
    """On -smoke (5 layers: one group and two unstacked remainder
    blocks) the port's 2-slot engine gives each request the tokens of a
    JAX batch-1 decode loop, past the window of 32."""
    jcfg, tcfg, jparams, tparams = _pair()
    prompts = _prompts(4, seed=8, lo=10, hi=20)
    got = _run(ServingEngine(tcfg, tparams, "cpu", n_slots=2, max_seq=64),
               prompts, max_new=24)
    want = {i: _jax_decode_loop(jcfg, jparams, p, 24, 64)
            for i, p in enumerate(prompts)}
    assert got == want


def test_reference_engine_cannot_admit_into_smoke():
    """ROADMAP C11: the JAX engine merges a slot on axis 1 of every leaf
    of rank 2 or more, but the remainder blocks' leaves hold the batch
    on axis 0, so its first admission raises. Pinned so that the ROADMAP
    entry stays true until the reference is fixed."""
    jcfg, _, jparams, _ = _pair()
    jeng = JEngine(jcfg, jparams, MESH, n_slots=2, max_seq=32)
    jeng.submit(JRequest(rid=0, prompt=np.array([3, 7, 11], np.int32),
                         max_new=2))
    with pytest.raises(ValueError, match="Incompatible shapes"):
        jeng.step()


@functools.lru_cache(maxsize=None)
def _serving_params():
    return convert.params_from_numpy(_pair_np(SMOKE, "bfloat16"), "cpu")


@pytest.mark.parametrize("policy", [SPARSE, DENSE], ids=["sparse", "dense"])
@pytest.mark.parametrize("new_slots", [2, 1, 3])
def test_kill_restore_continues_token_identically(tmp_path, policy,
                                                  new_slots):
    params = _serving_params()
    prompts = _prompts()
    ref = _run(ServingEngine.create(SMOKE, params, n_slots=2, max_seq=48,
                                    device="cpu"), prompts)
    sess = CheckpointSession(f"localfs:{tmp_path}", policy)
    eng = ServingEngine.create(SMOKE, params, n_slots=2, max_seq=48,
                               manager=sess.manager, device="cpu")
    sess.attach(eng)
    reqs = [Request(rid=i, prompt=p.copy(), max_new=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    for _ in range(10):
        eng.step()
        sess.maybe_snapshot()
    sess.wait()
    assert eng.queue and any(eng.slot_req), "kill must be mid-flight"
    st = dict(sess.stats)
    assert st["saves"] == 2 and st["chain_links"] == 1
    if policy.sparse:
        assert st["sparse_leaves"] > 0 and st["dirty_chunks"] > 0
    done = {r.rid: list(r.out) for r in reqs if r.done}
    sess.close()
    del eng, sess                                  # the kill

    sess2 = CheckpointSession(f"localfs:{tmp_path}", policy)
    eng2 = sess2.restore("latest", params=params, device="cpu",
                         n_slots=new_slots)
    assert eng2.n_slots == new_slots and eng2.steps == 8
    live = eng2.live_requests()
    assert {r.rid for r in live} | set(done) == set(ref)
    eng2.run_until_drained(max_steps=400)
    got = dict(done)
    got.update({r.rid: list(r.out) for r in live})
    assert got == ref
    sess2.close()


# --- serving chains across packages ------------------------------------------

def _assert_same_entries(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        assert sorted(a[name]) == sorted(b[name]), name
        for path in a[name]:
            x, y = a[name][path], b[name][path]
            assert tuple(np.shape(x)) == tuple(np.shape(y)), (name, path)
            assert _bytes(x) == _bytes(y), (name, path)


CHAIN = dict(sparse_chunk_bytes=1024, sparse_min_bytes=2048)


def test_port_serving_chain_restores_bit_identically_under_jax(tmp_path):
    params = convert.params_from_numpy(_pair_np(MATRIX, "bfloat16"), "cpu")
    sess = CheckpointSession(f"localfs:{tmp_path}",
                             Policy(interval=3, chain=4, **CHAIN))
    eng = ServingEngine.create(MATRIX, params, n_slots=2, max_seq=24,
                               manager=sess.manager, device="cpu")
    sess.attach(eng)
    for i, p in enumerate(_prompts(seed=9)):
        eng.submit(Request(rid=i, prompt=p % 64, max_new=8))
    live = {}
    for _ in range(12):
        eng.step()
        if sess.maybe_snapshot() is not None:
            live[eng.steps] = dict(flatten_with_paths(
                convert.tree_to_numpy(eng.cache)))
    sess.close()
    jm = JManager(JBackend(str(tmp_path)))
    tm = CheckpointManager(LocalFSBackend(str(tmp_path)))
    assert jm.backend.list_steps() == [3, 6, 9, 12]
    for step in (3, 6, 9, 12):
        jr, tr = jm.restore(step), tm.restore(step)
        _assert_same_entries(jr.entries, tr.entries)
        assert jr.manifest == tr.manifest
        for path, want in live[step].items():
            assert _bytes(jr.entries["kv_cache"][path]) == _bytes(want)
    assert "['groups']['b0_rglru']['state']" in live[12]
    for m in (jm, tm):
        m.close()


def test_jax_serving_chain_restores_bit_identically_under_the_port(tmp_path):
    jcfg, _, jparams, _ = _pair(MATRIX, "bfloat16")
    jm = JManager(JBackend(str(tmp_path)), async_save=False,
                  delta_base_interval=4, **CHAIN)
    jeng = JEngine(jcfg, jparams, MESH, n_slots=2, max_seq=24, manager=jm,
                   arch=MATRIX)
    for i, p in enumerate(_prompts(seed=9)):
        jeng.submit(JRequest(rid=i, prompt=p % 64, max_new=8))
    for _ in range(12):
        jeng.step()
        if jeng.steps % 3 == 0:
            jeng.snapshot()
    jm.wait()
    assert jm.backend.list_steps() == [3, 6, 9, 12]
    tm = CheckpointManager(LocalFSBackend(str(tmp_path)))
    for step in (3, 6, 9, 12):
        _assert_same_entries(tm.restore(step).entries,
                             jm.restore(step).entries)
    eng = CheckpointSession(f"localfs:{tmp_path}").restore(
        "latest", params=convert.params_from_numpy(_pair_np(MATRIX,
                                                            "bfloat16"),
                                                   "cpu"), device="cpu")
    want = jm.restore(12).entries["kv_cache"]
    got = dict(flatten_with_paths(convert.tree_to_numpy(eng.cache)))
    assert sorted(got) == sorted(want)
    for path, v in got.items():
        assert _bytes(v) == _bytes(want[path]), path
    assert eng.steps == jeng.steps
    np.testing.assert_array_equal(eng.slot_pos, jeng.slot_pos)
    np.testing.assert_array_equal(eng.slot_tok, jeng.slot_tok)
    assert [(r.rid, r.out) for r in eng.live_requests()] == \
        [(r.rid, r.out) for r in jeng.live_requests()]
    for m in (jm, tm):
        m.close()
