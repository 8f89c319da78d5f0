"""The port's hybrid family (Griffin/RecurrentGemma) on the CPU against
the JAX package.

The same seeded numpy inputs go through both packages: the RG-LRU
recurrence's plain version against ``repro.models.hybrid.rg_lru`` (the
associative scan) and the Pallas ``rg_lru_scan`` in interpret mode; the
decode step, the causal conv with a carried state, the RG-LRU block with
a cache; the whole recurrentgemma-9b-smoke model's params, prefill,
cache and decode past the attention window; the serving engine's greedy
tokens against the JAX engine (``-matrix``) and against a JAX batch-1
decode loop (``-smoke``, which the JAX engine cannot admit into: ROADMAP
C11); the serving memory estimate; the port's own serving kill ->
``restore("latest")`` and re-slot; serving chains across packages both
ways.

Tolerances: the recurrence 1e-4 (``tests/test_kernels.py``: the same f32
recurrence blocked differently); the blocks and the model 1e-5 in
float32.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import registry as jreg
from repro.core.backends.localfs import LocalFSBackend as JBackend
from repro.core.checkpoint import CheckpointManager as JManager
from repro.kernels.rg_lru.ops import rg_lru_scan as jrg_lru_scan
from repro.models import hybrid as JHY
from repro.models import model as JM
from repro.parallel.planner import estimate_serve_memory as jserve_memory
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import convert
from repro_torch.api import CheckpointSession, Policy
from repro_torch.configs import registry as treg
from repro_torch.core.backends.localfs import LocalFSBackend
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.kernels.rg_lru import ops as rg_ops
from repro_torch.kernels.rg_lru import ref as R
from repro_torch.models import hybrid as HY
from repro_torch.models import model as M
from repro_torch.parallel.planner import estimate_serve_memory
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.tree import flatten_with_paths

SMOKE = "recurrentgemma-9b-smoke"
MATRIX = "recurrentgemma-9b-matrix"
MESH = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
# B, S, W, chunk, block_w: tests/test_kernels.py's RG-LRU sweep
SWEEP = [(2, 128, 96, 32, 32), (1, 64, 256, 64, 128), (2, 100, 48, 32, 48)]
SPARSE = Policy(interval=4, chain=4, sparse_chunk_bytes=1024,
                sparse_min_bytes=2048)
DENSE = Policy(interval=4, chain=4, sparse=False)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bytes(v) -> bytes:
    return np.ascontiguousarray(np.asarray(v)).tobytes()


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _sweep_inputs(B, S, W, seed):
    """x ~ N(0,1), r and i = sigmoid(N(0,1)), lam ~ N(0,1), as the JAX
    kernel test draws them (decays vanish within a few tokens)."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    sig = lambda a: (1 / (1 + np.exp(-a))).astype(np.float32)
    return f(B, S, W), sig(f(B, S, W)), sig(f(B, S, W)), f(W)


# --- the recurrence ----------------------------------------------------------

@pytest.mark.parametrize("B,S,W,chunk,bw", SWEEP)
def test_rg_lru_plain_matches_jax_and_the_pallas_kernel(B, S, W, chunk, bw):
    x, r, i, lam = _sweep_inputs(B, S, W, seed=S + W)
    want, want_last = JHY.rg_lru(*map(jnp.asarray, (x, r, i, lam)))
    pallas = jrg_lru_scan(*map(jnp.asarray, (x, r, i, lam)), chunk=chunk,
                          block_w=bw, interpret=True)
    rg_ops.reset_counts()
    got = rg_ops.rg_lru_scan(*map(torch.from_numpy, (x, r, i, lam)),
                             chunk=chunk, block_w=bw)
    assert rg_ops.counts("cpu") == {"rg_lru_fwd": 1, "rg_lru_bwd": 0}
    assert rg_ops.counts("cuda") == {"rg_lru_fwd": 0, "rg_lru_bwd": 0}
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, W)
    _close(got, want, 1e-4)
    _close(got, pallas, 1e-4)
    h, last = HY.rg_lru(*map(torch.from_numpy, (x, r, i, lam)))
    _close(h, want, 1e-4)
    _close(last, want_last, 1e-4)


@pytest.mark.parametrize("u_range,decays", [
    ((0.9, 0.999), (0.6, 0.997)),
    ((0.99999, 0.999999), (0.99995, 0.999997))], ids=["init", "near_one"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rg_lru_at_the_model_inits_matches_jax(with_h0, u_range, decays):
    """Inputs as a fresh block makes them (``ref.model_inputs``): decays
    of 0.66-0.996 a token, so the state carries across the plain
    version's 64-token chunks; and decays near one, where the gate needs
    ``expm1``; with and without a carried-in state."""
    g = torch.Generator().manual_seed(5)
    x, r, i, lam = R.model_inputs(2, 512, 64, g, "cpu", u_range)
    h0 = torch.randn((2, 64), generator=g) if with_h0 else None
    want, want_last = JHY.rg_lru(
        *(jnp.asarray(t.numpy()) for t in (x, r, i, lam)),
        None if h0 is None else jnp.asarray(h0.numpy()))
    a = torch.exp(R.gates(r, lam)[0])
    assert decays[0] < float(a.min()) and float(a.max()) < decays[1]
    got, last = HY.rg_lru(x, r, i, lam, h0)
    _close(got, want, 1e-4)
    _close(last, want_last, 1e-4)
    # the chunk only reorders the sums
    _close(R.rg_lru_plain(x, r, i, lam, h0, chunk=7), got, 1e-4)


def test_rg_lru_step_matches_jax():
    x, r, i, lam = _sweep_inputs(3, 1, 40, seed=2)
    h = np.random.RandomState(3).randn(3, 40).astype(np.float32)
    jy, jh = JHY.rg_lru_step(*map(jnp.asarray, (x, r, i, lam, h)))
    ty, th = HY.rg_lru_step(*map(torch.from_numpy, (x, r, i, lam, h)))
    _close(ty, jy)
    _close(th, jh)
    # one step of the scan from h is the same step
    _close(HY.rg_lru(*map(torch.from_numpy, (x, r, i, lam, h)))[1], jh)


def test_rg_lru_wrapper_refuses_what_it_cannot_take():
    x, r, i, lam = map(torch.from_numpy, _sweep_inputs(1, 8, 4, seed=0))
    with pytest.raises(TypeError, match="float32"):
        rg_ops.rg_lru_fwd(x.double(), r, i, lam)
    with pytest.raises(ValueError, match="do not agree"):
        rg_ops.rg_lru_fwd(x, r[:, :4], i, lam)
    with pytest.raises(ValueError, match="do not agree"):
        rg_ops.rg_lru_fwd(x, r, i, lam, torch.zeros(1, 5))
    with pytest.raises(ValueError, match="no kernel for device"):
        rg_ops.rg_lru_fwd(*(t.to("meta") for t in (x, r, i, lam)))
    with pytest.raises(ValueError, match="positive"):
        rg_ops.rg_lru_scan(x, r, i, lam, chunk=0)


def test_causal_conv_with_state_matches_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 7, 12).astype(np.float32)
    w = rng.randn(4, 12).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    st = rng.randn(2, 3, 12).astype(np.float32)
    for state in (None, st):
        args = (x, w, b) + (() if state is None else (state,))
        jy, js = JHY._causal_conv1d(*map(jnp.asarray, args))
        ty, ts = HY._causal_conv1d(*map(torch.from_numpy, args))
        _close(ty, jy)
        _close(ts, js)


# --- the block and the model -------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pair_np(arch, dtype="float32", seed=0):
    """The JAX package's params for ``arch`` as numpy, with the
    zero-init leaves (norm scales, conv and gate biases) perturbed so a
    comparison sees every parameter."""
    jcfg = jreg.resolve_config(arch).replace(dtype=dtype)
    p = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed + 11)

    def perturb(node):
        for k, v in node.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("scale", "conv_b", "gate_a_b", "gate_x_b"):
                node[k] = (v.astype(np.float32) + 0.1 * rng.randn(*v.shape)
                           ).astype(v.dtype)
    perturb(p)
    return p


def _pair(arch=SMOKE, dtype="float32"):
    jcfg = jreg.resolve_config(arch).replace(dtype=dtype)
    tcfg = treg.resolve_config(arch).replace(dtype=dtype)
    p = _pair_np(arch, dtype)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, p), \
        convert.params_from_numpy(p, "cpu")


def test_rglru_block_with_a_cache_matches_jax():
    jcfg, tcfg, jparams, tparams = _pair()
    jp = jparams["rem0_rglru"]
    tp = tparams["rem0_rglru"]
    rng = np.random.RandomState(12)
    x = rng.randn(2, 20, tcfg.d_model).astype(np.float32)
    jout, none = JHY.rglru_block_forward(jcfg, jp, jnp.asarray(x))
    tout, tnone = HY.rglru_block_forward(tcfg, tp, torch.from_numpy(x))
    assert none is None and tnone is None
    _close(tout, jout)
    jc = jax.tree.map(jnp.zeros_like, JM.init_cache(jcfg, 2, 32)["rem0_rglru"])
    tc = M.init_cache(tcfg, 2, 32, "cpu")["rem0_rglru"]
    jout, jc = JHY.rglru_block_forward(jcfg, jp, jnp.asarray(x), jc)
    tout, tc = HY.rglru_block_forward(tcfg, tp, torch.from_numpy(x), tc)
    _close(tout, jout)
    for k in ("conv", "state"):
        _close(tc[k], jc[k])
    for t in range(3):                                    # decode steps
        one = rng.randn(2, 1, tcfg.d_model).astype(np.float32)
        jout, jc = JHY.rglru_block_forward(jcfg, jp, jnp.asarray(one), jc)
        tout, tc = HY.rglru_block_forward(tcfg, tp, torch.from_numpy(one), tc)
        _close(tout, jout)
        for k in ("conv", "state"):
            _close(tc[k], jc[k])


def test_param_template_and_cache_spec_match_the_reference():
    jcfg, tcfg, jparams, _ = _pair(dtype="bfloat16")
    from repro.core.split_state import flatten_with_paths as jflat
    want = [(p, tuple(v.shape), str(v.dtype)) for p, v in jflat(jparams)]
    got = [(p, tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for p, v in flatten_with_paths(M.init_params(tcfg, 0, "cpu"))]
    assert got == want
    assert any(p.startswith("['rem1_rglru']") for p, _, _ in got)
    assert M.logical_specs(tcfg) == JM.logical_specs(jcfg)
    jspec = dict(jflat(JM.cache_spec(jcfg, 3, 40)))
    tspec = dict(flatten_with_paths(M.cache_spec(tcfg, 3, 40)))
    assert sorted(jspec) == sorted(tspec)
    for k, s in jspec.items():
        assert tspec[k].shape == tuple(s.shape), k
        assert str(tspec[k].dtype).replace("torch.", "") == str(s.dtype), k
    axes = dict(flatten_with_paths(M.batch_axes(tcfg)))
    assert sorted(axes) == sorted(tspec)
    for k, ax in axes.items():
        assert ax == (1 if k.startswith("['groups']") else 0), k
        assert tspec[k].shape[ax] == 3, k


def test_full_size_template_counts_its_params():
    """recurrentgemma-9b's template holds 8,524,206,080 params (the JAX
    package's count), where ``ModelConfig.n_params()`` says
    6,611,185,664 (ROADMAP: a deliberate fix on both sides later)."""
    tcfg = treg.resolve_config("recurrentgemma-9b")
    assert M.param_count(tcfg) == JM.param_count(
        jreg.resolve_config("recurrentgemma-9b")) == 8_524_206_080
    assert tcfg.n_params() == 6_611_185_664


@pytest.mark.parametrize("prompt_len", [20, 40])
def test_prefill_and_decode_past_the_window_match_jax(prompt_len):
    """Prefill (40 > the window of 32 takes the ring-buffer prefill),
    then decode steps until position 52, past the window."""
    jcfg, tcfg, jparams, tparams = _pair()
    toks = np.random.RandomState(3).randint(
        0, jcfg.vocab_size, (2, prompt_len)).astype(np.int32)
    jlast, jc = JM.prefill(jcfg, jparams, jnp.asarray(toks),
                           JM.init_cache(jcfg, 2, 64))
    tc = M.init_cache(tcfg, 2, 64, device="cpu")
    tlast, tc2 = M.prefill(tcfg, tparams, torch.from_numpy(toks), tc)
    assert tc2 is tc                                 # written in place
    _close(tlast, jlast)
    jflat = dict(flatten_with_paths(jax.tree.map(np.asarray, jc)))
    for path, t in flatten_with_paths(tc):
        _close(t, jflat[path])
    rng = np.random.RandomState(4)
    jdec = jax.jit(functools.partial(JM.decode_step, jcfg))
    for pos in range(prompt_len, 52):
        nxt = rng.randint(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        p = np.array([pos, pos], np.int32)
        jl, jc = jdec(jparams, jc, jnp.asarray(nxt), jnp.asarray(p))
        tl, tc = M.decode_step(tcfg, tparams, tc, torch.from_numpy(nxt),
                               torch.from_numpy(p))
        _close(tl, jl)
    jflat = dict(flatten_with_paths(jax.tree.map(np.asarray, jc)))
    for path, t in flatten_with_paths(tc):
        _close(t, jflat[path])


def test_ring_prefill_past_the_window_misplaces_rows_in_both_packages():
    """ROADMAP C12: a prefill longer than the attention window writes the
    trailing ``window`` keys into the ring cache in arrival order
    (``_scatter_rows``' full-overwrite shortcut), not at ``pos % window``,
    so the next decode step overwrites a key still inside the window. Up
    to the window, decoding one token after a prefill equals prefilling
    it too; past it, both packages drift from that the same way. Pinned
    so that a fix is made on both sides deliberately."""
    jcfg, tcfg, jparams, tparams = _pair()
    toks = np.random.RandomState(7).randint(0, jcfg.vocab_size,
                                            (1, 41)).astype(np.int32)
    for n, agrees in ((32, True), (40, False)):
        got = {}
        for name, run in (("jax", _jax_prefill_decode), ("port",
                                                          _port_prefill_decode)):
            cfg, params = (jcfg, jparams) if name == "jax" else (tcfg, tparams)
            dec, pre = run(cfg, params, toks, n)
            got[name] = dec
            gap = float(np.abs(dec - pre).max())
            assert (gap < 1e-4) == agrees, (name, n, gap)
        _close(got["port"], got["jax"])


def _jax_prefill_decode(cfg, params, toks, n):
    """(decode logits of token n after a prefill of n tokens, the last
    logits of a prefill of n + 1 tokens)."""
    _, c = JM.prefill(cfg, params, jnp.asarray(toks[:, :n]),
                      JM.init_cache(cfg, 1, 64))
    dec, _ = JM.decode_step(cfg, params, c, jnp.asarray(toks[:, n:n + 1]),
                            jnp.asarray([n], jnp.int32))
    pre, _ = JM.prefill(cfg, params, jnp.asarray(toks[:, :n + 1]),
                        JM.init_cache(cfg, 1, 64))
    return np.asarray(dec), np.asarray(pre)


def _port_prefill_decode(cfg, params, toks, n):
    c = M.init_cache(cfg, 1, 64, "cpu")
    M.prefill(cfg, params, torch.from_numpy(toks[:, :n]), c)
    dec, _ = M.decode_step(cfg, params, c, torch.from_numpy(toks[:, n:n + 1]),
                           torch.tensor([n], dtype=torch.int32))
    pre, _ = M.prefill(cfg, params, torch.from_numpy(toks[:, :n + 1]),
                       M.init_cache(cfg, 1, 64, "cpu"))
    return _np(dec), _np(pre)

SERVE_SHAPES = ["decode_32k", "prefill_32k", "prefill_s32768_b2"]


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", SMOKE])
@pytest.mark.parametrize("shape", SERVE_SHAPES)
def test_serve_memory_estimate_matches_jax(arch, shape):
    want = jserve_memory(jreg.resolve_config(arch), jreg.get_shape(shape),
                         MESH, depth=1, cache_seq_shard=False)
    got = estimate_serve_memory(treg.resolve_config(arch),
                                treg.get_shape(shape))
    assert got.kv_cache == pytest.approx(want.kv_cache, rel=1e-12)
    assert got.total == pytest.approx(want.total, rel=1e-12)


# --- serving ------------------------------------------------------------------

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
