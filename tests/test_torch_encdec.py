"""The port's encoder-decoder family (whisper) on the CPU against the JAX
package.

The same seeded numpy inputs go through both packages: the template
(paths, shapes, dtypes, logical axes) at full size with nothing
allocated, the params carried across with ``convert``, the encoder's
output, the training logits, ``prefill(frames=)``'s logits and every
cache leaf (the cross-attention cache ``['cross'][0]``/``[1]`` too),
decode steps, three train steps against the pure JAX step function with
frames bit-identical from both pipelines, and the serving engine's
greedy tokens against the JAX engine, which admits an enc-dec request by
replaying it through batch-1 decode steps from a fresh cache: its cross
cache stays at its zero init, in both packages (ROADMAP C21). Then the
port's own C/R: trainer and engine kill -> ``restore("latest")`` ->
continue, bit-identical.

Tolerances: float32 1e-5 elementwise (the same math summed in another
order by XLA and by PyTorch's CPU kernels); bfloat16 2e-2 in the
relative 2-norm (the two frameworks round to bf16 at other places,
ROADMAP C8).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import registry as jreg
from repro.core.split_state import flatten_with_paths as jflat
from repro.data.pipeline import DataConfig as JData
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.models import model as JM
from repro.optim import AdamWConfig as JAdamW
from repro.optim import ScheduleConfig as JSchedule
from repro.optim import init_opt_state as jinit_opt
from repro.parallel.planner import make_plan as jmake_plan
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.api import CheckpointSession, Policy
from repro_torch.configs import registry as treg
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, ScheduleConfig, init_opt_state
from repro_torch.parallel.planner import make_plan
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.train import step as S
from repro_torch.train.loop import Trainer, TrainJob
from repro_torch.tree import flatten_with_paths

SMOKE = "whisper-base-smoke"
MATRIX = "whisper-base-matrix"
SHAPE = "train_s16_b4"
MESH = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
SMALL = dict(sparse_chunk_bytes=1024, sparse_min_bytes=2048)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bytes(v) -> bytes:
    return np.ascontiguousarray(np.asarray(v)).tobytes()


def _close(got, want, dtype):
    a, b = _np(got), _np(want)
    assert a.shape == b.shape
    if dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    else:
        assert np.linalg.norm(a - b) <= 2e-2 * np.linalg.norm(b)


@functools.lru_cache(maxsize=None)
def _pair_np(arch, dtype, seed=0):
    """The JAX package's params for ``arch`` as numpy, with the
    zero- and one-init leaves (layernorm scales and biases, MLP biases)
    perturbed so that a comparison sees every parameter."""
    jcfg = jreg.resolve_config(arch).replace(dtype=dtype)
    p = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed + 11)

    def perturb(node):
        for k, v in node.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("scale", "bias", "b_in", "b_out"):
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


def _inputs(cfg, B, S, seed):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.randn(B, cfg.encoder_seq, cfg.frontend_dim).astype(
        np.float32)
    return toks, frames


# --- template, params ------------------------------------------------------------

def test_full_size_template_matches_jax_without_allocating():
    """whisper-base's params, cache and batch axes as ``TensorSpec``s:
    the JAX package's paths, shapes, dtypes and logical axes. Its
    template holds 70,658,560 params, where ``ModelConfig.n_params()``
    says 70,607,872: it leaves out the layernorm and MLP biases
    (ROADMAP C14)."""
    jcfg = jreg.resolve_config("whisper-base")
    tcfg = treg.resolve_config("whisper-base")
    want = [(p, tuple(v.shape), str(v.dtype))
            for p, v in jflat(JM.init_abstract(jcfg))]
    got = [(p, v.shape, str(v.dtype).replace("torch.", ""))
           for p, v in flatten_with_paths(M.init_abstract(tcfg))]
    assert got == want
    assert any(p.startswith("['enc_layers']") for p, _, _ in got)
    assert any(p.startswith("['layers']['cross']") for p, _, _ in got)
    assert M.logical_specs(tcfg) == JM.logical_specs(jcfg)
    assert M.param_count(tcfg) == JM.param_count(jcfg) == 70_658_560
    assert tcfg.n_params() == jcfg.n_params() == 70_607_872
    jspec = [(p, tuple(s.shape), str(s.dtype))
             for p, s in jflat(JM.cache_spec(jcfg, 4, 448))]
    tspec = [(p, s.shape, str(s.dtype).replace("torch.", ""))
             for p, s in flatten_with_paths(M.cache_spec(tcfg, 4, 448))]
    assert tspec == jspec
    assert [p for p, _, _ in tspec] == [
        "['cross'][0]", "['cross'][1]", "['self']['k']", "['self']['pos']",
        "['self']['v']"]
    assert tspec[0][1] == (6, 4, 1500, 8, 64)
    axes = dict(flatten_with_paths(M.batch_axes(tcfg)))
    assert axes == dict.fromkeys((p for p, _, _ in tspec), 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_carry_across_with_their_bits(dtype):
    p = _pair_np(SMOKE, dtype)
    t = convert.params_from_numpy(p, "cpu")
    back = dict(flatten_with_paths(convert.tree_to_numpy(t)))
    want = dict(jflat(p))
    assert sorted(back) == sorted(want)
    for path, v in want.items():
        assert _bytes(back[path]) == _bytes(v), path
    assert t["layers"]["cross"]["wq"].dtype == (
        torch.float32 if dtype == "float32" else torch.bfloat16)


def test_a_jax_cache_carries_across_with_its_bits():
    """The JAX package's decode state after ``prefill(frames=)`` — the
    ``self`` KV cache beside the ``cross`` tuple — through
    ``convert.cache_from_numpy``: the same paths, the tuple kept, the
    same bits (bf16 as its 16-bit pattern); the port decodes on from it
    as the JAX package does."""
    jcfg, tcfg, jparams, tparams = _pair(SMOKE, "bfloat16")
    toks, frames = _inputs(jcfg, 2, 7, seed=9)
    _, jc = JM.prefill(jcfg, jparams, jnp.asarray(toks),
                       JM.init_cache(jcfg, 2, 16), frames=jnp.asarray(frames))
    jnp_cache = jax.tree.map(np.asarray, jc)
    tc = convert.cache_from_numpy(jnp_cache, "cpu")
    assert isinstance(tc["cross"], tuple) and len(tc["cross"]) == 2
    want = dict(jflat(jnp_cache))
    got = dict(flatten_with_paths(convert.tree_to_numpy(tc)))
    assert sorted(got) == sorted(want)
    for path, v in want.items():
        assert _bytes(got[path]) == _bytes(v), path
    nxt, pos = np.array([[3], [5]], np.int32), np.array([7, 7], np.int32)
    jl, _ = JM.decode_step(jcfg, jparams, jc, jnp.asarray(nxt),
                           jnp.asarray(pos))
    tl, _ = M.decode_step(tcfg, tparams, tc, torch.from_numpy(nxt),
                          torch.from_numpy(pos))
    _close(tl, jl, "bfloat16")


# --- forward -------------------------------------------------------------------

@pytest.mark.parametrize("arch", [SMOKE, MATRIX])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_output_matches_jax(arch, dtype):
    jcfg, tcfg, jparams, tparams = _pair(arch, dtype)
    _, frames = _inputs(jcfg, 2, 1, seed=1)
    want = JM._whisper_encoder(jcfg, JM.CallOptions(), jparams,
                               jnp.asarray(frames))
    got = M._whisper_encoder(tcfg, tparams, torch.from_numpy(frames))
    assert got.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_logits_match_jax(dtype):
    jcfg, tcfg, jparams, tparams = _pair(SMOKE, dtype)
    toks, frames = _inputs(jcfg, 2, 24, seed=2)
    want, _ = JM.forward_train(jcfg, jparams, {
        "tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    for remat in ("none", "full"):
        got, aux = M.forward_train(tcfg, tparams, {
            "tokens": torch.from_numpy(toks),
            "frames": torch.from_numpy(frames)}, M.CallOptions(remat=remat))
        _close(got, want, dtype)
        assert float(aux["moe_aux"]) == 0.0


def test_forward_and_prefill_need_frames():
    _, tcfg, _, tparams = _pair()
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="frames"):
        M.forward_train(tcfg, tparams, {"tokens": toks})
    cache = M.init_cache(tcfg, 1, 16, "cpu")
    with pytest.raises(ValueError, match="frames"):
        M.prefill(tcfg, tparams, toks, cache)
    short = torch.zeros((1, tcfg.encoder_seq - 1, tcfg.frontend_dim))
    with pytest.raises(ValueError, match="encoder positions"):
        M.prefill(tcfg, tparams, toks, cache, frames=short)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """prefill(frames=) (logits, the self cache and the cross cache),
    then 8 decode steps: logits each step, every cache leaf after; the
    cross cache is read by decode and left as prefill wrote it."""
    jcfg, tcfg, jparams, tparams = _pair(SMOKE, dtype)
    toks, frames = _inputs(jcfg, 2, 10, seed=3)
    jlast, jc = JM.prefill(jcfg, jparams, jnp.asarray(toks),
                           JM.init_cache(jcfg, 2, 32),
                           frames=jnp.asarray(frames))
    tc = M.init_cache(tcfg, 2, 32, "cpu")
    tlast, tc2 = M.prefill(tcfg, tparams, torch.from_numpy(toks), tc,
                           frames=torch.from_numpy(frames))
    assert tc2 is tc                                 # written in place
    _close(tlast, jlast, dtype)

    def leaves_match(jc, tc):
        want = dict(flatten_with_paths(jax.tree.map(np.asarray, jc)))
        got = dict(flatten_with_paths(tc))
        assert sorted(got) == sorted(want)
        for path, t in got.items():
            if path.endswith("['pos']"):
                np.testing.assert_array_equal(t.numpy(), want[path])
            else:
                _close(t, want[path], dtype)
    leaves_match(jc, tc)
    assert float(tc["cross"][0].float().abs().max()) > 0
    cross = tuple(c.clone() for c in tc["cross"])
    rng = np.random.RandomState(4)
    dec = jax.jit(functools.partial(JM.decode_step, jcfg))
    for pos in range(10, 18):
        nxt = rng.randint(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        p = np.array([pos, pos], np.int32)
        jl, jc = dec(jparams, jc, jnp.asarray(nxt), jnp.asarray(p))
        tl, tc = M.decode_step(tcfg, tparams, tc, torch.from_numpy(nxt),
                               torch.from_numpy(p))
        _close(tl, jl, dtype)
    leaves_match(jc, tc)
    for a, b in zip(tc["cross"], cross):
        assert torch.equal(a, b)


def test_decode_after_prefill_equals_forward_train():
    """Greedy decode after prefill(frames=) gives, at every step, the
    logits that forward_train over the extended sequence gives at that
    position (f32): the cache path and the no-cache path agree, encoder,
    decoder and cross-attention."""
    _, tcfg, _, tparams = _pair()
    toks, frames = _inputs(tcfg, 2, 6, seed=5)
    cache = M.init_cache(tcfg, 2, 32, "cpu")
    last, _ = M.prefill(tcfg, tparams, torch.from_numpy(toks), cache,
                        frames=torch.from_numpy(frames))
    seq, steps = torch.from_numpy(toks), [last]
    for pos in range(6, 14):
        nxt = torch.argmax(steps[-1], dim=-1).to(torch.int32)[:, None]
        seq = torch.cat([seq, nxt], dim=1)
        logits, cache = M.decode_step(tcfg, tparams, cache, nxt,
                                      torch.tensor([pos, pos],
                                                   dtype=torch.int32))
        steps.append(logits)
    full, _ = M.forward_train(tcfg, tparams, {
        "tokens": seq, "frames": torch.from_numpy(frames)})
    for i, got in enumerate(steps[:-1]):
        _close(got, full[:, 5 + i], "float32")


# --- training --------------------------------------------------------------------

def test_pipeline_frames_are_bit_identical():
    kw = dict(seed=1234, vocab_size=256, seq_len=16, global_batch=4,
              n_shards=4, frames=24, frame_dim=64)
    for cursor in (0, 5):
        want = JPipeline(JData(**kw)).batch_at(cursor)
        got = TokenPipeline(DataConfig(**kw)).batch_at(cursor)
        assert sorted(got) == sorted(want) == ["frames", "targets", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert _bytes(got[k]) == _bytes(want[k])


def test_three_train_steps_match_the_jax_step():
    """Three f32 steps from the same params, on batches with frames that
    both pipelines make bit for bit. Loss and grad_norm to 1e-5
    relative, params to 1e-6 absolute (a warmup step moves a param by
    ~1e-6), moments to 1e-4 relative and 1e-7 absolute, as
    ``test_torch_train`` holds the decoder-only families."""
    jcfg, tcfg, jparams, params = _pair()
    shape = jreg.get_shape(SHAPE)
    jopt = jinit_opt(jparams, JAdamW())
    opt = init_opt_state(params, AdamWConfig())
    plan = jmake_plan(jcfg, shape, MESH)
    jfn = jax.jit(jstep.make_train_step(jcfg, plan, JAdamW(), JSchedule(),
                                        mesh=None))
    tstep = S.make_train_step(tcfg, make_plan(tcfg, treg.get_shape(SHAPE)),
                              AdamWConfig(), ScheduleConfig())
    kw = dict(seed=5, vocab_size=tcfg.vocab_size, seq_len=16,
              global_batch=4, n_shards=4, frames=tcfg.encoder_seq,
              frame_dim=tcfg.frontend_dim)
    jpipe, pipe = JPipeline(JData(**kw)), TokenPipeline(DataConfig(**kw))
    for step in range(3):
        jbatch, batch = jpipe.batch_at(step), pipe.batch_at(step)
        assert _bytes(batch["frames"]) == _bytes(jbatch["frames"])
        jparams, jopt, jm = jfn(jparams, jopt,
                                {k: jnp.asarray(v) for k, v in jbatch.items()},
                                jnp.int32(step), jnp.float32(1.0))
        params, opt, tm = tstep(params, opt,
                                {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                                step, torch.tensor(1.0))
        for key in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
    want = dict(flatten_with_paths(jax.tree.map(np.asarray, jparams)))
    for path, a in flatten_with_paths(params):
        np.testing.assert_allclose(_np(a), want[path], rtol=0, atol=1e-6,
                                   err_msg=path)
    jo = jax.tree.map(np.asarray, jopt)
    for mom in ("mu", "nu"):
        want = dict(flatten_with_paths(jo[mom]))
        for path, a in flatten_with_paths(opt[mom]):
            np.testing.assert_allclose(_np(a), want[path], rtol=1e-4,
                                       atol=1e-7, err_msg=mom + path)
    assert int(opt["count"]) == int(jo["count"]) == 3


def test_train_input_specs_and_plan():
    cfg = treg.resolve_config("whisper-base")
    specs = S.train_input_specs(cfg, treg.get_shape("train_s4096_b8"))
    assert specs["frames"] == M.TensorSpec((8, 1500, 512), torch.float32)
    plan = make_plan(cfg, treg.get_shape("train_s4096_b8"))
    want = jmake_plan(jreg.resolve_config("whisper-base"),
                      jreg.get_shape("train_s4096_b8"), MESH)
    assert (plan.grad_accum, plan.remat) == (want.grad_accum, want.remat)


@pytest.mark.parametrize("label,policy", [
    ("chain2", Policy(interval=2, chain=2, **SMALL)),
    ("dense", Policy(interval=2, chain=2, sparse=False)),
])
def test_trainer_kill_restore_continues_bit_identically(tmp_path, label,
                                                        policy):
    sess = CheckpointSession(f"localfs:{tmp_path}", policy)
    t = Trainer(TrainJob(SMOKE, SHAPE), manager=sess.manager, device="cpu")
    t.init_state()
    sess.attach(t)
    assert t.pipeline.batch_at(0)["frames"].shape == (4, 24, 64)
    losses = []
    for _ in range(5):
        losses.append(t.train_steps(1)["loss"])
        sess.maybe_snapshot()
    sess.wait()
    want = t.state_digest()
    assert sess.restorable_steps() == [2, 4]
    sess.close()
    del t                                        # the kill
    sess2 = CheckpointSession(f"localfs:{tmp_path}", policy)
    t2 = sess2.restore("latest", expect_kind="train", device="cpu")
    assert t2.checkpoint_step() == 4
    assert t2.train_steps(1)["loss"] == losses[4]
    assert t2.state_digest() == want
    sess2.close()


# --- serving -------------------------------------------------------------------

def _prompts(vocab, n=4, seed=5, lo=3, hi=12):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=rng.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _run(eng, prompts, max_new):
    reqs = [Request(rid=i, prompt=p.copy(), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_steps=400)
    return {r.rid: list(r.out) for r in reqs}


@pytest.mark.parametrize("arch", [SMOKE, MATRIX])
def test_engine_tokens_equal_the_jax_engine(arch):
    """Both engines admit by replay (batch-1 decode steps from a fresh
    cache), so the cross cache is never written: the greedy tokens
    agree, and both caches' cross leaves are still zero after serving
    (ROADMAP C21)."""
    jcfg, tcfg, jparams, tparams = _pair(arch)
    prompts = _prompts(jcfg.vocab_size)
    jeng = JEngine(jcfg, jparams, MESH, n_slots=2, max_seq=32)
    jreqs = [JRequest(rid=i, prompt=p.copy(), max_new=10)
             for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_drained(max_steps=400)
    teng = ServingEngine(tcfg, tparams, "cpu", n_slots=2, max_seq=32)
    assert not teng._prefill_admission
    got = _run(teng, prompts, 10)
    assert got == {r.rid: list(r.out) for r in jreqs}
    assert all(len(v) == 10 for v in got.values())
    for c in jeng.cache["cross"]:
        assert not np.asarray(c).any()
    for c in teng.cache["cross"]:
        assert not c.any()
    assert (teng.cache["self"]["pos"] >= 0).any()


def test_engine_replay_equals_a_jax_decode_loop():
    """The port's 2-slot engine gives each request the tokens of the JAX
    package's batch-1 decode_step loop from ``init_cache`` (what the
    reference engine's replay admission runs)."""
    jcfg, tcfg, jparams, tparams = _pair()
    prompts = _prompts(jcfg.vocab_size, n=3, seed=8, lo=6, hi=12)
    got = _run(ServingEngine(tcfg, tparams, "cpu", n_slots=2, max_seq=48),
               prompts, 16)
    dec = jax.jit(functools.partial(JM.decode_step, jcfg))
    for i, prompt in enumerate(prompts):
        cache = JM.init_cache(jcfg, 1, 48)
        for pos, t in enumerate(prompt[:-1]):
            _, cache = dec(jparams, cache, jnp.asarray([[t]], jnp.int32),
                           jnp.asarray([pos], jnp.int32))
        tok, out = int(prompt[-1]), []
        for pos in range(len(prompt) - 1, len(prompt) + 15):
            logits, cache = dec(jparams, cache, jnp.asarray([[tok]],
                                                            jnp.int32),
                                jnp.asarray([pos], jnp.int32))
            tok = int(jnp.argmax(logits[0]))
            out.append(tok)
        assert got[i] == out, i


@functools.lru_cache(maxsize=None)
def _serving_params():
    return convert.params_from_numpy(_pair_np(SMOKE, "bfloat16"), "cpu")


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("new_slots", [2, 3])
def test_engine_kill_restore_continues_token_identically(tmp_path, streaming,
                                                         new_slots):
    params = _serving_params()
    prompts = _prompts(256, n=5, seed=3)
    ref = _run(ServingEngine.create(SMOKE, params, n_slots=2, max_seq=48,
                                    device="cpu"), prompts, 6)
    policy = Policy(interval=4, chain=4, **SMALL)
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
    done = {r.rid: list(r.out) for r in reqs if r.done}
    sess.close()
    del eng, sess                                  # the kill
    sess2 = CheckpointSession(f"localfs:{tmp_path}", policy)
    eng2 = sess2.restore("latest", params=params, device="cpu",
                         n_slots=new_slots,
                         streaming=streaming and new_slots == 2)
    assert eng2.n_slots == new_slots and eng2.steps == 8
    live = eng2.live_requests()
    eng2.run_until_drained(max_steps=400)
    got = dict(done)
    got.update({r.rid: list(r.out) for r in live})
    assert got == ref
    for c in eng2.cache["cross"]:
        assert not c.any()
    sess2.close()
