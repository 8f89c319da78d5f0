"""The port's moe family (llama4-scout: top-1 and a shared expert;
kimi-k2: top-k and a shared expert) on the CPU against the JAX package.

The same seeded numpy inputs go through both packages: the router
(gates, expert ids, the Switch aux loss), the capacity over a grid, the
dispatch/experts/combine with capacity forced small so that choices
drop, for top-1, top-2 and top-8, exact ties (a zero router: both take
experts 0..k-1) and near ties (counted, and left out of the id
comparison only where the k-th and (k+1)-th probabilities lie within
1e-5), ``moe_forward`` and its gradients against ``jax.grad``, the
template at full size with nothing allocated, the smoke models'
training logits and ``moe_aux`` with the params carried across by
``convert``, three train steps against the pure JAX step, and the
serving engine's greedy tokens against the JAX engine's prefill
admission, with prompts that make prefill drop. Then the port's own
C/R: trainer and engine kill -> ``restore`` -> continue, the engine
also re-slotted.

Tolerances: float32 1e-5 elementwise (the same math summed in another
order by XLA and by PyTorch's CPU kernels); bfloat16 2e-2 in the
relative 2-norm (the two frameworks round to bf16 at other places,
ROADMAP C8).
"""
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import registry as jreg
from repro.core.split_state import flatten_with_paths as jflat
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.optim import AdamWConfig as JAdamW
from repro.optim import ScheduleConfig as JSchedule
from repro.optim import init_opt_state as jinit_opt
from repro.parallel.planner import estimate_train_memory as jestimate
from repro.parallel.planner import make_plan as jmake_plan
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.api import CheckpointSession, Policy
from repro_torch.configs import registry as treg
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.optim import AdamWConfig, ScheduleConfig, init_opt_state
from repro_torch.parallel.planner import estimate_train_memory, make_plan
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.train import step as S
from repro_torch.train.loop import Trainer, TrainJob
from repro_torch.tree import fill_like, flatten_with_paths

LLAMA4, KIMI = "llama4-scout-17b-a16e", "kimi-k2-1t-a32b"
SMOKES = [LLAMA4 + "-smoke", KIMI + "-smoke"]
SHAPE = "train_s16_b4"
MESH = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
SMALL = dict(sparse_chunk_bytes=1024, sparse_min_bytes=2048)
NEAR = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype="float32"):
    a, b = _np(got), _np(want)
    assert a.shape == b.shape
    if dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    else:
        assert np.linalg.norm(a - b) <= 2e-2 * np.linalg.norm(b)


def _cfgs(arch, **kw):
    return (jreg.resolve_config(arch).replace(**kw),
            treg.resolve_config(arch).replace(**kw))


@functools.lru_cache(maxsize=None)
def _pair_np(arch, dtype, seed=0):
    """The JAX package's params as numpy, the zero-init norm scales
    perturbed so that a comparison sees them."""
    jcfg = jreg.resolve_config(arch).replace(dtype=dtype)
    p = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed + 11)

    def perturb(node):
        for k, v in node.items():
            if isinstance(v, dict):
                perturb(v)
            elif k == "scale":
                node[k] = (v + 0.1 * rng.randn(*v.shape)).astype(v.dtype)
    perturb(p)
    return p


def _pair(arch, dtype="float32"):
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    p = _pair_np(arch, dtype)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, p), \
        convert.params_from_numpy(p, "cpu")


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


# --- template, capacity ------------------------------------------------------

@pytest.mark.parametrize("arch", [LLAMA4, KIMI])
def test_full_size_template_matches_jax_without_allocating(arch):
    """Paths, shapes, dtypes (the router f32, the experts stacked 4-D)
    and logical axes at the published size; the template's count is
    ``ModelConfig.n_params()``'s in both packages."""
    jcfg, tcfg = _cfgs(arch)
    want = [(p, tuple(v.shape), str(v.dtype))
            for p, v in jflat(JM.init_abstract(jcfg))]
    got = [(p, v.shape, str(v.dtype).replace("torch.", ""))
           for p, v in flatten_with_paths(M.init_abstract(tcfg))]
    assert got == want
    leaves = dict((p, (s, d)) for p, s, d in got)
    e, d, f = tcfg.n_experts, tcfg.d_model, tcfg.resolved_moe_d_ff
    assert leaves["['layers']['ffn']['router']"] == (
        (tcfg.n_layers, d, e), "float32")
    assert leaves["['layers']['ffn']['w_gate']"] == (
        (tcfg.n_layers, e, d, f), "bfloat16")
    assert "['layers']['ffn']['shared']['w_down']" in leaves
    assert M.logical_specs(tcfg) == JM.logical_specs(jcfg)
    assert M.param_count(tcfg) == JM.param_count(jcfg) == tcfg.n_params() \
        == jcfg.n_params()
    jspec = [(p, tuple(s.shape), str(s.dtype))
             for p, s in jflat(JM.cache_spec(jcfg, 4, 1024))]
    tspec = [(p, s.shape, str(s.dtype).replace("torch.", ""))
             for p, s in flatten_with_paths(M.cache_spec(tcfg, 4, 1024))]
    assert tspec == jspec


@pytest.mark.parametrize("arch", [LLAMA4, KIMI])
def test_matrix_and_depth_cut_configs_run(arch):
    """``-matrix`` trains two steps and serves two requests on the CPU;
    ``<id>-layers<N>`` keeps the published width (its template counted
    without allocating, one layer's leaves N times)."""
    t = Trainer(TrainJob(arch + "-matrix", "train_s8_b2"), device="cpu")
    t.init_state()
    assert all(t.train_steps(1)["moe_aux"] > 0 for _ in range(2))
    cfg = treg.resolve_config(arch + "-matrix")
    eng = ServingEngine(cfg, M.init_params(cfg, 0, "cpu"), "cpu", n_slots=2,
                        max_seq=32)
    got = _run(eng, [np.arange(5, dtype=np.int32),
                     np.arange(3, 12, dtype=np.int32)], 4)
    assert all(len(v) == 4 for v in got.values())
    full = treg.resolve_config(arch)
    one, two = (M.param_count(treg.resolve_config(f"{arch}-layers{n}"))
                for n in (1, 2))
    assert treg.resolve_config(arch + "-layers2") == full.replace(n_layers=2)
    assert M.param_count(full) == one + (full.n_layers - 1) * (two - one)


def test_capacity_matches_jax_over_a_grid():
    for t in (1, 2, 3, 4, 7, 8, 16, 64, 100, 512, 4096, 32768):
        for k, e in ((1, 2), (1, 4), (1, 16), (2, 4), (2, 8), (8, 384)):
            for cf in (1.0, 1.25, 2.0, 0.5):
                assert MOE._capacity(t, k, e, cf) == \
                    JMOE._capacity(t, k, e, cf), (t, k, e, cf)


def test_decode_never_drops_at_eight_slots_or_fewer():
    """With T <= 8 tokens a call, capacity is 8 for top-1 of 16 and top-8
    of 384, and each token's k choices are distinct experts, so no
    expert can receive more than T <= 8 choices."""
    for arch in (LLAMA4, KIMI):
        cfg = treg.resolve_config(arch)
        for t in range(1, 9):
            assert MOE._capacity(t, cfg.experts_per_token, cfg.n_experts,
                                 cfg.capacity_factor) == 8
            # every token the same k experts: the worst case
            idx = torch.randperm(cfg.n_experts)[
                :cfg.experts_per_token].repeat(t, 1)
            slots = MOE._slots(idx, cfg.n_experts, 8)
            assert (slots < cfg.n_experts * 8).all()


# --- router ------------------------------------------------------------------

ROUTES = [(4, 1), (16, 1), (8, 2), (384, 8)]


def _route_pair(e, k, x, w):
    jcfg, tcfg = _cfgs(KIMI + "-smoke", n_experts=e, experts_per_token=k)
    jg, ji, ja = JMOE.route(jcfg, jnp.asarray(w), jnp.asarray(x))
    tg, ti, ta = MOE.route(tcfg, torch.from_numpy(w), torch.from_numpy(x))
    return (np.asarray(jg), np.asarray(ji), float(ja)), \
        (tg.numpy(), ti.numpy(), float(ta))


@pytest.mark.parametrize("e,k", ROUTES)
def test_route_matches_jax(e, k):
    """Gates within 1e-5 and aux within 1e-5 relative; the chosen
    experts equal as a set wherever the k-th and (k+1)-th probabilities
    lie more than 1e-5 apart, and in order wherever the first k + 1 keep
    such gaps. Near ties are counted: at least 90% of the tokens must
    be held to the ordered comparison."""
    rng = np.random.RandomState(e + k)
    x = rng.randn(4, 64, 64).astype(np.float32)
    w = (rng.randn(64, e) / 8).astype(np.float32)
    (jg, ji, ja), (tg, ti, ta) = _route_pair(e, k, x, w)
    assert ti.dtype == np.int32 and ti.shape == ji.shape == (4, 64, k)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(w), -1))
    top = -np.sort(-probs, axis=-1)[..., :min(k + 1, e)]
    gaps = -np.diff(top, axis=-1)
    near_set = (gaps[..., k - 1] <= NEAR if k < e
                else np.zeros(gaps.shape[:-1], bool))
    near = (gaps <= NEAR).any(-1)
    assert near.mean() <= 0.1, f"{near.sum()} of {near.size} near ties"
    assert (np.sort(ti[~near_set], -1) == np.sort(ji[~near_set], -1)).all()
    assert (ti[~near] == ji[~near]).all()
    np.testing.assert_allclose(tg[~near_set], jg[~near_set], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ta, ja, rtol=1e-5)


@pytest.mark.parametrize("e,k", ROUTES)
def test_route_exact_ties_take_the_lower_expert(e, k):
    """A zero router: every probability is 1/E, and both packages take
    experts 0..k-1 in order with gates 1/k; equal probabilities in part
    of the row (two experts' router columns equal) keep index order."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 64).astype(np.float32)
    (jg, ji, ja), (tg, ti, ta) = _route_pair(
        e, k, x, np.zeros((64, e), np.float32))
    assert (ti == ji).all() and (ti == np.arange(k)).all()
    np.testing.assert_allclose(tg, jg, rtol=1e-6)
    np.testing.assert_allclose(ta, ja, rtol=1e-6)
    w = rng.randn(64, e).astype(np.float32)
    w[:, 1::2] = w[:, ::2][:, :e // 2]          # experts 2i and 2i+1 equal
    (jg, ji, _), (tg, ti, _) = _route_pair(e, k, x, w)
    assert (ti == ji).all()
    if k > 1:
        assert (ti[..., 1] == ti[..., 0] + 1).all()


# --- dispatch, experts, combine ----------------------------------------------

@pytest.mark.parametrize("e,k", [(4, 1), (8, 2), (16, 8)])
@pytest.mark.parametrize("capacity", [8, 16])
def test_dispatch_compute_combine_matches_jax_with_drops(e, k, capacity):
    """The same routing (skewed towards the low experts, so that
    capacity 8 or 16 drops choices) through both packages' dispatch,
    experts and combine: f32 within 1e-5; the dropped choices add
    nothing."""
    t, d, f = 96, 32, 24
    rng = np.random.RandomState(e * k + capacity)
    x = rng.randn(t, d).astype(np.float32)
    idx = np.argsort(-(rng.rand(t, e) + np.linspace(1.0, 0.0, e)), axis=-1
                     )[:, :k].astype(np.int32)
    gates = rng.rand(t, k).astype(np.float32)
    ws = [(rng.randn(*s) / np.sqrt(s[1])).astype(np.float32)
          for s in ((e, d, f), (e, d, f), (e, f, d))]
    want = jax.jit(functools.partial(
        JMOE._dispatch_compute_combine, shard_index=0, n_shards=1,
        capacity=capacity))(jnp.asarray(x), jnp.asarray(gates),
                            jnp.asarray(idx), *map(jnp.asarray, ws))
    got = MOE._dispatch_compute_combine(
        torch.from_numpy(x), torch.from_numpy(gates), torch.from_numpy(idx),
        *map(torch.from_numpy, ws), capacity)
    _close(got, want)
    slots = MOE._slots(torch.from_numpy(idx), e, capacity)
    dropped = slots == e * capacity
    assert dropped.any() and not dropped.all()
    # the kept choices of each expert fill its first slots in token order
    for ex in range(e):
        mine = (torch.from_numpy(idx) == ex) & ~dropped
        assert sorted(slots[mine].tolist()) == list(
            range(ex * capacity, ex * capacity + int(mine.sum())))
    # no gate of a dropped choice reaches the output
    g0 = gates.copy()
    g0[dropped.numpy()] = 0.0
    again = MOE._dispatch_compute_combine(
        torch.from_numpy(x), torch.from_numpy(g0), torch.from_numpy(idx),
        *map(torch.from_numpy, ws), capacity)
    assert torch.equal(again, got)


@pytest.mark.parametrize("arch", SMOKES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_forward_matches_jax(arch, dtype):
    jcfg, tcfg, jp, tp = _pair(arch, dtype)
    x = np.random.RandomState(3).randn(2, 24, tcfg.d_model).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jy, ja = jax.jit(functools.partial(JMOE.moe_forward, jcfg))(
        _layer0(jp["layers"]["ffn"]), jx)
    ty, ta = MOE.moe_forward(tcfg, _layer0(tp["layers"]["ffn"]), tx)
    assert ty.dtype == tx.dtype and ta.dtype == torch.float32
    _close(ty, jy, dtype)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    again, _ = MOE.moe_forward(tcfg, _layer0(tp["layers"]["ffn"]), tx)
    assert torch.equal(again, ty)


@functools.lru_cache(maxsize=None)
def _jax_grads(arch, part):
    jcfg, _, jp, _ = _pair(arch)
    x, r = _grad_inputs(jcfg.d_model)

    def loss(p, xx):
        y, aux = JMOE.moe_forward(jcfg, p, xx)
        return jnp.sum(y * jnp.asarray(r)) if part == "y" else aux
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        _layer0(jp["layers"]["ffn"]), jnp.asarray(x))
    return dict(jflat(jax.tree.map(np.asarray, gp)), x=np.asarray(gx))


def _grad_inputs(d):
    rng = np.random.RandomState(4)
    return (rng.randn(2, 16, d).astype(np.float32),
            rng.randn(2, 16, d).astype(np.float32))


@pytest.mark.parametrize("arch", SMOKES)
@pytest.mark.parametrize("part", ["y", "aux"])
def test_moe_forward_gradients_match_jax_grad(arch, part):
    """d/d(x and every router, expert and shared-expert leaf) of
    sum(y * r) and, apart, of the aux loss, in f32 against
    ``jax.grad``: within rtol 1e-5 and 1e-5 of the leaf's largest
    gradient. The one exception is the router's gradient of sum(y * r)
    under top-1: the gate is p / p, 1 for every input, so that gradient
    is zero and both packages give rounding noise; it is held to 1e-5
    of the input gradient's scale in each."""
    _, tcfg, _, tp = _pair(arch)
    x, r = _grad_inputs(tcfg.d_model)
    ffn = _layer0(tp["layers"]["ffn"])
    leaves = {p: v.clone().requires_grad_(True)
              for p, v in flatten_with_paths(ffn)}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = MOE.moe_forward(tcfg, fill_like(ffn, leaves), tx)
    (torch.sum(y * torch.from_numpy(r)) if part == "y" else aux).backward()
    want = _jax_grads(arch, part)
    assert sorted(want) == sorted(leaves) + ["x"]
    scale_x = float(np.abs(want["x"]).max())
    for path, g in want.items():
        got = tx.grad if path == "x" else leaves[path].grad
        got = np.zeros_like(g) if got is None else _np(got)
        if path == "['router']" and part == "y" and \
                tcfg.experts_per_token == 1:
            assert np.abs(got).max() <= 1e-5 * scale_x
            assert np.abs(g).max() <= 1e-5 * scale_x
            continue
        np.testing.assert_allclose(got, g, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(g).max()),
                                   err_msg=path)


def test_more_than_one_device_raises_naming_a9():
    """ROADMAP A9a lifted the MoE's one-device refusal: under a process
    group of two a plain tensor's MoE runs on its device, to the same
    bits (expert parallelism takes DTensors, ``test_torch_mesh.py``).
    What still names A9 is cross-attention under a mesh — the
    encoder-decoder over a mesh waits for A9b step 4 (attention with a
    cache runs over a mesh since A9b step 1, ``test_torch_mesh.py``)."""
    _, tcfg, _, tp = _pair(SMOKES[0])
    p = _layer0(tp["layers"]["ffn"])
    x = torch.randn(1, 4, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    want = MOE.moe_forward(tcfg, p, x)
    dist = torch.distributed
    with mock.patch.object(dist, "is_initialized", lambda: True), \
            mock.patch.object(dist, "get_world_size", lambda *a: 2):
        got = MOE.moe_forward(tcfg, p, x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    from repro_torch.models import layers as L
    attn = _layer0(tp["layers"]["attn"])
    kv = torch.zeros(1, 4, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    with mock.patch.object(L, "is_dtensor", lambda t: True):
        with pytest.raises(NotImplementedError, match="A9b step 4"):
            L.attention_forward(tcfg, attn, x, torch.zeros(
                (1, 4), dtype=torch.int32), cross_kv=(kv, kv))


# --- the model ---------------------------------------------------------------

def _routed_forward_train(arch, dtype, toks):
    """forward_train in both packages, with each layer's routing: (JAX
    logits, JAX aux, [JAX idx per layer], port logits, port aux, [(port
    idx, port router probabilities) per layer])."""
    jcfg, tcfg, jp, tp = _pair(arch, dtype)
    jr, tr = [], []
    jroute, troute = JMOE.route, MOE.route

    def jwrap(cfg, w, x):
        out = jroute(cfg, w, x)
        jax.debug.callback(lambda i: jr.append(np.asarray(i)), out[1],
                           ordered=True)
        return out

    def twrap(cfg, w, x):
        out = troute(cfg, w, x)
        probs = torch.softmax(torch.einsum("bsd,de->bse", x.float(), w), -1)
        tr.append((out[1].numpy(), probs.detach().numpy()))
        return out
    with mock.patch.object(JMOE, "route", jwrap):
        want, jaux = jax.jit(functools.partial(JM.forward_train, jcfg))(
            jp, {"tokens": jnp.asarray(toks)})
        jax.effects_barrier()
    with mock.patch.object(MOE, "route", twrap):
        got, aux = M.forward_train(tcfg, tp,
                                   {"tokens": torch.from_numpy(toks)})
    return want, jaux, jr, got, aux, tr


def _flips(cfg, jr, tr):
    """Where the two packages' routing parts: ([the probability spread of
    the experts each flipped (layer, token) choice swapped], [B, S] mask
    of the tokens whose output it reaches: a token whose experts or
    kept/dropped choices differ at a layer, and at any layer but the
    last every later token of its row, which attends to it)."""
    e, k = cfg.n_experts, cfg.experts_per_token
    B, S, _ = jr[0].shape
    cap = MOE._capacity(B * S, k, e, cfg.capacity_factor)

    def dropped(idx):
        flat = torch.from_numpy(idx.reshape(B * S, k).copy())
        return (MOE._slots(flat, e, cap) == e * cap).numpy().reshape(B, S, k)
    spreads, reached = [], np.zeros((B, S), bool)
    for layer, (ji, (ti, probs)) in enumerate(zip(jr, tr)):
        moved = ji != ti
        for b, t in zip(*np.nonzero(moved.any(-1))):
            ex = np.concatenate([ji[b, t][moved[b, t]], ti[b, t][moved[b, t]]])
            spreads.append(float(np.ptp(probs[b, t, ex])))
        parted = moved.any(-1) | (dropped(ji) != dropped(ti)).any(-1)
        for b, t in zip(*np.nonzero(parted)):
            reached[b, t if layer == len(jr) - 1 else slice(t, None)] = True
    return spreads, reached


@pytest.mark.parametrize("arch", SMOKES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_logits_and_moe_aux_match_jax(arch, dtype):
    """Logits (f32 1e-5 elementwise, bf16 2e-2 in the 2-norm), the aux
    summed over the layers (1e-5 relative in f32, 2e-2 in bf16) and each
    layer's routing. In f32 the routing is the same. In bf16 the two
    packages' hidden states differ by ~1% (ROADMAP C8), and a token
    whose two candidate experts' probabilities lie closer than that can
    route apart (ROADMAP C22): each such flip must swap experts within
    1e-2 of each other in probability, at most 2% of the choices may
    flip, and the logits are held on the tokens no flip (nor the
    capacity drops a flip moves) reaches."""
    toks = np.random.RandomState(2).randint(0, 256, (2, 24)).astype(np.int32)
    want, jaux, jr, got, aux, tr = _routed_forward_train(arch, dtype, toks)
    cfg = treg.resolve_config(arch)
    assert len(jr) == len(tr) == cfg.n_layers
    spreads, reached = _flips(cfg, jr, tr)
    if dtype == "float32":
        assert not spreads and not reached.any()
    assert len(spreads) <= 0.02 * cfg.n_layers * toks.size
    assert all(s <= 1e-2 for s in spreads), spreads
    assert reached.mean() <= 0.25
    _close(got[torch.from_numpy(~reached)], np.asarray(want)[~reached], dtype)
    np.testing.assert_allclose(float(aux["moe_aux"]), float(jaux["moe_aux"]),
                               rtol=1e-5 if dtype == "float32" else 2e-2)
    assert float(aux["moe_aux"]) > 0
    again, _ = M.forward_train(treg.resolve_config(arch).replace(dtype=dtype),
                               _pair(arch, dtype)[3],
                               {"tokens": torch.from_numpy(toks)},
                               M.CallOptions(remat="full"))
    assert torch.equal(again, got)


@pytest.mark.parametrize("arch", SMOKES)
def test_params_cross_both_ways_bit_for_bit(arch):
    """bf16 experts (4-D stacked), the f32 router and the shared expert
    carried JAX -> port -> host arrays give the JAX package's bytes."""
    p = _pair_np(arch, "bfloat16")
    back = dict(flatten_with_paths(convert.tree_to_numpy(
        convert.params_from_numpy(p, "cpu"))))
    for path, a in jflat(p):
        assert back[path].shape == a.shape, path
        assert back[path].tobytes() == np.ascontiguousarray(a).tobytes(), path
    assert back["['layers']['ffn']['router']"].dtype == np.float32


@pytest.mark.parametrize("arch", SMOKES)
def test_three_train_steps_match_the_jax_step(arch):
    """Three f32 steps from the same params and batches, as
    ``test_torch_train`` holds the dense families: loss, ce, grad_norm
    and lr to 1e-5 relative, params to 1e-6 absolute, moments to 1e-4
    relative and 1e-7 absolute; ``moe_aux`` to 1e-5 relative."""
    jcfg, tcfg, jparams, params = _pair(arch)
    shape = jreg.get_shape(SHAPE)
    jopt = jinit_opt(jparams, JAdamW())
    opt = init_opt_state(params, AdamWConfig())
    jfn = jax.jit(jstep.make_train_step(jcfg, jmake_plan(jcfg, shape, MESH),
                                        JAdamW(), JSchedule(), mesh=None))
    tstep = S.make_train_step(tcfg, make_plan(tcfg, treg.get_shape(SHAPE)),
                              AdamWConfig(), ScheduleConfig())
    pipe = TokenPipeline(DataConfig(seed=5, vocab_size=tcfg.vocab_size,
                                    seq_len=16, global_batch=4, n_shards=4))
    for step in range(3):
        batch = pipe.batch_at(step)
        jparams, jopt, jm = jfn(jparams, jopt,
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                jnp.int32(step), jnp.float32(1.0))
        params, opt, tm = tstep(params, opt,
                                {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                                step, torch.tensor(1.0))
        for key in ("loss", "ce", "moe_aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
        assert float(tm["moe_aux"]) > 0
    want = dict(jflat(jax.tree.map(np.asarray, jparams)))
    for path, a in flatten_with_paths(params):
        np.testing.assert_allclose(_np(a), want[path], rtol=0, atol=1e-6,
                                   err_msg=path)
    jo = jax.tree.map(np.asarray, jopt)
    for mom in ("mu", "nu"):
        want = dict(jflat(jo[mom]))
        for path, a in flatten_with_paths(opt[mom]):
            np.testing.assert_allclose(_np(a), want[path], rtol=1e-4,
                                       atol=1e-7, err_msg=mom + path)


@pytest.mark.parametrize("arch", SMOKES + [LLAMA4, KIMI])
@pytest.mark.parametrize("shape", ["train_s16_b4", "train_s4096_b2"])
def test_plan_and_memory_estimate_match_jax(arch, shape):
    jcfg, tcfg = _cfgs(arch)
    want = jmake_plan(jcfg, jreg.get_shape(shape), MESH)
    got = make_plan(tcfg, treg.get_shape(shape))
    assert (got.grad_accum, got.remat) == (want.grad_accum, want.remat)
    for accum in (1, 4):
        j = jestimate(jcfg, jreg.get_shape(shape), MESH, True, True, accum)
        t = estimate_train_memory(tcfg, treg.get_shape(shape), accum)
        assert (t.params, t.opt_state, t.activations, t.total) == \
            (j.params, j.opt_state, j.activations, j.total)


# --- serving -----------------------------------------------------------------

def _prompts(vocab, n=4, seed=6):
    """Prompts of 20-60 tokens, each with a run of one repeated token:
    the run's tokens reach the first layer's router with one hidden
    state, so they all pick the same experts and prefill drops."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        p = rng.randint(0, vocab, size=rng.randint(20, 61)).astype(np.int32)
        start = rng.randint(0, len(p) // 2)
        p[start:start + 24] = rng.randint(0, vocab)
        out.append(p)
    return out


def _run(eng, prompts, max_new):
    reqs = [Request(rid=i, prompt=p.copy(), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_steps=400)
    return {r.rid: list(r.out) for r in reqs}


class _Drops:
    """Counts the (token, choice) pairs ``moe._slots`` sends to the drop
    slot, per call size."""

    def __init__(self):
        self.by_tokens = {}
        self._slots = MOE._slots

    def __call__(self, idx, n_experts, capacity):
        slots = self._slots(idx, n_experts, capacity)
        t = idx.shape[0]
        self.by_tokens[t] = self.by_tokens.get(t, 0) + int(
            (slots == n_experts * capacity).sum())
        return slots


@pytest.mark.parametrize("arch", SMOKES)
def test_engine_tokens_equal_the_jax_engine(arch):
    """f32, 2 slots, prefill admission in both engines into power-of-two
    buckets, whose width sets the capacity: prefill drops choices (the
    repeated runs) and decode (2 tokens a call) drops none; the greedy
    tokens are the JAX engine's."""
    jcfg, tcfg, jparams, tparams = _pair(arch)
    prompts = _prompts(jcfg.vocab_size)
    jeng = JEngine(jcfg, jparams, MESH, n_slots=2, max_seq=96)
    jreqs = [JRequest(rid=i, prompt=p.copy(), max_new=8)
             for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_drained(max_steps=400)
    teng = ServingEngine(tcfg, tparams, "cpu", n_slots=2, max_seq=96)
    assert teng._prefill_admission
    drops = _Drops()
    with mock.patch.object(MOE, "_slots", drops):
        got = _run(teng, prompts, 8)
    assert got == {r.rid: list(r.out) for r in jreqs}
    assert all(len(v) == 8 for v in got.values())
    assert drops.by_tokens[2] == 0
    assert sum(n for t, n in drops.by_tokens.items() if t >= 32) > 0


@functools.lru_cache(maxsize=None)
def _serving_params(arch):
    return convert.params_from_numpy(_pair_np(arch, "bfloat16"), "cpu")


@pytest.mark.parametrize("arch", SMOKES)
@pytest.mark.parametrize("new_slots,streaming", [(2, False), (2, True),
                                                 (3, False)])
def test_engine_kill_restore_continues_token_identically(
        tmp_path, arch, new_slots, streaming):
    """bf16, prefill that drops: a snapshot chain, a kill mid-flight, a
    restore (eager, streamed, or re-slotted 2 -> 3, which lands each
    former in-flight session's checkpointed cache column in its new
    slot and admits the waiting ones by prefill) finishes every request
    with the uninterrupted run's tokens."""
    params = _serving_params(arch)
    prompts = _prompts(256, n=5, seed=3)
    ref = _run(ServingEngine.create(arch, params, n_slots=2, max_seq=96,
                                    device="cpu"), prompts, 6)
    policy = Policy(interval=4, chain=4, **SMALL)
    sess = CheckpointSession(f"localfs:{tmp_path}", policy)
    eng = ServingEngine.create(arch, params, n_slots=2, max_seq=96,
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
                         n_slots=new_slots, streaming=streaming)
    assert eng2.n_slots == new_slots and eng2.steps == 8
    live = eng2.live_requests()
    eng2.run_until_drained(max_steps=400)
    got = dict(done)
    got.update({r.rid: list(r.out) for r in live})
    assert got == ref
    sess2.close()


# --- training C/R ------------------------------------------------------------

@pytest.mark.parametrize("arch", SMOKES)
def test_trainer_kill_restore_continues_bit_identically(tmp_path, arch):
    policy = Policy(interval=2, chain=2, **SMALL)
    sess = CheckpointSession(f"localfs:{tmp_path}", policy)
    t = Trainer(TrainJob(arch, SHAPE), manager=sess.manager, device="cpu")
    t.init_state()
    sess.attach(t)
    losses, aux = [], []
    for _ in range(5):
        met = t.train_steps(1)
        losses.append(met["loss"])
        aux.append(met["moe_aux"])
        sess.maybe_snapshot()
    sess.wait()
    assert all(a > 0 for a in aux)
    want = t.state_digest()
    sess.close()
    del t                                        # the kill
    sess2 = CheckpointSession(f"localfs:{tmp_path}", policy)
    t2 = sess2.restore("latest", expect_kind="train", device="cpu")
    assert t2.checkpoint_step() == 4
    assert t2.train_steps(1)["loss"] == losses[4]
    assert t2.state_digest() == want
    sess2.close()
