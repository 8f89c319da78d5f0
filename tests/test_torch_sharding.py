"""The port's logical-axis sharding, its train planner over meshes, the
compressed all-reduce's block codec and the pipeline's bubble against
the JAX package's — pure logic, no ranks.

Meshes are the reference's fake-mesh idiom (an object whose ``shape``
maps axis names to sizes, ``tests/test_sharding_planner.py``) at
(1, 1), (2, 2), (4, 2), (2, 4), (1, 4), (16, 16) and (2, 16, 16) with a
pod axis. For every architecture's full-size template (nothing
allocated) the train plan, every param's and every optimizer moment's
partition spec, and the per-chip memory estimate equal the reference's;
the DTensor placements follow the specs.
"""
import numpy as np
import pytest

import jax.numpy as jnp
from jax.sharding import PartitionSpec as JSpec

from repro.configs import registry as jreg
from repro.models import model as JM
from repro.optim import AdamWConfig as JAdamW
from repro.optim import abstract_opt_state as jabstract_opt
from repro.optim import opt_logical_specs as jopt_logical
from repro.optim.compression import _blockwise_dequant as jdequant
from repro.optim.compression import _blockwise_quant as jquant
from repro.parallel import planner as JP
from repro.parallel import sharding as JS
from repro.parallel.pipeline import bubble_fraction as jbubble
from repro_torch.configs import registry as treg
from repro_torch.models import model as TM
from repro_torch.models.layers import kv_heads_for
from repro_torch.optim import AdamWConfig
from repro_torch.optim import abstract_opt_state, opt_logical_specs
from repro_torch.optim.compression import (_blockwise_dequant,
                                           _blockwise_quant)
from repro_torch.parallel import planner as TP
from repro_torch.parallel import sharding as TS
from repro_torch.parallel.pipeline import bubble_fraction

import torch


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {
    "1x1": {"data": 1, "model": 1}, "2x2": {"data": 2, "model": 2},
    "4x2": {"data": 4, "model": 2}, "2x4": {"data": 2, "model": 4},
    "1x4": {"data": 1, "model": 4}, "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}
SHAPES = ["train_4k", "train_s16_b4"]


def _flat(tree, prefix=""):
    """{keystr path: leaf} of a tree of dicts and named tuples whose
    leaves are partition specs (either package's), placements tuples or
    estimates."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + f"[{k!r}]"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(_flat(getattr(tree, f), prefix + f".{f}"))
        return out
    return {prefix: tree}


def _plans(arch, shape, mesh):
    jm, tm = FakeMesh(MESHES[mesh]), FakeMesh(MESHES[mesh])
    want = JP.make_plan(jreg.get_config(arch), jreg.get_shape(shape), jm)
    got = TP.make_plan(treg.get_config(arch), treg.get_shape(shape), tm)
    return want, got, jm, tm


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(jreg.ARCH_IDS))
def test_train_plan_and_specs_equal_the_references(arch, mesh):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for shape in SHAPES:
        want, got, jm, tm = _plans(arch, shape, mesh)
        for f in ("rules", "batch_axes", "model_axis", "remat", "seq_shard",
                  "cache_seq_axis", "grad_accum", "interior_tp", "notes"):
            assert getattr(got, f) == getattr(want, f), (shape, f)
    # params, then the optimizer's moments (int8 above 5e10 params, as
    # both packages choose)
    jlog, tlog = JM.logical_specs(jcfg), TM.logical_specs(tcfg)
    jab, tab = JM.init_abstract(jcfg), TM.init_abstract(tcfg)
    jspecs = _flat(JS.tree_specs(want, jlog, jab, jm))
    tspecs = _flat(TS.tree_specs(got, tlog, tab, tm))
    quant = jcfg.n_params() > 5e10
    jo = JAdamW(quantize_moments=quant)
    to = AdamWConfig(quantize_moments=quant)
    jspecs.update(_flat(JS.tree_specs(
        want, jopt_logical(jlog, jo), jabstract_opt(jab, jo), jm),
        "opt"))
    tspecs.update(_flat(TS.tree_specs(
        got, opt_logical_specs(tlog, to), abstract_opt_state(tab, to), tm),
        "opt"))
    assert sorted(tspecs) == sorted(jspecs)
    for path, spec in jspecs.items():
        assert isinstance(spec, JSpec)
        assert tuple(tspecs[path]) == tuple(spec), path
    # one placement per mesh dim, Shard(d) where the spec splits dim d
    for path, spec in list(tspecs.items())[:12]:
        pl = TS.placements_for(spec, tm)
        assert len(pl) == len(MESHES[mesh])
        for dim, tgt in enumerate(spec):
            for a in (() if tgt is None else
                      (tgt,) if isinstance(tgt, str) else tgt):
                assert pl[list(MESHES[mesh]).index(a)].dim == dim, path


@pytest.mark.parametrize("mesh", ["1x1", "2x2", "1x4", "16x16",
                                  "2x16x16"])
@pytest.mark.parametrize("arch", ["starcoder2-3b", "kimi-k2-1t-a32b",
                                  "recurrentgemma-9b", "whisper-base"])
def test_per_chip_memory_estimate_equals_the_references(arch, mesh):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    shape = "train_4k"
    for accum in (1, 4, 16):
        j = JP.estimate_train_memory(jcfg, jreg.get_shape(shape),
                                     FakeMesh(MESHES[mesh]), True, True,
                                     accum)
        t = TP.estimate_train_memory(tcfg, treg.get_shape(shape), accum,
                                     mesh=FakeMesh(MESHES[mesh]))
        assert (t.params, t.opt_state, t.activations, t.total) == \
            (j.params, j.opt_state, j.activations, j.total)


def test_card_plan_divides_the_card_among_the_ranks_and_the_state():
    """On a card each rank of a (2, 2) mesh counts a quarter of the
    params, moments and gradients against a quarter of the card (the
    four ranks share it when there is one card)."""
    cfg = treg.get_config("starcoder2-3b")
    shape = treg.get_shape("train_s4096_b4")
    one = TP.estimate_card_train_memory(cfg, shape, 1)
    mesh = FakeMesh(MESHES["2x2"])
    four = TP.estimate_card_train_memory(cfg, shape, 1, mesh)
    assert four.params == one.params / 4
    assert four.opt_state == one.opt_state / 4
    plan = TP.card_plan(cfg, shape, 80e9, mesh)
    assert plan.grad_accum >= 1 and "(card)" in plan.notes
    assert plan.rules == JS.train_rules(True, ("data",))


def test_card_plan_counts_rank_zeros_snapshot_gather():
    """A snapshot gathers the whole state onto rank 0 of a mesh: the
    card's budget loses it before the ranks divide the rest, so full
    starcoder2-3b on a (2, 2) mesh of one 80 GB card no longer fits at
    train_s4096_b4, and one device gathers nothing."""
    cfg = treg.get_config("starcoder2-3b")
    shape = treg.get_shape("train_s4096_b4")
    mesh = FakeMesh(MESHES["2x2"])
    n = TM.param_count(cfg)
    gather = TP.snapshot_gather_bytes(cfg, mesh)
    assert gather > n * (2 + 8)
    assert TP.snapshot_gather_bytes(cfg) == 0
    est = TP.estimate_card_train_memory(cfg, shape, 16, mesh)
    assert est.total + gather / 4 > 0.9 * 80e9 / 4
    assert "OVERBUDGET" in TP.card_plan(cfg, shape, 80e9, mesh).notes
    with pytest.raises(MemoryError, match="snapshot gather"):
        TP.card_plan(cfg, shape, 0.9 * gather, mesh)


def test_card_plan_counts_the_state_over_the_survivors_ranks(monkeypatch):
    """A shrink from (2, 2) onto (2, 1) leaves each surviving rank half
    of the state where it held a quarter: on four cards (one rank a
    card) the plan counts the survivors' blocks and refuses before
    anything is allocated where they do not fit, though the (2, 2)
    blocks did."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cfg = treg.get_config("starcoder2-3b")
    shape = treg.get_shape("train_s4096_b4")
    big, small = FakeMesh(MESHES["2x2"]), FakeMesh({"data": 2, "model": 1})
    four = TP.estimate_card_train_memory(cfg, shape, 1, big)
    two = TP.estimate_card_train_memory(cfg, shape, 1, small)
    assert two.params == 2 * four.params
    assert two.opt_state == 2 * four.opt_state
    n = TM.param_count(cfg)
    gather = TP.snapshot_gather_bytes(cfg, small)
    assert gather == TP.snapshot_gather_bytes(cfg, big)
    card = (gather + 0.4 * n * (2 + 8)) / 0.9     # fits n/4, not n/2
    assert "(card)" in TP.card_plan(cfg, shape, card, big).notes
    with pytest.raises(MemoryError, match="shared by 1 rank"):
        TP.card_plan(cfg, shape, card, small)


@pytest.mark.parametrize("places", [("s0", "s1"), ("s1", "s0"),
                                    ("s0", "s0"), ("r", "s1"), ("r", "r")])
def test_block_narrows_tile_the_tensor_as_dtensor_splits_it(places):
    """Every coordinate's block of a [8, 12] tensor on a (2, 2) mesh, put
    back where ``block_narrows`` says, rebuilds the tensor; a dim split
    by both mesh dims goes in mesh-dim order (coordinate (i, j) holds
    quarter 2i + j, DTensor's nesting)."""
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(Replicate() if p == "r" else Shard(int(p[1]))
               for p in places)
    full = torch.arange(96).reshape(8, 12)
    out = torch.full_like(full, -1)
    for i in range(2):
        for j in range(2):
            view, block = out, full
            for d, start, size in TS.block_narrows((8, 12), (2, 2), (i, j),
                                                   pl):
                view = view.narrow(d, start, size)
                block = block.narrow(d, start, size)
            view.copy_(block)
            if places == ("s0", "s0"):
                assert torch.equal(block, full[2 * (2 * i + j):
                                               2 * (2 * i + j) + 2])
    assert torch.equal(out, full)


# --- the serving plan, its estimate and the cache's layout (A9b step 1) ------

SERVE_MESHES = {"1x1": (1, 1), "2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1),
                "16x16": (16, 16)}
SERVE_SHAPES = ["prefill_32k", "decode_32k", "decode_s1024_b4"]


def _rem_block(path: str) -> bool:
    """A hybrid remainder block's leaf: its slot axis is 0 in the port
    (``M.batch_axes``), 1 in the reference's rank rule (ROADMAP C25)."""
    return path.startswith("['rem")


@pytest.mark.parametrize("mesh", list(SERVE_MESHES))
@pytest.mark.parametrize("arch", list(jreg.ARCH_IDS))
def test_serve_plan_estimate_and_cache_specs_equal_the_references(arch,
                                                                  mesh):
    """For a prefill and two decode shapes: the serving plan field by
    field, the per-chip estimate at every escalation step, and every
    cache leaf's partition spec by path, against the reference's on an
    ``AbstractMesh`` (no devices) — a remainder block of the hybrid
    aside, whose slots the port splits where the reference's rank rule
    splits its second axis (C25)."""
    from jax.sharding import AbstractMesh
    from repro.serving.kv_cache import cache_shardings as jcache_shardings
    from repro_torch.parallel.sharding import cache_specs
    import jax
    am = AbstractMesh(SERVE_MESHES[mesh], ("data", "model"))
    fm = FakeMesh(dict(zip(("data", "model"), SERVE_MESHES[mesh])))
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for shape in SERVE_SHAPES:
        js, ts = jreg.get_shape(shape), treg.get_shape(shape)
        want, got = JP.make_plan(jcfg, js, am), TP.make_plan(tcfg, ts, fm)
        for f in ("rules", "batch_axes", "model_axis", "remat", "seq_shard",
                  "cache_seq_axis", "grad_accum", "interior_tp", "notes"):
            assert getattr(got, f) == getattr(want, f), (shape, f)
        for depth, cache_seq in TP.SERVE_DEPTHS:
            j = JP.estimate_serve_memory(jcfg, js, am, depth, cache_seq)
            t = TP.estimate_serve_memory(tcfg, ts, fm, depth, cache_seq)
            for f in ("params", "opt_state", "activations", "kv_cache",
                      "total"):
                assert getattr(t, f) == getattr(j, f), (shape, depth, f)
        jtree = JM.cache_spec(jcfg, js.global_batch, js.seq_len)
        jspecs = {jax.tree_util.keystr(p): sh.spec for p, sh in
                  jax.tree_util.tree_flatten_with_path(
                      jcache_shardings(jcfg, want, am, jtree))[0]}
        tspecs = cache_specs(got, fm, TM.cache_spec(
            tcfg, ts.global_batch, ts.seq_len), TM.batch_axes(tcfg))
        assert sorted(tspecs) == sorted(jspecs)
        for path, spec in jspecs.items():
            if _rem_block(path):
                assert tspecs[path][0] in (None, "data"), path
                continue
            assert tuple(tspecs[path]) == tuple(spec), (shape, path)


def test_phi4_cache_on_two_by_two_splits_slots_and_kv_heads():
    """The engine's cell, 4 slots x 1024 on (2, 2): k and v split their
    slots over data and their 8 KV heads over model, pos its slots; the
    placements follow."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.parallel.sharding import cache_specs
    from repro_torch.serving.kv_cache import cache_shardings
    cfg = treg.get_config("phi4-mini-3.8b")
    mesh = FakeMesh({"data": 2, "model": 2})
    plan = TP.make_plan(cfg, treg.get_shape("decode_s1024_b4"), mesh)
    tree = TM.cache_spec(cfg, 4, 1024)
    specs = cache_specs(plan, mesh, tree, TM.batch_axes(cfg))
    assert tuple(specs["['k']"]) == (None, "data", None, "model", None)
    assert tuple(specs["['v']"]) == (None, "data", None, "model", None)
    assert tuple(specs["['pos']"]) == (None, "data", None)
    places = cache_shardings(cfg, plan, mesh, tree)
    assert places["['k']"] == (Shard(1), Shard(3))
    assert places["['pos']"] == (Shard(1), Replicate())


@pytest.mark.parametrize("arch,mesh,depth", [
    ("phi4-mini-3.8b-layers4", "2x2", 1),
    ("phi4-mini-3.8b", "2x2", 1),
    ("llama4-scout-17b-a16e-layers8", "1x4", 1),
])
def test_card_serve_plan_counts_the_ranks_blocks(arch, mesh, depth):
    """On a fake 80 GB card: each rank's share of the params and the
    cache by their placements, the ranks sharing the card, rank 0's
    gather of the whole cache; the plan keeps the reference's rules at
    the depth that fits."""
    cfg = treg.resolve_config(arch)
    shape = treg.get_shape("decode_s1024_b4")
    fm = FakeMesh(dict(zip(("data", "model"), SERVE_MESHES[mesh])))
    plan = TP.card_plan(cfg, shape, 80e9, fm)
    assert "(card)" in plan.notes and f"depth={depth}" in plan.notes
    assert plan.rules == JS.serve_rules(depth, ("data",))
    one = TP.estimate_card_serve_memory(cfg, shape, plan)
    est = TP.estimate_card_serve_memory(cfg, shape, plan, fm)
    assert est.kv_cache < one.kv_cache and est.params < one.params
    whole = TP.serve_gather_bytes(cfg, shape, fm)
    assert TP.serve_gather_bytes(cfg, shape) == 0
    assert whole > one.kv_cache


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "whisper-base",
                                  "mamba2-780m"])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_s1024_b4"])
def test_serve_input_specs_match_the_references(arch, shape):
    """The serving steps' stand-ins: the reference's leaves, shapes and
    dtypes, as tensors on the meta device (nothing allocated)."""
    import jax
    from repro.serving.engine import serve_input_specs as jspecs
    from repro_torch.host import dtype_name
    from repro_torch.serving.engine import serve_input_specs
    from repro_torch.tree import flatten_with_paths
    want = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(jspecs(
                jreg.get_config(arch), jreg.get_shape(shape)))[0]}
    got = dict(flatten_with_paths(serve_input_specs(
        treg.get_config(arch), treg.get_shape(shape))))
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(want[path].shape), path
        assert dtype_name(t) == str(want[path].dtype), path


def test_card_serve_plan_refuses_what_cannot_fit():
    """qwen1.5-110b's params split four ways still exceed a quarter of an
    80 GB card: the plan raises before anything is allocated, naming
    the bytes and ROADMAP A9."""
    cfg = treg.get_config("qwen1.5-110b")
    with pytest.raises(MemoryError, match="ROADMAP A9"):
        TP.card_plan(cfg, treg.get_shape("decode_s1024_b4"), 80e9,
                     FakeMesh({"data": 2, "model": 2}))


# --- spec_for_axes, the reference's cases --------------------------------------

def _plan(fsdp=True):
    return TS.ParallelPlan(rules=TS.train_rules(fsdp, ("data",)))


MESH = FakeMesh({"data": 16, "model": 16})
MESH_MP = FakeMesh({"pod": 2, "data": 16, "model": 16})


@pytest.mark.parametrize("plan,axes,shape,mesh", [
    (_plan(), ("embed", "ff"), (8192, 49152), MESH),
    (_plan(False), ("embed", "heads", None), (3072, 24, 128), MESH),
    (_plan(), ("kv_heads", "embed"), (8, 64), MESH),
    (TS.ParallelPlan(rules={"a": "model", "b": "model"}), ("a", "b"),
     (32, 32), MESH),
    (TS.ParallelPlan(rules={"embed": ("pod", "data")},
                     batch_axes=("pod", "data")), ("embed", None),
     (8192, 64), MESH_MP),
    (_plan(), ("layers", "embed", "ff"), (30, 3072, 12288), MESH),
    (_plan(), (), (), MESH),
    (_plan(), ("vocab", "embed"), (49152, 3072), None),
])
def test_spec_for_axes_equals_the_references(plan, axes, shape, mesh):
    jplan = JS.ParallelPlan(rules=plan.rules, batch_axes=plan.batch_axes)
    want = JS.spec_for_axes(jplan, axes, shape, mesh)
    got = TS.spec_for_axes(plan, axes, shape, mesh)
    assert tuple(got) == tuple(want) and isinstance(got, TS.PartitionSpec)


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("batch_axes", [("data",), ("pod", "data")])
def test_batch_activation_logits_and_cache_specs(seq_shard, batch_axes):
    kw = dict(rules=TS.train_rules(True, batch_axes), batch_axes=batch_axes,
              seq_shard=seq_shard)
    jplan, tplan = JS.ParallelPlan(**kw), TS.ParallelPlan(**kw)
    for fn in ("batch_spec", "activation_spec", "logits_spec"):
        assert tuple(getattr(TS, fn)(tplan)) == \
            tuple(getattr(JS, fn)(jplan)), fn
    for entry, kv in (((32, 128, 8, 64), 8), ((3, 128, 2, 64), 2),
                      ((32, 128, 16, 64), 16)):
        for cache_axis in (None, "model"):
            want = JS.cache_entry_spec(jplan.with_(cache_seq_axis=cache_axis),
                                       entry, kv, MESH_MP)
            got = TS.cache_entry_spec(tplan.with_(cache_seq_axis=cache_axis),
                                      entry, kv, MESH_MP)
            assert tuple(got) == tuple(want)


def test_placements_of_a_device_mesh_shaped_object():
    """A ``DeviceMesh`` names its dims in ``mesh_dim_names`` and gives
    ``shape`` as a tuple; a dim split over two axes is split in mesh-dim
    order."""
    from torch.distributed.tensor import Replicate, Shard

    class DM:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 2, 4)

    assert TS.axis_sizes(DM()) == {"pod": 2, "data": 2, "model": 4}
    assert TS.placements_for(TS.PartitionSpec(("pod", "data"), "model"),
                             DM()) == (Shard(0), Shard(0), Shard(1))
    assert TS.placements_for(TS.PartitionSpec(), DM()) == \
        (Replicate(), Replicate(), Replicate())


@pytest.mark.parametrize("h,hkv,m,want", [
    (24, 2, 2, [(0, 1, None), (1, 2, None)]),          # starcoder2-3b
    (4, 2, 4, [(0, 0, [0]), (0, 0, [0]), (0, 0, [1]), (0, 0, [1])]),
    (8, 2, 2, [(0, 1, None), (1, 2, None)]),
    (12, 4, 4, [(0, 1, None), (1, 2, None), (2, 3, None), (3, 4, None)]),
    (12, 4, 2, [(0, 2, None), (2, 4, None)]),
    (12, 2, 4, [(0, 0, [0, 0, 0]), (0, 0, [0, 0, 0]), (0, 0, [1, 1, 1]),
                (0, 0, [1, 1, 1])]),
    (6, 1, 3, [(0, 0, [0, 0]), (0, 0, [0, 0]), (0, 0, [0, 0])]),
])
def test_kv_heads_follow_the_local_query_heads(h, hkv, m, want):
    """Each rank's query heads h read KV head h // (H / Hkv) under GQA,
    whatever block of the query heads the rank holds."""
    got = [kv_heads_for(h, hkv, m, r) for r in range(m)]
    assert got == want
    g = h // hkv
    for r, (lo, hi, idx) in enumerate(got):
        heads = range(r * h // m, (r + 1) * h // m)
        kv = list(range(lo, hi)) if idx is None else idx
        if idx is None:
            assert [q // g - lo for q in heads] == \
                [k for k in range(hi - lo) for _ in range(len(heads)
                                                          // (hi - lo))]
        else:
            assert kv == [q // g for q in heads]


# --- the compressed all-reduce's codec, the pipeline's bubble -------------------

@pytest.mark.parametrize("n", [256, 1000, 4096, 50280])
def test_blockwise_quant_is_the_references_bit_for_bit(n):
    rng = np.random.RandomState(n)
    x = (rng.randn(n) * rng.choice([1e-3, 1.0, 50.0], size=n)).astype(
        np.float32)
    x[:7] = [0.0, -0.0, 1e-30, 127.0, -127.5, 0.5, -2.5]
    jq, js = jquant(jnp.asarray(x))
    tq, ts = _blockwise_quant(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    back = _blockwise_dequant(tq, ts, n).numpy()
    assert back.tobytes() == np.asarray(jdequant(jq, js, n)).tobytes()


@pytest.mark.parametrize("stages,micro", [(1, 1), (2, 8), (4, 6), (8, 3),
                                          (16, 64)])
def test_bubble_fraction_equals_the_references(stages, micro):
    assert bubble_fraction(stages, micro) == jbubble(stages, micro)


def test_jax_specs_round_trip_through_the_port():
    """A spec the JAX package writes compares equal to the port's tuple."""
    assert tuple(JSpec("data", None, "model")) == \
        tuple(TS.PartitionSpec("data", None, "model"))
