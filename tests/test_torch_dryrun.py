"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's: the plain route's step flops of ``-smoke`` cells against the
reference's ``analyze_hlo`` of its own compiled steps on a one-device
mesh; the card route's kernel launches a step against the rule
``chip_smoke.py`` holds the card to; the card route's raw terms against
the same step with each wrapper running its plain version, and against
the plain route, with each difference named; the kernel-adjusted bytes
below the raw ones; the result's keys; and the planner's card memory
and ranks a card given explicitly, as a (16, 16) mesh of H100s is
planned. Each cell is traced once for the module (``_cell``). The dry
run over a fake process group is ``test_torch_dryrun_mesh.py``'s."""
import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import AxisType

from repro_torch.configs import resolve_config
from repro_torch.configs.registry import get_shape
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rg_lru import ops as rg
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.kernels.trace import launches_to
from repro_torch.launch import dryrun as DR
from repro_torch.launch import hlo_analysis as HA
from repro_torch.parallel import planner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the plain route's flops against the reference's, relative
FLOPS_RTOL = 0.05
KMODS = {"flash": fa, "ssd": ssd, "rg_lru": rg}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_rules", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _cell(arch: str, shape_key: str, route: str = "card",
          plain_kernels: bool = False):
    """(result, each kernel's calls by route, each launch's (kernel,
    dims)) of one ``run_cell`` on one device, traced once for the
    module. ``plain_kernels``: the card route with every wrapper's fake
    route turned off, so that each runs its plain version in place of
    its launch."""
    for m in KMODS.values():
        m.reset_counts()
    saved = [(m, m.fake_route) for m in KMODS.values()]
    if plain_kernels:
        for m in KMODS.values():
            m.fake_route = lambda t: False
    seen = []
    try:
        with launches_to(lambda k, plain, dims: seen.append((k, dims))):
            res = DR.run_cell(arch, shape_key, "card", route=route)
    finally:
        for m, f in saved:
            m.fake_route = f
    calls = {r: {k: n for m in KMODS.values() for k, n in
                 m.counts(r).items() if n} for r in ("fake", "cuda", "cpu")}
    return res, calls, seen


def _reference_flops(arch: str, shape_key: str) -> float:
    """``analyze_hlo`` of the reference's own compiled step for the cell
    on a one-device mesh (Auto axes: ROADMAP C4)."""
    from repro.configs import registry as R
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.models import model as JM
    from repro.optim import abstract_opt_state
    from repro.serving import engine as JE
    from repro.train import step as JS
    cfg = R.get_smoke_config(arch[:-len("-smoke")])
    shape = R.get_shape(shape_key)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    ab = JM.init_abstract(cfg)
    if shape.kind == "train":
        fn, info = JS.jit_train_step(cfg, shape, mesh, donate=False)
        lowered = fn.lower(ab, abstract_opt_state(ab, info["opt_cfg"]),
                           info["input_specs"],
                           jax.ShapeDtypeStruct((), jnp.int32),
                           jax.ShapeDtypeStruct((), jnp.float32))
    elif shape.kind == "prefill":
        fn, _ = JE.jit_prefill(cfg, shape, mesh)
        sp = JE.serve_input_specs(cfg, shape)
        lowered = fn.lower(ab, sp["tokens"], sp["cache"])
    else:
        fn, _ = JE.jit_decode_step(cfg, shape, mesh)
        sp = JE.serve_input_specs(cfg, shape)
        lowered = fn.lower(ab, sp["cache"], sp["tokens"], sp["pos"])
    return analyze_hlo(lowered.compile().as_text()).flops


@pytest.mark.parametrize("arch, shape_key", [
    ("starcoder2-3b-smoke", "train_s64_b2"),
    ("starcoder2-3b-smoke", "prefill_s64_b2"),
    ("starcoder2-3b-smoke", "decode_s64_b2"),
    ("whisper-base-smoke", "train_s64_b2"),
])
def test_plain_route_flops_match_the_reference(arch, shape_key):
    """The plain route on one device (dense attention, as JAX's; the
    reference's plan) against XLA's compiled step: within FLOPS_RTOL.
    These cells agree exactly: both count every product of the same
    program, remat's recomputed forward included. (The ssm and hybrid
    families do not: the port's plain SSD gradient and RG-LRU blocks
    count 7.6% and 5.6% more at ``train_s64_b2``, ROADMAP C26.)"""
    res = _cell(arch, shape_key, "plain")[0]
    want = _reference_flops(arch, shape_key)
    assert res["parsed"]["flops_per_chip"] == pytest.approx(
        want, rel=FLOPS_RTOL)
    assert res["parsed"]["flops_per_chip"] == want
    assert not res["launches"]


@pytest.mark.parametrize("arch, mods", [
    ("starcoder2-3b-smoke", ("flash",)),
    ("mamba2-780m-smoke", ("ssd",)),
    ("whisper-base-smoke", ("flash",)),
    ("recurrentgemma-9b-smoke", ("rg_lru", "flash")),
])
def test_fake_launches_a_step_follow_the_card_rule(arch, mods):
    """The card route's launches of one traced step equal what
    ``chip_smoke.calls_per_step`` makes the card launch a step: each
    module's first kernel twice a call site under remat, every other
    kernel once, plus the call sites outside remat."""
    rule = _chip_smoke().calls_per_step
    res, calls, _ = _cell(arch, "train_s64_b2")
    cfg = resolve_config(arch)
    want = {}
    for name in mods:
        remat, outside = rule(cfg, name)
        for i, k in enumerate(KMODS[name].KERNELS):
            want[k] = (2 if i == 0 else 1) * remat + outside
    assert calls["fake"] == want == res["launches"]
    assert not calls["cuda"] and not calls["cpu"]


def _ssd_bwd_tail_bytes(B, S, H, P, N, q, esz) -> int:
    """Bytes of the ops ``ssd_bwd``'s card route runs after its kernel:
    dA's partials summed over (batch, chunk), dB's and dC's over the
    head groups and cast to the input's dtype."""
    groups = -(-H // ssd.HEAD_GROUP)
    da = B * H * (S // q) * 4 + H * 4
    dbc = B * groups * S * N * 4 + 2 * B * S * N * 4 + B * S * N * esz
    return da + 2 * dbc


@pytest.mark.parametrize("arch", [
    "starcoder2-3b-smoke", "mamba2-780m-smoke", "recurrentgemma-9b-smoke"])
def test_raw_terms_put_each_plain_version_in_place_of_its_launch(arch):
    """The card route's raw terms (``roofline``) are its step with each
    launch charged at its wrapper's plain version: the flops and bytes
    of the same step traced with every wrapper running its plain version
    inline, exactly — less, for the bytes, the partial sums that
    ``ssd_bwd``'s card route runs after its kernel and its plain version
    does not. Against the plain route (the model's own CPU route) the
    flops differ by name alone: the plain dq recomputes the scores and
    the plain dk/dv the scores and dP, three products more a backward
    than autograd's dense backward; the SSD and RG-LRU flops agree. The
    bytes agree where no attention runs, less ``ssd_bwd``'s partial
    sums; where it runs they differ by the two attention routes (the
    wrappers' per-group loops and software exp against the model's
    dense product) and are not held. The adjusted terms lie at or below
    the raw ones."""
    res, _, seen = _cell(arch, "train_s64_b2")
    inline, calls, _ = _cell(arch, "train_s64_b2", plain_kernels=True)
    plain = _cell(arch, "train_s64_b2", "plain")[0]
    assert not inline["launches"] and calls["cpu"] == res["launches"]
    got, want = res["parsed"], inline["parsed"]
    assert got["flops_per_chip"] == want["flops_per_chip"]
    tail = sum(_ssd_bwd_tail_bytes(**{k: d[k] for k in "B S H P N q esz"
                                      .split()})
               for k, d in seen if k == "ssd_bwd")
    assert got["hbm_bytes_per_chip"] == want["hbm_bytes_per_chip"] + tail
    recomputed = sum(3 * 2 * d["hd"] * d["B"] * d["H"] * d["Sq"] * d["Skv"]
                     for k, d in seen if k == "flash_dq")
    assert got["flops_per_chip"] == \
        plain["parsed"]["flops_per_chip"] + recomputed
    if not any(k.startswith("flash_") for k, _ in seen):
        assert got["hbm_bytes_per_chip"] == \
            plain["parsed"]["hbm_bytes_per_chip"] + tail
    raw, adj = res["roofline"], res["roofline_kernel_adjusted"]
    assert adj["compute_s"] <= raw["compute_s"]
    assert adj["memory_s"] < raw["memory_s"]


def test_kernel_adjusted_bytes_fall_below_the_raw_for_attention():
    res = _cell("starcoder2-3b-smoke", "train_s64_b2")[0]
    raw, adj = res["roofline"], res["roofline_kernel_adjusted"]
    assert adj["memory_s"] < raw["memory_s"]
    loops = {f["kernel"]: f for f in res["fused_loops"]}
    assert set(loops) == set(fa.KERNELS)
    assert all(f["gb"] < f["plain_gb"] for f in loops.values())


def test_result_has_the_reference_keys(tmp_path):
    """``main`` writes the reference's keys, with ``trace_s`` in place of
    ``lower_s`` and ``compile_s`` and no ``xla_cost``."""
    DR.main(["--arch", "starcoder2-3b-smoke", "--shape", "decode_s64_b2",
             "--mesh", "card", "--out-dir", str(tmp_path)])
    res = json.loads((tmp_path / "card" /
                      "starcoder2-3b-smoke__decode_s64_b2.json").read_text())
    ref = {"arch", "shape", "mesh", "chips", "tag", "plan", "plan_overrides",
           "lower_s", "compile_s", "memory", "xla_cost", "parsed",
           "roofline", "roofline_kernel_adjusted", "fused_loops",
           "model_flops_per_chip", "useful_flops_ratio", "hw"}
    want = (ref - {"lower_s", "compile_s", "xla_cost"}) | {"trace_s"}
    assert want <= set(res)
    assert "xla_cost" not in res and "lower_s" not in res
    mem = res["memory"]
    assert mem["live_bytes"] == (mem["argument_bytes"] + mem["temp_bytes"]
                                 + mem["named_bytes"]) and mem["fits"]
    assert mem["named_terms"] == {
        "cublas_workspace_bytes": DR.cublas_workspace_bytes()}
    assert res["hw"]["hbm_bytes"] == HA.HBM_BYTES


class _H100Mesh:
    """A mesh of CUDA ranks as the planner reads one."""
    device_type = "cuda"

    def __init__(self, shape, axes):
        self.mesh_dim_names = axes
        self.shape = shape


def test_a_16x16_mesh_of_h100s_plans_one_rank_a_card():
    """``card_plan`` takes the card's memory and the ranks a card: a
    (16, 16) mesh of H100s plans one rank a card, with no CUDA in this
    process; the default divides the mesh by this machine's cards."""
    cfg, shape = resolve_config("starcoder2-3b"), get_shape("train_4k")
    mesh = _H100Mesh((16, 16), ("data", "model"))
    assert planner._ranks_per_card(mesh, 1) == 1
    assert planner._ranks_per_card(mesh) == 256 // max(
        1, __import__("torch").cuda.device_count())
    plan = planner.card_plan(cfg, shape, HA.HBM_BYTES, mesh,
                             ranks_per_card=1)
    assert plan.notes.startswith("train accum=1 ")
    # the mesh shared by 256 ranks on one card, as the default planned it
    # on a machine without cards: over budget at every accumulation
    shared = planner.card_plan(cfg, shape, HA.HBM_BYTES, mesh,
                               ranks_per_card=256)
    assert shared.notes.startswith("train OVERBUDGET")
    # serving refuses: a snapshot gathers the whole cache (193.8 GB at
    # decode_32k) onto rank 0's card (ROADMAP C27)
    with pytest.raises(MemoryError, match="cache gather"):
        planner.card_serve_plan(cfg, get_shape("decode_32k"), HA.HBM_BYTES,
                                mesh, ranks_per_card=1)
