"""The port's roofline analyzer (``repro_torch.launch.hlo_analysis``)
against the JAX package's (``repro.launch.hlo_analysis``): flops of the
same small functions, traced eagerly in PyTorch and compiled by XLA,
exactly equal; the ring factors per collective kind; the terms' keys;
the bound formulas against the operation and byte counts of PERF.md's
kernel table (rows 6-9b); the fake route's launches and the
kernel-adjusted bytes; the live-bytes tracker; and that a real tensor
never takes a fake route."""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.launch import hlo_analysis as REF
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rg_lru import ops as rg
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.kernels.trace import card_trace
from repro_torch.launch import hlo_analysis as HA


def _jax_flops(fn, *shapes) -> float:
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    hlo = jax.jit(fn).lower(*args).compile().as_text()
    return REF.analyze_hlo(hlo, assume_bf16=False).flops


def _port_flops(fn, *shapes) -> float:
    rng = np.random.RandomState(0)
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in shapes]
    _, a = HA.analyze(fn, *args)
    return a.counts.flops


def test_flops_of_a_dot_chain_equal_the_reference():
    shapes = ((8, 16), (16, 32), (32, 4), (4, 24))
    jf = _jax_flops(lambda a, b, c, d: ((a @ b) @ c) @ d, *shapes)
    pf = _port_flops(lambda a, b, c, d: ((a @ b) @ c) @ d, *shapes)
    assert pf == jf == 2 * (8 * 16 * 32 + 8 * 32 * 4 + 8 * 4 * 24)


def test_flops_of_a_12_trip_loop_equal_the_reference():
    """A loop of 12 trips over a dot: XLA's while loop, whose trip count
    the reference reads, against 12 eager trips."""
    def jloop(x, w):
        return jax.lax.fori_loop(0, 12, lambda i, h: jnp.tanh(h @ w), x)

    def tloop(x, w):
        for _ in range(12):
            x = torch.tanh(x @ w)
        return x
    shapes = ((8, 16), (16, 16))
    jf = _jax_flops(jloop, *shapes)
    assert _port_flops(tloop, *shapes) == jf == 12 * 2 * 8 * 16 * 16


def test_batched_and_bias_products_count_the_dot_rule():
    def fn(x, w, b):
        return torch.addmm(b, x, w), torch.einsum("bij,bjk->bik",
                                                  x[None].expand(3, -1, -1),
                                                  w[None].expand(3, -1, -1))
    shapes = ((8, 16), (16, 32), (32,))
    assert _port_flops(fn, *shapes) == 2 * 8 * 16 * 32 * (1 + 3)


# one op of each collective kind over groups of 4, in the reference's HLO
_COLLECTIVES_HLO = textwrap.dedent("""
    HloModule jit_c

    %add.c (x: f32[], y: f32[]) -> f32[] {
      %x = f32[] parameter(0)
      %y = f32[] parameter(1)
      ROOT %s = f32[] add(%x, %y)
    }

    ENTRY %main (a: f32[8,128]) -> f32[8,128] {
      %a = f32[8,128]{1,0} parameter(0)
      %ar = f32[8,128]{1,0} all-reduce(%a), replica_groups=[2,4]<=[8], to_apply=%add.c
      %ag = f32[32,128]{1,0} all-gather(%a), replica_groups=[2,4]<=[8], dimensions={0}
      %rs = f32[2,128]{1,0} reduce-scatter(%a), replica_groups=[2,4]<=[8], dimensions={0}, to_apply=%add.c
      %aa = f32[8,128]{1,0} all-to-all(%a), replica_groups=[2,4]<=[8], dimensions={0}
      %cp = f32[8,128]{1,0} collective-permute(%a), source_target_pairs={{0,1}}
      ROOT %o = f32[8,128]{1,0} add(%ar, %aa)
    }
""")
_RESULT_BYTES = {"all-reduce": 8 * 128 * 4, "all-gather": 32 * 128 * 4,
                 "reduce-scatter": 2 * 128 * 4, "all-to-all": 8 * 128 * 4,
                 "collective-permute": 8 * 128 * 4}


def test_ring_factors_match_the_reference_per_kind():
    ref = REF.analyze_hlo(_COLLECTIVES_HLO, assume_bf16=False)
    assert set(ref.collective_breakdown) == set(_RESULT_BYTES)
    for kind, rbytes in _RESULT_BYTES.items():
        # a permute's group is its pair: the reference's default of 2
        n = 2 if kind == "collective-permute" else 4
        assert HA.ring_wire_bytes(kind, rbytes, n) == pytest.approx(
            ref.collective_breakdown[kind]), kind
    with pytest.raises(ValueError):
        HA.ring_wire_bytes("all-everything", 1.0, 4)


def test_collective_kinds_of_the_functional_ops():
    assert HA._collective_kind("all_reduce") == "all-reduce"
    assert HA._collective_kind("all_gather_into_tensor") == "all-gather"
    assert HA._collective_kind("reduce_scatter_tensor") == "reduce-scatter"
    assert HA._collective_kind("all_to_all_single") == "all-to-all"
    assert HA._collective_kind("broadcast") == "collective-permute"
    assert HA._collective_kind("wait_tensor") is None


def test_roofline_terms_have_the_reference_keys():
    ref = REF.roofline_terms(REF.analyze_hlo(_COLLECTIVES_HLO))
    c = HA.RooflineCounts(flops=1e12, hbm_bytes=1e9, collective_bytes=1e8)
    for adjusted in (False, True):
        t = HA.roofline_terms(c, kernel_adjusted=adjusted)
        assert set(t) == set(ref)
        assert 0 <= t["roofline_fraction"] <= 1.0
    t = HA.roofline_terms(c)
    assert t["compute_s"] == 1e12 / HA.PEAK_FLOPS
    assert t["collective_s"] == 1e8 / HA.NVLINK_BW
    assert t["dominant"] == "compute"


def _ms(nbytes, ops, rate):
    return max(nbytes / HA.HBM_BW, ops / rate) * 1e3


@pytest.mark.parametrize("name, gflop, bound_ms", [
    ("flash_fwd", 206.2, 0.2085), ("flash_dq", 309.3, 0.3128),
    ("flash_dkv", 412.4, 0.4170)])
def test_flash_formulas_give_perf_rows_6_and_7(name, gflop, bound_ms):
    """starcoder2-3b's training attention: q [2, 24, 4096, 128], two KV
    heads, causal, bf16."""
    b, ops = HA.flash_work(2, 24, 2, 4096, 4096, 128, 2, True, 0)[name]
    assert round(ops / 1e9, 1) == gflop
    assert round(_ms(b, ops, HA.PEAK_FLOPS), 4) == bound_ms


@pytest.mark.parametrize("name, bound_ms", [
    ("flash_fwd", 0.2085), ("flash_dq", 0.3127), ("flash_dkv", 0.4170)])
def test_flash_formulas_give_the_hd256_row(name, bound_ms):
    """recurrentgemma-9b's: q [2, 16, 4096, 256], one KV head, causal,
    window 2048, bf16."""
    b, ops = HA.flash_work(2, 16, 1, 4096, 4096, 256, 2, True, 2048)[name]
    assert round(_ms(b, ops, HA.PEAK_FLOPS), 4) == bound_ms


@pytest.mark.parametrize("name, gb, gflop, bound_ms", [
    ("ssd_fwd", 0.841, 129.2, 0.2510), ("ssd_bwd", 1.053, 258.3, 0.3143)])
def test_ssd_formulas_give_perf_rows_8(name, gb, gflop, bound_ms):
    """mamba2-780m's training scan: B 8, S 4096, H 48, P 64, N 128,
    chunk 256, bf16."""
    b, ops = HA.ssd_work(8, 4096, 48, 64, 128, 256, 2)[name]
    assert round(b / 1e9, 3) == gb and round(ops / 1e9, 1) == gflop
    assert round(_ms(b, ops, HA.PEAK_FLOPS), 4) == bound_ms


@pytest.mark.parametrize("name, shape, gb, gflop, bound_ms, floor_ms", [
    ("rg_lru_fwd", (2, 32768, 4096), 4.295, 2.7, 1.2821, 2.2436),
    ("rg_lru_bwd", (2, 4096, 4096), 1.074, 0.7, 0.3205, 0.4006)])
def test_rg_lru_formulas_give_perf_rows_9(name, shape, gb, gflop, bound_ms,
                                          floor_ms):
    b, ops = HA.rg_lru_work(*shape)[name]
    assert round(b / 1e9, 3) == gb and round(ops / 1e9, 1) == gflop
    assert round(_ms(b, ops, HA.CUDA_CORE_OPS_PER_S), 4) == bound_ms
    n = int(np.prod(shape))
    design = HA.RG_LRU_DESIGN_BYTES[name] * n
    assert round(design / HA.HBM_BW * 1e3, 4) == floor_ms
    assert HA.kernel_work(name, B=shape[0], S=shape[1],
                          W=shape[2]) == (design, 0)


def test_fake_route_records_launches_and_adjusted_bytes_fall():
    """Flash attention on fake tensors inside ``card_trace``: the fake
    route launches nothing, counts one call a kernel, and the analyzer
    charges each launch at the kernel's own work in the adjusted terms —
    below the dense product's bytes of the raw ones (the counterpart of
    the reference's kernel adjustment reducing memory)."""
    fa.reset_counts()
    with FakeTensorMode(), card_trace():
        q = torch.empty((2, 4, 256, 64), dtype=torch.bfloat16,
                        requires_grad=True)
        k = torch.empty((2, 2, 256, 64), dtype=torch.bfloat16,
                        requires_grad=True)
        v = torch.empty((2, 2, 256, 64), dtype=torch.bfloat16,
                        requires_grad=True)
        a = HA.Analyzer()
        a.hold(q, k, v)
        with a:
            out = fa.flash_attention(q, k, v, causal=True)
            torch.autograd.grad(out.float().sum(), (q, k, v))
    assert fa.counts("fake") == {"flash_fwd": 1, "flash_dq": 1,
                                 "flash_dkv": 1}
    assert fa.counts("cuda") == fa.counts("cpu") == dict.fromkeys(
        fa.KERNELS, 0)
    c = a.counts
    assert c.launch_counts() == fa.counts("fake")
    assert c.hbm_bytes_kernel_adjusted() < c.hbm_bytes
    assert c.flops_kernel_adjusted() < c.flops
    fwd = next(r for r in c.launches if r.kernel == "flash_fwd")
    assert (fwd.hbm_bytes, fwd.flops) == HA.flash_work(
        2, 4, 2, 256, 256, 64, 2, True, 0)["flash_fwd"]
    # the plain work is the wrapper's plain version traced on the inputs
    with FakeTensorMode(), card_trace():
        p = HA.Analyzer()
        with p:
            fa.flash_fwd_plain(torch.empty(q.shape, dtype=q.dtype),
                               torch.empty(k.shape, dtype=k.dtype),
                               torch.empty(v.shape, dtype=v.dtype))
    assert (fwd.plain_flops, fwd.plain_bytes) == (p.counts.flops,
                                                  p.counts.hbm_bytes)
    # the outputs and the bf16 dk/dv's f32 partials were allocated
    assert a.temp_bytes >= 2 * 4 * 256 * 64 * 2 + 2 * (2 * 2 * 256 * 64 * 4)


def test_fake_route_of_the_ssd_and_rg_lru_wrappers():
    ssd.reset_counts()
    rg.reset_counts()
    with FakeTensorMode(), card_trace():
        B, S, H, P, N = 2, 512, 4, 16, 32
        x = torch.empty((B, S, H, P), dtype=torch.bfloat16)
        dt = torch.empty((B, S, H))
        A = torch.empty((H,))
        Bm = torch.empty((B, S, N), dtype=torch.bfloat16)
        a = HA.Analyzer()
        with a:
            y, final, states = ssd.ssd_fwd(x, dt, A, Bm, Bm.clone(), 256)
            ssd.ssd_bwd(x, dt, A, Bm, Bm.clone(), states, y, None, 256)
            xs = torch.empty((B, S, 64))
            h = rg.rg_lru_fwd(xs, xs, xs, torch.empty((64,)))
            rg.rg_lru_bwd(xs, xs, xs, torch.empty((64,)), h, h)
    assert tuple(states.shape) == (B, H, S // 256, P, N)
    assert ssd.counts("fake") == {"ssd_fwd": 1, "ssd_bwd": 1}
    assert rg.counts("fake") == {"rg_lru_fwd": 1, "rg_lru_bwd": 1}
    assert a.counts.launch_counts() == {"ssd_fwd": 1, "ssd_bwd": 1,
                                        "rg_lru_fwd": 1, "rg_lru_bwd": 1}
    # each plain version moves more than its kernel: raw >= adjusted
    for rec in a.counts.launches:
        assert rec.plain_bytes > rec.hbm_bytes, rec.kernel
    assert a.counts.hbm_bytes_kernel_adjusted() < a.counts.hbm_bytes


def test_a_real_tensor_never_takes_the_fake_route():
    """Real CPU tensors take the plain route inside ``card_trace`` and
    under an analyzer alike, and record no launch; a fake CPU tensor
    outside ``card_trace`` takes the plain route too; a fake CUDA tensor
    takes the fake route without ``card_trace``."""
    rng = np.random.RandomState(1)
    q = torch.from_numpy(rng.standard_normal((1, 2, 32, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 1, 32, 16)).astype(
        np.float32))
    want, _ = fa.flash_fwd_plain(q, k, k)
    fa.reset_counts()
    a = HA.Analyzer()
    with card_trace(), a:
        got, _ = fa.flash_fwd(q, k, k)
    assert torch.equal(got, want)
    assert fa.counts("cpu")["flash_fwd"] == 1
    assert fa.counts("fake")["flash_fwd"] == 0 and not a.counts.launches
    with FakeTensorMode():
        fq, fk = torch.empty(q.shape), torch.empty(k.shape)
        fa.flash_fwd(fq, fk, fk)
        assert fa.counts("cpu")["flash_fwd"] == 2
        cq = torch.empty(q.shape, device="cuda")
        ck = torch.empty(k.shape, device="cuda")
        fa.flash_fwd(cq, ck, ck)
    assert fa.counts("fake")["flash_fwd"] == 1
    assert fa.counts("cuda")["flash_fwd"] == 0


def test_live_bytes_follow_the_call():
    """Arguments apart; temporaries counted from their op to their last
    reference, views of a storage once."""
    x = torch.zeros(1000)                            # 4,000 bytes

    def fn(x):
        a = x * 2                                    # 4,000 live
        b = a[:10]                                   # a view: nothing
        del a
        c = torch.zeros(250)                         # 1,000 live
        d = torch.zeros(2000)                        # 9,000 peak
        del b, d
        return c + 1                                 # 1,000 + 1,000
    a = HA.Analyzer()
    assert a.hold(x) == 4000
    with a:
        fn(x)
    assert a.argument_bytes == 4000
    assert a.temp_bytes == 4000 + 1000 + 8000
    assert a.live_bytes == 4000 + 13000


def test_mask_indexing_on_fake_tensors_takes_its_upper_bound():
    with FakeTensorMode():
        x = torch.empty((6, 4))
        keep = torch.empty((6,), dtype=torch.bool)
        a = HA.Analyzer()
        with a:
            sel = x[keep]
            nz = keep.nonzero()
    assert tuple(sel.shape) == (6, 4) and tuple(nz.shape) == (6, 1)
    assert a.counts.upper_bound_ops == 2
