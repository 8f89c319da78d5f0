"""The port on the card: each CUDA kernel against its plain version,
the serving path's kill/restore and a training step on the GPU.

Every test here is marked ``cuda`` and skips without a CUDA device.
This file imports neither JAX nor ``ml_dtypes`` (the machine with the
card has neither), and ``tests/conftest.py`` reaches for JAX in an
autouse fixture, so on the card run it without the conftest:

    CUBLAS_WORKSPACE_CONFIG=:4096:8 PYTHONPATH=src python -m pytest
        --noconftest -m cuda -q tests/test_torch_cuda.py

(the fixed cuBLAS workspace makes the training step deterministic; the
trainer test skips without it).
"""
import numpy as np
import pytest
import torch

from repro_torch.api import CheckpointSession, Policy
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ckpt_codec import ops
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import model as M
from repro_torch.serving.engine import Request, ServingEngine

CB = 1024
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n_bytes", [CB * 64, CB * 64 + 7, 5])
def test_kernels_match_plain(cuda_device, n_bytes):
    g = torch.Generator(device=cuda_device).manual_seed(n_bytes)
    x = torch.randint(0, 256, (n_bytes,), dtype=torch.uint8,
                      device=cuda_device, generator=g)
    ops.reset_counts()
    fp = ops.chunk_fingerprints(x, CB)
    assert torch.equal(fp, ops.fingerprint_plain(x, CB))
    prev = fp.clone()
    prev[::3, 0] ^= 1
    for cap in (1, 4, 64):
        got = ops.fused_capture_blocks(x, prev, CB, cap)
        want = ops.fused_capture_plain(x, prev, CB, cap)
        kg, ig, cg = ops.fused_unpack(got[1].cpu().numpy(), cap, CB)
        kw, iw, cw = ops.fused_unpack(want[1].cpu().numpy(), cap, CB)
        m = min(kw, cap)
        assert torch.equal(got[0], want[0]) and kg == kw
        np.testing.assert_array_equal(ig[:m], iw[:m])
        np.testing.assert_array_equal(cg[:m], cw[:m])
    y = x.flip(0).contiguous()
    assert torch.equal(ops.xor_blocks(x, y), ops.xor_plain(x, y))
    assert torch.equal(ops.xor_blocks(x[1:], y[:-1]),      # unaligned
                       ops.xor_plain(x[1:], y[:-1]))
    assert ops.counts("cuda") == {"fingerprint": 1, "fused_capture": 3,
                                  "xor": 2}
    assert ops.counts("cpu") == dict.fromkeys(ops.KERNELS, 0)
    ops.reset_counts()


def test_fused_wrapper_matches_the_cpu_route(cuda_device):
    """The same leaf through the CUDA route and the CPU route of the
    public wrapper: identical fingerprints, indices and payload, both
    within capacity and on overflow."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(CB // 4 * 100 + 9, generator=g)
    prev = ops.chunk_fingerprints(x, CB)
    y = x.clone()
    y[::CB // 4 * 7] += 1.0                       # every 7th chunk dirty
    for hint in (64, 1):
        fc, ic, dc = ops.fused_dirty_chunk_capture(y, prev, CB,
                                                   capacity_hint=hint)
        fg, ig, dg = ops.fused_dirty_chunk_capture(
            y.to(cuda_device), prev.to(cuda_device), CB, capacity_hint=hint)
        assert torch.equal(fg.cpu(), fc)
        np.testing.assert_array_equal(ig, ic)
        np.testing.assert_array_equal(dg, dc)


@pytest.mark.parametrize("sparse", [True, False])
def test_engine_kill_restore_on_the_card(cuda_device, tmp_path, sparse):
    cfg = get_smoke_config("phi4-mini-3.8b")
    params = M.init_params(cfg, seed=0, device=cuda_device)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 256, size=rng.randint(3, 14)).astype(np.int32)
               for _ in range(5)]

    def reqs():
        return [Request(rid=i, prompt=p.copy(), max_new=6)
                for i, p in enumerate(prompts)]

    ref_eng = ServingEngine.create("phi4-mini-3.8b-smoke", params,
                                   n_slots=2, max_seq=48)
    ref_reqs = reqs()
    for r in ref_reqs:
        ref_eng.submit(r)
    ref_eng.run_until_drained()
    ref = {r.rid: r.out for r in ref_reqs}

    policy = Policy(interval=4, chain=4, sparse=sparse,
                    **({"sparse_chunk_bytes": CB, "sparse_min_bytes": 2 * CB}
                       if sparse else {}))
    ops.reset_counts()
    sess = CheckpointSession(f"localfs:{tmp_path}", policy)
    eng = ServingEngine.create("phi4-mini-3.8b-smoke", params, n_slots=2,
                               max_seq=48, manager=sess.manager)
    sess.attach(eng)
    rs = reqs()
    for r in rs:
        eng.submit(r)
    for _ in range(10):
        eng.step()
        sess.maybe_snapshot()
    sess.wait()
    done = {r.rid: r.out for r in rs if r.done}
    sess.close()
    del eng
    eng2 = CheckpointSession(f"localfs:{tmp_path}", policy).restore(
        "latest", params=params)
    assert eng2.device.type == "cuda"
    assert all(t.is_cuda for t in eng2.cache.values())
    live = eng2.live_requests()
    eng2.run_until_drained()
    got = dict(done)
    got.update({r.rid: r.out for r in live})
    assert got == ref
    launched = ops.counts("cuda")
    if sparse:
        assert launched["fingerprint"] > 0 and launched["fused_capture"] > 0
    assert ops.counts("cpu") == dict.fromkeys(ops.KERNELS, 0)


# --- flash attention -----------------------------------------------------------

FLASH_CASES = [   # B, H, Hkv, Sq, Skv, hd, causal, window
    (2, 4, 2, 128, 128, 64, True, 0),      # GQA
    (1, 8, 1, 256, 256, 32, True, 0),      # MQA
    (2, 4, 4, 96, 96, 64, True, 0),        # MHA, ragged
    (1, 6, 2, 64, 320, 128, True, 0),      # cross-length
    (1, 4, 2, 1000, 1000, 128, True, 64),  # ragged + window
    (1, 2, 2, 64, 64, 16, False, 0),       # bidirectional, smoke head dim
]


def _qkv(device, dtype, B, H, Hkv, Sq, Skv, hd, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device=device).to(dtype)
    return mk(B, H, Sq, hd), mk(B, Hkv, Skv, hd), mk(B, Hkv, Skv, hd), \
        mk(B, H, Sq, hd)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain(cuda_device, case, dtype):
    """Each flash kernel against its plain version on the same card
    inputs, elementwise |kernel - plain| <= rtol * |plain| + atol. bf16:
    both versions sum in f32 and round to bf16 once, so they may differ
    by one bf16 ulp, at most 2^-7 of the value (rtol 1e-2), plus the
    order of the f32 sums (atol 1e-5). f32: that order only (rtol 1e-4).
    The LSE is f32 for both dtypes (1e-4 absolute)."""
    B, H, Hkv, Sq, Skv, hd, causal, window = case
    q, k, v, do = _qkv(cuda_device, dtype, B, H, Hkv, Sq, Skv, hd)
    kw = dict(causal=causal, window=window)
    fa.reset_counts()
    out, lse = fa.flash_fwd(q, k, v, **kw)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, **kw)
    rtol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), out_p.float(), rtol=rtol,
                               atol=1e-5)
    torch.testing.assert_close(lse, lse_p, rtol=0, atol=1e-4)
    delta = fa.attention_delta(out_p, do)
    dq = fa.flash_dq(q, k, v, do, lse_p, delta, **kw)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_p, delta, **kw)
    dq_p = fa.flash_dq_plain(q, k, v, do, lse_p, delta, **kw)
    dk_p, dv_p = fa.flash_dkv_plain(q, k, v, do, lse_p, delta, **kw)
    for a, b in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol,
                                   atol=1e-5)
    torch.cuda.synchronize()
    assert fa.counts("cuda") == {"flash_fwd": 1, "flash_dq": 1,
                                 "flash_dkv": 1}
    assert fa.counts("cpu") == dict.fromkeys(fa.KERNELS, 0)


def test_flash_kernels_are_deterministic(cuda_device):
    q, k, v, do = _qkv(cuda_device, torch.bfloat16, 1, 12, 1, 512, 512, 128)
    runs = []
    for _ in range(2):
        out, lse = fa.flash_fwd(q, k, v)
        delta = fa.attention_delta(out, do)
        runs.append((out, lse, fa.flash_dq(q, k, v, do, lse, delta),
                     *fa.flash_dkv(q, k, v, do, lse, delta)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_wrapper_refuses_what_the_kernel_cannot_take(cuda_device):
    q, k, v, _ = _qkv(cuda_device, torch.float32, 1, 2, 1, 8, 8, 24)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(q, k, v)
    q, k, v, _ = _qkv(cuda_device, torch.float32, 1, 2, 1, 8, 8, 32)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)


def test_trainer_kill_restore_on_the_card(cuda_device, tmp_path):
    """The smoke trainer through the flash kernels, snapshots, a drop and
    restore("latest") on the card: bit-identical continuation under
    deterministic algorithms (needs CUBLAS_WORKSPACE_CONFIG=:4096:8 in
    the environment, as chip_smoke.py sets it)."""
    import os
    from repro_torch.train.loop import Trainer, TrainJob
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") is None:
        pytest.skip("set CUBLAS_WORKSPACE_CONFIG=:4096:8 for deterministic "
                    "cuBLAS")
    policy = Policy(interval=2, chain=2, sparse_chunk_bytes=CB,
                    sparse_min_bytes=2 * CB)
    torch.use_deterministic_algorithms(True)
    try:
        fa.reset_counts()
        sess = CheckpointSession(f"localfs:{tmp_path}", policy)
        t = Trainer(TrainJob("starcoder2-3b-smoke", "train_s128_b2"),
                    manager=sess.manager)
        t.init_state()
        sess.attach(t)
        losses = []
        for _ in range(5):
            losses.append(t.train_steps(1)["loss"])
            sess.maybe_snapshot()
        sess.wait()
        want = t.state_digest()
        sess.close()
        del t
        t2 = CheckpointSession(f"localfs:{tmp_path}", policy).restore(
            "latest", expect_kind="train")
        assert t2.device.type == "cuda" and t2.checkpoint_step() == 4
        assert t2.train_steps(1)["loss"] == losses[4]
        assert t2.state_digest() == want
    finally:
        torch.use_deterministic_algorithms(False)
    launched = fa.counts("cuda")
    assert launched["flash_fwd"] == 2 * 2 * 6     # 2 layers, remat, 6 steps
    assert launched["flash_dq"] == launched["flash_dkv"] == 2 * 6
