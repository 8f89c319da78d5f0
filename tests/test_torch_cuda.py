"""The port on the card: each CUDA kernel against its plain version,
and the serving path's kill/restore on the GPU.

Every test here is marked ``cuda`` and skips without a CUDA device.
This file imports neither JAX nor ``ml_dtypes`` (the machine with the
card has neither), and ``tests/conftest.py`` reaches for JAX in an
autouse fixture, so on the card run it without the conftest:

    PYTHONPATH=src python -m pytest --noconftest -m cuda -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.api import CheckpointSession, Policy
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ckpt_codec import ops
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
