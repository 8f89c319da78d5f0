"""The port on the card: each CUDA kernel against its plain version,
the serving path's kill/restore, the Mamba-2 prefill and decode, the
hybrid's prefill, decode and engine, and trainer kill/restore on the
GPU.

Every test here is marked ``cuda`` and skips without a CUDA device.
This file imports neither JAX nor ``ml_dtypes`` (the machine with the
card has neither), and ``tests/conftest.py`` reaches for JAX in an
autouse fixture, so on the card run it without the conftest:

    CUBLAS_WORKSPACE_CONFIG=:4096:8 PYTHONPATH=src python -m pytest
        --noconftest -m cuda -q tests/test_torch_cuda.py

(the fixed cuBLAS workspace makes the training step deterministic; the
trainer tests skip without it).
"""
import numpy as np
import pytest
import torch

from repro_torch.api import CheckpointSession, Policy
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ckpt_codec import ops
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.ssd_scan import ref as ssd_ref
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
    assert ops.counts("cuda") == dict(dict.fromkeys(ops.KERNELS, 0),
                                      fingerprint=1, fused_capture=3, xor=2)
    assert ops.counts("cpu") == dict.fromkeys(ops.KERNELS, 0)
    ops.reset_counts()


# the XOR kernel's cases: the delta codec's 4 MiB view, a size that is no
# multiple of the unroll (8 words of 16 bytes a thread), and views 1 and 3
# bytes off the 16-byte alignment (the byte path), each as (bytes, offset
# of a, offset of b)
XOR_CASES = [(4 << 20, 0, 0), ((4 << 20) + 16 * 8 * 3 + 37, 0, 0),
             (4 << 20, 1, 1), (4 << 20, 3, 3), ((4 << 20) + 5, 1, 3)]


@pytest.mark.parametrize("case", XOR_CASES)
def test_xor_kernel_is_bit_exact(cuda_device, case):
    n, oa, ob = case
    g = torch.Generator(device=cuda_device).manual_seed(n + oa + ob)
    a = torch.randint(0, 256, (n + oa,), dtype=torch.uint8,
                      device=cuda_device, generator=g)[oa:]
    b = torch.randint(0, 256, (n + ob,), dtype=torch.uint8,
                      device=cuda_device, generator=g)[ob:]
    ops.reset_counts()
    got = ops.xor_blocks(a, b)
    assert ops.counts("cuda")["xor"] == 1
    assert torch.equal(got, ops.xor_plain(a, b))
    ops.reset_counts()


def _codec_input(case, device):
    """Inputs of the int8 codec kernels: a ragged size (numel and nb not
    multiples of any tile), zero blocks, exact ties at scale 1.0, values
    drawn as AdamW's nu makes them, float16 and float64, and a view 4
    bytes off the 16-byte alignment (the scalar load path)."""
    rng = np.random.RandomState(7)
    if case == "ragged":
        x = rng.randn(300_001) * 3
    elif case == "zeros":
        x = np.zeros(5 * 256 + 3)
    elif case == "ties":
        x = np.zeros(512)
        x[0] = 127.0
        x[1:9] = [0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 3.5, -3.5]
    elif case == "adamw_nu":
        x = np.exp(rng.uniform(np.log(1e-14), np.log(1e-6), size=70_000))
    else:
        x = rng.randn(10_000) * 5
    dtype = {"float16": torch.float16, "float64": torch.float64}.get(
        case, torch.float32)
    t = torch.from_numpy(x).to(dtype).to(device)
    return t[1:] if case == "unaligned" else t


@pytest.mark.parametrize("case", ["ragged", "zeros", "ties", "adamw_nu",
                                  "float16", "float64", "unaligned"])
def test_codec_kernels_match_plain_and_the_oracle(cuda_device, case):
    """quantize and dequantize on the card: bit for bit the plain
    version on the card, and the numpy oracle on the host."""
    from repro_torch.kernels.ckpt_codec import ref
    x = _codec_input(case, cuda_device)
    ops.reset_counts()
    q, scale = ops.quantize(x)
    qp, sp = ops.quantize_plain(x)
    assert torch.equal(q, qp)
    assert torch.equal(scale.view(torch.int32), sp.view(torch.int32))
    qr, sr = ref.quantize_ref(x.cpu().numpy())
    np.testing.assert_array_equal(q.cpu().numpy(), qr)
    assert scale.cpu().numpy().tobytes() == sr.tobytes()
    d = ops.dequantize(q, scale)
    assert torch.equal(d.view(torch.int32),
                       ops.dequantize_plain(q, scale).view(torch.int32))
    assert d.cpu().numpy().tobytes() == ref.dequantize_ref(qr, sr).tobytes()
    assert ops.counts("cuda") == dict(dict.fromkeys(ops.KERNELS, 0),
                                      quantize=1, dequantize=1)
    assert ops.counts("cpu") == dict.fromkeys(ops.KERNELS, 0)


def test_codec_kernels_refuse_what_they_cannot_take(cuda_device):
    with pytest.raises(ValueError, match="float"):
        ops.quantize(torch.ones(512, dtype=torch.int32, device=cuda_device))
    q = torch.zeros((2, 256), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="int8"):
        ops.dequantize(q, torch.ones(3, device=cuda_device))
    with pytest.raises(ValueError, match="int8"):
        ops.dequantize(q, torch.ones(2))                 # scale on the host


def test_codec_route_on_the_card(cuda_device, tmp_path):
    """A mamba2 smoke trainer on the card under the int8 codec: capture
    launches one quantize per codec leaf and restore one dequantize,
    no plain call on either side, and the restored moments are the
    plain dequantize(quantize(m)) of the moments at the snapshot."""
    from repro_torch.core.delta import codec_applicable
    from repro_torch.train.loop import Trainer, TrainJob
    from repro_torch.tree import flatten_with_paths
    policy = Policy(interval=2, chain=1, codecs={"opt_state": "int8"})
    sess = CheckpointSession(f"sharded:{tmp_path}?hosts=4", policy)
    t = Trainer(TrainJob("mamba2-780m-smoke", "train_s512_b2"),
                manager=sess.manager)
    t.init_state()
    sess.attach(t)
    t.train_steps(2)
    clone = {p: v.clone() for p, v in flatten_with_paths(
        t.upper.get("opt_state")) if codec_applicable(v, "int8")}
    ops.reset_counts()
    sess.maybe_snapshot()
    t.train_steps(1)                  # in place, after snapshot() returned
    sess.wait()
    n = len(clone)
    assert n and ops.counts("cuda")["quantize"] == n
    st = sess.stats
    assert st["capture_bytes"] < st["bytes_logical"] / 2
    sess.close()
    del t
    t2 = CheckpointSession(f"sharded:{tmp_path}?hosts=4", policy).restore(
        "latest", expect_kind="train")
    assert ops.counts("cuda")["dequantize"] == n
    assert ops.counts("cpu") == dict.fromkeys(ops.KERNELS, 0)
    for p, v in flatten_with_paths(t2.upper.get("opt_state")):
        if p in clone:
            qp, sp = ops.quantize_plain(clone[p])
            want = ops.dequantize_plain(qp, sp)[:v.numel()].view(v.shape)
            assert v.is_cuda and torch.equal(v.view(torch.int32),
                                              want.view(torch.int32)), p


def test_a_coded_serving_cache_is_dequantized_on_the_card(cuda_device,
                                                         tmp_path):
    """A mamba2 smoke engine on the card under ``codecs={"cache":
    "int8"}``: capture quantizes its float32 scan states with the kernel,
    restore dequantizes them with the kernel on the card, no plain call
    on either side, into the plain dequantize(quantize(state))."""
    from repro_torch.core.delta import device_codec
    from repro_torch.tree import flatten_with_paths
    policy = Policy(interval=3, chain=1, codecs={"cache": "int8"})
    params = M.init_params(get_smoke_config("mamba2-780m"), seed=0,
                           device=cuda_device)
    sess = CheckpointSession(f"localfs:{tmp_path}", policy)
    eng = ServingEngine.create("mamba2-780m-smoke", params, n_slots=2,
                               max_seq=48, manager=sess.manager)
    sess.attach(eng)
    rng = np.random.RandomState(0)
    for i in range(3):
        eng.submit(Request(rid=i, prompt=rng.randint(0, 256, size=9)
                           .astype(np.int32), max_new=6))
    for _ in range(3):
        eng.step()
    coded = {p: v.clone() for p, v in flatten_with_paths(eng.cache)
             if device_codec(v, "int8")}
    assert coded
    ops.reset_counts()
    sess.maybe_snapshot()
    sess.wait()
    sess.close()
    del eng
    eng2 = CheckpointSession(f"localfs:{tmp_path}", policy).restore(
        "latest", params=params)
    launched = ops.counts("cuda")
    assert launched["quantize"] == launched["dequantize"] == len(coded)
    assert ops.counts("cpu") == dict.fromkeys(ops.KERNELS, 0)
    for p, v in flatten_with_paths(eng2.cache):
        if p in coded:
            want = ops.dequantize_plain(*ops.quantize_plain(coded[p]))
            assert v.is_cuda and torch.equal(
                v.view(torch.int32),
                want[:v.numel()].view(v.shape).view(torch.int32)), p
    eng2.run_until_drained(max_steps=400)


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
    # the bf16 tensor-core kernels' edges: 64 x 64 tiles, 16 query or key
    # rows per warp, the GQA group split over dk/dv blocks
    (1, 24, 2, 256, 256, 128, True, 0),    # starcoder2-3b's group (split 4)
    (2, 6, 2, 333, 333, 128, True, 0),     # ragged past every tile, causal
    (1, 4, 1, 333, 333, 64, True, 100),    # ragged with a window (split 4)
    (1, 4, 2, 192, 192, 16, True, 0),      # head dim 16
    (1, 6, 3, 130, 130, 32, True, 40),     # head dim 32, ragged, window
    (1, 4, 2, 300, 100, 64, True, 0),      # cross-length, Sq > Skv
    (1, 3, 1, 100, 300, 32, False, 0),     # cross-length, bidirectional
    # non-causal with Sq != Skv, as whisper's encoder and cross-attention
    # take them (MHA: a group of 1, so dk/dv is not split)
    (1, 8, 8, 300, 1000, 64, False, 0),    # ragged cross, Sq < Skv
    (2, 8, 8, 256, 150, 64, False, 0),     # cross, Sq > Skv, ragged keys
    (1, 4, 4, 150, 150, 64, False, 0),     # ragged encoder
    # head dim 256 (recurrentgemma-9b: MQA, a window; its bf16 kernels
    # are flash_attention_hd256.cu's, blocks of 128 query rows in the
    # forward, 64 in dq and dk/dv, its f32 ones take 32-row tiles): a
    # window that skips whole tiles, ragged rows, a group of 16 over one
    # kv head (split 4), non-causal
    (1, 16, 1, 700, 700, 256, True, 256),
    (2, 4, 1, 333, 333, 256, True, 100),
    (1, 2, 2, 96, 160, 256, False, 0),
    (1, 4, 2, 130, 130, 256, True, 0),       # group 2, 2 rows past a tile
    (1, 16, 1, 700, 700, 256, True, 300),    # a window off the tile grid
    (1, 2, 1, 2200, 2200, 256, True, 2048),  # the model's window
    (1, 4, 4, 333, 200, 256, False, 0),      # group 1, cross, Sq > Skv
    (2, 2, 1, 130, 333, 256, True, 100),     # group 2, Sq < Skv, window
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
    """The same bits from run to run, in bf16 through the split dk/dv
    path (partials summed in a fixed order: groups of 12 and 6 over 4
    and 3 blocks) and in f32."""
    for dtype, (B, H, Hkv, S) in ((torch.bfloat16, (1, 12, 1, 512)),
                                  (torch.bfloat16, (2, 24, 4, 320)),
                                  (torch.float32, (1, 4, 2, 256))):
        assert dtype != torch.bfloat16 or fa.dkv_splits(H, Hkv) > 1
        q, k, v, do = _qkv(cuda_device, dtype, B, H, Hkv, S, S, 128)
        runs = []
        for _ in range(2):
            out, lse = fa.flash_fwd(q, k, v)
            delta = fa.attention_delta(out, do)
            runs.append((out, lse, fa.flash_dq(q, k, v, do, lse, delta),
                         *fa.flash_dkv(q, k, v, do, lse, delta)))
        for a, b in zip(*runs):
            assert torch.equal(a, b)


def test_flash_kernels_at_head_dim_256_are_deterministic(cuda_device):
    """recurrentgemma-9b's attention at a reduced length (q [1,16,1024,
    256], k/v [1,1,1024,256], window 512): the same bits from run to run
    in bf16 (dk/dv split over 4 blocks per kv tile, partials summed in a
    fixed order) and f32."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = _qkv(cuda_device, dtype, 1, 16, 1, 1024, 1024, 256)
        runs = []
        for _ in range(2):
            out, lse = fa.flash_fwd(q, k, v, window=512)
            delta = fa.attention_delta(out, do)
            runs.append((out, lse, fa.flash_dq(q, k, v, do, lse, delta,
                                               window=512),
                         *fa.flash_dkv(q, k, v, do, lse, delta,
                                       window=512)))
        for a, b in zip(*runs):
            assert torch.equal(a, b)


def test_hybrid_trainer_parallel_encode_restores_on_the_card(cuda_device,
                                                             tmp_path):
    """recurrentgemma-9b-smoke trains on the card (the RG-LRU forward and
    backward kernels, flash at head dim 16) under deterministic
    algorithms, its snapshots encoded over the pack pool (more than one
    thread on the card's machine), then drop and ``restore("latest")``:
    the next loss and the state digest bit-identical, and the snapshot's
    blob files and manifest entries those a one-thread encode of the same
    run writes."""
    import os
    from repro_torch.core import async_snapshot
    from repro_torch.kernels.rg_lru import ops as rg
    from repro_torch.train.loop import Trainer, TrainJob
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") is None:
        pytest.skip("set CUBLAS_WORKSPACE_CONFIG=:4096:8 for deterministic "
                    "cuBLAS")
    assert async_snapshot.encode_workers() > 1
    policy = Policy(interval=2, chain=2, sparse_chunk_bytes=CB,
                    sparse_min_bytes=2 * CB)

    def files(root):
        """The blob files, and each manifest's entries."""
        import json
        out = {}
        for d, _, names in os.walk(root):
            for n in names:
                path = os.path.join(d, n)
                data = open(path, "rb").read()
                if n.endswith(".json"):
                    data = json.loads(data)["entries"]
                out[os.path.relpath(path, root)] = data
        return out

    def run(root):
        sess = CheckpointSession(f"localfs:{root}", policy)
        t = Trainer(TrainJob("recurrentgemma-9b-smoke", "train_s64_b2"),
                    manager=sess.manager)
        t.init_state()
        sess.attach(t)
        losses = []
        for _ in range(5):
            losses.append(t.train_steps(1)["loss"])
            sess.maybe_snapshot()
        sess.wait()
        digest = t.state_digest()
        sess.close()
        return losses, digest

    torch.use_deterministic_algorithms(True)
    try:
        rg.reset_counts()
        fa.reset_counts()
        losses, want = run(tmp_path / "pool")
        assert rg.counts("cuda")["rg_lru_bwd"] == 4 * 5   # 4 rec. layers
        assert fa.counts("cuda")["flash_dkv"] == 1 * 5     # 1 attn layer
        t2 = CheckpointSession(f"localfs:{tmp_path / 'pool'}",
                               policy).restore("latest", expect_kind="train")
        assert t2.device.type == "cuda" and t2.checkpoint_step() == 4
        assert t2.train_steps(1)["loss"] == losses[4]
        assert t2.state_digest() == want
        del t2
        one = pytest.MonkeyPatch()
        one.setattr(async_snapshot, "encode_workers", lambda: 1)
        try:
            assert run(tmp_path / "one") == (losses, want)
        finally:
            one.undo()
    finally:
        torch.use_deterministic_algorithms(False)
    assert files(tmp_path / "pool") == files(tmp_path / "one")


def test_flash_wrapper_refuses_what_the_kernel_cannot_take(cuda_device):
    q, k, v, _ = _qkv(cuda_device, torch.float32, 1, 2, 1, 8, 8, 24)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(q, k, v)
    q, k, v, _ = _qkv(cuda_device, torch.float32, 1, 2, 1, 8, 8, 32)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    for dtype in (torch.bfloat16, torch.float32):   # cp.async: 16 bytes
        q, k, v, _ = _qkv(cuda_device, dtype, 1, 2, 1, 8, 8, 32)
        buf = torch.empty(q.numel() + 1, dtype=dtype, device=cuda_device)
        shifted = buf[1:].view(q.shape).copy_(q)
        assert shifted.is_contiguous() and shifted.data_ptr() % 16
        with pytest.raises(ValueError, match="aligned"):
            fa.flash_fwd(shifted, k, v)


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


def test_whisper_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One f32 train step of whisper-base-smoke on the card (the flash
    kernels: the encoder and the cross-attention non-causal with Sq !=
    Skv) against the same step on the CPU (the plain versions), TF32
    off: loss and grad norm within 1e-5 relative, each leaf's gradient
    within 1e-4 in the relative 2-norm (``chip_smoke.py``'s floor for a
    gradient). The params after the step are not held elementwise:
    AdamW's first step moves a param by ~lr * g / (|g| + eps), so
    gradient elements near zero move the encoder's key projection by up
    to 2.4e-5 (an H100 against the CPU)."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.optim import AdamWConfig, ScheduleConfig, init_opt_state
    from repro_torch.parallel.planner import make_plan
    from repro_torch.configs.registry import get_shape
    from repro_torch.train.step import (make_loss_fn, make_train_step,
                                        value_and_grad)
    from repro_torch.tree import flatten_with_paths, tree_map
    cfg = get_smoke_config("whisper-base").replace(dtype="float32")
    plan = make_plan(cfg, get_shape("train_s64_b2"))
    step_fn = make_train_step(cfg, plan, AdamWConfig(), ScheduleConfig())
    loss_fn = make_loss_fn(cfg, M.CallOptions(remat=plan.remat))
    batch = TokenPipeline(DataConfig(
        seed=7, vocab_size=cfg.vocab_size, seq_len=64, global_batch=2,
        n_shards=2, frames=cfg.encoder_seq,
        frame_dim=cfg.frontend_dim)).batch_at(0)
    p_cpu = M.init_params(cfg, seed=3, device="cpu")

    def run(dev):
        params = tree_map(lambda t: t.to(dev, copy=True), p_cpu)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        _, g = value_and_grad(loss_fn, params, b)
        opt = init_opt_state(params, AdamWConfig())
        _, _, met = step_fn(params, opt, b, 150, torch.tensor(1.0))
        return met, {p: t.cpu() for p, t in flatten_with_paths(g)}

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        fa.reset_counts()
        met, got = run(cuda_device)
        launched = fa.counts("cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    want_met, want = run("cpu")
    n = cfg.n_encoder_layers + 2 * cfg.n_layers   # attention calls a pass
    # value_and_grad: fwd twice (remat), dq, dk/dv; then the step again
    assert launched == {"flash_fwd": 4 * n, "flash_dq": 2 * n,
                        "flash_dkv": 2 * n}
    for key in ("loss", "grad_norm"):
        a, b = float(want_met[key]), float(met[key])
        assert abs(a - b) <= 1e-5 * abs(a), key
    for path, g in want.items():
        err = float((got[path] - g).norm() / g.norm().clamp_min(1e-30))
        assert err <= 1e-4, (path, err)


# --- the SSD scan ----------------------------------------------------------------

SSD_CASES = [   # B, S, H, P, N, chunk, dtype, init_state
    (2, 256, 3, 32, 16, 64, torch.float32, False),
    (1, 512, 4, 64, 128, 256, torch.bfloat16, False),  # the model's dims
    (1, 300, 2, 64, 128, 300, torch.float32, True),    # ragged, chunk = S
    (2, 100, 3, 16, 16, 100, torch.float32, True),     # smoke dims
    (1, 192, 2, 8, 8, 64, torch.bfloat16, False),      # matrix dims
    # 8 chunks, and 10 heads: no multiple of the backward's head group (8)
    (1, 2048, 10, 64, 128, 256, torch.bfloat16, True),
    # 32 chunks: the forward's pass carries the state across all of them
    (1, 8192, 4, 64, 128, 256, torch.bfloat16, True),
]


def _ssd_inputs(device, B, S, H, P, N, dtype, init, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device=device)
    x, Bm, Cm = mk(B, S, H, P).to(dtype), mk(B, S, N).to(dtype), \
        mk(B, S, N).to(dtype)
    dt, A = ssd_ref.model_dt_A(B, S, H, g, device)
    s0 = mk(B, H, P, N) if init else None
    return x, dt, A, Bm, Cm, s0, mk(B, S, H, P), mk(B, H, P, N)


def _alt_chunk(q):
    return q // 4 if q % 4 == 0 else q


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_kernels_match_plain(cuda_device, case):
    """ssd_fwd (y, final state) and ssd_bwd (all five gradients) against
    their plain versions on the same card inputs. Each output's limit is
    elementwise rtol * (|plain| + rms(plain)), with rtol = max(4 x the
    spread between the plain version at the chunk and at a quarter of
    it — the same math blocked differently — , 1e-4)."""
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.ssd_scan import ref as R
    B, S, H, P, N, q, dtype, init = case
    x, dt, A, Bm, Cm, s0, dy, dfin = _ssd_inputs(cuda_device, B, S, H, P, N,
                                                 dtype, init)
    ssd.reset_counts()
    y, fin, states = ssd.ssd_fwd(x, dt, A, Bm, Cm, q, s0)
    grads = ssd.ssd_bwd(x, dt, A, Bm, Cm, states, dy, dfin, q)
    torch.cuda.synchronize()
    assert ssd.counts("cuda") == {"ssd_fwd": 1, "ssd_bwd": 1}
    assert ssd.counts("cpu") == {"ssd_fwd": 0, "ssd_bwd": 0}
    want = (*R.ssd_chunked_plain(x, dt, A, Bm, Cm, q, s0),
            *R.ssd_grads_plain(x, dt, A, Bm, Cm, dy, q, dfin, s0))
    alt = (*R.ssd_chunked_plain(x, dt, A, Bm, Cm, _alt_chunk(q), s0),
           *R.ssd_grads_plain(x, dt, A, Bm, Cm, dy, _alt_chunk(q), dfin, s0))
    got = (y, fin, *grads)
    names = ("y", "final", "dx", "ddt", "dA", "dB", "dC")
    for name, a, w, spread in zip(names, got, want,
                                  R.blocking_spread(want, alt)):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert torch.isfinite(a).all(), name
        assert R.within(a, w, R.tolerance(spread)) <= 1.0, (name, spread)


def test_ssd_kernels_are_deterministic(cuda_device):
    from repro_torch.kernels.ssd_scan import ops as ssd
    x, dt, A, Bm, Cm, _, dy, _ = _ssd_inputs(cuda_device, 2, 512, 6, 64, 128,
                                             torch.bfloat16, False)
    runs = []
    for _ in range(2):
        y, fin, st = ssd.ssd_fwd(x, dt, A, Bm, Cm, 256)
        runs.append((y, fin, st, *ssd.ssd_bwd(x, dt, A, Bm, Cm, st, dy, None,
                                              256)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_ssd_backward_is_deterministic_at_the_training_shape(cuda_device):
    """mamba2-780m's training shape (x [8,4096,48,64], B/C [8,4096,128]
    bf16, chunk 256): three ``ssd_bwd`` calls give the same bits — the
    head-group and (batch, chunk) partials are summed in a fixed order,
    with no atomics."""
    from repro_torch.kernels.ssd_scan import ops as ssd
    x, dt, A, Bm, Cm, _, dy, _ = _ssd_inputs(cuda_device, 8, 4096, 48, 64,
                                             128, torch.bfloat16, False)
    _, _, st = ssd.ssd_fwd(x, dt, A, Bm, Cm, 256)
    first = ssd.ssd_bwd(x, dt, A, Bm, Cm, st, dy, None, 256)
    for _ in range(2):
        again = ssd.ssd_bwd(x, dt, A, Bm, Cm, st, dy, None, 256)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_ssd_forward_is_deterministic_at_the_training_shape(cuda_device):
    """mamba2-780m's training shape: three ``ssd_fwd`` calls give the same
    bits (y, final state, chunk-start states) — every sum has one owner
    and a fixed order, with no atomics."""
    from repro_torch.kernels.ssd_scan import ops as ssd
    x, dt, A, Bm, Cm, *_ = _ssd_inputs(cuda_device, 8, 4096, 48, 64, 128,
                                       torch.bfloat16, False)
    first = ssd.ssd_fwd(x, dt, A, Bm, Cm, 256)
    for _ in range(2):
        again = ssd.ssd_fwd(x, dt, A, Bm, Cm, 256)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.parametrize("init", [False, True])
def test_ssd_forward_without_saved_states_matches(cuda_device, init):
    """A serving prefill (``save_states=False``: the states are the
    wrapper's scratch) gives the bits of the call that saves them."""
    from repro_torch.kernels.ssd_scan import ops as ssd
    x, dt, A, Bm, Cm, s0, *_ = _ssd_inputs(cuda_device, 2, 1024, 6, 64, 128,
                                           torch.bfloat16, init)
    ssd.reset_counts()
    y, fin, states = ssd.ssd_fwd(x, dt, A, Bm, Cm, 256, s0)
    y2, fin2, none = ssd.ssd_fwd(x, dt, A, Bm, Cm, 256, s0,
                                 save_states=False)
    assert states is not None and none is None
    assert torch.equal(y, y2) and torch.equal(fin, fin2)
    assert ssd.counts("cuda")["ssd_fwd"] == 2


def test_ssd_wrapper_refuses_what_the_kernel_cannot_take(cuda_device):
    from repro_torch.kernels.ssd_scan import ops as ssd
    x, dt, A, Bm, Cm, *_ = _ssd_inputs(cuda_device, 1, 64, 2, 128, 16,
                                       torch.float32, False)
    with pytest.raises(ValueError, match="head dim"):
        ssd.ssd_fwd(x, dt, A, Bm, Cm, 64)
    x, dt, A, Bm, Cm, *_ = _ssd_inputs(cuda_device, 1, 64, 2, 32, 16,
                                       torch.float32, False)
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_fwd(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A,
                    Bm, Cm, 64)


def test_mamba2_prefill_and_decode_on_the_card(cuda_device):
    """The smoke model's prefill (the forward kernel, no gradient, so no
    chunk states saved) and a decode step on the card against the CPU
    (plain scan), float32: the same math summed in another order."""
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.tree import tree_map
    cfg = get_smoke_config("mamba2-780m").replace(dtype="float32")
    p_cpu = M.init_params(cfg, seed=3, device="cpu")
    p_gpu = tree_map(lambda t: t.to(cuda_device), p_cpu)
    toks = torch.arange(2 * 300, dtype=torch.int32).reshape(2, 300) % 200
    ssd.reset_counts()
    res = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        cache = M.init_cache(cfg, 2, 512, device=dev)
        last, cache = M.prefill(cfg, params, toks.to(dev), cache)
        step, cache = M.decode_step(
            cfg, params, cache, torch.tensor([[5], [7]], dtype=torch.int32,
                                             device=dev),
            torch.tensor([300, 300], dtype=torch.int32, device=dev))
        res[dev] = (last.cpu(), step.cpu(), cache["state"].cpu())
    assert ssd.counts("cuda") == {"ssd_fwd": cfg.n_layers, "ssd_bwd": 0}
    for a, b in zip(res["cuda"], res["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_mamba2_trainer_kill_restore_on_the_card(cuda_device, tmp_path):
    """The mamba2 smoke trainer through the SSD kernels: snapshots, a
    drop and restore("latest") on the card, bit-identical under
    deterministic algorithms (needs CUBLAS_WORKSPACE_CONFIG)."""
    import os
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.train.loop import Trainer, TrainJob
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") is None:
        pytest.skip("set CUBLAS_WORKSPACE_CONFIG=:4096:8 for deterministic "
                    "cuBLAS")
    policy = Policy(interval=2, chain=2, sparse_chunk_bytes=CB,
                    sparse_min_bytes=2 * CB)
    torch.use_deterministic_algorithms(True)
    try:
        ssd.reset_counts()
        sess = CheckpointSession(f"localfs:{tmp_path}", policy)
        t = Trainer(TrainJob("mamba2-780m-smoke", "train_s512_b2"),
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
    launched = ssd.counts("cuda")
    assert launched["ssd_fwd"] == 2 * 2 * 6     # 2 layers, remat, 6 steps
    assert launched["ssd_bwd"] == 2 * 6


# (B, S, W, with h0, the rglru_a init's range): a prefill-like width, a
# ragged one, a tail shorter than the kernel's 8-step unroll, decays
# near one (where 1 - a^2 in f32 keeps under two digits); a sequence that
# is no multiple of the kernel's 256-token time chunk, one shorter than a
# chunk, and 128 chunks at decays near one, where the carry crosses
# every chunk almost undiminished
INIT, NEAR_ONE = (0.9, 0.999), (0.99999, 0.999999)
RGLRU_CASES = [(2, 4096, 1024, False, INIT), (2, 4096, 1024, True, INIT),
               (3, 1000, 1000, True, INIT), (1, 7, 33, False, INIT),
               (3, 1000, 1000, True, NEAR_ONE), (2, 1000, 300, True, INIT),
               (1, 200, 64, True, INIT), (1, 32768, 256, True, NEAR_ONE)]


@pytest.mark.parametrize("case", RGLRU_CASES)
def test_rg_lru_kernel_matches_plain(cuda_device, case):
    """rg_lru_fwd against its plain version on the same card inputs,
    drawn as a fresh block makes them (``ref.model_inputs``: decays of
    0.66-0.996 a token, so a dropped carry shows): every element within
    1e-4 * (|plain| + rms(plain))."""
    from repro_torch.kernels.rg_lru import ops as rg
    from repro_torch.kernels.rg_lru import ref as R
    B, S, W, init, u_range = case
    g = torch.Generator(device=cuda_device).manual_seed(S + W)
    x, r, i, lam = R.model_inputs(B, S, W, g, cuda_device, u_range)
    h0 = torch.randn((B, W), generator=g, device=cuda_device) if init \
        else None
    rg.reset_counts()
    h = rg.rg_lru_fwd(x, r, i, lam, h0)
    torch.cuda.synchronize()
    assert rg.counts("cuda") == {"rg_lru_fwd": 1, "rg_lru_bwd": 0}
    assert rg.counts("cpu") == {"rg_lru_fwd": 0, "rg_lru_bwd": 0}
    assert torch.isfinite(h).all()
    assert ssd_ref.within(h, R.rg_lru_plain(x, r, i, lam, h0), 1e-4) <= 1.0
    assert torch.equal(h, rg.rg_lru_fwd(x, r, i, lam, h0))  # deterministic


@pytest.mark.parametrize("case", RGLRU_CASES)
def test_rg_lru_bwd_kernel_matches_plain(cuda_device, case):
    """rg_lru_bwd against its plain version (the same phases in plain
    tensors) on the same card inputs: dx, dr, di, dlam and dh0 each
    within 1e-4 * (|plain| + rms(plain)), as the forward; the same bits
    on a second call (no atomics, a fixed order)."""
    from repro_torch.kernels.rg_lru import ops as rg
    from repro_torch.kernels.rg_lru import ref as R
    B, S, W, init, u_range = case
    g = torch.Generator(device=cuda_device).manual_seed(S + W + 1)
    x, r, i, lam = R.model_inputs(B, S, W, g, cuda_device, u_range)
    h0 = torch.randn((B, W), generator=g, device=cuda_device) if init \
        else None
    dh = torch.randn((B, S, W), generator=g, device=cuda_device)
    h = rg.rg_lru_fwd(x, r, i, lam, h0)
    rg.reset_counts()
    got = rg.rg_lru_bwd(x, r, i, lam, h, dh, h0)
    torch.cuda.synchronize()
    assert rg.counts("cuda") == {"rg_lru_fwd": 0, "rg_lru_bwd": 1}
    want = R.rg_lru_bwd_plain(x, r, i, lam, h, dh, h0)
    for name, a, b in zip(("dx", "dr", "di", "dlam", "dh0"), got, want):
        assert torch.isfinite(a).all(), name
        assert ssd_ref.within(a, b, 1e-4) <= 1.0, name
    again = rg.rg_lru_bwd(x, r, i, lam, h, dh, h0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_rg_lru_autograd_on_the_card_matches_the_cpu(cuda_device):
    """Gradients through the differentiable ``rg_lru`` (the forward and
    backward kernels) against the same loss on the CPU (the plain
    versions), from a state: each within 1e-4 * (|cpu| + rms(cpu))."""
    from repro_torch.kernels.rg_lru import ops as rg
    from repro_torch.kernels.rg_lru import ref as R
    g = torch.Generator().manual_seed(4)
    ins = R.model_inputs(2, 700, 96, g, "cpu") + (
        torch.randn((2, 96), generator=g),)
    dy = torch.randn((2, 700, 96), generator=g)
    grads = {}
    for dev in ("cpu", "cuda"):
        leaves = [t.detach().to(dev).requires_grad_(True) for t in ins]
        (rg.rg_lru(*leaves) * dy.to(dev)).sum().backward()
        grads[dev] = [t.grad.cpu() for t in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert ssd_ref.within(a, b, 1e-4) <= 1.0


def test_rg_lru_wrapper_refuses_what_the_kernel_cannot_take(cuda_device):
    from repro_torch.kernels.rg_lru import ops as rg
    from repro_torch.kernels.rg_lru import ref as R
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x, r, i, lam = R.model_inputs(2, 32, 64, g, cuda_device)
    # a CUDA input that requires grad has a backward now: the gradient
    # of the sum is finite and reaches every input
    xg = x.clone().requires_grad_(True)
    rg.rg_lru(xg, r, i, lam).sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()
    assert float(xg.grad.abs().sum()) > 0
    with pytest.raises(ValueError, match="contiguous"):
        rg.rg_lru_fwd(x.detach().transpose(0, 1).contiguous().transpose(
            0, 1), r, i, lam)
    with pytest.raises(ValueError, match="tensors on"):
        rg.rg_lru_fwd(x.detach(), r, i, lam.cpu())


def test_hybrid_prefill_decode_and_engine_on_the_card(cuda_device):
    """recurrentgemma-9b-smoke (one group and two remainder blocks) in
    float32: prefill (the RG-LRU kernel, once per recurrent layer), then
    decode steps past the window of 32, card against CPU (plain
    recurrence) within 1e-5 on logits and every cache leaf; the engine's
    greedy tokens equal on both devices, and its replay admission
    launches no kernel."""
    from repro_torch.kernels.rg_lru import ops as rg
    from repro_torch.tree import flatten_with_paths, tree_map
    cfg = get_smoke_config("recurrentgemma-9b").replace(dtype="float32")
    p_cpu = M.init_params(cfg, seed=3, device="cpu")
    p_gpu = tree_map(lambda t: t.to(cuda_device), p_cpu)
    toks = torch.arange(2 * 20, dtype=torch.int32).reshape(2, 20) % 200
    rg.reset_counts()
    res = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        cache = M.init_cache(cfg, 2, 64, device=dev)
        logits = [M.prefill(cfg, params, toks.to(dev), cache)[0]]
        for pos in range(20, 40):
            nxt = torch.tensor([[pos % 7], [pos % 11]], dtype=torch.int32,
                               device=dev)
            logits.append(M.decode_step(
                cfg, params, cache, nxt,
                torch.tensor([pos, pos], dtype=torch.int32, device=dev))[0])
        res[dev] = ([t.cpu() for t in logits],
                    [t.cpu() for _, t in flatten_with_paths(cache)])
    assert rg.counts("cuda") == {"rg_lru_fwd": 4,   # 4 recurrent layers
                                 "rg_lru_bwd": 0}
    for a, b in zip(res["cuda"][0] + res["cuda"][1],
                    res["cpu"][0] + res["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    rg.reset_counts()
    prompts = [np.arange(n, dtype=np.int32) % 97 for n in (12, 25, 7)]
    out = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        eng = ServingEngine(cfg, params, dev, n_slots=2, max_seq=64)
        reqs = [Request(rid=i, prompt=p, max_new=20)
                for i, p in enumerate(prompts)]
        for q in reqs:
            eng.submit(q)
        eng.run_until_drained()
        out[dev] = [q.out for q in reqs]
    assert out["cuda"] == out["cpu"]
    assert rg.counts("cuda") == {"rg_lru_fwd": 0, "rg_lru_bwd": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_rows_do_not_depend_on_the_batch(cuda_device,
                                                          dtype):
    """A decode row's attention output is the same bits at 2, 3 and 4
    rows, at llama4-scout's decode shape (8 kv heads of 5 queries, hd
    128, 1,024 cached positions): cuBLAS's batched p·v product gave a
    row other bits at 3 rows than at 4, so a session re-slotted onto
    another slot count decoded other tokens (ROADMAP C23)."""
    from repro_torch.models import layers as L
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(4, 1, 8, 5, 128, device=cuda_device, generator=g)
    k = torch.randn(4, 1024, 8, 128, device=cuda_device, generator=g)
    v = torch.randn(4, 1024, 8, 128, device=cuda_device, generator=g)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    q_pos = torch.full((4, 1), 700, dtype=torch.int32, device=cuda_device)
    kv_pos = torch.arange(1024, dtype=torch.int32,
                          device=cuda_device)[None].repeat(4, 1)
    kv_pos[:, 701:] = -1
    full = L.dense_attention(q, k, v, q_pos, kv_pos)
    for n in (2, 3):
        part = L.dense_attention(q[:n], k[:n], v[:n], q_pos[:n], kv_pos[:n])
        assert torch.equal(part, full[:n]), n


def test_router_rows_do_not_depend_on_the_batch(cuda_device):
    """llama4-scout's router (f32 logits, d_model 5,120 onto 16 experts)
    gives a decode row the same gates and experts at 2, 3 and 4 rows,
    the slot counts its card cell decodes and re-slots at. One row is
    not claimed: the f32 product gave other bits at 1 row than at 8
    (ROADMAP C23)."""
    from repro_torch.configs import resolve_config
    from repro_torch.models import moe as MOE
    cfg = resolve_config("llama4-scout-17b-a16e-layers1")
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(4, 1, cfg.d_model, device=cuda_device,
                    generator=g).to(torch.bfloat16)
    w = torch.randn(cfg.d_model, cfg.n_experts, device=cuda_device,
                    generator=g) * cfg.d_model ** -0.5
    full = MOE.route(cfg, w, x)[:2]
    for n in (2, 3):
        for part, whole in zip(MOE.route(cfg, w, x[:n])[:2], full):
            assert torch.equal(part, whole[:n]), n


# --- the failure loop on the card ---------------------------------------------

def _served_tokens(out: str):
    return {int(line.split()[0][4:]): line.split("out=")[1]
            for line in out.splitlines() if line.startswith("  rid=")}


def test_supervised_shrink_reslots_onto_three_slots_on_the_card(
        cuda_device, tmp_path, capsys):
    """``repro_torch.launch.serve`` on the card by default: host 2 of 4
    dies, no spare, the supervisor shrinks the world and restores the
    live sessions onto 3 slots from 4 (each carries its checkpointed
    cache column), and every request keeps the uninterrupted run's
    tokens."""
    from repro_torch.launch import serve
    argv = ["--arch", "phi4-mini-3.8b-smoke", "--slots", "4", "--max-seq",
            "64", "--requests", "6", "--max-new", "12"]
    assert serve.main(argv) == 0
    want = _served_tokens(capsys.readouterr().out)
    assert serve.main(argv + ["--store", f"localfs:{tmp_path}",
                              "--supervise", "--hosts", "4", "--spares",
                              "0", "--kill-host", "2@4"]) == 0
    out = capsys.readouterr().out
    assert "shrink: dead=[2]" in out and "on 3 slots" in out
    assert len(want) == 6 and _served_tokens(out) == want


def test_one_row_decode_against_four_rows(cuda_device):
    """phi4-mini-3.8b-smoke decodes 10 steps for 4 rows together and for
    each row alone (bf16, the engine's decode step): each row's logits
    the same bits either way. A re-slot onto 1 slot is claimed
    token-identical only where this holds (ROADMAP C23)."""
    cfg = get_smoke_config("phi4-mini-3.8b")
    params = M.init_params(cfg, seed=0, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 10), dtype=torch.int32,
                         device=cuda_device, generator=g)
    four = M.init_cache(cfg, 4, 32, device=cuda_device)
    ones = [M.init_cache(cfg, 1, 32, device=cuda_device) for _ in range(4)]
    for t in range(10):
        pos = torch.full((4,), t, dtype=torch.int32, device=cuda_device)
        l4, four = M.decode_step(cfg, params, four, toks[:, t:t + 1], pos)
        for r in range(4):
            l1, ones[r] = M.decode_step(cfg, params, ones[r],
                                        toks[r:r + 1, t:t + 1], pos[:1])
            assert torch.equal(l1[0], l4[r]), (t, r)


def test_router_one_row_against_four_rows(cuda_device):
    """llama4-scout-17b-a16e-smoke's router (f32 logits) gives a row the
    same gates and experts alone as in a 4-row batch (ROADMAP C23)."""
    from repro_torch.models import moe as MOE
    cfg = get_smoke_config("llama4-scout-17b-a16e")
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(4, 1, cfg.d_model, device=cuda_device,
                    generator=g).to(torch.bfloat16)
    w = torch.randn(cfg.d_model, cfg.n_experts, device=cuda_device,
                    generator=g) * cfg.d_model ** -0.5
    full = MOE.route(cfg, w, x)[:2]
    for r in range(4):
        for part, whole in zip(MOE.route(cfg, w, x[r:r + 1])[:2], full):
            assert torch.equal(part, whole[r:r + 1]), r


# --- training over a device mesh: four ranks share the card (A9a) -------------

def _mesh_collectives_rank(rank, world):
    """DTensor's reshards on a (2, 2) mesh of the card through the
    collective shim, and the shim's gather onto rank 0, against the
    whole tensors they must give."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.parallel import collectives
    mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
    a = torch.arange(8 * 70000, dtype=torch.float32,
                     device="cuda").reshape(8, -1) % 977
    d = distribute_tensor(a, mesh, [Shard(0), Shard(1)], src_data_rank=None)
    ok = {"gather": torch.equal(d.full_tensor(), a)}
    p = DTensor.from_local(a + rank, mesh, [Partial(), Replicate()])
    ok["reduce_scatter"] = torch.equal(
        p.redistribute(mesh, [Shard(0), Replicate()]).full_tensor(),
        2 * a + (2 if rank in (0, 2) else 4))
    t = distribute_tensor(a, mesh, [Shard(0), Replicate()],
                          src_data_rank=None)
    ok["reshard"] = torch.equal(
        t.redistribute(mesh, [Shard(1), Replicate()]).full_tensor(), a)
    x = torch.full((5,), float(rank), device="cuda")
    y = torch.empty(5, device="cuda")
    collectives.send_recv(x, (rank + 1) % world, y, (rank - 1) % world)
    ok["ring"] = torch.equal(y, torch.full((5,), float((rank - 1) % world),
                                           device="cuda"))
    ok["staged"] = collectives.STATS["all_gather"]["staged"]
    whole = collectives.gather_to(d, 0)
    ok["gather_to"] = torch.equal(whole, a) if rank == 0 else whole is None
    return ok


def test_staged_collectives_on_the_card(cuda_device):
    from repro_torch.launch.mesh import spawn_ranks
    for r in spawn_ranks(_mesh_collectives_rank, 4, device="cuda"):
        assert all(r.values()), r


def _mesh_step_rank(rank, world):
    from repro_torch.configs import starcoder2_3b
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.train.loop import Trainer, TrainJob
    plain = starcoder2_3b.smoke_config
    starcoder2_3b.smoke_config = lambda: plain().replace(dtype="float32")
    torch.use_deterministic_algorithms(True)
    t = Trainer(TrainJob("starcoder2-3b-smoke", "train_s128_b4"), (2, 2),
                ("data", "model"))
    t.init_state()
    fa_ops.reset_counts()
    losses = [t.train_steps(1)["loss"] for _ in range(2)]
    return losses, t.params_digest(), fa_ops.counts("cuda")


def test_mesh_step_on_the_card_matches_one_device(cuda_device, monkeypatch):
    """starcoder2-3b-smoke in f32 on a (2, 2) mesh of four ranks on the
    card, through the flash kernels on each rank's local heads: its
    losses within 1e-5 of the one-device trainer's on the card."""
    import os
    from repro_torch.configs import starcoder2_3b
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.train.loop import Trainer, TrainJob
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") is None:
        pytest.skip("needs CUBLAS_WORKSPACE_CONFIG for deterministic steps")
    runs = spawn_ranks(_mesh_step_rank, 4, device="cuda")
    plain = starcoder2_3b.smoke_config
    monkeypatch.setattr(starcoder2_3b, "smoke_config",
                        lambda: plain().replace(dtype="float32"))
    t = Trainer(TrainJob("starcoder2-3b-smoke", "train_s128_b4"))
    t.init_state()
    want = [t.train_steps(1)["loss"] for _ in range(2)]
    assert len({r[1] for r in runs}) == 1
    for losses, _, counts in runs:
        np.testing.assert_allclose(losses, want, rtol=1e-5)
        assert counts["flash_fwd"] > 0 and counts["flash_dkv"] > 0


# --- serving over a device mesh: four ranks share the card (A9b step 1) ------

def _mesh_serve_rank(rank, world, store):
    """phi4-mini-3.8b-smoke served on a (2, 2) mesh of the card: a
    snapshot at step 6 (rank 0's session), the run to the end; then step
    6 restored onto a new (2, 2) mesh and run to the end."""
    from repro_torch.api import CheckpointSession, Policy
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import collectives
    arch = "phi4-mini-3.8b-smoke"
    params = M.init_params(get_smoke_config("phi4-mini-3.8b"), seed=3,
                           device="cuda")
    sess = CheckpointSession(f"localfs:{store}", Policy(
        chain=4, sparse_chunk_bytes=CB, sparse_min_bytes=2 * CB)) \
        if rank == 0 else None
    eng = ServingEngine.create(arch, params, (2, 2), n_slots=4, max_seq=64,
                               manager=sess and sess.manager)
    rng = np.random.RandomState(9)
    reqs = [Request(rid=i, prompt=rng.randint(0, 256, size=rng.randint(
        3, 14)).astype(np.int32), max_new=8) for i in range(6)]
    for r in reqs:
        eng.submit(r)
    logits, digest = {}, None
    while eng.queue or any(eng.slot_req):
        eng.step()
        logits[eng.steps] = eng.last_logits.cpu()
        if eng.steps == 6:
            eng.snapshot(block=True)
            digest = eng.cache_digest()
    if sess is not None:
        sess.close()
    torch.distributed.barrier()
    sess = CheckpointSession(f"localfs:{store}")
    back = sess.restore(6, params=params, mesh_factory=lambda: make_mesh(
        (2, 2), ("data", "model")))
    live, got = back.live_requests(), {"digest": back.cache_digest()}
    got["logits"] = {}
    while back.queue or any(back.slot_req):
        back.step()
        got["logits"][back.steps] = back.last_logits.cpu()
    got["tokens"] = {r.rid: list(r.out) for r in live}
    sess.close()
    return dict(tokens={r.rid: list(r.out) for r in reqs}, logits=logits,
                digest=digest, back=got,
                staged=collectives.STATS["all_reduce"]["staged"])


def test_mesh_serving_on_the_card_restores_bit_for_bit(cuda_device,
                                                       tmp_path):
    """Four ranks serve phi4-mini-3.8b-smoke on a (2, 2) mesh of the card
    through the collective shim; kill -> restore of step 6 onto (2, 2)
    gives the saved cache digest, every request's tokens and every later
    step's logits bit for bit, the same on every rank."""
    from repro_torch.launch.mesh import spawn_ranks
    runs = spawn_ranks(_mesh_serve_rank, 4, device="cuda",
                       args=(str(tmp_path),))
    r0 = runs[0]
    assert all(len(t) == 8 for t in r0["tokens"].values())
    for r in runs:
        assert r["staged"]
        assert r["tokens"] == r0["tokens"] and r["digest"] == r0["digest"]
        back = r["back"]
        assert back["digest"] == r0["digest"]
        assert back["tokens"] == r0["tokens"]
        for step, v in back["logits"].items():
            assert torch.equal(v, r0["logits"][step]), step


def _wrapper_calls(dev):
    """(label, inputs on ``dev``, call) of each kernel wrapper on a
    step's path, at small shapes."""
    from repro_torch.kernels.rg_lru import ops as rg
    from repro_torch.kernels.ssd_scan import ops as ssd
    g = torch.Generator(device="cpu").manual_seed(3)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype).to(dev)

    def flash(hd, dtype, H, Hkv):
        def call(q, k, v):
            out, lse = fa.flash_fwd(q, k, v, causal=True)
            delta = fa.attention_delta(out, out)
            return (out, lse, fa.flash_dq(q, k, v, out, lse, delta),
                    *fa.flash_dkv(q, k, v, out, lse, delta))
        return tuple(rnd(2, h, 200, hd, dtype=dtype)
                     for h in (H, Hkv, Hkv)), call

    def ssd_call(x, dt, A, Bm, Cm):
        y, final, states = ssd.ssd_fwd(x, dt, A, Bm, Cm, 256)
        return (y, final, states,
                *ssd.ssd_bwd(x, dt, A, Bm, Cm, states, y, None, 256))

    def rg_call(x, r, i, lam):
        h = rg.rg_lru_fwd(x, r, i, lam)
        return (h, *rg.rg_lru_bwd(x, r, i, lam, h, h))
    ssd_in = (rnd(2, 512, 4, 32, dtype=torch.bfloat16), rnd(2, 512, 4).abs(),
              -rnd(4).abs(), rnd(2, 512, 64, dtype=torch.bfloat16),
              rnd(2, 512, 64, dtype=torch.bfloat16))
    rg_in = (rnd(2, 600, 64), rnd(2, 600, 64), rnd(2, 600, 64), rnd(64))
    return [("flash bf16 hd 64", *flash(64, torch.bfloat16, 4, 2)),
            ("flash bf16 hd 256", *flash(256, torch.bfloat16, 2, 1)),
            ("flash f32 hd 32", *flash(32, torch.float32, 2, 2)),
            ("ssd bf16", ssd_in, ssd_call), ("rg_lru", rg_in, rg_call)]


@pytest.mark.parametrize("case", range(5))
def test_fake_route_allocates_what_the_cuda_route_does(cuda_device, case):
    """The dry run's fake route (fake CUDA tensors) against the card: the
    same outputs' shapes and dtypes, and the analyzer's peak of the
    call's temporaries within the caching allocator's rounding of the
    card's (512 bytes a block) — the scratch each wrapper allocates."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.hlo_analysis import Analyzer
    label, inputs, call = _wrapper_calls(cuda_device)[case]
    call(*inputs)                             # build, cuBLAS workspaces
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    real = call(*inputs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    with FakeTensorMode() as mode:
        fake_in = [mode.from_tensor(t) for t in inputs]
        a = Analyzer()
        with a:
            fake = call(*fake_in)
    assert [(tuple(t.shape), t.dtype) for t in fake] == \
        [(tuple(t.shape), t.dtype) for t in real], label
    assert all(t.is_cuda for t in fake), label
    assert abs(peak - a.temp_bytes) <= 512 * 64, (label, peak, a.temp_bytes)


@pytest.mark.parametrize("S", [1, 255, 256, 257, 4096, 32768])
def test_rg_lru_fake_route_counts_the_library_chunks(cuda_device, S):
    from repro_torch.kernels.rg_lru import ops as rg
    assert rg._chunks("fake", S) == rg._chunks("cuda", S)
