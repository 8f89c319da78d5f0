#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.

    python3 chip_smoke.py        # from the repository root

Phases, each reported on its own line:

1. the card: ``nvidia-smi --query-gpu=name,power.limit`` verbatim;
2. the nvcc builds of ``src/repro_torch/csrc/*.cu`` into ``build/``, one
   nvcc per source, all started together;
3. each checkpoint-codec kernel (fingerprint, fused capture, XOR) held
   bit for bit against its plain PyTorch version on the card, at the
   serving path's shapes, with its time, its bound and the plain
   version's time (and ``torch.bitwise_xor``'s for the XOR); then the
   int8 codec's quantize and dequantize, bit for bit against their plain
   versions (and the numpy oracle on the smaller cases) at mamba2-780m's
   largest moment leaf ``[50280, 1536]`` f32, a ragged size, zero
   blocks, blocks of amax 127 with exact ties, and values drawn as
   AdamW's nu makes them, with their times at the large leaf (and
   ``torch.mul(q, scale[:, None])``'s for dequantize);
4. each flash-attention kernel (forward, dq, dk/dv) held against its
   plain PyTorch version at the training shape in bf16 and at a ragged
   shape with a window in f32 and in bf16, with its time, its bound, the
   plain version's time and ``scaled_dot_product_attention``'s (forward; its
   autograd backward for dq and dk/dv together); then each SSD kernel
   (the chunked scan's forward and its gradient) against its plain
   version at mamba2-780m's training shape in bf16 and at a ragged f32
   shape with an initial state, with limits set from the plain version's
   own spread between two chunk lengths, its time, its bound and the
   plain version's time (no single PyTorch call computes an SSD scan);
   then the RG-LRU kernel against its plain version at the prefill shape
   (x, r, i ``[2, 32768, 4096]`` f32 drawn as a fresh block makes them,
   ``rg_lru/ref.model_inputs``) from a zero and from a random state, and
   at a ragged shape with a state, every element within 1e-4 * (|plain|
   + rms(plain)), with its time, its bound and the plain version's time;
5. the serving path: phi4-mini-3.8b at full width and depth (bf16
   params from seeded ``torch.Generator``s) serves 6 requests on 4
   slots under a ``CheckpointSession`` with chained snapshots, is
   killed about half way, comes back through ``restore("latest")`` and
   must finish every request token for token as the uninterrupted run
   did — once with sparse capture on, once with ``sparse=False``. Every
   codec kernel must have launched, and no flash kernel (serving never
   takes the training route);
6. the hybrid path: recurrentgemma-9b-smoke in f32, card against CPU —
   a prefill past the attention window and greedy decode steps (logits
   and every cache leaf, the unstacked remainder blocks' too, within
   1e-5; the same tokens), then the engine's tokens on both devices;
   recurrentgemma-9b at full width and depth (8,524,206,080 bf16 params
   from seeded generators) prefills ``prefill_s32768_b2`` (PREFILL_32K's
   length, batch cut from 32 to 2) through the registered
   ``prefill_step``, profiled, launching the RG-LRU kernel exactly once
   per recurrent layer (26) and no other kernel; for each serving prompt
   a batch-1 prefill (the kernel) against the engine's replay admission
   (batch-1 decode steps) in f32, logits and every RG-LRU state within
   1e-4 in the 2-norm; then 6 requests of 32-96 tokens on 4 slots, 24
   new tokens each, under ``Policy(interval=4, chain=4)`` with sparse
   capture, killed while the first wave is in flight, restored through
   ``restore("latest")``: every request token for token as the
   uninterrupted run, the capture kernels launched, no flash, SSD or
   RG-LRU kernel during decode or replay;
7. the training paths, one per cell of ``TRAIN_CELLS``: one f32 step of
   the smoke model on the card matches the same step on the CPU; then
   the model at full width (and depth, unless the cell cuts it) trains
   8 steps under a
   ``CheckpointSession`` (one full snapshot, after step 6), is dropped,
   comes back through ``restore("latest")`` at step 6 and trains 2
   steps: the losses of steps 7-8 and the digest of params, optimizer
   state, step and data cursor must equal the uninterrupted run's bit
   for bit, and the cell's kernels must have launched once per layer
   and step (the forward twice, under remat). starcoder2-3b, its depth
   cut to 15 of 30 layers (``starcoder2-3b-layers15``), trains on 2 x
   4096 tokens a step through the flash kernels (a 15.9 GB snapshot),
   mamba2-780m at full depth on 8 x 4096 through the SSD kernels (7.8
   GB);
8. the codec phase, from mamba2-780m's restored trainer (``codec_path``):
   one snapshot under ``codecs={"opt_state": "int8"}`` into a
   ``sharded:`` store of 4 virtual hosts (quantize on the card, only the
   codes cross), two more steps while it encodes, drop,
   ``restore("latest")`` (dequantize on the card) and 2 steps; the
   manifest's codec leaves must carry the blobs of the plain version's
   codes, the restored moments must be its dequantize(quantize(m)) bit
   for bit, params, step and cursor bit-identical, and each kernel must
   have launched once per codec leaf with no plain or host codec call.
   Every phase logs the run's running total of snapshot bytes written.

Before the last line it prints ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without that line; so does a machine with no CUDA device.
"""
from __future__ import annotations

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# cuBLAS picks deterministic reductions only with a fixed workspace
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
CUDA_CORE_OPS_PER_S = 67e12     # H100 SXM peak outside the tensor cores
BF16_OPS_PER_S = 989e12         # H100 SXM dense bf16 tensor-core peak
ARCH = "phi4-mini-3.8b"
N_SLOTS, MAX_SEQ, N_REQ, MAX_NEW = 4, 1024, 6, 48
TRAIN_STEPS = 8
# the training cells, each at full width (and full depth unless ``layers``
# cuts it, as ``configs.registry.resolve_config`` spells it): the model,
# its shape (the published 4,096-token length at a batch cut from 256 to
# what one card steps without accumulation), the kernel module whose
# kernels the step runs, and the shape and mode of the f32 smoke step
# held against the CPU (check_train_reference)
TRAIN_CELLS = (
    dict(arch="starcoder2-3b", shape="train_s4096_b2", kernels="flash",
         reference_shape="train_s192_b2",         # 3 q tiles, ragged-free
         reference="state",
         # depth cut from 30: its snapshot's one-thread encode took 337-413
         # s of the run's 1,200 (the time limit; mamba2-780m keeps its
         # depth, the codec phase runs on it)
         layers=15),
    dict(arch="mamba2-780m", shape="train_s4096_b8", kernels="ssd",
         reference_shape="train_s512_b2",         # 2 chunks of 256
         reference="grads", codec=True),
)
# one full snapshot, after step 6, with no chain (so no dirty-chunk
# capture either): snapshots of the two training states are 15.9 and
# 7.8 GB (30.3 for starcoder2-3b at full depth) and the card's machine
# accepts 45 GiB of disk writes per run (deleted files count), so a
# chain's link at full depth cannot be written there; training links run
# at smoke size in the tests instead
TRAIN_POLICY = dict(interval=6, chain=1, keep_last=1)


_T0 = time.monotonic()
# bytes the snapshot pipelines of this run wrote (blob payloads, as
# their stats count them): the card's machine accepts 45 GiB of disk
# writes per run, deleted files included
_WRITTEN = {"bytes": 0}


def count_written(stats) -> str:
    """Add a session's blob bytes to the run's total, and say it."""
    _WRITTEN["bytes"] += int(stats["bytes_written"])
    return f"disk writes so far {_WRITTEN['bytes'] / 1e9:.2f} GB of blobs"


def log(msg: str) -> None:
    print(f"[{time.monotonic() - _T0:7.1f} s] {msg}", flush=True)


# GPU cycles to spin before each timed call: the card waits while the
# host enqueues the call behind it, so the two events bracket device
# work only, not the host's Python and launch overhead (~20 ms at the
# H100's clock, more than any call here takes to enqueue)
_SPIN_CYCLES = 40_000_000


def time_ms(fn, iters: int, flush) -> float:
    """Median device time of ``fn`` from CUDA events, one call per
    measurement with the L2 cache flushed before each (the main path
    finds its inputs cold)."""
    import torch
    fn()
    times = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(_SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound_ms(nbytes: int, ops: int, ops_per_s: float = CUDA_CORE_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def check_kernels(torch, ops, ref):
    """Phase 3: every kernel against its plain version on the card."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    l2 = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    flush = l2.zero_
    cb = ref.FP_CHUNK_BYTES
    # one KV-cache leaf of the main path: [L, slots, max_seq, kv, hd] bf16
    leaf = torch.randn((32, N_SLOTS, MAX_SEQ, 8, 128), generator=gen,
                       device=dev).to(torch.bfloat16)
    u8 = ops._u8(leaf)
    n = u8.numel()
    n_chunks = n // cb
    out = {}

    fp = ops.fingerprint_blocks(leaf, cb)
    fp_plain = ops.fingerprint_plain(u8, cb)
    host_fp = ref.fingerprint_ref(u8.cpu().numpy(), cb).view("int32")
    if not (torch.equal(fp, fp_plain)
            and (fp.cpu().numpy() == host_fp).all()):
        raise AssertionError("fingerprint kernel disagrees with its plain "
                             "version / the numpy oracle")
    b, o = bound_ms(n + 2 * fp.numel() * 4, 8 * (n // 4))
    out["fingerprint"] = dict(
        name="fingerprint", route="cuda",
        source="src/repro_torch/csrc/ckpt_codec.cu",
        replaces="src/repro/kernels/ckpt_codec/kernel.py:101",
        max_abs_err=0,
        ms=time_ms(lambda: ops.fingerprint_blocks(leaf, cb), 20, flush),
        plain_ms=time_ms(lambda: ops.fingerprint_plain(u8, cb), 3, flush),
        bound_ms=b, bound_by=o, library_ms=None)
    log(f"kernel fingerprint: bit-exact vs plain and numpy oracle on "
        f"{tuple(leaf.shape)} bf16 ({n} B, {n_chunks} chunks)")

    timed = None
    for label, n_dirty, hint in (("all-clean", 0, None),
                                 ("within-capacity", 10, 8),
                                 ("overflow", 200, 256)):
        prev = fp.clone()
        if n_dirty:
            sel = torch.randperm(n_chunks, generator=gen, device=dev)[:n_dirty]
            prev[sel, 1] ^= 1
        cap = ops.fused_capacity(n_chunks, cb, hint)
        got = ops.fused_capture_blocks(leaf, prev, cb, cap)
        want = ops.fused_capture_plain(u8, prev, cb, cap)
        kg, ig, cg = ops.fused_unpack(got[1].cpu().numpy(), cap, cb)
        kw, iw, cw = ops.fused_unpack(want[1].cpu().numpy(), cap, cb)
        m = min(kw, cap)
        if not (torch.equal(got[0], want[0]) and kg == kw == n_dirty
                and (ig[:m] == iw[:m]).all() and (cg[:m] == cw[:m]).all()):
            raise AssertionError(f"fused capture kernel disagrees with its "
                                 f"plain version ({label})")
        log(f"kernel fused_capture ({label}): bit-exact vs plain; "
            f"{n_dirty} dirty, capacity {cap}, "
            f"{'overflow' if kw > cap else 'fits'}")
        if label == "overflow":   # what most main-path links look like
            kept = min(kw, cap)
            timed = dict(
                ms=time_ms(lambda: ops.fused_capture_blocks(leaf, prev, cb,
                                                            cap), 20, flush),
                plain_ms=time_ms(lambda: ops.fused_capture_plain(
                    u8, prev, cb, cap), 3, flush),
                nbytes=n + 3 * n_chunks * 8 + 4 * (1 + cap) + kept * cb)
    b, o = bound_ms(timed["nbytes"], 9 * (n // 4))
    out["fused_capture"] = dict(
        name="fused_capture", route="cuda",
        source="src/repro_torch/csrc/ckpt_codec.cu",
        replaces="src/repro/kernels/ckpt_codec/kernel.py:160",
        max_abs_err=0, ms=timed["ms"], plain_ms=timed["plain_ms"],
        bound_ms=b, bound_by=o, library_ms=None)

    # the XOR runs on the delta codec's 4 MiB chunk views
    from repro_torch.core.delta import CHUNK_BYTES
    xa = u8[:CHUNK_BYTES].clone()
    xb = u8[CHUNK_BYTES:2 * CHUNK_BYTES].clone()
    if not torch.equal(ops.xor_blocks(xa, xb), ops.xor_plain(xa, xb)):
        raise AssertionError("XOR kernel disagrees with its plain version")
    b, o = bound_ms(3 * CHUNK_BYTES, CHUNK_BYTES // 16)
    out["xor"] = dict(
        name="xor", route="cuda",
        source="src/repro_torch/csrc/ckpt_codec.cu",
        replaces="src/repro/kernels/ckpt_codec/kernel.py:65",
        max_abs_err=0,
        ms=time_ms(lambda: ops.xor_blocks(xa, xb), 50, flush),
        plain_ms=time_ms(lambda: ops.xor_plain(xa, xb), 50, flush),
        bound_ms=b, bound_by=o,
        library_ms=time_ms(lambda: torch.bitwise_xor(xa, xb), 50, flush))
    log(f"kernel xor: bit-exact vs plain on two {CHUNK_BYTES} B views")
    for k in out.values():
        log(f"timing {k['name']}: {k['ms']:.4f} ms (bound {k['bound_ms']:.4f}"
            f" ms by {k['bound_by']}), plain {k['plain_ms']:.4f} ms, "
            f"library {k['library_ms']}")
    del leaf, u8, l2
    torch.cuda.empty_cache()
    return out


# the largest opt_state leaf of mamba2-780m: the embedding's moment
CODEC_LEAF_SHAPE = (50280, 1536)


def _codec_cases(torch, gen, dev):
    """(label, float tensor on the card) for the int8 codec kernels."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    ragged = rnd(1000 * 1001 + 5)       # nb = 3911: no tile of 8 divides it
    zeros = torch.zeros(64 * 256 + 100, device=dev)
    zeros[4096:4352] = rnd(256)          # one live block among zero blocks
    ties = torch.zeros(8 * 256, device=dev)
    ties[::256] = 127.0                  # amax 127 exactly: scale 1.0
    vals = torch.tensor([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 3.5, -3.5, 126.5],
                        device=dev)
    for b in range(8):
        ties[b * 256 + 1:b * 256 + 10] = (vals + 2 * b).clamp(-126.5,
                                                              126.5)
    u = torch.rand((4_000_003,), generator=gen, device=dev)
    nu = torch.exp(math.log(1e-14) + u * (math.log(1e-6) - math.log(1e-14)))
    return [("mamba2-780m embedding moment", rnd(*CODEC_LEAF_SHAPE) * 1e-3),
            ("ragged", ragged), ("zero blocks", zeros),
            ("amax 127 with exact ties", ties), ("AdamW nu", nu),
            ("float16", rnd(100_000).half() * 10),
            ("float64", rnd(100_001).double())]


def check_codec(torch, ops, ref):
    """The int8 codec kernels against their plain versions on the card,
    bit for bit, in every case of ``_codec_cases`` (and against the
    numpy oracle on the smaller ones); then their times at the largest
    opt_state leaf of mamba2-780m. What a block holding a NaN gives is
    logged, not held (ROADMAP C15)."""
    import numpy as np
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    l2 = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    flush = l2.zero_
    cases = _codec_cases(torch, gen, dev)
    for label, x in cases:
        q, scale = ops.quantize(x)
        qp, sp = ops.quantize_plain(x)
        d = ops.dequantize(q, scale)
        dp = ops.dequantize_plain(qp, sp)
        torch.cuda.synchronize()
        same = (torch.equal(q, qp)
                and torch.equal(scale.view(torch.int32), sp.view(torch.int32))
                and torch.equal(d.view(torch.int32), dp.view(torch.int32)))
        oracle = "not run (the plain version is held to it on the CPU)"
        if x.numel() < 10_000_000:
            qr, sr = ref.quantize_ref(x.cpu().numpy())
            same = same and (q.cpu().numpy() == qr).all() \
                and scale.cpu().numpy().tobytes() == sr.tobytes() \
                and d.cpu().numpy().tobytes() == \
                ref.dequantize_ref(qr, sr).tobytes()
            oracle = "bit-exact"
        if not same:
            raise AssertionError(f"codec kernels disagree with their plain "
                                 f"versions ({label})")
        log(f"kernel quantize/dequantize ({label}): {tuple(x.shape)} "
            f"{str(x.dtype)[6:]}, {q.shape[0]} blocks: q, scale and the "
            f"dequantized values bit-exact vs plain; numpy oracle {oracle}")
    nan = torch.ones(512, device=dev)
    nan[3] = float("nan")
    (qk, sk), (qp, sp) = ops.quantize(nan), ops.quantize_plain(nan)
    log(f"codec with a NaN in block 0 (not held): kernel scale "
        f"{sk[0].item()!r}, codes {sorted(set(qk[0].tolist()))}; plain "
        f"scale {sp[0].item()!r}, codes {sorted(set(qp[0].tolist()))}")
    x = cases[0][1]
    n = x.numel()
    nb = n // 256
    q, scale = ops.quantize(x)
    out = {}
    b, o = bound_ms(4 * n + n + 4 * nb, 7 * n)
    out["quantize"] = dict(
        name="quantize", route="cuda",
        source="src/repro_torch/csrc/ckpt_codec.cu",
        replaces="src/repro/kernels/ckpt_codec/kernel.py:38", max_abs_err=0,
        ms=time_ms(lambda: ops.quantize(x), 20, flush),
        plain_ms=time_ms(lambda: ops.quantize_plain(x), 3, flush),
        bound_ms=b, bound_by=o, library_ms=None)
    b, o = bound_ms(n + 4 * nb + 4 * n, 2 * n)
    out["dequantize"] = dict(
        name="dequantize", route="cuda",
        source="src/repro_torch/csrc/ckpt_codec.cu",
        replaces="src/repro/kernels/ckpt_codec/kernel.py:214", max_abs_err=0,
        ms=time_ms(lambda: ops.dequantize(q, scale), 20, flush),
        plain_ms=time_ms(lambda: ops.dequantize_plain(q, scale), 3, flush),
        bound_ms=b, bound_by=o,
        library_ms=time_ms(lambda: torch.mul(q, scale[:, None]), 20, flush))
    for k in out.values():
        log(f"timing {k['name']}: {k['ms']:.4f} ms (bound {k['bound_ms']:.4f}"
            f" ms by {k['bound_by']}, {tuple(x.shape)} f32 = "
            f"{4 * n / 1e6:.1f} MB), plain {k['plain_ms']:.4f} ms, library "
            f"{k['library_ms']}")
    del cases, x, q, scale, l2
    torch.cuda.empty_cache()
    return out


def attended_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave visible — the work the
    attention kernels must do for these inputs."""
    import numpy as np
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i + 1, skv) if causal else np.full(sq, skv)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(sq,
                                                                   np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def check_flash(torch, fa):
    """Phase 4: each flash kernel against its plain version on the card,
    at the training shape (bf16) and at a ragged shape with a window in
    f32 (the CUDA-core kernels) and in bf16 (the tensor-core ones)."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    l2 = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    flush = l2.zero_
    out = {}
    # each output, elementwise: |kernel - plain| <= rtol * |plain| + atol.
    # bf16: both versions sum in f32 and round to bf16 once, so they may
    # differ by one bf16 ulp, at most 2^-7 of the value (rtol 1e-2), and
    # by the order of the f32 sums (atol 1e-5, ~1/3000 of a typical
    # forward or dq value at the training shape). f32: the order only.
    # The LSE is f32 in both cases.
    tols = {torch.bfloat16: (1e-2, 1e-5), torch.float32: (1e-4, 1e-5)}
    lse_tol = (0.0, 1e-4)
    parts = {"flash_fwd": ("out", "lse"), "flash_dq": ("dq",),
             "flash_dkv": ("dk", "dv")}
    cases = [("training", torch.bfloat16, 2, 24, 2, 4096, 128, 0),
             ("ragged", torch.float32, 1, 4, 2, 1000, 128, 64),
             ("ragged bf16", torch.bfloat16, 1, 4, 2, 1000, 128, 64)]
    for label, dt, B, H, Hkv, S, hd, window in cases:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dt)
        q, k, v, do = rnd(B, H, S, hd), rnd(B, Hkv, S, hd), \
            rnd(B, Hkv, S, hd), rnd(B, H, S, hd)
        kw = dict(causal=True, window=window)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, **kw)
        delta = fa.attention_delta(o_p, do)
        got = {"flash_fwd": (o, lse),
               "flash_dq": (fa.flash_dq(q, k, v, do, lse_p, delta, **kw),),
               "flash_dkv": fa.flash_dkv(q, k, v, do, lse_p, delta, **kw)}
        want = {"flash_fwd": (o_p, lse_p),
                "flash_dq": (fa.flash_dq_plain(q, k, v, do, lse_p, delta,
                                               **kw),),
                "flash_dkv": fa.flash_dkv_plain(q, k, v, do, lse_p, delta,
                                                **kw)}
        torch.cuda.synchronize()
        errs, readings, bad = {}, [], []
        for name in fa.KERNELS:
            errs[name] = 0.0
            for part, a, b in zip(parts[name], got[name], want[name]):
                rtol, atol = lse_tol if part == "lse" else tols[dt]
                a, b = a.float(), b.float()
                err = (a - b).abs()
                # the worst element's error as a share of its limit
                share = float((err / (atol + rtol * b.abs())).max())
                errs[name] = max(errs[name], float(err.max()))
                readings.append(
                    f"{part} {float(err.max()):.2e} (rms of the plain "
                    f"{float(b.square().mean().sqrt()):.2e}, rtol {rtol:g} "
                    f"atol {atol:g}, worst element {share:.2f} of its limit)")
                if share > 1:
                    bad.append(f"{name} ({part})")
        log(f"kernel flash ({label}): q {(B, H, S, hd)} k/v "
            f"{(B, Hkv, S, hd)} {str(dt)[6:]} causal window {window}: fwd, "
            f"dq, dk/dv against the plain versions, max abs err "
            + "; ".join(readings))
        if bad:
            raise AssertionError(f"{label}: kernels disagree with their "
                                 f"plain versions past the limit: {bad}")
        if label != "training":
            continue
        pairs = B * H * attended_pairs(S, S, True, window)
        esz = q.element_size()
        qb, kvb, st = q.numel() * esz, k.numel() * esz, B * H * S * 4
        work = {"flash_fwd": (2 * qb + 2 * kvb + st, 2 * 2 * hd * pairs),
                "flash_dq": (3 * qb + 2 * kvb + 2 * st, 3 * 2 * hd * pairs),
                "flash_dkv": (2 * qb + 4 * kvb + 2 * st, 4 * 2 * hd * pairs)}
        calls = {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v, **kw),
                          lambda: fa.flash_fwd_plain(q, k, v, **kw)),
            "flash_dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta, **kw),
                         lambda: fa.flash_dq_plain(q, k, v, do, lse, delta,
                                                   **kw)),
            "flash_dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta, **kw),
                          lambda: fa.flash_dkv_plain(q, k, v, do, lse, delta,
                                                     **kw))}
        qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                                  enable_gqa=True)
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 10, flush)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            sdpa_out, (qr, kr, vr), do, retain_graph=True), 10, flush)
        for name in fa.KERNELS:
            nbytes, ops_n = work[name]
            b, o_by = bound_ms(nbytes, ops_n, BF16_OPS_PER_S)
            out[name] = dict(
                name=name, route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces={"flash_fwd": "src/repro/kernels/flash_attention/"
                                       "kernel.py:86",
                          "flash_dq": "src/repro/kernels/flash_attention/"
                                      "backward.py:161",
                          "flash_dkv": "src/repro/kernels/flash_attention/"
                                       "backward.py:185"}[name],
                max_abs_err=errs[name],
                ms=time_ms(calls[name][0], 5, flush),
                plain_ms=time_ms(calls[name][1], 2, flush),
                bound_ms=b, bound_by=o_by,
                library_ms=lib_fwd if name == "flash_fwd" else lib_bwd)
            log(f"timing {name}: {out[name]['ms']:.4f} ms (bound "
                f"{b:.4f} ms by {o_by}, {ops_n / 1e9:.1f} GFLOP), plain "
                f"{out[name]['plain_ms']:.4f} ms, library "
                f"{out[name]['library_ms']:.4f} ms")
        del qr, kr, vr, sdpa_out
    del l2
    torch.cuda.empty_cache()
    return out


SSD_TRAIN_SHAPE = (8, 4096, 48, 64, 128, 256)   # B, S, H, P, N, chunk


def ssd_work(B, S, H, P, N, q, esz):
    """(bytes, operations) of ssd_fwd and ssd_bwd on these shapes: each
    input read once and each output written once, and the products of
    the model's chunk-q algorithm as the reference does them (C.B^T for
    every head) over the causal pairs j <= i only, as ``attended_pairs``
    counts flash attention's. The forward's outputs include the
    chunk-start states it writes for the backward, which reads them: the
    path's forward cannot skip them. The backward takes the gradient of
    each product with respect to both its operands, twice the forward."""
    blocks = B * H * (S // q)
    pairs = q * (q + 1) // 2
    fwd_ops = blocks * (2 * pairs * (N + P) + 4 * q * P * N)
    x, bc = B * S * H * P * esz, 2 * B * S * N * esz
    small = B * S * H * 4 + H * 4                  # dt, A
    y, state = B * S * H * P * 4, B * H * P * N * 4
    states = state * (S // q)
    fwd_bytes = x + bc + small + y + state + states
    bwd_bytes = (x + bc + small + states + y) + (x + bc + small)
    return {"ssd_fwd": (fwd_bytes, fwd_ops),
            "ssd_bwd": (bwd_bytes, 2 * fwd_ops)}


def check_ssd(torch, ssd, R):
    """Each SSD kernel against its plain version on the card: the
    training shape (bf16 x, B, C; chunk 256) and a ragged f32 shape with
    an initial state (S = 300, chunk = S, the model's rule). Each
    output's limit is elementwise rtol * (|plain| + rms(plain)), with
    rtol = max(4 x the spread between the plain version at the chunk and
    at a quarter of it, 1e-4) — the same math blocked differently. dt
    and A are drawn as a freshly initialised block makes them
    (``model_dt_A``): the slow heads decay by O(1) over a chunk and
    across chunks, so a wrong far tile or state carry shows."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    l2 = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    flush = l2.zero_
    out = {}
    parts = {"ssd_fwd": ("y", "final"),
             "ssd_bwd": ("dx", "ddt", "dA", "dB", "dC")}
    cases = [("training", torch.bfloat16, SSD_TRAIN_SHAPE, False),
             ("ragged", torch.float32, (2, 300, 8, 64, 128, 300), True)]
    for label, dt_, (B, S, H, P, N, q), init in cases:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        x, Bm, Cm = rnd(B, S, H, P).to(dt_), rnd(B, S, N).to(dt_), \
            rnd(B, S, N).to(dt_)
        dt, A = R.model_dt_A(B, S, H, gen, dev)
        s0 = rnd(B, H, P, N) if init else None
        dy = rnd(B, S, H, P)
        y, fin, states = ssd.ssd_fwd(x, dt, A, Bm, Cm, q, s0)
        grads = ssd.ssd_bwd(x, dt, A, Bm, Cm, states, dy, None, q)
        got = {"ssd_fwd": (y, fin), "ssd_bwd": grads}
        want = {"ssd_fwd": R.ssd_chunked_plain(x, dt, A, Bm, Cm, q, s0),
                "ssd_bwd": R.ssd_grads_plain(x, dt, A, Bm, Cm, dy, q,
                                             init_state=s0)}
        qa = q // 4
        alt = {"ssd_fwd": R.ssd_chunked_plain(x, dt, A, Bm, Cm, qa, s0),
               "ssd_bwd": R.ssd_grads_plain(x, dt, A, Bm, Cm, dy, qa,
                                            init_state=s0)}
        torch.cuda.synchronize()
        errs, readings, bad = {}, [], []
        for name in ssd.KERNELS:
            errs[name] = 0.0
            spreads = R.blocking_spread(want[name], alt[name])
            for part, a, b, spread in zip(parts[name], got[name], want[name],
                                          spreads):
                rtol = R.tolerance(spread)
                share = R.within(a, b, rtol)
                err = float((a.float() - b.float()).abs().max())
                errs[name] = max(errs[name], err)
                readings.append(
                    f"{part} {err:.2e} (rms of the plain "
                    f"{float(b.float().square().mean().sqrt()):.2e}, spread "
                    f"chunk {q} vs {qa} {spread:.2e}, rtol {rtol:.2e}, worst "
                    f"element {share:.2f} of its limit)")
                if not share <= 1.0:
                    bad.append(f"{name} ({part})")
        log(f"kernel ssd ({label}): x {(B, S, H, P)} B/C {(B, S, N)} "
            f"{str(dt_)[6:]} chunk {q}{' with init_state' if init else ''}: "
            "fwd, bwd against the plain versions, max abs err "
            + "; ".join(readings))
        if bad:
            raise AssertionError(f"{label}: SSD kernels disagree with their "
                                 f"plain versions past the limit: {bad}")
        if label != "training":
            continue
        work = ssd_work(B, S, H, P, N, q, x.element_size())
        calls = {
            "ssd_fwd": (lambda: ssd.ssd_fwd(x, dt, A, Bm, Cm, q),
                        lambda: R.ssd_fwd_plain(x, dt, A, Bm, Cm, q)),
            "ssd_bwd": (lambda: ssd.ssd_bwd(x, dt, A, Bm, Cm, states, dy,
                                            None, q),
                        lambda: R.ssd_grads_plain(x, dt, A, Bm, Cm, dy, q))}
        for name in ssd.KERNELS:
            nbytes, ops_n = work[name]
            b, o_by = bound_ms(nbytes, ops_n, BF16_OPS_PER_S)
            out[name] = dict(
                name=name, route="cuda",
                source="src/repro_torch/csrc/ssd_scan.cu",
                replaces={"ssd_fwd": "src/repro/kernels/ssd_scan/kernel.py:66",
                          "ssd_bwd": "src/repro/models/ssm.py:87"}[name],
                max_abs_err=errs[name],
                ms=time_ms(calls[name][0], 5, flush),
                plain_ms=time_ms(calls[name][1], 2, flush),
                bound_ms=b, bound_by=o_by, library_ms=None)
            log(f"timing {name}: {out[name]['ms']:.4f} ms (bound {b:.4f} ms "
                f"by {o_by}: {nbytes / 1e9:.3f} GB, {ops_n / 1e9:.1f} GFLOP),"
                f" plain {out[name]['plain_ms']:.4f} ms, library none (no "
                "single PyTorch call computes an SSD scan)")
        del x, Bm, Cm, dt, dy, states, grads, want, alt, got
    del l2
    torch.cuda.empty_cache()
    return out


RGLRU_PREFILL_SHAPE = (2, 32768, 4096)      # B, S, W: prefill_s32768_b2
RGLRU_RTOL = 1e-4                           # ROADMAP B8
# the rglru_a init's range moved next to 1: decays ~0.99995-0.999998 a
# token, where 1 - a^2 in f32 keeps under two digits (the gate's expm1)
NEAR_ONE = (0.99999, 0.999999)


def check_rglru(torch, rg, R, within):
    """The RG-LRU kernel against its plain version on the card, with x,
    r, i and lam drawn as a fresh block makes them (``model_inputs``:
    decays 0.66-0.996 a token, so a dropped carry shows): at the prefill
    shape from a zero state and from a random one, and at a ragged shape
    with a state, once at the init's decays and once at decays near one.
    Every element within RGLRU_RTOL * (|plain| + rms(plain)); then its
    time, its bound and the plain version's."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    l2 = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    flush = l2.zero_
    B, S, W = RGLRU_PREFILL_SHAPE
    big = R.model_inputs(B, S, W, gen, dev)
    ragged = R.model_inputs(3, 1000, 1000, gen, dev)
    slow = R.model_inputs(3, 1000, 1000, gen, dev, u_range=NEAR_ONE)
    h0 = torch.randn((3, 1000), generator=gen, device=dev)
    cases = [("prefill, h0 = 0", big, None),
             ("prefill, random h0", big,
              torch.randn((B, W), generator=gen, device=dev)),
             ("ragged, random h0", ragged, h0),
             ("ragged, decays near one, random h0", slow, h0)]
    worst_err = 0.0
    for label, ins, h0 in cases:
        got = rg.rg_lru_fwd(*ins, h0)
        want = R.rg_lru_plain(*ins, h0)
        torch.cuda.synchronize()
        share = within(got, want, RGLRU_RTOL)
        err = float((got - want).abs().max())
        worst_err = max(worst_err, err)
        a = torch.exp(R.gates(ins[1], ins[3])[0])
        lo, hi = float(a.min()), float(a.max())
        del a
        log(f"kernel rg_lru ({label}): x/r/i {tuple(ins[0].shape)} f32, "
            f"decays {lo:.6f}-{hi:.6f} a token: max abs err {err:.2e} (rms "
            f"of the plain "
            f"{float(want.square().mean().sqrt()):.2e}), worst element "
            f"{share:.3f} of its limit {RGLRU_RTOL:g} * (|plain| + rms)")
        if not share <= 1.0:
            raise AssertionError(f"rg_lru_fwd ({label}) disagrees with its "
                                 f"plain version: {share:.2f} of the limit")
        del got, want
    x, r, i, lam = big
    n = x.numel()
    # x, r, i read and h written once (lam is W floats); ~10 operations
    # an element: the gate's product, exp, expm1, sqrt, i * x, two
    # multiplies and the FMA of the carry
    nbytes, ops_n = 16 * n + 4 * W, 10 * n
    b, o = bound_ms(nbytes, ops_n)
    out = dict(name="rg_lru_fwd", route="cuda",
               source="src/repro_torch/csrc/rg_lru.cu",
               replaces="src/repro/kernels/rg_lru/kernel.py:55",
               max_abs_err=worst_err,
               ms=time_ms(lambda: rg.rg_lru_fwd(x, r, i, lam), 10, flush),
               plain_ms=time_ms(lambda: R.rg_lru_plain(x, r, i, lam), 2,
                                flush),
               bound_ms=b, bound_by=o, library_ms=None)
    log(f"timing rg_lru_fwd: {out['ms']:.4f} ms (bound {b:.4f} ms by {o}: "
        f"{nbytes / 1e9:.3f} GB, {ops_n / 1e9:.1f} GFLOP), plain "
        f"{out['plain_ms']:.4f} ms, library none (no single PyTorch call "
        "computes this recurrence)")
    del big, ragged, slow, x, r, i, lam, l2
    torch.cuda.empty_cache()
    return {"rg_lru_fwd": out}


def check_small_reference(torch, M, get_smoke_config):
    """The model on the card agrees with the same model on the CPU at a
    small size (float32, TF32 off)."""
    from repro_torch.tree import tree_map
    cfg = get_smoke_config(ARCH).replace(dtype="float32")
    p_cpu = M.init_params(cfg, seed=3, device="cpu")
    p_gpu = tree_map(lambda t: t.cuda(), p_cpu)
    toks = torch.arange(2 * 12, dtype=torch.int32).reshape(2, 12) % 200
    worst = 0.0
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        cache = M.init_cache(cfg, 2, 32, device=dev)
        last, cache = M.prefill(cfg, params, toks.to(dev), cache)
        step, _ = M.decode_step(cfg, params, cache,
                                torch.tensor([[5], [7]], dtype=torch.int32,
                                             device=dev),
                                torch.tensor([12, 12], dtype=torch.int32,
                                             device=dev))
        if dev == "cpu":
            want = (last, step)
        else:
            for a, b in zip(want, (last.cpu(), step.cpu())):
                worst = max(worst, float((a - b).abs().max()))
                if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
                    raise AssertionError("card and CPU logits disagree")
    log(f"small reference: {ARCH}-smoke f32 prefill+decode logits on the "
        f"card match the CPU within 1e-4 (max abs diff {worst:.2e})")


def serve(torch, ServingEngine, Request, arch, params, prompts, *,
          n_slots, max_seq, max_new, sess=None, kill_at=None):
    """Serve ``prompts`` on a new engine for ``arch`` (under ``sess``
    when given) until every request is done or ``kill_at`` steps ran.
    Returns (engine, requests, tokens, seconds)."""
    eng = ServingEngine.create(arch, params, n_slots=n_slots, max_seq=max_seq,
                               manager=sess.manager if sess else None)
    if sess is not None:
        sess.attach(eng)
    reqs = [Request(rid=i, prompt=p.copy(), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    t0 = time.monotonic()
    tokens = 0
    while (eng.queue or any(eng.slot_req)) and \
            (kill_at is None or eng.steps < kill_at):
        tokens += eng.step()
        if sess is not None:
            sess.maybe_snapshot()
    torch.cuda.synchronize()
    return eng, reqs, tokens, time.monotonic() - t0


def profile_decode(torch, np, eng, Request, prompts) -> None:
    """Where a decode step's time goes: wall time per full-batch step
    against the device time of its kernels (torch.profiler), hence the
    device's idle share, and the kernel launches per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i, p in enumerate(prompts[:N_SLOTS]):
        eng.submit(Request(rid=100 + i, prompt=p[:128].copy(), max_new=16))
    for _ in range(3):                      # admission + warm steps
        eng.step()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(4):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.monotonic() - t0) / 4 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev = sum(e.time_range.elapsed_us() for e in kernels) / 3 / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 3 / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    log(f"decode profile: {wall:.2f} ms wall per step, {dev:.2f} ms of "
        f"device kernels ({len(kernels) // 3} launches) per step, device "
        f"idle {100 * (1 - dev / wall):.1f}% of the step; top kernels "
        + "; ".join(f"{n[:48]} {t:.2f} ms" for n, t in top))
    eng.run_until_drained()


# the codec kernels a chained snapshot's capture and encode launch (the
# int8 codec's pair runs on the training path's codec phase instead)
CAPTURE_KERNELS = ("fingerprint", "fused_capture", "xor")


def main_path(torch, np, ops, fa):
    """Phase 5, the serving path."""
    from repro_torch.api import CheckpointSession, Policy
    from repro_torch.configs import get_smoke_config, resolve_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.tree import flatten_with_paths

    check_small_reference(torch, M, get_smoke_config)
    cfg = resolve_config(ARCH)
    t0 = time.monotonic()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(v.numel() for _, v in flatten_with_paths(params))
    log(f"main path: {ARCH} full width and depth, {n_params} bf16 params "
        f"made in {time.monotonic() - t0:.1f} s")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.randint(64, 513, size=N_REQ)]
    log(f"main path: {N_REQ} requests, prompts {[len(p) for p in prompts]} "
        f"tokens, max_new {MAX_NEW}, {N_SLOTS} slots, max_seq {MAX_SEQ}")

    ops.reset_counts()
    fa.reset_counts()
    sizes = dict(n_slots=N_SLOTS, max_seq=MAX_SEQ, max_new=MAX_NEW)
    eng, reqs, toks, dt = serve(torch, ServingEngine, Request, ARCH, params,
                                prompts, **sizes)
    ref = {r.rid: list(r.out) for r in reqs}
    total_steps = eng.steps
    last_logits_ok = all(len(v) == MAX_NEW for v in ref.values())
    log(f"uninterrupted: {total_steps} engine steps, {toks} tokens in "
        f"{dt:.2f} s = {toks / dt:.1f} tokens/s (admission prefill "
        f"included); every request produced {MAX_NEW}: {last_logits_ok}")
    if not last_logits_ok:
        raise AssertionError("uninterrupted run did not finish every request")
    profile_decode(torch, np, eng, Request, prompts)
    del eng

    per_policy = {}
    for label, policy in (("sparse", Policy(interval=4, chain=4)),
                          ("dense", Policy(interval=4, chain=4,
                                           sparse=False))):
        before = ops.counts("cuda")
        outcomes0 = ops.fused_outcomes()
        store = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            sess = CheckpointSession(f"localfs:{store}", policy)
            eng, reqs, toks, dt = serve(torch, ServingEngine, Request, ARCH,
                                        params, prompts, **sizes, sess=sess,
                                        kill_at=total_steps // 2)
            sess.wait()
            st = dict(sess.stats)
            done = {r.rid: list(r.out) for r in reqs if r.done}
            sess.close()
            del eng, sess                       # the kill
            torch.cuda.empty_cache()
            t0 = time.monotonic()
            sess2 = CheckpointSession(f"localfs:{store}", policy)
            eng2 = sess2.restore("latest", params=params)
            torch.cuda.synchronize()
            restore_s = time.monotonic() - t0
            step_restored = eng2.steps
            live = eng2.live_requests()
            eng2.run_until_drained()
            torch.cuda.synchronize()
            got = dict(done)
            got.update({r.rid: list(r.out) for r in live})
            if got != ref:
                bad = sorted(k for k in ref if got.get(k) != ref[k])
                raise AssertionError(f"{label}: restored run diverged from "
                                     f"the uninterrupted run on {bad}")
            timings = eng2.incarnation.timings
            sess2.close()
            del eng2
        finally:
            shutil.rmtree(store, ignore_errors=True)
        after = ops.counts("cuda")
        launches = {k: after[k] - before[k] for k in after}
        outcomes = {k: v - outcomes0[k]
                    for k, v in ops.fused_outcomes().items()}
        saves = max(st["saves"], 1)
        log(f"{label}: killed at step {total_steps // 2}, restored step "
            f"{step_restored} in {restore_s:.2f} s (materialize "
            f"{timings.get('materialize_s', 0):.2f} s, replay "
            f"{timings.get('replay_s', 0):.2f} s); all {N_REQ} requests "
            f"token-identical to the uninterrupted run")
        log(f"{label}: {st['saves']} snapshots ({st['chain_links']} chain "
            f"links), decode {toks / dt:.1f} tokens/s with snapshots, "
            f"capture stall {st['capture_seconds'] / saves * 1e3:.1f} ms per "
            f"snapshot, encode+commit "
            f"{st['encode_commit_seconds'] / saves:.2f} s per snapshot "
            f"(background), dirty/clean chunks {st['dirty_chunks']}/"
            f"{st['clean_chunks']}, fused hits/overflows "
            f"{outcomes['hits']}/{outcomes['overflows']}, bytes written "
            f"{st['bytes_written']}, kernel launches {launches}")
        per_policy[label] = launches
        log(f"{label}: {count_written(st)}")
    total = ops.counts("cuda")
    missing = [k for k in CAPTURE_KERNELS if total[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    flash = fa.counts("cuda")
    if any(flash.values()):
        raise AssertionError(f"serving launched flash kernels: {flash}")
    log(f"main path kernel launches: {total} (sparse {per_policy['sparse']},"
        f" dense {per_policy['dense']}); flash kernels: none, as expected")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return total


HYBRID_ARCH = "recurrentgemma-9b"
# PREFILL_32K's 32,768 tokens at a global batch cut from 32 to 2
HYBRID_PREFILL = "prefill_s32768_b2"
HYBRID_SERVE = dict(n_slots=4, max_seq=1024, max_new=24)
HYBRID_N_REQ, HYBRID_PROMPT_LENS = 6, (32, 97)
HYBRID_POLICY = dict(interval=4, chain=4)
# prefill against replay admission, f32 at full width and depth, in the
# 2-norm (measured ~1e-5; bf16 rounding at 38 layers leaves both bf16
# paths ~5.5e-2 from the f32 model, beyond C8's 2e-2 set at smoke depth)
F32_REL = 1e-4


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def check_hybrid_reference(torch, np, M, rg, get_smoke_config, ServingEngine,
                           Request, arch=HYBRID_ARCH):
    """``arch``'s smoke model in float32 (TF32 off), card against CPU:
    prefill of 40 tokens (past the window of 32) then 32 greedy decode
    steps — logits and every cache leaf, the remainder blocks' too,
    within 1e-5 and the same tokens; then the engine's greedy tokens on
    both devices (admission by replay)."""
    from repro_torch.tree import flatten_with_paths, tree_map
    cfg = get_smoke_config(arch).replace(dtype="float32")
    p_cpu = M.init_params(cfg, seed=3, device="cpu")
    p_gpu = tree_map(lambda t: t.cuda(), p_cpu)
    toks = torch.arange(2 * 40, dtype=torch.int32).reshape(2, 40) \
        % cfg.vocab_size
    res, worst = {}, 0.0
    before = rg.counts("cuda")["rg_lru_fwd"]
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        cache = M.init_cache(cfg, 2, 96, device=dev)
        logits, _ = M.prefill(cfg, params, toks.to(dev), cache)
        # copies: on the CPU .cpu() would alias the cache that the decode
        # steps below write in place
        seen = [logits.to("cpu", copy=True)] + [
            t.to("cpu", copy=True) for _, t in flatten_with_paths(cache)]
        gen = []
        for pos in range(40, 72):
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            gen.append(nxt.cpu())
            logits, _ = M.decode_step(
                cfg, params, cache, nxt,
                torch.full((2,), pos, dtype=torch.int32, device=dev))
            seen.append(logits.cpu())
        res[dev] = (seen + [t.to("cpu", copy=True)
                            for _, t in flatten_with_paths(cache)],
                    torch.cat(gen, dim=1))
    launched = rg.counts("cuda")["rg_lru_fwd"] - before
    n_rglru = _n_rglru(cfg)
    if launched != n_rglru:
        raise AssertionError(f"{arch}-smoke prefill launched rg_lru_fwd "
                             f"{launched} times, expected {n_rglru}")
    for a, b in zip(res["cuda"][0], res["cpu"][0]):
        worst = max(worst, float((a.float() - b.float()).abs().max()))
        if not torch.allclose(a, b, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"{arch}-smoke: card and CPU disagree "
                                 f"past 1e-5 (max abs diff {worst:.2e})")
    if not torch.equal(res["cuda"][1], res["cpu"][1]):
        raise AssertionError(f"{arch}-smoke: greedy tokens differ")
    prompts = [np.arange(n, dtype=np.int32) * 7 % cfg.vocab_size
               for n in (12, 45, 7)]
    outs = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        eng = ServingEngine(cfg, params, dev, n_slots=2, max_seq=96)
        reqs = [Request(rid=i, prompt=p, max_new=30)
                for i, p in enumerate(prompts)]
        for q in reqs:
            eng.submit(q)
        eng.run_until_drained()
        outs[dev] = [q.out for q in reqs]
    if outs["cuda"] != outs["cpu"] or any(len(o) != 30 for o in outs["cpu"]):
        raise AssertionError(f"{arch}-smoke: the engine's tokens differ "
                             f"between card and CPU")
    log(f"small reference: {arch}-smoke f32 ({cfg.n_layers} layers, "
        f"{n_rglru} RG-LRU launches in the prefill) on the card matches "
        f"the CPU: prefill of 40 tokens and 32 greedy decode steps past "
        f"the window of {cfg.attn_window}, logits and all "
        f"{len(res['cpu'][0]) - 33} cache leaves twice within 1e-5 (max "
        f"abs diff {worst:.2e}), the same tokens; engine tokens equal on "
        "both devices")


def _n_rglru(cfg) -> int:
    """The recurrent layers of a hybrid config (one RG-LRU kernel launch
    each in a prefill)."""
    period = len(cfg.block_pattern)
    return sum(1 for i in range(cfg.n_layers)
               if cfg.block_pattern[i % period] == "rglru")


def _all_counts(mods):
    return {name: mod.counts("cuda") for name, mod in mods.items()}


def _reset_all(mods):
    for mod in mods.values():
        mod.reset_counts()


def profile_call(torch, fn, n_top=6):
    """Run ``fn`` once under torch.profiler (device activity only):
    returns (its result, wall ms, ms of device kernels, device kernel
    launches, the ``n_top`` largest kernels by time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        key = _kernel_name(e.name)
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
    return out, wall, dev, len(kernels), top


def prefill_vs_replay(torch, M, ServingEngine, rg, cfg, params, prompts):
    """For each prompt: the relative 2-norm distance between the engine's
    replay admission (``ServingEngine.replay``: batch-1 decode steps, no
    RG-LRU kernel) and a batch-1 ``prefill`` (the kernel once per
    recurrent layer), for the next-token logits and every RG-LRU state
    leaf. Returns ([{path: distance}] per prompt, [prefill logits])."""
    from repro_torch.tree import flatten_with_paths
    max_seq = HYBRID_SERVE["max_seq"]
    eng = ServingEngine(cfg, params, "cuda", n_slots=1, max_seq=max_seq)
    out, logits = [], []
    for p in prompts:
        before = rg.counts("cuda")["rg_lru_fwd"]
        r_logits, r_cache = eng.replay(p)
        if rg.counts("cuda")["rg_lru_fwd"] != before:
            raise AssertionError("replay admission launched rg_lru_fwd")
        one = M.init_cache(cfg, 1, max_seq, "cuda")
        p_logits, one = M.prefill(cfg, params,
                                  torch.from_numpy(p[None]).cuda(), one)
        rels = {"logits": _rel(r_logits, p_logits)}
        rels.update({path: _rel(a, b) for (path, a), (_, b) in zip(
            flatten_with_paths(r_cache), flatten_with_paths(one))
            if path.endswith("['state']")})
        out.append(rels)
        logits.append(p_logits)
    return out, logits


def hybrid_path(torch, np, mods):
    """The hybrid family's path (see the module docstring): the smoke
    model card against CPU; recurrentgemma-9b at full width and depth
    prefills ``HYBRID_PREFILL`` through the registered ``prefill_step``
    (the RG-LRU kernel once per recurrent layer), its prefill state is
    held against the engine's replay admission, and it serves under C/R
    through kill -> restore("latest"). Every kernel count is set to 0
    just before each run of the path and read just after it."""
    from repro_torch.api import CheckpointSession, Policy
    from repro_torch.configs import get_smoke_config, resolve_config
    from repro_torch.configs.registry import get_shape
    from repro_torch.core.split_state import LowerHalf
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.tree import flatten_with_paths, tree_map
    rg = mods["rg_lru"]

    check_hybrid_reference(torch, np, M, rg, get_smoke_config,
                           ServingEngine, Request)
    cfg = resolve_config(HYBRID_ARCH)
    t0 = time.monotonic()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(v.numel() for _, v in flatten_with_paths(params))
    n_rglru = _n_rglru(cfg)
    log(f"hybrid path: {HYBRID_ARCH} full width and depth ({cfg.n_layers} "
        f"layers, {n_rglru} RG-LRU, d_model {cfg.d_model}, width "
        f"{cfg.rglru_width}, head dim {cfg.resolved_head_dim}, window "
        f"{cfg.attn_window}), {n_params} params counted from the tensors "
        f"(ModelConfig.n_params() says {cfg.n_params()}), made in "
        f"{time.monotonic() - t0:.1f} s")

    # --- prefill at the published length, through the registered step
    shape = get_shape(HYBRID_PREFILL)
    B, S = shape.global_batch, shape.seq_len
    lower = LowerHalf(mesh_factory=lambda: torch.device("cuda"))
    lower.mesh_create((1, 1), ("data", "model"))
    prefill = lower.executable(lower.compile_step("prefill_step",
                                                  HYBRID_ARCH, shape.name))
    gen = torch.Generator(device="cuda").manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device="cuda", dtype=torch.int32)
    cache = lower.cache(lower.cache_alloc(HYBRID_ARCH, B, S))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all(mods)
    (logits, cache), wall, dev, n_k, top = profile_call(
        torch, lambda: prefill(params, toks, cache))
    counts = _all_counts(mods)
    peak = torch.cuda.max_memory_allocated()
    launches = counts["rg_lru"]["rg_lru_fwd"]
    others = {k: v for name, c in counts.items() if name != "rg_lru"
              for k, v in c.items() if v}
    log(f"hybrid prefill: {shape.name} ({B} x {S} tokens) in {wall:.1f} ms "
        f"= {B * S / wall * 1e3:.0f} tokens/s, {dev:.1f} ms of device "
        f"kernels ({n_k} launches), device idle {100 * (1 - dev / wall):.1f}%"
        f" (torch.profiler); rg_lru_fwd launches {launches}, other kernels "
        f"{others or 'none'}; peak device memory {peak / 1e9:.2f} GB; by "
        "kernel: " + "; ".join(f"{n} {t:.1f} ms" for n, t in top))
    if launches != n_rglru or others:
        raise AssertionError(f"prefill launched rg_lru_fwd {launches} times "
                             f"(expected {n_rglru}) and {others}")
    if tuple(logits.shape) != (B, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError("prefill logits are not finite [B, V]")
    # one state leaf per block of the pattern (stacked over the groups)
    # and per remainder block: n_rglru [B, W] states in all
    states = [t for p, t in flatten_with_paths(cache)
              if p.endswith("['state']")]
    if sum(t.numel() for t in states) != n_rglru * B * cfg.rglru_width \
            or not all(bool(torch.isfinite(t).all()) for t in states):
        raise AssertionError("prefill states are not n_rglru finite "
                             "[B, W] states")
    del cache, toks, logits, states
    torch.cuda.empty_cache()

    # --- the kernel's prefill state against the engine's replay admission
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.randint(*HYBRID_PROMPT_LENS, size=HYBRID_N_REQ)]
    t0 = time.monotonic()
    p32 = tree_map(lambda t: t.float(), params)
    rels, f32_logits = prefill_vs_replay(torch, M, ServingEngine, rg,
                                         cfg.replace(dtype="float32"), p32,
                                         prompts)
    del p32
    torch.cuda.empty_cache()
    worst = max((rel, f"prompt {k} {path}") for k, r in enumerate(rels)
                for path, rel in r.items())
    # the bf16 model, for the record (ROADMAP C8 at full depth): its
    # prefill against its replay, and its prefill logits against the f32
    # model's
    bf16, bf16_logits = prefill_vs_replay(torch, M, ServingEngine, rg, cfg,
                                          params, prompts)
    worst_bf16 = max(rel for r in bf16 for rel in r.values())
    off = [_rel(b, f) for b, f in zip(bf16_logits, f32_logits)]
    log(f"prefill vs replay: {HYBRID_N_REQ} prompts of "
        f"{[len(p) for p in prompts]} tokens, a batch-1 prefill (the "
        f"kernel) against the engine's replay admission (batch-1 decode "
        f"steps), next-token logits and the states of all {n_rglru} RG-LRU "
        f"layers in the 2-norm: the f32 model worst {worst[0]:.2e} "
        f"({worst[1]}; limit {F32_REL:g}); the bf16 model worst "
        f"{worst_bf16:.2e} (not held), its prefill logits "
        f"{min(off):.2e}-{max(off):.2e} from the f32 model's; "
        f"{time.monotonic() - t0:.1f} s")
    if not worst[0] <= F32_REL:
        raise AssertionError(f"prefill vs replay in f32: {worst[1]} "
                             f"{worst[0]:.2e} > {F32_REL}")

    # --- serving under C/R
    _reset_all(mods)
    eng, reqs, toks_n, dt = serve(torch, ServingEngine, Request, HYBRID_ARCH,
                                  params, prompts, **HYBRID_SERVE)
    ref = {r.rid: list(r.out) for r in reqs}
    total_steps = eng.steps
    if not all(len(v) == HYBRID_SERVE["max_new"] for v in ref.values()):
        raise AssertionError("uninterrupted hybrid run did not finish")
    log(f"hybrid uninterrupted: {total_steps} engine steps, {toks_n} tokens "
        f"in {dt:.2f} s = {toks_n / dt:.1f} tokens/s (replay admission "
        f"included)")
    del eng
    # the last snapshot before the kill falls while the first wave of
    # requests is in flight, so the restore rebinds live slot state
    kill_at = total_steps // 2 - 2
    policy = Policy(**HYBRID_POLICY)
    store = tempfile.mkdtemp(prefix="chip_smoke_hybrid_")
    try:
        sess = CheckpointSession(f"localfs:{store}", policy)
        eng, reqs, toks_n, dt = serve(torch, ServingEngine, Request,
                                      HYBRID_ARCH, params, prompts,
                                      **HYBRID_SERVE, sess=sess,
                                      kill_at=kill_at)
        sess.wait()
        st = dict(sess.stats)
        done = {r.rid: list(r.out) for r in reqs if r.done}
        in_flight = sum(1 for r in eng.slot_req if r is not None)
        sess.close()
        del eng, sess                                    # the kill
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        sess2 = CheckpointSession(f"localfs:{store}", policy)
        eng2 = sess2.restore("latest", params=params)
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        back, live = eng2.steps, eng2.live_requests()
        live_slots = sum(1 for r in eng2.slot_req if r is not None)
        eng2.run_until_drained()
        torch.cuda.synchronize()
        got = dict(done)
        got.update({r.rid: list(r.out) for r in live})
        sess2.close()
        del eng2
    finally:
        shutil.rmtree(store, ignore_errors=True)
    counts = _all_counts(mods)
    log(f"hybrid serving: {count_written(st)}")
    if got != ref:
        bad = sorted(k for k in ref if got.get(k) != ref[k])
        raise AssertionError(f"hybrid restored run diverged on {bad}")
    saves = max(st["saves"], 1)
    log(f"hybrid serving: killed at step {kill_at} ({in_flight} requests in "
        f"flight), restored step {back} ({live_slots} slots live) in "
        f"{restore_s:.2f} s; all {HYBRID_N_REQ} requests token-identical to "
        f"the uninterrupted run; {st['saves']} snapshots ({st['chain_links']}"
        f" chain links), capture stall {st['capture_seconds'] / saves * 1e3:.1f}"
        f" ms per snapshot, encode+commit {st['encode_commit_seconds'] / saves:.2f}"
        f" s, dirty/clean chunks {st['dirty_chunks']}/{st['clean_chunks']}, "
        f"bytes written {st['bytes_written']}; kernel launches {counts}")
    if not all(counts["codec"][k] for k in ("fingerprint", "fused_capture")):
        raise AssertionError(f"hybrid serving missed a capture kernel: "
                             f"{counts['codec']}")
    ran = {k: v for name in ("flash", "ssd", "rg_lru")
           for k, v in counts[name].items() if v}
    if ran:
        raise AssertionError(f"decode or replay launched {ran}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"rg_lru_fwd": launches}


def check_train_reference(torch, np, kern, arch, shape_key, mode):
    """One f32 train step of ``arch``'s smoke model on the card (its
    kernels: ``kern``'s counts must move) against the same step on the
    CPU (the plain versions): TF32 off, so the two differ only in the
    order of their sums. Loss and grad norm within 1e-5 relative; then,
    ``mode`` "state": params 1e-6 absolute at lr 3e-4 (a step moves a
    param by ~lr), moments 1e-4 relative; ``mode`` "grads" (the ssm
    family): each leaf's gradient in the 2-norm within ``R.tolerance``
    of the CPU step's own spread between the model's scan chunk and a
    quarter of it. The post-step state is not held elementwise there:
    AdamW's first step moves a param by lr * g / (|g| + eps), so a
    gradient element of ~1e-9 that reblocking the plain scan alone moves
    by a few percent moves its param by more than 1e-6; the log counts
    such params for the CPU against itself and for the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.registry import get_shape
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels.ssd_scan import ref as R
    from repro_torch.models import model as M
    from repro_torch.models import ssm as SSM
    from repro_torch.optim import AdamWConfig, ScheduleConfig, init_opt_state
    from repro_torch.parallel.planner import make_plan
    from repro_torch.train.step import (make_loss_fn, make_train_step,
                                        value_and_grad)
    from repro_torch.tree import flatten_with_paths, tree_map
    cfg = get_smoke_config(arch).replace(dtype="float32")
    shape = get_shape(shape_key)
    plan = make_plan(cfg, shape)
    step_fn = make_train_step(cfg, plan, AdamWConfig(), ScheduleConfig())
    loss_fn = make_loss_fn(cfg, M.CallOptions(remat=plan.remat))
    batch = TokenPipeline(DataConfig(seed=7, vocab_size=cfg.vocab_size,
                                     seq_len=shape.seq_len, global_batch=2,
                                     n_shards=2)).batch_at(0)
    p_cpu = M.init_params(cfg, seed=3, device="cpu")

    def run(dev):
        params = tree_map(lambda t: t.to(dev, copy=True), p_cpu)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        grads = {}
        if mode == "grads":
            _, g = value_and_grad(loss_fn, params, b)
            grads = {p: t.cpu() for p, t in flatten_with_paths(g)}
        opt = init_opt_state(params, AdamWConfig())
        params, opt, met = step_fn(params, opt, b, 150, torch.tensor(1.0))
        return (met, {p: t.cpu() for p, t in flatten_with_paths(params)},
                {p: t.cpu() for p, t in flatten_with_paths(opt)}, grads)

    res = {}
    for dev in ("cpu", "cuda"):
        before = kern.counts(dev)
        res[dev] = run(dev)
        ran = {k: kern.counts(dev)[k] - before[k] for k in kern.KERNELS}
        if dev == "cuda" and not all(ran.values()):
            raise AssertionError(f"the card's step missed a kernel: {ran}")
    for key in ("loss", "grad_norm"):
        a, b = float(res["cpu"][0][key]), float(res["cuda"][0][key])
        if abs(a - b) > 1e-5 * abs(a):
            raise AssertionError(f"train step {key}: CPU {a} vs card {b}")
    head = (f"small reference: {arch}-smoke f32 train step (seq "
            f"{shape.seq_len}, lr {float(res['cpu'][0]['lr']):.3e}) on the "
            f"card matches the CPU: loss {float(res['cuda'][0]['loss']):.6f}"
            f" vs {float(res['cpu'][0]['loss']):.6f}")
    if mode == "state":
        worst = 0.0
        for i, (rtol, atol) in ((1, (0, 1e-6)), (2, (1e-4, 1e-8))):
            for path, a in res["cpu"][i].items():
                b = res["cuda"][i][path]
                worst = max(worst, float((a.float() - b.float()).abs().max()))
                if not torch.allclose(a.float(), b.float(), rtol=rtol,
                                      atol=atol):
                    raise AssertionError(f"train step state {path}: card "
                                         "and CPU disagree")
        log(f"{head}, max abs state diff {worst:.2e}")
        return
    chunk = SSM.CHUNK
    SSM.CHUNK = chunk // 4
    try:
        alt = run("cpu")
    finally:
        SSM.CHUNK = chunk
    rel = lambda a, b: float((a - b).norm() / b.norm().clamp_min(1e-30))
    readings, bad = [], []
    for path, g in res["cpu"][3].items():
        spread = rel(alt[3][path], g)
        err = rel(res["cuda"][3][path], g)
        readings.append((err / R.tolerance(spread), path, err, spread))
        if err > R.tolerance(spread):
            bad.append(path)
    def moved(r):   # params more than 1e-6 away from the CPU step's
        return sum(int(((t - res["cpu"][1][p]).abs() > 1e-6).sum())
                   for p, t in r[1].items())

    off = {"cpu": moved(alt), "card": moved(res["cuda"])}
    share, path, err, spread = max(readings)
    log(f"{head}; gradients per leaf within 4 x the CPU's chunk {chunk} vs "
        f"{chunk // 4} spread (at least 1e-4) in the 2-norm, worst {path} "
        f"{err:.2e} (spread {spread:.2e}, {share:.2f} of its limit); params "
        f"off by more than 1e-6 after the step: CPU at chunk {chunk // 4} "
        f"{off['cpu']}, card {off['card']} of "
        f"{sum(t.numel() for t in res['cpu'][1].values())}")
    if bad:
        raise AssertionError(f"train step gradients past the limit: {bad}")


def _mem_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def _kernel_name(name: str) -> str:
    """A profiler kernel name without its return type, namespaces and
    argument list."""
    n = name.replace("void ", "", 1).replace("(anonymous namespace)::", "") \
        .replace("at::native::", "")
    depth, out = 0, []
    for ch in n:
        if ch == "(" and depth == 0:
            break
        depth += (ch == "<") - (ch == ">")
        out.append(ch)
    return "".join(out)[:64]


def profile_train_step(torch, tr):
    """Wall time of one train step against the device time of its
    kernels (torch.profiler), hence the device's idle share."""
    met, wall, dev, n_k, top = profile_call(torch, lambda: tr.train_steps(1),
                                            n_top=12)
    log(f"train profile: {wall:.1f} ms wall, {dev:.1f} ms of device kernels "
        f"({n_k} launches), device idle {100 * (1 - dev / wall):.1f}% of "
        "the step; by kernel: " + "; ".join(f"{n} {t:.1f} ms" for n, t in top))
    return met, wall


def train_path(torch, np, kernel_mods, cell):
    """A training path (see the module docstring): ``cell`` is one of
    ``TRAIN_CELLS``; its kernel module ``cell["kernels"]`` must launch
    its first kernel twice per layer and step (the forward, again under
    remat) and every other kernel once. Every kernel count is set to 0
    just before the run and read just after it."""
    from repro_torch.api import CheckpointSession, Policy
    from repro_torch.configs import resolve_config
    from repro_torch.configs.registry import get_shape
    from repro_torch.train.loop import Trainer, TrainJob

    arch, shape_key, steps = cell["arch"], cell["shape"], TRAIN_STEPS
    kern = kernel_mods[cell["kernels"]]
    check_train_reference(torch, np, kern, arch, cell["reference_shape"],
                          cell["reference"])
    job_arch = arch + (f"-layers{cell['layers']}" if "layers" in cell
                       else "")
    cfg = resolve_config(job_arch)
    shape = get_shape(shape_key)
    tokens = shape.global_batch * shape.seq_len
    n = cfg.n_params()
    snap = n * (2 + 4 + 4)                      # bf16 params, f32 mu and nu
    store = tempfile.mkdtemp(prefix="chip_smoke_train_")
    disk, mem = shutil.disk_usage(store).free, _mem_available()
    depth = (f"depth cut to {cfg.n_layers} of "
             f"{resolve_config(arch).n_layers} layers" if "layers" in cell
             else f"full depth, {cfg.n_layers} layers")
    log(f"train path: {job_arch} at full width, {depth} (d_model "
        f"{cfg.d_model}, {n} params), {shape_key}; a snapshot is "
        f"{snap / 1e9:.1f} GB; free disk {disk / 1e9:.1f} GB, MemAvailable "
        f"{mem / 1e9:.1f} GB")
    if disk < 1.05 * snap or mem < 1.5 * snap:
        raise AssertionError(
            f"the snapshot needs ~{1.05 * snap / 1e9:.0f} GB of disk and "
            f"~{1.5 * snap / 1e9:.0f} GB of host memory (page-locked "
            f"staging, then the restore's decode); have {disk / 1e9:.1f} "
            f"GB disk, {mem / 1e9:.1f} GB MemAvailable")
    policy = Policy(**TRAIN_POLICY)
    torch.use_deterministic_algorithms(True)
    _reset_all(kernel_mods)
    try:
        t0 = time.monotonic()
        sess = CheckpointSession(f"localfs:{store}", policy)
        tr = Trainer(TrainJob(job_arch, shape_key), manager=sess.manager)
        tr.init_state()
        sess.attach(tr)
        torch.cuda.synchronize()
        log(f"train path: cold start (seeded bf16 params, zero moments) in "
            f"{time.monotonic() - t0:.2f} s; plan {tr.plan}")
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = [], []
        for i in range(steps):
            if i == 4:
                met, ms = profile_train_step(torch, tr)
            else:
                t1 = time.monotonic()
                met = tr.train_steps(1)
                ms = (time.monotonic() - t1) * 1e3
            step_ms.append(ms)
            losses.append(met["loss"])
            if sess.maybe_snapshot() is not None:
                log(f"train path: snapshot after step {i + 1}; "
                    f"MemAvailable {_mem_available() / 1e9:.1f} GB")
        t1 = time.monotonic()
        sess.wait()
        drain = time.monotonic() - t1
        st = dict(sess.stats)
        peak = torch.cuda.max_memory_allocated()
        want = tr.state_digest()
        steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
        log(f"train path: losses {losses}; step {steady:.1f} ms (median of "
            f"steps 2-{steps}; step 1 {step_ms[0]:.1f} ms) = "
            f"{tokens / steady * 1e3:.0f} tokens/s; peak device memory "
            f"{peak / 1e9:.2f} GB")
        saves = max(st["saves"], 1)
        log(f"train path: {st['saves']} snapshot(s) ({st['chain_links']} chain "
            f"links), capture stall {st['capture_seconds'] / saves:.2f} s per "
            f"snapshot, encode+commit {st['encode_commit_seconds'] / saves:.1f}"
            f" s per snapshot (background; {drain:.1f} s left to drain after "
            f"step {steps}), bytes written {st['bytes_written'] / saves:.0f}"
            f" per snapshot, dirty/clean chunks {st['dirty_chunks']}/"
            f"{st['clean_chunks']}; {count_written(st)}")
        sess.close()
        del tr, sess                                 # the kill
        gc.collect()
        torch.cuda.empty_cache()
        log(f"train path: trainer dropped; device memory "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, MemAvailable "
            f"{_mem_available() / 1e9:.1f} GB")
        t0 = time.monotonic()
        sess2 = CheckpointSession(f"localfs:{store}", policy)
        tr2 = sess2.restore("latest", expect_kind="train")
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        back = tr2.checkpoint_step()
        timings = tr2.incarnation.timings
        again = [tr2.train_steps(1)["loss"] for _ in range(steps - back)]
        got = tr2.state_digest()
        sess2.close()
        # the codec phase continues from the restored trainer
        box = [tr2] if cell.get("codec") else []
        del tr2, sess2
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(store, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    counts = _all_counts(kernel_mods)
    log(f"train path: restored step {back} in {restore_s:.1f} s (materialize "
        f"{timings.get('materialize_s', 0):.1f} s, replay "
        f"{timings.get('replay_s', 0):.2f} s, rebind "
        f"{timings.get('rebind_s', 0):.1f} s); losses after restore {again}")
    if back != 6 or again != losses[back:]:
        raise AssertionError(f"restored run diverged: step {back}, losses "
                             f"{again} vs {losses[back:]}")
    if got != want:
        raise AssertionError(f"state digest after restore {got} != "
                             f"uninterrupted {want}")
    launched = counts[cell["kernels"]]
    layer_steps = cfg.n_layers * (steps + steps - back)
    expect = {k: (2 if i == 0 else 1) * layer_steps
              for i, k in enumerate(kern.KERNELS)}
    if launched != expect:
        raise AssertionError(f"{arch}: kernel launches {launched}, expected "
                             f"{expect} (forward twice per layer and step "
                             f"under remat, the rest once)")
    log(f"train path: losses and state digest {got} bit-identical to the "
        f"uninterrupted run; kernel launches {launched} ({cfg.n_layers} "
        f"layers x {steps + steps - back} steps; the forward twice per layer "
        f"under remat); all counts {counts}")
    if box:
        launched = dict(launched, **codec_path(torch, kernel_mods, box, cfg,
                                               losses[back:]))
    return launched


def expected_parts(ops, D, moments):
    """The manifest parts (codes and scales, chunk blob names included)
    that the host codec writes for the plain version's quantization of
    each moment: quantized on the card one leaf at a time, chunked and
    hashed on host threads (zlib and blake2b release the GIL)."""
    host = {}
    for p, m in moments.items():
        q, sc = ops.quantize_plain(m)
        host[p] = D.Int8Leaf(q.cpu(), sc.cpu(), m.shape, "float32")
        del q, sc

    def parts(p):
        return p, D.encode_leaf(host[p], lambda h, d: None, lambda h: False,
                                codec="int8")["parts"]

    with ThreadPoolExecutor(8) as pool:
        return dict(pool.map(parts, host))


# the codec phase's store: blobs hashed to 4 virtual hosts, no replicas
# (a second copy of every blob would not fit the run's disk writes)
CODEC_STORE_HOSTS = 4
CODEC_POLICY = dict(interval=TRAIN_STEPS, chain=1, keep_last=1,
                    codecs={"opt_state": "int8"})


def codec_path(torch, kernel_mods, box, cfg, uncoded_losses):
    """The int8 snapshot codec on the training path at full width and
    depth: from the trainer in ``box`` (restored and stepped by
    ``train_path``), one snapshot under ``codecs={"opt_state": "int8"}``
    into a ``sharded:`` store, two more uncoded steps while it encodes,
    then the trainer is dropped, comes back through
    ``restore("latest")`` and trains 2 steps. Raises unless (a) every
    codec leaf of opt_state is written in codec mode with the blobs of
    the plain quantize of a clone taken at the snapshot, (b) capture
    launched one quantize and restore one dequantize per codec leaf, with
    no plain call and no host quantize_ref/dequantize_ref on the path,
    (c) the restored moments are the plain dequantize(quantize(clone))
    bit for bit, (d) params, step and data cursor came back bit for bit,
    (e) the 2 steps after restore give finite losses (logged beside the
    uncoded steps'; the codec is lossy), (f) the SSD kernels launched
    once per layer and step (the forward twice, under remat). Every
    kernel count is set to 0 just before the snapshot and read after
    the last step."""
    from repro_torch.api import CheckpointSession, Policy
    from repro_torch.core import delta as D
    from repro_torch.kernels.ckpt_codec import ref as R
    from repro_torch.tree import flatten_with_paths
    ops = kernel_mods["codec"]
    tr = box.pop()
    opt = dict(flatten_with_paths(tr.upper.get("opt_state")))
    clone = {p: v.clone() for p, v in opt.items()
             if D.codec_applicable(v, "int8")}
    del opt
    n_leaves = len(clone)
    digest = (tr.params_digest(), tr.checkpoint_step(),
              int(tr.upper.get("data_cursor")))
    n_params = sum(v.numel() for _, v in flatten_with_paths(
        tr.upper.get("params")))
    n_mom = sum(v.numel() for v in clone.values())
    predicted = 2 * n_params + n_mom + 4 * (n_mom // 256)
    log(f"codec path: {cfg.n_layers} layers, {n_leaves} opt_state leaves "
        f"under int8 ({n_mom} moment elements, {4 * n_mom / 1e9:.2f} GB in "
        f"f32); a coded snapshot is ~{predicted / 1e9:.2f} GB before zlib "
        f"(bf16 params, q and scales), the uncoded one "
        f"{(2 * n_params + 4 * n_mom) / 1e9:.2f} GB")
    host_calls = {"quantize_ref": 0, "dequantize_ref": 0}
    originals = {k: getattr(R, k) for k in host_calls}

    def counting(name):
        def call(*a, **kw):
            host_calls[name] += 1
            return originals[name](*a, **kw)
        return call

    store = tempfile.mkdtemp(prefix="chip_smoke_codec_")
    spec = f"sharded:{store}?hosts={CODEC_STORE_HOSTS}"
    policy = Policy(**CODEC_POLICY)
    torch.use_deterministic_algorithms(True)
    for k in host_calls:
        setattr(R, k, counting(k))
    try:
        sess = CheckpointSession(spec, policy)
        sess.attach(tr)
        _reset_all(kernel_mods)
        torch.cuda.reset_peak_memory_stats()
        step = tr.checkpoint_step()
        sess.snapshot()
        captured = ops.counts("cuda")["quantize"]
        # the uncoded run goes on while the snapshot encodes: its moments
        # are updated in place after snapshot() returned
        uncoded = [tr.train_steps(1)["loss"] for _ in range(2)]
        t1 = time.monotonic()
        sess.wait()
        drain = time.monotonic() - t1
        st = dict(sess.stats)
        leaves = sess.backend.get_manifest(step)["entries"]["opt_state"][
            "leaves"]
        per_host = [sum(f.stat().st_size
                        for f in Path(store, f"host_{h:03d}").iterdir())
                    for h in range(CODEC_STORE_HOSTS)]
        sess.close()
        del tr, sess                                     # the drop
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.monotonic()
        expect = expected_parts(ops, D, clone)
        expect_s = time.monotonic() - t1
        bad = sorted(p for p in clone if leaves[p].get("mode") != "codec"
                     or leaves[p]["parts"] != expect[p])
        if bad or captured != n_leaves:
            raise AssertionError(f"(a) codec leaves not written as the plain "
                                 f"version's blobs: {bad[:4]} ({len(bad)}); "
                                 f"{captured} quantize launches at capture "
                                 f"for {n_leaves} leaves")
        del expect
        t0 = time.monotonic()
        sess2 = CheckpointSession(spec, policy)
        tr = sess2.restore("latest", expect_kind="train")
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        timings = tr.incarnation.timings
        codec_counts = ops.counts("cuda")
        plain_counts = ops.counts("cpu")
        worst = []
        for p, v in flatten_with_paths(tr.upper.get("opt_state")):
            if p in clone:
                q, sc = ops.quantize_plain(clone.pop(p))
                want = ops.dequantize_plain(q, sc)[:v.numel()].view(v.shape)
                if not torch.equal(v.view(torch.int32),
                                   want.view(torch.int32)):
                    worst.append(p)
                del q, sc, want
        del clone
        back = (tr.params_digest(), tr.checkpoint_step(),
                int(tr.upper.get("data_cursor")))
        coded = [tr.train_steps(1)["loss"] for _ in range(2)]
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        sess2.close()
        del tr, sess2
    finally:
        for k, fn in originals.items():
            setattr(R, k, fn)
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(store, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    counts = _all_counts(kernel_mods)
    saves = max(st["saves"], 1)
    log(f"codec path: snapshot of step {step} into {spec}: capture stall "
        f"{st['capture_seconds'] / saves:.2f} s, capture_bytes "
        f"{st['capture_bytes']} (logical {st['bytes_logical']}), "
        f"encode+commit {st['encode_commit_seconds'] / saves:.1f} s "
        f"(background; {drain:.1f} s left to drain after 2 steps), bytes "
        f"written {st['bytes_written']}, per virtual host {per_host}; "
        f"{count_written(st)}; the plain version's blob names computed in "
        f"{expect_s:.1f} s")
    log(f"codec path: restored step {back[1]} in {restore_s:.1f} s "
        f"(materialize {timings.get('materialize_s', 0):.1f} s, replay "
        f"{timings.get('replay_s', 0):.2f} s, rebind "
        f"{timings.get('rebind_s', 0):.1f} s); peak device memory "
        f"{peak / 1e9:.2f} GB; losses after restore {coded} beside the "
        f"uncoded run's {uncoded} (and the cell's steps 7-8 "
        f"{uncoded_losses}); codec launches {codec_counts}, plain calls "
        f"{plain_counts}, host reference calls {host_calls}")
    if codec_counts["quantize"] != n_leaves \
            or codec_counts["dequantize"] != n_leaves \
            or any(plain_counts.values()) or any(host_calls.values()):
        raise AssertionError(f"(b) codec route: {codec_counts} for "
                             f"{n_leaves} leaves, plain {plain_counts}, host "
                             f"{host_calls}")
    if worst:
        raise AssertionError(f"(c) restored moments differ from the plain "
                             f"dequantize(quantize(m)): {worst[:4]}")
    if back != digest:
        raise AssertionError(f"(d) params/step/cursor {back} != {digest}")
    if not all(math.isfinite(x) for x in coded):
        raise AssertionError(f"(e) losses after the coded restore {coded}")
    layer_steps = cfg.n_layers * 4
    expect_ssd = {"ssd_fwd": 2 * layer_steps, "ssd_bwd": layer_steps}
    if counts["ssd"] != expect_ssd:
        raise AssertionError(f"(f) SSD launches {counts['ssd']}, expected "
                             f"{expect_ssd}")
    log(f"codec path: (a)-(f) hold: {n_leaves} codec leaves written as the "
        f"plain version's blobs, restored bit for bit as its dequantize("
        f"quantize(m)) on the card, params/step/cursor bit-identical; all "
        f"counts {counts}")
    return {k: codec_counts[k] for k in ("quantize", "dequantize")}


def ptxas_summary(report: str):
    """``kernel<hd>: registers[, spill bytes]`` per entry function of an
    ``nvcc -Xptxas -v`` report."""
    import re
    out, name = [], "?"
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"\d([a-z][a-z_]*_kernel)(?:ILi(\d+)E)?",
                          m.group(1))
            name = (m.group(1)[-32:] if not t else t.group(1) if not
                    t.group(2) else f"{t.group(1)}<{t.group(2)}>")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and m.group(1) != "0":
            name += f" (spills {m.group(1)} B)"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{name} {m.group(1)} regs")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.kernels.ckpt_codec import ops, ref
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.nvcc import ARCH_FLAGS
    from repro_torch.kernels.rg_lru import ops as rg
    from repro_torch.kernels.rg_lru import ref as rg_ref
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.ssd_scan import ref as ssd_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.monotonic()
    libs = (ops.LIB, fa.LIB, ssd.LIB, rg.LIB)
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.library(), libs))
    log(f"build: {len(libs)} nvcc {' '.join(ARCH_FLAGS)} in parallel, "
        f"{time.monotonic() - t0:.1f} s")
    for lib in libs:
        info = lib.build_info
        log(f"build: {lib.source.name} -> {info['path']} in "
            f"{info['seconds']:.1f} s; ptxas: "
            + "; ".join(ptxas_summary(info.get("ptxas", ""))))

    kernels = check_kernels(torch, ops, ref)
    kernels.update(check_codec(torch, ops, ref))
    kernels.update(check_flash(torch, fa))
    kernels.update(check_ssd(torch, ssd, ssd_ref))
    kernels.update(check_rglru(torch, rg, rg_ref, ssd_ref.within))
    launches = main_path(torch, np, ops, fa)
    mods = {"codec": ops, "flash": fa, "ssd": ssd, "rg_lru": rg}
    launches.update(hybrid_path(torch, np, mods))
    for cell in TRAIN_CELLS:
        launches.update(train_path(torch, np, mods, cell))
    for name, k in kernels.items():
        k["launches"] = launches[name]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in kernels.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
