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
   version's time (and ``torch.bitwise_xor``'s for the XOR);
4. each flash-attention kernel (forward, dq, dk/dv) held against its
   plain PyTorch version at the training shape in bf16 and at a ragged
   f32 shape with a window, with its time, its bound, the plain
   version's time and ``scaled_dot_product_attention``'s (forward; its
   autograd backward for dq and dk/dv together);
5. the serving path: phi4-mini-3.8b at full width and depth (bf16
   params from seeded ``torch.Generator``s) serves 6 requests on 4
   slots under a ``CheckpointSession`` with chained snapshots, is
   killed about half way, comes back through ``restore("latest")`` and
   must finish every request token for token as the uninterrupted run
   did — once with sparse capture on, once with ``sparse=False``. Every
   codec kernel must have launched, and no flash kernel (serving never
   takes the training route);
6. the training path: one f32 step of starcoder2-3b-smoke on the card
   matches the same step on the CPU; then starcoder2-3b at full width
   and depth trains 8 steps of 2 x 4096 tokens under a
   ``CheckpointSession`` (one full 30.3 GB snapshot, after step 6), is
   dropped, comes back through ``restore("latest")`` at step 6 and
   trains 2 steps: the losses of steps 7-8 and the digest of params,
   optimizer state, step and data cursor must equal the uninterrupted
   run's bit for bit. Every flash kernel must have launched during this
   phase.

Before the last line it prints ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without that line; so does a machine with no CUDA device.
"""
from __future__ import annotations

import gc
import json
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
TRAIN_ARCH, TRAIN_SHAPE, TRAIN_STEPS = "starcoder2-3b", "train_s4096_b2", 8
# one full snapshot, after step 6, with no chain (so no dirty-chunk
# capture either): a snapshot of the training state is 30.3 GB and the
# card's machine accepts 45 GiB of disk writes per run, so a chain's
# link (another ~30 GB) cannot be written there; training links run at
# smoke size in the tests instead
TRAIN_POLICY = dict(interval=6, chain=1, keep_last=1)


_T0 = time.monotonic()


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
    at the training shape (bf16) and a ragged f32 shape with a window."""
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
             ("ragged", torch.float32, 1, 4, 2, 1000, 128, 64)]
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


def serve(torch, np, ServingEngine, Request, params, prompts, sess=None,
          kill_at=None):
    eng = ServingEngine.create(ARCH, params, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                               manager=sess.manager if sess else None)
    if sess is not None:
        sess.attach(eng)
    reqs = [Request(rid=i, prompt=p.copy(), max_new=MAX_NEW)
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
    eng, reqs, toks, dt = serve(torch, np, ServingEngine, Request, params,
                                prompts)
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
            eng, reqs, toks, dt = serve(torch, np, ServingEngine, Request,
                                        params, prompts, sess,
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
    total = ops.counts("cuda")
    missing = [k for k, v in total.items() if v == 0]
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


def check_train_reference(torch, np, fa):
    """One f32 train step of the smoke model on the card (flash kernels)
    against the same step on the CPU (the model's plain attention): TF32
    off, so the two differ only in the order of their sums. Tolerances: loss and
    grad norm 1e-5 relative; params 1e-6 absolute at lr 3e-4 (a step
    moves a param by ~lr); moments 1e-4 relative."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.registry import get_shape
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig, ScheduleConfig, init_opt_state
    from repro_torch.parallel.planner import make_plan
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import flatten_with_paths, tree_map
    cfg = get_smoke_config(TRAIN_ARCH).replace(dtype="float32")
    shape = get_shape("train_s192_b2")       # 3 q tiles, ragged-free
    step_fn = make_train_step(cfg, make_plan(cfg, shape), AdamWConfig(),
                              ScheduleConfig())
    batch = TokenPipeline(DataConfig(seed=7, vocab_size=cfg.vocab_size,
                                     seq_len=shape.seq_len, global_batch=2,
                                     n_shards=2)).batch_at(0)
    p_cpu = M.init_params(cfg, seed=3, device="cpu")
    res = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev, copy=True), p_cpu)
        opt = init_opt_state(params, AdamWConfig())
        before = fa.counts(dev)
        params, opt, met = step_fn(
            params, opt, {k: torch.from_numpy(v).to(dev)
                          for k, v in batch.items()}, 150,
            torch.tensor(1.0))
        ran = {k: fa.counts(dev)[k] - before[k] for k in fa.KERNELS}
        if dev == "cuda" and not all(ran.values()):
            raise AssertionError(f"the card's step missed a flash kernel: "
                                 f"{ran}")
        res[dev] = (met, dict(flatten_with_paths(params)),
                    dict(flatten_with_paths(opt)))
    worst = 0.0
    for key in ("loss", "grad_norm"):
        a, b = float(res["cpu"][0][key]), float(res["cuda"][0][key])
        if abs(a - b) > 1e-5 * abs(a):
            raise AssertionError(f"train step {key}: CPU {a} vs card {b}")
    for i, (rtol, atol) in ((1, (0, 1e-6)), (2, (1e-4, 1e-8))):
        for path, a in res["cpu"][i].items():
            b = res["cuda"][i][path].cpu()
            worst = max(worst, float((a.float() - b.float()).abs().max()))
            if not torch.allclose(a.float(), b.float(), rtol=rtol, atol=atol):
                raise AssertionError(f"train step state {path}: card and "
                                     "CPU disagree")
    log(f"small reference: {TRAIN_ARCH}-smoke f32 train step "
        f"(seq {shape.seq_len}, lr {float(res['cpu'][0]['lr']):.3e}) on the "
        f"card matches the CPU: loss {float(res['cuda'][0]['loss']):.6f}, "
        f"max abs state diff {worst:.2e}")


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        met = tr.train_steps(1)
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        key = _kernel_name(e.name)
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"train profile: {wall:.1f} ms wall, {dev:.1f} ms of device kernels "
        f"({len(kernels)} launches), device idle "
        f"{100 * (1 - dev / wall):.1f}% of the step; by kernel: "
        + "; ".join(f"{n} {t:.1f} ms" for n, t in top))
    return met, wall


def train_path(torch, np, ops, fa):
    """Phase 6, the training path (see the module docstring)."""
    from repro_torch.api import CheckpointSession, Policy
    from repro_torch.configs import resolve_config
    from repro_torch.train.loop import Trainer, TrainJob

    check_train_reference(torch, np, fa)
    cfg = resolve_config(TRAIN_ARCH)
    n = cfg.n_params()
    snap = n * (2 + 4 + 4)                      # bf16 params, f32 mu and nu
    store = tempfile.mkdtemp(prefix="chip_smoke_train_")
    disk, mem = shutil.disk_usage(store).free, _mem_available()
    log(f"train path: {TRAIN_ARCH} full width and depth ({n} params), "
        f"{TRAIN_SHAPE}; a snapshot is {snap / 1e9:.1f} GB; free disk "
        f"{disk / 1e9:.1f} GB, MemAvailable {mem / 1e9:.1f} GB")
    if disk < 1.05 * snap or mem < 1.5 * snap:
        raise AssertionError(
            f"the snapshot needs ~{1.05 * snap / 1e9:.0f} GB of disk and "
            f"~{1.5 * snap / 1e9:.0f} GB of host memory (page-locked "
            f"staging, then the restore's decode); have {disk / 1e9:.1f} "
            f"GB disk, {mem / 1e9:.1f} GB MemAvailable")
    policy = Policy(**TRAIN_POLICY)
    torch.use_deterministic_algorithms(True)
    ops.reset_counts()
    fa.reset_counts()
    try:
        t0 = time.monotonic()
        sess = CheckpointSession(f"localfs:{store}", policy)
        tr = Trainer(TrainJob(TRAIN_ARCH, TRAIN_SHAPE), manager=sess.manager)
        tr.init_state()
        sess.attach(tr)
        torch.cuda.synchronize()
        log(f"train path: cold start (seeded bf16 params, zero moments) in "
            f"{time.monotonic() - t0:.2f} s; plan {tr.plan}")
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = [], []
        for i in range(TRAIN_STEPS):
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
            f"steps 2-{TRAIN_STEPS}; step 1 {step_ms[0]:.1f} ms) = "
            f"{2 * 4096 / steady * 1e3:.0f} tokens/s; peak device memory "
            f"{peak / 1e9:.2f} GB")
        saves = max(st["saves"], 1)
        log(f"train path: {st['saves']} snapshot(s) ({st['chain_links']} chain "
            f"links), capture stall {st['capture_seconds'] / saves:.2f} s per "
            f"snapshot, encode+commit {st['encode_commit_seconds'] / saves:.1f}"
            f" s per snapshot (background; {drain:.1f} s left to drain after "
            f"step {TRAIN_STEPS}), bytes written {st['bytes_written'] / saves:.0f}"
            f" per snapshot, dirty/clean chunks {st['dirty_chunks']}/"
            f"{st['clean_chunks']}")
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
        again = [tr2.train_steps(1)["loss"]
                 for _ in range(TRAIN_STEPS - back)]
        got = tr2.state_digest()
        sess2.close()
        del tr2, sess2
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(store, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
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
    flash, codec = fa.counts("cuda"), ops.counts("cuda")
    missing = [k for k, v in flash.items() if v == 0]
    if missing:
        raise AssertionError(f"flash kernels never launched on the "
                             f"training path: {missing}")
    log(f"train path: losses and state digest {got} bit-identical to the "
        f"uninterrupted run; kernel launches {flash} (fwd twice per layer "
        f"under remat), codec {codec}")
    return flash


def ptxas_summary(report: str):
    """``kernel<type,hd>: registers[, spill bytes]`` per entry function
    of an ``nvcc -Xptxas -v`` report."""
    import re
    out, name = [], "?"
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"\d([a-z][a-z_]*_kernel)"
                          r"(?:I(13__nv_bfloat16|f)Li(\d+)E)?", m.group(1))
            name = t.group(1) if t and not t.group(2) else (
                f"{t.group(1)}<{'bf16' if 'bfloat' in t.group(2) else 'f32'}"
                f",{t.group(3)}>" if t else m.group(1)[-32:])
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.monotonic()
    libs = (ops.LIB, fa.LIB)
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
    kernels.update(check_flash(torch, fa))
    launches = main_path(torch, np, ops, fa)
    launches.update(train_path(torch, np, ops, fa))
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
