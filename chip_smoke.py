#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.

    python3 chip_smoke.py        # from the repository root

Phases, each reported on its own line:

1. the card: ``nvidia-smi --query-gpu=name,power.limit`` verbatim;
2. the nvcc build of ``src/repro_torch/csrc`` into ``build/``;
3. each checkpoint-codec kernel (fingerprint, fused capture, XOR) held
   bit for bit against its plain PyTorch version on the card, at the
   main path's shapes, with its time, its bound and the plain version's
   time (and ``torch.bitwise_xor``'s for the XOR);
4. the main path: phi4-mini-3.8b at full width and depth (bf16 params
   from seeded ``torch.Generator``s) serves 6 requests on 4 slots under
   a ``CheckpointSession`` with chained snapshots, is killed about half
   way, comes back through ``restore("latest")`` and must finish every
   request token for token as the uninterrupted run did — once with
   sparse capture on, once with ``sparse=False``. Every kernel must have
   launched during this phase.

Before the last line it prints ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
without that line; so does a machine with no CUDA device.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# cuBLAS picks deterministic reductions only with a fixed workspace
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
CUDA_CORE_OPS_PER_S = 67e12     # H100 SXM peak outside the tensor cores
ARCH = "phi4-mini-3.8b"
N_SLOTS, MAX_SEQ, N_REQ, MAX_NEW = 4, 1024, 6, 48


def log(msg: str) -> None:
    print(msg, flush=True)


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


def bound_ms(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
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


def main_path(torch, np, ops):
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
    log(f"main path kernel launches: {total} (sparse {per_policy['sparse']},"
        f" dense {per_policy['dense']})")
    return total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.kernels.ckpt_codec import cuda as kcuda
    from repro_torch.kernels.ckpt_codec import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.monotonic()
    kcuda.library()
    info = kcuda.build_info
    log(f"build: nvcc {' '.join(kcuda.ARCH_FLAGS)} -> {info['path']} in "
        f"{time.monotonic() - t0:.1f} s")
    for line in info.get("ptxas", "").splitlines():
        if "Used" in line:
            log(f"build: ptxas {line.split(':', 1)[1].strip()}")

    kernels = check_kernels(torch, ops, ref)
    launches = main_path(torch, np, ops)
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
