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
   version's time (and ``torch.bitwise_xor``'s for the XOR, also timed
   with it at a 256 MiB view); then the
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
   autograd backward for dq and dk/dv together), then non-causal with
   Sq != Skv at whisper-base's encoder ``[8, 8, 1500, 64]`` and
   cross-attention (4,096 queries, 1,500 keys) in bf16 (each kernel's
   time, bound, plain time and the non-causal SDPA's logged) and at a
   ragged f32 cross shape, then at recurrentgemma-9b's training
   attention (head dim 256, q ``[2, 16, 4096, 256]``, k/v ``[2, 1, 4096,
   256]``, causal, window 2,048) in bf16 and f32, each the same bits on
   a second call, with the bf16 kernels' times as the kernels line's
   ``*_hd256`` rows (``csrc/flash_attention_hd256.cu``: wgmma and TMA;
   SDPA given the window as a mask, its backend named from the
   profiler's kernels), and two bf16 hd-256 cases at that design's tile
   edges (ragged rows with a window off the 64-row grid; a GQA group of
   2, non-causal, Sq != Skv); then each SSD kernel
   (the chunked scan's forward and its gradient) against its plain
   version at mamba2-780m's training shape in bf16 and at a ragged f32
   shape with an initial state, with limits set from the plain version's
   own spread between two chunk lengths, its time, its bound and the
   plain version's time (no single PyTorch call computes an SSD scan),
   the forward and the backward each the same bits over three calls at
   the training shape, and each launch's device time (the forward's four
   kernels, the backward's six) from torch.profiler;
   then the RG-LRU kernel against its plain version at the prefill shape
   (x, r, i ``[2, 32768, 4096]`` f32 drawn as a fresh block makes them,
   ``rg_lru/ref.model_inputs``) from a zero and from a random state, and
   at a ragged shape with a state, every element within 1e-4 * (|plain|
   + rms(plain)), with its time, its bound, this design's own floor (x,
   r, i read twice), the plain version's time and each of its three
   launches' device time; then the RG-LRU backward kernel against its
   plain version at the training cell's shape (``[2, 4096, 4096]``, from
   zero), at the prefill shape from a random state and at a ragged shape
   with decays near one (dx, dr, di, dlam, dh0 within the same limit),
   the same bits on a second call, with its time, its bound by bytes,
   the plain version's time and each of its four launches' device time;
5. the serving path: phi4-mini-3.8b at full width and depth (bf16
   params from seeded ``torch.Generator``s) serves 6 requests on 4
   slots under a ``CheckpointSession`` with chained snapshots, is
   killed about half way, comes back through ``restore("latest")``,
   then that step again through ``restore(step, streaming=True)`` (the
   KV cache the cold tier, landed by the first decode step), and each
   must finish every request token for token as the uninterrupted run
   did — once with sparse capture on, once with ``sparse=False``; it
   logs each restore's return time, the time to its first decoded token
   and ``stream_timings()``. Every codec kernel must have launched, and
   no flash kernel (serving never takes the training route);
6. the hybrid path: recurrentgemma-9b-smoke in f32, card against CPU —
   a prefill past the attention window and greedy decode steps (logits
   and every cache leaf, the unstacked remainder blocks' too, within
   1e-5; the same tokens), then the engine's tokens on both devices;
   recurrentgemma-9b at full width, its depth cut from 38 to 5 layers
   (``HYBRID_LAYERS``; bf16 params from seeded generators) prefills ``prefill_s32768_b2`` (PREFILL_32K's
   length, batch cut from 32 to 2) through the registered
   ``prefill_step``, profiled, launching the RG-LRU kernel exactly once
   per recurrent layer (4) and no other kernel; for each serving prompt
   a batch-1 prefill (the kernel) against the engine's replay admission
   (batch-1 decode steps) in f32, logits and every RG-LRU state within
   1e-4 in the 2-norm; then 6 requests of 32-96 tokens on 4 slots, 24
   new tokens each, under ``Policy(interval=4, chain=4)`` with sparse
   capture, killed while the first wave is in flight, restored through
   ``restore("latest")``: every request token for token as the
   uninterrupted run, the capture kernels launched, no flash, SSD or
   RG-LRU kernel during decode or replay; then the ssm serving cell:
   mamba2-780m at full width, its depth cut from 48 to 8 layers
   (``SSM_SERVE_LAYERS``) serves 6 requests of 16-48 tokens on 4 slots, 24 new tokens
   each (admission by replay, timed per token), its decode profiled
   (ms a step, device idle share), then under ``Policy(interval=4,
   chain=4)`` with sparse capture it is killed while the first wave is
   in flight and restored eagerly, then streamed: every request token
   for token each time, the capture kernels launched, no flash, SSD or
   RG-LRU kernel; then the encoder-decoder (``encdec_path``):
   whisper-base-smoke in f32 card against CPU (``prefill(frames=)`` and
   8 greedy decode steps: logits and every cache leaf within 1e-5, the
   same tokens); whisper-base at full width and depth in f32, a
   ``prefill(frames=)`` (12 flash forward launches: encoder and
   cross-attention) and 16 greedy decode steps against ``forward_train``
   over the extended sequence within 1e-4 in the 2-norm; then its bf16
   serving cell as mamba2-780m's (6 requests of 16-48 tokens on 4
   slots of 448, replay admission, killed mid first wave, restored
   eagerly then streamed), the cross cache still zero after serving as
   the reference engine leaves it; then the moe family
   (``moe_serving_path``): llama4-scout-17b-a16e at full width, its
   depth cut from 48 to 8 layers by the card's memory (19,685,790,720
   bf16 params), serves as phi4-mini-3.8b does (6 prompts on 4 slots,
   48 new tokens each, prefill admission) through kill -> eager,
   streamed and re-slotted (onto 3 slots) restores, token for token,
   no decode call dropping a choice; then kimi-k2-1t-a32b at full width
   with 1 of its 61 layers (top-8 of 384 experts, ``moe_topk_path``)
   serves 4 requests twice with the same tokens and KV cache bits, then
   through kill -> restore; no flash kernel runs in either;
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
   cut to 12 of 30 layers (``starcoder2-3b-layers12``), trains on 2 x
   4096 tokens a step through the flash kernels, mamba2-780m, its depth
   cut to 8 of 48 layers, on 8 x 4096 through the SSD kernels,
   whisper-base at full width and depth on 8 x 4096 tokens (1,500
   encoder frames a row) through the flash kernels, 36 forward, 18 dq and
   18 dk/dv launches a step (6 encoder, 6 self- and 6 cross-attention
   layers, the forward twice under remat); recurrentgemma-9b at full
   width, its depth cut to 3 of 38 layers (one block group: two RG-LRU
   blocks and one local-attention block), on 2 x 4096 tokens through the
   RG-LRU forward and backward kernels and the flash kernels at head dim
   256 (4 ``rg_lru_fwd``, 2 ``rg_lru_bwd``, 2 ``flash_fwd``, 1 ``flash_dq``
   and 1 ``flash_dkv`` a step), after its full depth is refused on the
   card before anything is allocated (params and f32 moments past 0.9 x
   the card's memory; the message names the bytes and ROADMAP A9);
8. the codec phase, from mamba2-780m's restored trainer (``codec_path``):
   one snapshot under ``codecs={"opt_state": "int8"}`` into a
   ``sharded:`` store of 4 virtual hosts (quantize on the card, only the
   codes cross), two more steps while it encodes, drop,
   ``restore("latest")`` (dequantize on the card) and 2 steps; the
   manifest's codec leaves must carry the blobs of the plain version's
   codes, the restored moments must be its dequantize(quantize(m)) bit
   for bit, params, step and cursor bit-identical, and each kernel must
   have launched once per codec leaf with no plain or host codec call;
   then the same step restored streamed (``opt_state`` the cold tier,
   fetched from the 4 virtual hosts) and 2 steps: moments, params, step,
   cursor and both losses bit-identical to the eager restore, one
   dequantize launch per codec leaf, no plain or host codec call;
9. the moe family's training at ``-smoke`` (``moe_train_smoke``):
   llama4-scout-17b-a16e and kimi-k2-1t-a32b, each an f32 step held
   against the CPU (gradients, and each layer's expert ids off near
   ties), its gradients the same bits twice under deterministic
   algorithms, then 8 steps, a snapshot after step 6, a drop,
   ``restore("latest")`` and 2 steps, bit-identical, through the flash
   kernels at head dim 16;
10. the failure loop (``supervise_path``), driven through the launchers'
   own functions (``repro_torch.launch.serve._run_supervised`` and
   ``_run_migrated``, ``repro_torch.launch.train._run_supervised``) over
   a simulated world of 4 hosts: phi4-mini-3.8b at full width, 16 of 32
   layers, in bf16 (params from one init) serves 6 seeded prompts on 4 slots, 24
   new tokens each, into ``sharded:<tmp>?hosts=4&replicate=1`` with a
   chained snapshot every 4 engine steps, with host 2 killed at engine
   step 8 under a hot spare (no restore), a shrink (re-slotted onto 3
   slots) and a restart, and once moved live onto a 3-slot engine at
   step 6 (each session's cache column carried); every request must
   keep the uninterrupted run's tokens, and each run logs its MTTR
   (the end of the step before the detecting tick to the end of the
   first step after the decision) or the move's worst per-batch
   blackout; then whisper-base at full width and depth trains 8 steps
   with a checkpoint every 4 and host 2 of 4 killed at step 4 (a shrink
   onto 3 virtual hosts): every step's loss, the rolled-back steps'
   again, and the state digest bit-identical to the training cell's
   uninterrupted run, 36 / 18 / 18 flash launches a step;
11. training over a device mesh and elastic restore (``mesh_path``):
   four ranks (``launch.mesh.spawn_ranks``) share the card, their
   collectives through gloo and the collective shim's pinned staging
   area (``parallel.collectives``); starcoder2-3b at full width, 2 of 30
   layers, ``train_s4096_b4``, a step on a (2, 2) mesh through the
   flash kernels on each rank's local heads, a snapshot (the shards
   gathered onto rank 0 alone, its capture kernels and commit), one
   more step; the group torn down; the checkpoint restored onto one
   device here and, in a
   second launch, onto (4, 1) and (2, 2), every params digest the saved
   one, each stepped once, (2, 2)'s loss and state digest the
   uninterrupted run's bit for bit and the others' losses within 2e-4
   of it; llama4-scout's one-layer forward expert-parallel on (1, 4)
   against one rank (bf16, ROADMAP C8): the tokens whose top-1 expert
   differs counted, the others' logits held within a relative 2-norm
   limit; ``compressed_psum`` over the four ranks within 2 x scale of
   the exact mean that rank 0 computes alone from every rank's seed;
   the GPipe toy pipeline against the layer loop. Per-rank step ms,
   the staged collectives' seconds and bytes, the snapshot's gather and
   encode, each restore's seconds and peak memory per rank are logged.
   Serving over the mesh in the same two launches (``MESH_SERVE``):
   phi4-mini-3.8b at full width, 2 of 32 layers, bf16, 4 slots x 1,024,
   the serving path's six prompts, 12 new tokens; in the first launch
   served to the end on (2, 2) (the slots split over data, the 8 KV
   heads over model) with a snapshot every 4 steps (rank 0's session,
   chained, sparse), the cache digest of step 8's snapshot kept, then
   step 8 restored onto (2, 2) and decoded to the end: every request's
   tokens bit for bit (the restored engine snapshotting on, dense, into
   a store of its own: its chain links XOR on the card, where the sparse
   links XOR their dirty chunks on the host); in the second launch
   restored eagerly onto (1, 4)
   and streamed onto (4, 1); in this process onto one device. Every
   target's restored cache digest is the saved one, every rank emits the
   same tokens, the first restored step's logits lie within 2e-2 of the
   uninterrupted run's in the relative 2-norm (bf16 sums in another
   order, ROADMAP C8) and each target's count of requests that finish
   token for token is logged; rank 0's capture kernels must launch. Each
   rank's decode step (wall and device ms), the staged collectives of
   one decode step, each restore's seconds (materialize, replay,
   rebind) and first token, and each rank's peak memory are logged; the
   second launch's peak is read before llama4-scout's forward and reset
   between them.
   The failure loop over the mesh in the same two launches
   (``MESH_SUPERVISE``): every rank runs one ``ClusterSupervisor`` over
   hosts 0-3 (host h backs rank h) and host 3 dies. The training
   checkpoint shrinks onto (2, 1) over ranks 0-1 and steps once: the
   saved params digest, a data assignment of the survivors alone, the
   loss within 2e-4 of the uninterrupted run's. Serving step 8 re-slots
   onto 3 slots of (1, 2) over ranks 0-1 and drains: the saved
   sessions' cache columns, the first step's logits within 2e-2 of a
   one-device re-slot. The (2, 2)-restored engine's sessions move onto
   one device on rank 0 (``migrate_sessions``): the carried columns'
   digest the source's, the first step's logits within 2e-2 of a
   one-device restore. Every rank's incidents must agree; each rank's
   MTTR, the restores' phases, the peaks (ranks outside the shrunk
   mesh hold nothing), the staged collectives, the move's blackout and
   the token-for-token counts are logged.
   Every phase logs its seconds and the run's running total of snapshot
   bytes written.

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
from types import SimpleNamespace
from typing import Tuple

ROOT = Path(__file__).resolve().parent
# cuBLAS picks deterministic reductions only with a fixed workspace
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, str(ROOT / "src"))
# bytecode of every module this run imports, compiled once into build/
# (gitignored) and read by the mesh path's spawned ranks, which would
# otherwise each compile torch's sources again (~10 s a rank on the card
# machine, whose site-packages keeps no bytecode)
if __name__ == "__main__":
    os.environ["PYTHONPYCACHEPREFIX"] = str(ROOT / "build" / "pycache")
    sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"]
    sys.dont_write_bytecode = False

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
CUDA_CORE_OPS_PER_S = 67e12     # H100 SXM peak outside the tensor cores
BF16_OPS_PER_S = 989e12         # H100 SXM dense bf16 tensor-core peak
ARCH = "phi4-mini-3.8b"
N_SLOTS, MAX_SEQ, N_REQ, MAX_NEW = 4, 1024, 6, 48
TRAIN_STEPS = 8
# the training cells, each at full width (and full depth unless ``layers``
# cuts it, as ``configs.registry.resolve_config`` spells it): the model,
# its shape (the published 4,096-token length at a batch cut from 256 to
# what one card steps without accumulation), the kernel module (or
# modules) whose kernels the step runs, and the shape and mode of the f32
# smoke step held against the CPU (check_train_reference)
TRAIN_CELLS = (
    dict(arch="starcoder2-3b", shape="train_s4096_b2", kernels="flash",
         reference_shape="train_s192_b2",         # 3 q tiles, ragged-free
         reference="state",
         # depth cut from 30: its snapshot's one-thread encode took 337-413
         # s of the run's 1,200 (the time limit), and to 12 from 15 to make
         # room for the supervise path, ~10-14 s a layer
         layers=12),
    dict(arch="mamba2-780m", shape="train_s4096_b8", kernels="ssd",
         reference_shape="train_s512_b2",         # 2 chunks of 256
         reference="grads", codec=True,
         # depth cut from 48: the snapshot's one-thread encode (95.6 s)
         # and the codec phase's (113.9 s) at full depth put the script
         # over its 1,200 s limit; 16 layers kept a 2.6 GB snapshot, 8
         # since the mesh path came (ROADMAP C17)
         layers=8),
    # full width and depth (6 + 6 layers); the flash kernels also run
    # non-causal: the encoder over 1,500 frames, the cross-attention from
    # 4,096 tokens to them
    dict(arch="whisper-base", shape="train_s4096_b8", kernels="flash",
         reference_shape="train_s64_b2", reference="grads"),
    # full width, depth cut from 38 to 3: one block group (two RG-LRU
    # blocks, one local-attention block at head dim 256), so both block
    # kinds train; 4,096 tokens cross the 2,048-token window. Full depth
    # is refused on the card before anything is allocated (params and
    # f32 moments alone 85.2 GB, ROADMAP A9)
    dict(arch="recurrentgemma-9b", layers=3, shape="train_s4096_b2",
         kernels=("rg_lru", "flash"),
         reference_shape="train_s256_b2", reference="grads",
         refuse_full_depth=True),
)
# one full snapshot, after step 6, with no chain (so no dirty-chunk
# capture either): each cell logs its snapshot's size (30.3 GB for
# starcoder2-3b at full depth, 7.8 for mamba2-780m, 16.4 for
# recurrentgemma-9b at 3 layers) and the card's machine
# accepts 45 GiB of disk writes per run (deleted files count), so a
# chain's link at full depth cannot be written there; training links run
# at smoke size in the tests instead
TRAIN_POLICY = dict(interval=6, chain=1, keep_last=1)
# (job arch, shape) -> (the losses of the uninterrupted run's steps, its
# state digest after them), as ``train_path`` measured them; the
# supervise path holds whisper-base's supervised run to them
UNINTERRUPTED = {}


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
    # a 256 MiB view shows the rate the kernel streams at, apart from the
    # launch latency that dominates 4 MiB
    big = 256 << 20
    ya = torch.randint(0, 256, (big,), dtype=torch.uint8, device=dev,
                       generator=gen)
    yb = torch.randint(0, 256, (big,), dtype=torch.uint8, device=dev,
                       generator=gen)
    if not torch.equal(ops.xor_blocks(ya, yb), torch.bitwise_xor(ya, yb)):
        raise AssertionError("XOR kernel disagrees with bitwise_xor at "
                             "256 MiB")
    kb, kl = (time_ms(lambda: ops.xor_blocks(ya, yb), 20, flush),
              time_ms(lambda: torch.bitwise_xor(ya, yb), 20, flush))
    b256, _ = bound_ms(3 * big, big // 16)
    log(f"timing xor at 256 MiB: {kb:.4f} ms (bound {b256:.4f} ms by bytes,"
        f" {3 * big / kb / 1e9:.2f} TB/s), torch.bitwise_xor {kl:.4f} ms")
    del ya, yb
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


def flash_f64(torch, fa, q, k, v, do, lse, delta, causal, window):
    """(out, lse, dq, dk, dv) of the plain versions' math in float64: the
    forward from scratch, the backward from the given f32 ``lse`` and
    ``delta`` (the inputs both the kernels and the plain versions take) —
    how far each version's f32 sums are from exact."""
    B, H, Sq, hd = q.shape
    scale = fa.softmax_scale(hd)
    mask = fa._index_mask(Sq, k.shape[2], causal, window, q.device)
    f64 = torch.float64
    res = [torch.empty(q.shape, dtype=f64, device=q.device),
           torch.empty(lse.shape, dtype=f64, device=q.device),
           torch.empty(q.shape, dtype=f64, device=q.device),
           torch.empty(k.shape, dtype=f64, device=q.device),
           torch.empty(k.shape, dtype=f64, device=q.device)]
    for b, hk, hs in fa._groups(q, k):
        qs = q[b, hs].to(f64) * scale
        kf, vf, dof = k[b, hk].to(f64), v[b, hk].to(f64), do[b, hs].to(f64)
        s = torch.einsum("gqd,cd->gqc", qs, kf).masked_fill(~mask,
                                                            -math.inf)
        res[0][b, hs] = torch.einsum("gqc,cd->gqd", s.softmax(-1), vf)
        res[1][b, hs] = s.logsumexp(-1)
        p = torch.exp(s - lse[b, hs].to(f64)[..., None])
        dp = torch.einsum("gqd,cd->gqc", dof, vf)
        ds = p * (dp - delta[b, hs].to(f64)[..., None]) * scale
        res[2][b, hs] = torch.einsum("gqc,cd->gqd", ds, kf)
        res[4][b, hk] = torch.einsum("gqc,gqd->cd", p, dof)
        res[3][b, hk] = torch.einsum("gqc,gqd->cd", ds, qs) / scale
        del s, p, dp, ds
    return res


def check_flash(torch, fa):
    """Phase 4: each flash kernel against its plain version on the card,
    at the training shape (bf16) and at a ragged shape with a window in
    f32 (the CUDA-core kernels) and in bf16 (the tensor-core ones); then
    non-causal with Sq != Skv as whisper-base's training step takes them:
    its encoder (bf16 [8, 8, 1500, 64], ragged against the 64-row tiles),
    its cross-attention (bf16, 4,096 decoder queries against 1,500
    encoder keys) and a ragged f32 cross shape. At whisper's two shapes
    each kernel's time, bound, plain time and the non-causal
    ``scaled_dot_product_attention``'s time are logged (not rows of the
    kernels line: the kernels are the same)."""
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
    # The LSE is f32 in both cases. At recurrentgemma-9b's f32 shape, dk
    # and dv sum over 16 heads x up to 2,048 queries (32,768 terms), and
    # both versions' f32 sums drift from exact by more than 1e-5 there
    # (partial sums of ~10 cancel to values of ~1): each part's atol is
    # then 8 x the plain version's own largest distance from a float64
    # evaluation of the same math (flash_f64), at least 1e-5. The
    # kernel's one f32 accumulator an element sums the 32,768 terms in
    # sequence where the plain version's GEMM sums in blocks: measured on
    # an H100, its distance from float64 was 2-6 x the plain version's.
    tols = {torch.bfloat16: (1e-2, 1e-5), torch.float32: (1e-4, 1e-5)}
    lse_tol = (0.0, 1e-4)
    parts = {"flash_fwd": ("out", "lse"), "flash_dq": ("dq",),
             "flash_dkv": ("dk", "dv")}
    # label, dtype, B, H, Hkv, Sq, Skv, hd, causal, window
    cases = [("training", torch.bfloat16, 2, 24, 2, 4096, 4096, 128, True, 0),
             ("ragged", torch.float32, 1, 4, 2, 1000, 1000, 128, True, 64),
             ("ragged bf16", torch.bfloat16, 1, 4, 2, 1000, 1000, 128, True,
              64),
             ("whisper encoder", torch.bfloat16, 8, 8, 8, 1500, 1500, 64,
              False, 0),
             ("whisper cross", torch.bfloat16, 8, 8, 8, 4096, 1500, 64, False,
              0),
             ("ragged cross", torch.float32, 1, 8, 8, 300, 1000, 64, False,
              0),
             # recurrentgemma-9b's training attention: head dim 256, 16
             # query heads over one kv head, window 2,048 at 4,096 tokens
             ("recurrentgemma", torch.bfloat16, 2, 16, 1, 4096, 4096, 256,
              True, 2048),
             ("recurrentgemma f32", torch.float32, 2, 16, 1, 4096, 4096,
              256, True, 2048),
             # the bf16 hd-256 kernels' edges: 700 rows are not a multiple
             # of the forward's 128-row blocks nor 300 of the 64-row
             # tiles; a group of 2, non-causal, more keys than queries
             ("ragged hd256", torch.bfloat16, 1, 16, 1, 700, 700, 256, True,
              300),
             ("cross hd256", torch.bfloat16, 1, 4, 2, 300, 520, 256, False,
              0)]
    # the rows of the kernels line: the starcoder2-3b training shape under
    # the kernels' names, recurrentgemma-9b's under name + "_hd256"
    rows = {"training": "", "recurrentgemma": "_hd256"}
    for label, dt, B, H, Hkv, Sq, Skv, hd, causal, window in cases:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dt)
        q, k, v, do = rnd(B, H, Sq, hd), rnd(B, Hkv, Skv, hd), \
            rnd(B, Hkv, Skv, hd), rnd(B, H, Sq, hd)
        kw = dict(causal=causal, window=window)
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
        exact = (dict(zip(("out", "lse", "dq", "dk", "dv"), flash_f64(
            torch, fa, q, k, v, do, lse_p, delta, causal, window)))
            if label == "recurrentgemma f32" else None)
        errs, readings, bad = {}, [], []
        for name in fa.KERNELS:
            errs[name] = 0.0
            for part, a, b in zip(parts[name], got[name], want[name]):
                rtol, atol = lse_tol if part == "lse" else tols[dt]
                if exact is not None:
                    own = float((b.double() - exact[part]).abs().max())
                    kern = float((a.double() - exact[part]).abs().max())
                    atol = max(atol, 8 * own)
                    readings.append(f"{part} from float64: plain {own:.2e}, "
                                    f"kernel {kern:.2e}")
                a, b = a.float(), b.float()
                err = (a - b).abs()
                # the worst element's error as a share of its limit
                share = float((err / (atol + rtol * b.abs())).max())
                errs[name] = max(errs[name], float(err.max()))
                readings.append(
                    f"{part} {float(err.max()):.2e} (rms of the plain "
                    f"{float(b.square().mean().sqrt()):.2e}, rtol {rtol:g} "
                    f"atol {atol:.3g}, worst element {share:.2f} of its "
                    "limit)")
                if share > 1:
                    bad.append(f"{name} ({part})")
        log(f"kernel flash ({label}): q {(B, H, Sq, hd)} k/v "
            f"{(B, Hkv, Skv, hd)} {str(dt)[6:]} "
            f"{'causal' if causal else 'non-causal'} window {window}: fwd, "
            f"dq, dk/dv against the plain versions, max abs err "
            + "; ".join(readings))
        if bad:
            raise AssertionError(f"{label}: kernels disagree with their "
                                 f"plain versions past the limit: {bad}")
        del exact
        if label.startswith("recurrentgemma"):
            again = {"flash_fwd": fa.flash_fwd(q, k, v, **kw),
                     "flash_dq": (fa.flash_dq(q, k, v, do, lse_p, delta,
                                              **kw),),
                     "flash_dkv": fa.flash_dkv(q, k, v, do, lse_p, delta,
                                               **kw)}
            same = all(torch.equal(a, b) for name in fa.KERNELS
                       for a, b in zip(got[name], again[name]))
            if not same:
                raise AssertionError(f"{label}: a second call of the flash "
                                     "kernels gave other bits")
            log(f"kernel flash ({label}): fwd, dq and dk/dv the same bits "
                "on a second call")
            del again
        if label not in ("training", "whisper encoder", "whisper cross",
                         "recurrentgemma", "recurrentgemma f32"):
            continue
        pairs = B * H * attended_pairs(Sq, Skv, causal, window)
        esz = q.element_size()
        qb, kvb, st = q.numel() * esz, k.numel() * esz, B * H * Sq * 4
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
        # SDPA takes the window as a boolean mask (True: attended), which
        # rules out its flash backend; the backend it picks is named from
        # the kernels the profiler sees
        sdpa_kw = (dict(is_causal=causal) if window == 0 else dict(
            attn_mask=fa._index_mask(Sq, Skv, causal, window, dev)))
        sdpa_out = F.scaled_dot_product_attention(qr, kr, vr,
                                                  enable_gqa=True, **sdpa_kw)
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=True, **sdpa_kw), 10, flush)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            sdpa_out, (qr, kr, vr), do, retain_graph=True), 10, flush)
        if window:
            top = profile_call(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=True, **sdpa_kw), n_top=3)[4]
            log(f"library ({label}): scaled_dot_product_attention with the "
                f"window as a mask runs " + "; ".join(
                    f"{n} {t:.3f} ms" for n, t in top))
        for name in fa.KERNELS:
            nbytes, ops_n = work[name]
            b, o_by = bound_ms(nbytes, ops_n, BF16_OPS_PER_S)
            if label not in rows:
                ms, plain = (time_ms(calls[name][0], 5, flush),
                             time_ms(calls[name][1], 2, flush))
                lib = lib_fwd if name == "flash_fwd" else lib_bwd
                log(f"timing {name} ({label}): {ms:.4f} ms (bound {b:.4f} "
                    f"ms by {o_by}, {ops_n / 1e9:.1f} GFLOP, "
                    f"{100 * b / ms:.1f}% of it), plain {plain:.4f} ms, "
                    f"scaled_dot_product_attention"
                    f"({'is_causal=False' if not causal else 'window mask'})"
                    f"{'' if name == 'flash_fwd' else ' backward'} "
                    f"{lib:.4f} ms")
                continue
            row = name + rows[label]
            out[row] = dict(
                name=row, route="cuda",
                source="src/repro_torch/csrc/" + ("flash_attention_hd256.cu"
                                                  if hd == 256 else
                                                  "flash_attention.cu"),
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
            log(f"timing {row} ({label}): {out[row]['ms']:.4f} ms (bound "
                f"{b:.4f} ms by {o_by}, {ops_n / 1e9:.1f} GFLOP), plain "
                f"{out[row]['plain_ms']:.4f} ms, library "
                f"{out[row]['library_ms']:.4f} ms")
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
        for _ in range(2):
            again = ssd.ssd_fwd(x, dt, A, Bm, Cm, q, s0)
            if not all(torch.equal(a, b) for a, b in zip((y, fin, states),
                                                         again)):
                raise AssertionError("ssd_fwd gave other bits on a repeated "
                                     "call at the training shape")
            again = ssd.ssd_bwd(x, dt, A, Bm, Cm, states, dy, None, q)
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise AssertionError("ssd_bwd gave other bits on a repeated "
                                     "call at the training shape")
        del again
        log("kernel ssd (training): ssd_fwd and ssd_bwd each the same bits "
            "over 3 calls")
        log_phases(torch, "ssd_fwd", lambda: ssd.ssd_fwd(x, dt, A, Bm, Cm, q))
        log_phases(torch, "ssd_bwd", lambda: ssd.ssd_bwd(
            x, dt, A, Bm, Cm, states, dy, None, q))
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
    # the three-phase design reads x, r, i twice: 28 bytes an element
    floor = 28 * n / HBM_BYTES_PER_S * 1e3
    log(f"timing rg_lru_fwd: {out['ms']:.4f} ms (bound {b:.4f} ms by {o}: "
        f"{nbytes / 1e9:.3f} GB, {ops_n / 1e9:.1f} GFLOP; this design's "
        f"floor {floor:.4f} ms, 28 bytes an element), plain "
        f"{out['plain_ms']:.4f} ms, library none (no single PyTorch call "
        "computes this recurrence)")
    log_phases(torch, "rg_lru_fwd", lambda: rg.rg_lru_fwd(x, r, i, lam))
    del big, ragged, slow, x, r, i, lam, l2
    torch.cuda.empty_cache()
    return {"rg_lru_fwd": out}


RGLRU_TRAIN_SHAPE = (2, 4096, 4096)         # B, S, W: train_s4096_b2


def check_rglru_bwd(torch, rg, R, within):
    """The RG-LRU backward kernel against its plain version on the card
    (the same phases in plain tensors), with x, r, i and lam drawn as a
    fresh block makes them and dh ~ N(0, 1): at the training cell's shape
    from a zero state, at the prefill shape from a random one, and at a
    ragged shape with decays near one. dx, dr, di, dlam and dh0 each
    within RGLRU_RTOL * (|plain| + rms(plain)); the same bits on a second
    call at the training shape; its time there, its bound (the bytes it
    must move) and the plain version's; each launch's device time."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    l2 = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    flush = l2.zero_
    names = ("dx", "dr", "di", "dlam", "dh0")
    cases = [("training, h0 = 0", RGLRU_TRAIN_SHAPE, None, False),
             ("prefill, random h0", RGLRU_PREFILL_SHAPE, None, True),
             ("ragged, decays near one, random h0", (3, 1000, 1000),
              NEAR_ONE, True)]
    worst_err, row = 0.0, None
    for label, (B, S, W), u_range, init in cases:
        ins = R.model_inputs(B, S, W, gen, dev,
                             *(() if u_range is None else (u_range,)))
        h0 = torch.randn((B, W), generator=gen, device=dev) if init else None
        dh = torch.randn((B, S, W), generator=gen, device=dev)
        h = rg.rg_lru_fwd(*ins, h0)
        got = rg.rg_lru_bwd(*ins, h, dh, h0)
        want = R.rg_lru_bwd_plain(*ins, h, dh, h0)
        torch.cuda.synchronize()
        readings, bad = [], []
        for name, a, b in zip(names, got, want):
            share = within(a, b, RGLRU_RTOL)
            err = float((a - b).abs().max())
            worst_err = max(worst_err, err)
            readings.append(f"{name} {err:.2e} (rms of the plain "
                            f"{float(b.square().mean().sqrt()):.2e}, worst "
                            f"element {share:.3f} of its limit)")
            if not share <= 1.0:
                bad.append(name)
        log(f"kernel rg_lru_bwd ({label}): x/r/i/h/dh {(B, S, W)} f32 against"
            f" the plain version, limit {RGLRU_RTOL:g} * (|plain| + rms): "
            + "; ".join(readings))
        if bad:
            raise AssertionError(f"rg_lru_bwd ({label}) disagrees with its "
                                 f"plain version: {bad}")
        del want
        if (B, S, W) == RGLRU_TRAIN_SHAPE:
            again = rg.rg_lru_bwd(*ins, h, dh, h0)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError("rg_lru_bwd gave other bits on a second "
                                     "call")
            del again
            x, r, i, lam = ins
            n = x.numel()
            # x, r, i, h, dh read and dx, dr, di written once (lam, dlam
            # and dh0 are W and B x W floats); ~20 operations an element:
            # the gates again, the reverse scan's FMA, the five products
            # of the gradients
            nbytes, ops_n = 32 * n + 8 * W + 4 * B * W, 20 * n
            b, o = bound_ms(nbytes, ops_n)
            row = dict(name="rg_lru_bwd", route="cuda",
                       source="src/repro_torch/csrc/rg_lru.cu",
                       replaces="none: jax.grad of associative_scan, "
                                "src/repro/models/hybrid.py:76",
                       ms=time_ms(lambda: rg.rg_lru_bwd(x, r, i, lam, h, dh),
                                  10, flush),
                       plain_ms=time_ms(lambda: R.rg_lru_bwd_plain(
                           x, r, i, lam, h, dh), 2, flush),
                       bound_ms=b, bound_by=o, library_ms=None)
            floor = 40 * n / HBM_BYTES_PER_S * 1e3
            log(f"timing rg_lru_bwd: {row['ms']:.4f} ms (bound {b:.4f} ms by "
                f"{o}: {nbytes / 1e9:.3f} GB, {ops_n / 1e9:.1f} GFLOP; this "
                f"design's floor {floor:.4f} ms, 40 bytes an element: r and"
                f" dh read twice), plain {row['plain_ms']:.4f} ms, library "
                "none (no single PyTorch call computes this gradient)")
            log_phases(torch, "rg_lru_bwd",
                       lambda: rg.rg_lru_bwd(x, r, i, lam, h, dh))
            del x, r, i, lam
        elif S == RGLRU_PREFILL_SHAPE[1]:
            ms = time_ms(lambda: rg.rg_lru_bwd(*ins, h, dh, h0), 5, flush)
            n = B * S * W
            log(f"timing rg_lru_bwd ({label}): {ms:.4f} ms (bound "
                f"{bound_ms(32 * n, 20 * n)[0]:.4f} ms by bytes)")
        del ins, h0, dh, h, got
        torch.cuda.empty_cache()
    row["max_abs_err"] = worst_err
    del l2
    torch.cuda.empty_cache()
    return {"rg_lru_bwd": row}


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


def time_admission(torch, eng, acc):
    """Time each admission of ``eng`` (prefill or replay of a request's
    history, synchronized) into ``acc``: seconds and history tokens (none
    for a re-slotted session, whose checkpointed cache column lands
    instead)."""
    bind = eng._bind_slot

    def timed(s, req):
        carried = req.rid in eng._carried
        torch.cuda.synchronize()
        t0 = time.monotonic()
        bind(s, req)
        torch.cuda.synchronize()
        acc["s"] += time.monotonic() - t0
        if not carried:
            acc["tokens"] += len(req.prompt) + len(req.out) - 1
    eng._bind_slot = timed


def per_token_ms(acc) -> str:
    return (f"{acc['s'] / max(acc['tokens'], 1) * 1e3:.1f} ms a token "
            f"({acc['tokens']} tokens in {acc['s']:.2f} s)")


def serving_prompts(np, vocab_size):
    """The phi4 serving cell's prompts: ``N_REQ`` seeded prompts of
    64-512 tokens (111-387 from this seed)."""
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab_size, size=int(n)).astype(np.int32)
            for n in rng.randint(64, 513, size=N_REQ)]


def serve(torch, ServingEngine, Request, arch, params, prompts, *,
          n_slots, max_seq, max_new, sess=None, kill_at=None,
          admission=None):
    """Serve ``prompts`` on a new engine for ``arch`` (under ``sess``
    when given) until every request is done or ``kill_at`` steps ran,
    timing admissions into ``admission`` when given. Returns (engine,
    requests, tokens, seconds)."""
    eng = ServingEngine.create(arch, params, n_slots=n_slots, max_seq=max_seq,
                               manager=sess.manager if sess else None)
    if admission is not None:
        time_admission(torch, eng, admission)
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


def restore_and_finish(torch, store, policy, params, step, done, ref, *,
                       streaming, label, n_slots=None):
    """Restore the serving checkpoint ``step`` of ``store`` (eagerly, or
    streamed with the KV cache as the cold tier; onto ``n_slots`` slots
    when given, a re-slot: each live session's cache column lands in its
    new slot) and finish every request; raises unless each one's tokens
    equal ``ref`` (the uninterrupted run's), with ``done`` the requests
    that finished before the kill. Returns what the restore took:
    ``restore()``'s return time, the time to the first decoded token
    (the first engine step, admission and the deferred cache merge
    included), the incarnation's timings, ``stream_timings()`` and the
    admissions'."""
    from repro_torch.api import CheckpointSession
    admission = {"s": 0.0, "tokens": 0}
    t0 = time.monotonic()
    sess = CheckpointSession(f"localfs:{store}", policy)
    eng = sess.restore(step, params=params, streaming=streaming,
                       n_slots=n_slots)
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    time_admission(torch, eng, admission)
    back, live = eng.steps, eng.live_requests()
    live_slots = sum(1 for r in eng.slot_req if r is not None)
    eng.step()
    torch.cuda.synchronize()
    first_s = time.monotonic() - t0
    eng.run_until_drained()
    torch.cuda.synchronize()
    got = dict(done)
    got.update({r.rid: list(r.out) for r in live})
    kind = ("streamed" if streaming else "eager") + (
        f", re-slotted onto {n_slots} slots" if n_slots else "")
    if got != ref:
        bad = sorted(k for k in ref if got.get(k) != ref[k])
        raise AssertionError(f"{label} ({kind} restore): restored run "
                             f"diverged from the uninterrupted run on {bad}")
    out = dict(step=back, restore_s=restore_s, first_token_s=first_s,
               live_slots=live_slots, kind=kind, n_live=len(live),
               timings=dict(eng.incarnation.timings),
               stream=eng.incarnation.stream_timings(), admission=admission)
    sess.close()
    del eng, sess
    torch.cuda.empty_cache()
    return out


def describe_restore(r) -> str:
    t = r["timings"]
    msg = (f"restore() returned in {r['restore_s']:.2f} s (materialize "
           f"{t.get('materialize_s', 0):.2f} s, replay "
           f"{t.get('replay_s', 0):.2f} s), first token "
           f"{r['first_token_s']:.2f} s after it began")
    st = r["stream"]
    if st is not None:
        msg += (f"; stream: hot tier {st.get('hot_ready_s', 0):.2f} s, "
                f"fetch {st['fetch_s']:.2f} s, bytes per source "
                f"{st['fetch_bytes_per_source']}, decode busy "
                f"{st['decode_busy_s']:.2f} s ({st['decode_overlap_pct']:.0f}%"
                f" overlapping fetch), hot/cold leaves {st['hot_leaves']}/"
                f"{st['cold_leaves']}, lazy faults {st['lazy_faults']}, "
                f"hedges {st['hedges']} (won {st['hedge_wins']})")
    return msg


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
    prompts = serving_prompts(np, cfg.vocab_size)
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
            # the same step restored twice: eagerly, then streamed (the
            # KV cache the cold tier, landed by the first decode step)
            eager = restore_and_finish(torch, store, policy, params,
                                       "latest", done, ref, streaming=False,
                                       label=label)
            streamed = restore_and_finish(torch, store, policy, params,
                                          eager["step"], done, ref,
                                          streaming=True, label=label)
        finally:
            shutil.rmtree(store, ignore_errors=True)
        after = ops.counts("cuda")
        launches = {k: after[k] - before[k] for k in after}
        outcomes = {k: v - outcomes0[k]
                    for k, v in ops.fused_outcomes().items()}
        saves = max(st["saves"], 1)
        log(f"{label}: killed at step {total_steps // 2}, restored step "
            f"{eager['step']}; eager: {describe_restore(eager)}; all "
            f"{N_REQ} requests token-identical to the uninterrupted run")
        log(f"{label}: streamed restore of step {streamed['step']}: "
            f"{describe_restore(streamed)}; all {N_REQ} requests "
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
# depth cut from 38 to 5 layers (a group of the rglru, rglru, attn
# pattern and its 2 remainder blocks) to keep the script inside its
# 1,200 s limit: replay admission and decode are host-bound per layer
# (20 until the mesh path came, ROADMAP C17)
HYBRID_LAYERS = 5
HYBRID_RUN = f"{HYBRID_ARCH}-layers{HYBRID_LAYERS}"
# PREFILL_32K's 32,768 tokens at a global batch cut from 32 to 2
HYBRID_PREFILL = "prefill_s32768_b2"
HYBRID_SERVE = dict(n_slots=4, max_seq=1024, max_new=24)
HYBRID_N_REQ, HYBRID_PROMPT_LENS = 6, (32, 97)
HYBRID_POLICY = dict(interval=4, chain=4)
# prefill against replay admission, f32 at full width, in the
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


def log_phases(torch, label, fn, calls=3):
    """Log the device time of each kernel that ``fn`` (a wrapper that
    launches several) launches: its mean over its launches in ``calls``
    calls under torch.profiler, after one call outside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = per.get(_kernel_name(e.name), (0.0, 0))
            per[_kernel_name(e.name)] = (ms + e.time_range.elapsed_us() / 1e3,
                                         n + 1)
    log(f"phases {label} ({calls} calls): " + "; ".join(
        f"{name} {ms / n:.4f} ms ({n} launches)"
        for name, (ms, n) in sorted(per.items(), key=lambda kv: -kv[1][0])))


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


def serving_cell(torch, mods, arch, params, prompts, *, serve_kw, policy_kw,
                 label, streamed, profile=None, reslot=None):
    """A serving cell under C/R: ``prompts`` served uninterrupted (then
    ``profile(engine)`` when given), then again under a
    ``CheckpointSession`` with ``policy_kw``, killed two steps before
    half way so the last snapshot falls while the first wave of
    requests is in flight, restored through ``restore("latest")`` and,
    with ``streamed``, that step again streamed, and with ``reslot``
    that step again onto ``reslot`` slots: every request token for
    token as the uninterrupted run. Every kernel count is set to 0 just
    before the uninterrupted run and read after the last restore; raises
    unless the capture kernels launched and no flash, SSD or RG-LRU
    kernel ran (decode and replay admission take none). Returns the
    counts."""
    from repro_torch.api import CheckpointSession, Policy
    from repro_torch.serving.engine import Request, ServingEngine
    _reset_all(mods)
    admission = {"s": 0.0, "tokens": 0}
    eng, reqs, toks_n, dt = serve(torch, ServingEngine, Request, arch,
                                  params, prompts, **serve_kw,
                                  admission=admission)
    ref = {r.rid: list(r.out) for r in reqs}
    total_steps = eng.steps
    if not all(len(v) == serve_kw["max_new"] for v in ref.values()):
        raise AssertionError(f"{label}: the uninterrupted run did not finish")
    log(f"{label} uninterrupted: {total_steps} engine steps, {toks_n} tokens "
        f"in {dt:.2f} s = {toks_n / dt:.1f} tokens/s (admission included); "
        f"admission {per_token_ms(admission)}")
    if profile is not None:
        profile(eng)
    del eng
    kill_at = total_steps // 2 - 2
    policy = Policy(**policy_kw)
    store = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        sess = CheckpointSession(f"localfs:{store}", policy)
        eng, reqs, toks_n, dt = serve(torch, ServingEngine, Request, arch,
                                      params, prompts, **serve_kw, sess=sess,
                                      kill_at=kill_at)
        sess.wait()
        st = dict(sess.stats)
        done = {r.rid: list(r.out) for r in reqs if r.done}
        in_flight = sum(1 for r in eng.slot_req if r is not None)
        sess.close()
        del eng, sess                                    # the kill
        torch.cuda.empty_cache()
        restores = [restore_and_finish(torch, store, policy, params,
                                       "latest", done, ref, streaming=False,
                                       label=label)]
        if streamed:
            restores.append(restore_and_finish(
                torch, store, policy, params, restores[0]["step"], done, ref,
                streaming=True, label=label))
        if reslot:
            restores.append(restore_and_finish(
                torch, store, policy, params, restores[0]["step"], done, ref,
                streaming=False, label=label, n_slots=reslot))
    finally:
        shutil.rmtree(store, ignore_errors=True)
    counts = _all_counts(mods)
    log(f"{label}: {count_written(st)}")
    saves = max(st["saves"], 1)
    log(f"{label}: killed at step {kill_at} ({in_flight} requests in flight),"
        f" {st['saves']} snapshots ({st['chain_links']} chain links), capture "
        f"stall {st['capture_seconds'] / saves * 1e3:.1f} ms per snapshot, "
        f"encode+commit {st['encode_commit_seconds'] / saves:.2f} s, "
        f"dirty/clean chunks {st['dirty_chunks']}/{st['clean_chunks']}, "
        f"bytes written {st['bytes_written']}")
    for r in restores:
        log(f"{label}: {r['kind']} restore of step {r['step']} "
            f"({r['live_slots']} slots live, {r['n_live']} requests live): "
            f"{describe_restore(r)}; admission after it "
            f"{per_token_ms(r['admission'])}; all {len(ref)} requests "
            f"token-identical to the uninterrupted run")
    log(f"{label}: kernel launches {counts}")
    if not all(counts["codec"][k] for k in ("fingerprint", "fused_capture")):
        raise AssertionError(f"{label} missed a capture kernel: "
                             f"{counts['codec']}")
    ran = {k: v for name in ("flash", "ssd", "rg_lru")
           for k, v in counts[name].items() if v}
    if ran:
        raise AssertionError(f"{label}: decode or replay launched {ran}")
    return counts


def hybrid_path(torch, np, mods):
    """The hybrid family's path (see the module docstring): the smoke
    model card against CPU; recurrentgemma-9b at full width and
    ``HYBRID_LAYERS`` deep prefills ``HYBRID_PREFILL`` through the registered ``prefill_step``
    (the RG-LRU kernel once per recurrent layer), its prefill state is
    held against the engine's replay admission, and it serves under C/R
    through kill -> restore("latest"). Every kernel count is set to 0
    just before each run of the path and read just after it."""
    from repro_torch.configs import get_smoke_config, resolve_config
    from repro_torch.configs.registry import get_shape
    from repro_torch.core.split_state import LowerHalf
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.tree import flatten_with_paths, tree_map
    rg = mods["rg_lru"]

    check_hybrid_reference(torch, np, M, rg, get_smoke_config,
                           ServingEngine, Request)
    cfg = resolve_config(HYBRID_RUN)
    t0 = time.monotonic()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(v.numel() for _, v in flatten_with_paths(params))
    n_rglru = _n_rglru(cfg)
    log(f"hybrid path: {HYBRID_ARCH} at full width, depth cut to "
        f"{cfg.n_layers} of {resolve_config(HYBRID_ARCH).n_layers} layers "
        f"({n_rglru} RG-LRU, d_model {cfg.d_model}, width "
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
                                                  HYBRID_RUN, shape.name))
    gen = torch.Generator(device="cuda").manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device="cuda", dtype=torch.int32)
    cache = lower.cache(lower.cache_alloc(HYBRID_RUN, B, S))
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
    # the bf16 model, for the record (ROADMAP C8 at depth): its
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
    serving_cell(torch, mods, HYBRID_RUN, params, prompts,
                 serve_kw=HYBRID_SERVE, policy_kw=HYBRID_POLICY,
                 label="hybrid serving", streamed=False)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"rg_lru_fwd": launches}


SSM_SERVE_ARCH = "mamba2-780m"
# depth cut from 48 to 8 layers to keep the script inside its 1,200 s
# limit (replay admission and the snapshot encode scale with depth; 24
# until the mesh path came, ROADMAP C17)
SSM_SERVE_LAYERS = 8
SSM_SERVE_RUN = f"{SSM_SERVE_ARCH}-layers{SSM_SERVE_LAYERS}"
# replay admission costs ~0.1 s a token at 48 layers, so the prompts
# are short: 6 requests of 16-48 tokens on 4 slots, 24 new tokens each
SSM_SERVE = dict(n_slots=4, max_seq=1024, max_new=24)
SSM_N_REQ, SSM_PROMPT_LENS = 6, (16, 49)
SSM_POLICY = dict(interval=4, chain=4)


def ssm_serving_path(torch, np, mods):
    """The ssm family's serving cell: mamba2-780m at full width and
    ``SSM_SERVE_LAYERS`` deep (params from seeded generators) serves 6 requests on
    4 slots (admission by replay), its decode profiled, then under
    ``Policy(interval=4, chain=4)`` with sparse capture it is killed
    while the first wave is in flight and restored eagerly, then
    streamed (``serving_cell``)."""
    from repro_torch.configs import resolve_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request
    from repro_torch.tree import flatten_with_paths

    cfg = resolve_config(SSM_SERVE_RUN)
    t0 = time.monotonic()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(v.numel() for _, v in flatten_with_paths(params))
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.randint(*SSM_PROMPT_LENS, size=SSM_N_REQ)]
    log(f"ssm serving: {SSM_SERVE_ARCH} at full width, depth cut to "
        f"{cfg.n_layers} of {resolve_config(SSM_SERVE_ARCH).n_layers} layers "
        f"(d_model {cfg.d_model}), {n_params} params counted from the "
        f"tensors (ModelConfig.n_params() says {cfg.n_params()}), made in "
        f"{time.monotonic() - t0:.1f} s; {SSM_N_REQ} requests, prompts "
        f"{[len(p) for p in prompts]} tokens, max_new {SSM_SERVE['max_new']}, "
        f"{SSM_SERVE['n_slots']} slots, max_seq {SSM_SERVE['max_seq']}")
    # the decode profile admits 4 more requests: 4-token prompts keep
    # their replay short
    short = [p[:4] for p in prompts]
    counts = serving_cell(
        torch, mods, SSM_SERVE_RUN, params, prompts, serve_kw=SSM_SERVE,
        policy_kw=SSM_POLICY, label="ssm serving", streamed=True,
        profile=lambda eng: profile_decode(torch, np, eng, Request, short))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


ENCDEC_ARCH = "whisper-base"
# whisper's published text context is 448 tokens (arXiv:2212.04356);
# admission is by replay, as in the reference engine
ENCDEC_SERVE = dict(n_slots=4, max_seq=448, max_new=24)
ENCDEC_N_REQ, ENCDEC_PROMPT_LENS = 6, (16, 49)
ENCDEC_POLICY = dict(interval=4, chain=4)
ENCDEC_F32_REL = 1e-4          # decode after prefill vs forward_train


def check_encdec_reference(torch, np, M, get_smoke_config):
    """whisper-base-smoke in f32, card against CPU: ``prefill(frames=)``
    of 2 prompts, then 8 greedy ``decode_step``s; the logits of every
    step and every cache leaf (the cross cache too) within 1e-5, the
    same tokens."""
    from repro_torch.tree import flatten_with_paths, tree_map
    cfg = get_smoke_config(ENCDEC_ARCH).replace(dtype="float32")
    p_cpu = M.init_params(cfg, seed=3, device="cpu")
    rng = np.random.RandomState(4)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 12))
                            .astype(np.int32))
    frames = torch.from_numpy(rng.randn(2, cfg.encoder_seq, cfg.frontend_dim)
                              .astype(np.float32))
    runs = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev, copy=True), p_cpu)
        cache = M.init_cache(cfg, 2, 32, device=dev)
        last, _ = M.prefill(cfg, params, toks.to(dev), cache,
                            frames=frames.to(dev))
        logits, tokens = [last.cpu()], []
        for pos in range(12, 20):
            nxt = torch.argmax(logits[-1], dim=-1).to(torch.int32)[:, None]
            tokens.append(nxt)
            out, _ = M.decode_step(cfg, params, cache, nxt.to(dev),
                                   torch.full((2,), pos, dtype=torch.int32,
                                              device=dev))
            logits.append(out.cpu())
        runs[dev] = (logits, tokens,
                     {p: t.to("cpu", copy=True)
                      for p, t in flatten_with_paths(cache)})
    worst = 0.0
    for a, b in zip(runs["cpu"][0], runs["cuda"][0]):
        worst = max(worst, float((a - b).abs().max()))
    for path, a in runs["cpu"][2].items():
        worst = max(worst, float((a.float()
                                  - runs["cuda"][2][path].float()).abs().max()))
    same = all(torch.equal(a, b) for a, b in zip(runs["cpu"][1],
                                                 runs["cuda"][1]))
    cross = float(runs["cuda"][2]["['cross'][0]"].abs().max())
    log(f"encdec small reference: {ENCDEC_ARCH}-smoke f32 prefill(frames=) "
        f"+ 8 greedy decode steps on the card against the CPU: max abs "
        f"diff {worst:.2e} over the logits and every cache leaf (limit "
        f"1e-5; the cross cache's max |k| {cross:.3f}), same tokens: {same}")
    if not cross > 0:
        raise AssertionError("prefill(frames=) left the cross cache empty")
    if worst > 1e-5 or not same:
        raise AssertionError("whisper-base-smoke: card and CPU disagree")


def encdec_path(torch, np, mods):
    """The encoder-decoder's path: the smoke model card against CPU
    (``check_encdec_reference``); whisper-base at full size in f32, a
    ``prefill(frames=)`` of 2 prompts (the flash kernels: encoder and
    cross-attention, 12 launches) and 16 greedy decode steps held
    against ``forward_train`` over the extended sequence with the same
    frames (the no-cache path: encoder, decoder and cross-attention
    through the flash kernels) in the 2-norm; then whisper-base in bf16
    serves 6 requests of 16-48 tokens on 4 slots (replay admission, the
    cross cache left at its zero init as the reference engine leaves
    it), its decode profiled, killed mid first wave and restored eagerly,
    then streamed (``serving_cell``)."""
    from repro_torch.configs import get_smoke_config, resolve_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request
    from repro_torch.tree import flatten_with_paths, tree_map
    fa = mods["flash"]

    check_encdec_reference(torch, np, M, get_smoke_config)
    cfg = resolve_config(ENCDEC_ARCH)
    t0 = time.monotonic()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(v.numel() for _, v in flatten_with_paths(params))
    log(f"encdec path: {ENCDEC_ARCH} full width and depth "
        f"({cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder layers, "
        f"d_model {cfg.d_model}, {cfg.encoder_seq} encoder frames), "
        f"{n_params} params counted from the tensors (ModelConfig.n_params()"
        f" says {cfg.n_params()}), made in {time.monotonic() - t0:.1f} s")

    # --- the cache path against the no-cache path, f32, full size
    c32 = cfg.replace(dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    rng = np.random.RandomState(5)
    n_prompt, n_dec = 32, 16
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, n_prompt))
                            .astype(np.int32)).cuda()
    frames = torch.from_numpy(rng.randn(2, cfg.encoder_seq, cfg.frontend_dim)
                              .astype(np.float32)).cuda()
    cache = M.init_cache(c32, 2, ENCDEC_SERVE["max_seq"], "cuda")
    _reset_all(mods)
    t0 = time.monotonic()
    last, _ = M.prefill(c32, p32, toks, cache, frames=frames)
    torch.cuda.synchronize()
    prefill_ms = (time.monotonic() - t0) * 1e3
    pre_counts = fa.counts("cuda")
    want = {"flash_fwd": cfg.n_encoder_layers + cfg.n_layers, "flash_dq": 0,
            "flash_dkv": 0}
    if pre_counts != want:
        raise AssertionError(f"prefill(frames=) flash launches {pre_counts},"
                             f" expected {want}")
    seq, steps = toks, [last]
    for pos in range(n_prompt, n_prompt + n_dec):
        nxt = torch.argmax(steps[-1], dim=-1).to(torch.int32)[:, None]
        seq = torch.cat([seq, nxt], dim=1)
        out, _ = M.decode_step(c32, p32, cache, nxt,
                               torch.full((2,), pos, dtype=torch.int32,
                                          device="cuda"))
        steps.append(out)
    if fa.counts("cuda") != pre_counts:
        raise AssertionError("decode_step launched a flash kernel")
    with torch.no_grad():
        full, _ = M.forward_train(c32, p32, {"tokens": seq,
                                             "frames": frames})
    rels = [_rel(got, full[:, n_prompt - 1 + i])
            for i, got in enumerate(steps[:-1])]
    cross_max = float(cache["cross"][0].abs().max())
    log(f"encdec cache vs no-cache: {ENCDEC_ARCH} f32, prefill(frames=) of "
        f"2 x {n_prompt} tokens in {prefill_ms:.1f} ms ({pre_counts}), then "
        f"{n_dec} greedy decode steps, against forward_train over the "
        f"extended {seq.shape[1]} tokens with the same frames: logits worst "
        f"{max(rels):.2e} in the 2-norm (limit {ENCDEC_F32_REL:g}); cross "
        f"cache filled (max |k| {cross_max:.3f})")
    if not max(rels) <= ENCDEC_F32_REL or not cross_max > 0:
        raise AssertionError(f"whisper-base: decode after prefill is "
                             f"{max(rels):.2e} from forward_train")
    del p32, cache, full, steps, seq, frames
    torch.cuda.empty_cache()

    # --- serving under C/R
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.randint(*ENCDEC_PROMPT_LENS, size=ENCDEC_N_REQ)]
    log(f"encdec serving: {ENCDEC_N_REQ} requests, prompts "
        f"{[len(p) for p in prompts]} tokens, max_new "
        f"{ENCDEC_SERVE['max_new']}, {ENCDEC_SERVE['n_slots']} slots, "
        f"max_seq {ENCDEC_SERVE['max_seq']}")

    def profile(eng):
        profile_decode(torch, np, eng, Request, [p[:4] for p in prompts])
        if any(bool(c.any()) for c in eng.cache["cross"]):
            raise AssertionError("serving wrote the cross cache")
        log("encdec serving: the cross cache is still zero after serving, "
            "as the reference engine leaves it (ROADMAP C21)")

    counts = serving_cell(
        torch, mods, ENCDEC_ARCH, params, prompts, serve_kw=ENCDEC_SERVE,
        policy_kw=ENCDEC_POLICY, label="encdec serving", streamed=True,
        profile=profile)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# the moe family's serving cell: llama4-scout-17b-a16e at full width
# (d_model 5,120, 16 experts of 8,192 and a shared one, vocab 202,048), its
# depth cut from 48 to 8 layers by the card's memory (19.7e9 bf16 params,
# 39.4 GB; init draws each stacked leaf in f32, the [8, 16, 5120, 8192]
# experts' twice over), served as phi4-mini-3.8b is: 6 prompts of 64-512
# tokens on 4 slots of 1,024, 48 new tokens each, admission by prefill
MOE_ARCH, MOE_LAYERS = "llama4-scout-17b-a16e", 8
MOE_SERVE = dict(n_slots=N_SLOTS, max_seq=MAX_SEQ, max_new=MAX_NEW)
MOE_POLICY = dict(interval=4, chain=4)
MOE_RESLOT = 3
# kimi-k2-1t-a32b at full width (d_model 7,168, 384 experts of 2,048,
# top-8, a shared expert, vocab 163,840), one of its 61 layers (19.4e9
# params, 38.8 GB bf16): 4 prompts of 16-48 tokens on 4 slots of 256, 8
# new tokens each, served twice, then killed and restored; a snapshot
# every step, so the two before the kill (at step 2 of ~8) make a chain
# link, which the capture kernels write
TOPK_ARCH, TOPK_LAYERS = "kimi-k2-1t-a32b", 1
TOPK_SERVE = dict(n_slots=4, max_seq=256, max_new=8)
TOPK_N_REQ, TOPK_PROMPT_LENS = 4, (16, 49)
TOPK_POLICY = dict(interval=1, chain=4)
# the moe family's training, at smoke size on the card (full width does
# not fit the run: one llama4-scout layer's snapshot is 42.7 GB)
MOE_TRAIN_CELLS = tuple(
    dict(arch=a, job=a + "-smoke", shape="train_s256_b8", kernels="flash",
         reference_shape="train_s64_b2", reference="grads")
    for a in (MOE_ARCH, TOPK_ARCH))


class MoeDrops:
    """Counts the (token, choice) pairs the moe dispatch sends to its
    drop slot (``models.moe._slots`` wrapped), apart for decode calls
    (fewer than 8 tokens: prefill buckets hold at least 8) and prefill
    calls; the sums stay on the card until ``read``."""

    def __init__(self, MOE):
        self.MOE, self.plain = MOE, MOE._slots
        self.sums = {"decode": [], "prefill": []}

    def __enter__(self):
        def counted(idx, n_experts, capacity):
            slots = self.plain(idx, n_experts, capacity)
            kind = "decode" if idx.shape[0] < 8 else "prefill"
            self.sums[kind].append((slots == n_experts * capacity).sum())
            return slots
        self.MOE._slots = counted
        return self

    def __exit__(self, *exc):
        self.MOE._slots = self.plain

    def read(self):
        return {k: int(sum(int(t) for t in v)) for k, v in self.sums.items()}

    def calls(self):
        return {k: len(v) for k, v in self.sums.items()}


def _init_logged(torch, M, cfg, label):
    """Seeded bf16 params of ``cfg`` on the card, with their count, the
    time they took and the peak device memory of the init."""
    from repro_torch.tree import flatten_with_paths
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n = sum(v.numel() for _, v in flatten_with_paths(params))
    log(f"{label}: {cfg.name} at full width, {cfg.n_layers} layers (d_model "
        f"{cfg.d_model}, {cfg.n_experts} experts of "
        f"{cfg.resolved_moe_d_ff}, top-{cfg.experts_per_token}, "
        f"{cfg.n_shared_experts} shared, vocab {cfg.vocab_size}), {n} params "
        f"counted from the tensors (ModelConfig.n_params() says "
        f"{cfg.n_params()}), made in {time.monotonic() - t0:.1f} s; peak "
        f"device memory of the init "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB held")
    return params


def _flat_counts(counts):
    return {k: v for per in counts.values() for k, v in per.items()}


def moe_serving_path(torch, np, mods):
    """The moe family's serving cell (llama4-scout-17b-a16e-layers8, see
    ``MOE_ARCH``): served uninterrupted, its decode profiled, then under
    ``Policy(interval=4, chain=4)`` with sparse capture killed while the
    first wave is in flight and restored eagerly, streamed and re-slotted
    onto 3 slots (``serving_cell``), every request token for token.
    Raises unless no decode call dropped a choice."""
    from repro_torch.configs import resolve_config
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.serving.engine import Request
    arch = f"{MOE_ARCH}-layers{MOE_LAYERS}"
    params = _init_logged(torch, M, resolve_config(arch), "moe serving")
    vocab = resolve_config(arch).vocab_size
    prompts = serving_prompts(np, vocab)
    log(f"moe serving: {N_REQ} requests, prompts {[len(p) for p in prompts]}"
        f" tokens, max_new {MOE_SERVE['max_new']}, {MOE_SERVE['n_slots']} "
        f"slots, max_seq {MOE_SERVE['max_seq']}")
    torch.cuda.reset_peak_memory_stats()
    with MoeDrops(MOE) as drops:
        counts = serving_cell(
            torch, mods, arch, params, prompts, serve_kw=MOE_SERVE,
            policy_kw=MOE_POLICY, label="moe serving", streamed=True,
            reslot=MOE_RESLOT,
            profile=lambda eng: profile_decode(torch, np, eng, Request,
                                               prompts))
    dropped = drops.read()
    log(f"moe serving: choices sent to the drop slot over the cell: "
        f"{dropped} in {drops.calls()} moe calls; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if dropped["decode"]:
        raise AssertionError(f"moe decode dropped {dropped['decode']} "
                             "choices at 4 slots (capacity 8)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return _flat_counts(counts)


def moe_topk_path(torch, np, mods):
    """kimi-k2-1t-a32b-layers1 (see ``TOPK_ARCH``): 4 requests served
    twice, the tokens and the final KV cache the same bits both times,
    the decode step timed, the choices prefill dropped counted (decode
    must drop none); then killed and restored eagerly, token for token
    (``serving_cell``). No flash kernel runs: serving takes attention's
    cache branch (head dim 112 has no flash kernel, ROADMAP B12)."""
    from repro_torch.configs import resolve_config
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.tree import flatten_with_paths
    arch = f"{TOPK_ARCH}-layers{TOPK_LAYERS}"
    cfg = resolve_config(arch)
    params = _init_logged(torch, M, cfg, "moe top-k")
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.randint(*TOPK_PROMPT_LENS, size=TOPK_N_REQ)]
    log(f"moe top-k: {TOPK_N_REQ} requests, prompts "
        f"{[len(p) for p in prompts]} tokens, max_new "
        f"{TOPK_SERVE['max_new']}, {TOPK_SERVE['n_slots']} slots, max_seq "
        f"{TOPK_SERVE['max_seq']}")
    _reset_all(mods)
    runs = []
    for i in range(2):
        with MoeDrops(MOE) as drops:
            eng, reqs, toks, dt = serve(torch, ServingEngine, Request, arch,
                                        params, prompts, **TOPK_SERVE)
        runs.append(({r.rid: list(r.out) for r in reqs},
                     {p: t.to("cpu", copy=True)
                      for p, t in flatten_with_paths(eng.cache)}))
        log(f"moe top-k run {i + 1}: {eng.steps} engine steps, {toks} "
            f"tokens in {dt:.2f} s (admission included); choices sent to "
            f"the drop slot {drops.read()} in {drops.calls()} moe calls")
        if drops.read()["decode"]:
            raise AssertionError("moe top-k decode dropped a choice")
        del eng
    same_cache = all(torch.equal(a, runs[1][1][p])
                     for p, a in runs[0][1].items())
    if runs[0][0] != runs[1][0] or not same_cache:
        raise AssertionError(f"moe top-k: two runs differ (tokens equal: "
                             f"{runs[0][0] == runs[1][0]}, KV cache bits "
                             f"equal: {same_cache})")
    log(f"moe top-k: the two runs' tokens and final KV cache "
        f"({len(runs[0][1])} leaves) are the same bits")
    counts = serving_cell(
        torch, mods, arch, params, prompts, serve_kw=TOPK_SERVE,
        policy_kw=TOPK_POLICY, label="moe top-k serving", streamed=False,
        profile=lambda eng: profile_decode(torch, np, eng, Request, prompts))
    log(f"moe top-k: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return _flat_counts(counts)


def moe_train_smoke(torch, np, mods):
    """The moe family's training on the card, at smoke size, under
    deterministic algorithms (``train_path`` per ``MOE_TRAIN_CELLS``):
    one f32 step against the CPU's (``check_train_reference``: the
    gradients, and each layer's routing where the k-th and (k+1)-th
    probabilities lie more than 1e-5 apart), then 8 steps, a snapshot
    after step 6, a drop, ``restore("latest")`` and 2 steps: losses and
    state digest bit-identical. Returns the flash launches summed."""
    total = {}
    for cell in MOE_TRAIN_CELLS:
        for k, n in train_path(torch, np, mods, cell).items():
            total[k] = total.get(k, 0) + n
    return total


def check_train_reference(torch, np, kerns, arch, shape_key, mode):
    """One f32 train step of ``arch``'s smoke model on the card (its
    kernels: every module of ``kerns``' counts must move) against the same step on the
    CPU (the plain versions): TF32 off, so the two differ only in the
    order of their sums. Loss and grad norm within 1e-5 relative; then,
    ``mode`` "state": params 1e-6 absolute at lr 3e-4 (a step moves a
    param by ~lr), moments 1e-4 relative (atol 1e-8), against the CPU
    step with the softmax's exponential that the card's step takes,
    ``torch.exp`` (the model's ``exp_stable`` is ``exp_f32`` on a CPU
    tensor): AdamW's first step turns a gradient element of ~1e-9 — the
    softmax-invariant direction of the key projection, zero but for
    rounding — into a param move of up to ~lr, so the two exponentials'
    rounding alone moves ``attn.wk`` by ~1e-6 on the CPU. The distance
    to the CPU step under ``exp_f32`` is logged; ``mode`` "grads" (the ssm
    family): each leaf's gradient in the 2-norm within ``R.tolerance``
    of the CPU step's own spread between the model's scan chunk and a
    quarter of it. The post-step state is not held elementwise there:
    AdamW's first step moves a param by lr * g / (|g| + eps), so a
    gradient element of ~1e-9 that reblocking the plain scan alone moves
    by a few percent moves its param by more than 1e-6; the log counts
    such params for the CPU against itself and for the card. The
    encoder-decoder takes ``mode`` "grads" too, with the spread between
    the CPU step under ``exp_f32`` and under ``torch.exp``: AdamW's
    first step moves its encoder's key projection by up to 2.4e-5 on an
    H100 against the CPU (whisper-base-smoke, seq 64), past "state"'s
    1e-6, from gradient elements near zero."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.registry import get_shape
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels.ssd_scan import ref as R
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
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
    batch = TokenPipeline(DataConfig(
        seed=7, vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
        global_batch=2, n_shards=2,
        frames=cfg.encoder_seq if cfg.is_encoder_decoder else 0,
        frame_dim=cfg.frontend_dim)).batch_at(0)
    p_cpu = M.init_params(cfg, seed=3, device="cpu")

    def run(dev):
        params = tree_map(lambda t: t.to(dev, copy=True), p_cpu)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        grads, routes = {}, []
        if mode == "grads":
            with RouteLog(torch, MOE) as rl:
                _, g = value_and_grad(loss_fn, params, b)
            routes = rl.calls[:cfg.n_layers]    # the forward's, not remat's
            grads = {p: t.cpu() for p, t in flatten_with_paths(g)}
        opt = init_opt_state(params, AdamWConfig())
        params, opt, met = step_fn(params, opt, b, 150, torch.tensor(1.0))
        return (met, {p: t.cpu() for p, t in flatten_with_paths(params)},
                {p: t.cpu() for p, t in flatten_with_paths(opt)}, grads,
                routes)

    res = {}
    for dev in ("cpu", "cuda"):
        before = [kern.counts(dev) for kern in kerns]
        res[dev] = run(dev)
        ran = {k: kern.counts(dev)[k] - b[k]
               for kern, b in zip(kerns, before) for k in kern.KERNELS}
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
        from unittest import mock
        from repro_torch.models import layers as L
        with mock.patch.object(L, "exp_stable", torch.exp):
            want = run("cpu")
        diff = lambda a, b: float((a.float() - b.float()).abs().max())
        worst, own = 0.0, 0.0
        for i, (rtol, atol) in ((1, (0, 1e-6)), (2, (1e-4, 1e-8))):
            for path, a in want[i].items():
                b = res["cuda"][i][path]
                worst = max(worst, diff(a, b))
                own = max(own, diff(res["cpu"][i][path], b))
                if not torch.allclose(a.float(), b.float(), rtol=rtol,
                                      atol=atol):
                    raise AssertionError(
                        f"train step state {path}: card and CPU disagree "
                        f"(max abs diff {diff(a, b):.2e}, atol {atol:.0e})")
        log(f"{head}, max abs state diff {worst:.2e} against the CPU step "
            f"under torch.exp ({own:.2e} against it under exp_f32)")
        return
    if cfg.family == "ssm":
        chunk = SSM.CHUNK
        SSM.CHUNK = chunk // 4
        try:
            alt = run("cpu")
        finally:
            SSM.CHUNK = chunk
        alt_label = f"the CPU at chunk {chunk // 4}"
        spread_of = f"the CPU's chunk {chunk} vs {chunk // 4} spread"
    else:
        from unittest import mock
        from repro_torch.kernels.rg_lru import ref as RG
        from repro_torch.models import layers as L
        with mock.patch.object(L, "exp_stable", torch.exp), \
                mock.patch.object(MOE, "exp_stable", torch.exp), \
                mock.patch.object(RG, "exp_stable", torch.exp):
            alt = run("cpu")
        alt_label = "the CPU under torch.exp"
        spread_of = "the CPU's exp_f32 vs torch.exp spread"
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
    log(f"{head}; gradients per leaf within 4 x {spread_of} (at least "
        f"1e-4) in the 2-norm, worst {path} {err:.2e} (spread "
        f"{spread:.2e}, {share:.2f} of its limit); params off by more than "
        f"1e-6 after the step: {alt_label} {off['cpu']}, card "
        f"{off['card']} of {sum(t.numel() for t in res['cpu'][1].values())}")
    if bad:
        raise AssertionError(f"train step gradients past the limit: {bad}")
    if cfg.n_experts:
        check_routes(torch, cfg, res["cpu"][4], res["cuda"][4])
        check_grads_repeat(torch, cfg, loss_fn, value_and_grad, p_cpu,
                           batch)


class RouteLog:
    """Records each ``models.moe.route`` call's expert ids and router
    probabilities (on the host) while it is entered."""

    def __init__(self, torch, MOE):
        self.torch, self.MOE = torch, MOE
        self.plain, self.calls = MOE.route, []

    def __enter__(self):
        def logged(cfg, w, x):
            out = self.plain(cfg, w, x)
            with self.torch.no_grad():
                probs = (x.float() @ w).softmax(-1)
            self.calls.append((out[1].cpu(), probs.cpu()))
            return out
        self.MOE.route = logged
        return self

    def __exit__(self, *exc):
        self.MOE.route = self.plain


def check_routes(torch, cfg, cpu, card):
    """Each layer's expert ids on the card equal the CPU's for every
    token whose k-th and (k+1)-th router probabilities (the CPU's) lie
    more than 1e-5 apart; the near ties are counted and logged."""
    k, near, tokens = cfg.experts_per_token, 0, 0
    for layer, ((ci, cp), (gi, _)) in enumerate(zip(cpu, card)):
        top = torch.sort(cp, dim=-1, descending=True).values
        gap = top[..., k - 1] - top[..., k]
        ok = gap > 1e-5
        near += int((~ok).sum())
        tokens += ok.numel()
        if not torch.equal(ci[ok], gi[ok]):
            raise AssertionError(f"layer {layer}: the card routed "
                                 f"{int((ci[ok] != gi[ok]).any(-1).sum())} "
                                 "tokens apart from the CPU")
        flips = int((ci[~ok] != gi[~ok]).any(-1).sum())
        if flips:
            log(f"routing: layer {layer}: {flips} near-tied tokens routed "
                "apart on the card")
    log(f"routing: {len(cpu)} layers x {tokens // max(len(cpu), 1)} tokens,"
        f" top-{k} of {cfg.n_experts}: the card's expert ids are the CPU's "
        f"wherever the k-th and (k+1)-th probabilities lie more than 1e-5 "
        f"apart ({near} near ties left out)")


def check_grads_repeat(torch, cfg, loss_fn, value_and_grad, p_cpu, batch):
    """Under ``torch.use_deterministic_algorithms(True)`` the card's
    gradients (the dispatch's masked write and the combine's gather
    backward among them) come out the same bits twice."""
    from repro_torch.tree import flatten_with_paths, tree_map
    params = tree_map(lambda t: t.to("cuda", copy=True), p_cpu)
    b = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    torch.use_deterministic_algorithms(True)
    try:
        runs = [dict(flatten_with_paths(value_and_grad(loss_fn, params,
                                                       b)[1]))
                for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(False)
    same = [p for p, g in runs[0].items() if torch.equal(g, runs[1][p])]
    if len(same) != len(runs[0]):
        raise AssertionError(f"{cfg.name}: gradients differ between two "
                             f"runs on {sorted(set(runs[0]) - set(same))}")
    log(f"{cfg.name}: under deterministic algorithms the card's gradients "
        f"are the same bits twice ({len(same)} leaves)")


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


def calls_per_step(cfg, name: str) -> Tuple[int, int]:
    """Calls a train step makes to kernel module ``name``'s wrappers,
    (under remat, outside it): one per layer that runs it — for the
    encoder-decoder's flash kernels one per encoder layer and two per
    decoder layer (self- and cross-attention), for the hybrid one per
    recurrent (``rg_lru``) or attention (``flash``) block, those of its
    block groups under remat and its remainder blocks outside it."""
    if cfg.family == "hybrid":
        kind = "rglru" if name == "rg_lru" else "attn"
        n_groups, rem = divmod(cfg.n_layers, len(cfg.block_pattern))
        return (n_groups * cfg.block_pattern.count(kind),
                cfg.block_pattern[:rem].count(kind))
    if cfg.is_encoder_decoder and name == "flash":
        return cfg.n_encoder_layers + 2 * cfg.n_layers, 0
    return cfg.n_layers, 0


def check_full_depth_refused(torch, arch, shape_key):
    """The model at full depth does not fit one card: its Trainer raises
    while it plans, before any param or moment is allocated, and the
    message gives the bytes and names ROADMAP A9."""
    from repro_torch.train.loop import Trainer, TrainJob
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        Trainer(TrainJob(arch, shape_key))
    except MemoryError as e:
        msg = str(e)
    else:
        raise AssertionError(f"{arch} at full depth built a trainer on one "
                             "card")
    after = torch.cuda.memory_allocated()
    if "A9" not in msg or " GB" not in msg or after != before:
        raise AssertionError(f"{arch}: refused with {msg!r}, device memory "
                             f"{before} -> {after} bytes")
    log(f"train path: {arch} at full depth refused before allocating "
        f"(device memory {after} bytes, as before): {msg}")


def train_path(torch, np, kernel_mods, cell):
    """A training path (see the module docstring): ``cell`` is one of
    ``TRAIN_CELLS``; each of its kernel modules ``cell["kernels"]`` must
    launch its first kernel twice per call site and step (the forward,
    again under remat) and every other kernel once (``calls_per_step``).
    Every kernel count is set to 0 just before the run and read just
    after it."""
    from repro_torch.api import CheckpointSession, Policy
    from repro_torch.configs import resolve_config
    from repro_torch.configs.registry import get_shape
    from repro_torch.train.loop import Trainer, TrainJob

    from repro_torch.models.model import param_count

    arch, shape_key, steps = cell["arch"], cell["shape"], TRAIN_STEPS
    names = ((cell["kernels"],) if isinstance(cell["kernels"], str)
             else tuple(cell["kernels"]))
    check_train_reference(torch, np, [kernel_mods[k] for k in names], arch,
                          cell["reference_shape"], cell["reference"])
    if cell.get("refuse_full_depth"):
        check_full_depth_refused(torch, arch, shape_key)
    job_arch = cell.get("job") or arch + (
        f"-layers{cell['layers']}" if "layers" in cell else "")
    cfg = resolve_config(job_arch)
    shape = get_shape(shape_key)
    tokens = shape.global_batch * shape.seq_len
    n = param_count(cfg)                        # the template's leaves
    snap = n * (2 + 4 + 4)                      # bf16 params, f32 mu and nu
    store = tempfile.mkdtemp(prefix="chip_smoke_train_")
    disk, mem = shutil.disk_usage(store).free, _mem_available()
    depth = (f"depth cut to {cfg.n_layers} of "
             f"{resolve_config(arch).n_layers} layers" if "layers" in cell
             else f"full depth, {cfg.n_layers} layers")
    if cfg.is_encoder_decoder:
        depth += f" + {cfg.n_encoder_layers} encoder layers"
    size = (f"{cfg.n_layers} layers" if "job" in cell
            else f"at full width, {depth}")
    log(f"train path: {job_arch} {size} (d_model "
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
        UNINTERRUPTED[(job_arch, shape_key)] = (list(losses), want)
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
    launched = {k: n for name in names for k, n in counts[name].items()}
    run_steps = steps + steps - back
    expect = {k: ((2 if i == 0 else 1) * calls_per_step(cfg, name)[0]
                  + calls_per_step(cfg, name)[1]) * run_steps
              for name in names
              for i, k in enumerate(kernel_mods[name].KERNELS)}
    if launched != expect:
        raise AssertionError(f"{arch}: kernel launches {launched}, expected "
                             f"{expect} (forward twice per layer and step "
                             f"under remat, the rest once)")
    log(f"train path: losses and state digest {got} bit-identical to the "
        f"uninterrupted run; kernel launches {launched} "
        f"({ {name: calls_per_step(cfg, name) for name in names} } kernel "
        f"calls a step under remat and outside it x {run_steps} steps; the "
        f"forward twice "
        f"under remat: per step "
        f"{ {k: n // run_steps for k, n in launched.items()} }"
        f"); all counts {counts}")
    if "flash" in names and cfg.resolved_head_dim == 256:
        # the kernels line's head-dim-256 rows (check_flash)
        launched.update({f"{k}_hd256": counts["flash"][k]
                         for k in kernel_mods["flash"].KERNELS})
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
    the last step. Then the same step is restored streamed and takes 2
    steps, its counts set to 0 just before: it must be the eager
    restore's bits (moments, params, step, cursor, losses) with one
    dequantize launch per codec leaf and no plain or host codec call."""
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

    def off_plain(trainer):
        """The codec leaves of ``trainer``'s moments that are not the
        plain dequantize(quantize(clone)) bit for bit."""
        bad = []
        for p, v in flatten_with_paths(trainer.upper.get("opt_state")):
            if p in clone:
                q, sc = ops.quantize_plain(clone[p])
                want = ops.dequantize_plain(q, sc)[:v.numel()].view(v.shape)
                if not torch.equal(v.view(torch.int32),
                                   want.view(torch.int32)):
                    bad.append(p)
                del q, sc, want
        return bad

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
        worst = off_plain(tr)
        back = (tr.params_digest(), tr.checkpoint_step(),
                int(tr.upper.get("data_cursor")))
        coded = [tr.train_steps(1)["loss"] for _ in range(2)]
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        sess2.close()
        del tr, sess2
        gc.collect()
        torch.cuda.empty_cache()
        counts = _all_counts(kernel_mods)
        # the same step again, streamed: opt_state is the cold tier,
        # fetched from the 4 virtual hosts while params bind; counts set
        # to 0 just before this restore, read after its 2 steps
        _reset_all(kernel_mods)
        t0 = time.monotonic()
        sess3 = CheckpointSession(spec, policy)
        tr = sess3.restore(step, expect_kind="train", streaming=True)
        torch.cuda.synchronize()
        stream_restore_s = time.monotonic() - t0
        s_timings = dict(tr.incarnation.timings)
        stream = tr.incarnation.stream_timings()
        s_codec, s_plain = ops.counts("cuda"), ops.counts("cpu")
        s_worst = off_plain(tr)
        del clone
        s_back = (tr.params_digest(), tr.checkpoint_step(),
                  int(tr.upper.get("data_cursor")))
        s_coded = [tr.train_steps(1)["loss"] for _ in range(2)]
        torch.cuda.synchronize()
        sess3.close()
        del tr, sess3
        s_counts = _all_counts(kernel_mods)
    finally:
        for k, fn in originals.items():
            setattr(R, k, fn)
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(store, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
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
    log(f"codec path: streamed restore of step {s_back[1]} in "
        f"{stream_restore_s:.1f} s (eager {restore_s:.1f} s; materialize "
        f"{s_timings.get('materialize_s', 0):.1f} s to the hot tier, replay "
        f"{s_timings.get('replay_s', 0):.2f} s, rebind "
        f"{s_timings.get('rebind_s', 0):.1f} s); stream: fetch "
        f"{stream['fetch_s']:.1f} s, bytes per source "
        f"{stream['fetch_bytes_per_source']}, MB/s per source "
        f"{ {k: round(v, 1) for k, v in stream.get('fetch_mb_s_per_source', {}).items()} }, "
        f"decode busy {stream['decode_busy_s']:.1f} s "
        f"({stream['decode_overlap_pct']:.0f}% overlapping fetch), hot/cold "
        f"leaves {stream['hot_leaves']}/{stream['cold_leaves']}, lazy faults "
        f"{stream['lazy_faults']}, hedges {stream['hedges']}; losses after "
        f"it {s_coded}; codec launches {s_codec}, plain calls {s_plain}, "
        f"host reference calls {host_calls}; all counts {s_counts}")
    if s_codec["dequantize"] != n_leaves or s_codec["quantize"] \
            or any(s_plain.values()) or any(host_calls.values()):
        raise AssertionError(f"streamed restore's codec route: {s_codec} for "
                             f"{n_leaves} leaves, plain {s_plain}, host "
                             f"{host_calls}")
    if s_worst:
        raise AssertionError(f"streamed restore: moments differ from the "
                             f"plain dequantize(quantize(m)): {s_worst[:4]}")
    if s_back != back or s_coded != coded:
        raise AssertionError(f"streamed restore: params/step/cursor {s_back} "
                             f"and losses {s_coded} != the eager restore's "
                             f"{back}, {coded}")
    if len(stream["fetch_bytes_per_source"]) != CODEC_STORE_HOSTS:
        raise AssertionError(f"streamed fetch did not fan out over the "
                             f"{CODEC_STORE_HOSTS} hosts: "
                             f"{stream['fetch_bytes_per_source']}")
    expect_ssd = {"ssd_fwd": 2 * cfg.n_layers * 2, "ssd_bwd": cfg.n_layers * 2}
    if s_counts["ssd"] != expect_ssd:
        raise AssertionError(f"streamed: SSD launches {s_counts['ssd']}, "
                             f"expected {expect_ssd}")
    log(f"codec path: the streamed restore is bit-identical to the eager one "
        f"(moments, params, step, cursor, the 2 losses), with "
        f"{s_codec['dequantize']} dequantize launches")
    return {k: codec_counts[k] for k in ("quantize", "dequantize")}


# the failure loop on the card, driven through the launchers'
# own functions (``repro_torch.launch.serve._run_supervised`` /
# ``_run_migrated``, ``repro_torch.launch.train._run_supervised``) over a
# simulated 4-host world: phi4-mini-3.8b at full width (16 of 32 layers) in bf16
# serves 6 seeded prompts of 8-32 tokens on 4 slots of 64, 24 new tokens
# each, into a replicated ``sharded:`` store of 4 virtual hosts with a
# chained snapshot every 4 engine steps, under each policy below with
# host 2 killed at engine step 8; then once more moved live onto a 3-slot
# engine at step 6 (``--migrate-to 3@6``), each session's cache column
# carried. The cache is cut to 64 positions so that the one-thread
# snapshot encode keeps pace with the decode: at the phi4 serving cell's
# shape (4 x 1024, prompts of 111-387 tokens) a run takes 49-62 s
# against 7 s uninterrupted and the MTTRs are 6.6-8.8 s (PERF.md §5, an
# open defect, ROADMAP C24); here they measure the failure loop without
# that backlog
SUPERVISE_SERVE = dict(n_slots=4, max_seq=64, max_new=24)
SUPERVISE_N_REQ, SUPERVISE_PROMPT_LENS = 6, (8, 33)
# phi4-mini-3.8b at full width, depth cut from 32 to 16 layers since the
# mesh path came (ROADMAP C17): its decode is host-bound per layer
SUPERVISE_ARCH = f"{ARCH}-layers16"
SUPERVISE_POLICY = dict(interval=4, chain=4)
SUPERVISE_KILL = "2@8"
SUPERVISE_RUNS = (
    # label, the launcher's flags, the decision, slots after it
    ("hot spare", ["--spares", "1"], "hot_spare", 4),
    ("shrink", ["--spares", "0"], "shrink", 3),
    ("restart", ["--spares", "0", "--no-shrink"], "restart_last_ckpt", 4),
)
SUPERVISE_MOVE = "3@6"
# whisper-base at full width and depth trains 8 steps through
# ``launch.train._run_supervised`` with a checkpoint every 4 steps and host
# 2 of 4 killed at step 4, no spare: a shrink onto 3 virtual hosts
SUPERVISE_TRAIN = ["--arch", "whisper-base", "--shape", "train_s4096_b8",
                   "--steps", "8", "--ckpt-every", "4", "--supervise",
                   "--hosts", "4", "--spares", "0", "--kill-host", "2@4"]


class StepClock:
    """``on_step`` hook for the launchers' loops: the wall time at the
    end of each step and the supervisor's incident count then, so the
    time from the step whose heartbeat tick detected a death to the end
    of the first step after the decision executed (detection -> serving
    again) can be read off."""

    def __init__(self, sess):
        self.sess, self.marks = sess, []

    def __call__(self, *_):
        sup = self.sess.supervisor
        self.marks.append((time.monotonic(),
                           len(sup.incidents) if sup is not None else 0))

    def serving_again(self):
        """Seconds from the end of the step before each incident to the
        end of the first step after it."""
        return [b[0] - a[0] for a, b in zip(self.marks, self.marks[1:])
                if b[1] > a[1]]


def supervised_serving(torch, np, mods, params, prompts, ref):
    """The three supervised serving runs and the live move of
    ``supervise_path``; raises unless each run decided the expected
    action, re-slotted as it should and finished every request with the
    uninterrupted run's tokens. Returns {label: MTTR and blackout
    figures}."""
    from repro_torch.api import CheckpointSession, Policy
    from repro_torch.launch import serve as L
    from repro_torch.launch.supervise import parse_supervise_args
    from repro_torch.serving.engine import Request, ServingEngine
    sv = SUPERVISE_SERVE
    base = ["--arch", SUPERVISE_ARCH, "--slots", str(sv["n_slots"]),
            "--max-seq",
            str(sv["max_seq"]), "--max-new", str(sv["max_new"]),
            "--requests", str(len(prompts))]
    out = {}
    runs = [(label, flags, action, slots) for label, flags, action, slots
            in SUPERVISE_RUNS] + [("live move", None, None, 3)]
    for label, flags, action, slots in runs:
        argv = base + (["--supervise", "--hosts", "4", "--kill-host",
                        SUPERVISE_KILL] + flags if flags is not None
                       else ["--migrate-to", SUPERVISE_MOVE])
        args = L.build_parser().parse_args(argv)
        kill, err = parse_supervise_args(args, "chip_smoke")
        move, err2 = L._parse_migrate_to(args, "chip_smoke")
        if err or err2:
            raise AssertionError(err or err2)
        store = tempfile.mkdtemp(prefix="chip_smoke_sup_")
        moves = []
        try:
            sess = CheckpointSession(f"sharded:{store}?hosts=4&replicate=1",
                                     Policy(**SUPERVISE_POLICY))
            eng0 = ServingEngine.create(SUPERVISE_ARCH, params,
                                        n_slots=sv["n_slots"],
                                        max_seq=sv["max_seq"],
                                        manager=sess.manager)
            sess.attach(eng0)
            for i, p in enumerate(prompts):
                eng0.submit(Request(rid=i, prompt=p.copy(),
                                    max_new=sv["max_new"]))
            clock = StepClock(sess)
            occupied = {}

            def on_step(e):
                clock()
                if e is eng0:
                    occupied[e.steps] = sum(r is not None
                                            for r in e.slot_req)
            t0 = time.monotonic()
            if flags is not None:
                eng, reg = L._run_supervised(args, sess, eng0, params, kill,
                                             on_step=on_step)
            else:
                eng, reg = L._run_migrated(args, sess, eng0, move,
                                           on_step=on_step,
                                           on_move=moves.append)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            st = dict(sess.stats)
            sup = sess.supervisor
            sess.close()
        finally:
            shutil.rmtree(store, ignore_errors=True)
        got = {rid: list(r.out) for rid, r in reg.items()}
        if got != ref:
            bad = sorted(k for k in ref if got.get(k) != ref[k])
            raise AssertionError(f"supervised serving, {label}: requests "
                                 f"{bad} diverged from the uninterrupted "
                                 "run")
        if eng.n_slots != slots:
            raise AssertionError(f"supervised serving, {label}: ended on "
                                 f"{eng.n_slots} slots, wanted {slots}")
        saves = max(st["saves"], 1)
        row = dict(wall_s=wall, steps=eng.steps,
                   snapshots=st["saves"], links=st["chain_links"],
                   stall_ms=st["capture_seconds"] / saves * 1e3,
                   encode_s=st["encode_commit_seconds"] / saves)
        count_written(st)
        if flags is not None:
            incs = [(i.action, i.dead) for i in sup.incidents]
            if incs != [(action, [2])]:
                raise AssertionError(f"supervised serving, {label}: "
                                     f"incidents {incs}, wanted "
                                     f"[({action!r}, [2])]")
            if (eng is eng0) != (action == "hot_spare"):
                raise AssertionError(f"supervised serving, {label}: the "
                                     "engine was "
                                     + ("kept" if eng is eng0 else "rebuilt"))
            row.update(restore_s=sup.incidents[0].wall_s,
                       serving_again_s=clock.serving_again()[0],
                       world=sup.world, step=sup.incidents[0].step)
        else:
            mv = moves[0]
            # every session in a slot at the move carries its column; a
            # queued one is admitted from its prompt, as it would have been
            begun = occupied[move[1]]
            if mv.carried != begun:
                raise AssertionError(f"supervised serving, {label}: "
                                     f"{mv.carried} of the {begun} begun "
                                     "sessions carried their cache column")
            row.update(blackout_s=mv.blackout_s, capture_s=mv.capture_s,
                       restore_s=mv.restore_s, moved=len(mv.moved),
                       carried=mv.carried,
                       batches=[{k: round(v, 4) for k, v in b.items()}
                                for b in mv.batches])
        out[label] = row
        log(f"supervised serving, {label}: every request token-identical to "
            f"the uninterrupted run on {eng.n_slots} slots; {row}; disk "
            f"writes so far {_WRITTEN['bytes'] / 1e9:.2f} GB of blobs")
        del eng, eng0, reg
        gc.collect()
        torch.cuda.empty_cache()
    return out


def supervised_training(torch, np, mods):
    """whisper-base's supervised shrink (``SUPERVISE_TRAIN``) against the
    training cell's 8 steps uninterrupted (``UNINTERRUPTED``), under
    deterministic algorithms: every
    step's loss, the rolled-back steps' again included, and the final
    state digest bit-identical; raises otherwise, or unless the flash
    kernels launched 36 / 18 / 18 times a step. Returns the figures."""
    from repro_torch.launch import train as LT
    from repro_torch.launch.common import build_session
    from repro_torch.launch.supervise import parse_supervise_args
    from repro_torch.train.loop import Trainer, TrainJob
    args = LT.build_parser().parse_args(SUPERVISE_TRAIN)
    kill, err = parse_supervise_args(args, "chip_smoke")
    if err:
        raise AssertionError(err)
    if (args.arch, args.shape) not in UNINTERRUPTED:
        raise AssertionError(f"supervised training needs the {args.arch} "
                             "training cell's uninterrupted run first")
    job = TrainJob(args.arch, args.shape)
    fa = mods["flash"]
    store = tempfile.mkdtemp(prefix="chip_smoke_suptrain_")
    torch.use_deterministic_algorithms(True)
    try:
        fa.reset_counts()
        # the same job's first 8 steps uninterrupted, as the training
        # cell's ``train_path`` ran them from the same seeds
        want, want_digest = UNINTERRUPTED[(args.arch, args.shape)]
        sess, err = build_session(f"localfs:{store}", "chip_smoke",
                                  interval=args.ckpt_every,
                                  keep_last=args.keep_last)
        if err:
            raise AssertionError(err)
        tr = sess.attach(Trainer(job, manager=sess.manager))
        tr.init_state()
        seen = []
        clock = StepClock(sess)

        def on_step(step, met):
            seen.append((step, met["loss"]))
            clock()
        t0 = time.monotonic()
        tr = LT._run_supervised(args, sess, tr, kill, on_step=on_step)
        sess.wait()
        wall = time.monotonic() - t0
        got_digest = tr.state_digest()
        sup, st = sess.supervisor, dict(sess.stats)
        sess.close()
        del tr, sess
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(store, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    incs = [(i.action, i.dead, i.step) for i in sup.incidents]
    if incs != [("shrink", [2], 4)] or sup.world != [0, 1, 3]:
        raise AssertionError(f"supervised training: incidents {incs}, world "
                             f"{sup.world}")
    bad = [(s, l) for s, l in seen if l != want[s - 1]]
    if bad or [s for s, _ in seen][-1] != args.steps:
        raise AssertionError(f"supervised training: losses {seen} against "
                             f"the uninterrupted {want}")
    if got_digest != want_digest:
        raise AssertionError(f"supervised training: state digest "
                             f"{got_digest} != uninterrupted {want_digest}")
    n_steps = len(seen)
    launched = fa.counts("cuda")
    per = {k: n // n_steps for k, n in launched.items()}
    if any(n % n_steps for n in launched.values()) or \
            per != dict(zip(fa.KERNELS, (36, 18, 18))):
        raise AssertionError(f"supervised training: flash launches "
                             f"{launched} over {n_steps} steps")
    row = dict(wall_s=wall, steps=[s for s, _ in seen],
               restore_s=sup.incidents[0].wall_s,
               serving_again_s=clock.serving_again()[0],
               snapshots=st["saves"], bytes=st["bytes_written"])
    log(f"supervised training: whisper-base shrink 4 -> 3 virtual hosts; "
        f"losses of every step (steps {row['steps']}) and the state digest "
        f"{got_digest} bit-identical to the uninterrupted run; flash "
        f"launches {launched} ({per} a step); {row}; {count_written(st)}")
    return launched, row


def supervise_path(torch, np, mods):
    """The failure loop on the card (see ``SUPERVISE_SERVE`` and
    ``SUPERVISE_TRAIN``): phi4-mini-3.8b served uninterrupted, then under
    hot spare, shrink (4 -> 3 slots) and restart, then moved live, every
    request token for token; then whisper-base's supervised shrink
    bit-identical. Every kernel count is set to 0 just before the
    serving runs and read after them, and again around the training;
    raises unless the capture kernels launched in the serving runs.
    Returns the counts summed."""
    from repro_torch.configs import resolve_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.tree import flatten_with_paths
    cfg = resolve_config(SUPERVISE_ARCH)
    t0 = time.monotonic()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n = sum(v.numel() for _, v in flatten_with_paths(params))
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, cfg.vocab_size, size=int(k)).astype(np.int32)
               for k in rng.randint(*SUPERVISE_PROMPT_LENS,
                                    size=SUPERVISE_N_REQ)]
    log(f"supervise path: {SUPERVISE_ARCH} at full width, {n} bf16 params "
        f"made "
        f"in {time.monotonic() - t0:.1f} s; {len(prompts)} requests, prompts "
        f"{[len(p) for p in prompts]} tokens, {SUPERVISE_SERVE}")
    _reset_all(mods)
    eng, reqs, toks, dt = serve(torch, ServingEngine, Request,
                                SUPERVISE_ARCH, params,
                                prompts, **SUPERVISE_SERVE)
    ref = {r.rid: list(r.out) for r in reqs}
    log(f"supervise path: uninterrupted {eng.steps} engine steps, {toks} "
        f"tokens in {dt:.2f} s")
    del eng
    serving = supervised_serving(torch, np, mods, params, prompts, ref)
    counts = _all_counts(mods)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"supervise path: serving kernel launches {counts}")
    if not all(counts["codec"][k] for k in ("fingerprint", "fused_capture")):
        raise AssertionError(f"supervised serving missed a capture kernel: "
                             f"{counts['codec']}")
    ran = {k: v for name in ("flash", "ssd", "rg_lru")
           for k, v in counts[name].items() if v}
    if ran:
        raise AssertionError(f"supervised serving launched {ran}")
    total = _flat_counts(counts)
    _reset_all(mods)
    launched, training = supervised_training(torch, np, mods)
    for k, v in launched.items():
        total[k] = total.get(k, 0) + v
    log("supervise path: MTTR (detection -> serving again, s): " + "; ".join(
        f"{label} {row['serving_again_s']:.3f} (restore hook "
        f"{row['restore_s']:.3f})" for label, row in serving.items()
        if "serving_again_s" in row)
        + f"; whisper-base shrink {training['serving_again_s']:.3f} (restore "
        f"hook {training['restore_s']:.3f}); live move worst blackout "
        f"{serving['live move']['blackout_s']:.3f} s")
    return total


# the mesh path: four ranks share the one card (gloo, the collective shim
# of ``parallel.collectives``); starcoder2-3b at full width, depth cut
# from 30 to 2 (ROADMAP C17), the published 4,096 tokens at a batch cut
# from 256 to 4 (the (4, 1) mesh splits it four ways), one step and a
# snapshot (a base: a link after a second step cost rank 0 a 50 s encode
# on one H100, PERF.md §6); a restore's loss within
# ``loss_rtol`` of the uninterrupted run's on another mesh (the bf16
# forward sums in another order: 1e-6 to 1e-5 relative on one H100);
# llama4-scout's one-layer forward expert-parallel, the logits of tokens
# that kept their top-1 expert within ``max_rel`` of one rank's
MESH_TRAIN = dict(arch="starcoder2-3b-layers2", shape="train_s4096_b4",
                  steps=1, mesh=(2, 2), elastic=((4, 1), (2, 2)),
                  loss_rtol=2e-4)
MESH_MOE = dict(arch="llama4-scout-17b-a16e-layers1", mesh=(1, 4),
                batch=2, seq=1024, capacity_factor=16.0, max_rel=3e-2)
MESH_COMPRESS = (1536, 50280)
MESH_PIPELINE = dict(L=8, M=6, mb=4, D=16)
MESH_AXES = ("data", "model")
# serving over the mesh: phi4-mini-3.8b at full width, depth cut from 32
# to 2 (ROADMAP C17: the script's time), the serving path's prompts on
# 4 slots x 1,024, 12 new tokens; snapshots every 4 steps, step 8 (mid
# first wave) restored onto each target
MESH_SERVE = dict(arch=f"{ARCH}-layers2", mesh=(2, 2), n_slots=N_SLOTS,
                  max_seq=MAX_SEQ, max_new=12,
                  policy=dict(interval=4, chain=4), at=8,
                  targets=(((1, 4), False), ((4, 1), True)),
                  logits_rel=2e-2)
# the failure loop over the mesh (A9b step 2): in each launch every
# rank runs one ClusterSupervisor over hosts 0-3 (host h backs rank h).
# Host 3 dies: the training cell's checkpoint shrinks onto (2, 1) over
# ranks 0-1 and steps once (its loss within ``loss_rtol`` of the
# uninterrupted run's, the bf16 sums on another mesh as MESH_TRAIN's);
# MESH_SERVE's checkpoint of step 8 re-slots onto 3 slots of (1, 2) over
# ranks 0-1 and drains. The (2, 2)-restored engine's sessions move onto
# one device on rank 0 with their cache columns.
MESH_SUPERVISE = dict(dead=3, train_mesh=(2, 1), serve_mesh=(1, 2),
                      loss_rtol=2e-4, logits_rel=2e-2)


def _rank_counts(device):
    from repro_torch.kernels.ckpt_codec import ops as codec
    from repro_torch.kernels.flash_attention import ops as fa
    route = "cuda" if device == "cuda" else "cpu"
    return {**codec.counts(route), **fa.counts(route)}


def _rank_reset():
    from repro_torch.kernels.ckpt_codec import ops as codec
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.parallel import collectives
    codec.reset_counts()
    fa.reset_counts()
    collectives.reset_stats()


def _sync(torch, device):
    if device == "cuda":
        torch.cuda.synchronize()


def _peak(torch, device) -> int:
    return torch.cuda.max_memory_allocated() if device == "cuda" else 0


def _rank_stats():
    from repro_torch.parallel import collectives
    return {k: dict(v) for k, v in collectives.STATS.items()}


def _stats_since(before):
    """The staged collectives run since ``before`` (``_rank_stats()``):
    {name: [calls, bytes, seconds]}."""
    out = {}
    for k, v in _rank_stats().items():
        b = before.get(k, {"calls": 0, "bytes": 0, "seconds": 0.0})
        if v["calls"] > b["calls"]:
            out[k] = [v["calls"] - b["calls"], v["bytes"] - b["bytes"],
                      round(v["seconds"] - b["seconds"], 4)]
    return out


def columns_digest(cols):
    """blake2b over a live move's or a re-slot's cache columns ({rid:
    column tree}), rid by rid, leaf path by path (bf16 as its bits):
    None for None (a rank that holds no columns)."""
    import hashlib
    from repro_torch.host import host_array
    from repro_torch.tree import flatten_with_paths
    if cols is None:
        return None
    h = hashlib.blake2b(digest_size=16)
    for rid in sorted(cols):
        for path, v in sorted(flatten_with_paths(cols[rid]),
                              key=lambda pv: pv[0]):
            h.update(f"{rid}{path}".encode())
            h.update(host_array(v).tobytes())
    return h.hexdigest()


def _beat_until_dead(sup, now, world, dead):
    """Seven ticks of the supervisor's clock with every host of
    ``world`` but ``dead`` beating, then one poll."""
    for _ in range(7):
        now[0] += 1.0
        for h in range(world):
            if h != dead:
                sup.beat(h, 0)
    return sup.poll()


def _free(torch, device):
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


class _Marks:
    """Seconds since the rank's spawn at each named point of its run."""

    def __init__(self, spawned: float) -> None:
        self.spawned, self.at = spawned, []
        self("start")

    def __call__(self, name: str) -> None:
        self.at.append((name, round(time.time() - self.spawned, 2)))


def _timed_step(torch, eng, device, profile=False):
    """One engine step: (wall ms, device ms of its kernels from
    torch.profiler when ``profile`` on the card, else None, the staged
    collectives it ran {name: [calls, bytes, seconds]})."""
    from repro_torch.parallel import collectives
    before = {k: dict(v) for k, v in collectives.STATS.items()}
    prof = None
    if profile and device == "cuda":
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        prof = prof_ctx(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
        prof.__enter__()
    _sync(torch, device)
    t0 = time.monotonic()
    eng.step()
    _sync(torch, device)
    wall = (time.monotonic() - t0) * 1e3
    dev_ms = None
    if prof is not None:
        from torch.autograd import DeviceType
        prof.__exit__(None, None, None)
        dev_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == DeviceType.CUDA) / 1e3
    coll = {}
    for k, v in collectives.STATS.items():
        b = before.get(k, {"calls": 0, "bytes": 0, "seconds": 0.0})
        if v["calls"] > b["calls"]:
            coll[k] = [v["calls"] - b["calls"], v["bytes"] - b["bytes"],
                       round(v["seconds"] - b["seconds"], 4)]
    return wall, dev_ms, coll


def mesh_serve_restore(torch, store, cell, params, device, *, mesh=None,
                       streaming=False, resnap=False, manager=None,
                       n_slots=None):
    """The serving checkpoint of ``cell["at"]`` restored onto ``mesh``
    (or one device; onto ``n_slots`` slots where given, a re-slot) and
    decoded to the end: its return time and phases,
    the first token's time (the restore, the landing of a streamed cache
    and the first engine step; the digest read between them is not
    counted), the restored cache digest, the first step's logits
    (whole), every live request's tokens and each later step's wall
    ms. With ``resnap`` the restored engine goes on snapshotting every
    interval steps, into ``manager`` (rank 0's; the other ranks join
    the cache's gather)."""
    from repro_torch.api import CheckpointSession
    sess = CheckpointSession(f"localfs:{store}")
    kw = {"mesh_factory": lambda: mesh} if mesh is not None else \
        {"device": device}
    _sync(torch, device)
    t0 = time.monotonic()
    if n_slots is not None:
        kw["n_slots"] = n_slots
    eng = sess.restore(cell["at"], params=params, streaming=streaming, **kw)
    eng._ensure_cache()
    _sync(torch, device)
    restore_s = time.monotonic() - t0
    live = eng.live_requests()
    digest = eng.cache_digest()
    first_s = restore_s + _timed_step(torch, eng, device)[0] / 1e3
    logits = eng.last_logits.float().cpu()
    steps_ms = []
    if manager is not None:
        eng.manager = manager
    while eng.queue or any(eng.slot_req):
        steps_ms.append(_timed_step(torch, eng, device)[0])
        if resnap and eng.steps % cell["policy"]["interval"] == 0:
            eng.snapshot()
    out = dict(restore_s=restore_s, first_s=first_s, digest=digest,
               logits=logits, timings=dict(eng.incarnation.timings),
               tokens={r.rid: list(r.out) for r in live},
               step_ms=steps_ms, streamed=streaming)
    sess.close()
    del eng, sess
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def mesh_serve_rank(torch, rank, device, store, cell, mark):
    """One rank of the serving cell's first launch: ``cell["arch"]``
    served on ``cell["mesh"]`` to the end, a snapshot every
    ``cell["policy"]["interval"]`` steps (rank 0 holds the session), the
    cache digest at ``cell["at"]`` and the next step's logits kept, one
    decode step profiled; then ``cell["at"]`` restored onto the same
    mesh and decoded to the end."""
    import numpy as np
    from repro_torch.api import CheckpointSession, Policy
    from repro_torch.configs import resolve_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = resolve_config(cell["arch"])
    params = M.init_params(cfg, seed=0, device=device)      # whole
    prompts = serving_prompts(np, cfg.vocab_size)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _rank_reset()
    sess = CheckpointSession(f"localfs:{store}", Policy(**cell["policy"])) \
        if rank == 0 else None
    eng = ServingEngine.create(cell["arch"], params, cell["mesh"],
                               MESH_AXES, n_slots=cell["n_slots"],
                               max_seq=cell["max_seq"],
                               manager=sess and sess.manager, device=device)
    mark("serve: engine built")
    reqs = [Request(rid=i, prompt=p.copy(), max_new=cell["max_new"])
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    every = cell["policy"]["interval"]
    step_ms, snap_s, out = [], [], {}
    while eng.queue or any(eng.slot_req):
        # step 6: a first-wave decode step (all four slots, no admission)
        wall, dev_ms, coll = _timed_step(torch, eng, device,
                                         profile=eng.steps == 5)
        step_ms.append(wall)
        if eng.steps == 6:
            out.update(profiled=dict(wall_ms=wall, device_ms=dev_ms,
                                     collectives=coll))
        if eng.steps == cell["at"] + 1:
            out["next_logits"] = eng.last_logits.float().cpu()
        if eng.steps % every == 0:
            t0 = time.monotonic()
            eng.snapshot()
            snap_s.append(time.monotonic() - t0)
            if eng.steps == cell["at"]:
                out["digest"] = eng.cache_digest()
                # every begun session's column, gathered onto rank 0:
                # what a re-slot carries (MESH_SUPERVISE)
                out["columns"] = columns_digest(eng.session_columns())
    mark("serve: uninterrupted")
    t0 = time.monotonic()
    if sess is not None:
        sess.wait()
        out["encode_s"] = sess.stats["encode_commit_seconds"]
        out["bytes_written"] = sess.stats["bytes_written"]
        sess.close()
    torch.distributed.barrier()          # rank 0's commits are readable
    out.update(drain_s=time.monotonic() - t0, step_ms=step_ms,
               snap_s=snap_s, tokens={r.rid: list(r.out) for r in reqs},
               plan=str(eng.plan),
               local_k=tuple(eng.cache["k"].to_local().shape))
    del eng
    mark("serve: drained")
    # the restored engine goes on snapshotting, dense (its chain links
    # XOR on the card; the sparse links XOR their dirty chunks on the
    # host), into a store of its own
    dense = store.rstrip("/") + "-dense"
    resnap = CheckpointSession(f"localfs:{dense}", Policy(
        **cell["policy"], sparse=False)) if rank == 0 else None
    out["restore"] = mesh_serve_restore(
        torch, store, cell, params, device,
        mesh=make_mesh(cell["mesh"], MESH_AXES, device), resnap=True,
        manager=resnap and resnap.manager)
    if resnap is not None:
        resnap.wait()
        out["resnap"] = dict(resnap.stats)
        resnap.close()
        shutil.rmtree(dense, ignore_errors=True)
    if rank:
        out["restore"]["logits"] = out["next_logits"] = None
    mark("serve: restored, decoded")
    out["move"] = mesh_move(torch, rank, device, store, cell, params)
    out["counts"] = _rank_counts(device)
    mark("serve: moved off the mesh")
    out["peak"] = _peak(torch, device)
    del params
    return out


def mesh_move(torch, rank, device, store, cell, params):
    """A live move off the mesh (MESH_SUPERVISE): the serving checkpoint
    of ``cell["at"]`` restored onto ``cell["mesh"]``, every session moved
    onto a one-device engine on rank 0 (``migrate_sessions``, the cache
    columns carried through a move channel beside the store). Rank 0
    returns the source columns' digest and the landed ones', the move's
    blackout, the target's first step's logits and every moved
    request's tokens; every rank the moved rids and what its source
    has left."""
    from repro_torch.api import CheckpointSession
    from repro_torch.core.migration import migrate_sessions
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving.engine import ServingEngine
    sess = CheckpointSession(f"localfs:{store}")
    mesh = make_mesh(cell["mesh"], MESH_AXES, device)
    eng = sess.restore(cell["at"], params=params, mesh_factory=lambda: mesh)
    t0 = time.monotonic()
    cols = eng.session_columns()            # collective: rank 0's whole
    _sync(torch, device)
    out = dict(columns_s=time.monotonic() - t0,
               src=columns_digest(cols) if rank == 0 else None)
    del cols
    target = ServingEngine.create(
        cell["arch"], params, n_slots=cell["n_slots"],
        max_seq=cell["max_seq"], device=device) if rank == 0 else None
    moves = store.rstrip("/") + "-moves"
    res = migrate_sessions(eng, target, via=f"localfs:{moves}",
                           include_queue=True, settle=False)
    out.update(moved=res.moved, left=len(eng.live_requests()))
    if target is not None:
        out.update(landed=columns_digest(dict(target._carried)),
                   carried=res.carried, capture_s=res.capture_s,
                   restore_s=res.restore_s)
        wall = _timed_step(torch, target, device)[0]
        out.update(blackout_s=res.blackout_s + wall / 1e3,
                   logits=target.last_logits.float().cpu())
        target.run_until_drained()
        out["tokens"] = {r.rid: list(r.out) for r in res.requests}
        shutil.rmtree(moves, ignore_errors=True)
    sess.close()
    del eng, target, sess
    _free(torch, device)
    return out


def mesh_train_rank(rank, world, device, store, cell, spawned,
                    serve_store=None, serve=None):
    """One rank of the mesh path's uninterrupted run: ``cell["steps"]``
    steps on ``cell["mesh"]``, a snapshot after each (a base, then its
    links; rank 0 commits them in the background), then one more step;
    then, given ``serve``, ``mesh_serve_rank`` into ``serve_store``."""
    import torch
    from repro_torch.api import CheckpointSession, Policy
    from repro_torch.train.loop import Trainer, TrainJob
    mark = _Marks(spawned)
    torch.use_deterministic_algorithms(True)
    sess = CheckpointSession(f"localfs:{store}", Policy(chain=2)) \
        if rank == 0 else None
    tr = Trainer(TrainJob(cell["arch"], cell["shape"]), cell["mesh"],
                 MESH_AXES, manager=sess and sess.manager, device=device)
    mark("mesh, step built")
    tr.init_state()
    mark("init")
    _rank_reset()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, step_ms, gather_s = [], [], []
    for i in range(cell["steps"]):
        t0 = time.monotonic()
        losses.append(tr.train_steps(1)["loss"])
        _sync(torch, device)
        step_ms.append((time.monotonic() - t0) * 1e3)
        t0 = time.monotonic()
        tr.snapshot()
        gather_s.append(time.monotonic() - t0)
        mark(f"step, snapshot {i + 1}")
    digest = tr.params_digest()
    mark("params digest")
    t0 = time.monotonic()
    nxt = tr.train_steps(1)["loss"]
    _sync(torch, device)
    step_ms.append((time.monotonic() - t0) * 1e3)
    state = tr.state_digest()
    mark("step, state digest")
    t0 = time.monotonic()
    if sess is not None:
        sess.wait()
        encode_s = sess.stats["encode_commit_seconds"]
        sess.close()
    else:
        encode_s = 0.0
    mark("drain")
    out = dict(losses=losses, step_ms=step_ms, gather_s=gather_s,
               encode_s=encode_s, drain_s=time.monotonic() - t0,
               marks=mark.at,
               digest=digest, next_loss=nxt, state_digest=state,
               counts=_rank_counts(device), stats=_rank_stats(),
               peak=_peak(torch, device), plan=str(tr.plan),
               step=cell["steps"])
    if serve is not None:
        del tr
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        out["serve"] = mesh_serve_rank(torch, rank, device, serve_store,
                                       serve, mark)
    return out


def _restore_on(torch, store, mesh, device):
    from repro_torch.api import CheckpointSession
    from repro_torch.train.loop import Trainer
    sess = CheckpointSession(f"localfs:{store}")
    t0 = time.monotonic()
    tr = Trainer.restore(sess.manager, mesh_factory=lambda: mesh)
    _sync(torch, device)
    return tr, sess, time.monotonic() - t0


class _Routes:
    """Within the block, every top-k choice the MoE's router makes
    (``moe._route_local``'s expert ids), in call order."""

    def __enter__(self):
        from repro_torch.models import moe as MOE
        self.mod, self.plain, self.idx = MOE, MOE._route_local, []

        def spy(*args):
            out = self.plain(*args)
            self.idx.append(out[1])
            return out
        MOE._route_local = spy
        return self

    def __exit__(self, *exc):
        self.mod._route_local = self.plain


def mesh_moe_forward(torch, cfg, device):
    """forward_train of ``cfg`` on a ``MESH_MOE["mesh"]`` mesh,
    expert-parallel: (the logits gathered whole, the aux loss, seconds,
    the tokens, the router's expert ids [MoE layers, B, S, k] — every
    rank routes all the tokens on a mesh of one data rank)."""
    from repro_torch.configs.registry import get_shape
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.parallel import context as pctx
    from repro_torch.parallel.planner import make_plan
    from repro_torch.parallel.sharding import leaf_placements, shard_tensor
    from repro_torch.train.step import make_call_options, shard_batch
    mesh = make_mesh(MESH_MOE["mesh"], MESH_AXES, device)
    B, S = MESH_MOE["batch"], MESH_MOE["seq"]
    # a forward needs the plan's rules only: the train branch's over the
    # mesh's axis sizes, not the card's training budget (params, moments
    # and a snapshot's gather), which a one-layer forward never holds
    sizes = SimpleNamespace(shape=dict(zip(MESH_AXES, MESH_MOE["mesh"])))
    plan = make_plan(cfg, get_shape(f"train_s{S}_b{B}"), sizes)
    places = leaf_placements(plan, M.param_template(cfg), mesh)
    params = M.init_params(cfg, seed=0, device=device, leaf_fn=lambda p, t:
                           shard_tensor(t, mesh, places[p]))
    gen = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           dtype=torch.int32).to(device)
    if MESH_MOE["mesh"][0] != 1:
        raise ValueError("the routing comparison needs one data rank")
    t0 = time.monotonic()
    with torch.no_grad(), pctx.mesh_context(mesh, plan.batch_axes,
                                            plan.model_axis), \
            _Routes() as routes:
        logits, aux = M.forward_train(
            cfg, params, shard_batch(plan, mesh, {"tokens": tokens}),
            make_call_options(plan, mesh))
        full = logits.full_tensor().float()
        aux = float(aux["moe_aux"].full_tensor())
    _sync(torch, device)
    return full, aux, time.monotonic() - t0, tokens, torch.stack(routes.idx)


def mesh_moe_reference(torch, cfg, device, full, tokens, idx):
    """The same forward on one rank (plain tensors) against ``full``:
    the tokens whose top-k choices differ from the mesh's (``idx``), and
    the relative 2-norm error over all tokens and over those that kept
    their choices."""
    from repro_torch.models import model as M
    params = M.init_params(cfg, seed=0, device=device)
    with torch.no_grad(), _Routes() as routes:
        ref, aux = M.forward_train(cfg, params, {"tokens": tokens})
    ref = ref.float()
    # [MoE layers, B, S, k] -> [B, S]: a token routed elsewhere in a
    # layer (with one MoE layer its logits depend on its own choices
    # alone)
    flipped = (idx != torch.stack(routes.idx)).movedim(0, -1) \
        .flatten(2).any(dim=-1)
    kept = ~flipped

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))
    return dict(rel=rel(full, ref), kept_rel=rel(full[kept], ref[kept]),
                flipped=int(flipped.sum()), tokens=int(flipped.numel()),
                equal=bool(torch.equal(full, ref)),
                finite=bool(torch.isfinite(full).all()),
                ref_aux=float(aux["moe_aux"]))


def mesh_compress(torch, device, rank, world):
    """compressed_psum over the world on a [1536, 50280] f32 gradient per
    rank (seed 100 + rank). Every rank returns its result's hash; rank 0
    also its error against the exact mean and the scale (the largest
    magnitude / 127), which it computes alone from every rank's seed,
    with no collective."""
    import hashlib
    from repro_torch.optim.compression import (compressed_psum,
                                               init_error_feedback)

    def grad(r):
        gen = torch.Generator().manual_seed(100 + r)
        return torch.randn(MESH_COMPRESS, generator=gen).to(device)
    g = grad(rank)
    t0 = time.monotonic()
    red, ef = compressed_psum({"w": g}, init_error_feedback({"w": g}))
    _sync(torch, device)
    out = dict(seconds=time.monotonic() - t0, hash=hashlib.blake2b(
        red["w"].cpu().numpy().tobytes(), digest_size=16).hexdigest())
    del g, ef
    if rank == 0:
        exact = torch.zeros(MESH_COMPRESS, device=device)
        top = 0.0
        for r in range(world):
            gr = grad(r)
            exact += gr
            top = max(top, float(gr.abs().amax()))
            del gr
        exact /= world
        out.update(err=float((red["w"] - exact).abs().max()),
                   scale=top / 127)
    return out


def mesh_pipeline(torch, device, rank, world):
    """The reference's toy GPipe (L 8, M 6, mb 4, D 16) over ``world``
    stages against the plain layer loop."""
    from repro_torch.parallel.pipeline import bubble_fraction, \
        pipeline_forward
    c = MESH_PIPELINE
    gen = torch.Generator().manual_seed(0)
    W = (torch.randn(c["L"], c["D"], c["D"], generator=gen) * 0.2).to(device)
    X = torch.randn(c["M"], c["mb"], c["D"], generator=gen).to(device)
    block = lambda w, x: torch.tanh(x @ w)
    ref = X
    for i in range(c["L"]):
        ref = block(W[i], ref)
    out = pipeline_forward(lambda p, x: block(p["w"], x), {"w": W}, X)
    return dict(err=float((out - ref).abs().max()),
                bubble=bubble_fraction(world, c["M"]))


def mesh_elastic_rank(rank, world, device, store, cell, moe, spawned,
                      serve_store=None, serve=None, sup=None):
    """One rank of the mesh path's second launch: the checkpoint restored
    onto each of ``cell["elastic"]`` and stepped once (the state digest
    read after the step on the uninterrupted run's mesh); given ``sup``,
    the supervised shrink of that checkpoint (``mesh_supervise_train``);
    given ``serve``, its serving checkpoint restored onto each of
    ``serve["targets"]`` and decoded to the end (``mesh_serve_restore``),
    then with ``sup`` its supervised re-slot (``mesh_supervise_serve``);
    then the expert-parallel forward, the compressed all-reduce and the
    pipeline."""
    import gc
    import torch
    from repro_torch.configs import resolve_config
    mark = _Marks(spawned)
    torch.use_deterministic_algorithms(True)
    out = {"restores": [], "marks": mark.at, "serve": []}
    from repro_torch.launch.mesh import make_mesh
    shapes = list(cell["elastic"]) + ([t for t, _ in serve["targets"]]
                                      if serve is not None else [])
    meshes = {}
    for shape in shapes:
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, MESH_AXES, device)
    _rank_reset()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for shape in cell["elastic"]:
        tr, sess, seconds = _restore_on(torch, store, meshes[shape],
                                        device)
        mark(f"restore {shape}")
        timings = dict(tr.incarnation.timings)
        digest = tr.params_digest()
        mark("params digest")
        t0 = time.monotonic()
        loss = tr.train_steps(1)["loss"]
        _sync(torch, device)
        mark("step")
        res = dict(shape=shape, seconds=seconds, digest=digest, loss=loss,
                   step_ms=(time.monotonic() - t0) * 1e3,
                   step=tr.checkpoint_step() - 1, timings=timings)
        if tuple(shape) == tuple(cell["mesh"]):
            res["state_digest"] = tr.state_digest()
        out["restores"].append(res)
        mark("state digest")
        sess.close()
        del tr, sess
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    peak = _peak(torch, device)
    if sup is not None:
        out["supervise"] = mesh_supervise_train(torch, rank, world, device,
                                                store, cell, sup)
        mark("supervised shrink, step")
    if serve is not None:
        from repro_torch.models import model as M
        params = M.init_params(resolve_config(serve["arch"]), seed=0,
                               device=device)
        for shape, streaming in serve["targets"]:
            res = mesh_serve_restore(torch, serve_store, serve, params,
                                     device, mesh=meshes[shape],
                                     streaming=streaming)
            res["shape"] = shape
            if rank:
                res["logits"] = None          # every rank's are the same
            out["serve"].append(res)
            mark(f"serve restore {shape}")
        if sup is not None:
            out["supervise_serve"] = mesh_supervise_serve(
                torch, rank, world, device, serve_store, serve, sup, params)
            mark("supervised re-slot, drained")
        del params
    out["peak_before_moe"] = max(peak, _peak(torch, device))
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cfg = resolve_config(moe["arch"]).replace(
        capacity_factor=moe["capacity_factor"])
    if device != "cuda":
        cfg = cfg.replace(dtype="float32")
    full, aux, seconds, tokens, idx = mesh_moe_forward(torch, cfg, device)
    mark("moe init, forward")
    out["counts"] = _rank_counts(device)     # the comparisons below don't
    out["peak"] = _peak(torch, device)       # count
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    out["moe"] = dict(ep_s=seconds, aux=aux)
    if rank == 0:
        out["moe"].update(mesh_moe_reference(torch, cfg, device, full,
                                             tokens, idx))
    del full, idx
    mark("moe reference")
    out["compress"] = mesh_compress(torch, device, rank, world)
    out["pipeline"] = mesh_pipeline(torch, device, rank, world)
    mark("compress, pipeline")
    out["stats"] = _rank_stats()
    return out


def mesh_supervise_train(torch, rank, world, device, store, cell, sup):
    """The training half of MESH_SUPERVISE: every rank runs one
    ``ClusterSupervisor`` over hosts 0..world-1 on the training cell's
    checkpoint, balancing ``cell``'s batch rows as data shards; host
    ``sup["dead"]`` goes silent and the shrink restores onto
    ``sup["train_mesh"]`` over the first surviving ranks, which step
    once. Every rank returns the decision, its MTTR, the mesh and
    its peak device memory from the decision on (the ranks outside the
    mesh hold nothing) and its staged collectives; the mesh's ranks also
    the restore's phases, the params digest and the step's loss."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.api import CheckpointSession
    from repro_torch.configs import get_shape
    from repro_torch.core.supervisor import OutsideMesh
    from repro_torch.launch.mesh import make_mesh
    _free(torch, device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    before = _rank_stats()
    survivors = [h for h in range(world) if h != sup["dead"]]
    ranks = survivors[:int(np.prod(sup["train_mesh"]))]
    sess = CheckpointSession(f"localfs:{store}")
    now = [0.0]
    sv = sess.supervise(
        list(range(world)), heartbeat_timeout=3.0, clock=lambda: now[0],
        n_shards=get_shape(cell["shape"]).global_batch,
        restore_kwargs={"mesh_factory": lambda: make_mesh(
            sup["train_mesh"], MESH_AXES, device, ranks=ranks)},
        process_group=dist.group.WORLD)
    target = _beat_until_dead(sv, now, world, sup["dead"])
    inc = sv.incidents[-1]
    tr = sv.runner
    out = dict(action=target.action.value, hosts=target.hosts,
               step=target.step, mttr_s=inc.wall_s, mesh=inc.mesh,
               incident=(inc.action, inc.dead, inc.step, inc.mesh),
               outside=isinstance(tr, OutsideMesh))
    if not out["outside"]:
        out.update(timings=dict(tr.incarnation.timings),
                   ranks=[int(x) for x in tr.mesh.mesh.flatten()],
                   assignment=tr.lower.data_assignment,
                   digest=tr.params_digest())
        t0 = time.monotonic()
        out["loss"] = tr.train_steps(1)["loss"]
        _sync(torch, device)
        out["step_ms"] = (time.monotonic() - t0) * 1e3
    out.update(peak=_peak(torch, device), stats=_stats_since(before))
    sv.runner = None
    sess.close()
    del tr, sv, sess
    _free(torch, device)
    dist.barrier()
    return out


def mesh_supervise_serve(torch, rank, world, device, serve_store, serve,
                         sup, params):
    """The serving half of MESH_SUPERVISE: on a copy of ``serve``'s store
    that ends at its checkpoint of ``serve["at"]``, every rank runs one
    ``ClusterSupervisor`` over hosts 0..world-1; host ``sup["dead"]``
    goes silent and the shrink re-slots the sessions onto
    ``launch.serve.proportional_slots`` of ``sup["serve_mesh"]`` over the
    first surviving ranks, which drain them. The mesh's ranks return the
    re-slotted sessions' columns digest (rank 0), the restore's phases,
    the first step's logits (rank 0), each decode step's wall ms and
    every live request's tokens; every rank the decision and its MTTR."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.api import CheckpointSession
    from repro_torch.core.supervisor import OutsideMesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import proportional_slots
    copy = serve_store.rstrip("/") + "-supervised"
    if rank == 0:
        shutil.copytree(serve_store, copy)
        sess = CheckpointSession(f"localfs:{copy}")
        for step in sess.backend.list_steps():
            if step > serve["at"]:
                sess.backend.delete_step(step)
        sess.close()
    dist.barrier()
    survivors = [h for h in range(world) if h != sup["dead"]]
    ranks = survivors[:int(np.prod(sup["serve_mesh"]))]
    sess = CheckpointSession(f"localfs:{copy}")
    now = [0.0]
    sv = sess.supervise(
        list(range(world)), heartbeat_timeout=3.0, clock=lambda: now[0],
        restore_kwargs=lambda t: {
            "params": params,
            "n_slots": proportional_slots(serve["n_slots"], world,
                                          len(t.hosts)),
            "mesh_factory": lambda: make_mesh(sup["serve_mesh"], MESH_AXES,
                                              device, ranks=ranks)},
        process_group=dist.group.WORLD)
    target = _beat_until_dead(sv, now, world, sup["dead"])
    inc = sv.incidents[-1]
    eng = sv.runner
    out = dict(action=target.action.value, step=target.step,
               mttr_s=inc.wall_s, mesh=inc.mesh,
               incident=(inc.action, inc.dead, inc.step, inc.mesh),
               outside=isinstance(eng, OutsideMesh))
    if not out["outside"]:
        live = eng.live_requests()
        cols = eng.session_columns(include_queue=True)
        out.update(n_slots=eng.n_slots, columns=columns_digest(
            cols if rank == 0 else None),
            timings=dict(eng.incarnation.timings))
        del cols
        wall = _timed_step(torch, eng, device)[0]
        out.update(first_ms=wall, logits=eng.last_logits.float().cpu()
                   if rank == 0 else None)
        steps_ms = []
        while eng.queue or any(eng.slot_req):
            steps_ms.append(_timed_step(torch, eng, device)[0])
        out.update(step_ms=steps_ms,
                   tokens={r.rid: list(r.out) for r in live})
    sv.runner = None
    sess.close()
    del eng, sv, sess
    _free(torch, device)
    dist.barrier()
    if rank == 0:
        shutil.rmtree(copy, ignore_errors=True)
    return out


def _rel_norm(torch, a, b) -> float:
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def mesh_serve_report(torch, runs, runs2, one, cell, world, device):
    """The serving cell's checks and lines (``MESH_SERVE``): raises
    unless every rank emits the same tokens, every target's restored
    cache digest is the saved one, the same-mesh continuation gives
    every request's tokens and rank 0's capture kernels launched, and
    the first restored step's logits lie within ``cell["logits_rel"]``
    of the uninterrupted run's elsewhere. Returns rank 0's launches."""
    sv = [r["serve"] for r in runs]
    s0 = sv[0]
    if len({repr(sorted(x["tokens"].items())) for x in sv}) != 1 or \
            len({repr(sorted(x["restore"]["tokens"].items()))
                 for x in sv}) != 1:
        raise AssertionError("mesh serving: the ranks' tokens differ")
    want, digest = s0["tokens"], s0["digest"]
    if any(len(t) != cell["max_new"] for t in want.values()):
        raise AssertionError(f"mesh serving: unfinished requests {want}")
    same = s0["restore"]
    if same["digest"] != digest or same["tokens"] != want:
        raise AssertionError(
            f"mesh serving: {cell['mesh']} continuation: digest "
            f"{same['digest']} vs saved {digest}, tokens equal "
            f"{same['tokens'] == want}")
    missing = [k for k in CAPTURE_KERNELS if not s0["counts"].get(k)]
    if device == "cuda" and missing:
        raise AssertionError(f"mesh serving: rank 0's snapshots missed "
                             f"{missing}: {s0['counts']}")
    targets = [(tuple(t["shape"]), t) for t in runs2[0]["serve"]]
    for r in runs2[1:]:
        if [x["tokens"] for x in r["serve"]] != \
                [t["tokens"] for _, t in targets]:
            raise AssertionError("mesh serving: the second launch's ranks' "
                                 "tokens differ")
    targets.append(("one device", one))
    lines = []
    for name, t in [(cell["mesh"], same)] + targets:
        rel = _rel_norm(torch, t["logits"], s0["next_logits"])
        ok = sum(t["tokens"][k] == want[k] for k in t["tokens"])
        if t["digest"] != digest:
            raise AssertionError(f"mesh serving: {name}: restored cache "
                                 f"digest {t['digest']} != saved {digest}")
        if name != cell["mesh"] and rel > cell["logits_rel"]:
            raise AssertionError(f"mesh serving: {name}: first restored "
                                 f"step's logits {rel:.3e} off (limit "
                                 f"{cell['logits_rel']})")
        tm = t["timings"]
        lines.append(
            f"{name}{' streamed' if t['streamed'] else ''}: restore "
            f"{t['restore_s']:.2f} s (materialize "
            f"{tm.get('materialize_s', 0):.2f}, replay "
            f"{tm.get('replay_s', 0):.2f}, rebind {tm.get('rebind_s', 0):.2f})"
            f", first token {t['first_s']:.2f} s, first step's logits "
            f"{rel:.3e} off, {ok} of {len(t['tokens'])} requests token for "
            f"token, decode {_median(t['step_ms']):.0f} ms a step")
    prof = [x["profiled"] for x in sv]
    log(f"mesh serving: {cell['arch']} on {cell['mesh']} x {world} ranks, "
        f"plan {s0['plan']}, local k block {s0['local_k']}; "
        f"{len(s0['step_ms'])} steps, decode ms a step (median per rank) "
        + str([round(_median(x["step_ms"]), 1) for x in sv])
        + "; one first-wave step per rank: wall ms "
        + str([round(p["wall_ms"], 1) for p in prof]) + ", device ms "
        + str([None if p["device_ms"] is None else round(p["device_ms"], 2)
               for p in prof])
        + f"; its staged collectives on rank 0 (calls, bytes, s): "
        f"{prof[0]['collectives']}; snapshots (gather onto rank 0 and "
        f"capture) {[round(x, 2) for x in s0['snap_s']]} s, rank 0's "
        f"encode + commit {s0.get('encode_s', 0):.2f} s, "
        f"{s0.get('bytes_written', 0)} bytes written; the restored engine's "
        f"dense snapshots {s0['resnap']['saves']} ("
        f"{s0['resnap']['chain_links']} links, "
        f"{s0['resnap']['bytes_written']} bytes); launches rank 0 "
        f"{ {k: v for k, v in s0['counts'].items() if v} }; peak device "
        f"memory per rank GB {[round(x['peak'] / 1e9, 2) for x in sv]}")
    log("mesh serving: the saved cache digest restored on every target; "
        "same-mesh tokens bit for bit; " + "; ".join(lines))
    return s0["counts"]


def mesh_supervise_report(torch, runs, runs2, one_serve, one_reslot, serve,
                          cell, sup, world):
    """MESH_SUPERVISE's checks and lines: raises unless every rank took
    the same decisions; (a) the shrunk trainer came back on
    ``sup["train_mesh"]`` over the first survivors with the saved params
    digest, a data assignment of the survivors alone and its next loss
    within ``sup["loss_rtol"]`` of the uninterrupted run's; (b) the
    re-slotted engine holds the saved sessions' cache columns on
    ``sup["serve_mesh"]`` and its first step's logits lie within
    ``sup["logits_rel"]`` of a one-device re-slot of the same step;
    (c) the moved sessions' landed columns are the source's, the
    target's first logits within ``sup["logits_rel"]`` of a one-device
    restore's, and every rank's source gave up every session."""
    r0, s0 = runs[0], runs[0]["serve"]
    want = s0["tokens"]
    survivors = [h for h in range(world) if h != sup["dead"]]
    tr = [r["supervise"] for r in runs2]
    sv = [r["supervise_serve"] for r in runs2]
    for name, part in (("training", tr), ("serving", sv)):
        if len({repr(x["incident"]) for x in part}) != 1:
            raise AssertionError(f"mesh supervise: the ranks' {name} "
                                 f"incidents differ: "
                                 f"{[x['incident'] for x in part]}")
        if part[0]["action"] != "shrink":
            raise AssertionError(f"mesh supervise: {name}: "
                                 f"{part[0]['incident']}, not a shrink")
    n_train = math.prod(sup["train_mesh"])
    inside = [x for x in tr if not x["outside"]]
    if [not x["outside"] for x in tr] != [h in survivors[:n_train]
                                          for h in range(world)]:
        raise AssertionError("mesh supervise: the shrunk trainer is not on "
                             "the first survivors' ranks")
    for x in inside:
        if x["digest"] != r0["digest"] or x["step"] != r0["step"] or \
                tuple(x["mesh"]) != tuple(sup["train_mesh"]):
            raise AssertionError(f"mesh supervise: shrink onto {x['mesh']}:"
                                 f" digest {x['digest']} step {x['step']} "
                                 f"!= saved {r0['digest']} {r0['step']}")
        if not {h for h, _ in x["assignment"]} <= set(survivors):
            raise AssertionError(f"mesh supervise: data assignment "
                                 f"{x['assignment']} names a dead host")
        if abs(x["loss"] - r0["next_loss"]) > \
                sup["loss_rtol"] * abs(r0["next_loss"]):
            raise AssertionError(f"mesh supervise: the shrunk step's loss "
                                 f"{x['loss']} off {r0['next_loss']}")
    v0 = sv[0]
    ok = sum(v0["tokens"][k] == want[k] for k in v0["tokens"])
    rel = _rel_norm(torch, v0["logits"], one_reslot["logits"])
    if v0["columns"] != s0["columns"] or \
            tuple(v0["mesh"]) != tuple(sup["serve_mesh"]):
        raise AssertionError(f"mesh supervise: re-slot onto {v0['mesh']}: "
                             f"columns {v0['columns']} != saved "
                             f"{s0['columns']}")
    if rel > sup["logits_rel"]:
        raise AssertionError(f"mesh supervise: the re-slotted first step's "
                             f"logits {rel:.3e} off a one-device re-slot")
    mv = [r["serve"]["move"] for r in runs]
    m0 = mv[0]
    mrel = _rel_norm(torch, m0["logits"], one_serve["logits"])
    mok = sum(m0["tokens"][k] == want[k] for k in m0["tokens"])
    if m0["src"] != m0["landed"] or not m0["carried"] or \
            any(x["moved"] != m0["moved"] or x["left"] for x in mv):
        raise AssertionError(f"mesh supervise: the move: source columns "
                             f"{m0['src']} landed {m0['landed']}, carried "
                             f"{m0['carried']}, moved per rank "
                             f"{[x['moved'] for x in mv]}, left "
                             f"{[x['left'] for x in mv]}")
    if mrel > sup["logits_rel"]:
        raise AssertionError(f"mesh supervise: the moved sessions' first "
                             f"step's logits {mrel:.3e} off one device's")

    def phases(t):
        return (f"materialize {t.get('materialize_s', 0):.2f}, replay "
                f"{t.get('replay_s', 0):.2f}, rebind "
                f"{t.get('rebind_s', 0):.2f} s")
    log(f"mesh supervise: {cell['arch']} shrink (host {sup['dead']} dead) "
        f"onto {sup['train_mesh']} over ranks {inside[0]['ranks']} from "
        f"step {inside[0]['step']}: MTTR per rank "
        f"{[round(x['mttr_s'], 2) for x in tr]} s; restore "
        + "; ".join(f"r{i} {phases(x['timings'])}" for i, x in
                    enumerate(tr) if not x["outside"])
        + f"; the saved digest, loss {[x['loss'] for x in inside]} against "
        f"{r0['next_loss']} (limit {sup['loss_rtol']} relative), step ms "
        f"{[round(x['step_ms'], 1) for x in inside]}; peak device memory "
        f"per rank from the decision on GB "
        f"{[round(x['peak'] / 1e9, 3) for x in tr]}; staged collectives "
        f"per rank (calls, bytes, s) {[x['stats'] for x in tr]}")
    log(f"mesh supervise: {serve['arch']} re-slot onto {v0['n_slots']} "
        f"slots of {sup['serve_mesh']} from step {v0['step']}: MTTR per "
        f"rank {[round(x['mttr_s'], 2) for x in sv]} s; restore "
        f"{phases(v0['timings'])}; the saved sessions' columns, first "
        f"step {v0['first_ms']:.0f} ms, its logits {rel:.3e} off a "
        f"one-device re-slot, {ok} of {len(v0['tokens'])} requests token "
        f"for token, decode {_median(v0['step_ms']):.0f} ms a step")
    log(f"mesh supervise: live move off {serve['mesh']} onto one device: "
        f"{len(m0['moved'])} sessions, {m0['carried']} columns carried "
        f"(digest {m0['src']} on both ends), columns gathered in "
        f"{m0['columns_s']:.3f} s, capture {m0['capture_s']:.3f} s, "
        f"restore {m0['restore_s']:.3f} s, blackout {m0['blackout_s']:.3f} "
        f"s; first step's logits {mrel:.3e} off a one-device restore; {mok} "
        f"of {len(m0['tokens'])} requests token for token")


def _median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else 0.0


def mesh_path(torch, np, mods, device="cuda", cell=None, moe=None,
              serve=None, sup=None):
    """Training over a device mesh and elastic restore across meshes
    (ROADMAP A9a), four ranks on the one card: (a) ``MESH_TRAIN`` on a
    (2, 2) mesh through the flash kernels on each rank's local heads, a
    snapshot (the shards gathered whole; rank 0's capture kernels, its
    encode and commit behind the next step), one more step; (b) the
    group torn down; (c) the checkpoint
    restored onto (4, 1) and, in this process, onto one device, each
    restore's params digest the saved one bit for bit, each stepped once;
    (d) restored onto (2, 2) again, its step's loss and state digest the
    uninterrupted run's bit for bit; (e) llama4-scout's one-layer forward
    expert-parallel on (1, 4) against one rank; (f) ``compressed_psum``
    over the four ranks within 2 x scale of the exact mean; (g) the toy
    pipeline against the plain layer loop; ``MESH_SUPERVISE`` in both
    launches (``mesh_supervise_report``). Returns the ranks' flash and
    codec launches summed."""
    from repro_torch.api import CheckpointSession
    from repro_torch.configs import resolve_config
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import model as M
    from repro_torch.train.loop import Trainer
    from repro_torch.launch.serve import proportional_slots
    cell, moe = cell or MESH_TRAIN, moe or MESH_MOE
    serve, sup = serve or MESH_SERVE, sup or MESH_SUPERVISE
    world = int(np.prod(cell["mesh"]))
    store = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    serve_store = tempfile.mkdtemp(prefix="chip_smoke_mesh_serve_")
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def collectives_line(stats):
        return "; ".join(
            f"{k} {v['calls']} calls {v['bytes'] / 1e6:.1f} MB "
            f"{v['seconds']:.2f} s{' staged' if v['staged'] else ''}"
            for k, v in sorted(stats.items()))
    try:
        t0 = time.monotonic()
        runs = spawn_ranks(mesh_train_rank, world, device=device,
                           args=(device, store, cell, time.time(),
                                 serve_store, serve),
                           timeout_s=600)
        train_s = time.monotonic() - t0         # the group is torn down
        t0 = time.monotonic()
        sess = CheckpointSession(f"localfs:{store}")
        one = Trainer.restore(sess.manager, device=device)
        one_s = time.monotonic() - t0
        one_digest = one.params_digest()
        one_loss = one.train_steps(1)["loss"]
        sess.close()
        del one, sess
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t0 = time.monotonic()
        params = M.init_params(resolve_config(serve["arch"]), seed=0,
                               device=device)
        one_serve = mesh_serve_restore(torch, serve_store, serve, params,
                                       device)
        one_serve_s = time.monotonic() - t0
        one_reslot = mesh_serve_restore(
            torch, serve_store, serve, params, device,
            n_slots=proportional_slots(serve["n_slots"], world, world - 1))
        del params
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t0 = time.monotonic()
        runs2 = spawn_ranks(mesh_elastic_rank, world, device=device,
                            args=(device, store, cell, moe, time.time(),
                                  serve_store, serve, sup),
                            timeout_s=600)
        elastic_s = time.monotonic() - t0
    finally:
        shutil.rmtree(store, ignore_errors=True)
        shutil.rmtree(serve_store, ignore_errors=True)
    r0 = runs[0]
    for r in runs:
        add(r["counts"])
    if len({r["digest"] for r in runs}) != 1 or \
            len({tuple(r["losses"]) for r in runs}) != 1:
        raise AssertionError("ranks disagree on the losses or digest")
    log(f"mesh path: {cell['arch']} {cell['shape']} on {cell['mesh']} x "
        f"{world} ranks in {train_s:.1f} s (spawn included); plan "
        f"{r0['plan']}; losses {r0['losses']} then {r0['next_loss']}; "
        "step ms per rank (the last after the snapshot) "
        + "; ".join(f"r{i} {[round(m, 1) for m in r['step_ms']]}"
                    for i, r in enumerate(runs))
        + f"; snapshots (gather onto rank 0 and capture) "
        f"{[round(g, 2) for g in r0['gather_s']]} s, rank 0's encode + "
        f"commit {r0['encode_s']:.2f} s in the background "
        f"({r0['drain_s']:.2f} s left after the next step and the "
        f"digests); peak device memory per rank GB "
        f"{[round(r['peak'] / 1e9, 2) for r in runs]}")
    log(f"mesh path: rank 0's run, s from its spawn: {r0['marks']}")
    log(f"mesh path: collectives rank 0 (train, snapshot, digests): "
        f"{collectives_line(r0['stats'])}; launches rank 0 "
        f"{ {k: v for k, v in r0['counts'].items() if v} }")
    if device == "cuda" and not r0["counts"].get("fingerprint"):
        raise AssertionError(f"rank 0's snapshot missed the capture "
                             f"kernels: {r0['counts']}")
    if one_digest != r0["digest"]:
        raise AssertionError(f"(1, 1) restore digest {one_digest} != saved "
                             f"{r0['digest']}")

    def near(loss):
        return abs(loss - r0["next_loss"]) <= \
            cell["loss_rtol"] * abs(r0["next_loss"])
    if not near(one_loss):
        raise AssertionError(f"(1, 1) continuation loss {one_loss} off the "
                             f"uninterrupted {r0['next_loss']}")
    e0 = runs2[0]
    for r in runs2:
        add(r["counts"])
    for res in e0["restores"]:
        if res["digest"] != r0["digest"] or res["step"] != r0["step"]:
            raise AssertionError(f"restore onto {res['shape']}: digest "
                                 f"{res['digest']} step {res['step']} != "
                                 f"saved {r0['digest']} step {r0['step']}")
        if not near(res["loss"]):
            raise AssertionError(f"{res['shape']} continuation loss "
                                 f"{res['loss']} off the uninterrupted "
                                 f"{r0['next_loss']}")
    same = [r for r in e0["restores"] if tuple(r["shape"]) ==
            tuple(cell["mesh"])][0]
    if same["loss"] != r0["next_loss"] or \
            same["state_digest"] != r0["state_digest"]:
        raise AssertionError(
            f"{cell['mesh']} continuation: loss {same['loss']} digest "
            f"{same['state_digest']} != uninterrupted {r0['next_loss']} "
            f"{r0['state_digest']}")

    def phases(t):
        return (f"materialize {t.get('materialize_s', 0):.2f}, replay "
                f"{t.get('replay_s', 0):.2f}, rebind "
                f"{t.get('rebind_s', 0):.2f} s")
    log(f"mesh path: restores in {elastic_s:.1f} s (spawn included): "
        + "; ".join(f"{tuple(r['shape'])} {r['seconds']:.2f} s "
                    f"({phases(r['timings'])}), loss {r['loss']}, step "
                    f"{r['step_ms']:.0f} ms" for r in e0["restores"])
        + f"; (1, 1) in this process {one_s:.2f} s, loss {one_loss}; every "
        f"params digest the saved {r0['digest']}; {cell['mesh']}'s loss and "
        f"state digest bit-identical to the uninterrupted run's, the other "
        f"losses within {cell['loss_rtol']} relative")
    log(f"mesh path: rank 0's second run, s from its spawn: {e0['marks']}")
    for r in runs:
        add(r["serve"]["counts"])
    mesh_serve_report(torch, runs, runs2, one_serve, serve, world, device)
    mesh_supervise_report(torch, runs, runs2, one_serve, one_reslot, serve,
                          cell, sup, world)
    log(f"mesh serving: one device in this process {one_serve_s:.2f} s "
        f"(params made included); peak device memory per rank GB in the "
        f"second launch before llama4-scout's forward (training and "
        f"serving restores) "
        f"{[round(r['peak_before_moe'] / 1e9, 2) for r in runs2]}, and "
        f"from its forward on (reset between) "
        f"{[round(r['peak'] / 1e9, 2) for r in runs2]}")
    m = e0["moe"]
    # bf16 (ROADMAP C8): the mesh sums the attention's and the shared
    # expert's parts in another order, so a token whose top-1 choice is
    # a near tie can route to another expert; the tokens that kept their
    # choice are held at ``max_rel``
    if not m["finite"] or m["kept_rel"] > moe["max_rel"]:
        raise AssertionError(f"expert-parallel forward off one rank's: {m}")
    log(f"mesh path: {moe['arch']} forward_train on {moe['mesh']} "
        f"(capacity factor {moe['capacity_factor']}, B {moe['batch']} S "
        f"{moe['seq']}) in {m['ep_s']:.2f} s against one rank: "
        f"{m['flipped']} of {m['tokens']} tokens routed to another expert, "
        f"relative 2-norm error {m['kept_rel']:.3e} over the others (limit "
        f"{moe['max_rel']}), {m['rel']:.3e} over all (bits equal: "
        f"{m['equal']}), aux {m['aux']} vs {m['ref_aux']}")
    c = e0["compress"]
    if len({r["compress"]["hash"] for r in runs2}) != 1:
        raise AssertionError("the ranks' compressed_psum results differ")
    worst = c["err"] / c["scale"]
    if worst >= 2:
        raise AssertionError(f"compressed_psum off the exact mean: {worst} "
                             "x scale")
    log(f"mesh path: compressed_psum on {MESH_COMPRESS} f32 x {world} ranks "
        f"in {c['seconds']:.2f} s, max error {c['err']:.3e} = "
        f"{worst:.3f} x scale (limit 2)")
    pe = max(r["pipeline"]["err"] for r in runs2)
    if pe > 1e-5:
        raise AssertionError(f"pipeline off the layer loop by {pe}")
    log(f"mesh path: pipeline {MESH_PIPELINE} over {world} stages, max "
        f"error {pe:.2e} against the layer loop, bubble "
        f"{e0['pipeline']['bubble']:.3f}; collectives rank 0 (restores, "
        f"moe, compress, pipeline): {collectives_line(e0['stats'])}")
    return total


def ptxas_summary(report: str):
    """``kernel<hd>: registers[, spill bytes]`` per entry function of an
    ``nvcc -Xptxas -v`` report."""
    import re
    out, name = [], "?"
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"\d([a-z][a-z_]*_kernel)(?:ILi(\d+)E|I(f|13__nv_"
                          r"bfloat16)E)?", m.group(1))
            arg = t and (t.group(2) or {"f": "float", None: None}.get(
                t.group(3), "bf16"))
            name = (m.group(1)[-32:] if not t else t.group(1) if not arg
                    else f"{t.group(1)}<{arg}>")
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
    libs = (ops.LIB, fa.LIB, fa.LIB256, ssd.LIB, rg.LIB)
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.library(), libs))
    log(f"build: {len(libs)} nvcc {' '.join(ARCH_FLAGS)} in parallel, "
        f"{time.monotonic() - t0:.1f} s")
    for lib in libs:
        info = lib.build_info
        log(f"build: {lib.source.name} -> {info['path']} in "
            f"{info['seconds']:.1f} s; ptxas: "
            + "; ".join(ptxas_summary(info.get("ptxas", ""))))

    def phase(name, fn, *args):
        t = time.monotonic()
        out = fn(*args)
        log(f"phase {name}: {time.monotonic() - t:.1f} s")
        return out

    kernels = phase("check_kernels", check_kernels, torch, ops, ref)
    kernels.update(phase("check_codec", check_codec, torch, ops, ref))
    kernels.update(phase("check_flash", check_flash, torch, fa))
    kernels.update(phase("check_ssd", check_ssd, torch, ssd, ssd_ref))
    kernels.update(phase("check_rglru", check_rglru, torch, rg, rg_ref,
                         ssd_ref.within))
    kernels.update(phase("check_rglru_bwd", check_rglru_bwd, torch, rg,
                         rg_ref, ssd_ref.within))
    # each kernel's launches summed over the paths' runs (every path
    # sets the counts to 0 before it runs and reads them after)
    launches = dict.fromkeys(kernels, 0)

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    add(phase("main_path", main_path, torch, np, ops, fa))
    mods = {"codec": ops, "flash": fa, "ssd": ssd, "rg_lru": rg}
    add(phase("hybrid_path", hybrid_path, torch, np, mods))
    phase("ssm_serving_path", ssm_serving_path, torch, np, mods)
    phase("encdec_path", encdec_path, torch, np, mods)
    add(phase("moe_serving_path", moe_serving_path, torch, np, mods))
    add(phase("moe_topk_path", moe_topk_path, torch, np, mods))
    for cell in TRAIN_CELLS:
        add(phase(f"train_path {cell['arch']}", train_path, torch, np, mods,
                  cell))
    add(phase("moe_train_smoke", moe_train_smoke, torch, np, mods))
    add(phase("supervise_path", supervise_path, torch, np, mods))
    add(phase("mesh_path", mesh_path, torch, np, mods))
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
