"""Dry run: trace one step of every (architecture x input shape) cell
for one rank of the production meshes, or for one H100, with nothing
allocated; prove that its memory fits and count its roofline terms —
the port of ``repro.launch.dryrun``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh card

Meshes (``--mesh``): ``card`` is one H100 with no process group;
``single`` the reference's (16, 16) over (data, model), ``multi`` its
(2, 16, 16) over (pod, data, model), ``both`` the two in turn; ``small``
is (2, 4) over (data, model), what the tests trace. A mesh of 256 or 512
ranks is built over a fake process group
(``torch.testing._internal.distributed.fake_pg``: every collective
returns at once and moves nothing) in a process of its own — the group
is process-wide, as the reference's 512 placeholder devices are — and
its rank 0 traces its own blocks. No collective shim is installed.

The step runs once under ``FakeTensorMode``: params, optimizer state,
inputs and the cache are fake tensors, each rank's local block placed as
the plan says (``parallel.planner.card_plan`` for an H100 of
``hlo_analysis.HBM_BYTES``, one rank a card), and no memory is
allocated and no kernel launches. The fake tensors lie on the CPU and
the step runs inside ``kernels.trace.card_trace``, which sends them
down the card's routes (PyTorch built without CUDA cannot record
autograd on a fake CUDA tensor): flash attention in the model and each
kernel wrapper's fake route, which allocates what its CUDA route
allocates. ``--route plain`` traces the CPU's plain route instead (one
device; attention is the dense product, as JAX's is), what the tests
hold against the reference's compiled steps. The call is traced by
``hlo_analysis.Analyzer``: the train step (``train.step.make_train_step``,
remat as on the card), or the prefill or decode step
(``serving.engine.sharded_prefill`` / ``sharded_decode_step`` over a
mesh, the model's ``prefill`` / ``decode_step`` on one device).

Memory: ``argument_bytes`` are params, optimizer state, inputs and
cache; ``temp_bytes`` the peak of everything else the call keeps alive;
``named_bytes`` what the trace cannot see (``named_terms``: cuBLAS's
workspaces, from ``CUBLAS_WORKSPACE_CONFIG``); ``live_bytes`` the three
together, and ``fits`` is ``live_bytes`` under 0.98 x the H100's
``total_memory`` (in place of the reference's ``fits_16g``).

Results land in ``build/dryrun/<mesh>/<arch>__<shape>.json`` with the
reference's keys, except that ``lower_s`` and ``compile_s`` are one
``trace_s`` and there is no ``xla_cost`` (there is no XLA). A cell that
fails (a plan ``card_plan`` refuses with ``MemoryError``; on a mesh an
ssm, hybrid or encoder-decoder cell, whose model raises until ROADMAP
A9b step 4) is printed with its error, and ``main`` then exits 1, as the
reference's does.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from contextlib import nullcontext
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import registry as cfg_registry
from repro_torch.configs.base import shapes_for
from repro_torch.kernels.trace import card_trace
from repro_torch.launch import hlo_analysis as HA
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.models.params import torch_dtype
from repro_torch.tree import fill_like, flatten_with_paths

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "small": ((2, 4), ("data", "model"))}
FITS_SHARE = 0.98


def cublas_workspace_bytes() -> int:
    """cuBLAS's workspaces, which the caching allocator holds and the
    trace cannot see: ``CUBLAS_WORKSPACE_CONFIG`` (``:KiB:count`` pairs;
    ``:4096:8`` where unset, as ``chip_smoke.py`` sets it) for each of
    two cuBLAS handles — the step's thread and autograd's device thread,
    which runs the backward."""
    spec = os.environ.get("CUBLAS_WORKSPACE_CONFIG") or ":4096:8"
    parts = [int(p) for p in spec.split(":") if p]
    return 2 * sum(kib * 1024 * n for kib, n in zip(parts[0::2], parts[1::2]))


def process_mesh(mesh_kind: str):
    """The mesh of ``mesh_kind`` over this process's fake group, which
    it starts (the mesh's ranks, this process rank 0); None for
    ``card``."""
    if mesh_kind == "card":
        return None
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, axes = MESHES[mesh_kind]
    n = int(np.prod(shape))
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    return make_mesh(shape, axes, device="cpu")


def _plan(cfg, shape, mesh, route: str, overrides):
    from repro_torch.parallel.planner import card_plan, make_plan
    if route == "plain":
        plan = make_plan(cfg, shape, mesh)
    else:
        plan = card_plan(cfg, shape, HA.HBM_BYTES, mesh, ranks_per_card=1)
    return plan.with_(**overrides) if overrides else plan


def _params(cfg, plan, mesh, train: bool):
    """Fake params of the template's shapes and dtypes: this rank's
    blocks on a mesh (the train or the serve plan's placements)."""
    tmpl = M.param_template(cfg)
    whole = {p: torch.empty(leaf.shape, dtype=torch_dtype(
        leaf.dtype or cfg.dtype)) for p, leaf in flatten_with_paths(tmpl)}
    if mesh is None:
        return fill_like(tmpl, whole)
    if not train:
        from repro_torch.serving.engine import place_params
        return place_params(cfg, fill_like(tmpl, whole), plan, mesh)
    from repro_torch.parallel.sharding import leaf_placements, shard_tensor
    places = leaf_placements(plan, tmpl, mesh)
    return fill_like(tmpl, {p: shard_tensor(t, mesh, places[p])
                            for p, t in whole.items()})


def _cache(cfg, shape, mesh, plan):
    if mesh is None:
        return M.init_cache(cfg, shape.global_batch, shape.seq_len,
                            device="cpu")
    from repro_torch.serving.kv_cache import sharded_cache
    return sharded_cache(cfg, shape.global_batch, shape.seq_len, mesh, plan)


def lower_cell(arch: str, shape_key: str, mesh, plan_overrides=None,
               route: str = "card"):
    """(analyzer, plan): one call of the cell's step traced for this
    rank under ``FakeTensorMode`` (see the module docstring)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.train import step as step_lib
    cfg = cfg_registry.resolve_config(arch)
    shape = cfg_registry.get_shape(shape_key)
    plan = _plan(cfg, shape, mesh, route, plan_overrides)
    b = shape.global_batch
    a = HA.Analyzer()
    trace = card_trace() if route == "card" else nullcontext()
    with FakeTensorMode(), trace:
        if shape.kind == "train":
            from repro_torch.optim import ScheduleConfig, init_opt_state
            params = _params(cfg, plan, mesh, train=True)
            opt_cfg = step_lib.default_opt_config(cfg)
            opt = init_opt_state(params, opt_cfg)
            batch = {k: torch.empty(s.shape, dtype=s.dtype) for k, s in
                     step_lib.train_input_specs(cfg, shape).items()}
            lr_scale = torch.tensor(1.0, dtype=torch.float32)
            fn = step_lib.make_train_step(cfg, plan, opt_cfg,
                                          ScheduleConfig(), mesh=mesh)
            a.hold(params, opt, batch)
            with a:
                fn(params, opt, batch, 0, lr_scale)
            return a, plan
        params = _params(cfg, plan, mesh, train=False)
        cache = _cache(cfg, shape, mesh, plan)
        frames = torch.empty((b, cfg.encoder_seq, cfg.frontend_dim),
                             dtype=torch.float32) \
            if cfg.is_encoder_decoder else None
        if shape.kind == "prefill":
            tokens = torch.empty((b, shape.seq_len), dtype=torch.int32)
            a.hold(params, cache, tokens, frames)
            with torch.no_grad(), a:
                if mesh is None:
                    M.prefill(cfg, params, tokens, cache, frames=frames)
                else:
                    from repro_torch.serving.engine import sharded_prefill
                    sharded_prefill(cfg, shape, mesh, plan)(params, tokens,
                                                            cache)
            return a, plan
        tokens = torch.empty((b, 1), dtype=torch.int32)
        pos = torch.empty((b,), dtype=torch.int32)
        a.hold(params, cache, tokens, pos)
        with torch.no_grad(), a:
            if mesh is None:
                M.decode_step(cfg, params, cache, tokens, pos)
            else:
                from repro_torch.serving.engine import sharded_decode_step
                sharded_decode_step(cfg, shape, mesh, plan)(params, cache,
                                                            tokens, pos)
        return a, plan


def run_cell(arch: str, shape_key: str, mesh_kind: str,
             plan_overrides=None, tag: str = "", route: str = "card"
             ) -> dict:
    """One cell's result dict (the reference's keys; see the module
    docstring). On ``single`` or ``multi`` this process's fake group is
    started if it is not yet."""
    cfg = cfg_registry.resolve_config(arch)
    shape = cfg_registry.get_shape(shape_key)
    mesh = process_mesh(mesh_kind)
    n_chips = 1 if mesh is None else int(np.prod(list(mesh.shape)))

    t0 = time.monotonic()
    a, plan = lower_cell(arch, shape_key, mesh, plan_overrides, route)
    t_trace = time.monotonic() - t0

    named = {"cublas_workspace_bytes": cublas_workspace_bytes()} \
        if route == "card" else {}
    mem = {"argument_bytes": int(a.argument_bytes),
           "temp_bytes": int(a.temp_bytes),
           "named_bytes": int(sum(named.values())),
           "named_terms": named}
    live = mem["argument_bytes"] + mem["temp_bytes"] + mem["named_bytes"]
    mem["live_bytes"] = live
    mem["fits"] = bool(live < FITS_SHARE * HA.HBM_BYTES)

    counts = a.counts
    terms = HA.roofline_terms(counts)
    terms_kernel = HA.roofline_terms(counts, kernel_adjusted=True)
    launches = counts.launch_counts()
    # the launches by kernel: each kernel's own work and the plain
    # version's in its place (the reference's fused loops)
    fused = {}
    for rec in counts.launches:
        f = fused.setdefault(rec.kernel, {"kernel": rec.kernel, "launches": 0,
                                          "gb": 0.0, "plain_gb": 0.0,
                                          "gflop": 0.0, "plain_gflop": 0.0})
        f["launches"] += 1
        f["gb"] += rec.hbm_bytes / 1e9
        f["plain_gb"] += rec.plain_bytes / 1e9
        f["gflop"] += rec.flops / 1e9
        f["plain_gflop"] += rec.plain_flops / 1e9

    n_active = cfg.n_active_params()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens
    model_flops_per_chip = model_flops / n_chips
    parsed = counts.flops
    useful = model_flops_per_chip / parsed if parsed else 0.0

    return {
        "arch": arch, "shape": shape_key, "mesh": mesh_kind,
        "chips": n_chips, "tag": tag, "route": route,
        "plan": plan.notes,
        "plan_overrides": plan_overrides or {},
        "trace_s": round(t_trace, 2),
        "memory": mem,
        "parsed": {
            "flops_per_chip": counts.flops,
            "hbm_bytes_per_chip": counts.hbm_bytes,
            "collective_bytes_per_chip": counts.collective_bytes,
            "collective_breakdown": counts.collective_breakdown,
            "n_collectives": counts.n_collectives,
            "n_ops": counts.n_ops,
            "upper_bound_ops": counts.upper_bound_ops,
        },
        "roofline": terms,
        "roofline_kernel_adjusted": terms_kernel,
        "fused_loops": list(fused.values()),
        "launches": launches,
        "model_flops_per_chip": model_flops_per_chip,
        "useful_flops_ratio": useful,
        "hw": {"device": HA.DEVICE, "peak_flops": HA.PEAK_FLOPS,
               "hbm_bw": HA.HBM_BW, "nvlink_bw": HA.NVLINK_BW,
               "hbm_bytes": HA.HBM_BYTES},
    }


def out_path(arch: str, shape_key: str, mesh_kind: str, tag: str = "",
             results_dir: Optional[Path] = None) -> Path:
    d = (results_dir or RESULTS_DIR) / mesh_kind
    d.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    return d / f"{arch}__{shape_key}{suffix}.json"


def _cells(args):
    if args.all:
        return [(arch, s.name) for arch in cfg_registry.ARCH_IDS
                for s in shapes_for(cfg_registry.get_config(arch))]
    if not (args.arch and args.shape):
        raise SystemExit("give --arch and --shape, or --all")
    return [(args.arch, args.shape)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("card", "single", "multi", "both",
                                       "small"), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="", help="variant label (perf exps)")
    ap.add_argument("--plan-overrides", default="",
                    help='json, e.g. {"seq_shard": true}')
    ap.add_argument("--route", choices=("card", "plain"), default="card",
                    help="plain: the CPU's plain route, one device")
    ap.add_argument("--out-dir", default=None,
                    help=f"results root (default {RESULTS_DIR})")
    args = ap.parse_args(argv)

    if args.mesh == "both":
        # one process a mesh: the fake group is process-wide (the last
        # --mesh given wins)
        rest = list(argv if argv is not None else sys.argv[1:])
        codes = [subprocess.run([sys.executable, "-m",
                                 "repro_torch.launch.dryrun", *rest,
                                 "--mesh", kind]).returncode
                 for kind in ("single", "multi")]
        raise SystemExit(max(codes))
    if args.route == "plain" and args.mesh != "card":
        raise SystemExit("--route plain traces one device: --mesh card")

    overrides = json.loads(args.plan_overrides) if args.plan_overrides \
        else None
    out_dir = Path(args.out_dir) if args.out_dir else None
    failures = []
    for arch, shape_key in _cells(args):
        p = out_path(arch, shape_key, args.mesh, args.tag, out_dir)
        if args.skip_existing and p.exists():
            print(f"skip {p.name} ({args.mesh})")
            continue
        print(f"=== {arch} x {shape_key} on {args.mesh} ===", flush=True)
        try:
            res = run_cell(arch, shape_key, args.mesh, overrides, args.tag,
                           args.route)
            p.write_text(json.dumps(res, indent=1))
            r = res["roofline"]
            print(f"ok: dominant={r['dominant']} "
                  f"compute={r['compute_s']:.4f}s "
                  f"memory={r['memory_s']:.4f}s "
                  f"collective={r['collective_s']:.4f}s "
                  f"frac={r['roofline_fraction']:.2f} "
                  f"live={res['memory']['live_bytes']/2**30:.1f}GiB "
                  f"fits={res['memory']['fits']} "
                  f"trace={res['trace_s']}s", flush=True)
        except Exception as e:
            traceback.print_exc()
            failures.append((args.mesh, arch, shape_key, repr(e)))
    if failures:
        print("FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
