"""Training planner — the port of the train branch of
``repro.parallel.planner``: choose the sharding rules, remat and
gradient accumulation of one (arch, shape, mesh) cell from an analytic
memory estimate against the device's budget.

``make_plan`` takes one device (``None``, a ``torch.device``) or a mesh
(a ``DeviceMesh`` with ``mesh_dim_names``, or any object whose ``shape``
maps axis names to sizes, as the reference's tests pass). One device is
the reference's 1x1 mesh.

On the CPU the estimate and the plan are the reference's, term for
term: per-chip params and two optimizer moments at ``moments_bytes``
each (1: int8 block-quantized, the reference's default), sharded over
model x data (ZeRO-3 FSDP), a gradient accumulator when accumulating,
and activations under full remat (one residual per layer boundary,
divided by the model axis under sequence sharding, plus 3x the logits
divided by it) for the local batch, against 0.9 x the JAX package's TPU
v5e constant (16 GiB); the notes are the reference's strings. Its params
come from ``ModelConfig.n_params()``, which counts 6,611,185,664 for
recurrentgemma-9b against 8,524,206,080 template leaves.

On a CUDA card (``card_plan``) the estimate counts what the port
stores, a port-only divergence (ROADMAP C9, C14): params from the
template's leaves, AdamW's moments as the f32 they are below 5e10
params (8 bytes a param), the gradients in the params' dtype (autograd
holds them all before the update), each divided by the rank's share of
the mesh, against 0.9 x the card's ``total_memory``, less the whole
state a snapshot gathers onto rank 0 of a mesh, divided among the
ranks that share the card; where params and moments alone exceed that
budget the plan raises before anything is allocated, naming the bytes
and ROADMAP A9 (sharding over cards). Serving plans wait for ROADMAP
A9b; of the serving estimate only the ssm and hybrid branches (params,
the decode state, activations) are here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.parallel.sharding import (ParallelPlan, axis_sizes,
                                           train_rules)

HBM_BYTES = 16 * 1024**3       # the reference's per-chip budget (TPU v5e)

ONE_DEVICE = {"data": 1, "model": 1}


def _bytes_per_param(dtype: str = "bfloat16") -> int:
    return 2 if "16" in dtype else 4


def is_mesh(mesh) -> bool:
    """A mesh (named axes with sizes), as opposed to one device."""
    return getattr(mesh, "mesh_dim_names", None) is not None or \
        isinstance(getattr(mesh, "shape", None), dict)


def _sizes(mesh) -> Dict[str, int]:
    return axis_sizes(mesh) if is_mesh(mesh) else dict(ONE_DEVICE)


def _mesh_sizes(sizes: Dict[str, int]) -> Tuple[int, int, int]:
    return int(sizes.get("pod", 1)), int(sizes["data"]), int(sizes["model"])


def _on_card(device) -> bool:
    if device is None:
        return False
    if is_mesh(device):
        return getattr(device, "device_type", None) == "cuda"
    return torch.device(device).type == "cuda"


def _ranks_per_card(mesh) -> int:
    """Ranks of ``mesh`` that share one card (all of them on a one-card
    machine)."""
    if not is_mesh(mesh):
        return 1
    n = 1
    for v in _sizes(mesh).values():
        n *= v
    return max(1, n // max(1, torch.cuda.device_count()))


@dataclass
class MemoryEstimate:
    params: float
    opt_state: float            # moments, plus the accumulator if any
    activations: float
    total: float
    kv_cache: float = 0.0       # serving: the decode state

    def fits(self, budget: float = 0.9 * HBM_BYTES) -> bool:
        return self.total < budget


def _activations(cfg: ModelConfig, shape: ShapeConfig, grad_accum: int,
                 sizes: Dict[str, int]) -> float:
    """Per-chip activations under full remat, sequence-sharded: one
    residual per layer boundary plus 3x the vocab-sharded logits."""
    pod, dp, tp = _mesh_sizes(sizes)
    bp = _bytes_per_param(cfg.dtype)
    toks = shape.global_batch / (pod * dp) / grad_accum * shape.seq_len
    resid = toks * cfg.d_model * bp / tp
    depth = cfg.n_layers + (cfg.n_encoder_layers or 0)
    return resid * (depth + 2) + toks * cfg.vocab_size * bp / tp * 3


def estimate_train_memory(cfg: ModelConfig, shape: ShapeConfig,
                          grad_accum: int, moments_bytes: int = 1,
                          mesh=None) -> MemoryEstimate:
    """Per-chip bytes of the reference's train branch (FSDP and sequence
    sharding on) on ``mesh`` (default: one device)."""
    pod, dp, tp = _mesh_sizes(_sizes(mesh))
    n = cfg.n_params()
    bp = _bytes_per_param(cfg.dtype)
    pshards = tp * pod * dp
    params = n * bp / pshards
    opt = n * (2 * moments_bytes) / pshards
    grads = n * bp / pshards if grad_accum > 1 else 0.0
    acts = _activations(cfg, shape, grad_accum, _sizes(mesh))
    total = params + opt + grads + acts
    return MemoryEstimate(params, opt + grads, acts, total)


def _template_params(cfg: ModelConfig) -> int:
    from repro_torch.models.model import param_count
    return param_count(cfg)


def _moment_bytes(cfg: ModelConfig) -> int:
    """Bytes a param of AdamW's two moments as stored: f32, or int8 codes
    with f32 block scales above 5e10 params (the reference's rule)."""
    return 2 if cfg.n_params() > 5e10 else 8


def estimate_card_train_memory(cfg: ModelConfig, shape: ShapeConfig,
                               grad_accum: int,
                               mesh=None) -> MemoryEstimate:
    """Bytes on one rank as the port stores them: its share of the
    template's params in the model dtype, of the f32 AdamW moments (int8
    codes and f32 block scales above 5e10 params, the reference's rule)
    and of the gradients in the params' dtype plus an f32 accumulator
    when accumulating, and the reference's per-chip activation term.
    ``opt_state`` holds the moments, the gradients and the accumulator."""
    pod, dp, tp = _mesh_sizes(_sizes(mesh))
    n = _template_params(cfg) / (pod * dp * tp)
    bp = _bytes_per_param(cfg.dtype)
    params = n * bp
    moments = n * _moment_bytes(cfg)
    grads = n * bp + (n * 4 if grad_accum > 1 else 0)
    acts = _activations(cfg, shape, grad_accum, _sizes(mesh))
    return MemoryEstimate(params, moments + grads, acts,
                          params + moments + grads + acts)


def _train_plan(sizes: Dict[str, int], **kw) -> ParallelPlan:
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    return ParallelPlan(rules=train_rules(True, batch_axes),
                        batch_axes=batch_axes, remat="full",
                        seq_shard=True, **kw)


def snapshot_gather_bytes(cfg: ModelConfig, mesh=None) -> float:
    """Bytes a snapshot or a digest adds on rank 0 of a mesh of more than
    one rank (0 on one device): the whole state gathered onto its device
    — every param in the model dtype and its AdamW moments as stored —
    plus one leaf's blocks while that leaf is placed
    (``collectives.gather_to``). The other ranks add nothing."""
    pod, dp, tp = _mesh_sizes(_sizes(mesh))
    if pod * dp * tp == 1:
        return 0.0
    from repro_torch.models.model import param_template
    from repro_torch.tree import flatten_with_paths
    n = _template_params(cfg)
    largest = max(int(np.prod(leaf.shape)) for _, leaf
                  in flatten_with_paths(param_template(cfg)))
    return n * (_bytes_per_param(cfg.dtype) + _moment_bytes(cfg)) \
        + largest * 4


def card_plan(cfg: ModelConfig, shape: ShapeConfig, total_memory: float,
              mesh=None) -> ParallelPlan:
    """The plan on a CUDA card of ``total_memory`` bytes for one rank of
    ``mesh`` (default: one device): the escalating accumulation search
    against 0.9 x that, less rank 0's snapshot gather
    (``snapshot_gather_bytes``), divided among the ranks sharing the
    card, with the port's own count (``estimate_card_train_memory``).
    Raises ``MemoryError`` where params and moments alone exceed the
    budget."""
    sizes = _sizes(mesh)
    gather = snapshot_gather_bytes(cfg, mesh)
    budget = (0.9 * total_memory - gather) / _ranks_per_card(mesh)
    est1 = estimate_card_train_memory(cfg, shape, 1, mesh)
    n = _template_params(cfg)
    pod, dp, tp = _mesh_sizes(sizes)
    moments = n / (pod * dp * tp) * _moment_bytes(cfg)
    if est1.params + moments > budget:
        raise MemoryError(
            f"{cfg.name}: {n} params ({est1.params / 1e9:.1f} GB a rank in "
            f"{cfg.dtype}) and their AdamW moments ({moments / 1e9:.1f} GB)"
            f" take {(est1.params + moments) / 1e9:.1f} GB, "
            f"{(est1.params + est1.opt_state) / 1e9:.1f} GB with the "
            f"gradients, past 0.9 x the card's {total_memory / 1e9:.1f} GB "
            f"less rank 0's {gather / 1e9:.1f} GB snapshot gather, shared "
            f"by {_ranks_per_card(mesh)} rank(s) ({budget / 1e9:.1f} GB); "
            "training it needs its state sharded over cards (ROADMAP A9) "
            "or a depth cut (<arch>-layers<N>)")
    for accum in (1, 4, 16):
        est = estimate_card_train_memory(cfg, shape, accum, mesh)
        if est.fits(budget):
            return _train_plan(
                sizes, grad_accum=accum,
                notes=f"train accum={accum} est={est.total / 1e9:.1f}GB "
                      "(card)")
    return _train_plan(
        sizes, grad_accum=16,
        notes=f"train OVERBUDGET est={est.total / 1e9:.1f}GB (card)")


def estimate_serve_memory(cfg: ModelConfig,
                          shape: ShapeConfig) -> MemoryEstimate:
    """Bytes of an ssm or hybrid serving cell on the one device — those
    branches of the reference's ``estimate_serve_memory`` with no
    sharding: params, the decode state and activations. The ssm state is
    the f32 scan state plus the conv windows; the hybrid's, the windowed
    KV caches of its attention layers plus each recurrent layer's f32
    state and conv window. The other families wait for ROADMAP A9b."""
    if cfg.family not in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the port estimates serving memory for the ssm "
            "and hybrid families only; the rest waits for ROADMAP A9b")
    n = cfg.n_params()
    bp = _bytes_per_param(cfg.dtype)
    params = n * bp
    b_eff = max(shape.global_batch, 1)
    if cfg.family == "ssm":
        d_in = cfg.ssm_expand * cfg.d_model
        nh = d_in // cfg.ssm_head_dim
        per_layer = b_eff * (nh * cfg.ssm_head_dim * cfg.ssm_state * 4
                             + 3 * d_in * bp)
        cache = per_layer * cfg.n_layers
    else:
        w = cfg.rglru_width or cfg.d_model
        period = len(cfg.block_pattern)
        n_attn = sum(1 for i in range(cfg.n_layers)
                     if cfg.block_pattern[i % period] == "attn")
        n_rec = cfg.n_layers - n_attn
        win = min(cfg.attn_window or shape.seq_len, shape.seq_len)
        kv = b_eff * win * cfg.n_kv_heads * cfg.resolved_head_dim * 2 * bp
        cache = n_attn * kv + n_rec * b_eff * w * (4 + 3 * bp)
    acts = b_eff * max(shape.seq_len if shape.kind == "prefill" else 1, 1) \
        * cfg.d_model * bp * 4
    return MemoryEstimate(params, 0.0, acts, params + cache + acts, cache)


def make_plan(cfg: ModelConfig, shape: ShapeConfig,
              mesh=None) -> ParallelPlan:
    """Escalating search over gradient accumulation 1 -> 4 -> 16 for a
    plan whose estimate fits the budget of one rank of ``mesh`` (one
    device by default): on a CUDA card ``card_plan``'s, elsewhere the
    reference's train branch, term for term."""
    if shape.kind != "train":
        raise NotImplementedError(
            f"{shape.name}: the port plans training only; serving plans "
            "wait for ROADMAP A9b")
    if _on_card(mesh):
        dev = mesh if not is_mesh(mesh) else torch.device(
            "cuda", torch.cuda.current_device())
        return card_plan(cfg, shape, torch.cuda.get_device_properties(
            dev).total_memory, mesh if is_mesh(mesh) else None)
    sizes = _sizes(mesh)
    budget = 0.9 * HBM_BYTES
    est1 = estimate_train_memory(cfg, shape, 1, mesh=mesh)
    static = est1.params + est1.opt_state
    if static > budget:
        return _train_plan(
            sizes, grad_accum=1,
            notes=f"train OVERBUDGET static={static/2**30:.1f}GiB "
                  f"est={est1.total/2**30:.1f}GiB (params+opt exceed "
                  f"HBM at this chip count; accum would only add "
                  f"gather traffic — needs the multi-pod mesh)")
    for accum in (1, 4, 16):
        est = estimate_train_memory(cfg, shape, accum, mesh=mesh)
        if est.fits(budget):
            return _train_plan(
                sizes, grad_accum=accum,
                notes=f"train fsdp=True seq_shard=True "
                      f"accum={accum} est={est.total/2**30:.1f}GiB")
    est = estimate_train_memory(cfg, shape, 16, mesh=mesh)
    return _train_plan(
        sizes, grad_accum=16,
        notes=f"train OVERBUDGET est={est.total/2**30:.1f}GiB "
              f"(needs more chips; fits on multi-pod? see EXPERIMENTS)")
