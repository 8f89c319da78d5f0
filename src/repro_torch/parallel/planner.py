"""The planner — the port of ``repro.parallel.planner``: choose the
sharding rules, remat and gradient accumulation (training) or the
weight-sharding depth and KV-cache layout (serving) of one (arch,
shape, mesh) cell from an analytic memory estimate against the
device's budget.

``make_plan`` takes one device (``None``, a ``torch.device``) or a mesh
(a ``DeviceMesh`` with ``mesh_dim_names``, or any object whose ``shape``
maps axis names to sizes, as the reference's tests pass). One device is
the reference's 1x1 mesh.

On the CPU the estimates and the plans are the reference's, term for
term. Training: per-chip params and two optimizer moments at
``moments_bytes`` each (1: int8 block-quantized, the reference's
default), sharded over model x data (ZeRO-3 FSDP), a gradient
accumulator when accumulating, and activations under full remat (one
residual per layer boundary, divided by the model axis under sequence
sharding, plus 3x the logits divided by it) for the local batch.
Serving: params over the model axis (depth 1) or model x data (depth 2,
2D weight sharding), the decode state of the local slots (the KV cache
divided by the model axis where its heads or, escalated, its sequence
split; the ssm and hybrid states; the encoder-decoder's cross cache)
and four residuals of the local tokens; the search escalates depth 1
-> 2 -> 2 with the cache's sequence over the model axis, and the cache
takes the sequence split wherever the KV heads do not divide the model
axis. Both against 0.9 x the JAX package's TPU v5e constant (16 GiB);
the notes are the reference's strings. Params come from
``ModelConfig.n_params()``, which counts 6,611,185,664 for
recurrentgemma-9b against 8,524,206,080 template leaves.

On a CUDA card (``card_plan``) the estimates count what the port
stores, a port-only divergence (ROADMAP C9, C14), against 0.9 x the
card's ``total_memory`` less what a snapshot gathers onto rank 0 of a
mesh, divided among the ranks that share the card. Training: params
from the template's leaves, AdamW's moments as the f32 they are below
5e10 params (8 bytes a param), the gradients in the params' dtype
(autograd holds them all before the update), each divided by the rank's
share of the mesh; where params and moments alone exceed the budget the
plan raises before anything is allocated, naming the bytes and ROADMAP
A9 (sharding over cards). Serving: each template leaf's and each cache
leaf's block under the candidate plan's placements, the reference's
activation term, and rank 0's gather of the whole cache; it raises
``MemoryError`` the same way where no depth fits.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.parallel.sharding import (ParallelPlan, axis_sizes,
                                           cache_specs, serve_rules,
                                           spec_for_axes, train_rules)

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


def _ranks_per_card(mesh, ranks_per_card=None) -> int:
    """Ranks of ``mesh`` that share one card: ``ranks_per_card`` where
    given, else the mesh's ranks over this machine's cards (all of them
    on a one-card machine)."""
    if ranks_per_card is not None:
        return int(ranks_per_card)
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
              mesh=None, ranks_per_card=None) -> ParallelPlan:
    """The plan on a CUDA card of ``total_memory`` bytes for one rank of
    ``mesh`` (default: one device): the escalating accumulation search
    against 0.9 x that, less rank 0's snapshot gather
    (``snapshot_gather_bytes``), divided among the ranks sharing the
    card, with the port's own count (``estimate_card_train_memory``).
    The mesh's own ranks are counted, so a restore onto the survivors of
    a shrink (a mesh over part of the world, whose ranks each hold a
    larger share) is planned for what they hold. Raises ``MemoryError``
    where params and moments alone exceed the budget, before anything is
    allocated. A prefill or decode shape takes ``card_serve_plan``.
    ``ranks_per_card`` (default: the mesh's ranks over this machine's
    cards) plans a mesh of other machines, as the dry run does."""
    if shape.kind != "train":
        return card_serve_plan(cfg, shape, total_memory, mesh,
                               ranks_per_card)
    sizes = _sizes(mesh)
    gather = snapshot_gather_bytes(cfg, mesh)
    share = _ranks_per_card(mesh, ranks_per_card)
    budget = (0.9 * total_memory - gather) / share
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
            f"by {share} rank(s) ({budget / 1e9:.1f} GB); "
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


def estimate_serve_memory(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                          depth: int = 1,
                          cache_seq_shard: bool = False) -> MemoryEstimate:
    """Per-chip bytes of the reference's serving branch on ``mesh``
    (default: one device), term for term: params over the model axis
    (and the data axes at ``depth`` 2), the decode state of the local
    slots, four residuals of the local tokens."""
    pod, dp, tp = _mesh_sizes(_sizes(mesh))
    n = cfg.n_params()
    bp = _bytes_per_param(cfg.dtype)
    pshards = tp * ((pod * dp) if depth >= 2 else 1)
    params = n * bp / pshards

    # KV cache / recurrent state
    data_shards = pod * dp
    b_eff = max(shape.global_batch / data_shards, 1)
    if cfg.family == "ssm":
        d_in = cfg.ssm_expand * cfg.d_model
        nh = d_in // cfg.ssm_head_dim
        per_layer = b_eff * (nh * cfg.ssm_head_dim * cfg.ssm_state * 4 / tp
                             + 3 * d_in * bp)
        cache = per_layer * cfg.n_layers
    elif cfg.family == "hybrid":
        w = cfg.rglru_width or cfg.d_model
        period = len(cfg.block_pattern)
        n_attn = sum(1 for i in range(cfg.n_layers)
                     if cfg.block_pattern[i % period] == "attn")
        n_rec = cfg.n_layers - n_attn
        win = min(cfg.attn_window or shape.seq_len, shape.seq_len)
        kv = b_eff * win * cfg.n_kv_heads * cfg.resolved_head_dim * 2 * bp
        cache = n_attn * kv + n_rec * b_eff * w * (4 + 3 * bp)
    else:
        smax = min(cfg.attn_window, shape.seq_len) if cfg.attn_window \
            else shape.seq_len
        seq_div = tp if cache_seq_shard else (
            tp if cfg.n_kv_heads % tp == 0 else 1)
        kv = b_eff * smax * cfg.n_kv_heads * cfg.resolved_head_dim * 2 * bp \
            / seq_div
        cache = kv * cfg.n_layers
        if cfg.is_encoder_decoder:
            cache += (b_eff * cfg.encoder_seq * cfg.n_kv_heads *
                      cfg.resolved_head_dim * 2 * bp) * cfg.n_layers

    acts = b_eff * max(shape.seq_len if shape.kind == "prefill" else 1, 1) \
        * cfg.d_model * bp * 4
    return MemoryEstimate(params, 0.0, acts, params + cache + acts, cache)


SERVE_DEPTHS = ((1, False), (2, False), (2, True))   # (depth, cache_seq)


def _serve_plan(cfg: ModelConfig, sizes: Dict[str, int], depth: int,
                cache_seq: bool, note: str) -> ParallelPlan:
    """The serving plan at ``depth``: the cache's sequence over the model
    axis when escalated to it or when the KV heads do not divide it."""
    _, _, tp = _mesh_sizes(sizes)
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    cache_axis = "model" if (
        cache_seq or (cfg.n_kv_heads and tp and cfg.n_kv_heads % tp != 0
                      and cfg.family not in ("ssm",))) else None
    return ParallelPlan(
        rules=serve_rules(depth, batch_axes), batch_axes=batch_axes,
        remat="none", seq_shard=False, cache_seq_axis=cache_axis,
        notes=f"serve depth={depth} cache_seq={cache_axis} {note}")


def _leaf_bytes(shape, axes_spec, sizes: Dict[str, int], esize: int
                ) -> float:
    """Bytes of one rank's block of a leaf of ``shape`` under the
    partition spec ``axes_spec``."""
    div = 1
    for tgt in axes_spec:
        for a in (() if tgt is None else (tgt,) if isinstance(tgt, str)
                  else tgt):
            div *= sizes[a]
    return float(np.prod(shape)) * esize / div


def serve_gather_bytes(cfg: ModelConfig, shape: ShapeConfig,
                       mesh=None) -> float:
    """Bytes a serving snapshot or a cache digest adds on rank 0 of a
    mesh of more than one rank (0 on one device): the whole decode state
    gathered onto its device, plus one leaf's blocks while that leaf is
    placed (``collectives.gather_to``)."""
    pod, dp, tp = _mesh_sizes(_sizes(mesh))
    if pod * dp * tp == 1:
        return 0.0
    from repro_torch.models.model import cache_spec
    from repro_torch.tree import flatten_with_paths
    leaves = [float(np.prod(s.shape)) * torch.empty(
        (), dtype=s.dtype).element_size() for _, s in flatten_with_paths(
        cache_spec(cfg, shape.global_batch, shape.seq_len))]
    return sum(leaves) + max(leaves)


def estimate_card_serve_memory(cfg: ModelConfig, shape: ShapeConfig,
                               plan: ParallelPlan,
                               mesh=None) -> MemoryEstimate:
    """Bytes on one rank as the port stores them under ``plan``: its
    block of every template leaf (``spec_for_axes``; a split that does
    not divide replicates), of every decode-state leaf
    (``cache_specs``), and the reference's activation term for the local
    slots."""
    from repro_torch.models.model import (batch_axes, cache_spec,
                                          param_template)
    from repro_torch.tree import flatten_with_paths
    sizes = _sizes(mesh)
    pod, dp, tp = _mesh_sizes(sizes)
    fake = _AxisSizes(sizes)
    params = sum(_leaf_bytes(
        leaf.shape, spec_for_axes(plan, leaf.axes, leaf.shape, fake), sizes,
        _bytes_per_param(leaf.dtype or cfg.dtype))
        for _, leaf in flatten_with_paths(param_template(cfg)))
    tree = cache_spec(cfg, shape.global_batch, shape.seq_len)
    specs = cache_specs(plan, fake, tree, batch_axes(cfg))
    cache = sum(_leaf_bytes(s.shape, specs[p], sizes, torch.empty(
        (), dtype=s.dtype).element_size())
        for p, s in flatten_with_paths(tree))
    b_eff = max(shape.global_batch / (pod * dp), 1)
    acts = b_eff * max(shape.seq_len if shape.kind == "prefill" else 1, 1) \
        * cfg.d_model * _bytes_per_param(cfg.dtype) * 4
    return MemoryEstimate(params, 0.0, acts, params + cache + acts, cache)


class _AxisSizes:
    """A mesh's axis sizes as the spec functions read them."""

    def __init__(self, sizes: Dict[str, int]) -> None:
        self.shape = dict(sizes)


def card_serve_plan(cfg: ModelConfig, shape: ShapeConfig,
                    total_memory: float, mesh=None,
                    ranks_per_card=None) -> ParallelPlan:
    """The serving plan on a CUDA card of ``total_memory`` bytes for one
    rank of ``mesh`` (default: one device): the reference's escalation
    (depth 1 -> 2 -> 2 with the cache's sequence split) against 0.9 x
    that, less rank 0's gather of the whole cache
    (``serve_gather_bytes``), divided among the ranks sharing the card,
    with the port's own count (``estimate_card_serve_memory``). Raises
    ``MemoryError`` before anything is allocated where no depth fits."""
    sizes = _sizes(mesh)
    gather = serve_gather_bytes(cfg, shape, mesh)
    share = _ranks_per_card(mesh, ranks_per_card)
    budget = (0.9 * total_memory - gather) / share
    for depth, cache_seq in SERVE_DEPTHS:
        plan = _serve_plan(cfg, sizes, depth, cache_seq, "")
        est = estimate_card_serve_memory(cfg, shape, plan, mesh)
        if est.fits(budget):
            return plan.with_(notes=plan.notes + f"est="
                              f"{est.total / 1e9:.1f}GB (card)")
    raise MemoryError(
        f"{cfg.name} at {shape.name}: {est.params / 1e9:.1f} GB of params "
        f"and {est.kv_cache / 1e9:.1f} GB of decode state a rank at the "
        f"deepest serving split, past 0.9 x the card's "
        f"{total_memory / 1e9:.1f} GB less rank 0's {gather / 1e9:.1f} GB "
        f"cache gather, shared by {share} rank(s) "
        f"({budget / 1e9:.1f} GB); serving it needs cards beyond this one "
        "(ROADMAP A9) or a depth cut (<arch>-layers<N>)")


def make_plan(cfg: ModelConfig, shape: ShapeConfig,
              mesh=None) -> ParallelPlan:
    """The plan of one rank of ``mesh`` (one device by default): on a
    CUDA card ``card_plan``'s or ``card_serve_plan``'s, elsewhere the
    reference's, term for term — for training the escalating search over
    gradient accumulation 1 -> 4 -> 16, for serving (a prefill or decode
    shape) over weight-sharding depth and the cache's sequence split."""
    if _on_card(mesh):
        dev = mesh if not is_mesh(mesh) else torch.device(
            "cuda", torch.cuda.current_device())
        return card_plan(cfg, shape, torch.cuda.get_device_properties(
            dev).total_memory, mesh if is_mesh(mesh) else None)
    sizes = _sizes(mesh)
    budget = 0.9 * HBM_BYTES
    if shape.kind != "train":
        for depth, cache_seq in SERVE_DEPTHS:
            est = estimate_serve_memory(cfg, shape, mesh, depth, cache_seq)
            if est.fits(budget):
                break
        return _serve_plan(cfg, sizes, depth, cache_seq,
                           f"est={est.total/2**30:.1f}GiB")
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
