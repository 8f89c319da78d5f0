"""Mixture-of-Experts FFN — the port of ``repro.models.moe``.

Each token picks its top-k experts from an f32 router; every expert
takes at most ``capacity`` tokens, counted jointly over the k choices in
token-major order, and a choice past its expert's capacity goes to one
drop slot whose output is zero. Dispatch writes each kept (token,
choice) row into its own slot of an ``[E * C + 1, D]`` buffer, the
experts run as three batched products over ``[E, C, ·]``, and the
combine gathers each choice's row back, scaled by its gate, summed over
the choices in order.

No op here depends on the order threads finish in: the dispatch is a
write to unique slots (no accumulation), the ranks an integer cumsum,
the combine a gather, whose backward (like the dispatch's) PyTorch sums
per slot in sorted order under ``torch.use_deterministic_algorithms``.
So a train step gives the same bits twice on the card, and prefill and
decode drop exactly the choices the JAX package drops for the same
routing.

Under a device mesh (the input a DTensor) the experts are parallel, as
the reference's ``shard_map`` branch: expert weights split over the
model axis, tokens over the data axes, and every model rank sees its
data shard's tokens. The routing runs once per rank on its local tokens
(identical across the model axis); each rank dispatches only the
choices that fall on its own ``E / M`` experts (``shard_index``), with
the capacity counted on its local tokens as the reference counts it,
and an all-reduce over the model group sums the ranks' outputs (the
reference's ``psum``). The load-balance loss sums its per-expert counts
and probabilities over the data axes first, so it is the global batch's.
Serving takes the same branch: a decode step's few tokens split over
the data axes with the slots, a batch-1 admission prefill's tokens
replicated over them (every data rank then routes them all).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.numerics import exp_stable
from repro_torch.models import layers as L
from repro_torch.models.params import P
from repro_torch.parallel import context as pctx


def moe_template(cfg: ModelConfig) -> Dict[str, Any]:
    d, f, e = cfg.d_model, cfg.resolved_moe_d_ff, cfg.n_experts
    t: Dict[str, Any] = {
        "router": P((d, e), ("embed", None), fan_in=d, dtype="float32"),
        "w_gate": P((e, d, f), ("experts", "embed", "ff"), fan_in=d),
        "w_up": P((e, d, f), ("experts", "embed", "ff"), fan_in=d),
        "w_down": P((e, f, d), ("experts", "ff", "embed"), fan_in=f),
    }
    if cfg.n_shared_experts:
        t["shared"] = L.mlp_template(cfg, cfg.n_shared_experts * f)
    return t


def _capacity(n_tokens: int, k: int, n_experts: int, cf: float) -> int:
    """Slots per expert: ``ceil(cf * tokens * k / experts)``, at least 8,
    rounded up to a multiple of 8 (the reference's float expression)."""
    c = int(math.ceil(cf * n_tokens * k / n_experts))
    return max(8, int(math.ceil(c / 8)) * 8)


def _route_local(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gates [B,S,K] f32, idx [B,S,K] int64, probs [B,S,E] f32)."""
    logits = torch.einsum("bsd,de->bse", x.float(), router_w)
    e = exp_stable(logits - logits.amax(dim=-1, keepdim=True).detach())
    probs = e / e.sum(dim=-1, keepdim=True)
    k = cfg.experts_per_token
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[..., :k], order[..., :k]
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return gates, idx, probs


def route(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router: (gates [B,S,K] f32, idx [B,S,K] int32, aux f32 scalar) for
    x [B,S,D]. Top-k takes the lower expert index on equal
    probabilities, as ``jax.lax.top_k`` does (a stable descending sort);
    the gates are renormalised over the k choices; ``aux`` is the
    Switch load-balance loss ``E * sum_e f_e * P_e``."""
    gates, idx, probs = _route_local(cfg, router_w, x)
    n = cfg.n_experts
    dispatch_frac = F.one_hot(idx, n).to(torch.float32).sum(dim=2) \
        .mean(dim=(0, 1))
    prob_frac = probs.mean(dim=(0, 1))
    aux = n * torch.sum(dispatch_frac * prob_frac)
    return gates, idx.to(torch.int32), aux


def _local_expert_ffn(buf: torch.Tensor, w_gate: torch.Tensor,
                      w_up: torch.Tensor, w_down: torch.Tensor,
                      capacity: int) -> torch.Tensor:
    """buf [E * C + 1, D] -> the same shape through the experts
    (SiLU-gated, three batched products); the drop row comes out zero."""
    n = w_gate.shape[0]
    xb = buf[:-1].reshape(n, capacity, -1)
    h = F.silu(torch.bmm(xb, w_gate)) * torch.bmm(xb, w_up)
    y = torch.bmm(h, w_down).reshape(n * capacity, -1)
    return torch.cat([y, torch.zeros_like(buf[-1:])], dim=0)


def _slots(idx: torch.Tensor, n_experts: int, capacity: int
           ) -> torch.Tensor:
    """idx [T, K] expert ids -> slots [T, K] int64 in ``[0, E * C]``. A
    choice's rank within its expert counts every earlier (token, choice)
    in token-major order, so the K choices share the capacity; a choice
    ranked past it goes to the drop slot ``E * C``."""
    t, k = idx.shape
    flat = idx.reshape(t * k).long()
    onehot = flat[:, None] == torch.arange(n_experts,
                                           device=idx.device)[None, :]
    ranks = torch.cumsum(onehot.to(torch.int32), dim=0,
                         dtype=torch.int32) - 1
    rank = ranks.gather(1, flat[:, None])[:, 0]
    drop = n_experts * capacity
    return torch.where(rank < capacity, flat * capacity + rank,
                       torch.full_like(flat, drop)).reshape(t, k)


def _dispatch_compute_combine(x: torch.Tensor, gates: torch.Tensor,
                              idx: torch.Tensor, w_gate: torch.Tensor,
                              w_up: torch.Tensor, w_down: torch.Tensor,
                              capacity: int, shard_index: int = 0,
                              n_shards: int = 1) -> torch.Tensor:
    """x [T, D], gates [T, K] f32, idx [T, K] global expert ids, the
    weights of this shard's ``E / n_shards`` experts -> [T, D], the
    output of the choices that fall on them (all of them on one shard)."""
    t, k = idx.shape
    el = w_gate.shape[0]
    drop = el * capacity
    if n_shards == 1:
        slots = _slots(idx, el, capacity)
    else:
        # another shard's choices go to a phantom expert ``el``, which
        # takes none of this shard's capacity, and then to the drop slot
        local = idx.long() - shard_index * el
        mine = (local >= 0) & (local < el)
        slots = _slots(torch.where(mine, local, torch.full_like(local, el)),
                       el + 1, capacity).clamp(max=drop)
    flat = slots.reshape(t * k)
    keep = flat < drop
    tok = torch.arange(t * k, device=x.device) // k
    buf = x.new_zeros((drop + 1, x.shape[-1])).index_put(
        (flat[keep],), x[tok[keep]])
    buf = _local_expert_ffn(buf, w_gate, w_up, w_down, capacity)
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + buf[slots[:, j]] * gates[:, j].to(x.dtype)[:, None]
    return out


def moe_forward(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], the weighted aux loss, an f32
    scalar). Capacity is set by all B * S tokens of the call (under a
    mesh: by one data shard's tokens)."""
    if L.is_dtensor(x):
        y, aux = _moe_forward_mesh(cfg, p, x)
    else:
        B, S, D = x.shape
        gates, idx, aux = route(cfg, p["router"], x)
        cap = _capacity(B * S, cfg.experts_per_token, cfg.n_experts,
                        cfg.capacity_factor)
        y = _dispatch_compute_combine(
            x.reshape(B * S, D), gates.reshape(B * S, -1),
            idx.reshape(B * S, -1), p["w_gate"], p["w_up"], p["w_down"],
            cap).reshape(B, S, D)
    if cfg.n_shared_experts:
        y = y + L.mlp_forward(cfg, p["shared"], x)
    return y, aux * cfg.router_aux_loss


def _moe_forward_mesh(cfg: ModelConfig, p: Dict[str, Any], x
                      ) -> Tuple[Any, Any]:
    """The expert-parallel forward of DTensor x [B, S, D] (see the module
    docstring): (y, unweighted aux), both DTensors."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    ctx = pctx.for_mesh(mesh)
    m, r = ctx.model_size(), ctx.model_rank()
    n, k = cfg.n_experts, cfg.experts_per_token
    if n % m:
        raise ValueError(f"{cfg.name}: {n} experts over a model axis of {m}")
    B, S, D = x.shape
    bp = pctx.batch_placement(x)
    # every data rank's tokens are its own (summed over the data axes)
    # unless the batch is replicated there (a batch-1 admission prefill)
    over_data = Partial() if isinstance(bp, Shard) else Replicate()
    rows = ctx.placements(bp, Replicate())
    rows_partial = ctx.placements(bp, Partial())
    xr = x.redistribute(mesh, rows)

    # routing: once per rank on its tokens, the same on every model rank
    full = ctx.placements(Replicate(), Replicate())
    w_r = p["router"].redistribute(mesh, full).to_local(
        grad_placements=ctx.placements(over_data, Replicate()))
    gates_l, idx_l, probs_l = _route_local(cfg, w_r, xr.to_local(
        grad_placements=rows))
    counts = F.one_hot(idx_l, n).to(torch.float32).sum(dim=(0, 1, 2))
    sums = ctx.placements(over_data, Replicate())
    dispatch_frac = DTensor.from_local(counts, mesh, sums) / (B * S)
    prob_frac = DTensor.from_local(probs_l.sum(dim=(0, 1)), mesh,
                                   sums) / (B * S)
    aux = n * torch.sum(dispatch_frac * prob_frac)
    gates = DTensor.from_local(gates_l, mesh, rows)

    # this rank's experts over its tokens; the model axis sums the parts
    w = {name: p[name].redistribute(
        mesh, ctx.placements(Replicate(), Shard(0))).to_local(
        grad_placements=ctx.placements(over_data, Shard(0)))
        for name in ("w_gate", "w_up", "w_down")}
    x_l = xr.to_local(grad_placements=rows_partial)
    g_l = gates.to_local(grad_placements=rows_partial)
    bl = x_l.shape[0]
    cap = _capacity(bl * S, k, n, cfg.capacity_factor)
    y_l = _dispatch_compute_combine(
        x_l.reshape(bl * S, D), g_l.reshape(bl * S, k),
        idx_l.reshape(bl * S, k), w["w_gate"], w["w_up"], w["w_down"],
        cap, shard_index=r, n_shards=m).reshape(bl, S, D)
    y = DTensor.from_local(y_l, mesh, rows_partial).redistribute(mesh, rows)
    return y, aux
