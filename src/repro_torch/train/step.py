"""Train / eval step construction — the port of ``repro.train.step``:
loss, gradients (autograd), the optimizer update and microbatch
gradient accumulation, registered in the C/R function registry so a
logged ``Compile("train_step", ...)`` rebuilds the step at restore.

PyTorch runs eagerly, so a "compiled" step is a plain Python function.
Parameters stay plain tensors (no ``requires_grad``): each step tracks
gradients on detached aliases of them and then updates them in place
(``optim.apply_updates``), so a step holds one copy of the params, not
two.

Over a ``DeviceMesh`` the params and moments are DTensors with the
plan's placements (``parallel.sharding.tree_placements``): the step
splits each microbatch's rows over the data axes (``batch_spec``),
installs the mesh context, reshards the residual stream and the logits
where the reference constrains them (``activation_spec``,
``logits_spec``), runs autograd through DTensor's propagation, reduces
each gradient to its param's placements (a sum over the data axes, a
reduce-scatter where the param is FSDP-split) and updates the local
shards in place.
"""
from __future__ import annotations

import json
from typing import Callable, Dict

import torch

from repro_torch.configs import registry as cfg_registry
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.split_state import register_step_fn
from repro_torch.models import model as M
from repro_torch.models.model import TensorSpec
from repro_torch.optim import (AdamWConfig, ScheduleConfig, apply_updates,
                               schedule_lr)
from repro_torch.launch.mesh import is_device_mesh
from repro_torch.models.layers import is_dtensor
from repro_torch.parallel import context as pctx
from repro_torch.parallel.planner import make_plan
from repro_torch.parallel.sharding import (ParallelPlan, activation_spec,
                                           batch_spec, logits_spec,
                                           placements_for)
from repro_torch.tree import fill_like, flatten_with_paths, tree_map


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """Mean CE over all tokens, f32. logits [B,S,V]; targets [B,S].
    On one device the gold logit is gathered. A DTensor's logits take
    the reference's vocab-parallel form: the gold logit is a masked sum
    over the (model-split) vocab axis and the log-sum-exp reduces its
    max and sum over that axis, so no rank holds the whole [B,S,V]."""
    if is_dtensor(logits):
        return _vocab_parallel_ce(logits, targets)
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def _vocab_parallel_ce(logits, targets):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    lf = logits.to(torch.float32)
    m = lf.detach().amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
    # the vocab ids, split over the mesh as the logits' vocab axis is
    vocab = [Shard(0) if isinstance(p, Shard) and p.dim == lf.ndim - 1
             else Replicate() for p in lf.placements]
    ids = distribute_tensor(
        torch.arange(lf.shape[-1], device=lf.device, dtype=torch.int64),
        lf.device_mesh, vocab, src_data_rank=None)
    gold_mask = ids == targets.long()[..., None]
    gold = torch.sum(torch.where(gold_mask, lf, 0.0), dim=-1)
    return torch.mean(lse - gold)


def make_loss_fn(cfg: ModelConfig, opts: M.CallOptions):
    def loss_fn(params, batch):
        logits, aux = M.forward_train(cfg, params, batch, opts)
        ce = cross_entropy(logits, batch["targets"])
        loss = ce + aux["moe_aux"]
        return loss, {"ce": ce, "moe_aux": aux["moe_aux"]}
    return loss_fn


class _Reshard(torch.autograd.Function):
    """A DTensor resharded to ``placements``, its gradient resharded to
    ``grad_placements``. The residual stream is split over the sequence
    (``seq_shard``), but a product folds batch and sequence together,
    which some DTensor releases refuse on a split sequence (PyTorch
    2.11: "Attempted to flatten multiple dimensions"); so the gradient
    flowing back into the block's products keeps its sequence whole."""

    @staticmethod
    def forward(ctx, x, placements, grad_placements):
        ctx.grad_placements = grad_placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.grad_placements), None, None


def make_call_options(plan: ParallelPlan, mesh=None) -> M.CallOptions:
    """The plan's remat, and under a DeviceMesh the residual-stream and
    logits reshards at the plan's activation and logits specs."""
    if not is_device_mesh(mesh):
        return M.CallOptions(remat=plan.remat)
    spec = activation_spec(plan)
    act = placements_for(spec, mesh)
    act_grad = placements_for((spec[0], None, None), mesh)
    logit = placements_for(logits_spec(plan), mesh)
    return M.CallOptions(
        remat=plan.remat,
        act_constraint=lambda x: _Reshard.apply(x, act, act_grad),
        logit_constraint=lambda x: x.redistribute(mesh, logit))


def shard_batch(plan: ParallelPlan, mesh, batch):
    """Full batch tensors (the same on every rank) -> DTensors split over
    the data axes on their leading dim (``batch_spec``)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.parallel.sharding import axis_sizes
    spec = tuple(batch_spec(plan))
    n = 1
    for a in plan.batch_axes:
        n *= axis_sizes(mesh)[a]
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split over the "
                         f"data axes {plan.batch_axes} of {n} ranks")

    def one(v):
        pl = placements_for(spec[:1] + (None,) * (v.dim() - 1), mesh)
        return distribute_tensor(v, mesh, pl, src_data_rank=None)
    return {k: one(v) for k, v in batch.items()}


def _local_value(x):
    """A metric as a plain tensor (a DTensor metric is replicated)."""
    return x.full_tensor() if is_dtensor(x) else x


def value_and_grad(loss_fn, params, batch):
    """((loss, parts), grads) with grads in each param's dtype."""
    leaves = flatten_with_paths(params)
    tracked = {p: t.detach().requires_grad_(True) for p, t in leaves}
    loss, parts = loss_fn(fill_like(params, tracked), batch)
    grads = torch.autograd.grad(loss, [tracked[p] for p, _ in leaves])
    grads = fill_like(params, {p: g for (p, _), g in zip(leaves, grads)})
    return (loss.detach(), {k: v.detach() for k, v in parts.items()}), grads


def make_train_step(cfg: ModelConfig, plan: ParallelPlan,
                    opt_cfg: AdamWConfig, sched_cfg: ScheduleConfig,
                    mesh=None) -> Callable:
    """Returns train_step(params, opt_state, batch, step, lr_scale)
    -> (params, opt_state, metrics); params and moments are updated in
    place. Gradient accumulation per ``plan.grad_accum``, summed in
    float32 over microbatches as the reference's scan does. Over a
    DeviceMesh ``batch`` holds the full batch on every rank and the
    params and moments are DTensors (see the module docstring)."""
    M.check_trainable(cfg)
    loss_fn = make_loss_fn(cfg, make_call_options(plan, mesh))
    accum = max(plan.grad_accum, 1)
    on_mesh = is_device_mesh(mesh)

    def grads_of(params, mb):
        if not on_mesh:
            return value_and_grad(loss_fn, params, mb)
        with pctx.mesh_context(mesh, plan.batch_axes, plan.model_axis):
            (loss, parts), g = value_and_grad(
                loss_fn, params, shard_batch(plan, mesh, mb))
        # reduce each gradient to its param's placements (over the data
        # axes: a sum, or a reduce-scatter where the param is FSDP-split)
        g = tree_map(lambda gr, p: gr.redistribute(p.device_mesh,
                                                   p.placements), g, params)
        return ((_local_value(loss),
                 {k: _local_value(v) for k, v in parts.items()}), g)

    def train_step(params, opt_state, batch, step, lr_scale):
        if accum == 1:
            (loss, parts), grads = grads_of(params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            loss = 0.0
            for i in range(accum):
                mb = {k: v.reshape((accum, v.shape[0] // accum)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                (l, _), g = grads_of(params, mb)
                tree_map(lambda a, b: a.add_(b.to(a.dtype)), grads, g)
                loss = loss + l
                del g
            grads = tree_map(lambda g: g / accum, grads)
            loss = loss / accum
            parts = {"ce": loss, "moe_aux": torch.zeros(
                (), dtype=torch.float32, device=loss.device)}
        lr = schedule_lr(sched_cfg, step) * lr_scale
        params, opt_state, om = apply_updates(params, grads, opt_state,
                                              opt_cfg, lr)
        del grads
        metrics = {"loss": loss, **parts, **om, "step": int(step) + 1}
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, plan: ParallelPlan):
    loss_fn = make_loss_fn(cfg, M.CallOptions(remat=plan.remat))

    @torch.no_grad()
    def eval_step(params, batch):
        loss, parts = loss_fn(params, batch)
        return {"loss": loss, **parts}

    return eval_step


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig
                      ) -> Dict[str, TensorSpec]:
    """TensorSpec stand-ins for a training batch."""
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": TensorSpec((b, s), torch.int32),
             "targets": TensorSpec((b, s), torch.int32)}
    if cfg.is_encoder_decoder:
        specs["frames"] = TensorSpec((b, cfg.encoder_seq, cfg.frontend_dim),
                                     torch.float32)
    return specs


def default_opt_config(cfg: ModelConfig) -> AdamWConfig:
    """The reference's choice: int8 moments above 5e10 params."""
    return AdamWConfig(quantize_moments=cfg.n_params() > 5e10)


# ---------------------------------------------------------------------------
# C/R function-registry builder (Compile ops resolve here)
# ---------------------------------------------------------------------------

def plan_from_key(cfg: ModelConfig, shape: ShapeConfig, device,
                  plan_key: str) -> ParallelPlan:
    plan = make_plan(cfg, shape, device)
    if plan_key:
        plan = plan.with_(**json.loads(plan_key))
    return plan


@register_step_fn("train_step")
def _build_train_step(arch: str, shape_key: str, plan_key: str, lower):
    cfg = cfg_registry.resolve_config(arch)
    shape = cfg_registry.get_shape(shape_key)
    plan = plan_from_key(cfg, shape, lower.mesh, plan_key)
    return make_train_step(cfg, plan, default_opt_config(cfg),
                           ScheduleConfig(), mesh=lower.mesh)
