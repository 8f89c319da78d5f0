"""Train / eval step construction — the port of ``repro.train.step``:
loss, gradients (autograd), the optimizer update and microbatch
gradient accumulation, registered in the C/R function registry so a
logged ``Compile("train_step", ...)`` rebuilds the step at restore.

PyTorch runs eagerly, so a "compiled" step is a plain Python function.
Parameters stay plain tensors (no ``requires_grad``): each step tracks
gradients on detached aliases of them and then updates them in place
(``optim.apply_updates``), so a step holds one copy of the params, not
two.
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
from repro_torch.parallel.planner import make_plan
from repro_torch.parallel.sharding import ParallelPlan
from repro_torch.tree import fill_like, flatten_with_paths, tree_map


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """Mean CE over all tokens, f32. logits [B,S,V]; targets [B,S].
    The gold logit is gathered — the same value the reference takes
    with a masked sum over the vocab axis (which it needs for a
    vocab-sharded axis; one device has none)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def make_loss_fn(cfg: ModelConfig, opts: M.CallOptions):
    def loss_fn(params, batch):
        logits, aux = M.forward_train(cfg, params, batch, opts)
        ce = cross_entropy(logits, batch["targets"])
        loss = ce + aux["moe_aux"]
        return loss, {"ce": ce, "moe_aux": aux["moe_aux"]}
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """((loss, parts), grads) with grads in each param's dtype."""
    leaves = flatten_with_paths(params)
    tracked = {p: t.detach().requires_grad_(True) for p, t in leaves}
    loss, parts = loss_fn(fill_like(params, tracked), batch)
    grads = torch.autograd.grad(loss, [tracked[p] for p, _ in leaves])
    grads = fill_like(params, {p: g for (p, _), g in zip(leaves, grads)})
    return (loss.detach(), {k: v.detach() for k, v in parts.items()}), grads


def make_train_step(cfg: ModelConfig, plan: ParallelPlan,
                    opt_cfg: AdamWConfig,
                    sched_cfg: ScheduleConfig) -> Callable:
    """Returns train_step(params, opt_state, batch, step, lr_scale)
    -> (params, opt_state, metrics); params and moments are updated in
    place. Gradient accumulation per ``plan.grad_accum``, summed in
    float32 over microbatches as the reference's scan does."""
    M.check_trainable(cfg)
    loss_fn = make_loss_fn(cfg, M.CallOptions(remat=plan.remat))
    accum = max(plan.grad_accum, 1)

    def train_step(params, opt_state, batch, step, lr_scale):
        if accum == 1:
            (loss, parts), grads = value_and_grad(loss_fn, params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = 0.0
            for i in range(accum):
                mb = {k: v.reshape((accum, v.shape[0] // accum)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                (l, _), g = value_and_grad(loss_fn, params, mb)
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
                           ScheduleConfig())
