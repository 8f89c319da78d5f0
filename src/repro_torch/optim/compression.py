"""Gradient compression for the data-parallel all-reduce, with error
feedback (EF-SGD style) — the port of ``repro.optim.compression``.

Per-rank gradients are int8-quantized (per-block scales over blocks of
256), summed over the group in their dequantized form, and the
quantization residual is carried to the next step and added back —
preserving convergence while the payload a rank sends could be the
int8 codes and scales. The reference does not wire it into its step,
so neither does the port: ``compressed_psum`` is called by whoever
reduces gradients explicitly.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.parallel import collectives
from repro_torch.tree import fill_like, flatten_with_paths, tree_map

BLOCK = 256


def _blockwise_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: f32 flat [N] -> (int8 [nb, BLOCK], scales [nb])."""
    pad = (-x.numel()) % BLOCK
    xb = F.pad(x, (0, pad)).reshape(-1, BLOCK)
    scale = torch.clamp(xb.abs().amax(dim=1), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xb / scale[:, None]), -127, 127) \
        .to(torch.int8)
    return q, scale


def _blockwise_dequant(q: torch.Tensor, scale: torch.Tensor,
                       n: int) -> torch.Tensor:
    return (q.to(torch.float32) * scale[:, None]).reshape(-1)[:n]


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum(grads, ef_state, group=None):
    """Quantize (grad + carried error), all-reduce the dequantized
    payload over ``group`` (default: the world), take the mean, and
    compute the new error carry. Returns (reduced_grads, new_ef_state)."""
    import torch.distributed as dist
    n_shards = dist.get_world_size(group)

    def one(g, e):
        gf = g.to(torch.float32) + e
        q, scale = _blockwise_quant(gf.reshape(-1))
        sent = _blockwise_dequant(q, scale, gf.numel()).reshape(gf.shape)
        total = collectives.all_reduce(sent, group)
        return total / n_shards, gf - sent

    errs = dict(flatten_with_paths(ef_state))
    outs = {p: one(g, errs[p]) for p, g in flatten_with_paths(grads)}
    return (fill_like(grads, {p: o[0] for p, o in outs.items()}),
            fill_like(grads, {p: o[1] for p, o in outs.items()}))
