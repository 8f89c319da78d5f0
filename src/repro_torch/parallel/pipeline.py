"""Pipeline parallelism over a group of ranks (GPipe schedule) — the
port of ``repro.parallel.pipeline``.

Each stage (a rank of ``group``, in group-rank order) owns a contiguous
chunk of the stacked layer parameters and runs the classic
(M + S - 1)-tick GPipe schedule: at tick ``t`` stage 0 takes microbatch
``t`` (clamped), every other stage takes what its predecessor handed
it, each runs its chunk and hands the result to the next stage in a
ring (the last stage's send wraps to stage 0, which ignores it), and
the last stage banks microbatch ``t - (S - 1)``. The hand-offs are
``isend``/``irecv`` pairs (``collectives.send_recv``); the banked
outputs are then broadcast from the last stage, so every stage returns
them. The schedule and its arithmetic are the reference's, tick for
tick; it is opt-in, as there.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.parallel import collectives
from repro_torch.tree import flatten_with_paths, tree_map


def pipeline_forward(block_fn: Callable, stacked_params,
                     x_microbatches: torch.Tensor, group=None
                     ) -> torch.Tensor:
    """``block_fn(layer_params, x) -> x``; ``stacked_params`` a tree of
    leaves [L, ...] (the whole stack: each stage takes its chunk);
    ``x_microbatches`` [M, mb, ...]. Returns the outputs [M, mb, ...]
    after all L layers on every stage. L must divide by the stage count;
    the bubble is (S - 1) / (M + S - 1)."""
    n = dist.get_world_size(group)
    s = dist.get_rank(group)
    ranks = [dist.get_global_rank(group, i) if group is not None else i
             for i in range(n)]
    n_layers = flatten_with_paths(stacked_params)[0][1].shape[0]
    if n_layers % n:
        raise ValueError(f"{n_layers} layers over {n} stages")
    per = n_layers // n
    chunk = tree_map(lambda w: w[s * per:(s + 1) * per], stacked_params)
    M = x_microbatches.shape[0]

    def run_chunk(x):
        for i in range(per):
            x = block_fn(tree_map(lambda w: w[i], chunk), x)
        return x

    outputs = torch.zeros_like(x_microbatches)
    inflight = torch.zeros_like(x_microbatches[0])
    for t in range(M + n - 1):
        x_in = x_microbatches[min(t, M - 1)] if s == 0 else inflight
        y = run_chunk(x_in)
        nxt = torch.empty_like(y)
        collectives.send_recv(y, ranks[(s + 1) % n], nxt,
                              ranks[(s - 1) % n], group)
        if s == n - 1 and t - (n - 1) >= 0:
            outputs[t - (n - 1)] = y
        inflight = nxt
    return collectives.broadcast(outputs, ranks[n - 1], group)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
