"""Parameter templates — the port of ``repro.models.params``.

A model declares a nested dict of ``P`` leaves (shape, logical axes,
init style); ``init_concrete`` materializes real tensors on a device
from explicit ``torch.Generator``s.

Paths, shapes, dtypes and logical axes are the JAX package's, so params
carried across with ``repro_torch.convert`` land on identical paths.
The random values are not: ``jax.random`` and ``torch.Generator`` draw
different numbers from one seed, so a test that compares the two
packages feeds both the same params (``convert.params_from_numpy``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.host import resolve_device, torch_dtype
from repro_torch.tree import fill_like, flatten_with_paths, tree_map


@dataclass(frozen=True)
class P:
    """One parameter leaf: shape + logical axis names + init style."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones | scaled
    scale: float = 1.0          # stddev multiplier for normal/scaled
    fan_in: int = 0             # for scaled init: std = scale/sqrt(fan_in)
    dtype: Optional[str] = None  # override model dtype (e.g. f32 norms)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} / axes {self.axes} mismatch")


def stacked(n_layers: int, tree: Dict[str, Any]) -> Dict[str, Any]:
    """Add a leading 'layers' axis to every leaf (the layer loop indexes
    it)."""

    def f(leaf: P) -> P:
        return P(
            shape=(n_layers,) + leaf.shape,
            axes=("layers",) + leaf.axes,
            init=leaf.init,
            scale=leaf.scale,
            fan_in=leaf.fan_in,
            dtype=leaf.dtype,
        )

    return tree_map(f, tree)


def init_concrete(template: Dict[str, Any], default_dtype: str, seed: int,
                  device=None) -> Dict[str, Any]:
    """Materialize real parameters on ``device`` (default: the card).
    Deterministic in ``seed``: each leaf draws from its own
    ``torch.Generator`` seeded from ``seed`` and the hash of its path,
    so adding/removing params does not perturb sibling initializations."""
    dev = resolve_device(device)
    by_path = {}
    for path, leaf in flatten_with_paths(template):
        dt = torch_dtype(leaf.dtype or default_dtype)
        if leaf.init == "zeros":
            arr = torch.zeros(leaf.shape, dtype=dt, device=dev)
        elif leaf.init == "ones":
            arr = torch.ones(leaf.shape, dtype=dt, device=dev)
        elif leaf.init in ("normal", "scaled"):
            gen = torch.Generator(device=dev)
            gen.manual_seed((int(seed) << 31) ^ _stable_hash(path))
            fan_in = leaf.fan_in or (leaf.shape[-2] if len(leaf.shape) >= 2
                                     else leaf.shape[-1])
            std = leaf.scale / np.sqrt(max(fan_in, 1))
            arr = (torch.randn(leaf.shape, generator=gen, device=dev,
                               dtype=torch.float32) * std).to(dt)
        else:
            raise NotImplementedError(
                f"init {leaf.init!r} belongs to a model family the port "
                "does not run yet (ROADMAP A8)")
        by_path[path] = arr
    return fill_like(template, by_path)


def init_abstract(template: Dict[str, Any], default_dtype: str):
    """``TensorSpec`` tree — shapes and dtypes, nothing allocated (what
    a restore binds a checkpoint's leaves against)."""
    from repro_torch.models.model import TensorSpec
    return tree_map(lambda leaf: TensorSpec(
        tuple(leaf.shape), torch_dtype(leaf.dtype or default_dtype)),
        template)


def logical_specs(template: Dict[str, Any]) -> Dict[str, Any]:
    """Tree of logical axis-name tuples, one per leaf."""
    return tree_map(lambda leaf: tuple(leaf.axes), template)


def _stable_hash(s: str) -> int:
    """Deterministic across processes (unlike builtin hash)."""
    h = 2166136261
    for ch in s.encode():
        h = ((h ^ ch) * 16777619) & 0x7FFFFFFF
    return h


def count_params(tree) -> int:
    return int(sum(int(np.prod(leaf.shape))
                   for _, leaf in flatten_with_paths(tree)))
