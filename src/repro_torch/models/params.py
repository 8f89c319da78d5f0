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
    init: str = "normal"        # normal | zeros | ones | scaled | ssm_a
                                #   | ssm_dt | rglru_a
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
                  device=None, leaf_fn=None) -> Dict[str, Any]:
    """Materialize real parameters on ``device`` (default: the card).
    Deterministic in ``seed``: each leaf draws from its own
    ``torch.Generator`` seeded from ``seed`` and the hash of its path,
    so adding/removing params does not perturb sibling initializations.
    ``leaf_fn(path, tensor)``, where given, replaces each leaf as soon as
    it is drawn (a mesh keeps only its shard of it)."""
    dev = resolve_device(device)
    by_path = {}
    for path, leaf in flatten_with_paths(template):
        dt = torch_dtype(leaf.dtype or default_dtype)
        if leaf.init == "zeros":
            arr = torch.zeros(leaf.shape, dtype=dt, device=dev)
        elif leaf.init == "ones":
            arr = torch.ones(leaf.shape, dtype=dt, device=dev)
        elif leaf.init in ("normal", "scaled"):
            fan_in = leaf.fan_in or (leaf.shape[-2] if len(leaf.shape) >= 2
                                     else leaf.shape[-1])
            std = leaf.scale / np.sqrt(max(fan_in, 1))
            arr = (torch.randn(leaf.shape, generator=_gen(seed, path, dev),
                               device=dev, dtype=torch.float32) * std).to(dt)
        elif leaf.init == "ssm_a":
            # mamba2 A_log: log of uniform [1, 16]
            u = _uniform(leaf.shape, seed, path, dev, 1.0, 16.0)
            arr = torch.log(u).to(dt)
        elif leaf.init == "ssm_dt":
            # dt bias: softplus^-1 of uniform log-spaced [1e-3, 1e-1]
            lo, hi = float(np.log(1e-3)), float(np.log(1e-1))
            u = torch.exp(_uniform(leaf.shape, seed, path, dev, lo, hi))
            arr = (u + torch.log(-torch.expm1(-u))).to(dt)
        elif leaf.init == "rglru_a":
            # RG-LRU forget-gate param: softplus^-1(-log a), a uniform
            # [0.9, 0.999]
            u = _uniform(leaf.shape, seed, path, dev, 0.9, 0.999)
            arr = torch.log(torch.expm1(-torch.log(u))).to(dt)
        else:
            raise ValueError(f"unknown init {leaf.init!r}")
        by_path[path] = arr if leaf_fn is None else leaf_fn(path, arr)
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


def _gen(seed: int, path: str, dev: torch.device) -> torch.Generator:
    """The leaf's own generator, seeded from ``seed`` and its path."""
    gen = torch.Generator(device=dev)
    gen.manual_seed((int(seed) << 31) ^ _stable_hash(path))
    return gen


def _uniform(shape, seed: int, path: str, dev: torch.device, lo: float,
             hi: float) -> torch.Tensor:
    """float32 uniform on [lo, hi): ``lo + (hi - lo) * U[0, 1)``, the
    form ``jax.random.uniform`` takes."""
    u = torch.rand(shape, generator=_gen(seed, path, dev), device=dev,
                   dtype=torch.float32)
    return lo + (hi - lo) * u


def _stable_hash(s: str) -> int:
    """Deterministic across processes (unlike builtin hash)."""
    h = 2166136261
    for ch in s.encode():
        h = ((h ^ ch) * 16777619) & 0x7FFFFFFF
    return h


def count_params(tree) -> int:
    return int(sum(int(np.prod(leaf.shape))
                   for _, leaf in flatten_with_paths(tree)))
