"""Carry weights, optimizer state and KV caches across from the JAX
package.

The JAX package's trees reach the port as numpy (``jax.tree.map(
np.asarray, params)`` on the JAX side); these helpers turn them into the
port's tensors on a device with identical paths and identical bits —
bfloat16 included, moved as its 16-bit pattern rather than through a
float conversion, so no ``ml_dtypes`` is needed here.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.host import host_array, resolve_device
from repro_torch.tree import tree_map


def _leaf_to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    # order="C", not ascontiguousarray: that one turns a 0-d leaf (the
    # optimizer's count) into shape (1,)
    a = np.asarray(a, order="C")
    if str(a.dtype) == "bfloat16":     # ml_dtypes.bfloat16 on the JAX side
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_numpy(tree, device=None):
    """Nested dict of numpy arrays (the JAX package's params) -> the same
    nested dict of tensors on ``device`` (default: the card)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf_to_tensor(a, dev), tree)


def cache_from_numpy(tree, device=None):
    """The KV-cache twin of :func:`params_from_numpy` (k/v in the model
    dtype, ``pos`` int32 with -1 marking an empty slot)."""
    return params_from_numpy(tree, device)


def opt_state_from_numpy(tree, device=None):
    """The JAX package's AdamW state as numpy (``mu``, ``nu`` — f32
    leaves or ``QMoment(q, scale)`` named tuples — and the int32
    ``count``) -> the port's, on ``device``, with the port's ``QMoment``
    and identical bits."""
    from repro_torch.optim import QMoment
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return QMoment(*(conv(getattr(node, f))
                             for f in QMoment._fields))
        return _leaf_to_tensor(node, dev)

    return conv(tree)


def tree_to_numpy(tree):
    """The port's tensors -> numpy on the host, bfloat16 as its uint16
    bit view (``.view(ml_dtypes.bfloat16)`` recovers the values where
    ``ml_dtypes`` is installed). Named tuples (an optimizer state's
    ``QMoment``) keep their type; 0-d leaves stay 0-d."""
    return tree_map(host_array, tree)
