"""AdamW with optional int8 block-quantized moments — the port of
``repro.optim.adamw``.

``opt_state`` is ``{"mu": tree, "nu": tree, "count": int32 0-d}``, with
the JAX package's leaf paths: a quantized moment is a ``QMoment`` named
tuple, so its leaves are ``...['w'].q`` and ``...['w'].scale``, as
``jax.tree_util.keystr`` spells them.

The arithmetic of one update is the reference's, op for op, in float32
tensor math (``b1 ** count`` is a float32 power; the clip factor and
the bias corrections are float32 tensors). One deliberate difference:
``apply_updates`` writes the new parameters and moments IN PLACE, one
slice of the leading (layer) axis at a time, where the JAX version
returns new trees. The update is elementwise, so slicing changes no bit;
what it saves is memory — the largest stacked leaf of starcoder2-3b
(``ffn.w_in``, 1.13 G elements) would otherwise need 4.5 GB for every
float32 temporary of the update.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.model import TensorSpec
from repro_torch.tree import flatten_with_paths, tree_map

BLOCK = 256


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_moments: bool = False


class QMoment(NamedTuple):
    q: Any       # int8, same shape as the param
    scale: Any   # f32, param.shape[:-1] + (ceil(last/BLOCK),)


def _nblocks(last: int) -> int:
    return (last + BLOCK - 1) // BLOCK


def _q_encode(x: torch.Tensor) -> QMoment:
    """x: f32 param-shaped."""
    shape = tuple(x.shape)
    last = shape[-1] if shape else 1
    nb = _nblocks(last)
    xp = F.pad(x.reshape(shape[:-1] + (last,)), (0, nb * BLOCK - last))
    xb = xp.reshape(shape[:-1] + (nb, BLOCK))
    scale = torch.clamp(xb.abs().amax(dim=-1), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127) \
        .to(torch.int8)
    q = q.reshape(shape[:-1] + (nb * BLOCK,))[..., :last]
    return QMoment(q, scale)


def _q_decode(m: QMoment) -> torch.Tensor:
    q, scale = m
    shape = tuple(q.shape)
    last = shape[-1]
    nb = scale.shape[-1]
    qp = F.pad(q, (0, nb * BLOCK - last))
    xb = qp.reshape(shape[:-1] + (nb, BLOCK)).to(torch.float32)
    return (xb * scale[..., None]).reshape(
        shape[:-1] + (nb * BLOCK,))[..., :last]


def _zeros_moment(p: torch.Tensor, quantize: bool):
    if not quantize or p.dim() == 0:
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    nb = _nblocks(p.shape[-1])
    return QMoment(torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                   torch.zeros(tuple(p.shape[:-1]) + (nb,),
                               dtype=torch.float32, device=p.device))


def _read_moment(m) -> torch.Tensor:
    return _q_decode(m) if isinstance(m, QMoment) else m


def _write_moment_(dst, val: torch.Tensor) -> None:
    """Store ``val`` into moment ``dst`` in place."""
    if isinstance(dst, QMoment):
        enc = _q_encode(val)
        dst.q.copy_(enc.q)
        dst.scale.copy_(enc.scale)
    else:
        dst.copy_(val)


# --- public API ---------------------------------------------------------------

def init_opt_state(params, cfg: AdamWConfig) -> Dict[str, Any]:
    dev = flatten_with_paths(params)[0][1].device
    return {
        "mu": tree_map(lambda p: _zeros_moment(p, cfg.quantize_moments),
                       params),
        "nu": tree_map(lambda p: _zeros_moment(p, cfg.quantize_moments),
                       params),
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def abstract_opt_state(abstract_params, cfg: AdamWConfig):
    def mom(p: TensorSpec):
        if not cfg.quantize_moments or len(p.shape) == 0:
            return TensorSpec(p.shape, torch.float32)
        nb = _nblocks(p.shape[-1])
        return QMoment(TensorSpec(p.shape, torch.int8),
                       TensorSpec(tuple(p.shape[:-1]) + (nb,),
                                  torch.float32))
    return {
        "mu": tree_map(mom, abstract_params),
        "nu": tree_map(mom, abstract_params),
        "count": TensorSpec((), torch.int32),
    }


def opt_logical_specs(param_logical, cfg: AdamWConfig):
    """Moments inherit the param's logical axes (quantized: q = same
    axes; scale = same axes with the last replaced by None)."""
    def is_axes(x) -> bool:
        return isinstance(x, tuple) and all(
            a is None or isinstance(a, str) for a in x)

    def mom_axes(node):
        if is_axes(node):
            if not cfg.quantize_moments or len(node) == 0:
                return node
            return QMoment(tuple(node), tuple(node[:-1]) + (None,))
        return {k: mom_axes(v) for k, v in node.items()}

    return {"mu": mom_axes(param_logical), "nu": mom_axes(param_logical),
            "count": ()}


def _slices(p: torch.Tensor, *rest) -> Iterator[Tuple[Any, ...]]:
    """(p, *rest) whole, or one slice of the leading axis at a time for
    stacked leaves (ndim >= 3); a QMoment slices both its parts."""
    def take(x, i):
        if isinstance(x, QMoment):
            return QMoment(x.q[i], x.scale[i])
        return x[i]

    if p.dim() < 3:
        yield (p, *rest)
        return
    for i in range(p.shape[0]):
        yield (p[i], *(take(x, i) for x in rest))


def global_norm(tree) -> torch.Tensor:
    parts: List[torch.Tensor] = []
    for _, x in flatten_with_paths(tree):
        sq = [torch.sum(torch.square(s.to(torch.float32)))
              for (s,) in _slices(x)]
        parts.append(sq[0] if len(sq) == 1 else torch.stack(sq).sum())
    return torch.sqrt(torch.sum(torch.stack(parts)))


def apply_updates(params, grads, opt_state, cfg: AdamWConfig, lr):
    """One AdamW step, in place on ``params`` and the moments of
    ``opt_state``. Returns (params, opt_state, metrics) — the same
    param and moment tensors, a new ``count``."""
    f32 = torch.float32
    count = opt_state["count"] + 1
    cf = count.to(f32)
    gnorm = global_norm(grads)
    if cfg.grad_clip > 0:
        clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                           max=1.0)
    else:
        clip = torch.tensor(1.0, dtype=f32, device=gnorm.device)
    b1 = torch.tensor(cfg.b1, dtype=f32, device=cf.device)
    b2 = torch.tensor(cfg.b2, dtype=f32, device=cf.device)
    bc1 = 1.0 - b1 ** cf
    bc2 = 1.0 - b2 ** cf
    lr = torch.as_tensor(lr, dtype=f32)

    def upd(p, g, mu, nu, decay: float) -> None:
        gf = g.to(f32) * clip
        m = cfg.b1 * _read_moment(mu) + (1.0 - cfg.b1) * gf
        v = cfg.b2 * _read_moment(nu) + (1.0 - cfg.b2) * gf * gf
        mhat = m / bc1
        vhat = v / bc2
        step = mhat / (torch.sqrt(vhat) + cfg.eps)
        pf = p.to(f32)
        new_p = pf - lr * (step + decay * pf)
        p.copy_(new_p.to(p.dtype))
        _write_moment_(mu, m)
        _write_moment_(nu, v)

    mus = dict(_dict_leaves(opt_state["mu"]))
    nus = dict(_dict_leaves(opt_state["nu"]))
    flat_g = dict(_dict_leaves(grads))
    with torch.no_grad():
        for path, p in _dict_leaves(params):
            # weight decay by the stacked leaf's rank, as the reference
            decay = cfg.weight_decay if p.dim() >= 2 else 0.0
            for ps, gs, ms, ns in _slices(p, flat_g[path], mus[path],
                                          nus[path]):
                upd(ps, gs, ms, ns, decay)
    new_state = {"mu": opt_state["mu"], "nu": opt_state["nu"],
                 "count": count}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


def _dict_leaves(tree, prefix: str = ""):
    """(path, leaf) over nested dicts only: a moment tree's QMoment is
    one leaf here, paired with its param by path."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _dict_leaves(tree[k], prefix + f"[{k!r}]")
    else:
        yield prefix, tree
