"""Model assembly for the dense decoder and the ssm family (Mamba-2) —
the port of ``repro.models.model``: ``param_template``,
``forward_train``, ``cache_spec``, ``init_cache``, ``prefill``,
``decode_step``, ``init_params``, ``init_abstract`` and
``logical_specs``.

Parameters are nested dicts of tensors stacked over a leading layer
axis, exactly the JAX package's layout and paths; where the JAX package
runs the layer stack under ``jax.lax.scan``, this is a Python loop that
indexes the stacked dim (a view, no copy). Remat "full" wraps each
layer in ``torch.utils.checkpoint`` (non-reentrant), where the JAX
package wraps the scan body in ``jax.checkpoint``. Decode state (the KV
cache, the SSM conv and scan states) is updated in place. Other families
(moe, hybrid, the whisper encoder-decoder) raise ``NotImplementedError``
naming ROADMAP A8.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.host import resolve_device, torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import params as PM
from repro_torch.models import ssm as SSM
from repro_torch.models.params import P, stacked
from repro_torch.tree import fill_like, flatten_with_paths, tree_map


@dataclass(frozen=True)
class TensorSpec:
    """Shape + dtype of a tensor not yet allocated (the counterpart of
    ``jax.ShapeDtypeStruct``); a leaf of the trees it stands in for."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "vlm", "ssm") or cfg.n_experts \
            or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; the "
            "port runs the dense decoder and the ssm family (other "
            "families: ROADMAP A8)")


# ---------------------------------------------------------------------------
# templates
# ---------------------------------------------------------------------------

def param_template(cfg: ModelConfig) -> Dict[str, Any]:
    _check_family(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    t: Dict[str, Any] = {
        "tok_emb": P((v, d), ("vocab", "embed"), fan_in=d),
        "final_norm": L.norm_template(cfg),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = P((d, v), ("embed", "vocab"), fan_in=d)
    if cfg.family == "ssm":
        t["layers"] = stacked(cfg.n_layers, SSM.ssm_block_template(cfg))
    else:
        t["layers"] = stacked(cfg.n_layers, {
            "ln1": L.norm_template(cfg),
            "attn": L.attention_template(cfg),
            "ln2": L.norm_template(cfg),
            "ffn": L.mlp_template(cfg),
        })
    return t


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer(tree, i: int):
    return tree_map(lambda t: t[i], tree)


def _unstack(tree, n: int):
    """The per-layer views of a stacked tree, from one ``unbind`` per
    leaf: its backward stacks the layers' gradients once, where a
    per-layer index would make each layer's backward write a zero-filled
    gradient of the whole stacked leaf."""
    leaves = flatten_with_paths(tree)
    parts = {p: t.unbind(0) for p, t in leaves}
    return [fill_like(tree, {p: u[i] for p, u in parts.items()})
            for i in range(n)]


@dataclass(frozen=True)
class CallOptions:
    remat: str = "none"             # none | full


def _block(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor,
           cache) -> torch.Tensor:
    h = L.apply_norm(cfg, p["ln1"], x)
    x = x + L.attention_forward(
        cfg, p["attn"], h, positions, window=cfg.attn_window, cache=cache)
    h = L.apply_norm(cfg, p["ln2"], x)
    return x + L.mlp_forward(cfg, p["ffn"], h)


def _decoder(cfg: ModelConfig, stacked_params, x: torch.Tensor,
             positions: torch.Tensor, cache,
             opts: CallOptions = CallOptions()) -> torch.Tensor:
    """The layer stack; ``cache`` (stacked over layers) is written in
    place. Remat "full" recomputes each layer in the backward pass."""
    layers = _unstack(stacked_params, cfg.n_layers)
    for i, p in enumerate(layers):
        c = _layer(cache, i) if cache is not None else None
        if opts.remat == "full" and cache is None:
            x = checkpoint(_block, cfg, p, x, positions, None,
                           use_reentrant=False)
        else:
            x = _block(cfg, p, x, positions, c)
    return x


def _ssm_layer(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    return x + SSM.ssm_block_forward(cfg, p, x)[0]


def _scan_ssm(cfg: ModelConfig, stacked_params, x: torch.Tensor, cache,
              opts: CallOptions = CallOptions()) -> torch.Tensor:
    """The Mamba-2 layer stack; ``cache`` (stacked over layers) is
    written in place. Remat "full" recomputes each layer in the backward
    pass (the JAX package's ``jax.checkpoint`` of the scan body)."""
    layers = _unstack(stacked_params, cfg.n_layers)
    for i, p in enumerate(layers):
        if cache is None:
            if opts.remat == "full":
                x = checkpoint(_ssm_layer, cfg, p, x, use_reentrant=False)
            else:
                x = _ssm_layer(cfg, p, x)
            continue
        c = _layer(cache, i)
        out, new = SSM.ssm_block_forward(cfg, p, x, c)
        for k, t in new.items():
            c[k].copy_(t)
        x = x + out
    return x


def _backbone(cfg: ModelConfig, params, x: torch.Tensor,
              positions: torch.Tensor, cache,
              opts: CallOptions = CallOptions()) -> torch.Tensor:
    if cfg.family == "ssm":
        return _scan_ssm(cfg, params["layers"], x, cache, opts)
    return _decoder(cfg, params["layers"], x, positions, cache, opts)


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok_emb"][tokens.long()]


def _logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    x = L.apply_norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["tok_emb"])
    return torch.einsum("bsd,dv->bsv", x, params["lm_head"])


def forward_train(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
                  opts: CallOptions = CallOptions()):
    """Full-sequence forward. batch: tokens [B,S] int32.

    Returns (logits [B,S,V], aux: dict). Positions are ``arange(S)``, so
    attention takes its no-cache branch (the flash kernels on the card);
    the ssm family's scan runs the SSD kernels on the card."""
    _check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    x = _backbone(cfg, params, _embed(params, tokens), positions, None, opts)
    aux = {"moe_aux": torch.zeros((), dtype=torch.float32,
                                  device=tokens.device)}
    return _logits(cfg, params, x), aux


# --- caches -----------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, max_seq: int) -> Dict[str, Any]:
    """Shapes/dtypes of the whole model's decode state: per leaf
    [L, B, Smax, Hkv, hd] for k/v and [L, B, Smax] int32 positions; for
    the ssm family the conv states [L, B, cw-1, ...] and the scan state
    [L, B, H, P, N] float32."""
    _check_family(cfg)
    n = cfg.n_layers
    if cfg.family == "ssm":
        return {k: TensorSpec((n,) + shape, dt) for k, (shape, dt)
                in SSM.ssm_cache_spec(cfg, batch).items()}
    h, nkv = cfg.resolved_head_dim, cfg.n_kv_heads
    smax = min(max_seq, cfg.attn_window) if cfg.attn_window else max_seq
    dt = torch_dtype(cfg.dtype)
    return {
        "k": TensorSpec((n, batch, smax, nkv, h), dt),
        "v": TensorSpec((n, batch, smax, nkv, h), dt),
        "pos": TensorSpec((n, batch, smax), torch.int32),
    }


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """An empty cache on ``device`` (default: the card): float leaves
    zeros, ``pos`` -1 (every slot empty)."""
    dev = resolve_device(device)

    def make(s: TensorSpec) -> torch.Tensor:
        if s.dtype == torch.int32:
            return torch.full(s.shape, -1, dtype=torch.int32, device=dev)
        return torch.zeros(s.shape, dtype=s.dtype, device=dev)

    return {k: make(s) for k, s in cache_spec(cfg, batch, max_seq).items()}


# --- prefill / decode --------------------------------------------------------

@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, cache):
    """Run the full prompt, filling ``cache`` in place. Returns
    (last_logits [B, V], cache)."""
    _check_family(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    x = _backbone(cfg, params, _embed(params, tokens), positions, cache)
    return _logits(cfg, params, x[:, -1:])[:, 0], cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache, tokens: torch.Tensor,
                pos: torch.Tensor):
    """One token for every sequence. tokens: [B,1]; pos: [B] int32.
    Returns (logits [B,V], cache), the cache updated in place."""
    _check_family(cfg)
    positions = pos[:, None].to(torch.int32)
    x = _backbone(cfg, params, _embed(params, tokens), positions, cache)
    return _logits(cfg, params, x)[:, 0], cache


# --- init --------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Random params from per-leaf ``torch.Generator``s seeded by
    ``seed`` (see ``params.init_concrete``), on ``device`` (default: the
    card)."""
    return PM.init_concrete(param_template(cfg), cfg.dtype, seed, device)


def init_abstract(cfg: ModelConfig):
    return PM.init_abstract(param_template(cfg), cfg.dtype)


def logical_specs(cfg: ModelConfig):
    return PM.logical_specs(param_template(cfg))


def param_count(cfg: ModelConfig) -> int:
    return PM.count_params(param_template(cfg))
