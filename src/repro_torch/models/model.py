"""Model assembly for the dense decoder, the moe family (its decoder
blocks' FFN a routed mixture of experts, ``models.moe``), the ssm family
(Mamba-2), the hybrid family (Griffin/RecurrentGemma) and the whisper
encoder-decoder — the port of ``repro.models.model``:
``param_template``, ``forward_train``,
``cache_spec``, ``init_cache``, ``prefill``, ``decode_step``,
``init_params``, ``init_abstract`` and ``logical_specs``, plus
``batch_axes``, where each decode-state leaf keeps its batch (slot)
index.

Parameters are nested dicts of tensors stacked over a leading layer (or,
for the hybrid, block-group) axis, exactly the JAX package's layout and
paths; the hybrid's remainder blocks (``rem{i}_{kind}``, when the layer
count is no multiple of the block pattern) are not stacked. Where the
JAX package runs a stack under ``jax.lax.scan``, this is a Python loop
that indexes the stacked dim (a view, no copy). Remat "full" wraps each
layer in ``torch.utils.checkpoint`` (non-reentrant), where the JAX
package wraps the scan body in ``jax.checkpoint`` (for whisper: each
encoder layer and each decoder layer; for the hybrid: each block group,
its remainder blocks not). Decode state (KV caches, conv
windows, recurrent states) is updated in place; whisper's cross-attention
cache ``cross`` = (k, v), stacked over decoder layers, is written by
``prefill(frames=)`` and only read by ``decode_step``. The moe
family's blocks return their router's load-balance loss, summed over the
layers in order into ``forward_train``'s ``moe_aux``; prefill and decode
drop it, as the JAX package does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.host import resolve_device, torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import hybrid as HY
from repro_torch.models import moe as MOE
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
    if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported; the "
            "port runs the dense decoder, the moe, the ssm, the hybrid and "
            "the encoder-decoder family")


def check_trainable(cfg: ModelConfig) -> None:
    """Raise unless the port can train ``cfg``'s family (every family it
    runs)."""
    _check_family(cfg)


def _hybrid_layout(cfg: ModelConfig):
    """(number of stacked block groups, [(key, kind)] of one group,
    [(key, kind)] of the unstacked remainder blocks)."""
    n_groups, rem = divmod(cfg.n_layers, len(cfg.block_pattern))
    group = [(f"b{i}_{kind}", kind) for i, kind in
             enumerate(cfg.block_pattern)]
    tail = [(f"rem{i}_{cfg.block_pattern[i]}", cfg.block_pattern[i])
            for i in range(rem)]
    return n_groups, group, tail


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
    elif cfg.family == "hybrid":
        def block(kind):
            return HY.rglru_block_template(cfg) if kind == "rglru" \
                else HY.attn_block_template(cfg)
        n_groups, group, tail = _hybrid_layout(cfg)
        t["groups"] = stacked(n_groups, {k: block(kind)
                                         for k, kind in group})
        for k, kind in tail:
            t[k] = block(kind)
    elif cfg.is_encoder_decoder:
        t["enc_layers"] = stacked(cfg.n_encoder_layers, {
            "ln1": L.norm_template(cfg),
            "attn": L.attention_template(cfg),
            "ln2": L.norm_template(cfg),
            "ffn": L.mlp_template(cfg),
        })
        t["enc_final_norm"] = L.norm_template(cfg)
        t["layers"] = stacked(cfg.n_layers, {
            "ln1": L.norm_template(cfg),
            "attn": L.attention_template(cfg),
            "ln_cross": L.norm_template(cfg),
            "cross": L.attention_template(cfg),
            "ln2": L.norm_template(cfg),
            "ffn": L.mlp_template(cfg),
        })
    else:       # the dense and moe decoder
        t["layers"] = stacked(cfg.n_layers, {
            "ln1": L.norm_template(cfg),
            "attn": L.attention_template(cfg),
            "ln2": L.norm_template(cfg),
            "ffn": MOE.moe_template(cfg) if cfg.n_experts
            else L.mlp_template(cfg),
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
           cache) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One decoder block: (x, its moe aux loss; None for a dense FFN)."""
    h = L.apply_norm(cfg, p["ln1"], x)
    x = x + L.attention_forward(
        cfg, p["attn"], h, positions, window=cfg.attn_window, cache=cache)
    h = L.apply_norm(cfg, p["ln2"], x)
    if cfg.n_experts:
        f, aux = MOE.moe_forward(cfg, p["ffn"], h)
    else:
        f, aux = L.mlp_forward(cfg, p["ffn"], h), None
    return x + f, aux


def _decoder(cfg: ModelConfig, stacked_params, x: torch.Tensor,
             positions: torch.Tensor, cache,
             opts: CallOptions = CallOptions()
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer stack: (x, the blocks' aux losses summed in layer
    order from an f32 zero); ``cache`` (stacked over layers) is written
    in place. Remat "full" recomputes each layer in the backward pass."""
    layers = _unstack(stacked_params, cfg.n_layers)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(layers):
        c = _layer(cache, i) if cache is not None else None
        if opts.remat == "full" and cache is None:
            x, a = checkpoint(_block, cfg, p, x, positions, None,
                              use_reentrant=False)
        else:
            x, a = _block(cfg, p, x, positions, c)
        if a is not None:
            aux = aux + a
    return x, aux


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


def _hybrid_block(cfg: ModelConfig, kind: str, p, x: torch.Tensor,
                  positions: torch.Tensor, cache) -> torch.Tensor:
    if kind != "rglru":
        return HY.attn_block_forward(cfg, p, x, positions, cache)
    x, new = HY.rglru_block_forward(cfg, p, x, cache)
    if cache is not None:
        for k, t in new.items():
            cache[k].copy_(t)
    return x


def _hybrid_group(cfg: ModelConfig, group, p_g, x: torch.Tensor,
                  positions: torch.Tensor, c_g) -> torch.Tensor:
    for k, kind in group:
        x = _hybrid_block(cfg, kind, p_g[k], x, positions,
                          c_g[k] if c_g is not None else None)
    return x


def _scan_hybrid(cfg: ModelConfig, params, x: torch.Tensor,
                 positions: torch.Tensor, cache,
                 opts: CallOptions = CallOptions()) -> torch.Tensor:
    """The block groups in order (the JAX package's ``lax.scan`` over
    ``groups``), then the remainder blocks; ``cache`` is written in
    place. Remat "full" recomputes each group in the backward pass (the
    reference's ``jax.checkpoint`` of the scan body); the remainder
    blocks are not recomputed, as there."""
    n_groups, group, tail = _hybrid_layout(cfg)
    for g, p_g in enumerate(_unstack(params["groups"], n_groups)):
        if cache is None and opts.remat == "full":
            x = checkpoint(_hybrid_group, cfg, group, p_g, x, positions,
                           None, use_reentrant=False)
            continue
        c_g = _layer(cache["groups"], g) if cache is not None else None
        x = _hybrid_group(cfg, group, p_g, x, positions, c_g)
    for k, kind in tail:
        x = _hybrid_block(cfg, kind, params[k], x, positions,
                          cache[k] if cache is not None else None)
    return x


def _enc_layer(cfg: ModelConfig, p, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    h = L.apply_norm(cfg, p["ln1"], x)
    x = x + L.attention_forward(cfg, p["attn"], h, positions, causal=False)
    h = L.apply_norm(cfg, p["ln2"], x)
    return x + L.mlp_forward(cfg, p["ffn"], h)


def _whisper_encoder(cfg: ModelConfig, params, frames: torch.Tensor,
                     opts: CallOptions = CallOptions()) -> torch.Tensor:
    """frames [B, Senc, D] (precomputed embeddings: the audio frontend
    is a stub) -> the encoder output [B, Senc, D] in the model dtype:
    non-causal self-attention with RoPE at positions ``arange(Senc)``,
    then ``enc_final_norm``."""
    B, Se, _ = frames.shape
    positions = torch.arange(Se, dtype=torch.int32,
                             device=frames.device)[None].expand(B, Se)
    x = frames.to(torch_dtype(cfg.dtype))
    for p in _unstack(params["enc_layers"], cfg.n_encoder_layers):
        if opts.remat == "full":
            x = checkpoint(_enc_layer, cfg, p, x, positions,
                           use_reentrant=False)
        else:
            x = _enc_layer(cfg, p, x, positions)
    return L.apply_norm(cfg, params["enc_final_norm"], x)


def _cross_kv(p, enc_out: torch.Tensor):
    """A decoder layer's cross-attention (k, v) [B, Senc, Hkv, hd] from
    the encoder output: projections with no bias, no norm, no RoPE."""
    return (torch.einsum("bsd,dhk->bshk", enc_out, p["cross"]["wk"]),
            torch.einsum("bsd,dhk->bshk", enc_out, p["cross"]["wv"]))


def _dec_layer(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor,
               cross_kv, cache) -> torch.Tensor:
    h = L.apply_norm(cfg, p["ln1"], x)
    x = x + L.attention_forward(cfg, p["attn"], h, positions, cache=cache)
    h = L.apply_norm(cfg, p["ln_cross"], x)
    x = x + L.attention_forward(cfg, p["cross"], h, positions,
                                cross_kv=cross_kv, use_rope=False)
    h = L.apply_norm(cfg, p["ln2"], x)
    return x + L.mlp_forward(cfg, p["ffn"], h)


def _dec_layer_train(cfg: ModelConfig, p, x: torch.Tensor,
                     positions: torch.Tensor,
                     enc_out: torch.Tensor) -> torch.Tensor:
    return _dec_layer(cfg, p, x, positions, _cross_kv(p, enc_out), None)


def _whisper_decoder(cfg: ModelConfig, params, x: torch.Tensor,
                     positions: torch.Tensor, cache,
                     enc_out: Optional[torch.Tensor],
                     opts: CallOptions = CallOptions()) -> torch.Tensor:
    """The decoder stack. Without a cache (training) each layer takes its
    cross k/v from ``enc_out``; with one, prefill (``enc_out`` given)
    computes them and writes them into ``cache["cross"]``, and decode
    (``enc_out`` None) reads them from there. The self-attention cache
    ``cache["self"]`` is written in place."""
    for i, p in enumerate(_unstack(params["layers"], cfg.n_layers)):
        if cache is None:
            if opts.remat == "full":
                x = checkpoint(_dec_layer_train, cfg, p, x, positions,
                               enc_out, use_reentrant=False)
            else:
                x = _dec_layer_train(cfg, p, x, positions, enc_out)
            continue
        ck, cv = (c[i] for c in cache["cross"])
        if enc_out is not None:
            kv = _cross_kv(p, enc_out)
            ck.copy_(kv[0])
            cv.copy_(kv[1])
        x = _dec_layer(cfg, p, x, positions, (ck, cv),
                       _layer(cache["self"], i))
    return x


def _need_frames(cfg: ModelConfig, cache, frames) -> None:
    if frames is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder needs frames "
                         "[B, Senc, D] for its encoder")
    senc = cache["cross"][0].shape[2] if cache is not None else None
    if senc is not None and frames.shape[1] != senc:
        raise ValueError(f"{cfg.name}: frames hold {frames.shape[1]} "
                         f"encoder positions, the cache {senc}")


def _backbone(cfg: ModelConfig, params, x: torch.Tensor,
              positions: torch.Tensor, cache,
              opts: CallOptions = CallOptions(),
              frames: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, the summed moe aux loss: an f32 zero outside the moe
    family)."""
    zero = lambda: torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        return _scan_ssm(cfg, params["layers"], x, cache, opts), zero()
    if cfg.family == "hybrid":
        return _scan_hybrid(cfg, params, x, positions, cache, opts), zero()
    if cfg.is_encoder_decoder:
        enc = None if frames is None \
            else _whisper_encoder(cfg, params, frames, opts)
        return (_whisper_decoder(cfg, params, x, positions, cache, enc,
                                 opts), zero())
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
    """Full-sequence forward. batch: tokens [B,S] int32 (+ frames
    [B,Senc,D] float for the encoder-decoder).

    Returns (logits [B,S,V], aux: dict), ``aux["moe_aux"]`` the moe
    family's router losses summed over the layers (an f32 zero for the
    other families). Positions are ``arange(S)``, so
    attention takes its no-cache branch (the flash kernels on the card;
    whisper's encoder and cross-attention too, non-causal; the hybrid's
    local attention with its window, at head dim 256 for
    recurrentgemma-9b); the ssm family's scan runs the SSD kernels on
    the card, the hybrid's recurrence the RG-LRU kernels (forward and
    backward)."""
    check_trainable(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    frames = batch.get("frames")
    if cfg.is_encoder_decoder:
        _need_frames(cfg, None, frames)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    x, moe_aux = _backbone(cfg, params, _embed(params, tokens), positions,
                           None, opts, frames)
    return _logits(cfg, params, x), {"moe_aux": moe_aux}


# --- caches -----------------------------------------------------------------

def _kv_spec(cfg: ModelConfig, batch: int, max_seq: int):
    """(shape, dtype) of one attention layer's cache: k/v [B, Smax, Hkv,
    hd] and int32 positions [B, Smax]; with a window, Smax is at most the
    window (a ring buffer)."""
    h, nkv = cfg.resolved_head_dim, cfg.n_kv_heads
    smax = min(max_seq, cfg.attn_window) if cfg.attn_window else max_seq
    dt = torch_dtype(cfg.dtype)
    return {"k": ((batch, smax, nkv, h), dt), "v": ((batch, smax, nkv, h), dt),
            "pos": ((batch, smax), torch.int32)}


def _cache_tree(cfg: ModelConfig, batch: int, max_seq: int,
                leaf: Callable[[Tuple[int, ...], torch.dtype, Optional[int]],
                               Any]):
    """The decode-state tree with each leaf ``leaf(shape, dtype, n)``:
    one layer's shape and dtype, and the number of layers (or hybrid
    block groups) stacked on a leading axis in front of it — None for
    a block that stands alone (the hybrid's ``rem*`` blocks)."""
    def block(spec, n):
        return {k: leaf(shape, dt, n) for k, (shape, dt) in spec.items()}

    if cfg.family == "ssm":
        return block(SSM.ssm_cache_spec(cfg, batch), cfg.n_layers)
    if cfg.family == "hybrid":
        def one(kind):
            return HY.rglru_cache_spec(cfg, batch) if kind == "rglru" \
                else _kv_spec(cfg, batch, max_seq)
        n_groups, group, tail = _hybrid_layout(cfg)
        out: Dict[str, Any] = {"groups": {k: block(one(kind), n_groups)
                                          for k, kind in group}}
        out.update({k: block(one(kind), None) for k, kind in tail})
        return out
    if cfg.is_encoder_decoder:
        cross = ((batch, cfg.encoder_seq, cfg.n_kv_heads,
                  cfg.resolved_head_dim), torch_dtype(cfg.dtype))
        return {"self": block(_kv_spec(cfg, batch, max_seq), cfg.n_layers),
                "cross": tuple(leaf(*cross, cfg.n_layers) for _ in "kv")}
    return block(_kv_spec(cfg, batch, max_seq), cfg.n_layers)


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int) -> Dict[str, Any]:
    """Shapes/dtypes of the whole model's decode state, the JAX
    package's tree: k/v [L, B, Smax, Hkv, hd] and [L, B, Smax] int32
    positions; for the ssm family the conv states [L, B, cw-1, ...] and
    the scan state [L, B, H, P, N] float32; for the hybrid, per block of
    the pattern under ``groups`` (stacked over groups) and per remainder
    block (unstacked) the KV cache, or the conv window [B, 3, W] and the
    f32 state [B, W]; for the encoder-decoder the decoder's KV cache
    under ``self`` and ``cross`` = (k, v), each [L, B, Senc, Hkv, hd]."""
    _check_family(cfg)
    return _cache_tree(cfg, batch, max_seq, lambda shape, dt, n: TensorSpec(
        shape if n is None else (n,) + shape, dt))


def batch_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Per decode-state leaf (the tree of ``cache_spec``), the axis that
    holds the batch (slot) index: 1 behind a stacked layer or group
    axis, 0 on a block that stands alone. The leaf's rank does not
    tell: a remainder block's conv window [B, 3, W] has rank 3 and its
    batch on axis 0."""
    _check_family(cfg)
    return _cache_tree(cfg, 1, 1, lambda shape, dt, n: 0 if n is None else 1)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """An empty cache on ``device`` (default: the card): float leaves
    zeros, ``pos`` -1 (every slot empty)."""
    dev = resolve_device(device)

    def make(s: TensorSpec) -> torch.Tensor:
        if s.dtype == torch.int32:
            return torch.full(s.shape, -1, dtype=torch.int32, device=dev)
        return torch.zeros(s.shape, dtype=s.dtype, device=dev)

    return tree_map(make, cache_spec(cfg, batch, max_seq))


# --- prefill / decode --------------------------------------------------------

@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, cache,
            frames: Optional[torch.Tensor] = None):
    """Run the full prompt, filling ``cache`` in place. Returns
    (last_logits [B, V], cache). The encoder-decoder needs ``frames``
    [B, Senc, D]: the encoder runs over them and each decoder layer's
    cross k/v land in ``cache["cross"]``."""
    _check_family(cfg)
    if cfg.is_encoder_decoder:
        _need_frames(cfg, cache, frames)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    x, _ = _backbone(cfg, params, _embed(params, tokens), positions, cache,
                     frames=frames)
    return _logits(cfg, params, x[:, -1:])[:, 0], cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache, tokens: torch.Tensor,
                pos: torch.Tensor):
    """One token for every sequence. tokens: [B,1]; pos: [B] int32.
    Returns (logits [B,V], cache), the cache updated in place (the
    encoder-decoder's ``cross`` is read, not written)."""
    _check_family(cfg)
    positions = pos[:, None].to(torch.int32)
    x, _ = _backbone(cfg, params, _embed(params, tokens), positions, cache)
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
