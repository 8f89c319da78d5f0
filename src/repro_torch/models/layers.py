"""Shared layers — norms, RoPE, position-masked GQA attention with a KV
cache, and the MLP — the port of ``repro.models.layers`` for the dense
decoder.

Attention without a cache (the training forward, positions
``arange(S)``; the whisper encoder) goes through the flash-attention
kernels on a CUDA tensor: there the kernels' index masks equal the
position masks. So does cross-attention over given encoder k/v with more
than one query (non-causal, keys ``arange(Skv)``). On the CPU, on every
cache path (prefill, decode) and for a single cross-attention query, it
stays the plain dense/chunked attention below.

The arithmetic follows the JAX functions step for step (float32 norms,
RoPE and softmax; ``-1e30`` instead of ``-inf`` for masked scores), so
the two packages agree to float rounding. The softmax's exponential is
``numerics.exp_stable``: on the CPU its bits depend on the values alone
(ROADMAP C18), on the card it is ``torch.exp``. One deliberate difference:
the JAX package updates the KV cache functionally (``.at[].set``); here
the cache tensors are written in place (``index_put_`` / ``copy_``),
which keeps one cache allocation alive instead of two. A snapshot of the
cache therefore has to copy it (``core.async_snapshot._StagingSlot``)
and cannot assume an unchanged object holds unchanged bytes.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.numerics import exp_stable
from repro_torch.models.params import P

NEG_INF = -1e30  # large-negative instead of -inf: keeps masked softmax NaN-free


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def norm_template(cfg: ModelConfig, d: Optional[int] = None) -> Dict[str, P]:
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": P((d,), (None,), init="ones", dtype="float32"),
                "bias": P((d,), (None,), init="zeros", dtype="float32")}
    return {"scale": P((d,), (None,), init="zeros", dtype="float32")}


def apply_norm(cfg: ModelConfig, p: Dict[str, torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rmsnorm(x, p["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_apply(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S] (broadcastable)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freqs        # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                 # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention parameter template
# ---------------------------------------------------------------------------

def attention_template(cfg: ModelConfig) -> Dict[str, Any]:
    d, h = cfg.d_model, cfg.resolved_head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    t: Dict[str, Any] = {
        "wq": P((d, nh, h), ("embed", "heads", None), fan_in=d),
        "wk": P((d, nkv, h), ("embed", "kv_heads", None), fan_in=d),
        "wv": P((d, nkv, h), ("embed", "kv_heads", None), fan_in=d),
        "wo": P((nh, h, d), ("heads", None, "embed"), fan_in=nh * h),
    }
    if cfg.qkv_bias:
        t["bq"] = P((nh, h), ("heads", None), init="zeros")
        t["bk"] = P((nkv, h), ("kv_heads", None), init="zeros")
        t["bv"] = P((nkv, h), ("kv_heads", None), init="zeros")
    if cfg.qk_norm:
        t["q_norm"] = P((h,), (None,), init="zeros", dtype="float32")
        t["k_norm"] = P((h,), (None,), init="zeros", dtype="float32")
    return t


# ---------------------------------------------------------------------------
# attention — position-masked (pos == -1 marks an empty cache slot)
# ---------------------------------------------------------------------------

def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor:
    """[B, Sq, Skv] validity: slot filled, causal, inside the window."""
    valid = kv_pos[:, None, :] >= 0
    if causal:
        valid = valid & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window > 0:
        valid = valid & (q_pos[:, :, None] - kv_pos[:, None, :] < window)
    return valid


def chunked_attention(
    q: torch.Tensor,              # [B, Sq, Hkv, G, hd]
    k: torch.Tensor,              # [B, Skv, Hkv, hd]
    v: torch.Tensor,              # [B, Skv, Hkv, hd]
    q_pos: torch.Tensor,          # [B, Sq] int32
    kv_pos: torch.Tensor,         # [B, Skv] int32 (-1 = invalid slot)
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    chunk: int = 1024,
) -> torch.Tensor:
    """Streaming-softmax attention over kv chunks (the flash recurrence,
    as a loop over chunks). Returns [B,Sq,Hkv,G,hd]; f32 accumulation."""
    B, Sq, Hkv, G, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    chunk = min(chunk, k.shape[1])
    qf = q.float() * scale
    m = torch.full((B, Sq, Hkv, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Sq, Hkv, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, Hkv, G, hd), dtype=torch.float32,
                      device=q.device)
    for lo in range(0, k.shape[1], chunk):
        kc = k[:, lo:lo + chunk].float()
        vc = v[:, lo:lo + chunk].float()
        pc = kv_pos[:, lo:lo + chunk]
        s = torch.einsum("bqkgd,bckd->bqkgc", qf, kc)
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        valid = _mask(q_pos, pc, causal, window)
        s = s.masked_fill(~valid[:, :, None, None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = exp_stable(s - m_new[..., None])
        corr = exp_stable(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd",
                                                   p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def dense_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_pos: torch.Tensor, kv_pos: torch.Tensor,
    *, causal: bool = True, window: int = 0, softcap: float = 0.0,
) -> torch.Tensor:
    """One-shot softmax attention (decode and short-seq paths). Shapes
    as chunked_attention."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    s = _per_row("bqkgd,bckd->bqkgc", q.float() * scale, k.float())
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    valid = _mask(q_pos, kv_pos, causal, window)
    s = s.masked_fill(~valid[:, :, None, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = exp_stable(s - m)
    out = _per_row("bqkgc,bckd->bqkgd", p, v.float())
    out = out / torch.clamp(p.sum(dim=-1), min=1e-30)[..., None]
    return out.to(q.dtype)


def _per_row(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` over a leading batch axis, one batch row
    a call. A batched GEMM picks its kernel by the batch count, so a
    row's bits would otherwise depend on how many rows share the call
    (on an H100 the decode step's probabilities-times-values product
    differed at 3 rows against 4), and a session re-slotted onto another
    slot count would decode other bits than the run it left."""
    return torch.cat([torch.einsum(eq, a[i:i + 1], b[i:i + 1])
                      for i in range(a.shape[0])])


# ---------------------------------------------------------------------------
# full attention block (projections + rope + cache handling)
# ---------------------------------------------------------------------------

def attention_forward(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                   # [B, S, D]
    positions: torch.Tensor,           # [B, S]
    *,
    window: int = 0,
    causal: bool = True,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    use_rope: bool = True,
    attn_chunk: int = 1024,
) -> torch.Tensor:
    """Returns the attention output [B,S,D]; a given ``cache`` is
    updated IN PLACE.

    cache layout (serving.kv_cache): {"k": [B,Smax,Hkv,hd], "v": ...,
    "pos": [B,Smax] int32}; with a window, Smax == window and the cache
    is a ring buffer indexed by position. ``cross_kv``: the encoder's
    (k, v) [B,Skv,Hkv,hd] for cross-attention, taken as given (no
    norm, no RoPE); the cache is then unused."""
    B, S, D = x.shape
    h = cfg.resolved_head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    g = nh // nkv

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if cross_kv is None:
        k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
        if "bk" in p:
            k, v = k + p["bk"], v + p["bv"]
    else:
        k, v = cross_kv
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        if cross_kv is None:
            k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        q = rope_apply(q, positions, cfg.rope_theta)
        if cross_kv is None:
            k = rope_apply(k, positions, cfg.rope_theta)

    if cross_kv is not None:
        if q.is_cuda and S > 1:
            out = _flash_no_cache(q, k, v, causal=False, window=0)
            return torch.einsum("bshk,hkd->bsd", out, p["wo"])
        skv = k.shape[1]
        kv_pos = torch.arange(skv, dtype=torch.int32,
                              device=k.device)[None].expand(B, skv)
        out = dense_attention(q.reshape(B, S, k.shape[2], -1, h), k, v,
                              positions, kv_pos, causal=False)
        return torch.einsum("bshk,hkd->bsd", out.reshape(B, S, nh, h),
                            p["wo"])

    qg = q.reshape(B, S, nkv, g, h)
    softcap = cfg.attn_logit_softcap
    if cache is not None:
        smax = cache["k"].shape[1]
        if window > 0 and S > smax:
            # prefill into a ring buffer: only the trailing `window`
            # positions can ever be attended to — write just those.
            pos_w = positions[:, -smax:]
            slot = pos_w % smax
            _scatter_rows_(cache["k"], slot, k[:, -smax:])
            _scatter_rows_(cache["v"], slot, v[:, -smax:])
            _scatter_rows_(cache["pos"], slot, pos_w)
        else:
            slot = positions % smax if window > 0 else positions
            _scatter_rows_(cache["k"], slot, k)
            _scatter_rows_(cache["v"], slot, v)
            _scatter_rows_(cache["pos"], slot, positions)
        if S == 1:
            # decode: attend over the (just updated) cache
            att_k, att_v, att_pos = cache["k"], cache["v"], cache["pos"]
        else:
            # prefill: attend over the inputs (a ring cache only holds the
            # trailing window; every query still sees its own context here)
            att_k, att_v, att_pos = k, v, positions
    else:
        if q.is_cuda and softcap == 0.0:
            return torch.einsum("bshk,hkd->bsd", _flash_no_cache(
                q, k, v, causal=causal, window=window), p["wo"])
        att_k, att_v, att_pos = k, v, positions
    if S == 1 or att_k.shape[1] <= 2048:
        out = dense_attention(qg, att_k, att_v, positions, att_pos,
                              causal=causal, window=window, softcap=softcap)
    else:
        out = chunked_attention(qg, att_k, att_v, positions, att_pos,
                                causal=causal, window=window,
                                softcap=softcap, chunk=attn_chunk)
    return torch.einsum("bshk,hkd->bsd", out.reshape(B, S, nh, h), p["wo"])


def _flash_no_cache(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int) -> torch.Tensor:
    """q [B,Sq,H,hd], k/v [B,Skv,Hkv,hd] (query positions arange(Sq),
    key positions arange(Skv)) through the flash kernels' [B,H,S,hd]
    layout; returns [B,Sq,H,hd]. Head h reads kv head h // (H/Hkv), the
    model's [B,S,Hkv,G,hd] grouping."""
    out = flash_attention(q.transpose(1, 2).contiguous(),
                          k.transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous(),
                          causal=causal, window=window)
    return out.transpose(1, 2)


def _scatter_rows_(buf: torch.Tensor, slots: torch.Tensor,
                   rows: torch.Tensor) -> None:
    """In-place counterpart of the JAX package's ``_scatter_rows``:
    buf [B, Smax, ...]; slots [B, S]; rows [B, S, ...]."""
    B, S = slots.shape
    if S == buf.shape[1] and rows.shape[:2] == buf.shape[:2]:
        # full overwrite in slot order (prefill fills every slot exactly
        # once when S == Smax and slots is 0..S-1)
        buf.copy_(rows)
        return
    b_idx = torch.arange(B, device=buf.device)[:, None].expand(B, S)
    buf.index_put_((b_idx, slots.long()), rows.to(buf.dtype))


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------

def mlp_template(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, Any]:
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    if cfg.act in ("silu", "gelu_glu"):
        return {
            "w_gate": P((d, f), ("embed", "ff"), fan_in=d),
            "w_up": P((d, f), ("embed", "ff"), fan_in=d),
            "w_down": P((f, d), ("ff", "embed"), fan_in=f),
        }
    t = {
        "w_in": P((d, f), ("embed", "ff"), fan_in=d),
        "w_out": P((f, d), ("ff", "embed"), fan_in=f),
    }
    if cfg.norm == "layernorm":  # bias-ful families (starcoder2, whisper)
        t["b_in"] = P((f,), ("ff",), init="zeros")
        t["b_out"] = P((d,), (None,), init="zeros")
    return t


def mlp_forward(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "silu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    if cfg.act == "gelu_glu":
        return (F.gelu(x @ p["w_gate"], approximate="tanh")
                * (x @ p["w_up"])) @ p["w_down"]
    h = x @ p["w_in"]
    if "b_in" in p:
        h = h + p["b_in"]
    y = F.gelu(h, approximate="tanh") @ p["w_out"]
    if "b_out" in p:
        y = y + p["b_out"]
    return y
