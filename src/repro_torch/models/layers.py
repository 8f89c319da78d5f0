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

Under a device mesh (``parallel.context``) the training forward's
tensors are DTensors: projections, norms and the MLP run through
DTensor's sharding propagation, and attention drops to each rank's
local heads (``_mesh_attention``) so the flash kernels — or the plain
attention on the CPU — only ever see plain tensors.
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
from repro_torch.parallel import context as pctx

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

    if is_dtensor(x) and (cache is not None or cross_kv is not None):
        raise NotImplementedError(
            "attention with a cache or cross k/v under a device mesh: "
            "serving over a mesh waits for ROADMAP A9b")
    x = replicate_seq(x)
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
    if is_dtensor(q):
        out = _mesh_attention(cfg, q, k, v, causal=causal, window=window,
                              use_rope=use_rope, attn_chunk=attn_chunk)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"])
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
        return torch.einsum("bshk,hkd->bsd", _attend(
            q, k, v, positions, causal=causal, window=window,
            softcap=softcap, attn_chunk=attn_chunk), p["wo"])
    out = _attend_positions(qg, att_k, att_v, positions, att_pos,
                            causal=causal, window=window, softcap=softcap,
                            attn_chunk=attn_chunk)
    return torch.einsum("bshk,hkd->bsd", out.reshape(B, S, nh, h), p["wo"])


def _attend_positions(qg, k, v, q_pos, kv_pos, *, causal, window, softcap,
                      attn_chunk):
    if qg.shape[1] == 1 or k.shape[1] <= 2048:
        return dense_attention(qg, k, v, q_pos, kv_pos, causal=causal,
                               window=window, softcap=softcap)
    return chunked_attention(qg, k, v, q_pos, kv_pos, causal=causal,
                             window=window, softcap=softcap, chunk=attn_chunk)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            positions: torch.Tensor, *, causal: bool, window: int,
            softcap: float, attn_chunk: int) -> torch.Tensor:
    """Attention without a cache (query and key positions both
    ``positions`` = ``arange(S)``): q [B,S,H,hd], k/v [B,S,Hkv,hd] ->
    [B,S,H,hd]; the flash kernels on a CUDA tensor, the plain dense or
    chunked attention elsewhere."""
    if q.is_cuda and softcap == 0.0:
        return _flash_no_cache(q, k, v, causal=causal, window=window)
    B, S, H, hd = q.shape
    out = _attend_positions(q.reshape(B, S, k.shape[2], -1, hd), k, v,
                            positions, positions, causal=causal,
                            window=window, softcap=softcap,
                            attn_chunk=attn_chunk)
    return out.reshape(B, S, H, hd)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicate_seq(x):
    """A DTensor activation [B, S, ...] with its sequence dim gathered
    over the mesh (sequence parallelism's all-gather before a
    projection: a product that folds B and S together needs S whole);
    anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
               for p in x.placements)
    return x if pl == tuple(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def kv_heads_for(n_heads: int, n_kv: int, model_size: int, model_rank: int
                 ) -> Tuple[int, int, Optional[list]]:
    """The KV heads that this rank's query heads read under GQA (query
    head h reads KV head h // (H / Hkv)) when the query heads are split
    over the model axis in contiguous blocks and the KV heads are not:
    ``(lo, hi, None)`` where the block covers whole groups (KV heads
    ``lo..hi-1``, the grouping kept), else ``(0, 0, idx)`` — one KV head
    per local query head (``-smoke`` at (1, 4): 4 query heads over 2 KV
    heads, each rank's one query head reads KV head ``rank // 2``)."""
    h_local = n_heads // model_size
    g = n_heads // n_kv
    heads = range(model_rank * h_local, (model_rank + 1) * h_local)
    if h_local % g == 0:
        return heads[0] // g, heads[-1] // g + 1, None
    return 0, 0, [h // g for h in heads]


def _mesh_attention(cfg: ModelConfig, q, k, v, *, causal: bool,
                    window: int, use_rope: bool, attn_chunk: int):
    """Attention of DTensors q [B,S,H,hd], k/v [B,S,Hkv,hd] on each
    rank's local batch rows and heads; returns [B,S,H,hd], split as q.

    Query heads split over the model axis when H divides by it, KV heads
    when Hkv does too (contiguous blocks line up under GQA); where KV
    heads do not divide, K/V stay replicated while Q is head-split and
    each rank takes the KV heads its own query heads read
    (``kv_heads_for``), their gradients then partial sums over the model
    axis. RoPE and the attention run on plain local tensors: the flash
    kernels on the card, the plain attention on the CPU."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = q.device_mesh
    ctx = pctx.for_mesh(mesh)
    m, r = ctx.model_size(), ctx.model_rank()
    H, Hkv = q.shape[2], k.shape[2]
    q_split = ctx.model_axis is not None and m > 1 and H % m == 0
    kv_split = q_split and Hkv % m == 0
    qp = ctx.placements(Shard(0), Shard(2) if q_split else Replicate())
    kvp = ctx.placements(Shard(0), Shard(2) if kv_split else Replicate())
    kv_grad = ctx.placements(Shard(0), Shard(2) if kv_split else
                             Partial() if q_split else Replicate())
    q_l = q.redistribute(mesh, qp).to_local(grad_placements=qp)
    k_l = k.redistribute(mesh, kvp).to_local(grad_placements=kv_grad)
    v_l = v.redistribute(mesh, kvp).to_local(grad_placements=kv_grad)
    if q_split and not kv_split:
        lo, hi, idx = kv_heads_for(H, Hkv, m, r)
        if idx is None:
            k_l, v_l = k_l[:, :, lo:hi], v_l[:, :, lo:hi]
        else:
            sel = torch.tensor(idx, device=k_l.device)
            k_l, v_l = k_l.index_select(2, sel), v_l.index_select(2, sel)
    B, S = q_l.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=q_l.device)[None].expand(B, S)
    if use_rope:
        q_l = rope_apply(q_l, positions, cfg.rope_theta)
        k_l = rope_apply(k_l, positions, cfg.rope_theta)
    out = _attend(q_l, k_l.contiguous(), v_l.contiguous(), positions,
                  causal=causal, window=window,
                  softcap=cfg.attn_logit_softcap, attn_chunk=attn_chunk)
    return DTensor.from_local(out, mesh, qp, run_check=False)


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
    x = replicate_seq(x)
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
