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

Under a device mesh (``parallel.context``) the training forward's and
the serving steps' tensors are DTensors: projections, norms and the MLP
run through DTensor's sharding propagation, and attention drops to each
rank's local heads (``_mesh_attention``; with a cache,
``_mesh_cached_attention``) so the flash kernels — or the plain
attention — only ever see plain tensors. A cache over a mesh comes in
as each layer's ``CacheBlock``: this rank's blocks of k, v and pos,
written in place. Where the plan splits the cache's sequence over the
model axis, each rank writes the positions that fall in its block and a
decode query attends to that block alone; the ranks then combine their
partial softmaxes in rank order (``combine_partials``), so every run on
one mesh gives the same bits.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.numerics import exp_stable
from repro_torch.kernels.trace import on_card
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
    _, l, acc = partial_attention(q, k, v, q_pos, kv_pos, causal=causal,
                                  window=window, softcap=softcap)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def partial_attention(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                      window: int = 0, softcap: float = 0.0):
    """``dense_attention`` before its normalisation, over the keys given
    (all of them, or one block of them): (the row max m [B,Sq,Hkv,G],
    the sum of exp l, the exp-weighted values acc [B,Sq,Hkv,G,hd]), all
    f32. A block where a row sees no key gives m = -1e30, which
    ``combine_partials`` weighs by 0."""
    hd = q.shape[-1]
    s = _per_row("bqkgd,bckd->bqkgc", q.float() * (1.0 / math.sqrt(hd)),
                 k.float())
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    valid = _mask(q_pos, kv_pos, causal, window)
    s = s.masked_fill(~valid[:, :, None, None, :], NEG_INF)
    m = s.amax(dim=-1)
    p = exp_stable(s - m[..., None])
    return m, p.sum(dim=-1), _per_row("bqkgc,bckd->bqkgd", p, v.float())


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

    if is_dtensor(x) and cross_kv is not None:
        raise NotImplementedError(
            "cross-attention under a device mesh: the encoder-decoder over "
            "a mesh waits for ROADMAP A9b step 4")
    x = replicate_seq(x)
    q = head_projection(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if cross_kv is None:
        k = head_projection(x, p["wk"])
        v = head_projection(x, p["wv"])
        if "bk" in p:
            k, v = k + p["bk"], v + p["bv"]
    else:
        k, v = cross_kv
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        if cross_kv is None:
            k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if is_dtensor(q) and cache is not None:
        out = _mesh_cached_attention(cfg, q, k, v, positions, cache,
                                     window=window, causal=causal,
                                     use_rope=use_rope,
                                     attn_chunk=attn_chunk)
        return head_output(out, p["wo"])
    if is_dtensor(q):
        out = _mesh_attention(cfg, q, k, v, causal=causal, window=window,
                              use_rope=use_rope, attn_chunk=attn_chunk)
        return head_output(out, p["wo"])
    if use_rope:
        q = rope_apply(q, positions, cfg.rope_theta)
        if cross_kv is None:
            k = rope_apply(k, positions, cfg.rope_theta)

    if cross_kv is not None:
        if on_card(q) and S > 1:
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
        blk = CacheBlock.whole(cache)
        _write_block_(blk, positions, k, v, window)
        att_k, att_v, att_pos = _attended(blk, positions, k, v)
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
    if on_card(q) and softcap == 0.0:
        return _flash_no_cache(q, k, v, causal=causal, window=window)
    B, S, H, hd = q.shape
    out = _attend_positions(q.reshape(B, S, k.shape[2], -1, hd), k, v,
                            positions, positions, causal=causal,
                            window=window, softcap=softcap,
                            attn_chunk=attn_chunk)
    return out.reshape(B, S, H, hd)


def head_projection(x, w):
    """``einsum("bsd,dhk->bshk", x, w)``. Over a mesh whose model axis
    does not divide the heads (24 query heads over 16, 8 KV heads over
    16), the product runs with the head dims flattened and its [B, S,
    H * hd] output is gathered whole over the model axis before the
    heads unflatten: DTensor splits that output by columns, a split that
    cuts a head, which it cannot unflatten; so is the gradient of the
    flattened weight before it unflattens. The reference replicates
    such heads over the model axis; ``_mesh_attention`` then takes them
    as replicated."""
    d, h, k = w.shape
    ctx = _uneven_heads(x, h)
    if ctx is None:
        return torch.einsum("bsd,dhk->bshk", x, w)
    wf = _GradWholeOverModel.apply(w.reshape(d, h * k), ctx)
    y = _whole_over_model(torch.matmul(x, wf), ctx)
    return y.reshape(*y.shape[:-1], h, k)


def _uneven_heads(x, h: int):
    """The mesh context of DTensor ``x`` where its model axis does not
    divide ``h`` heads, else None."""
    if not is_dtensor(x):
        return None
    ctx = pctx.for_mesh(x.device_mesh)
    m = ctx.model_size()
    return ctx if ctx.model_axis is not None and m > 1 and h % m else None


def _whole_over_model(t, ctx):
    """DTensor ``t`` with its model-axis placement made Replicate."""
    from torch.distributed.tensor import Replicate
    keep = tuple(Replicate() if a == ctx.model_axis else pl for a, pl in
                 zip(t.device_mesh.mesh_dim_names, t.placements))
    return t.redistribute(t.device_mesh, keep)


class _GradWholeOverModel(torch.autograd.Function):
    """Identity whose gradient is gathered whole over the model axis."""

    @staticmethod
    def forward(ctx, x, mctx):
        ctx.mctx = mctx
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _whole_over_model(g, ctx.mctx), None


def head_output(o, w):
    """``einsum("bshk,hkd->bsd", o, w)``; over a mesh whose model axis
    does not divide the heads, with the head dims flattened and the
    gradient that flows back into them gathered whole over the model
    axis before they unflatten (see :func:`head_projection`)."""
    h, k, d = w.shape
    ctx = _uneven_heads(o, h)
    if ctx is None:
        return torch.einsum("bshk,hkd->bsd", o, w)
    flat = _GradWholeOverModel.apply(o.reshape(*o.shape[:2], h * k), ctx)
    return torch.matmul(flat, _GradWholeOverModel.apply(
        w.reshape(h * k, d), ctx))


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


# ---------------------------------------------------------------------------
# attention with a cache over a mesh
# ---------------------------------------------------------------------------

@dataclass
class CacheBlock:
    """One layer's KV cache as this rank holds it (on one device, all of
    it: ``whole``): its blocks k, v [B_l, S_l, Hkv_l, hd] and pos
    [B_l, Smax] (the positions split only with the slots, so every model
    rank holds and writes them all), plain tensors that alias the
    cache's DTensors, so writes land in place; and where they lie in the whole layer: the first slot and
    sequence position of the block (``rows``, ``seq``), the whole
    cache's sequence length and KV head count, and whether its slots are
    split over the data axes."""
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    rows: int
    seq: int
    smax: int
    n_kv: int
    batch_split: bool

    @classmethod
    def whole(cls, cache: Dict[str, torch.Tensor]) -> "CacheBlock":
        """One layer's cache on one device: the block is all of it."""
        k = cache["k"]
        return cls(k=k, v=cache["v"], pos=cache["pos"], rows=0, seq=0,
                   smax=int(k.shape[1]), n_kv=int(k.shape[2]),
                   batch_split=False)

    @property
    def seq_split(self) -> bool:
        return self.k.shape[1] < self.smax

    @property
    def pos_block(self) -> torch.Tensor:
        """The positions of this rank's block of the sequence."""
        return self.pos[:, self.seq:self.seq + self.k.shape[1]]

    @property
    def kv_split(self) -> bool:
        return self.k.shape[2] < self.n_kv


def local_of(t):
    """A DTensor's local block, aliasing its storage (writes land in
    the DTensor)."""
    with torch.no_grad():
        return t.to_local()


def cache_block(cache: Dict[str, Any], i: int) -> CacheBlock:
    """Layer ``i`` of a cache of DTensors stacked over layers (k, v
    [L, B, Smax, Hkv, hd], pos [L, B, Smax]) as this rank's
    ``CacheBlock``."""
    from torch.distributed.tensor import Shard
    from repro_torch.parallel.sharding import block_narrows
    k = cache["k"]
    mesh = k.device_mesh
    coord = [int(mesh.get_local_rank(d)) for d in range(mesh.ndim)]
    start = [0] * k.ndim
    for d, lo, _ in block_narrows(tuple(k.shape), tuple(mesh.shape), coord,
                                  k.placements):
        start[d] = lo
    return CacheBlock(k=local_of(k)[i], v=local_of(cache["v"])[i],
                      pos=local_of(cache["pos"])[i], rows=start[1],
                      seq=start[2], smax=int(k.shape[2]),
                      n_kv=int(k.shape[3]), batch_split=any(
                          isinstance(p, Shard) and p.dim == 1 and n > 1
                          for p, n in zip(k.placements, mesh.shape)))


def _cache_slots(positions: torch.Tensor, smax: int, window: int):
    """(positions, slots) a cache write takes: every position, at its
    slot (``% smax`` in a ring buffer); with a window shorter than the
    input, only the trailing ``smax`` positions."""
    if window > 0 and positions.shape[1] > smax:
        positions = positions[:, -smax:]
    return positions, (positions % smax if window > 0 else positions)


def _write_block_(blk: CacheBlock, positions: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor, window: int) -> None:
    """Write this rank's part of k/v [B_l, S, Hkv_l, hd] at
    ``positions`` [B_l, S] into ``blk`` in place: every row where the
    block holds the whole sequence, else only the rows whose slot falls
    in the block."""
    s = positions.shape[1]
    pos_w, slot = _cache_slots(positions, blk.smax, window)
    k, v = k[:, s - pos_w.shape[1]:], v[:, s - pos_w.shape[1]:]
    _scatter_rows_(blk.pos, slot, pos_w)
    if not blk.seq_split:
        _scatter_rows_(blk.k, slot, k)
        _scatter_rows_(blk.v, slot, v)
        return
    local = slot.long() - blk.seq
    mine = (local >= 0) & (local < blk.k.shape[1])
    b_idx, s_idx = mine.nonzero(as_tuple=True)
    at = (b_idx, local[b_idx, s_idx])
    blk.k.index_put_(at, k[b_idx, s_idx].to(blk.k.dtype))
    blk.v.index_put_(at, v[b_idx, s_idx].to(blk.v.dtype))


def _attended(blk: CacheBlock, positions: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor):
    """(k, v, positions) a step attends over once it has written them:
    a decode step (one token) the cache's block, just updated; a prefill
    its own inputs (a ring cache only holds the trailing window, and
    every query still sees its own context here)."""
    if positions.shape[1] == 1:
        return blk.k, blk.v, blk.pos_block
    return k, v, positions


def combine_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor
                     ) -> torch.Tensor:
    """Softmax attention from the partial results of n key blocks,
    stacked on a leading dim in block order (m, l [n, ...], acc
    [n, ..., hd]): each block's sum and values rescaled to the largest
    row max and added in block order."""
    top = m.amax(dim=0)
    tot = torch.zeros_like(l[0])
    out = torch.zeros_like(acc[0])
    for r in range(m.shape[0]):
        w = exp_stable(m[r] - top)
        tot = tot + l[r] * w
        out = out + acc[r] * w[..., None]
    return out / torch.clamp(tot, min=1e-30)[..., None]


def _gather_model(x: torch.Tensor, ctx, batch) -> torch.Tensor:
    """Every model rank's ``x`` (this rank's rows [B_l, ...]) stacked on
    a new leading dim in model-rank order, on every rank."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    rows = Shard(1) if isinstance(batch, Shard) else Replicate()
    d = DTensor.from_local(x[None], ctx.mesh, ctx.placements(rows, Shard(0)),
                           run_check=False)
    return d.redistribute(ctx.mesh, ctx.placements(rows, Replicate())) \
        .to_local()


def _mesh_cached_attention(cfg: ModelConfig, q, k, v, positions, blk,
                           *, window: int, causal: bool, use_rope: bool,
                           attn_chunk: int):
    """Attention with a cache of DTensors q [B,S,H,hd], k/v [B,S,Hkv,hd]
    on each rank's slots: returns [B,S,H,hd] (heads over the model axis
    where the queries split). ``positions`` [B, S] is whole on every
    rank; ``blk`` is this layer's ``CacheBlock``.

    The batch takes the cache's split over the data axes. Where the cache
    splits its KV heads, q and k/v split theirs the same way; where it
    does not, k/v stay whole and each rank's query heads read the KV
    heads they need (``kv_heads_for``). RoPE and the cache write run on
    the local blocks. A prefill attends over its own inputs; a decode
    step over the cache: where the cache's sequence is split, with every
    query head, over this rank's block, then ``combine_partials`` over
    the model axis in rank order."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    ctx = pctx.for_mesh(mesh)
    m, r = ctx.model_size(), ctx.model_rank()
    H, Hkv, S = q.shape[2], k.shape[2], q.shape[1]
    batch = Shard(0) if blk.batch_split else Replicate()
    combine = blk.seq_split and S == 1
    q_split = m > 1 and H % m == 0 and not combine
    qp = ctx.placements(batch, Shard(2) if q_split else Replicate())
    kvp = ctx.placements(batch, Shard(2) if blk.kv_split else Replicate())
    q_l = local_of(q.redistribute(mesh, qp))
    k_l = local_of(k.redistribute(mesh, kvp))
    v_l = local_of(v.redistribute(mesh, kvp))
    pos_l = positions[blk.rows:blk.rows + q_l.shape[0]]
    if use_rope:
        q_l = rope_apply(q_l, pos_l, cfg.rope_theta)
        k_l = rope_apply(k_l, pos_l, cfg.rope_theta)
    _write_block_(blk, pos_l, k_l, v_l, window)
    att_k, att_v, att_pos = _attended(blk, pos_l, k_l, v_l)
    if q_split and not blk.kv_split:
        lo, hi, idx = kv_heads_for(H, Hkv, m, r)
        if idx is None:
            att_k, att_v = att_k[:, :, lo:hi], att_v[:, :, lo:hi]
        else:
            sel = torch.tensor(idx, device=att_k.device)
            att_k, att_v = att_k.index_select(2, sel), \
                att_v.index_select(2, sel)
    b_l, hd = q_l.shape[0], q_l.shape[-1]
    qg = q_l.reshape(b_l, S, att_k.shape[2], -1, hd)
    softcap = cfg.attn_logit_softcap
    if combine:
        pm, pl, pacc = partial_attention(qg, att_k, att_v, pos_l, att_pos,
                                         causal=causal, window=window,
                                         softcap=softcap)
        every = _gather_model(torch.cat([pm[..., None], pl[..., None], pacc],
                                        dim=-1), ctx, batch)
        out = combine_partials(every[..., 0], every[..., 1],
                               every[..., 2:]).to(q_l.dtype)
    else:
        out = _attend_positions(qg, att_k.contiguous(), att_v.contiguous(),
                                pos_l, att_pos, causal=causal,
                                window=window, softcap=softcap,
                                attn_chunk=attn_chunk)
    out = out.reshape(b_l, S, q_l.shape[2], hd)
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
