"""Mamba-2 blocks: the chunked SSD (state-space duality) scan — the port
of ``repro.models.ssm``.

Training and prefill use the chunked SSD algorithm (quadratic within a
``CHUNK``-token chunk, the state passed across chunks); decode is the
O(1) recurrent update. ``ssd_chunked`` is the autograd ``SSDScan`` of
``kernels/ssd_scan``: on a CUDA tensor the hand-written forward and
backward kernels, with no option; on a CPU tensor their plain versions,
a copy of the JAX function and autograd through it. Paths, shapes,
dtypes and the arithmetic of everything around the scan follow the JAX
module step for step. One deliberate difference: ``ssm_block_forward``
returns the new decode state and the caller writes it into its cache in
place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.host import torch_dtype
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import apply_norm, norm_template
from repro_torch.models.params import P

CHUNK = 256


def dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    return d_in, nh, cfg.ssm_state


def ssm_block_template(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    d_in, nh, ds = dims(cfg)
    hd = cfg.ssm_head_dim
    cw = cfg.ssm_conv_width
    return {
        "norm": norm_template(cfg),
        "w_z": P((d, nh, hd), ("embed", "heads", None), fan_in=d),
        "w_x": P((d, nh, hd), ("embed", "heads", None), fan_in=d),
        "w_B": P((d, ds), ("embed", None), fan_in=d),
        "w_C": P((d, ds), ("embed", None), fan_in=d),
        "w_dt": P((d, nh), ("embed", "heads"), fan_in=d),
        "conv_x": P((cw, nh, hd), (None, "heads", None), init="scaled",
                    fan_in=cw),
        "conv_B": P((cw, ds), (None, None), init="scaled", fan_in=cw),
        "conv_C": P((cw, ds), (None, None), init="scaled", fan_in=cw),
        "conv_bx": P((nh, hd), ("heads", None), init="zeros"),
        "conv_bB": P((ds,), (None,), init="zeros"),
        "conv_bC": P((ds,), (None,), init="zeros"),
        "A_log": P((nh,), ("heads",), init="ssm_a", dtype="float32"),
        "D": P((nh,), ("heads",), init="ones", dtype="float32"),
        "dt_bias": P((nh,), ("heads",), init="ssm_dt", dtype="float32"),
        "out_norm": P((nh, hd), ("heads", None), init="zeros",
                      dtype="float32"),
        "w_out": P((nh, hd, d), ("heads", None, "embed"), fan_in=d_in),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv via shifted adds. x: [B,S,...ch]; w:
    [cw,...ch]. Returns (y, new_state), the state being the trailing
    cw-1 inputs."""
    cw = w.shape[0]
    if state is None:
        pad = [0, 0] * (x.dim() - 2) + [cw - 1, 0]
        xp = F.pad(x, pad)
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * w[i] for i in range(cw))
    new_state = xp[:, xp.shape[1] - (cw - 1):]
    return F.silu(y + b), new_state


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int = CHUNK,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD. x [B,S,H,P], dt [B,S,H], A [H], Bm/Cm [B,S,N].
    Returns (y f32 [B,S,H,P], final_state f32 [B,H,P,N])."""
    return ssd_ops.ssd_chunked(x, dt, A, Bm, Cm, chunk, init_state)


def ssd_decode_step(x, dt, A, Bm, Cm, state):
    """One-token recurrence. x [B,1,H,P], dt [B,1,H], Bm/Cm [B,1,N],
    state [B,H,P,N] -> (y [B,1,H,P], new_state)."""
    f32 = torch.float32
    xf, dtf = x.to(f32)[:, 0], dt.to(f32)[:, 0]
    Bf, Cf = Bm.to(f32)[:, 0], Cm.to(f32)[:, 0]
    dec = torch.exp(dtf * A.to(f32))                        # [B,H]
    upd = torch.einsum("bhp,bn->bhpn", xf * dtf[..., None], Bf)
    s_new = state.to(f32) * dec[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", s_new, Cf)
    return y[:, None], s_new


def ssm_block_forward(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                      x: torch.Tensor,
                      cache: Optional[Dict[str, torch.Tensor]] = None):
    """Full Mamba-2 block (pre-norm; the caller adds the residual).
    x: [B,S,D]. Returns (out [B,S,D], new_cache or None)."""
    B, S, D = x.shape
    h = apply_norm(cfg, p["norm"], x)

    z = torch.einsum("bsd,dhp->bshp", h, p["w_z"])
    xs = torch.einsum("bsd,dhp->bshp", h, p["w_x"])
    Bm = torch.einsum("bsd,dn->bsn", h, p["w_B"])
    Cm = torch.einsum("bsd,dn->bsn", h, p["w_C"])
    dt_raw = torch.einsum("bsd,dh->bsh", h, p["w_dt"])

    cs = (lambda k: cache[k]) if cache is not None else (lambda k: None)
    xs, ns_x = _causal_conv(xs, p["conv_x"], p["conv_bx"], cs("conv_x"))
    Bm, ns_B = _causal_conv(Bm, p["conv_B"], p["conv_bB"], cs("conv_B"))
    Cm, ns_C = _causal_conv(Cm, p["conv_C"], p["conv_bC"], cs("conv_C"))

    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    if cache is not None and S == 1:
        y, s_new = ssd_decode_step(xs, dt, A, Bm, Cm, cache["state"])
    else:
        chunk = CHUNK if S % CHUNK == 0 else S
        y, s_new = ssd_chunked(xs, dt, A, Bm, Cm, chunk=chunk,
                               init_state=cs("state"))

    y = y + xs.to(torch.float32) * p["D"][:, None]
    # gated RMSNorm (per-head scale), then the output projection
    y = y * F.silu(z.to(torch.float32))
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + cfg.norm_eps) * (1.0 + p["out_norm"])
    out = torch.einsum("bshp,hpd->bsd", y.to(x.dtype), p["w_out"])

    new_cache = None
    if cache is not None:
        new_cache = {"conv_x": ns_x, "conv_B": ns_B, "conv_C": ns_C,
                     "state": s_new}
    return out, new_cache


def ssm_cache_spec(cfg: ModelConfig, batch: int):
    """(shape, dtype) of one SSM block's decode state."""
    d_in, nh, ds = dims(cfg)
    hd = cfg.ssm_head_dim
    cw = cfg.ssm_conv_width
    dt = torch_dtype(cfg.dtype)
    return {
        "conv_x": ((batch, cw - 1, nh, hd), dt),
        "conv_B": ((batch, cw - 1, ds), dt),
        "conv_C": ((batch, cw - 1, ds), dt),
        "state": ((batch, nh, hd, ds), torch.float32),
    }
