"""RWKV6 "Finch" time-mixing: linear attention with data-dependent decay.

PyTorch counterpart of ``repro.models.rwkv6``.  Per head, per step t:

    a_t   = k_t (x) v_t                      (Dk, Dv)
    out_t = r_t @ (S_{t-1} + diag(u) a_t)   (Dv,)
    S_t   = diag(w_t) S_{t-1} + a_t

with ``w_t = exp(-exp(w0 + lora(x_t)))``, the data-dependent decay.
Prefill runs the chunked scan: with ``cfg.use_pallas`` through kernel B5
(``kernels.rwkv6_scan``, chunks of 32), otherwise through the reference's
plain route :func:`wkv_chunked` at ``cfg.wkv_chunk``.  Decode takes one
:func:`wkv_step`, as in the reference.  The state dict is written in place
and returned.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..kernels.rwkv6_scan import rwkv6_scan, wkv_chunked
from .layers import constrain, silu
from .param import ParamSpec

LORA_RANK = 64


def rwkv_specs(cfg: ModelConfig) -> dict:
    D, H, Dh = cfg.d_model, cfg.padded_heads, cfg.head_dim
    return {
        "mu_r": ParamSpec((D,), ("embed",), init="zeros"),
        "mu_k": ParamSpec((D,), ("embed",), init="zeros"),
        "mu_v": ParamSpec((D,), ("embed",), init="zeros"),
        "mu_w": ParamSpec((D,), ("embed",), init="zeros"),
        "mu_g": ParamSpec((D,), ("embed",), init="zeros"),
        "wr": ParamSpec((D, H, Dh), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((D, H, Dh), ("embed", "heads", "head_dim")),
        "wv": ParamSpec((D, H, Dh), ("embed", "heads", "head_dim")),
        "wg": ParamSpec((D, H, Dh), ("embed", "heads", "head_dim")),
        "w0": ParamSpec((H, Dh), ("heads", "head_dim"), dtype=torch.float32,
                        init="zeros"),
        "w_lora_a": ParamSpec((D, LORA_RANK), ("embed", None)),
        "w_lora_b": ParamSpec((LORA_RANK, H, Dh), (None, "heads", "head_dim")),
        "u": ParamSpec((H, Dh), ("heads", "head_dim"), dtype=torch.float32,
                       init="zeros"),
        "ln_x": ParamSpec((H, Dh), ("heads", "head_dim"), dtype=torch.float32,
                          init="ones"),
        "wo": ParamSpec((H, Dh, D), ("heads", "head_dim", "embed"),
                        fan_in_axes=(0, 1)),
    }


def init_rwkv_state(cfg: ModelConfig, batch: int, device=None):
    H, Dh = cfg.padded_heads, cfg.head_dim
    return {
        "s": torch.zeros((batch, H, Dh, Dh), dtype=torch.float32,
                         device=device),                       # wkv state
        "x_prev": torch.zeros((batch, cfg.d_model), dtype=torch.bfloat16,
                              device=device),
    }


def _projections(cfg, p, x, x_prev):
    """Token-shift lerps + r/k/v/g/w projections.  x: (B, S, D)."""
    shifted = torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)

    def mix(mu):
        return x + (shifted - x) * mu.to(x.dtype)

    r = torch.einsum("bsd,dhk->bshk", mix(p["mu_r"]), p["wr"])
    k = torch.einsum("bsd,dhk->bshk", mix(p["mu_k"]), p["wk"])
    v = torch.einsum("bsd,dhk->bshk", mix(p["mu_v"]), p["wv"])
    g = torch.einsum("bsd,dhk->bshk", mix(p["mu_g"]), p["wg"])
    lora = torch.tanh(mix(p["mu_w"]) @ p["w_lora_a"])
    w_log = p["w0"] + torch.einsum("bsr,rhk->bshk", lora, p["w_lora_b"]).float()
    log_decay = -torch.exp(torch.clamp(w_log, -8.0, 4.0))     # in (-inf, 0)
    log_decay = torch.clamp(log_decay, min=-8.0)               # numerics floor
    return r, k, v, g, log_decay


def wkv_step(r, k, v, log_w, u, s):
    """Single decode step.  r/k/v/log_w: (B, H, Dh); s: (B, H, Dk, Dv)."""
    r32, k32, v32 = r.float(), k.float(), v.float()
    a = k32[..., :, None] * v32[..., None, :]                   # (B,H,Dk,Dv)
    out = torch.einsum("bhk,bhkv->bhv", r32, s + u[..., None] * a)
    s_new = torch.exp(log_w)[..., None] * s + a
    return out, s_new


def apply_rwkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
               state: dict | None = None, *, decode: bool = False):
    """Time-mixing block body.  Returns (y, state).

    With a ``state`` dict (the layer's cache) the new wkv state and token
    shift are written into it in place and the same dict is returned;
    without one, a new dict.
    """
    B, S, D = x.shape
    H, Dh = cfg.padded_heads, cfg.head_dim
    x_prev = state["x_prev"] if state is not None else torch.zeros(
        (B, D), dtype=x.dtype, device=x.device)
    r, k, v, g, log_w = _projections(cfg, p, x, x_prev)
    tpl = ("dp", None, "model", None)
    r, k, v, g = (constrain(a, cfg, tpl) for a in (r, k, v, g))
    log_w = constrain(log_w, cfg, tpl)
    u = p["u"]
    s0 = state["s"] if state is not None else torch.zeros(
        (B, H, Dh, Dh), dtype=torch.float32, device=x.device)

    if decode:
        out, s_new = wkv_step(r[:, 0], k[:, 0], v[:, 0], log_w[:, 0], u, s0)
        out = out[:, None]
    elif cfg.use_pallas:
        out, s_new = rwkv6_scan(*(a.contiguous() for a in (r, k, v, log_w)),
                                u.contiguous(), s0.contiguous())
    else:
        out, s_new = wkv_chunked(r, k, v, log_w, u, s0, cfg.wkv_chunk)

    # per-head group norm, then output gate + projection
    out = out.reshape(B, S, H, Dh).float()
    var = (out * out).mean(-1, keepdim=True)
    out = out * torch.rsqrt(var + cfg.rms_eps) * p["ln_x"]
    out = out.to(x.dtype) * silu(g)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    x_last = x[:, -1, :].to(torch.bfloat16)
    if state is None:
        return y, {"s": s_new, "x_prev": x_last}
    state["s"].copy_(s_new)
    state["x_prev"].copy_(x_last)
    return y, state
