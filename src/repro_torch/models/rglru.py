"""RG-LRU recurrent block (RecurrentGemma / Griffin).

PyTorch counterpart of ``repro.models.rglru``:

    r_t = sigmoid(x_t @ Wa)                    (recurrence gate)
    i_t = sigmoid(x_t @ Wx)                    (input gate)
    a_t = exp(-c * softplus(lam) * r_t)        (data-dependent diagonal decay)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the diagonal recurrence over the whole prompt: with
``cfg.use_pallas`` through kernel B6 (``kernels.rglru_scan``), otherwise
through the reference's plain route :func:`rglru_chunked` (an associative
scan in chunks of ``cfg.rglru_chunk``).  Decode takes one step inline, as
the reference does.  The state (h and the conv window) is written in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.rglru_scan import rglru_scan as rglru_kernel
from .layers import constrain, gelu
from .param import ParamSpec

C_CONST = 8.0


def rglru_specs(cfg: ModelConfig) -> dict:
    D, R, W = cfg.d_model, cfg.rnn_width, cfg.conv_width
    return {
        "w_in": ParamSpec((D, R), ("embed", "rnn")),
        "w_gate_branch": ParamSpec((D, R), ("embed", "rnn")),
        "conv_w": ParamSpec((W, R), (None, "rnn")),
        "conv_b": ParamSpec((R,), ("rnn",), init="zeros"),
        "wa": ParamSpec((R, R), ("rnn", None)),
        "ba": ParamSpec((R,), ("rnn",), init="zeros"),
        "wx": ParamSpec((R, R), ("rnn", None)),
        "bx": ParamSpec((R,), ("rnn",), init="zeros"),
        "lam": ParamSpec((R,), ("rnn",), dtype=torch.float32, init="ones"),
        "w_out": ParamSpec((R, D), ("rnn", "embed")),
    }


def init_rglru_state(cfg: ModelConfig, batch: int, device=None):
    R, W = cfg.rnn_width, cfg.conv_width
    return {
        "h": torch.zeros((batch, R), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, W - 1, R), dtype=torch.bfloat16,
                            device=device),
    }


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _gates(p, u, u32=None):
    """u: (..., R) post-conv activations -> (log_a, gated input).

    ``u32`` is the float32 value that the gated input scales (``u`` when
    ``None``).  Jitted XLA fuses a bf16 add into the float32 upcast that
    follows it, so an upcast sum is its unrounded float32 value: the bias
    adds here, and the conv's bias add in :func:`apply_rglru`.
    """
    r = torch.sigmoid((u @ p["wa"]).float() + p["ba"].float())
    i = torch.sigmoid((u @ p["wx"]).float() + p["bx"].float())
    log_a = -C_CONST * _softplus(p["lam"]) * r                  # (..., R) < 0
    # the float64 root rounded once: PyTorch's CPU float32 sqrt is not
    # correctly rounded (XLA's and CUDA's are)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                  min=1e-12).double()).float()
    x_in = beta * i * (u.float() if u32 is None else u32)
    return log_a, x_in


def _combine(c1, c2):
    la1, y1 = c1
    la2, y2 = c2
    return la1 + la2, torch.exp(la2) * y1 + y2


def _associative_scan(elems):
    """``jax.lax.associative_scan`` of :func:`_combine` along axis 1, in its
    order: combine adjacent pairs, scan the halves recursively, then fill
    in the even positions."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:-1:2] for e in elems], [e[:, 1::2] for e in elems])
    odd = _associative_scan(reduced)
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    out = []
    for ev, od in zip(even, odd):
        # interleave: even positions from ``ev``, odd ones from ``od`` (out
        # of place, so that a DTensor program propagates it)
        m = od.shape[1]
        merged = torch.stack([ev[:, :m], od], dim=2).flatten(1, 2)
        if n % 2:
            merged = torch.cat([merged, ev[:, m:]], dim=1)
        out.append(merged)
    return out


def rglru_scan(log_a, x_in, h0):
    """Diagonal linear recurrence h_t = a_t h_{t-1} + x_t via associative scan.

    log_a/x_in: (B, S, R) fp32; h0: (B, R) fp32.
    """
    # Fold h0 into the first element: h_1 = a_1 h_0 + x_1.
    x_in = x_in.clone()
    x_in[:, 0] = x_in[:, 0] + torch.exp(log_a[:, 0]) * h0
    _, h = _associative_scan([log_a, x_in])
    return h


def rglru_chunked(log_a, x_in, h0, chunk: int):
    """Chunked recurrence: an inner log-depth scan, an outer sequential carry
    (the reference's plain route)."""
    B, S, R = x_in.shape
    if S <= chunk:
        hs = rglru_scan(log_a, x_in, h0)
        return hs, hs[:, -1]
    n = -(-S // chunk)
    pad = n * chunk - S
    if pad:
        log_a = F.pad(log_a, (0, 0, 0, pad))
        x_in = F.pad(x_in, (0, 0, 0, pad))
    h = h0
    outs = []
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        hs = rglru_scan(log_a[:, sl], x_in[:, sl], h)
        h = hs[:, -1]
        outs.append(hs)
    return torch.cat(outs, dim=1)[:, :S], h


def apply_rglru(cfg: ModelConfig, p: dict, x: torch.Tensor,
                state: dict | None = None, *, decode: bool = False):
    """Griffin recurrent block body: conv1d -> RG-LRU -> gate -> out-proj.

    With a ``state`` dict (the layer's cache) the new h and conv window are
    written into it in place and the same dict is returned; without one, a
    new dict.
    """
    B, S, D = x.shape
    W = cfg.conv_width
    gate = gelu(x @ p["w_gate_branch"])
    u = x @ p["w_in"]                                           # (B, S, R)
    gate = constrain(gate, cfg, ("dp", None, "model"))
    u = constrain(u, cfg, ("dp", None, "model"))

    R = u.shape[-1]
    prev = state["conv"] if state is not None else torch.zeros(
        (B, W - 1, R), dtype=u.dtype, device=x.device)
    seq = torch.cat([prev.to(u.dtype), u], dim=1)               # (B, S+W-1, R)
    # depthwise causal conv, width W
    taps = seq[:, 0:S] * p["conv_w"][0]
    for i in range(1, W):
        taps = taps + seq[:, i:i + S] * p["conv_w"][i]
    conv = taps + p["conv_b"]

    log_a, x_in = _gates(p, conv, taps.float() + p["conv_b"].float())
    log_a = constrain(log_a, cfg, ("dp", None, "model"))
    x_in = constrain(x_in, cfg, ("dp", None, "model"))
    h0 = state["h"] if state is not None else torch.zeros(
        (B, R), dtype=torch.float32, device=x.device)
    if decode:
        h = torch.exp(log_a[:, 0]) * h0 + x_in[:, 0]
        hs = h[:, None]
        h_last = h
    elif cfg.use_pallas:
        hs, h_last = rglru_kernel(log_a.contiguous(), x_in.contiguous(),
                                  h0.contiguous())
    else:
        hs, h_last = rglru_chunked(log_a, x_in, h0, cfg.rglru_chunk)
    hs = constrain(hs, cfg, ("dp", None, "model"))

    y = (hs.to(x.dtype) * gate) @ p["w_out"]
    window = seq[:, -(W - 1):].to(torch.bfloat16)
    if state is None:
        return y, {"h": h_last, "conv": window}
    state["h"].copy_(h_last)
    state["conv"].copy_(window)
    return y, state
