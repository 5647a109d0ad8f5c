"""Shared neural building blocks (pure-functional, bf16-first).

PyTorch counterpart of ``repro.models.layers``.  On one card there is no
mesh: :func:`constrain` is the identity and :func:`tp_project_rs` the plain
einsum, which is what the reference computes off-mesh.  Their mesh paths
come with the mesh item (ROADMAP A.9c).
"""
from __future__ import annotations

import math

import torch

from .param import ParamSpec


def constrain(x: torch.Tensor, cfg, template: tuple) -> torch.Tensor:
    """Activation sharding constraint: the identity on one device."""
    if cfg.mesh is not None:
        raise NotImplementedError("activation sharding over a mesh is not "
                                  "ported yet (ROADMAP A.9c)")
    return x


def rmsnorm_spec(dim: int) -> ParamSpec:
    return ParamSpec((dim,), ("embed",), dtype=torch.float32, init="ones")


def tp_project_rs(h: torch.Tensor, w: torch.Tensor, cfg, *,
                  contract_model_dims: int) -> torch.Tensor:
    """TP output projection; off-mesh, the plain einsum of the reference."""
    ein = "bshk,hkd->bsd" if contract_model_dims == 2 else "bsf,fd->bsd"
    return constrain(torch.einsum(ein, h, w), cfg, ("dp", "sp", None))


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6,
            dtype: torch.dtype | None = None) -> torch.Tensor:
    """RMS norm in float32, cast to ``dtype`` (``x``'s when ``None``)."""
    dtype = x.dtype if dtype is None else dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale).to(dtype)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for ``positions`` (any leading shape), half-dim layout.

    The reference computes ``1 / theta ** (i / half)`` and the tables in
    float32 under XLA, which folds the reciprocal into ``theta ** -(i /
    half)`` and whose float32 cos and sin sit closer to the correctly
    rounded values than PyTorch's.  So the frequencies take the negated
    exponent, and the tables are the float64 cos and sin of the float32
    angles, rounded once to float32.
    """
    dev = positions.device
    half = head_dim // 2
    # scalars made on the device (a fill, not a host-to-device copy)
    scalar = lambda v: torch.full((), v, dtype=torch.float32, device=dev)  # noqa: E731
    exps = torch.arange(half, dtype=torch.float32, device=dev) / scalar(half)
    freqs = torch.pow(scalar(theta), -exps)
    ang = (positions.float()[..., None] * freqs).double()   # (..., half)
    return torch.cos(ang).float(), torch.sin(ang).float()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, Dh); cos/sin: (..., S, half) broadcast over heads.
    The tables are cast to the activation dtype first, as in the reference."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference evaluates it: ``x * sigmoid(x)`` with
    sigmoid as ``1 / (1 + exp(-x))``, every op rounded to ``x``'s dtype.
    (XLA expands the logistic into these four ops and rounds a bf16 graph
    after each; ``F.silu`` rounds once, and often lands on another bf16
    value.)"""
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default tanh form) as the reference evaluates
    it: ``x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3)))`` with the
    constants rounded to ``x``'s dtype and every op rounded to it (jitted
    XLA rounds a bf16 graph after each op, as for :func:`silu`)."""
    const = lambda v: torch.full((), v, dtype=torch.float32,  # noqa: E731
                                 device=x.device).to(x.dtype)
    inner = const(math.sqrt(2.0 / math.pi)) * (x + const(0.044715) * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def swiglu_hidden(h: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """silu(h @ w1) * (h @ w3) in the activation dtype (the reference's
    dense FFN and shared experts)."""
    return silu(h @ w1) * (h @ w3)


def mlp_specs(d_model: int, d_ff: int, prefix_axes=()) -> dict:
    """Gated MLP parameter structure (w1/w3 sharded on ffn, w2 on ffn-in)."""
    return {
        "w1": ParamSpec((d_model, d_ff), ("embed", "ffn")),
        "w3": ParamSpec((d_model, d_ff), ("embed", "ffn")),
        "w2": ParamSpec((d_ff, d_model), ("ffn", "embed")),
    }
