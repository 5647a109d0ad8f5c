"""Shared neural building blocks (pure-functional, bf16-first).

PyTorch counterpart of ``repro.models.layers``.  Off a mesh (or on a
mesh of one rank) :func:`constrain` is the identity and
:func:`tp_project_rs` the plain einsum, as in the reference.  On a larger
mesh (``cfg.mesh``, a ``DeviceMesh``) :func:`constrain` redistributes a
DTensor and :func:`tp_project_rs` may take the explicit reduce-scatter.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial
from torch.distributed.tensor.experimental import local_map

from ..parallel.collectives import psum_scatter
from ..parallel.sharding import (NamedSharding, P, axis_names, dp_axes,
                                 mesh_shape, placements, redistribute)
from .param import ParamSpec


def constrain_spec(shape: tuple, cfg, template: tuple) -> P:
    """The spec :func:`constrain` gives a tensor of ``shape`` on
    ``cfg.mesh``: "dp" over the data-parallel axes, "model" over the
    tensor-parallel axis, "sp" over "model" only when ``cfg.sp``; a dim
    that does not divide stays replicated."""
    mesh = cfg.mesh
    sizes = mesh_shape(mesh)
    dp = dp_axes(mesh)
    if getattr(cfg, "dp_only", False) and "model" in sizes:
        dp = dp + ("model",)           # pure-DP scheme: model axis joins DP
    dp_sz = int(np.prod([sizes[a] for a in dp])) if dp else 1
    used_model = False
    parts = []
    for dim, t in zip(shape, template):
        if t == "dp" and dp and dim % dp_sz == 0:
            parts.append(dp)
        elif t in ("model", "sp") and not used_model \
                and (t == "model" or cfg.sp) \
                and not getattr(cfg, "dp_only", False) \
                and "model" in sizes and dim % sizes["model"] == 0:
            parts.append("model")
            used_model = True
        else:
            parts.append(None)
    return P(*parts)


def constrain(x: torch.Tensor, cfg, template: tuple) -> torch.Tensor:
    """Activation sharding constraint from a template of {"dp", "model",
    "sp", None} (:func:`constrain_spec`): ``x``, a DTensor, redistributed
    to it.  The identity off a mesh or on a mesh of one rank; a plain
    tensor on a larger mesh raises ``TypeError``."""
    mesh = cfg.mesh
    if mesh is None or mesh.size() == 1:
        return x
    return redistribute(x, NamedSharding(mesh, constrain_spec(
        tuple(x.shape), cfg, template)))


def rmsnorm_spec(dim: int) -> ParamSpec:
    return ParamSpec((dim,), ("embed",), dtype=torch.float32, init="ones")


def tp_project_rs(h: torch.Tensor, w: torch.Tensor, cfg, *,
                  contract_model_dims: int) -> torch.Tensor:
    """TP output projection with an explicit reduce-scatter (Megatron g-op).

    ``h``: activations whose model-sharded dims are contracted by ``w``
    (heads x head_dim, or the ffn hidden).  With ``cfg.tp_impl ==
    "shardmap"`` and ``cfg.sp`` on a mesh whose "model" axis divides the
    sequence and the contracted dim, each rank computes its local partial
    einsum and the partials are reduce-scattered over the sequence dim
    (``local_map``), leaving the output in the sequence-parallel layout.
    Otherwise (no mesh, decode S = 1, replicated heads, the knob off) the
    plain einsum and :func:`constrain`.
    """
    mesh = cfg.mesh
    if contract_model_dims == 2:
        ein = "bshk,hkd->bsd"
        h_spec_dims = ("model", None)         # h: (B, S, H, Dh), H sharded
        w_spec = P("model", None, None)
    else:
        ein = "bsf,fd->bsd"
        h_spec_dims = ("model",)              # h: (B, S, F), F sharded
        w_spec = P("model", None)

    def plain_path():
        return constrain(torch.einsum(ein, h, w), cfg, ("dp", "sp", None))

    if mesh is None or "model" not in axis_names(mesh) \
            or mesh_shape(mesh)["model"] == 1 or not cfg.sp \
            or getattr(cfg, "tp_impl", "gspmd") != "shardmap":
        return plain_path()
    sizes = mesh_shape(mesh)
    tp = sizes["model"]
    S = h.shape[1]
    shard_dim_size = h.shape[2]
    if S % tp != 0 or shard_dim_size % tp != 0:
        return plain_path()
    for name, t in (("h", h), ("w", w)):
        if not isinstance(t, DTensor):
            raise TypeError(f"tp_project_rs: {name} is a "
                            f"{type(t).__name__} on a mesh; pass DTensors")
    dp = dp_axes(mesh)
    B = h.shape[0]
    dp_sz = int(np.prod([sizes[a] for a in dp])) if dp else 1
    bdim = dp if (dp and B % dp_sz == 0) else None

    h_spec = P(bdim, None, *h_spec_dims)
    out_spec = P(bdim, "model", None)
    group = mesh.get_group("model")
    # w's gradient sums over the data shards where h is sharded over them
    w_grad = tuple(Partial() if bdim and name in dp else pl for name, pl in
                   zip(axis_names(mesh), placements(w_spec, mesh)))

    def local(hl, wl):
        y = torch.einsum(ein, hl, wl)         # local partial sum
        return psum_scatter(y, group, dim=1)

    return local_map(local, out_placements=(placements(out_spec, mesh),),
                     in_placements=(placements(h_spec, mesh),
                                    placements(w_spec, mesh)),
                     in_grad_placements=(placements(h_spec, mesh), w_grad),
                     device_mesh=mesh, redistribute_inputs=True)(h, w)


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
