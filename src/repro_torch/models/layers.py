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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..parallel.collectives import psum, psum_scatter
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


def gather_sequence(x: torch.Tensor, cfg) -> torch.Tensor:
    """A block's normed input with its sequence whole: Megatron-SP's
    all-gather before the column-parallel projections, the batch split
    over the data axes (a projection flattens batch and sequence, which a
    DTensor sharded on both cannot do).  The identity off a mesh."""
    return constrain(x, cfg, ("dp", None, None))


def _model_shard(t: DTensor, dim: int) -> int | None:
    """The mesh dim over which "model" splits ``t``'s ``dim``, if any."""
    names = axis_names(t.device_mesh)
    for i, pl in enumerate(t.placements):
        if pl == Shard(dim) and names[i] == "model":
            return i
    return None


def _vocab_parallel(local, table, idx, vdim: int, idx_pl: tuple):
    """``local(table_shard, idx, start)`` on each rank's "model" shard of
    ``table``'s vocabulary dim ``vdim`` (``start``: the shard's first
    id), its masked result summed over "model" (Megatron's vocab-parallel
    lookup; DTensor's own masked partials fail in some releases).
    ``idx`` is taken with placements ``idx_pl`` and the result keeps its
    batch shards; ``table``'s gradient is its shard, a partial sum over
    the mesh dims that split ``idx`` but not ``table``."""
    mesh, i = table.device_mesh, _model_shard(table, vdim)
    out_pl = tuple(pl if pl == Shard(0) else Replicate() for pl in idx_pl)
    grad_pl = tuple(Partial() if pl == Shard(0) and tp != Shard(0) else tp
                    for tp, pl in zip(table.placements, idx_pl))
    group = mesh.get_group(i)

    if not isinstance(idx, DTensor):      # the same ids on every rank
        idx = DTensor.from_local(idx, mesh, (Replicate(),) * mesh.ndim,
                                 run_check=False)

    def run(t, ids):
        start = mesh.get_local_rank(i) * t.shape[vdim]
        return psum(local(t, ids, start), [group])

    return local_map(run, out_placements=(out_pl,),
                     in_placements=(table.placements, idx_pl),
                     in_grad_placements=(grad_pl, idx_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, idx)


def embed_tokens(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``emb``'s rows at ``tokens``.  On a DTensor table whose vocabulary
    "model" splits, each rank looks up the ids it holds and the rows are
    summed over "model" (exact: one rank holds each id)."""
    if not isinstance(emb, DTensor) or _model_shard(emb, 0) is None:
        return torch.nn.functional.embedding(tokens, emb)

    def local(t, ids, start):
        ids = ids - start
        hit = (ids >= 0) & (ids < t.shape[0])
        rows = torch.nn.functional.embedding(torch.where(hit, ids, 0), t)
        return rows * hit[..., None].to(rows.dtype)

    whole = (Replicate(),) * emb.device_mesh.ndim
    return _vocab_parallel(local, emb, tokens, 0, tokens.placements
                           if isinstance(tokens, DTensor) else whole)


def take_along_vocab(logits: torch.Tensor, labels: torch.Tensor):
    """``logits.gather(-1, labels[..., None])`` (the trailing dim kept);
    on DTensor logits whose vocabulary "model" splits, vocab-parallel as
    :func:`embed_tokens`."""
    if not isinstance(logits, DTensor) or \
            _model_shard(logits, logits.dim() - 1) is None:
        return logits.gather(-1, labels.long()[..., None])

    def local(t, ids, start):
        ids = ids.long()[..., None] - start
        hit = (ids >= 0) & (ids < t.shape[-1])
        picked = t.gather(-1, torch.where(hit, ids, 0))
        return picked * hit.to(picked.dtype)

    # the labels follow the logits' batch shards
    return _vocab_parallel(local, logits, labels, logits.dim() - 1, tuple(
        pl if pl == Shard(0) else Replicate() for pl in logits.placements))


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
