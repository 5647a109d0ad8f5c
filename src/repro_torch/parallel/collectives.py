"""Collectives over one mesh dim's process group, with the gradients that
``shard_map``'s transposes give in the reference.

They run on the tensors' own device (whatever the group's backend does
with it), and nothing here copies a tensor to the host.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Shard


class _Psum(torch.autograd.Function):
    """Sum over each group of ``groups`` in turn; the result is replicated
    over them, so its cotangent (the same on every rank) passes back
    unchanged, times ``grad_scale``: ``psum``'s transpose inside
    ``shard_map``."""

    @staticmethod
    def forward(ctx, x, groups, grad_scale):
        ctx.grad_scale = grad_scale
        out = x.clone()
        for group in groups:
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.grad_scale == 1 else g * ctx.grad_scale), None, None


def psum(x: torch.Tensor, groups, *, grad_scale: float = 1.0) -> torch.Tensor:
    """``jax.lax.psum`` over the product of ``groups`` (process groups of
    distinct mesh dims).  ``grad_scale`` scales the cotangent passed back:
    ``1 / n`` spreads a value that the n ranks of another mesh dim computed
    alike over them, where their gradients are summed."""
    return _Psum.apply(x, tuple(groups), grad_scale)


def _scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over ``group`` of every rank's ``t``, this rank keeping its
    block of ``dim`` (a reduce-scatter along dim 0 of ``t`` moved)."""
    n = dist.get_world_size(group)
    t = t.movedim(dim, 0).contiguous()
    out = torch.empty((t.shape[0] // n, *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.reduce_scatter_tensor(out, t, group=group)
    return out.movedim(0, dim)


def _gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` joined along ``dim``."""
    n = dist.get_world_size(group)
    t = t.movedim(dim, 0).contiguous()
    out = torch.empty((t.shape[0] * n, *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)
    return out.movedim(0, dim)


class _PsumScatter(torch.autograd.Function):
    """Sum over ``group``, each rank keeping its block of ``dim``; the
    backward all-gathers the cotangent."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


def psum_scatter(x: torch.Tensor, group, *, dim: int) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``:
    ``x``'s ``dim`` must divide by the group's size."""
    if x.shape[dim] % dist.get_world_size(group):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"over {dist.get_world_size(group)} ranks")
    return _PsumScatter.apply(x, group, dim)


# ---------------------------------------------------------------------------
# whole trees of shards (no autograd)
# ---------------------------------------------------------------------------

def mesh_groups(mesh) -> list:
    """(mesh dim, its size, its group) for each mesh dim of more than one
    rank."""
    return [(i, n, mesh.get_group(i)) for i, n in enumerate(mesh.shape)
            if n > 1]


def reduce_shards(g: torch.Tensor, placements, mesh, batch_dims) -> torch.Tensor:
    """This rank's shard (``placements``) of the sum over the batch's mesh
    dims of every rank's ``g``: reduce-scattered where the shard splits a
    dim over such a mesh dim, all-reduced where it does not; sliced with no
    collective over a mesh dim the batch is replicated on."""
    for i, n, group in mesh_groups(mesh):
        pl = placements[i]
        if i in batch_dims and isinstance(pl, Shard):
            g = _scatter(g, group, pl.dim)
        elif i in batch_dims:
            g = g.contiguous()
            dist.all_reduce(g, group=group)
        elif isinstance(pl, Shard):
            g = g.chunk(n, pl.dim)[mesh.get_coordinate()[i]]
    return g


def gather_shards(t: torch.Tensor, placements, mesh) -> torch.Tensor:
    """The whole tensor from this rank's shard: all-gathered over each mesh
    dim the shard splits, minor dims first."""
    for i, _, group in reversed(mesh_groups(mesh)):
        if isinstance(placements[i], Shard):
            t = _gather(t, group, placements[i].dim)
    return t


def full_tensor(t: DTensor) -> torch.Tensor:
    """``t.full_tensor()`` through :func:`gather_shards`' plain all-gathers
    (DTensor's own gather goes through the functional collectives, which
    crash gloo ranks on CUDA tensors)."""
    if any(isinstance(pl, Partial) for pl in t.placements):
        raise ValueError(f"{t.placements}: reduce a Partial DTensor first")
    return gather_shards(t.to_local(), t.placements, t.device_mesh)
