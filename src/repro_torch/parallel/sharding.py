"""Sharding rules: logical axes -> mesh PartitionSpecs -> DTensor placements.

PyTorch counterpart of ``repro.parallel.sharding``.  The rules read line
for line as the reference's; only the types differ (see
``repro_torch.parallel``'s docstring for the port's mesh model).

Parallelism map (single-pod mesh (16,16)=("data","model"); multi-pod adds a
leading "pod" axis folded into data-parallelism):

- DP  : batch over ("pod","data")
- TP  : "heads"/"kv_heads"/"ffn"/"vocab"/"lora"/"rnn" over "model"
- EP  : "experts" over "model" (MoE archs)
- SP  : sequence dim of boundary activations over "model" (optional knob)
- ZeRO-1: optimizer state additionally sharded over "data" on the first
  replicated-and-divisible dim of each parameter

Divisibility-aware fallback: a dim is sharded only when evenly divisible by
the axis size (e.g. qwen2-0.5b's 14 heads stay replicated while its
d_ff=4864 shards 16-way).  Each mesh axis is used at most once per spec.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from .._tree import tree_flatten, tree_map


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry a tensor dim (trailing dims
    may be left out), each ``None`` (replicated), a mesh axis name, or a
    tuple of names (sharded over their product, the first name major).
    Entries are canonical as in JAX: a one-name tuple is the name, an
    empty one ``None``."""

    def __new__(cls, *parts):
        def canon(p):
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                return None if not p else p[0] if len(p) == 1 else p
            return p
        return super().__new__(cls, (canon(p) for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def axis_names(mesh: DeviceMesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def mesh_shape(mesh: DeviceMesh) -> dict[str, int]:
    """The reference's ``mesh.shape``: axis name -> size."""
    return dict(zip(axis_names(mesh), mesh.shape))


def placements(spec: PartitionSpec, mesh: DeviceMesh) -> tuple:
    """DTensor placements of ``spec``: ``Shard(i)`` on each mesh dim that
    tensor dim ``i`` names, ``Replicate()`` on the others.  A dim over
    several axes is split by them major to minor, which DTensor does in
    mesh-dim order: such a tuple must follow the mesh's order."""
    names = axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for dim, part in enumerate(spec):
        if part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} of dim {dim} are not in "
                             f"the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]} used twice")
            out[i] = Shard(dim)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding``: a spec on a mesh, the leaf type of
    every ``*_shardings`` tree (``ckpt.restore`` tells a leaf by its
    ``mesh``)."""
    mesh: DeviceMesh
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def redistribute(x, sharding: NamedSharding):
    """``jax.lax.with_sharding_constraint`` on a DTensor.  A plain tensor
    raises ``TypeError`` on a mesh of more than one rank: a mesh program's
    activations are DTensors, and a local tensor is never sharded by
    guessing what it holds."""
    if not isinstance(x, DTensor):
        raise TypeError(f"a {type(x).__name__} on a mesh of "
                        f"{sharding.mesh.size()} ranks: shard it into a "
                        "DTensor (distribute_tensor) first")
    return x.redistribute(sharding.mesh, sharding.placements)


LOGICAL_RULES: dict[str | None, str | None] = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "experts": "model",
    "lora": "model",
    "rnn": "model",
    "embed": None,
    "head_dim": None,
    "layers": None,
    None: None,
}


def _axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def dp_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def dp_size(mesh: DeviceMesh) -> int:
    shape = mesh_shape(mesh)
    return int(np.prod([shape[a] for a in dp_axes(mesh)]))


def param_pspec(axes: tuple, shape: tuple, mesh: DeviceMesh, *,
                dp_only: bool = False) -> PartitionSpec:
    if dp_only:
        return P(*([None] * len(shape)))   # pure-DP: weights replicated
    sizes = mesh_shape(mesh)
    spec, used = [], set()
    for logical, dim in zip(axes, shape):
        mesh_axis = LOGICAL_RULES.get(logical)
        if (mesh_axis and mesh_axis in sizes and mesh_axis not in used
                and dim % sizes[mesh_axis] == 0):
            spec.append(mesh_axis)
            used.add(mesh_axis)
        else:
            spec.append(None)
    return P(*spec)


def opt_pspec(axes: tuple, shape: tuple, mesh: DeviceMesh, *,
              zero1: bool = True, dp_only: bool = False) -> PartitionSpec:
    """Optimizer-state spec: param spec + ZeRO-1 'data' sharding."""
    base = list(param_pspec(axes, shape, mesh, dp_only=dp_only))
    sizes = mesh_shape(mesh)
    if zero1 and "data" in sizes:
        # pure-DP: ZeRO may shard over the whole flattened DP domain
        candidates = ["data", "model"] if dp_only else ["data"]
        for ax in candidates:
            if ax not in sizes or ax in base:
                continue
            d = sizes[ax]
            for i, (logical, dim) in enumerate(zip(axes, shape)):
                if base[i] is None and logical != "layers" and dim % d == 0 \
                        and dim >= d:
                    base[i] = ax
                    break
    return P(*base)


def param_shardings(structure, mesh: DeviceMesh, *, dp_only: bool = False):
    """A ``NamedSharding`` a leaf of ``structure`` (a tree of ``ParamSpec``)."""
    return tree_map(
        lambda s: NamedSharding(mesh, param_pspec(s.axes, s.shape, mesh,
                                                  dp_only=dp_only)),
        structure)


def opt_shardings(structure, mesh: DeviceMesh, *, zero1: bool = True,
                  dp_only: bool = False):
    return tree_map(
        lambda s: NamedSharding(mesh, opt_pspec(s.axes, s.shape, mesh,
                                                zero1=zero1, dp_only=dp_only)),
        structure)


# ---------------------------------------------------------------------------
# batch / cache shardings
# ---------------------------------------------------------------------------

def batch_pspec(mesh: DeviceMesh, shape: tuple, *,
                dp_only: bool = False) -> PartitionSpec:
    """Inputs: leading batch dim over DP axes (replicated if not divisible)."""
    dp = dp_axes(mesh)
    sizes = mesh_shape(mesh)
    if dp_only and "model" in sizes:
        dp = dp + ("model",)
    sz = int(np.prod([sizes[a] for a in dp])) if dp else 1
    if dp and shape[0] % sz == 0:
        return P(dp, *([None] * (len(shape) - 1)))
    return P(*([None] * len(shape)))


def batch_shardings(input_structs, mesh: DeviceMesh, *, dp_only: bool = False):
    """A ``NamedSharding`` a leaf of ``input_structs`` (anything with a
    ``shape``: tensors or the model's input specs)."""
    return tree_map(
        lambda s: NamedSharding(mesh, batch_pspec(mesh, tuple(s.shape),
                                                  dp_only=dp_only)),
        input_structs)


_CACHE_RULES = {
    # name -> (rank-without-layer-dim, spec builder)
    "k": lambda dp: (4, P(dp, None, "model", None)),
    "v": lambda dp: (4, P(dp, None, "model", None)),
    # MLA latent cache: replicate the (small) lora dim — sharding it forces a
    # psum over the full cache in the per-step up-projection; head-sharded
    # w_uk/w_uv then need no collective at all.
    "ckv": lambda dp: (3, P(dp, None, None)),
    "krope": lambda dp: (3, P(dp, None, None)),
    "s": lambda dp: (4, P(dp, "model", None, None)),
    "x_prev": lambda dp: (2, P(dp, None)),
    "h": lambda dp: (2, P(dp, "model")),
    "conv": lambda dp: (3, P(dp, None, "model")),
    "pos": lambda dp: (1, P(None)),
}


def _map_with_name(f, tree, name=None):
    """``f(name, leaf)`` over a cache tree, ``name`` the innermost dict key
    above the leaf (``jax.tree.map_with_path``'s last ``DictKey``)."""
    if isinstance(tree, dict):
        return {k: _map_with_name(f, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_name(f, v, name) for v in tree)
    return f(name, tree)


def cache_shardings(cache, mesh: DeviceMesh):
    """Sharding for serve caches, keyed on leaf names (stable across models)."""
    dp = dp_axes(mesh)

    def spec_for(name, leaf):
        base_rank, spec = _CACHE_RULES[name](dp)
        parts = list(spec)
        extra = leaf.dim() - base_rank           # leading stacked-layer dims
        parts = [None] * extra + parts
        # divisibility fallback on sharded dims
        dp_names = set(dp) | {dp}
        for i, p in enumerate(parts):
            if p == "model" and leaf.shape[i] % _axis_size(mesh, "model") != 0:
                parts[i] = None
            elif p in dp_names and dp and leaf.shape[i] % dp_size(mesh) != 0:
                parts[i] = None
        return NamedSharding(mesh, P(*parts))

    return _map_with_name(spec_for, cache)


# ---------------------------------------------------------------------------
# activation constraints (SP knob)
# ---------------------------------------------------------------------------

def constrain_activation(x, mesh: DeviceMesh | None, *, sp: bool = False):
    """Boundary-activation constraint: (B, S, D) -> DP on batch, optional SP
    (sequence dim over 'model') to cut per-chip boundary-residency 16x."""
    if mesh is None or mesh.size() == 1:
        return x
    dp = dp_axes(mesh)
    sizes = mesh_shape(mesh)
    if sp and "model" in sizes and x.shape[1] % sizes["model"] == 0:
        return redistribute(x, NamedSharding(mesh, P(dp, "model", None)))
    return redistribute(x, NamedSharding(mesh, P(dp, *([None] * (x.dim() - 1)))))


def local_slices(shape: tuple, sharding: NamedSharding) -> tuple[slice, ...]:
    """This rank's shard of a tensor of ``shape``, one slice a dim (the
    rules shard only dims that the axes divide; others raise)."""
    mesh = sharding.mesh
    coord = mesh.get_coordinate()
    out = [slice(0, n) for n in shape]
    for mdim, pl in enumerate(sharding.placements):
        if isinstance(pl, Shard):
            s, parts = out[pl.dim], mesh.shape[mdim]
            if (s.stop - s.start) % parts:
                raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not "
                                 f"divide into {parts} shards")
            n = (s.stop - s.start) // parts
            out[pl.dim] = slice(s.start + coord[mdim] * n,
                                s.start + (coord[mdim] + 1) * n)
    return tuple(out)


def local_shape(shape: tuple, sharding: NamedSharding) -> tuple[int, ...]:
    """The shape of this rank's shard of a tensor of ``shape``."""
    return tuple(s.stop - s.start for s in local_slices(shape, sharding))


def shard_tree(tree, shardings):
    """Each leaf of ``tree`` (a whole tensor, the same on every rank) as a
    DTensor of the matching ``NamedSharding``: every rank keeps a copy of
    its own slice (the whole tensor can then be freed), and nothing is
    sent."""
    leaves, rebuild = tree_flatten(tree)
    shds = tree_flatten(shardings)[0]
    if len(shds) != len(leaves):
        raise ValueError(f"{len(shds)} shardings for {len(leaves)} leaves")
    return rebuild([
        DTensor.from_local(t[local_slices(tuple(t.shape), s)].clone(
                               memory_format=torch.contiguous_format),
                           s.mesh, s.placements, run_check=False)
        for t, s in zip(leaves, shds)])
