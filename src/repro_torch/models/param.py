"""Parameter structure: shapes, logical axes and init, from one declaration.

PyTorch counterpart of ``repro.models.param``.  Every model declares its
parameters once as a tree (nested dicts and lists) of :class:`ParamSpec`;
from it come the real tensors (:func:`init_params`), their meta stand-ins
(:func:`shape_structs`) and the parameter count.  The logical axes are kept for the sharding item, which maps them
to a device mesh; on one card nothing reads them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .._device import resolve_device
from .._tree import tree_leaves, tree_map  # noqa: F401  (re-exported)

#: most float32 elements drawn at once by :func:`init_params`; a larger leaf
#: is drawn slice by slice along its leading axis
DRAW_CHUNK = 1 << 28


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical axis names, len == rank
    dtype: Any = torch.bfloat16
    init: str = "normal"                  # normal | zeros | ones
    fan_in_axes: tuple[int, ...] | None = None  # dims contracted on use

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _fan_in(spec: ParamSpec) -> int:
    """The contracted size the init scales by, as in the reference."""
    if spec.fan_in_axes:
        return int(np.prod([spec.shape[i] for i in spec.fan_in_axes]))
    return spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]


def _draw(spec: ParamSpec, generator: torch.Generator, device) -> torch.Tensor:
    """normal(0, 1) / sqrt(fan_in), drawn in float32 and cast to the leaf's
    dtype.  A leaf of more than :data:`DRAW_CHUNK` elements is drawn in
    slices along its leading axis, so the float32 temporary stays small
    (the stacked MoE leaf of DeepSeek-V2-Lite has 4.8 G elements)."""
    scale = 1.0 / np.sqrt(max(_fan_in(spec), 1))
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    flat = out.view(out.shape[0], -1) if out.dim() else out.view(1, 1)
    step = max(1, DRAW_CHUNK // max(flat.shape[1], 1))
    for a in range(0, flat.shape[0], step):
        rows = flat[a:a + step]
        blk = torch.randn(rows.shape, generator=generator, device=device,
                          dtype=torch.float32)
        rows.copy_(blk.mul_(scale))
    return out


def init_params(structure, generator: torch.Generator, device=None):
    """Materialise real parameters on ``device`` (CUDA when ``None``) from
    ``generator``, a ``torch.Generator`` on that device.

    On ``device="meta"`` this is :func:`shape_structs` (nothing is drawn).
    The draws come from a ``torch.Generator``, so they are not the
    reference's numbers for the same seed: a test that needs both packages
    on the same weights makes them in JAX and carries them over with
    :func:`repro_torch.convert.params_from_jax`.
    """
    device = resolve_device(device)
    if device.type == "meta":
        return shape_structs(structure)

    def make(spec: ParamSpec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=device)
        return _draw(spec, generator, device)

    return tree_map(make, structure)


def shape_structs(structure):
    """Meta tensors of each leaf's shape and dtype: the structure without
    storage (the reference's ``ShapeDtypeStruct`` stand-ins).  Nothing is
    drawn."""
    return tree_map(lambda spec: torch.empty(spec.shape, dtype=spec.dtype,
                                             device="meta"), structure)


def count_params(structure) -> int:
    return int(sum(np.prod(s.shape) for s in tree_leaves(structure)))
