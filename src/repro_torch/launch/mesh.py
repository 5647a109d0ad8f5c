"""Production meshes (as functions: importing never touches device state).

PyTorch counterpart of ``repro.launch.mesh``.  A mesh is a ``DeviceMesh``
over the default process group, which the caller sets up with its ranks
(``torch.distributed.init_process_group``); ``make_host_mesh`` sets up a
one-rank group itself where there is none.  :func:`fake_production_mesh`
builds the production mesh over a fake group (one rank's view, nothing
sent), for the dry-run and the roofline pass on the CPU.
"""
from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .._device import resolve_device


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """The 16 x 16 ``("data", "model")`` mesh, or 2 x 16 x 16 with a
    leading ``"pod"``, over a default group of 256 (512) ranks, on CUDA
    unless ``device="cpu"``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def make_host_mesh(device=None) -> DeviceMesh:
    """A one-rank (1, 1) ``("data", "model")`` mesh, on CUDA unless
    ``device="cpu"``.

    Where no default group exists, this sets one up: rank 0 of 1 on an
    in-process ``HashStore`` (no address, no socket), with NCCL on CUDA
    and gloo on the CPU.  The group then belongs to the caller, who ends
    it with ``torch.distributed.destroy_process_group()``.
    """
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_production_mesh(*, multi_pod: bool = False):
    """The production mesh on the CPU over a fake default group of 256
    (512) ranks, this process rank 0 (``torch.testing``'s ``FakeStore``:
    collectives return at once and move nothing).  The group ends when the
    block does, also when it raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group exists: end it before "
                           "building a fake production mesh")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi_pod else 256)
    try:
        yield make_production_mesh(multi_pod=multi_pod, device="cpu")
    finally:
        dist.destroy_process_group()
