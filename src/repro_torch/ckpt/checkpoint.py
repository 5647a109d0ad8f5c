"""Checkpointing: atomic save, async writer, restore onto a device.

PyTorch counterpart of ``repro.ckpt.checkpoint``, with its on-disk layout
(one directory a step)::

    <root>/step_000000123/
        manifest.json          tree description, shapes, dtypes, step, metadata
        leaf_00000.npy ...     one file a leaf, in JAX's flatten order
    <root>/LATEST              committed step marker (written last → atomic)

A step is written into ``.tmp_step_*`` and renamed into place.  bfloat16
leaves are stored as float32 (numpy has no bfloat16; the widening is
exact) and the manifest spells every dtype as numpy does (``"bfloat16"``,
``"float32"``, ``"int32"``), so a checkpoint written by either package
restores in the other: ``restore`` checks only the number of leaves, and
``manifest["treedef"]`` holds each package's own description of the tree.

``restore`` puts each leaf on the device and dtype of the matching leaf of
``like``; with ``shardings=`` (a tree of ``parallel.sharding.NamedSharding``)
each leaf comes back as a DTensor on its sharding's mesh, and each rank
reads only its own slice of the file (the reference's reshard-on-restore).
"""
from __future__ import annotations

import json
import pathlib
import queue
import shutil
import threading
from typing import Any

import numpy as np
import torch

from .._tree import tree_flatten

_SENTINEL = object()


def _describe(tree) -> str:
    """The tree's layout with ``*`` for each leaf (the manifest's
    ``treedef``, informational)."""
    leaves, rebuild = tree_flatten(tree)
    return repr(rebuild(["*"] * len(leaves)))


def _host_leaf(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf as the numpy array the file holds, and its dtype as numpy
    spells it; bfloat16 is widened to float32 on the leaf's own device,
    before the copy to the host."""
    t = leaf.detach()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy(), name


def save(root: str | pathlib.Path, tree: Any, step: int, *, keep: int = 3,
         metadata: dict | None = None) -> pathlib.Path:
    """Synchronous atomic checkpoint write."""
    root = pathlib.Path(root)
    tmp = root / f".tmp_step_{step:09d}"
    final = root / f"step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves, _ = tree_flatten(tree)
    manifest = {
        "step": step,
        "treedef": _describe(tree),
        "num_leaves": len(leaves),
        "metadata": metadata or {},
        "leaves": [],
    }
    for i, leaf in enumerate(leaves):
        arr, dtype = _host_leaf(leaf)
        np.save(tmp / f"leaf_{i:05d}.npy", arr)
        manifest["leaves"].append({"shape": list(arr.shape), "dtype": dtype})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                       # atomic publish
    (root / "LATEST").write_text(str(step))
    _gc(root, keep)
    return final


def _gc(root: pathlib.Path, keep: int) -> None:
    steps = sorted(p for p in root.glob("step_*") if p.is_dir())
    for p in steps[:-keep] if keep else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(root: str | pathlib.Path) -> int | None:
    marker = pathlib.Path(root) / "LATEST"
    if not marker.exists():
        return None
    return int(marker.read_text().strip())


def restore(root: str | pathlib.Path, like: Any, *, step: int | None = None,
            shardings: Any = None) -> tuple[Any, int]:
    """Load a checkpoint into the structure of ``like``.

    ``like`` is a tree of tensors; each leaf takes the dtype of ``like``'s
    leaf and, without ``shardings``, its device.  ``shardings``, a tree of
    ``NamedSharding`` with one leaf a leaf of ``like`` (told by its
    ``mesh``, as in the reference), puts each leaf on its mesh as a DTensor
    with the sharding's placements: each rank maps the file and reads only
    its own slice.  Returns ``(tree, step)``.
    """
    root = pathlib.Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = root / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())
    like_leaves, rebuild = tree_flatten(like)
    if manifest["num_leaves"] != len(like_leaves):
        raise ValueError(
            f"checkpoint has {manifest['num_leaves']} leaves, "
            f"target structure has {len(like_leaves)}")
    if shardings is None:
        out = [torch.from_numpy(np.load(d / f"leaf_{i:05d}.npy"))
               .to(device=tgt.device, dtype=tgt.dtype)
               for i, tgt in enumerate(like_leaves)]
        return rebuild(out), step
    shard_leaves = tree_flatten(shardings)[0]
    for shd in shard_leaves:
        if not hasattr(shd, "mesh"):
            raise TypeError(f"a leaf of shardings is a {type(shd).__name__}, "
                            "not a NamedSharding")
    if len(shard_leaves) != len(like_leaves):
        raise ValueError(f"shardings has {len(shard_leaves)} leaves, the "
                         f"target structure {len(like_leaves)}")
    out = [_restore_shard(d / f"leaf_{i:05d}.npy", tgt.dtype, shd)
           for i, (tgt, shd) in enumerate(zip(like_leaves, shard_leaves))]
    return rebuild(out), step


def _restore_shard(path: pathlib.Path, dtype: torch.dtype, sharding):
    """One leaf as a DTensor of ``sharding``: this rank's slice of the
    mapped file, cast on the host to ``dtype`` and moved to the rank's
    device."""
    from torch.distributed.tensor import DTensor

    from ..parallel.sharding import local_slices
    arr = np.load(path, mmap_mode="r")
    mesh = sharding.mesh
    local = np.array(arr[local_slices(arr.shape, sharding)])  # reads the slice
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    t = torch.from_numpy(local).to(dtype=dtype).to(dev)
    return DTensor.from_local(t, mesh, sharding.placements, run_check=False)


class AsyncCheckpointer:
    """Background-thread checkpoint writer.

    ``save`` copies the leaves into host memory that nothing else holds
    (synchronously: cheap against a blocking write), so a later in-place
    update of the live tensors cannot reach the file; the serialisation is
    queued.  ``wait`` drains the queue and raises the first error.
    """

    def __init__(self, root: str | pathlib.Path, keep: int = 3):
        self.root = pathlib.Path(root)
        self.keep = keep
        self._q: queue.Queue = queue.Queue()
        self._errors: list[Exception] = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                return
            tree, step, metadata = item
            try:
                save(self.root, tree, step, keep=self.keep, metadata=metadata)
            except Exception as e:  # noqa: BLE001
                self._errors.append(e)
            finally:
                self._q.task_done()

    def save(self, tree: Any, step: int, metadata: dict | None = None) -> None:
        leaves, rebuild = tree_flatten(tree)
        host = rebuild([x.detach().to("cpu", copy=True) for x in leaves])
        self._q.put((host, step, metadata))

    def wait(self) -> None:
        self._q.join()
        if self._errors:
            raise self._errors[0]

    def close(self) -> None:
        self.wait()
        self._q.put(_SENTINEL)
        self._thread.join()
