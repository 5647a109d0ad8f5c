"""Carry state from the reference (or any numpy source) into the port.

This system's "weights" are the staged candidate archive: the catalog
columns, the (K, T) T3 window (or its stored int8 / bf16 codes and scale)
and its memoised Eq. 3 statistics.  With these helpers a test or the
on-card smoke run gives both packages (or two devices) bit-identical
stored codes and statistics, and the same shard bounds, so that what is
compared is what comes after them.  :func:`params_from_jax` does the same for the LM
stack's parameters, and :func:`train_state_from_jax` for a whole training
state (parameters and AdamW moments).
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .core.scoring import CandidateStats, f32
from .core.types import CandidateSet
from .serve.archive import DeviceArchive, QuantizedDeviceArchive
from .train import OptState, TrainState

_FIELDS = ("names", "regions", "azs", "families", "categories", "vcpus",
           "memory_gb", "prices", "t3")


def candidate_set_from_numpy(**arrays) -> CandidateSet:
    """The port's :class:`CandidateSet` from the reference's arrays.

    Takes the nine fields by name (``vars(reference_candidate_set)`` gives
    them) and copies each into a fresh numpy array.
    """
    missing = set(_FIELDS) - set(arrays)
    extra = set(arrays) - set(_FIELDS)
    if missing or extra:
        raise TypeError(f"candidate set fields: missing {sorted(missing)}, "
                        f"unexpected {sorted(extra)}")
    return CandidateSet(**{k: np.array(arrays[k]) for k in _FIELDS})


def as_candidate_set(cands) -> CandidateSet:
    """``cands`` as the port's :class:`CandidateSet`: returned as it is when
    it already is one, else its nine fields copied (a collector of the
    reference's simulator hands out the reference's type)."""
    if isinstance(cands, CandidateSet):
        return cands
    return candidate_set_from_numpy(**{k: getattr(cands, k) for k in _FIELDS})


def archive_from_numpy(cands: CandidateSet, stats=None, *, device=None,
                       key: str | None = None) -> DeviceArchive:
    """Stage ``cands`` on ``device`` with the given memoised statistics.

    ``stats`` is ``(area, slope, std)`` as arrays of shape (K,) — from the
    reference's ``candidate_stats``, or another device's ``score_stats()``
    — and becomes the archive's ``score_stats()`` as float32, bit for bit.
    ``None`` leaves the statistics to be computed on first use.
    """
    return _with_stats(DeviceArchive.stage(cands, key=key, device=device),
                       stats)


def _with_stats(archive, stats):
    """Memoise ``stats`` (three (K,) arrays, or None) on a staged archive."""
    if stats is not None:
        K = len(archive)
        rows = [f32(np.asarray(x), archive.device) for x in stats]
        if len(rows) != 3 or any(tuple(r.shape) != (K,) for r in rows):
            raise ValueError(f"stats must be three ({K},) arrays")
        object.__setattr__(archive, "_score_stats", CandidateStats(*rows))
    return archive


def quantized_archive_from_numpy(cands: CandidateSet, t3_q, scale,
                                 precision: str, stats=None, *, device=None,
                                 key: str | None = None
                                 ) -> QuantizedDeviceArchive:
    """A :class:`QuantizedDeviceArchive` holding the given stored codes.

    ``t3_q`` (K, T) int8 or bf16 codes and ``scale`` (K,) float32, from the
    reference's ``QuantizedDeviceArchive`` (``np.asarray`` of its ``t3_q``
    and ``scale``), land on ``device`` bit for bit; ``key`` is used as it
    is (the reference's key already carries ``#<precision>``).  ``stats``
    as for :func:`archive_from_numpy`.
    """
    dev = resolve_device(device)
    codes = _tensor_from_numpy(t3_q, dev)
    want = {"int8": torch.int8, "bfloat16": torch.bfloat16}.get(precision)
    if codes.dtype != want or codes.shape != (len(cands), *codes.shape[1:]):
        raise ValueError(f"t3_q must be ({len(cands)}, T) {precision} codes, "
                         f"got {tuple(codes.shape)} {codes.dtype}")
    archive = QuantizedDeviceArchive(
        key=key if key is not None else f"{cands.fingerprint()}#{precision}",
        host=cands, t3_q=codes, scale=f32(np.asarray(scale), dev),
        precision=precision, prices=f32(cands.prices, dev),
        vcpus=f32(cands.vcpus, dev), memory_gb=f32(cands.memory_gb, dev))
    return _with_stats(archive, stats)


def sharded_archive_from_numpy(cands: CandidateSet, bounds, stats=None, *,
                               devices=None, key: str | None = None):
    """A float32 :class:`ShardedArchive` split at the given ``bounds`` (the
    reference's ``ShardedArchive.bounds``), each shard memoising its rows
    of the full-width ``stats`` (three (K,) arrays) when given."""
    from .shard import ShardedArchive   # shard -> stream -> this module
    archive = ShardedArchive.stage(cands, bounds=bounds, devices=devices,
                                   key=key)
    if stats is not None:
        for (a, b), shard in zip(archive.bounds, archive.shards):
            _with_stats(shard, [np.asarray(x)[a:b] for x in stats])
    return archive


def _tensor_from_numpy(a, device) -> torch.Tensor:
    """One parameter leaf: bf16 (numpy's ``bfloat16`` extension type, as
    ``np.asarray`` gives a JAX bf16 array) kept bit for bit through its raw
    16-bit pattern; float32 and integer leaves as they are."""
    a = np.array(a)             # an owned, writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(params_np_tree, *, device=None):
    """The port's parameter tree from the reference's.

    ``params_np_tree`` is the reference model's parameters with every leaf
    turned into a numpy array (``jax.tree.map(np.asarray, params)``): nested
    dicts and lists, the same layout as the port's ``Model.structure()``.
    Each leaf lands on ``device`` (CUDA when ``None``) with its dtype and
    bits unchanged.
    """
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        if node is None:
            return None
        return _tensor_from_numpy(node, dev)

    return walk(params_np_tree)


def train_state_from_jax(state_np_tree, *, device=None):
    """The port's ``TrainState`` from the reference's.

    ``state_np_tree`` is the reference's ``TrainState`` with every leaf a
    numpy array (``jax.tree.map(np.asarray, state)``): ``(params, (mu, nu,
    master, count))``.  Parameters, both moments, the float32 master copy
    (``None`` stays ``None``) and the step count land on ``device`` (CUDA
    when ``None``) bit for bit, so both packages can step from one state.
    """
    params, (mu, nu, master, count) = state_np_tree
    load = lambda tree: params_from_jax(tree, device=device)  # noqa: E731
    dev = resolve_device(device)
    return TrainState(
        params=load(params),
        opt=OptState(mu=load(mu), nu=load(nu),
                     master=None if master is None else load(master),
                     count=torch.tensor(int(np.asarray(count)),
                                        dtype=torch.int32, device=dev)))
