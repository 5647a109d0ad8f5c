"""Carry state from the reference (or any numpy source) into the port.

This system's "weights" are the staged candidate archive: the catalog
columns, the (K, T) T3 window and its memoised Eq. 3 statistics.  With
these two helpers a test or the on-card smoke run gives both packages (or
two devices) bit-identical statistics, so that what is compared is what
comes after them.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.scoring import CandidateStats, f32
from .core.types import CandidateSet
from .serve.archive import DeviceArchive

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


def archive_from_numpy(cands: CandidateSet, stats=None, *, device=None,
                       key: str | None = None) -> DeviceArchive:
    """Stage ``cands`` on ``device`` with the given memoised statistics.

    ``stats`` is ``(area, slope, std)`` as arrays of shape (K,) — from the
    reference's ``candidate_stats``, or another device's ``score_stats()``
    — and becomes the archive's ``score_stats()`` as float32, bit for bit.
    ``None`` leaves the statistics to be computed on first use.
    """
    archive = DeviceArchive.stage(cands, key=key, device=device)
    if stats is not None:
        K = len(cands)
        rows = [f32(np.asarray(x), archive.device) for x in stats]
        if len(rows) != 3 or any(tuple(r.shape) != (K,) for r in rows):
            raise ValueError(f"stats must be three ({K},) arrays")
        object.__setattr__(archive, "_score_stats", CandidateStats(*rows))
    return archive
