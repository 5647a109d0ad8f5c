"""Device-staged candidate archives + LRU cache keyed by archive content.

PyTorch counterpart of ``repro.serve.archive`` (float32 tier).  The T3
archive slice is the large, slowly-changing half of every request (a K x T
matrix against a handful of request scalars); staging it on the device once
and reusing it across batches removes the per-batch host-to-device copy,
and the memoised Eq. 3 statistics remove the per-batch O(K*T) pass.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field, replace

import torch

from .._device import resolve_device
from ..core import scoring
from ..core.scoring import f32
from ..core.types import CandidateSet, Recommendation, ResourceRequest
from ..parallel import compression


@dataclass(frozen=True)
class DeviceArchive:
    """A candidate set's numeric arrays, resident on one device.

    ``t3`` / ``prices`` / ``vcpus`` / ``memory_gb`` are float32 tensors —
    the operands the engine's batched path reads.  ``host`` keeps the
    original :class:`CandidateSet` for filter masks and result
    materialisation (names, string columns, float64 prices for exact
    hourly-cost accounting).
    """

    key: str
    host: CandidateSet
    t3: torch.Tensor
    prices: torch.Tensor
    vcpus: torch.Tensor
    memory_gb: torch.Tensor

    @classmethod
    def stage(cls, cands: CandidateSet, *, key: str | None = None,
              device=None, precision: str = "float32"):
        """Put a candidate set's numeric arrays on ``device``.

        ``device`` follows the port's policy: CUDA unless ``"cpu"`` is asked
        for, and no fallback.  Only the float32 tier stages here;
        ``"bfloat16"`` / ``"int8"`` raise ``NotImplementedError`` (the
        quantized tiers stage as rolling archives, ``repro_torch.stream``).
        """
        if compression.resolve_precision(precision) != "float32":
            raise NotImplementedError(
                f"the {precision} tier of a static DeviceArchive is not "
                "ported yet; RollingDeviceArchive stages every tier")
        dev = resolve_device(device)
        key = key if key is not None else cands.fingerprint()
        return cls(key=key, host=cands, t3=f32(cands.t3, dev),
                   prices=f32(cands.prices, dev), vcpus=f32(cands.vcpus, dev),
                   memory_gb=f32(cands.memory_gb, dev))

    @property
    def device(self) -> torch.device:
        return self.t3.device

    def score_stats(self) -> scoring.CandidateStats:
        """Request-independent scoring statistics, computed once per archive.

        The O(K*T) raw area / slope / std reductions of Eq. 3 depend only on
        the T3 slice, so they are computed on first use and memoised; every
        later batch against this archive skips the pass.
        """
        stats = self.__dict__.get("_score_stats")
        if stats is None:
            stats = scoring.candidate_stats(self.t3)
            object.__setattr__(self, "_score_stats", stats)
        return stats

    @property
    def nbytes(self) -> int:
        """Device bytes held by this entry, memoised statistics included."""
        n = sum(int(a.nbytes) for a in
                (self.t3, self.prices, self.vcpus, self.memory_gb))
        stats = self.__dict__.get("_score_stats")
        if stats is not None:
            n += sum(int(a.nbytes) for a in stats)
        return n

    def __len__(self) -> int:
        return len(self.host)


@dataclass
class ArchiveCache:
    """LRU of :class:`DeviceArchive` entries keyed by archive fingerprint.

    ``get`` stages on miss (on ``device``) and refreshes recency on hit.
    Keys default to :meth:`CandidateSet.fingerprint` (content hash); pass
    an explicit ``key`` to skip hashing large archives.  ``max_bytes`` adds
    a device-byte budget on top of the entry-count cap, counting each
    entry's memoised statistics; the most recent entry always survives.
    """

    capacity: int = 4
    max_bytes: int | None = None
    precision: str = "float32"
    device: torch.device | str | None = None
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    _entries: OrderedDict = field(default_factory=OrderedDict)

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError("capacity must be >= 1")
        if self.max_bytes is not None and self.max_bytes < 1:
            raise ValueError("max_bytes must be >= 1")
        compression.resolve_precision(self.precision)
        self.device = resolve_device(self.device)

    def get(self, cands: CandidateSet, *, key: str | None = None):
        key = key if key is not None else cands.fingerprint()
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            self._entries.move_to_end(key)
            return entry
        self.misses += 1
        entry = DeviceArchive.stage(cands, key=key, device=self.device,
                                    precision=self.precision)
        self._entries[key] = entry
        self.enforce_budget()
        return entry

    def put(self, entry) -> None:
        """Insert (or refresh) an already-staged entry under ``entry.key``."""
        self._entries[entry.key] = entry
        self._entries.move_to_end(entry.key)
        self.enforce_budget()

    def invalidate(self, key: str) -> bool:
        """Drop ``key`` if present.  Not counted as a capacity eviction."""
        return self._entries.pop(key, None) is not None

    def enforce_budget(self) -> None:
        """Evict LRU-first down to the entry-count and byte budgets."""
        while len(self._entries) > self.capacity or (
                self.max_bytes is not None and len(self._entries) > 1
                and self.nbytes > self.max_bytes):
            self._entries.popitem(last=False)
            self.evictions += 1

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())


class PoolCache:
    """Last-response memo keyed by request signature — the degraded tier.

    Under overload, a shed request is answered with the last pool computed
    for its exact :meth:`ResourceRequest.signature`, flagged degraded.
    Thread-safe: ``put``/``get`` take an internal lock.
    """

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.hits = 0
        self.misses = 0
        self._entries: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def put(self, request: ResourceRequest, rec: Recommendation) -> None:
        sig = request.signature()
        with self._lock:
            self._entries[sig] = rec
            self._entries.move_to_end(sig)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def get(self, request: ResourceRequest) -> Recommendation | None:
        """The last full-path pool for this signature, or ``None``.

        Returns a *copy* with fresh diagnostics (``degraded: True``,
        ``served_from: "pool_cache"``), never the memoised original.
        """
        sig = request.signature()
        with self._lock:
            rec = self._entries.get(sig)
            if rec is None:
                self.misses += 1
                return None
            self._entries.move_to_end(sig)
            self.hits += 1
            return replace(rec, diagnostics={
                **rec.diagnostics, "degraded": True,
                "served_from": "pool_cache"})

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
