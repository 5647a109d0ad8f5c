"""Device-staged candidate archives + LRU cache keyed by archive content.

PyTorch counterpart of ``repro.serve.archive``.  The T3 archive slice is
the large, slowly-changing half of every request (a K x T matrix against a
handful of request scalars); staging it on the device once and reusing it
across batches removes the per-batch host-to-device copy, and the memoised
Eq. 3 statistics remove the per-batch O(K*T) pass.  The window is staged
at one of three storage tiers: float32 (:class:`DeviceArchive`), or int8 /
bfloat16 codes (:class:`QuantizedDeviceArchive`).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from .._device import resolve_device
from ..core import scoring
from ..core.scoring import f32
from ..core.types import CandidateSet, Recommendation, ResourceRequest
from ..parallel import compression

#: rows of a quantised window decoded at a time by :func:`decoded_stats`:
#: a K = 2^20, T = 1008 window would be a 4.2 GB float32 transient whole
STATS_CHUNK = compression.STAGE_CHUNK


def decoded_stats(t3_q: torch.Tensor, scale: torch.Tensor, precision: str,
                  *, chunk: int = STATS_CHUNK) -> scoring.CandidateStats:
    """Eq. 3 statistics of a stored window, decoded ``chunk`` rows at a time.

    The statistics of a candidate depend on its own row alone, and every
    reduction runs along the row, so the chunks' statistics concatenate to
    the statistics of the whole decoded window bit for bit
    (``tests/test_torch_quantized_archive.py``).
    """
    K = t3_q.shape[0]
    parts = [scoring.candidate_stats(compression.dequantize_window(
        t3_q[a:a + chunk], scale[a:a + chunk], precision))
        for a in range(0, K, chunk)]
    return scoring.CandidateStats(*(torch.cat(x) for x in zip(*parts)))


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
              device=None, precision: str = "float32",
              headroom: float = 1.0):
        """Put a candidate set's numeric arrays on ``device``.

        ``device`` follows the port's policy: CUDA unless ``"cpu"`` is asked
        for, and no fallback.  ``precision`` selects the storage tier
        (``compression.ARCHIVE_PRECISIONS``): ``"bfloat16"`` / ``"int8"``
        return a :class:`QuantizedDeviceArchive` holding the window as
        stored codes (2x / 4x fewer resident window bytes) and a
        per-candidate float32 scale, keyed ``<key>#<precision>`` so tiers
        never collide in an :class:`ArchiveCache`.  ``headroom`` widens the
        int8 step (``compression.candidate_scales``).  Catalog columns stay
        float32 on every tier.
        """
        precision = compression.resolve_precision(precision)
        dev = resolve_device(device)
        key = key if key is not None else cands.fingerprint()
        catalog = dict(prices=f32(cands.prices, dev),
                       vcpus=f32(cands.vcpus, dev),
                       memory_gb=f32(cands.memory_gb, dev))
        if precision == "float32":
            return cls(key=key, host=cands, t3=f32(cands.t3, dev), **catalog)
        t3 = np.asarray(cands.t3)
        scale = compression.candidate_scales(t3, precision,
                                             headroom=headroom)
        return QuantizedDeviceArchive(
            key=f"{key}#{precision}", host=cands,
            t3_q=compression.quantize_window(t3, scale, precision).to(dev),
            scale=f32(scale, dev), precision=precision, **catalog)

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


@dataclass(frozen=True)
class QuantizedDeviceArchive:
    """A staged archive whose T3 window lives on the device as stored codes.

    Serves wherever a :class:`DeviceArchive` does: the same float32 catalog
    columns, a memoised ``score_stats()`` computed from the decoded window
    (the tier's ground truth, decoded in :data:`STATS_CHUNK`-row pieces),
    and a :attr:`t3` that decodes ``code * scale`` on each access.  The
    decode is not memoised: nothing float32 and (K, T)-shaped stays
    resident, so only the dense scoring stage pays for it, per batch.

    A stored sample is within ``scale / 2`` of its source
    (``core.quantized`` turns that into the score-drift budget); a staged
    window never clips, its scale comes from its own per-candidate maxabs.
    """

    key: str
    host: CandidateSet
    t3_q: torch.Tensor          # (K, T) stored codes (int8 / bf16)
    scale: torch.Tensor         # (K,) float32 quantisation step
    precision: str
    prices: torch.Tensor
    vcpus: torch.Tensor
    memory_gb: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.t3_q.device

    @property
    def t3(self) -> torch.Tensor:
        """The dequantized float32 window, rebuilt on each access."""
        return compression.dequantize_window(self.t3_q, self.scale,
                                             self.precision)

    def score_stats(self) -> scoring.CandidateStats:
        """Eq. 3 statistics of the dequantized window, memoised once."""
        stats = self.__dict__.get("_score_stats")
        if stats is None:
            stats = decoded_stats(self.t3_q, self.scale, self.precision)
            object.__setattr__(self, "_score_stats", stats)
        return stats

    @property
    def t3_operand(self) -> torch.Tensor:
        """A (K,) stand-in for the window where a stats-backed dispatch
        wants some t3 operand: never the decoded window."""
        return self.score_stats().area

    @property
    def nbytes(self) -> int:
        """Resident device bytes: stored codes + scale + catalog columns +
        the memoised statistics once computed (a dense batch's transient
        decode does not outlive the batch and is not counted)."""
        n = sum(int(a.nbytes) for a in
                (self.t3_q, self.scale, self.prices, self.vcpus,
                 self.memory_gb))
        stats = self.__dict__.get("_score_stats")
        if stats is not None:
            n += sum(int(a.nbytes) for a in stats)
        return n

    def __len__(self) -> int:
        return len(self.host)


@dataclass
class ArchiveCache:
    """LRU of :class:`DeviceArchive` entries keyed by archive fingerprint.

    ``get`` stages on miss (on ``device``, at ``precision`` /
    ``headroom``) and refreshes recency on hit.  Keys default to
    :meth:`CandidateSet.fingerprint` (content hash); pass an explicit
    ``key`` to skip hashing large archives.  A quantised tier suffixes the
    key with ``#<precision>``, so one cache never serves one tier for
    another.  ``max_bytes`` adds a device-byte budget on top of the
    entry-count cap, counting each entry's memoised statistics; the most
    recent entry always survives.
    """

    capacity: int = 4
    max_bytes: int | None = None
    precision: str = "float32"
    headroom: float = 1.0
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
        base = key if key is not None else cands.fingerprint()
        key = base if self.precision == "float32" \
            else f"{base}#{self.precision}"
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            self._entries.move_to_end(key)
            return entry
        self.misses += 1
        entry = DeviceArchive.stage(cands, key=base, device=self.device,
                                    precision=self.precision,
                                    headroom=self.headroom)
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
