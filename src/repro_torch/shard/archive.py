"""K-axis sharded candidate archives: one device-resident slice per shard.

PyTorch counterpart of ``repro.shard.archive``.  The paper's candidate pool
is every (instance type, AZ) pair across regions — a SpotLake-scale archive
whose (K, T) window outgrows one device before the request rate does.
Everything downstream of staging is an O(K) pass with mergeable carries, so
this module splits the candidate axis into contiguous ``[start, end)``
shards and stages each slice — window, catalog columns, per-candidate
statistics — on its own device:

- :class:`ShardedArchive`        : immutable slices, one
                                   :class:`~repro_torch.serve.DeviceArchive`
                                   (or quantised archive) per shard;
- :class:`ShardedRollingArchive` : one
                                   :class:`~repro_torch.stream.RollingDeviceArchive`
                                   ring per shard; a collector tick splits
                                   its (K,) column by the same bounds and
                                   appends every slice under a **single**
                                   version bump;
- :class:`ShardedSnapshot`       : the version-pinned view a drain holds
                                   across ticks.

Shards are contiguous, so concatenating per-shard rows in bounds order
restores the global candidate order exactly.  ``devices`` takes torch
devices; shards round-robin over them, so on one card (or the CPU) every
shard is a slice on the same device.  The full-width catalog columns, the
pool stage's operands, live on the first device (the merge device).  The
compute that runs against these archives is :mod:`repro_torch.shard.compute`;
the engine routes any archive with ``is_sharded = True`` there.  Sharded
archives hold no single-device window, so they serve the tiled scoring
stage only (``dense_capable = False``).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from ..core.scoring import f32
from ..core.types import CandidateSet
from ..serve.archive import DeviceArchive
from ..stream.rolling import ArchiveSnapshot, RollingDeviceArchive


def shard_bounds(k: int, n_shards: int) -> tuple[tuple[int, int], ...]:
    """Contiguous, balanced ``[start, end)`` slices of a K-candidate axis.

    The first ``k % n_shards`` shards take one extra candidate, so shard
    sizes differ by at most one.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n_shards > k:
        raise ValueError(
            f"n_shards {n_shards} > {k} candidates (empty shards have no "
            f"masked extrema to merge)")
    base, rem = divmod(k, n_shards)
    bounds, start = [], 0
    for i in range(n_shards):
        end = start + base + (1 if i < rem else 0)
        bounds.append((start, end))
        start = end
    return tuple(bounds)


def check_bounds(bounds, k: int) -> tuple[tuple[int, int], ...]:
    """Validate explicit shard bounds: a contiguous partition of ``[0, k)``.

    Region-sharded serving passes region extents here — the merge needs
    contiguous, non-empty, exhaustive slices, not balanced ones.
    """
    bounds = tuple((int(a), int(b)) for a, b in bounds)
    if not bounds:
        raise ValueError("bounds must be non-empty")
    start = 0
    for i, (a, b) in enumerate(bounds):
        if a != start:
            raise ValueError(
                f"bounds[{i}] starts at {a}, expected {start} (shards must "
                f"be a contiguous partition of [0, {k}))")
        if b <= a:
            raise ValueError(f"bounds[{i}] = [{a}, {b}) is empty")
        start = b
    if start != k:
        raise ValueError(
            f"bounds cover [0, {start}) but the candidate axis has {k} rows")
    return bounds


def _devices(devices) -> tuple[torch.device, ...]:
    """``devices`` resolved by the port's policy; by default every CUDA
    device (raises without CUDA: pass ``devices=["cpu"]`` for the CPU)."""
    if devices is None:
        resolve_device(None)
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    devices = tuple(resolve_device(d) for d in devices)
    if not devices:
        raise ValueError("devices must be non-empty")
    return devices


def _plan(k: int, n_shards: int | None, devices, bounds=None):
    """Resolve ``(bounds, device-per-shard)`` for a K-candidate axis."""
    devices = _devices(devices)
    if bounds is not None:
        bounds = check_bounds(bounds, k)
        if n_shards is not None and int(n_shards) != len(bounds):
            raise ValueError(
                f"n_shards={n_shards} conflicts with {len(bounds)} explicit "
                f"bounds")
        n = len(bounds)
    else:
        n = min(len(devices), k) if n_shards is None else int(n_shards)
        bounds = shard_bounds(k, n)
    return bounds, tuple(devices[i % len(devices)] for i in range(n))


def _full_columns(cands: CandidateSet, device):
    """Full-width catalog columns on the merge device (pool stage operands)."""
    return (f32(cands.prices, device), f32(cands.vcpus, device),
            f32(cands.memory_gb, device))


class _ShardedSurface:
    """The engine-facing surface shared by the three sharded classes.

    ``is_sharded`` routes the engine to the per-shard pipeline;
    ``dense_capable = False`` keeps the scoring stage tiled (there is no
    single-device window: ``t3`` raises).  ``nbytes`` counts every shard
    plus the full-width merge-device catalog columns.
    """

    is_sharded = True
    dense_capable = False

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def device(self) -> torch.device:
        """The merge device: where the pool stage runs."""
        return self.prices.device

    @property
    def t3(self):
        raise RuntimeError(
            f"{type(self).__name__} holds no single-device window matrix: "
            "the (K, T) slices live one per shard (tiled scoring stage "
            "only; see repro_torch.shard.compute).")

    @property
    def nbytes(self) -> int:
        return (sum(s.nbytes for s in self.shards)
                + sum(int(a.nbytes) for a in
                      (self.prices, self.vcpus, self.memory_gb)))

    def __len__(self) -> int:
        return len(self.host)


@dataclass(frozen=True)
class ShardedArchive(_ShardedSurface):
    """An immutable candidate archive split along K.

    ``shards[i]`` is a staged archive of the host rows ``bounds[i]``, on its
    own device, with its own memoised ``score_stats``.  ``prices`` /
    ``vcpus`` / ``memory_gb`` are the full-width catalog columns on the
    merge device; ``host`` keeps the full :class:`CandidateSet` for filter
    masks and results.
    """

    key: str
    host: CandidateSet
    bounds: tuple[tuple[int, int], ...]
    shards: tuple
    prices: torch.Tensor
    vcpus: torch.Tensor
    memory_gb: torch.Tensor

    @classmethod
    def stage(cls, cands: CandidateSet, *, n_shards: int | None = None,
              devices=None, key: str | None = None,
              precision: str = "float32", headroom: float = 1.0,
              bounds=None) -> "ShardedArchive":
        """Split ``cands`` into shards and stage one slice per device.

        ``devices`` defaults to every CUDA device and ``n_shards`` to their
        number (capped at K); shards round-robin over the devices, so more
        shards than devices put several slices on one.  ``precision`` /
        ``headroom`` stage every shard at that tier
        (``DeviceArchive.stage``): quantisation is per candidate, so the
        shards store exactly the rows of the single-device archive, and the
        tier suffix lands on the archive's key as on each shard's.
        ``bounds`` replaces the balanced split with an explicit contiguous
        partition (:func:`check_bounds`).
        """
        bounds, devs = _plan(len(cands), n_shards, devices, bounds)
        key = key if key is not None else cands.fingerprint()
        shards = tuple(
            DeviceArchive.stage(cands.take(np.arange(a, b)),
                                key=f"{key}/s{i}", device=dev,
                                precision=precision, headroom=headroom)
            for i, ((a, b), dev) in enumerate(zip(bounds, devs)))
        prices, vcpus, memory_gb = _full_columns(cands, devs[0])
        if precision != "float32":
            key = f"{key}#{precision}"
        return cls(key=key, host=cands, bounds=bounds, shards=shards,
                   prices=prices, vcpus=vcpus, memory_gb=memory_gb)


@dataclass(frozen=True)
class ShardedSnapshot(_ShardedSurface):
    """Version-pinned view of a :class:`ShardedRollingArchive`.

    One :class:`~repro_torch.stream.ArchiveSnapshot` per shard under a
    single key and version — what the admission queue hands a drain, so a
    tick landing mid-drain can never mix two windows or two shard versions
    in one batch.  The full-width catalog columns are the parent's (no tick
    writes them).
    """

    key: str
    version: int
    host: CandidateSet
    bounds: tuple[tuple[int, int], ...]
    shards: tuple[ArchiveSnapshot, ...]
    prices: torch.Tensor
    vcpus: torch.Tensor
    memory_gb: torch.Tensor
    window_len: int
    #: the parent was marked stale when this was taken (see ArchiveSnapshot)
    stale: bool = False


class ShardedRollingArchive(_ShardedSurface):
    """A live candidate archive sharded along K: one ring per shard.

    Serves wherever a :class:`~repro_torch.stream.RollingDeviceArchive`
    does (``key`` / ``host`` / ``append`` / ``snapshot`` / ``materialize``
    / ``window_len`` / ``nbytes`` / ``version`` / ``stale``), with the same
    versioned-key contract: one version bump per tick across all shards.
    Each ring absorbs its slice of the tick column through the same
    in-place append and rank-1 statistics update (kernel B3 on the card, a
    launch per shard); the update is elementwise along K, so a row-sliced
    update gives the bits of the corresponding rows of a full-width one.
    """

    def __init__(self, cands: CandidateSet, *, capacity: int | None = None,
                 name: str | None = None, n_shards: int | None = None,
                 devices=None, precision: str = "float32",
                 headroom: float = 1.0, bounds=None):
        bounds, devs = _plan(len(cands), n_shards, devices, bounds)
        self.host = cands
        self.name = name if name is not None else cands.fingerprint()
        self.bounds = bounds
        self.precision = precision
        self.shards = tuple(
            RollingDeviceArchive(cands.take(np.arange(a, b)),
                                 capacity=capacity, name=f"{self.name}/s{i}",
                                 device=dev, precision=precision,
                                 headroom=headroom)
            for i, ((a, b), dev) in enumerate(zip(bounds, devs)))
        self.prices, self.vcpus, self.memory_gb = _full_columns(cands,
                                                                devs[0])
        self.version = 0
        self.appends = 0
        #: staleness flag, owned by the feed (``LiveIngestor``)
        self.stale = False
        # Serializes append against snapshot: a tick appends the shard
        # slices one by one before the shared version bump, and the
        # admission worker snapshots from its own thread.  A snapshot
        # between two per-shard appends would pin shard 0 at tick N+1 and
        # shard 1 at tick N under one key.
        self._tick_lock = threading.Lock()

    @property
    def key(self) -> str:
        """Versioned fingerprint: one bump per tick across all shards,
        ``#<precision>``-suffixed on the quantised tiers."""
        key = f"{self.name}@v{self.version}"
        if self.precision != "float32":
            key += f"#{self.precision}"
        return key

    @property
    def clipped_samples(self) -> int:
        """int8-clipped samples over all shards since staging."""
        return sum(s.clipped_samples for s in self.shards)

    @property
    def window_len(self) -> int:
        return self.shards[0].window_len

    def append(self, column) -> "ShardedRollingArchive":
        """Absorb one collector tick: split the (K,) column by the shard
        bounds, append every slice, bump the shared version once.  Atomic
        with respect to :meth:`snapshot`."""
        col = np.asarray(column, np.float32)
        if col.shape != (len(self.host),):
            raise ValueError(
                f"column shape {col.shape} != ({len(self.host)},)")
        with self._tick_lock:
            for (a, b), shard in zip(self.bounds, self.shards):
                shard.append(col[a:b])
            self.version += 1
            self.appends += 1
        return self

    def snapshot(self) -> ShardedSnapshot:
        """Pin the current version of every shard for an in-flight batch,
        under the tick lock: all pieces belong to the stamped version."""
        with self._tick_lock:
            return ShardedSnapshot(
                key=self.key, version=self.version, host=self.host,
                bounds=self.bounds,
                shards=tuple(s.snapshot() for s in self.shards),
                prices=self.prices, vcpus=self.vcpus,
                memory_gb=self.memory_gb, window_len=self.window_len,
                stale=self.stale)

    def materialize(self) -> np.ndarray:
        """Host copy of the full logical window (parity tests, re-staging)."""
        with self._tick_lock:
            return np.concatenate([s.materialize() for s in self.shards],
                                  axis=0)
