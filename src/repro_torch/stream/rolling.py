"""Ring-buffer device archive: one-column appends without re-staging.

PyTorch counterpart of ``repro.stream.rolling``.  A live collector changes
the archive by exactly one T3 column per tick; this module absorbs the
column in O(K):

- the T3 window lives on the device as a ring of ``capacity`` slots, stored
  slot-major as a (capacity, K) tensor, so a slot (one column of the
  window) is a contiguous (K,) row that the kernel reads and the append
  writes in place;
- the Eq. 3 statistics ride along through the rank-1 update
  (``kernels.stats_update``, kernel B3 on the card) instead of an O(K*T)
  recompute, so the tiled scoring stage never touches the window;
- every append bumps ``version`` and therefore :attr:`key`, the versioned
  fingerprint the ``ArchiveCache`` entries are keyed by.

The logical (K, window_len) window, oldest first, is only gathered when
something asks for :attr:`t3` (the dense scoring stage or a parity check),
and the gather is memoised per version.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from ..core import scoring
from ..core.scoring import f32
from ..core.types import CandidateSet
from ..kernels import stats_update as stats_update_lib
from ..parallel import compression


@dataclass(frozen=True)
class ArchiveSnapshot:
    """An immutable, version-pinned view of a :class:`RollingDeviceArchive`.

    What the admission queue hands to a drain: the parent may absorb more
    ticks while a batch is in flight, but a snapshot references only tensors
    no later tick writes (the catalog columns and the statistics of its
    version; each tick's statistics are new tensors), so it stays valid
    across version bumps.

    Snapshots carry no window matrix and serve the tiled scoring stage only:
    ``dense_capable = False`` makes the engine keep the stage tiled whatever
    ``auto`` would pick, and :attr:`t3` raises.
    """

    key: str
    version: int
    host: CandidateSet
    prices: torch.Tensor
    vcpus: torch.Tensor
    memory_gb: torch.Tensor
    stats: scoring.CandidateStats
    window_len: int
    #: storage tier of the parent ring ("float32" / "bfloat16" / "int8")
    precision: str = "float32"
    #: the parent's per-candidate quantisation step (None on float32)
    scale: torch.Tensor | None = None
    #: the parent was marked stale (its feed stopped) when this was taken;
    #: drains stamp a ``stale_archive`` diagnostic on what they serve
    stale: bool = False

    dense_capable = False

    @property
    def device(self) -> torch.device:
        return self.prices.device

    def score_stats(self) -> scoring.CandidateStats:
        return self.stats

    @property
    def t3(self):
        raise RuntimeError(
            "ArchiveSnapshot has no window matrix: it pins a past archive "
            "version for in-flight batches and serves the tiled scoring "
            "stage only (score_impl='tiled'/'auto' at streaming K).")

    @property
    def nbytes(self) -> int:
        n = sum(int(a.nbytes) for a in
                (self.prices, self.vcpus, self.memory_gb, *self.stats))
        if self.scale is not None:
            n += int(self.scale.nbytes)
        return n

    def __len__(self) -> int:
        return len(self.host)


class RollingDeviceArchive:
    """A device-staged candidate archive that absorbs one-column ticks.

    Serves wherever a :class:`~repro_torch.serve.DeviceArchive` does
    (``prices`` / ``vcpus`` / ``memory_gb`` / ``t3`` / ``score_stats()`` /
    ``key`` / ``host`` / ``device`` / ``nbytes``), plus :meth:`append`,
    :meth:`snapshot` and a ``version`` that changes with every append.

    ``host`` keeps the stage-time :class:`CandidateSet` for filter masks and
    results; its ``t3`` is a cold copy, :meth:`materialize` gives the live
    window.  ``device`` follows the port's policy (CUDA unless ``"cpu"``).
    ``precision`` picks the ring's storage tier: ``"float32"``,
    ``"bfloat16"`` or ``"int8"`` with a per-candidate scale frozen at
    staging (``headroom`` buys clip slack for later columns).
    """

    def __init__(self, cands: CandidateSet, *, capacity: int | None = None,
                 name: str | None = None, device=None,
                 precision: str = "float32", headroom: float = 1.0):
        self.precision = compression.resolve_precision(precision)
        t3 = np.asarray(cands.t3)
        K, T = t3.shape
        capacity = T if capacity is None else int(capacity)
        if capacity < T:
            raise ValueError(f"capacity {capacity} < staged window {T}")
        dev = resolve_device(device)
        self.device = dev
        self.host = cands
        self.name = name if name is not None else cands.fingerprint()
        self.capacity = capacity
        self.prices = f32(cands.prices, dev)
        self.vcpus = f32(cands.vcpus, dev)
        self.memory_gb = f32(cands.memory_gb, dev)
        host_scale = compression.candidate_scales(
            t3, self.precision, headroom=headroom)
        self.scale = (f32(host_scale, dev) if self.precision != "float32"
                      else None)
        self._clips = torch.zeros((), dtype=torch.int32, device=dev)
        # ring: window in slots [0, T), zero-filled tail, cursor at T
        codes = compression.quantize_window(t3, host_scale, self.precision)
        buf = torch.zeros((capacity, K), dtype=codes.dtype)
        buf[:T] = codes.T
        self._buf = buf.to(dev)
        self._pos = T % capacity
        self._len = T
        self.version = 0
        # seeded from the stored window (codes decoded with the exact
        # dequantize multiply / bf16 cast): the tier's ground truth
        self._moments = stats_update_lib.moments_from_window(
            codes, scale=host_scale if self.precision == "int8" else None,
            device=dev)
        self._stats: scoring.CandidateStats | None = None
        self._t3_logical: torch.Tensor | None = None
        self.appends = 0
        #: staleness flag, owned by the feed (``LiveIngestor``); changing it
        #: does not bump :attr:`version`: the window is unchanged
        self.stale = False

    # -- identity ----------------------------------------------------------

    @property
    def key(self) -> str:
        """Versioned fingerprint: changes with every appended column.

        Quantised tiers get a ``#<precision>`` suffix so two archives staged
        from one candidate set at different precisions never collide.
        """
        key = f"{self.name}@v{self.version}"
        if self.precision != "float32":
            key += f"#{self.precision}"
        return key

    @property
    def clipped_samples(self) -> int:
        """Samples clipped to the int8 code range since staging (0 on the
        bf16 and float32 tiers); a non-zero count voids the error bound."""
        return int(self._clips)

    @property
    def window_len(self) -> int:
        return self._len

    @property
    def _start(self) -> int:
        return (self._pos - self._len) % self.capacity

    def __len__(self) -> int:
        return len(self.host)

    # -- streaming ---------------------------------------------------------

    def append(self, column) -> "RollingDeviceArchive":
        """Absorb one collector tick: O(K) work, no (K, T) copy.

        Encodes ``column`` at the ring's tier, rank-1-updates the moments
        and statistics (one launch of kernel B3 on the card), writes the
        slot under the cursor in place, bumps :attr:`version` and drops the
        memoised window.  Returns ``self``.
        """
        col = f32(column, self.device)
        if tuple(col.shape) != (len(self.host),):
            raise ValueError(
                f"column shape {tuple(col.shape)} != ({len(self.host)},)")
        evict = self._len == self.capacity
        new_len = self._len if evict else self._len + 1
        slot = self._pos
        new_start = ((slot + 1) % self.capacity if evict
                     else (slot + 1 - new_len) % self.capacity)
        codes, n_clip = compression.quantize_column(col, self.scale,
                                                    self.precision)
        if self.precision == "int8":
            self._clips += n_clip
        # Read before write: ``y_old`` is a view of the slot about to be
        # overwritten, so the update runs first and the slot write after it
        # (stream order on the card, program order on the CPU).  The new
        # window's first column is the new one only when the ring has one
        # slot.
        y_old = self._buf[slot]
        y_first = codes if new_start == slot else self._buf[new_start]
        self._moments, stats = stats_update_lib.stats_update(
            self._moments, codes, y_old, y_first, codes, new_len, evict,
            scale=self.scale if self.precision == "int8" else None)
        self._buf[slot] = codes
        self._pos = (slot + 1) % self.capacity
        self._len = new_len
        self._stats = stats
        self._t3_logical = None
        self.version += 1
        self.appends += 1
        return self

    def snapshot(self) -> ArchiveSnapshot:
        """Pin the current version for an in-flight batch (tiled stage)."""
        return ArchiveSnapshot(
            key=self.key, version=self.version, host=self.host,
            prices=self.prices, vcpus=self.vcpus, memory_gb=self.memory_gb,
            stats=self.score_stats(), window_len=self._len,
            precision=self.precision, scale=self.scale, stale=self.stale)

    # -- engine-facing surface ---------------------------------------------

    def score_stats(self) -> scoring.CandidateStats:
        """Eq. 3 statistics of the current window, O(K)-maintained: derived
        from the seed moments at version 0, from kernel B3 after that."""
        if self._stats is None:
            m = self._moments
            y_first = self._decode_col(self._buf[self._start])
            y_last = self._decode_col(
                self._buf[(self._pos - 1) % self.capacity])
            self._stats = scoring.stats_from_moments(
                m.s0 + m.s0c, m.s1 + m.s1c, m.q + m.qc, y_first, y_last,
                self._len, m.ref)
        return self._stats

    def _decode_col(self, col: torch.Tensor) -> torch.Tensor:
        """Stored ring slot -> float32 (the dequantize multiply on int8)."""
        col = col.to(torch.float32)
        return col * self.scale if self.precision == "int8" else col

    @property
    def t3(self) -> torch.Tensor:
        """The logical (K, window_len) float32 window, oldest first:
        gathered on the device from the ring and memoised per version."""
        if self._t3_logical is None:
            order = (self._start + np.arange(self._len)) % self.capacity
            stored = self._buf[torch.as_tensor(order, device=self.device)].T
            self._t3_logical = compression.dequantize_window(
                stored, self.scale, self.precision).contiguous()
        return self._t3_logical

    def materialize(self) -> np.ndarray:
        """Host copy of the logical window (parity tests, re-staging)."""
        return self.t3.cpu().numpy()

    @property
    def nbytes(self) -> int:
        """Every resident device byte: ring, catalog columns, moments, scale,
        and whatever is memoised now (statistics, gathered window)."""
        n = sum(int(a.nbytes) for a in
                (self._buf, self.prices, self.vcpus, self.memory_gb))
        n += self._moments.nbytes
        if self.scale is not None:
            n += int(self.scale.nbytes)
        if self._stats is not None:
            n += sum(int(a.nbytes) for a in self._stats)
        if self._t3_logical is not None:
            n += int(self._t3_logical.nbytes)
        return n
