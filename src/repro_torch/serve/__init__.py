"""Serving layer over the recommendation engine (paper §4).

- :class:`DeviceArchive` — a candidate archive staged once on a device,
  with memoised Eq. 3 statistics; :class:`QuantizedDeviceArchive` — the
  same with the window stored as int8 or bf16 codes.
- :class:`ArchiveCache` — an LRU of staged archives keyed by content.
- :class:`BatchServer` — request bucketing to a ladder of padded batch
  sizes, one fused engine pass per chunk.
"""
from .archive import (  # noqa: F401
    ArchiveCache, DeviceArchive, PoolCache, QuantizedDeviceArchive,
)
from .histogram import LatencyHistogram  # noqa: F401
from .server import BatchServer, ServeStats  # noqa: F401
