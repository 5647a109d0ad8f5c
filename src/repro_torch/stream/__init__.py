"""Live ingestion: streaming collector -> serving pipeline.

PyTorch counterpart of ``repro.stream``:

    collector  --one (K,) column per tick-->  LiveIngestor
        -> RollingDeviceArchive.append     (in-place ring slot write, O(K))
        -> kernels.stats_update            (kernel B3: rank-1 Eq. 3 update)
        -> versioned key put/invalidate    (ArchiveCache never serves stale)
    AdmissionQueue.submit -> deadline/size-triggered drains
        -> ArchiveSnapshot (version-pinned)  -> BatchServer.serve

Nothing O(K*T) runs after :meth:`LiveIngestor.prime`.
"""
from .admission import AdmissionQueue, AdmissionStats, Ticket  # noqa: F401
from .ingest import IngestPump, LiveIngestor  # noqa: F401
from .rolling import ArchiveSnapshot, RollingDeviceArchive  # noqa: F401
