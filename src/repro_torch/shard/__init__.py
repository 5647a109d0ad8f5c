"""K-axis sharding of the candidate archive.

PyTorch counterpart of ``repro.shard``.  Splits the (instance type, AZ)
candidate axis into contiguous shards — window slices, catalog columns and
per-candidate statistics, each on its own device — and runs the batched
recommendation pipeline as per-shard phase-0 carries, an exact min/max
merge, per-shard row emission and a pool scan on the merge device.  Pools
are bit-identical to the single-device tiled path on the same device; see
:mod:`repro_torch.shard.compute` for the argument and
:mod:`repro_torch.shard.archive` for the storage layer.
"""
from .archive import (ShardedArchive, ShardedRollingArchive, ShardedSnapshot,
                      check_bounds, shard_bounds)
from .compute import sharded_batch_arrays

__all__ = [
    "ShardedArchive",
    "ShardedRollingArchive",
    "ShardedSnapshot",
    "check_bounds",
    "shard_bounds",
    "sharded_batch_arrays",
]
