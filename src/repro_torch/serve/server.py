"""Batched recommendation server: bucketing + archive cache + stats.

PyTorch counterpart of ``repro.serve.server``.  ``BatchServer.serve`` takes
the requests that arrived in one service interval, splits them into chunks
from a fixed ladder of batch sizes (padding the tail chunk up to the
smallest covering bucket), and runs each chunk through
:meth:`RecommendationEngine.recommend_batch` against a device-staged
archive.  Padded rows are computed and discarded.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..core.config import EngineConfig, resolve_engine_config
from ..core.engine import RecommendationEngine
from ..core.types import CandidateSet, Recommendation
from .histogram import LatencyHistogram

DEFAULT_BUCKETS = (1, 8, 64, 256)


def _is_archive(target) -> bool:
    """Anything engine-ready: staged arrays with the host catalog attached."""
    return hasattr(target, "host") and (hasattr(target, "score_stats")
                                        or hasattr(target, "is_sharded"))


@dataclass
class ServeStats:
    """Counters accumulated across ``serve`` calls, mutated under the
    server's stats lock.  ``latency`` holds one sample per ``serve`` call:
    batch assembly through device read-back of every chunk."""

    requests: int = 0
    batches: int = 0
    padded_slots: int = 0
    bucket_counts: dict = field(default_factory=dict)   # bucket size -> #batches
    latency: LatencyHistogram = field(default_factory=LatencyHistogram)

    def record(self, n_requests: int, bucket: int) -> None:
        self.requests += n_requests
        self.batches += 1
        self.padded_slots += bucket - n_requests
        self.bucket_counts[bucket] = self.bucket_counts.get(bucket, 0) + 1


class BatchServer:
    """Serve request batches against cached device-staged archives.

    Parameters
    ----------
    engine : RecommendationEngine, optional
        The scoring/pool engine.  Default: one built from ``config`` on
        ``device``.  An engine brings its own device.
    config : EngineConfig, optional
        The stack's tunables (engine switches, archive LRU budgets).  The
        per-knob ``pool_impl=`` / ``score_impl=`` / ``cache_capacity=``
        keyword arguments are deprecated shims.
    bucket_sizes : tuple[int, ...]
        Allowed padded batch sizes.
    device : str | torch.device, optional
        Where archives are staged and batches run: CUDA unless ``"cpu"``.
    """

    def __init__(self, engine: RecommendationEngine | None = None, *,
                 config: EngineConfig | None = None,
                 bucket_sizes: tuple[int, ...] = DEFAULT_BUCKETS,
                 device=None, cache_capacity: int | None = None,
                 pool_impl: str | None = None, score_impl: str | None = None):
        if not bucket_sizes or any(b < 1 for b in bucket_sizes):
            raise ValueError("bucket_sizes must be positive")
        if engine is not None and device is not None:
            raise ValueError("pass device= or an engine (which has one), "
                             "not both")
        self.config = resolve_engine_config(
            config, cache_capacity=cache_capacity, pool_impl=pool_impl,
            score_impl=score_impl)
        self.engine = (engine if engine is not None
                       else RecommendationEngine(config=self.config,
                                                 device=device))
        self.bucket_sizes = tuple(sorted(set(bucket_sizes)))
        self.cache = self.config.build_cache(device=self.engine.device)
        self.stats = ServeStats()
        self._stats_lock = threading.Lock()

    @property
    def result_sink(self):
        """The engine's result hook (see ``RecommendationEngine.result_sink``)."""
        return self.engine.result_sink

    @result_sink.setter
    def result_sink(self, sink):
        self.engine.result_sink = sink

    def plan_chunks(self, n: int) -> list[tuple[int, int]]:
        """Split ``n`` requests into ``(chunk_len, bucket)`` pieces.

        Pad the remainder up to the smallest covering bucket when at most
        half of that bucket would be padding; otherwise emit a full chunk of
        the largest bucket that fits and continue.
        """
        chunks = []
        while n > 0:
            cover = next((b for b in self.bucket_sizes if b >= n), None)
            fits = [b for b in self.bucket_sizes if b <= n]
            if cover is not None and (not fits or cover - n <= cover // 2):
                chunks.append((n, cover))
                break
            fit = max(fits)
            chunks.append((fit, fit))
            n -= fit
        return chunks

    def serve(self, target, requests, *,
              archive_key: str | None = None) -> list[Recommendation]:
        """Recommend pools for ``requests``; results align with the input.

        ``target`` is a host :class:`~repro_torch.core.CandidateSet` (staged
        through the LRU cache, keyed by content fingerprint or
        ``archive_key``), an already-staged :class:`DeviceArchive`, or a
        live :class:`~repro_torch.stream.RollingDeviceArchive` or its
        :class:`~repro_torch.stream.ArchiveSnapshot`.  Staged archives are
        served directly, bypassing the LRU: a rolling archive re-keys
        itself every tick, and the ingestor manages its cache membership.
        """
        requests = list(requests)
        if not requests:
            return []
        if isinstance(target, CandidateSet):
            archive = self.cache.get(target, key=archive_key)
        elif _is_archive(target):
            if getattr(target, "is_sharded", False):
                raise NotImplementedError(
                    "K-sharded archives are not ported yet (a later slice)")
            if archive_key is not None:
                raise ValueError(
                    "archive_key only applies when serving a CandidateSet; "
                    f"{type(target).__name__} already carries its key")
            archive = target
        else:
            raise TypeError(
                "serve() target must be a CandidateSet or a staged archive "
                "(DeviceArchive / rolling / snapshot), got "
                f"{type(target).__name__}")
        t0 = time.perf_counter()
        out: list[Recommendation] = []
        pos = 0
        for chunk_len, bucket in self.plan_chunks(len(requests)):
            chunk = requests[pos:pos + chunk_len]
            pos += chunk_len
            out.extend(self.engine.recommend_batch(
                archive.host, chunk, pad_to=bucket, archive=archive))
            with self._stats_lock:
                self.stats.record(chunk_len, bucket)
        with self._stats_lock:
            self.stats.latency.record(time.perf_counter() - t0)
        return out
