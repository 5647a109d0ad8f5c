"""Collector -> rolling archive -> versioned cache: the live-ingestion loop.

PyTorch counterpart of ``repro.stream.ingest``.  :class:`LiveIngestor`
stages the collector's current scoring window once (:meth:`prime`), then
absorbs each collector tick as a single O(K) column append
(:meth:`poll` / :meth:`ingest_tick`), and keeps the serve layer's
``ArchiveCache`` membership honest across versions: the stale versioned key
is invalidated before the append and the fresh one put after it.

The collector is duck-typed: anything with ``ticks``, ``column(i)`` (the
(K,) T3 column of tick ``i``) and ``to_candidate_set(window=)`` feeds it,
such as the reference simulator's ``DataCollector``.
"""
from __future__ import annotations

import threading

from .. import convert
from ..core.config import EngineConfig
from ..parallel import compression
from ..serve.archive import ArchiveCache
from .rolling import RollingDeviceArchive


class LiveIngestor:
    """Incrementally feed a collector's archive to serving.

    Parameters
    ----------
    collector
        The live collection loop (see the module docstring).
    window : int
        Scoring-window length (columns) the served archive holds.
    cache : ArchiveCache, optional
        When given, every tick inserts the new version and drops the stale
        one.
    name : str, optional
        Stable archive identity used in the versioned keys (defaults to the
        staged window's content fingerprint).
    config : EngineConfig, optional
        When given (and ``cache`` is not), the ingestor builds its own cache
        from the config's budgets; its ``archive_precision`` /
        ``archive_headroom`` become the ring's tier unless ``precision`` /
        ``headroom`` override them.  Passing both ``cache`` and ``config``
        is an error.
    precision, headroom : optional
        Storage tier of the ring and its int8 clip slack.
    device : str | torch.device, optional
        Where the ring lives: CUDA unless ``"cpu"``.
    shards : int, optional
        When set (or when ``devices`` or ``shard_bounds`` is given),
        :meth:`prime` stages a K-sharded rolling archive
        (``repro_torch.shard.ShardedRollingArchive``): one ring per shard,
        every tick split across the shards under one version bump.  The
        rest of the loop is unchanged.
    devices : sequence, optional
        Devices the shards round-robin over (default: ``device`` alone).
    shard_bounds : sequence of (start, end), optional
        An explicit contiguous partition of the candidate axis
        (``repro_torch.shard.check_bounds``) instead of the balanced split;
        region-sharded serving pins one shard per region this way.
    """

    def __init__(self, collector, *, window: int,
                 cache: ArchiveCache | None = None, name: str | None = None,
                 shards: int | None = None, devices=None,
                 config: EngineConfig | None = None,
                 precision: str | None = None,
                 headroom: float | None = None,
                 shard_bounds=None, device=None):
        if window < 1:
            raise ValueError("window must be >= 1")
        if shards is not None and shards < 1:
            raise ValueError("shards must be >= 1")
        if shard_bounds is not None:
            shard_bounds = tuple((int(a), int(b)) for a, b in shard_bounds)
        if config is not None:
            if cache is not None:
                raise TypeError("pass either cache= or config=, not both")
            cache = config.build_cache(device=device)
        if precision is None:
            precision = (config.archive_precision if config is not None
                         else "float32")
        if headroom is None:
            headroom = (config.archive_headroom if config is not None
                        else 1.0)
        self.collector = collector
        self.window = window
        self.cache = cache
        self.precision = compression.resolve_precision(precision)
        self.headroom = headroom
        self.device = device
        self._name = name
        self._shards = shards
        self._devices = devices
        self._shard_bounds = shard_bounds
        self.archive = None   # RollingDeviceArchive | ShardedRollingArchive
        self._ingested = 0                    # collector ticks absorbed

    def prime(self):
        """Cold start: stage the current window as the rolling archive.

        The one place the O(K*T) path runs (upload and exact moment
        seeding); every later tick is O(K).  Re-priming replaces the archive
        and its cache entry.
        """
        if self.collector.ticks < 1:
            raise ValueError("collector has no completed ticks to stage")
        old_key = self.archive.key if self.archive is not None else None
        cands = convert.as_candidate_set(
            self.collector.to_candidate_set(window=self.window))
        if (self._shards is not None or self._devices is not None
                or self._shard_bounds is not None):
            from ..shard import ShardedRollingArchive
            self.archive = ShardedRollingArchive(
                cands, capacity=self.window, name=self._name,
                n_shards=self._shards,
                devices=(self._devices if self._devices is not None
                         else [self.device]),
                precision=self.precision, headroom=self.headroom,
                bounds=self._shard_bounds)
        else:
            self.archive = RollingDeviceArchive(
                cands, capacity=self.window, name=self._name,
                device=self.device, precision=self.precision,
                headroom=self.headroom)
        self._ingested = self.collector.ticks
        if self.cache is not None:
            if old_key is not None:
                self.cache.invalidate(old_key)
            self.cache.put(self.archive)
        return self.archive

    @property
    def version(self) -> int:
        return -1 if self.archive is None else self.archive.version

    @property
    def lag(self) -> int:
        """Collector ticks not yet absorbed into the served archive."""
        return self.collector.ticks - self._ingested

    def ingest_tick(self):
        """Absorb exactly one pending collector tick (O(K))."""
        if self.archive is None:
            raise RuntimeError("prime() the ingestor before ingesting ticks")
        if self.lag <= 0:
            raise RuntimeError("no pending collector tick to ingest")
        # Invalidate the stale key before the in-place append: the cache
        # entry is this same mutable object, so dropping it afterwards would
        # leave a moment where the old version's key serves the new window.
        if self.cache is not None:
            self.cache.invalidate(self.archive.key)
        self.archive.append(self.collector.column(self._ingested))
        self._ingested += 1
        self.archive.stale = False
        if self.cache is not None:
            self.cache.put(self.archive)
        return self.archive

    def poll(self) -> int:
        """Absorb every pending collector tick; return how many."""
        n = self.lag
        for _ in range(n):
            self.ingest_tick()
        return n

    def mark_stale(self) -> None:
        """Flag the served archive as stale (its feed stopped delivering).

        The archive keeps serving, but every snapshot taken from here on
        carries ``stale=True`` and drains stamp a ``stale_archive``
        diagnostic; the next successful :meth:`ingest_tick` or
        :meth:`prime` clears the flag.
        """
        if self.archive is not None:
            self.archive.stale = True


class IngestPump:
    """Daemon thread driving collect -> ``LiveIngestor.poll`` on a cadence.

    ``collect`` is the hook that advances the collector by one tick;
    ``period`` the wall-clock cadence in seconds (``0`` pumps as fast as the
    loop allows).  Exceptions from the hook or the poll are counted
    (``errors``) and the first is kept in ``last_error``: a flaky tick must
    not kill the pump.  The three counters are written only under
    ``_stats_lock``.
    """

    def __init__(self, ingestor: LiveIngestor, collect, *,
                 period: float = 0.0):
        if period < 0:
            raise ValueError("period must be >= 0")
        self.ingestor = ingestor
        self.collect = collect
        self.period = period
        self.errors = 0
        self.last_error: BaseException | None = None
        self.ticks_pumped = 0
        self._stats_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.collect()
                pumped = self.ingestor.poll()
                with self._stats_lock:
                    self.ticks_pumped += pumped
            except Exception as e:  # flaky tick: count, keep pumping
                with self._stats_lock:
                    self.errors += 1
                    if self.last_error is None:
                        self.last_error = e
            if self._stop.wait(self.period):
                return

    def start(self) -> "IngestPump":
        if self.running:
            raise RuntimeError("pump already running")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Signal the loop and join the thread (no-op if never started)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError("ingest pump failed to stop in time")
            self._thread = None

    def __enter__(self) -> "IngestPump":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
