"""Async admission in front of :class:`~repro_torch.serve.BatchServer`.

PyTorch counterpart of ``repro.stream.admission``; the queue itself is
host code and the same as the reference's.

``BatchServer.serve`` batches whatever one *call site* hands it — the paper's
service, though, sees requests *arrive* one at a time, and the batch that
actually dispatches should be shaped by arrival time and latency budget, not
by which caller happened to hold a list.  :class:`AdmissionQueue` adds that
front:

- :meth:`submit` enqueues a request with a deadline (``now + max_wait``) and
  returns a :class:`Ticket` immediately;
- a drain fires when the earliest deadline comes due **or** the queue
  reaches the largest serve bucket — and then takes *everything* pending,
  so late arrivals coalesce into the due batch instead of waiting their own
  full ``max_wait`` (arrival batching, not call-site batching);
- every drain serves against **one** version-pinned snapshot of the live
  archive taken at drain start, so a collector tick landing mid-drain can
  never mix two windows inside a batch; the served version is stamped into
  each result's diagnostics.

Latency under load (the SLO story) adds two opt-in behaviors:

- **Adaptive drain sizing** (``adaptive=True``): a drain takes at most the
  largest serve bucket, earliest-deadline first, instead of the whole
  backlog.  One drain therefore maps to one serve bucket, and the
  most-overdue tickets resolve
  after one service time instead of after the entire backlog clears — under
  saturation the worker fires back-to-back full-bucket drains, which is the
  throughput-optimal schedule anyway.
- **Shedding with a degraded tier** (``shed_depth=N``): once the queue holds
  N tickets, a newly submitted request whose signature has a memoized pool
  (:class:`~repro_torch.serve.PoolCache`, fed by every successful drain) resolves
  *immediately* with that cached pool, flagged ``degraded`` — bounding both
  the queue depth and the tail latency of the requests that do queue.  A
  signature with no memo entry queues normally: **no ticket is ever
  dropped**, every submit resolves exactly once, degraded or full.

End-to-end latency (submit -> resolve, queueing + service) streams into
``AdmissionStats.latency`` (full-path) and ``.shed_latency`` (degraded),
lock-guarded like every other counter here.

The queue is deterministic by construction (injectable ``clock``, explicit
:meth:`pump`), which is what the tests and a load harness drive; :meth:`start` spins the same logic on a daemon
thread for wall-clock operation, and ticket ``result()`` falls back to a
synchronous force-drain when no worker is running.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..serve.archive import PoolCache
from ..serve.histogram import LatencyHistogram
from ..serve.server import BatchServer

DEFAULT_MAX_WAIT_S = 0.05


class Ticket:
    """Handle for one admitted request; resolves when its drain completes."""

    __slots__ = ("request", "deadline", "submitted_at", "_queue", "_event",
                 "_result", "_error")

    def __init__(self, request, deadline: float, queue: "AdmissionQueue",
                 submitted_at: float = 0.0):
        self.request = request
        self.deadline = deadline
        self.submitted_at = submitted_at
        self._queue = queue
        self._event = threading.Event()
        self._result = None
        self._error = None

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        """The :class:`~repro_torch.core.types.Recommendation` for this request.

        With a background worker running, blocks until the drain that picks
        this ticket up completes (or ``timeout`` expires).  Without one,
        synchronously force-drains the queue — the no-thread mode used by
        scripts and tests.
        """
        if not self._event.is_set() and not self._queue.running:
            self._queue.drain(force=True)
        if not self._event.wait(timeout):
            raise TimeoutError("admission ticket not served within timeout")
        if self._error is not None:
            raise self._error
        return self._result

    def _resolve(self, result=None, error=None) -> None:
        self._result = result
        self._error = error
        self._event.set()


@dataclass
class AdmissionStats:
    """Counters accumulated across drains.

    Mutated only under the queue's lock (``submit`` and the tail of
    ``drain`` both hold it), so concurrent submitters, the worker thread,
    and direct ``drain`` callers never lose an increment.

    The ledger balances by construction: every submitted request ends in
    exactly one of ``served`` (full path), ``shed`` (degraded tier), or
    ``failed`` (its drain's dispatch raised; the ticket resolved carrying
    the error) — ``submitted == served + shed + failed`` once the queue is
    empty.  ``latency`` holds end-to-end submit->resolve times for
    full-path requests, ``shed_latency`` for degraded ones (resolved at
    submit, so ~0 unless the caller backdated the arrival).
    """

    submitted: int = 0
    served: int = 0
    shed: int = 0               # resolved degraded from the PoolCache
    failed: int = 0             # resolved with their drain's dispatch error
    drains: int = 0
    failed_drains: int = 0      # drains whose dispatch raised (no ticket hung)
    forced_drains: int = 0      # force=True (shutdown / sync Ticket.result)
    coalesced: int = 0          # rode a *due* drain before their own deadline
    versions: dict = field(default_factory=dict)   # archive key -> #requests
    latency: LatencyHistogram = field(default_factory=LatencyHistogram)
    shed_latency: LatencyHistogram = field(default_factory=LatencyHistogram)

    def record_drain(self, n: int, n_early: int, key: str,
                     forced: bool = False, latencies=()) -> None:
        self.drains += 1
        self.served += n
        if forced:
            # A forced drain takes everything by definition — counting its
            # not-yet-due tickets as "coalesced" would credit the arrival
            # batching for work the force carve-out did (the sync
            # Ticket.result fallback used to inflate the counter this way).
            self.forced_drains += 1
        else:
            self.coalesced += n_early
        self.versions[key] = self.versions.get(key, 0) + n
        for lat in latencies:
            self.latency.record(lat)


class AdmissionQueue:
    """Deadline-batched arrival queue over a ``BatchServer``.

    Parameters
    ----------
    server : BatchServer
        The batching executor drains dispatch through
        (:meth:`BatchServer.serve`).
    archive_source
        Where a drain gets its archive: a :class:`RollingDeviceArchive` (or
        any object with ``snapshot()`` — the snapshot pins the version for
        the whole drain), a plain ``DeviceArchive``, or a zero-arg callable
        returning either (e.g. ``lambda: ingestor.archive``).
    max_wait_s : float
        Default admission deadline: a request waits at most this long
        before the batch it joined dispatches.
    max_pending : int, optional
        Queue length that triggers an immediate drain (default: the
        server's largest bucket — a full batch gains nothing by waiting).
        Must be >= 1: a threshold of 0 would make every pump/loop pass
        "due" with an empty queue and busy-drain nothing forever.
    clock : callable
        Monotonic time source (tests and the load harness inject a fake).
    adaptive : bool
        Deadline- and depth-aware drain sizing: a non-forced drain takes at
        most ``max(server.bucket_sizes)`` tickets, earliest deadline first
        (see the module docstring).  Off by default — the take-everything
        coalescing drain is the right shape for bursty low-rate traffic.
    shed_depth : int, optional
        Backpressure threshold: submits arriving while the queue holds this
        many tickets are answered from the degraded pool-cache tier when
        their signature has a memoized pool (and queue normally otherwise —
        zero drops).  ``None`` disables shedding.
    pool_cache : PoolCache, optional
        The degraded tier's memo.  A default one is built when
        ``shed_depth`` is set; pass one explicitly to share it across
        queues or to warm it ahead of a failover.
    """

    def __init__(self, server: BatchServer, archive_source, *,
                 max_wait_s: float = DEFAULT_MAX_WAIT_S,
                 max_pending: int | None = None, clock=time.monotonic,
                 adaptive: bool = False, shed_depth: int | None = None,
                 pool_cache: PoolCache | None = None):
        if max_wait_s < 0:
            raise ValueError("max_wait_s must be >= 0")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if shed_depth is not None and shed_depth < 1:
            raise ValueError(f"shed_depth must be >= 1, got {shed_depth}")
        self.server = server
        self._source = archive_source
        self.max_wait_s = max_wait_s
        self.max_pending = (max(server.bucket_sizes) if max_pending is None
                            else max_pending)
        self.clock = clock
        self.adaptive = adaptive
        self.shed_depth = shed_depth
        self.pool_cache = (pool_cache if pool_cache is not None
                           else PoolCache() if shed_depth is not None
                           else None)
        self.stats = AdmissionStats()
        self._pending: list[Ticket] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._worker: threading.Thread | None = None
        self._stopping = False

    # -- admission ---------------------------------------------------------

    def submit(self, request, *, max_wait_s: float | None = None,
               at: float | None = None) -> Ticket:
        """Admit one request; returns immediately with its :class:`Ticket`.

        ``at`` backdates the arrival (deadline and latency accounting start
        there instead of ``clock()``) — the load harness uses this to stamp
        a request that arrived *during* a simulated service interval with
        its true arrival time.  Must not be in the future.

        When the queue is at ``shed_depth``, the degraded tier may resolve
        the ticket immediately (see the class docstring); the returned
        ticket is then already ``done`` with ``diagnostics["degraded"]``
        set.
        """
        wait = self.max_wait_s if max_wait_s is None else max_wait_s
        now = self.clock() if at is None else at
        ticket = Ticket(request, now + wait, self, submitted_at=now)
        with self._wake:
            if (self.shed_depth is not None
                    and len(self._pending) >= self.shed_depth):
                rec = self.pool_cache.get(request)
                if rec is not None:
                    rec.diagnostics["shed_queue_depth"] = len(self._pending)
                    self.stats.submitted += 1
                    self.stats.shed += 1
                    self.stats.shed_latency.record(
                        max(0.0, self.clock() - now))
                    ticket._resolve(result=rec)
                    return ticket
            self._pending.append(ticket)
            self.stats.submitted += 1
            self._wake.notify()
        return ticket

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    @property
    def running(self) -> bool:
        return self._worker is not None and self._worker.is_alive()

    def due(self, now: float | None = None) -> bool:
        """Should a drain fire now?  (earliest deadline hit, or queue full)"""
        now = self.clock() if now is None else now
        with self._lock:
            return bool(self._pending) and (
                len(self._pending) >= self.max_pending
                or min(t.deadline for t in self._pending) <= now)

    def next_due(self) -> float | None:
        """Earliest time a drain becomes due; ``None`` when nothing pends.

        ``clock()`` (i.e. "now") when the queue is already full.  The load
        harness advances its virtual clock to exactly this instant.
        """
        with self._lock:
            if not self._pending:
                return None
            if len(self._pending) >= self.max_pending:
                return self.clock()
            return min(t.deadline for t in self._pending)

    # -- drain -------------------------------------------------------------

    def resolve_archive(self):
        """The archive a drain fired now would serve against.

        Snapshots a live source (anything with ``snapshot()``) so the
        version is pinned for the whole drain; public so a caller can warm
        up against exactly this operand.
        """
        src = self._source() if callable(self._source) else self._source
        if src is None:
            raise RuntimeError("archive_source produced no archive "
                               "(ingestor not primed?)")
        snap = getattr(src, "snapshot", None)
        return snap() if snap is not None else src

    def pump(self, now: float | None = None) -> int:
        """Drain iff due; returns requests served.  The test-mode heartbeat."""
        return self.drain(now=now) if self.due(now) else 0

    def drain(self, now: float | None = None, *, force: bool = False) -> int:
        """Serve pending tickets against one version-pinned snapshot.

        Coalescing: a non-adaptive drain takes the whole queue, not just the
        due tickets — a request submitted a microsecond ago rides along with
        the batch whose deadline fired.  An ``adaptive`` drain caps the
        batch at the largest serve bucket, earliest deadline first, leaving
        the remainder pending for the immediately-following drain.
        ``force`` drains everything even when nothing is due (shutdown,
        synchronous ``Ticket.result``).

        A failing dispatch does **not** strand its batch or kill the
        caller's loop: every popped ticket resolves carrying the error
        (``Ticket.result`` re-raises it), one ``failed_drains`` is counted,
        and the drain returns the batch size like any other — the daemon
        worker and direct callers both live to drain again.
        """
        now = self.clock() if now is None else now
        with self._lock:
            if not self._pending or not (force or any(
                    t.deadline <= now for t in self._pending)
                    or len(self._pending) >= self.max_pending):
                return 0
            cap = max(self.server.bucket_sizes)
            if not force and self.adaptive and len(self._pending) > cap:
                order = sorted(range(len(self._pending)),
                               key=lambda i: self._pending[i].deadline)
                take = set(order[:cap])
                batch = [t for i, t in enumerate(self._pending) if i in take]
                self._pending = [t for i, t in enumerate(self._pending)
                                 if i not in take]
            else:
                batch, self._pending = self._pending, []
        try:
            archive = self.resolve_archive()
            recs = self.server.serve(archive, [t.request for t in batch])
        except Exception as err:  # noqa: BLE001 — fail the tickets, not the loop
            with self._lock:
                self.stats.drains += 1
                self.stats.failed_drains += 1
                self.stats.failed += len(batch)
                if force:
                    self.stats.forced_drains += 1
            for t in batch:
                t._resolve(error=err)
            return len(batch)
        n_early = sum(1 for t in batch if t.deadline > now)
        key = getattr(archive, "key", "?")
        version = getattr(archive, "version", None)
        stale = bool(getattr(archive, "stale", False))
        done = self.clock()     # after service: end-to-end, not queueing-only
        latencies = []
        for t, rec in zip(batch, recs):
            rec.diagnostics["archive_key"] = key
            rec.diagnostics["degraded"] = False
            rec.diagnostics["stale_archive"] = stale
            if version is not None:
                rec.diagnostics["archive_version"] = version
            if self.pool_cache is not None:
                self.pool_cache.put(t.request, rec)
            latencies.append(max(0.0, done - t.submitted_at))
            t._resolve(result=rec)
        with self._lock:        # stats share the drain lock (see AdmissionStats)
            self.stats.record_drain(len(batch), n_early, key, forced=force,
                                    latencies=latencies)
        return len(batch)

    # -- background operation ----------------------------------------------

    def start(self) -> "AdmissionQueue":
        """Run the drain loop on a daemon thread (wall-clock mode)."""
        if self.running:
            return self
        self._stopping = False
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="admission-drain")
        self._worker.start()
        return self

    def stop(self, *, drain: bool = True) -> None:
        """Stop the worker; optionally force-drain what's left."""
        with self._wake:
            self._stopping = True
            self._wake.notify()
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if drain:
            self.drain(force=True)

    def _loop(self) -> None:
        while True:
            with self._wake:
                if self._stopping:
                    return
                if not self._pending:
                    self._wake.wait(timeout=0.2)
                    continue
                timeout = max(0.0, min(t.deadline for t in self._pending)
                              - self.clock())
                if timeout > 0 and len(self._pending) < self.max_pending:
                    self._wake.wait(timeout=min(timeout, 0.2))
                    continue
            try:
                self.drain()
            except Exception:  # noqa: BLE001 — belt-and-braces: drain already
                pass           # resolves its batch and swallows dispatch errors
