"""Closed-loop latency harness: arrival replay over a virtual clock.

The throughput benchmarks answer "how many requests per second can one
dispatch sustain"; this harness answers the production question — **what
latency does a request actually see** when arrivals are a process, batching
is deadline-driven, and the server is sometimes behind.

The trick that makes the measurement both realistic and reproducible is
*virtual time with real service costs*:

- arrivals come from a deterministic process (``repro_torch.loadgen.arrivals``)
  replayed on a :class:`VirtualClock` the admission queue is constructed
  with — a 60-second diurnal cycle costs 60 *virtual* seconds;
- every drain's service time is the **measured wall time** of the real
  ``BatchServer.serve`` call (the device pass and its device-to-host copies),
  injected into the virtual timeline by :class:`_TimedServer` *before* the
  drain resolves its tickets — so end-to-end ticket latency =
  virtual queueing delay + real service time.

This is a discrete-event simulation whose service-time distribution is the
real system, which is exactly what a latency SLO is about: the p99 numbers
move when the kernels, the bucketing, or the admission policy change, and
do not move when the wall-clock duration of the *experiment* does.  A
wall-clock mode (``realtime=True``) drives the same queue with
``time.monotonic`` and the background worker instead, for soak runs against
a live ingestor.

Overload is a first-class scenario: construct the harness with
``shed_depth`` and the queue answers past-saturation traffic from the
degraded pool-cache tier (see ``repro_torch.stream.admission``) — the report then
splits latency into full-path and shed histograms so "p99 of non-shed
requests" is directly checkable against an SLO.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..serve.histogram import LatencyHistogram
from ..serve.server import BatchServer
from ..stream.admission import AdmissionQueue
from .arrivals import Arrivals
from .workload import RequestMix


class VirtualClock:
    """A settable monotonic clock; the queue and harness share one."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError("clock cannot run backwards")
        self.t += dt


class _TimedServer:
    """BatchServer proxy: measured serve wall time -> virtual clock.

    Advancing the clock *inside* ``serve`` (after the real call returns,
    before the drain resolves tickets) is what folds real service cost into
    the virtual timeline — the queue's resolve-time ``clock()`` then reads
    drain start + service duration.  ``scale`` rescales measured service
    time (emulate faster/slower hardware without re-tuning arrival rates).
    """

    def __init__(self, inner: BatchServer, clock: VirtualClock,
                 scale: float = 1.0):
        self.inner = inner
        self.clock = clock
        self.scale = scale
        self.batch_latency = LatencyHistogram()   # real wall time per call

    @property
    def bucket_sizes(self):
        return self.inner.bucket_sizes

    @property
    def stats(self):
        return self.inner.stats

    def serve(self, target, requests, **kw):
        t0 = time.perf_counter()
        out = self.inner.serve(target, requests, **kw)
        dt = time.perf_counter() - t0
        self.batch_latency.record(dt)
        self.clock.advance(dt * self.scale)
        return out


@dataclass
class LoadReport:
    """One scenario's outcome: counters + the three latency histograms."""

    name: str
    horizon_s: float
    offered_rate: float             # arrivals/s the process targeted
    submitted: int
    served: int                     # resolved via the full batch path
    shed: int                       # resolved degraded from the pool cache
    drains: int
    errors: int
    latency: LatencyHistogram       # end-to-end, full-path (non-shed) tickets
    shed_latency: LatencyHistogram  # end-to-end, degraded tickets
    batch_latency: LatencyHistogram  # real serve-call wall time per drain
    extra: dict = field(default_factory=dict)

    @property
    def dropped(self) -> int:
        """Tickets that resolved neither full nor degraded — must be 0."""
        return self.submitted - self.served - self.shed

    def percentiles(self) -> dict:
        return self.latency.percentiles()

    def to_dict(self) -> dict:
        return {
            "name": self.name, "horizon_s": self.horizon_s,
            "offered_rate": round(self.offered_rate, 3),
            "submitted": self.submitted, "served": self.served,
            "shed": self.shed, "drains": self.drains, "errors": self.errors,
            "dropped": self.dropped,
            "latency": self.latency.percentiles(),
            "shed_latency": self.shed_latency.percentiles(),
            "batch_latency": self.batch_latency.percentiles(),
            **self.extra,
        }


class LoadHarness:
    """Drive one ``BatchServer`` + archive with arrival-process traffic.

    Parameters mirror :class:`~repro_torch.stream.AdmissionQueue` where they
    overlap; each :meth:`run` builds a **fresh** queue (and virtual clock)
    so scenarios never share queue state, while the server — and therefore
    its built kernels and staged archives — is reused across runs, like a
    warm production process.
    """

    def __init__(self, server: BatchServer, archive_source, *,
                 max_wait_s: float = 0.05, max_pending: int | None = None,
                 adaptive: bool = True, shed_depth: int | None = None,
                 pool_cache=None, service_time_scale: float = 1.0):
        self.server = server
        self.archive_source = archive_source
        self.max_wait_s = max_wait_s
        self.max_pending = max_pending
        self.adaptive = adaptive
        self.shed_depth = shed_depth
        self.pool_cache = pool_cache    # share/warm the degraded-tier memo
        self.service_time_scale = service_time_scale

    def _build_queue(self, clock) -> AdmissionQueue:
        timed = _TimedServer(self.server, clock,
                             scale=self.service_time_scale)
        return AdmissionQueue(
            timed, self.archive_source, max_wait_s=self.max_wait_s,
            max_pending=self.max_pending, clock=clock,
            adaptive=self.adaptive, shed_depth=self.shed_depth,
            pool_cache=self.pool_cache)

    def warmup(self, workload: RequestMix, rng=None) -> int:
        """Serve every ladder bucket once before the measured run.

        Serves one batch per ladder bucket straight through the inner
        server (no queue, no stats pollution of the virtual run beyond the
        shared ``ServeStats``).  Without this, the first drain would pay
        the kernels' first build (nvcc) and each bucket its first
        allocations inside its measured service time —
        a cold-start artifact the SLO story should report separately, not
        fold into p99.  Returns the number of warmup requests served.
        """
        rng = np.random.default_rng(0) if rng is None else rng
        queue = self._build_queue(VirtualClock())
        archive = queue.resolve_archive()
        n = 0
        for bucket in self.server.bucket_sizes:
            reqs = [workload.sample(rng) for _ in range(bucket)]
            self.server.serve(archive, reqs)
            n += bucket
        return n

    def warm_pool_cache(self, workload: RequestMix,
                        n_samples: int = 1024, rng=None) -> int:
        """Pre-populate the degraded-tier memo, like a pre-failover warm.

        Under sustained overload the shedding tier is only as good as its
        memo: a cold :class:`~repro_torch.serve.PoolCache` lets early memo-misses
        queue far past ``shed_depth`` before coverage builds up.  Samples
        the workload, dedupes by request signature, serves each novel
        signature once through the inner server, and memoizes the pools.
        Returns the number of signatures warmed.
        """
        from ..serve.archive import PoolCache
        if self.pool_cache is None:
            self.pool_cache = PoolCache()
        rng = np.random.default_rng(0) if rng is None else rng
        queue = self._build_queue(VirtualClock())
        archive = queue.resolve_archive()
        fresh, seen = [], set()
        for _ in range(n_samples):
            req = workload.sample(rng)
            sig = req.signature()
            if sig not in seen:
                seen.add(sig)
                fresh.append(req)
        bucket = max(self.server.bucket_sizes)
        for lo in range(0, len(fresh), bucket):
            chunk = fresh[lo:lo + bucket]
            for req, rec in zip(chunk, self.server.serve(archive, chunk)):
                self.pool_cache.put(req, rec)
        return len(fresh)

    def run(self, workload: RequestMix, arrivals: Arrivals,
            horizon_s: float, *, seed: int = 0,
            name: str | None = None) -> LoadReport:
        """Replay ``arrivals`` x ``workload`` for ``horizon_s`` virtual secs.

        The event loop interleaves two event kinds in virtual-time order —
        the next arrival and the queue's next due drain — exactly the two
        things that can happen to an admission queue.  Ticket latency is
        measured from the *true* arrival time (``submit(at=...)`` backdates
        admissions that land while a drain's service interval is in flight),
        so queueing behind a busy server is charged to the request, as it
        would be in wall-clock production.
        """
        rng = np.random.default_rng(seed)
        clock = VirtualClock()
        queue = self._build_queue(clock)
        times = arrivals.times(horizon_s, rng)
        tickets = []
        i = 0
        while i < len(times) or queue.pending:
            due = queue.next_due()
            # A drain whose deadline already passed fires *now* (the clock
            # never runs backwards) — and every arrival stamped before that
            # instant must be admitted first, exactly as wall-clock
            # operation would have: submits are instantaneous, drains take
            # service time.  Comparing against the raw (possibly overdue)
            # deadline instead would starve arrivals that landed during the
            # previous drain's service interval, hiding the real backlog
            # from ``max_pending``/``shed_depth``.
            fire_at = None if due is None else max(due, clock.t)
            if i < len(times) and (fire_at is None or times[i] <= fire_at):
                t_arr = float(times[i])
                clock.t = max(clock.t, t_arr)
                tickets.append(queue.submit(workload.sample(rng), at=t_arr))
                i += 1
                continue
            clock.t = max(clock.t, due)
            if queue.drain() == 0 and i >= len(times):
                queue.drain(force=True)     # tail flush, nothing left due
        errors = 0
        for t in tickets:
            if not t.done:          # cannot happen: loop drains to empty
                raise RuntimeError("undrained ticket after harness run")
            if t._error is not None:
                errors += 1
        s = queue.stats
        timed: _TimedServer = queue.server
        return LoadReport(
            name=name or f"{workload.name}/{type(arrivals).__name__.lower()}",
            horizon_s=horizon_s, offered_rate=arrivals.mean_rate(),
            submitted=s.submitted, served=s.served, shed=s.shed,
            drains=s.drains, errors=errors,
            latency=s.latency, shed_latency=s.shed_latency,
            batch_latency=timed.batch_latency,
            extra={"coalesced": s.coalesced,
                   "pool_cache_len": (len(queue.pool_cache)
                                      if queue.pool_cache is not None else 0)},
        )
