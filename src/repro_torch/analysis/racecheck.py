"""Dynamic race sanitizer for the port's threaded serving / operator paths.

PyTorch counterpart of ``repro.analysis.racecheck``; pure stdlib, so it is
the same code, and the port's threaded classes keep the reference's lock
attribute names (``BatchServer._stats_lock``, ``AdmissionQueue._lock`` /
``_wake``, ``IngestPump._stats_lock``, ``FaultInjectedServer._inject_lock``,
``PoolCMDB._lock``), so the helpers below wire into either package's
objects.

The static half (SPL003) proves each *lexical* write site sits under a
``with <lock>`` — it cannot see aliasing, delegation, or lock-order
inversions.  This module closes that gap at runtime:

- :class:`LockRegistry` hands out :class:`InstrumentedLock` proxies for the
  real serving locks.  Every acquisition records an edge from each lock the
  acquiring thread already holds to the one it is taking; a **cycle** in
  that graph is a potential deadlock even if the run happened not to hang.
- :meth:`LockRegistry.guard` patches the guarded object's class
  ``__setattr__`` so every write to a mapped field checks that one of the
  mapped locks is held by the writing thread — a write without it is a
  **race report**, even when the racy interleaving did not corrupt anything
  this run.

The instrumentation helpers (:func:`instrument_admission_queue` etc.) wire
the proxies into the real objects *before their worker threads start*; a
test then runs its threaded scenario and fails on any report.  Nothing
here imports torch: the sanitizer runs wherever the threads do, the card's
admission worker and ingest pump included.

CPython compatibility note: ``threading.Condition`` only requires its lock
to expose ``acquire``/``release`` (it probes ownership with a non-blocking
``acquire(0)`` when the lock has no ``_is_owned``), so an
:class:`InstrumentedLock` works as a Condition's lock; the admission
queue's ``_wake`` condition is rebuilt around the proxy.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field


@dataclass(frozen=True)
class RaceReport:
    """One unguarded write observed at runtime."""

    obj: str            # e.g. "AdmissionStats"
    attr: str           # field written
    thread: str         # writing thread's name
    required: tuple     # lock names, any of which would have been fine
    held: tuple         # lock names actually held at the write

    def format(self) -> str:
        held = ", ".join(self.held) if self.held else "none"
        return (f"unguarded write: {self.obj}.{self.attr} from thread "
                f"{self.thread!r} requires one of {list(self.required)} "
                f"(held: {held})")


@dataclass
class _Guard:
    obj: object
    fields: frozenset
    locks: frozenset
    label: str


class InstrumentedLock:
    """Proxy around a ``Lock``/``RLock`` that reports to a registry.

    Supports the full lock protocol (context manager, ``acquire`` with
    ``blocking``/``timeout``) plus re-entrant acquisition when the inner
    lock allows it; held/edge bookkeeping only happens on *successful*
    acquisitions, so `Condition`'s non-blocking ownership probes stay
    invisible when they fail.
    """

    def __init__(self, registry: "LockRegistry", inner, name: str):
        self._registry = registry
        self._inner = inner
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1):
        self._registry._before_acquire(self.name)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._registry._on_acquired(self.name)
        return got

    def release(self):
        self._inner.release()
        self._registry._on_released(self.name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        locked = getattr(self._inner, "locked", None)
        return locked() if locked is not None else False


class LockRegistry:
    """Acquisition-order graph + guarded-field write checker.

    One registry per run; :meth:`close` unpatches every ``__setattr__``
    it installed (call it in a ``finally``).
    """

    def __init__(self):
        self._tls = threading.local()
        self._mu = threading.Lock()          # protects everything below
        self._edges: set[tuple[str, str]] = set()
        self._reports: list[RaceReport] = []
        self._guards: dict[int, _Guard] = {}
        self._patched: dict[type, object] = {}   # class -> original __setattr__

    # -- lock wrapping -----------------------------------------------------

    def wrap(self, lock, name: str) -> InstrumentedLock:
        """Wrap a real lock; callers re-bind the owning attribute."""
        return InstrumentedLock(self, lock, name)

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def held_now(self) -> tuple:
        """Names of instrumented locks held by the calling thread."""
        return tuple(self._stack())

    def _before_acquire(self, name: str) -> None:
        held = self._stack()
        if name in held:        # re-entrant RLock acquire orders nothing
            return
        if held:
            with self._mu:
                self._edges.update((h, name) for h in held if h != name)

    def _on_acquired(self, name: str) -> None:
        self._stack().append(name)

    def _on_released(self, name: str) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    # -- guarded-field writes ----------------------------------------------

    def guard(self, obj, *, fields, locks, label: str | None = None) -> None:
        """Require one of ``locks`` (by proxy name) held for writes to
        ``fields`` of ``obj``.  Patches ``type(obj).__setattr__`` once per
        class; only registered instances are checked."""
        cls = type(obj)
        with self._mu:
            self._guards[id(obj)] = _Guard(
                obj=obj, fields=frozenset(fields), locks=frozenset(locks),
                label=label or cls.__name__)
            if cls not in self._patched:
                self._patched[cls] = cls.__setattr__
                cls.__setattr__ = self._make_setattr(cls.__setattr__)

    def _make_setattr(self, orig):
        registry = self

        def __setattr__(obj, attr, value):
            guard = registry._guards.get(id(obj))
            if guard is not None and attr in guard.fields:
                held = registry.held_now()
                if not (guard.locks & set(held)):
                    report = RaceReport(
                        obj=guard.label, attr=attr,
                        thread=threading.current_thread().name,
                        required=tuple(sorted(guard.locks)),
                        held=held)
                    with registry._mu:
                        registry._reports.append(report)
            orig(obj, attr, value)

        return __setattr__

    # -- verdicts ----------------------------------------------------------

    def cycles(self) -> list[list[str]]:
        """Elementary cycles in the acquisition-order graph (DFS)."""
        with self._mu:
            edges = sorted(self._edges)
        adj: dict[str, list[str]] = {}
        for a, b in edges:
            adj.setdefault(a, []).append(b)
        found: list[list[str]] = []
        seen_keys: set[tuple] = set()

        def dfs(node: str, path: list[str], on_path: set[str]):
            for nxt in adj.get(node, ()):
                if nxt in on_path:
                    cyc = path[path.index(nxt):] + [nxt]
                    key = frozenset(cyc)
                    if key not in seen_keys:
                        seen_keys.add(key)
                        found.append(cyc)
                    continue
                on_path.add(nxt)
                dfs(nxt, path + [nxt], on_path)
                on_path.discard(nxt)

        for start in adj:
            dfs(start, [start], {start})
        return found

    def race_reports(self) -> list[RaceReport]:
        with self._mu:
            return list(self._reports)

    def edges(self) -> list[tuple[str, str]]:
        with self._mu:
            return sorted(self._edges)

    def problems(self) -> list[str]:
        out = [r.format() for r in self.race_reports()]
        out.extend("potential deadlock: lock-order cycle " + " -> ".join(c)
                   for c in self.cycles())
        return out

    def assert_clean(self) -> None:
        problems = self.problems()
        if problems:
            raise AssertionError(
                "racecheck: " + "; ".join(problems))

    def close(self) -> None:
        """Restore every patched ``__setattr__`` and drop guard refs."""
        with self._mu:
            for cls, orig in self._patched.items():
                cls.__setattr__ = orig
            self._patched.clear()
            self._guards.clear()


# -- instrumentation helpers for the port's threaded objects ----------------
#
# Each helper swaps the object's real lock for a named proxy and registers
# its guarded stats fields.  Call BEFORE starting worker threads.

_COUNTER_TYPES = (int, float, bool, str, bytes, type(None), BaseException)


def _scalar_fields(obj) -> tuple:
    return tuple(k for k, v in vars(obj).items()
                 if isinstance(v, _COUNTER_TYPES))


def guard_stats(registry: LockRegistry, stats, locks, *,
                label: str | None = None, histogram_attrs=("latency",)):
    """Guard every scalar counter of a stats dataclass, plus the scalar
    counters of any attached latency histograms (which inherit the owner's
    lock discipline by design — see ``serve/histogram.py``)."""
    registry.guard(stats, fields=_scalar_fields(stats), locks=locks,
                   label=label or type(stats).__name__)
    for attr in histogram_attrs:
        hist = getattr(stats, attr, None)
        if hist is not None and vars(hist):
            registry.guard(hist, fields=_scalar_fields(hist), locks=locks,
                           label=f"{label or type(stats).__name__}.{attr}")


def instrument_admission_queue(registry: LockRegistry, queue,
                               name: str = "admission"):
    """Swap in a proxy for ``AdmissionQueue._lock`` and rebuild ``_wake``
    around it (the Condition shares the queue's lock); guard the stats."""
    proxy = registry.wrap(queue._lock, f"{name}._lock")
    queue._lock = proxy
    queue._wake = threading.Condition(proxy)
    guard_stats(registry, queue.stats, (f"{name}._lock",),
                label="AdmissionStats",
                histogram_attrs=("latency", "shed_latency"))
    return proxy


def instrument_server(registry: LockRegistry, server, name: str = "server"):
    """Proxy ``BatchServer._stats_lock`` and guard its ServeStats."""
    proxy = registry.wrap(server._stats_lock, f"{name}._stats_lock")
    server._stats_lock = proxy
    guard_stats(registry, server.stats, (f"{name}._stats_lock",),
                label="ServeStats")
    return proxy


def instrument_pump(registry: LockRegistry, pump, name: str = "pump"):
    """Proxy ``IngestPump._stats_lock`` and guard its counters."""
    proxy = registry.wrap(pump._stats_lock, f"{name}._stats_lock")
    pump._stats_lock = proxy
    registry.guard(pump, fields=("errors", "last_error", "ticks_pumped"),
                   locks=(f"{name}._stats_lock",), label="IngestPump")
    return proxy


def instrument_fault_server(registry: LockRegistry, fs,
                            name: str = "chaos"):
    """Proxy ``FaultInjectedServer._inject_lock``; guard the counter."""
    proxy = registry.wrap(fs._inject_lock, f"{name}._inject_lock")
    fs._inject_lock = proxy
    registry.guard(fs, fields=("injected_failures",),
                   locks=(f"{name}._inject_lock",),
                   label="FaultInjectedServer")
    return proxy


def instrument_cmdb(registry: LockRegistry, cmdb, name: str = "cmdb"):
    """Proxy ``PoolCMDB._lock``; guard the registration fields."""
    proxy = registry.wrap(cmdb._lock, f"{name}._lock")
    cmdb._lock = proxy
    registry.guard(cmdb, fields=("_next_id",), locks=(f"{name}._lock",),
                   label="PoolCMDB")
    return proxy
