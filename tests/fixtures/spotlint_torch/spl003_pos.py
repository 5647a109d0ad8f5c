"""Deliberate SPL003 violation: a ServeStats write outside the stats
lock. Expected: exactly one SPL003 finding (the ``serve`` increment)."""
import threading


class BatchServer:
    def __init__(self):
        self._stats_lock = threading.Lock()
        self.stats = None

    def serve(self, n):
        self.stats.record(n, 16)
