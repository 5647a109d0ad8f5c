"""SPL003-clean counterpart: the stats write sits under the mapped lock.
Expected: zero findings."""
import threading


class BatchServer:
    def __init__(self):
        self._stats_lock = threading.Lock()
        self.stats = None

    def serve(self, n):
        with self._stats_lock:
            self.stats.record(n, 16)
