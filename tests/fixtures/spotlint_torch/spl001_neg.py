"""SPL001-clean counterpart: the port's ``RollingDeviceArchive.append``
order — the views of the ring are read by the statistics update before
the slot is written, and a view kept past the write is cloned first.
Expected: zero findings."""
from repro_torch.kernels import stats_update as stats_update_lib
from repro_torch.parallel import compression


class RollingDeviceArchive:
    def append(self, column):
        col = column
        evict = self._len == self.capacity
        new_len = self._len if evict else self._len + 1
        slot = self._pos
        new_start = ((slot + 1) % self.capacity if evict
                     else (slot + 1 - new_len) % self.capacity)
        codes, n_clip = compression.quantize_column(col, self.scale,
                                                    self.precision)
        codes = codes.to(self.device)
        y_old = self._buf[slot]
        y_first = codes if new_start == slot else self._buf[new_start]
        self._moments, stats = stats_update_lib.stats_update(
            self._moments, codes, y_old, y_first, codes, new_len, evict,
            scale=self.scale if self.precision == "int8" else None)
        evicted = self._buf[slot].clone()
        self._buf[slot] = codes
        self._pos = (slot + 1) % self.capacity
        self._len = new_len
        self._stats = stats
        self.version += 1
        self.appends += 1
        return self, evicted
