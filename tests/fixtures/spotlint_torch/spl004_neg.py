"""SPL004-clean counterpart: every payload mutation bumps the version;
the staleness flag is no payload. Expected: zero findings."""


class RollingDeviceArchive:
    def __init__(self, buf):
        self._buf = buf
        self._pos = 0
        self.version = 0
        self.stale = False

    def append(self, codes):
        self._buf[self._pos] = codes
        self._pos += 1
        self.version += 1

    def mark_stale(self):
        self.stale = True
