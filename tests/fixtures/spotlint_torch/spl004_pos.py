"""Deliberate SPL004 violation: a versioned ring whose rewind moves the
cursor without bumping ``self.version``. Expected: exactly one SPL004
finding (the ``rewind`` method)."""


class RollingDeviceArchive:
    def __init__(self, buf):
        self._buf = buf
        self._pos = 0
        self.version = 0

    def append(self, codes):
        self._buf[self._pos] = codes
        self._pos += 1
        self.version += 1

    def rewind(self):
        self._pos -= 1
