"""The traced run: host spans and device ranges that the benchmark puts
around the program's calls, and the reduction of a ``torch.profiler`` trace
to per-range device time, the device's busy time and what the host was
doing while the device sat idle.

Nothing here runs in an untraced run.  Spans inside the program are a later
change; until then these wrappers stand in for them.

Ranges (each a ``torch.profiler.record_function`` named ``spotbench.<name>``
and, for the host spans, a host-clock duration a call):

    serve          BatchServer.serve
      assembly     core.types.RequestBatch.from_requests
      device_pass  RecommendationEngine.batch_arrays (through its copies)
        score_fuse kernels.score_fuse.score_fuse_batch (B1)
        sort       core.pool._sort_masked (the stable sort and its gathers)
        pool_scan  core.pool.pool_scan (the prefix sums and B2)
      results      RecommendationEngine._build_recommendations

A device operation belongs to every range around the host call that
launched it (matched by the profiler's correlation id), so a kernel renamed
or split by a later change is still counted against its call's work.
"""
from __future__ import annotations

import bisect
import functools
import json
import time
from collections import defaultdict

import numpy as np

PREFIX = "spotbench."
WINDOW = "window"
PARENT = {"assembly": "serve", "device_pass": "serve", "results": "serve",
          "score_fuse": "device_pass", "sort": "device_pass",
          "pool_scan": "device_pass"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
            "cudaMemcpy", "cudaMemset")
NAME_CHARS = 96
TOP = 10


class Recorder:
    """Host-clock durations of the wrapped calls, by span name."""

    def __init__(self):
        self.spans: dict[str, list[float]] = defaultdict(list)

    def wrap(self, fn, name: str):
        from torch.profiler import record_function

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            t0 = time.perf_counter()
            with record_function(PREFIX + name):
                out = fn(*args, **kwargs)
            self.spans[name].append(time.perf_counter() - t0)
            return out
        return inner


def instrument(rec: Recorder, server):
    """Put the wrappers in place; returns a function that takes them away."""
    from repro_torch.core import pool as pool_lib
    from repro_torch.core import types
    from repro_torch.kernels import score_fuse

    undo = []

    def patch(obj, attr, new):
        undo.append((obj, attr, obj.__dict__.get(attr)))
        setattr(obj, attr, new)

    batch_cls = types.RequestBatch
    assemble = batch_cls.__dict__["from_requests"].__func__
    patch(batch_cls, "from_requests", classmethod(rec.wrap(assemble,
                                                           "assembly")))
    patch(server, "serve", rec.wrap(server.serve, "serve"))
    eng = server.engine
    patch(eng, "batch_arrays", rec.wrap(eng.batch_arrays, "device_pass"))
    patch(eng, "_build_recommendations",
          rec.wrap(eng._build_recommendations, "results"))
    patch(score_fuse, "score_fuse_batch",
          rec.wrap(score_fuse.score_fuse_batch, "score_fuse"))
    patch(pool_lib, "_sort_masked", rec.wrap(pool_lib._sort_masked, "sort"))
    patch(pool_lib, "pool_scan", rec.wrap(pool_lib.pool_scan, "pool_scan"))

    def restore():
        for obj, attr, old in reversed(undo):
            if old is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old)
    return restore


class Trace:
    """A chrome trace reduced to what the per-layer readers need.

    ``device_s[name]``: device seconds of the operations launched inside
    range ``name`` (scaled up where the profiler lost some of their
    records, as ``chip_smoke.py`` ``profiled`` does); ``recorded[name]``
    the share of those launches it kept.  ``d2h_s``: device seconds of the
    device-to-host copies.  ``busy_s``: seconds in which some kernel, copy
    or memset ran, within the traced window of ``window_s`` seconds.
    ``idle_by_host``: the device's idle seconds by the innermost host span
    around them (``client`` where the host was in none: the closed loop
    between calls).  ``top_ops``: device seconds by range and operation.
    """

    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        ranges = defaultdict(list)
        runtime = {}
        launches = []
        device = []
        for e in events:
            cat = e.get("cat", "")
            if e.get("ph") != "X":
                continue
            if cat == "user_annotation" and e["name"].startswith(PREFIX):
                ranges[e["name"][len(PREFIX):]].append(
                    (e["ts"], e["ts"] + e["dur"], e.get("tid")))
            elif cat in RUNTIME_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    runtime[corr] = (e["ts"], e.get("tid"))
                if e["name"] in LAUNCHES:
                    launches.append((e["ts"], e.get("tid")))
            elif cat in DEVICE_CATS:
                device.append((e["name"], e["ts"], e["dur"], cat,
                               e.get("args", {}).get("correlation")))
        if WINDOW not in ranges:
            raise RuntimeError("the trace holds no window range")
        w0, w1, _ = ranges.pop(WINDOW)[0]
        self.window_s = (w1 - w0) / 1e6
        self._ranges = {n: sorted(r) for n, r in ranges.items()}

        def owners(ts, tid):
            out = []
            for name, rs in self._ranges.items():
                i = bisect.bisect_right(rs, (ts, float("inf"), None)) - 1
                if i >= 0 and rs[i][0] <= ts < rs[i][1] and rs[i][2] == tid:
                    out.append(name)
            return out

        launched = defaultdict(int)
        for ts, tid in launches:
            for name in owners(ts, tid):
                launched[name] += 1
        dev_s = defaultdict(float)
        seen = defaultdict(int)
        ops = defaultdict(float)
        d2h = 0.0
        spans = []
        for name, ts, dur, cat, corr in device:
            end = ts + dur
            if end <= w0 or ts >= w1:
                continue
            spans.append((max(ts, w0), min(end, w1)))
            where = owners(*runtime[corr]) if corr in runtime else []
            for r in where:
                dev_s[r] += dur / 1e6
                seen[r] += 1
            inner = max(where, key=self._depth, default="client")
            ops[f"{inner}/{name[:NAME_CHARS]}"] += dur / 1e6
            if cat == "gpu_memcpy" and "DtoH" in name:
                d2h += dur / 1e6
        self.recorded = {r: seen[r] / launched[r] for r in seen
                         if launched[r]}
        self.device_s = {r: s / min(1.0, self.recorded.get(r, 1.0))
                         for r, s in dev_s.items()}
        self.d2h_s = d2h
        busy = _union(spans)
        self.busy_s = float(sum(b - a for a, b in busy)) / 1e6
        self.idle_by_host = self._idle(busy, w0, w1)
        self.top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]

    @staticmethod
    def _depth(name: str) -> int:
        d = 0
        while name in PARENT:
            name = PARENT[name]
            d += 1
        return d

    def _idle(self, busy, w0, w1) -> dict:
        """Idle device seconds by the innermost host span over them."""
        edges = [w0]
        for a, b in busy:
            edges += [a, b]
        edges.append(w1)
        lo = np.array(edges[0::2], np.float64)
        hi = np.array(edges[1::2], np.float64)
        keep = hi > lo
        lo, hi = lo[keep], hi[keep]
        cum = np.concatenate([[0.0], np.cumsum(hi - lo)])

        def idle_before(t):
            """Idle microseconds in [w0, t], for an array of t."""
            if lo.size == 0:
                return np.zeros_like(t)
            i = np.searchsorted(lo, t, side="right")
            j = np.maximum(i - 1, 0)
            part = np.clip(np.minimum(t, hi[j]) - lo[j], 0.0, None)
            return np.where(i > 0, cum[j] + part, 0.0)

        total = {}
        for name, rs in self._ranges.items():
            a = np.array([r[0] for r in rs], np.float64)
            b = np.array([r[1] for r in rs], np.float64)
            a, b = np.clip(a, w0, w1), np.clip(b, w0, w1)
            total[name] = float((idle_before(b) - idle_before(a)).sum())
        own = dict(total)
        for child, parent in PARENT.items():
            if child in total and parent in own:
                own[parent] -= total[child]
        tops = [n for n in total if n not in PARENT]
        own["client"] = float(cum[-1]) - sum(total[n] for n in tops)
        return {n: v / 1e6 for n, v in own.items()}


def _union(spans):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out
