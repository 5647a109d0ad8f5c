#!/usr/bin/env python3
"""Drive the PyTorch port's serving and live-ingest paths on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is 0 only if all pass):

1. Print the card's name and power limit; build the CUDA kernels of
   ``src/repro_torch/csrc`` (one nvcc per source, started together).
2. Kernel phase: at the main path's shapes (K = 32768 candidates, B = 16
   requests), run kernel B1 ``score_fuse`` with one unique filter mask
   (U = 1) and with region/family filters (U > 1), and kernel B2
   ``pool_scan`` on the resulting sorted rows.  Each result must equal the
   kernel's plain PyTorch version on the same inputs bit for bit.  Times
   each kernel and its plain version.
3. Main path: a seeded K = 32768, T = 1008 archive (132 MB of float32 T3 on
   the card) served through ``BatchServer.serve`` for 3 x 16 mixed
   requests, with the kernels' launch counters reset just before and read
   just after.  The same requests then run on the CPU (plain versions) on
   an archive holding the card's statistics: score rows must be
   bit-identical, and pools identical except where the decision-margin
   replay puts a decision within float32 rounding of the two devices'
   prefix sums (a tie, counted and printed).
4. Live-ingest path (float32, then int8): a seeded synthetic feed over the
   same K = 32768 catalog primes a rolling archive of capacity 1008 with 504
   columns through ``EngineConfig.build_ingestor``, then absorbs 1512 ticks
   (504 growing, 1008 sliding: one wrap; 600 on int8) through
   ``LiveIngestor.poll``, kernel B3 ``stats_update`` once per tick, with the
   launch counters reset just before and read just after.  Every tick is
   replayed through B3's plain version on the same inputs (bit-identical
   moments and statistics required).  At three versions 16 mixed requests
   are served through ``AdmissionQueue`` drains and compared with a CPU run
   on the snapshot's statistics as in phase 3; the final statistics are held
   against ``candidate_stats`` of the window at RTOL 1e-5 / ATOL 1e-4 and
   the window against the feed.  Prints append latency and B3's times.
5. Print the ``kernels`` JSON line, the card line, and last the ``ok`` line.

Exits non-zero without printing a result when CUDA is unavailable or when
the ``src/repro_torch`` package is not beside this script.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
K_FULL = 32768
T_FULL = 1008          # 7 days of 10-minute samples
B_FULL = 16
N_CALLS = 3            # serve() calls of B_FULL requests on the main path
BUCKETS = (1, 8, 16, 64, 256)   # the default ladder plus 16: one batch a call
TIME_REPS = 50
LATENCY_CALLS = 100    # serve() calls timed for p50 / p90 (10 samples above)

# live-ingest phase: a ring of one week of 10-minute samples, primed with
# half of it, then one full wrap (504 growing ticks, 1008 sliding ones)
INGEST_WINDOW = 1008
INGEST_PRIME = 504
INGEST_TICKS = {"float32": 1512, "int8": 600}
INGEST_SERVE_AT = {"float32": (504, 1008, 1512), "int8": (600,)}
# float operations of one candidate's tick in kernel B3: ten compensated
# adds of 4, the update's 7 products and differences, the derivation's 21
# (4 more decodes on the int8 tier)
B3_FLOPS = 68

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def candidates(K: int, T: int, seed: int = 0):
    """The seeded archive generator of ``benchmarks/latency_slo.py``."""
    from repro_torch.core.types import CandidateSet
    rng = np.random.default_rng(seed)
    fams = rng.choice(["m5", "c5", "r5", "t3"], K)
    return CandidateSet(
        names=np.array([f"{fams[i]}.x{i}" for i in range(K)]),
        regions=rng.choice(["us-east-1", "eu-west-1", "ap-north-1"], K),
        azs=rng.choice(["a", "b", "c"], K),
        families=fams,
        categories=rng.choice(["general", "compute", "memory"], K),
        vcpus=rng.choice([2, 4, 8, 16, 32, 64, 96], K).astype(np.float64),
        memory_gb=rng.choice([4, 8, 16, 64, 128, 384], K).astype(np.float64),
        prices=rng.uniform(0.01, 5.0, K),
        t3=rng.uniform(0.0, 50.0, (K, T)),
    )


def mixed_requests(rng, n: int, *, filtered: bool = True):
    """Filterless by CPU, region- and family-filtered, by memory, one with
    ``max_types``, one with W = 1."""
    from repro_torch.core.types import ResourceRequest
    reqs = []
    for i in range(n):
        kw = dict(weight=float(rng.uniform(0.2, 0.8)),
                  lam=float(rng.uniform(0.05, 0.3)))
        kind = i % 8 if filtered else 0
        if kind == 5:
            kw["memory_gb"] = float(rng.choice([64, 256, 1024, 4096]))
        else:
            kw["cpus"] = float(rng.choice([64, 128, 256, 512, 1000, 4096]))
        if kind in (3, 4):
            kw["regions"] = [["us-east-1", "eu-west-1", "ap-north-1"][i % 3]]
        if kind == 4:
            kw["families"] = ["c5", "m5"]
        if kind == 6:
            kw["max_types"] = 2
        if kind == 7:
            kw["weight"] = 1.0
        reqs.append(ResourceRequest(**kw))
    return reqs


def same_bits(a, b) -> bool:
    """Equal values, NaN where the other is NaN (``-0.0 == 0.0``)."""
    import torch
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def time_ms(fn, names: tuple[str, ...] | None):
    """Median per-call CUDA-event time, and the per-call device time of the
    kernels whose names contain one of ``names`` (all kernels if ``None``)
    from a ``torch.profiler`` trace; the latter is ``None`` if the profiler
    records no device time."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(TIME_REPS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    call_ms = float(np.median([a.elapsed_time(b) for a, b in pairs]))
    prof_ms = None
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TIME_REPS):
                fn()
            torch.cuda.synchronize()
        total_us = 0.0
        for evt in prof.key_averages():
            dev_us = getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0.0))
            if names is None or any(n in evt.key for n in names):
                total_us += dev_us
        prof_ms = total_us / 1e3 / TIME_REPS if total_us > 0 else None
    except RuntimeError as err:   # no CUPTI on this machine: events only
        print(f"profiler unavailable ({err}); kernel time from events")
    return call_ms, prof_ms


def kernel_phase(torch, cands, archive):
    """B1 and B2 against their plain versions at the main path's shapes."""
    from repro_torch.core import pool as pool_lib
    from repro_torch.core.engine import _dedup_masks
    from repro_torch.core.types import RequestBatch
    from repro_torch.kernels import pool_scan as ps
    from repro_torch.kernels import score_fuse as sf

    dev = archive.device
    K = len(cands)
    stats = torch.stack(tuple(archive.score_stats()))
    rng = np.random.default_rng(1)
    timings = {}
    err = {"score_fuse": 0.0, "pool_scan": 0.0}
    for label, filtered in (("U=1", False), ("U>1", True)):
        batch = RequestBatch.from_requests(
            cands, mixed_requests(rng, B_FULL, filtered=filtered))
        uniq, inv = _dedup_masks(batch.masks)
        on = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        masks, use_cpus = on(batch.masks), on(batch.use_cpus)
        amounts, lams, weights = on(batch.amounts), on(batch.lams), on(batch.weights)
        args = (stats, archive.prices, archive.vcpus, archive.memory_gb,
                masks, use_cpus, amounts, lams, weights, on(uniq), inv)
        got = sf.score_fuse_batch(*args)
        want = sf.score_fuse_batch(*args, backend="torch")
        torch.cuda.synchronize()
        m = masks
        for name in ("comb", "avail", "cost"):
            if not same_bits(getattr(got, name)[m], getattr(want, name)[m]):
                fail(f"score_fuse {label}: {name} rows differ from the plain version")
        if not (same_bits(got.extrema, want.extrema)
                and same_bits(got.c_min, want.c_min)):
            fail(f"score_fuse {label}: extrema or C_min differ")
        for name in ("comb", "avail", "cost"):
            d = (getattr(got, name) - getattr(want, name))[m].abs()
            err["score_fuse"] = max(err["score_fuse"],
                                    float(d.nan_to_num(0.0).max()))
        U = uniq.shape[0]
        if (U == 1) != (label == "U=1"):
            fail(f"score_fuse {label}: expected that case, got U = {U}")

        caps = torch.where(use_cpus[:, None], archive.vcpus, archive.memory_gb)
        _, s, c = pool_lib._sort_masked(got.comb, caps, masks)
        csc = ps._clamped_prefix_sums(s)
        pk = ps.pool_scan(s, c, amounts, csc)
        pp = ps.pool_scan(s, c, amounts, csc, backend="torch")
        torch.cuda.synchronize()
        for name, a, b in zip(("counts", "k_stop", "any_term"), pk, pp):
            if not torch.equal(a, b):
                fail(f"pool_scan {label}: {name} differs from the plain version")
        err["pool_scan"] = max(err["pool_scan"],
                               float((pk[0] - pp[0]).abs().max()))
        print(f"kernel phase {label}: U={U} bit-identical "
              f"(score rows, extrema, C_min, counts, k_stop, any_term)")

        if label == "U>1":   # the main path's mix: time and bound here
            k_stop, any_term = pk[1].cpu().numpy(), pk[2].cpu().numpy()
            scanned = np.where(any_term, k_stop, K - 1) + 1
            B = B_FULL
            sf_bytes = (4 * 6 * K + B * K + U * K + 4 * 5 * B + 4 * 3 * B * K
                        + 4 * 6 * U + 4 * B)
            sf_ops = 24 * B * K + 6 * U * K + 4 * B * K
            ps_bytes = 4 * B * K + 12 * int(scanned.sum()) + 4 * 3 * B
            ps_ops = 12 * int(scanned.sum()) + 4 * int(scanned.sum())
            for name, kfn, pfn, nbytes, nops, knames in (
                    ("score_fuse", lambda: sf.score_fuse_batch(*args),
                     lambda: sf.score_fuse_batch(*args, backend="torch"),
                     sf_bytes, sf_ops, ("score_reduce_kernel",
                                        "score_emit_kernel")),
                    ("pool_scan", lambda: ps.pool_scan(s, c, amounts, csc),
                     lambda: ps.pool_scan(s, c, amounts, csc, backend="torch"),
                     ps_bytes, ps_ops, ("pool_term_kernel",
                                        "pool_emit_kernel"))):
                call_ms, dev_ms = time_ms(kfn, knames)
                plain_call_ms, plain_dev_ms = time_ms(pfn, None)
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = nops / FP32_OPS_PER_S * 1e3
                timings[name] = dict(
                    ms=dev_ms if dev_ms is not None else call_ms,
                    ms_source="profiler" if dev_ms is not None else "events",
                    call_ms=call_ms,
                    plain_ms=(plain_dev_ms if plain_dev_ms is not None
                              else plain_call_ms),
                    plain_call_ms=plain_call_ms,
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    bytes=nbytes, ops=nops)
            timings["pool_scan"]["scanned_lanes"] = int(scanned.sum())
    for name, e in err.items():
        timings[name]["max_abs_err"] = e
    return timings


def check_pools(cands, calls, served, label: str) -> None:
    """Algorithm 1's own invariants: a non-empty pool of positive counts,
    inside the request's filters, whose capacity covers the request."""
    row_of = {name: i for i, name in enumerate(cands.names)}
    for reqs, recs in zip(calls, served):
        for req, rec in zip(reqs, recs):
            rows = np.array([row_of[n] for n in rec.names], np.int64)
            cap = req.capacity_of(cands)[rows] if rows.size else rows
            if not (rows.size and np.all(rec.counts > 0)
                    and req.filter_mask(cands)[rows].all()
                    and np.isfinite(rec.combined).all()
                    and np.isfinite(rec.hourly_cost)
                    and (rec.counts * cap).sum() >= req.amount):
                fail(f"{label}: malformed pool for {req}")


def compare_with_cpu(torch, server, archive, cands, calls, served, label):
    """Serve ``calls`` again on the CPU, on an archive holding the card
    archive's statistics: score rows must be bit-identical, and pools
    identical except where ``prefix_sum_tie`` flags a tie (counted)."""
    from repro_torch import convert
    from repro_torch.core import pool as pool_lib
    from repro_torch.core.types import RequestBatch
    from repro_torch.kernels import pool_scan as ps
    from repro_torch.serve import BatchServer

    stats_host = [x.cpu().numpy() for x in archive.score_stats()]
    cpu_archive = convert.archive_from_numpy(cands, stats_host, device="cpu")
    cpu_server = BatchServer(device="cpu", bucket_sizes=BUCKETS)
    cpu_served = [cpu_server.serve(cpu_archive, reqs) for reqs in calls]

    ties = mismatched = csc_rows_differ = 0
    csc_max_rel = 0.0
    for reqs, recs, cpu_recs in zip(calls, served, cpu_served):
        batch = RequestBatch.from_requests(cands, reqs)
        gpu = server.engine.batch_arrays(cands, batch, archive=archive)
        cpu = cpu_server.engine.batch_arrays(cands, batch, archive=cpu_archive)
        for name, a, b in zip(("comb", "avail", "cost"), gpu[:3], cpu[:3]):
            if not same_bits(a[batch.masks], b[batch.masks]):
                fail(f"{label}: {name} rows differ between card and CPU")
        comb = torch.as_tensor(cpu[0])
        caps_all = torch.where(torch.as_tensor(batch.use_cpus)[:, None],
                               cpu_archive.vcpus, cpu_archive.memory_gb)
        _, s, c = pool_lib._sort_masked(comb, caps_all,
                                        torch.as_tensor(batch.masks))
        csc_cpu = ps._clamped_prefix_sums(s).numpy()
        csc_gpu = ps._clamped_prefix_sums(s.to(DEVICE)).cpu().numpy()
        csc_rows_differ += int((csc_cpu != csc_gpu).any(axis=1).sum())
        csc_max_rel = max(csc_max_rel, float(
            (np.abs(csc_cpu - csc_gpu) / np.abs(csc_cpu)).max()))
        for b, (req, rg, rc) in enumerate(zip(reqs, recs, cpu_recs)):
            same_scan = (np.array_equal(gpu[3][b], cpu[3][b])
                         and np.array_equal(gpu[4][b], cpu[4][b])
                         and gpu[5][b] == cpu[5][b] and gpu[6][b] == cpu[6][b])
            same_pool = (list(rg.names) == list(rc.names)
                         and np.array_equal(rg.counts, rc.counts)
                         and rg.hourly_cost == rc.hourly_cost)
            runs = [(int(x[5][b]), bool(x[6][b])) for x in (gpu, cpu)]
            tie, margin, budget = pool_lib.prefix_sum_tie(
                s[b].numpy(), c[b].numpy(), float(batch.amounts[b]),
                csc_cpu[b], csc_gpu[b], runs)
            ties += tie
            if not (same_scan and same_pool):
                mismatched += 1
                if not tie:
                    fail(f"{label}: pool of {req} differs between card and "
                         f"CPU with margin {margin:.3g} > budget {budget:.3g}")
    return dict(ties=int(ties), tie_mismatches=int(mismatched),
                prefix_sum_rows_differ=csc_rows_differ,
                prefix_sum_max_rel_diff=csc_max_rel)


def main_path(torch, cands):
    """3 x 16 mixed requests through BatchServer.serve on the card, then on
    the CPU with the card's statistics; returns the counters and report."""
    from repro_torch.kernels import pool_scan as ps
    from repro_torch.kernels import score_fuse as sf
    from repro_torch.serve import BatchServer

    rng = np.random.default_rng(2)
    calls = [mixed_requests(rng, B_FULL) for _ in range(N_CALLS)]
    server = BatchServer(device=DEVICE, bucket_sizes=BUCKETS)
    archive = server.cache.get(cands)
    archive.score_stats()
    torch.cuda.synchronize()

    sf.score_fuse_batch.launches = 0
    ps.pool_scan.launches = 0
    served, serve_ms = [], []
    for reqs in calls:
        t0 = time.perf_counter()
        served.append(server.serve(archive, reqs))
        serve_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"score_fuse": sf.score_fuse_batch.launches,
                "pool_scan": ps.pool_scan.launches}
    for name, n in launches.items():
        if n == 0:
            fail(f"the main path never launched kernel {name}")

    check_pools(cands, calls, served, "main path")
    report = compare_with_cpu(torch, server, archive, cands, calls, served,
                              "main path")
    return launches, dict(serve_ms=serve_ms, requests=N_CALLS * B_FULL,
                          **report)


class SyntheticFeed:
    """A seeded live collector over a fixed catalog: tick ``i`` is the (K,)
    column ``uniform(0, 50)`` drawn from ``(seed, i)``.  Has what the
    ingestor reads of a collector: ``ticks``, ``column(i)`` and
    ``to_candidate_set(window=)``.  :meth:`run` draws the next tick's column
    ahead, so an ingest reads it from memory as from a collector's ring."""

    def __init__(self, catalog, seed: int, ticks: int):
        self.catalog = catalog
        self.seed = seed
        self.ticks = ticks
        self._ahead = None

    def _draw(self, i: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, i))
        return rng.uniform(0.0, 50.0, len(self.catalog))

    def column(self, i: int) -> np.ndarray:
        if not 0 <= i < self.ticks:
            raise IndexError(f"tick {i} not collected yet")
        if self._ahead is not None and self._ahead[0] == i:
            return self._ahead[1]
        return self._draw(i)

    def window(self, n: int) -> np.ndarray:
        """The (K, n) window of the last ``n`` ticks, oldest first."""
        return np.stack([self.column(i)
                         for i in range(self.ticks - n, self.ticks)], axis=1)

    def to_candidate_set(self, window: int | None = None):
        from dataclasses import replace
        n = min(window or self.ticks, self.ticks)
        return replace(self.catalog, t3=self.window(n))

    def run(self, n: int = 1) -> None:
        self.ticks += n
        self._ahead = (self.ticks - 1, self._draw(self.ticks - 1))


def ingest_phase(torch, catalog, precision: str):
    """The live-ingest path at full width: prime a rolling archive of K
    candidates, absorb ``INGEST_TICKS[precision]`` ticks through
    ``LiveIngestor.poll`` (kernel B3 once per tick) and serve 16 mixed
    requests through ``AdmissionQueue`` drains at ``INGEST_SERVE_AT``.

    Every tick is replayed through B3's plain version on the same inputs
    (bit-identical moments and statistics required); the final statistics
    are held against ``candidate_stats`` of the materialized window, the
    window against the feed, and the served pools against a CPU run on the
    snapshots' statistics."""
    from repro_torch.core import scoring
    from repro_torch.core.config import EngineConfig
    from repro_torch.kernels import pool_scan as ps
    from repro_torch.kernels import score_fuse as sf
    from repro_torch.kernels import stats_update as su
    from repro_torch.parallel import compression
    from repro_torch.stream import AdmissionQueue

    n_ticks = INGEST_TICKS[precision]
    label = f"ingest {precision}"
    quantized = precision == "int8"
    feed = SyntheticFeed(catalog, seed=5, ticks=INGEST_PRIME)
    cfg = EngineConfig(archive_precision=precision)
    server = cfg.build_server(device=DEVICE, bucket_sizes=BUCKETS)
    rng = np.random.default_rng(4)
    calls, served, snaps, append_ms = [], [], [], []
    max_err = 0.0

    su.stats_update.launches = 0
    sf.score_fuse_batch.launches = 0
    ps.pool_scan.launches = 0
    t0 = time.perf_counter()
    ing = cfg.build_ingestor(feed, window=INGEST_WINDOW, name="live",
                             device=DEVICE)
    arch = ing.prime()
    torch.cuda.synchronize()
    prime_s = time.perf_counter() - t0
    queue = AdmissionQueue(server, lambda: ing.archive, max_wait_s=0.0)
    for tick in range(1, n_ticks + 1):
        feed.run(1)
        slot, prev = arch._pos, arch._moments
        y_old = arch._buf[slot].clone()
        evict = arch.window_len == arch.capacity
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ing.poll()
        torch.cuda.synchronize()
        append_ms.append((time.perf_counter() - t0) * 1e3)
        # the same tick through B3's plain version, on the same inputs
        y_new = arch._buf[slot]
        pm, pst = su.stats_update(
            prev, y_new, y_old, arch._buf[arch._start], y_new,
            arch.window_len, evict, scale=arch.scale if quantized else None,
            backend="torch")
        for a, b in zip((*arch._moments, *arch.score_stats()), (*pm, *pst)):
            if not same_bits(a, b):
                fail(f"{label}: B3 differs from its plain version at tick "
                     f"{tick}")
            max_err = max(max_err, float((a - b).abs().nan_to_num(0.0).max()))
        if tick in INGEST_SERVE_AT[precision]:
            reqs = mixed_requests(rng, B_FULL)
            tickets = [queue.submit(r) for r in reqs]
            queue.drain(force=True)
            recs = [t.result() for t in tickets]
            if any(r.diagnostics["archive_version"] != arch.version
                   for r in recs):
                fail(f"{label}: a drain served another version")
            calls.append(reqs)
            served.append(recs)
            snaps.append(arch.snapshot())
    launches = {"stats_update": su.stats_update.launches,
                "score_fuse": sf.score_fuse_batch.launches,
                "pool_scan": ps.pool_scan.launches}
    if launches["stats_update"] != n_ticks:
        fail(f"{label}: B3 launched {launches['stats_update']} times over "
             f"{n_ticks} ticks, not once per tick")
    for name, n in launches.items():
        if n == 0:
            fail(f"{label}: the ingest path never launched kernel {name}")

    # the stored window against the feed, the statistics against a recompute
    host = feed.window(arch.window_len)
    if quantized:
        codes = compression.quantize_window(host, arch.scale.cpu().numpy(),
                                            precision)
        host = compression.dequantize_window(codes, arch.scale.cpu(),
                                             precision).numpy()
    if not np.array_equal(arch.materialize(), host.astype(np.float32)):
        fail(f"{label}: the ring's window differs from the feed's")
    want = scoring.candidate_stats(arch.t3)
    for name, a, b in zip(("area", "slope", "std"), arch.score_stats(), want):
        if not torch.allclose(a, b, rtol=1e-5, atol=1e-4):
            fail(f"{label}: streamed {name} is off a recompute of the window")
    recompute = {name: float((a - b).abs().max()) for name, a, b in
                 zip(("area", "slope", "std"), arch.score_stats(), want)}

    serve = []
    for reqs, recs, snap in zip(calls, served, snaps):
        check_pools(snap.host, [reqs], [recs], f"{label} v{snap.version}")
        serve.append(dict(version=snap.version, **compare_with_cpu(
            torch, server, snap, snap.host, [reqs], [recs],
            f"{label} v{snap.version}")))

    profile = profile_ingest(torch, ing, feed)

    # B3 alone at this shape: one sliding tick of the final state
    K = len(arch)
    y_new = arch._buf[(arch._pos - 1) % arch.capacity]
    args = (arch._moments, y_new, arch._buf[arch._pos],
            arch._buf[arch._start], y_new, arch.window_len, True)
    kw = dict(scale=arch.scale if quantized else None)
    call_ms, dev_ms = time_ms(lambda: su.stats_update(*args, **kw),
                              ("stats_update_kernel",))
    plain_call_ms, plain_dev_ms = time_ms(
        lambda: su.stats_update(*args, **kw, backend="torch"), None)
    col_bytes = (1 if quantized else 4) * 4 * K
    nbytes = 4 * 7 * K + col_bytes + (4 * K if quantized else 0) + 4 * 9 * K
    nops = (B3_FLOPS + (4 if quantized else 0)) * K
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    b3 = dict(ms=dev_ms if dev_ms is not None else call_ms,
              ms_source="profiler" if dev_ms is not None else "events",
              call_ms=call_ms,
              plain_ms=plain_dev_ms if plain_dev_ms is not None
              else plain_call_ms,
              plain_call_ms=plain_call_ms, bound_ms=max(t_bytes, t_ops),
              bound_by="bytes" if t_bytes >= t_ops else "operations",
              bytes=nbytes, ops=nops, max_abs_err=max_err)
    report = dict(
        K=K, capacity=INGEST_WINDOW, prime_columns=INGEST_PRIME,
        ticks=n_ticks, grow_ticks=INGEST_WINDOW - INGEST_PRIME,
        slide_ticks=n_ticks - (INGEST_WINDOW - INGEST_PRIME),
        prime_s=prime_s,
        append_ms={"p50": float(np.percentile(append_ms, 50)),
                   "p90": float(np.percentile(append_ms, 90)),
                   "max": float(np.max(append_ms))},
        b3_launches_per_tick=launches["stats_update"] / n_ticks,
        launches=launches, clipped_samples=arch.clipped_samples,
        recompute_max_abs_err=recompute, serve=serve, b3=b3,
        profile=profile)
    return launches, report


def profile_ingest(torch, ing, feed, n: int = 50):
    """``n`` more ticks under ``torch.profiler``: per poll, the wall time,
    the device's busy time and idle share, and the largest host and device
    items (self time, per poll)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            feed.run(1)
            ing.poll()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    host, dev = [], []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            dev.append((dev_us / 1e3 / n, evt.key[:60]))
        if evt.self_cpu_time_total > 0:
            host.append((evt.self_cpu_time_total / 1e3 / n, evt.key[:60]))
    dev.sort(reverse=True)
    host.sort(reverse=True)
    busy = sum(ms for ms, _ in dev)
    return dict(polls=n, wall_ms_per_poll=wall_ms, device_busy_ms_per_poll=busy,
                idle_share=1 - busy / wall_ms if wall_ms > 0 else None,
                device_top=[[round(ms, 5), k] for ms, k in dev[:6]],
                host_top=[[round(ms, 5), k] for ms, k in host[:10]])


def profile_serve(torch, cands):
    """Device busy time against wall time for one served batch, and the
    host-clock split of a batch into its three engine stages."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.types import RequestBatch
    from repro_torch.serve import BatchServer
    server = BatchServer(device=DEVICE, bucket_sizes=BUCKETS)
    reqs = mixed_requests(np.random.default_rng(3), B_FULL)
    archive = server.cache.get(cands)
    server.serve(archive, reqs)
    torch.cuda.synchronize()
    stages = {"assemble_ms": [], "device_pass_ms": [], "results_ms": []}
    for _ in range(5):
        t0 = time.perf_counter()
        batch = RequestBatch.from_requests(cands, reqs, pad_to=B_FULL)
        t1 = time.perf_counter()
        arrays = server.engine.batch_arrays(cands, batch, archive=archive)
        t2 = time.perf_counter()
        server.engine._build_recommendations(cands, batch, reqs,
                                             *arrays[:6], 0.0)
        t3 = time.perf_counter()
        for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[key].append(dt * 1e3)
    latency = []
    for _ in range(LATENCY_CALLS):
        t0 = time.perf_counter()
        server.serve(archive, reqs)
        latency.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.serve(archive, reqs)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, evt.key[:60]))
    rows.sort(reverse=True)
    busy = sum(ms for ms, _ in rows)
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                idle_share=1 - busy / wall_ms if wall_ms > 0 else None,
                stages_median_ms={k: float(np.median(v))
                                  for k, v in stages.items()},
                serve_latency_ms={"n": LATENCY_CALLS,
                                  "p50": float(np.percentile(latency, 50)),
                                  "p90": float(np.percentile(latency, 90)),
                                  "max": float(np.max(latency))},
                top=[[round(ms, 4), k] for ms, k in rows[:8]])


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script measures the port on a GPU")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"src/repro_torch not found beside {Path(__file__).name}: "
             "run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.serve import DeviceArchive

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build("score_fuse", "pool_scan", "stats_update")
    print(f"built score_fuse.cu + pool_scan.cu + stats_update.cu in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in ("score_fuse", "pool_scan", "stats_update"):
        for line in _build.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    cands = candidates(K_FULL, T_FULL)
    archive = DeviceArchive.stage(cands, device=DEVICE)
    archive.score_stats()
    torch.cuda.synchronize()
    print(f"archive K={K_FULL} T={T_FULL}: {archive.t3.nbytes / 1e6:.1f} MB "
          f"of T3 on the card, set up in {time.perf_counter() - t0:.2f} s")

    timings = kernel_phase(torch, cands, archive)
    launches, report = main_path(torch, cands)
    print("main path: " + json.dumps(report))
    print("serve profile: " + json.dumps(profile_serve(torch, cands)))
    del archive
    for precision in ("float32", "int8"):
        t0 = time.perf_counter()
        ingest_launches, ingest = ingest_phase(torch, cands, precision)
        ingest["phase_s"] = time.perf_counter() - t0
        print(f"ingest {precision}: " + json.dumps(ingest))
        if precision == "float32":
            launches["stats_update"] = ingest_launches["stats_update"]
            timings["stats_update"] = ingest["b3"]

    meta = {"score_fuse": ("cuda", "src/repro_torch/csrc/score_fuse.cu",
                           "src/repro/kernels/score_fuse.py:189"),
            "pool_scan": ("cuda", "src/repro_torch/csrc/pool_scan.cu",
                          "src/repro/kernels/pool_scan.py:155"),
            "stats_update": ("cuda", "src/repro_torch/csrc/stats_update.cu",
                             "src/repro/kernels/stats_update.py:203")}
    kernels = []
    for name, (route, source, replaces) in meta.items():
        t = timings[name]
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **t, "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
