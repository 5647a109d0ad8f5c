"""One run of one cell: set-up, the measured window, the comparison with the
plain reference, and the result.

Everything specific to a cell is data found by name (``spec``): the
configuration file (the deployment: catalog layout, window, W and lambda,
server ladder, limits of the comparison), the traffic file (the request
mix of a call), and a reader file for each metric (``metrics/<name>.py``).
The program is driven through its public serving path:
``DeviceArchive.stage`` once, then every call
``BatchServer.serve(archive, requests)``, back to back: the next call is
submitted when the last one returns.
"""
from __future__ import annotations

import gc
import math
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import gen, judge, spec, tracing
from . import reference as ref

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARMUP_CALLS = 2
JUDGE_TAG = 4
JUDGE_ANSWERS = 2048     # answers judged a run: whole calls drawn from the seed


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


@dataclass
class Call:
    """One serve call of the window."""

    submitted: float
    done: float
    requests: list
    answers: list | None          # None where the call raised
    error: str = ""


@dataclass
class Run:
    """What a run measured, as the metric readers see it."""

    cell: spec.Cell
    setup_s: float
    window_s: float
    calls: list
    latencies_s: list
    answered: int
    memory_peak_bytes: int
    spans: dict = field(default_factory=dict)
    trace: tracing.Trace | None = None
    work_s: dict = field(default_factory=dict)

    @property
    def n_calls(self) -> int:
        return len(self.calls)


def _answer(rec, cat, rows: dict) -> ref.Answer:
    """A returned ``Recommendation`` as the judge reads it; a member that
    is no (type, AZ) of the catalog, or not in its AZ's region, reads as
    row -1."""
    got = []
    for name, az, region in zip(rec.names, rec.azs, rec.regions):
        r = rows.get((name, az), -1)
        got.append(r if r >= 0 and cat.regions[r] == region else -1)
    return ref.Answer(
        rows=np.array(got, np.int64), counts=np.asarray(rec.counts),
        combined=np.asarray(rec.combined, np.float64),
        availability=np.asarray(rec.availability, np.float64),
        cost=np.asarray(rec.cost, np.float64),
        hourly_cost=float(rec.hourly_cost),
        iterations=int(rec.diagnostics["greedy_iterations"]),
        considered=int(rec.diagnostics["candidates_considered"]))


def _log(msg: str) -> None:
    print(f"spotbench: {msg}", file=sys.stderr, flush=True)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             control: bool = False) -> dict:
    """Run ``cell`` once and return its result (the line ``run.py``
    prints).  ``device="cpu"`` runs the program's plain versions, for the
    tests.  ``control`` also judges the bfloat16 control on the same
    inputs, under ``result["control"]`` (``control.py``)."""
    import torch
    from repro_torch.core.types import CandidateSet, ResourceRequest
    from repro_torch.serve import BatchServer, DeviceArchive

    t_start = time.perf_counter() if t_start is None else t_start
    cfg, traffic = cell.config, cell.traffic
    on_gpu = device != "cpu"
    sync = torch.cuda.synchronize if on_gpu else (lambda: None)

    cat = gen.catalog(cfg, seed)
    mix = gen.Mix(cfg, traffic)
    K, T = cat.t3.shape
    cands = CandidateSet(names=cat.names, regions=cat.regions, azs=cat.azs,
                         families=cat.families, categories=cat.categories,
                         vcpus=cat.vcpus, memory_gb=cat.memory_gb,
                         prices=cat.prices, t3=cat.t3)
    server = BatchServer(device=device,
                         bucket_sizes=tuple(cfg["bucket_sizes"]))
    archive = DeviceArchive.stage(cands, key=cell.config_name, device=device,
                                  precision=cfg["precision"])
    archive.score_stats()

    # warm-up: the cell's one bucket
    for i in range(WARMUP_CALLS):
        specs = mix.requests(seed, i, tag=gen.WARMUP_TAG)
        server.serve(archive, [ResourceRequest(**s) for s in specs])
    sync()
    setup_s = time.perf_counter() - t_start
    _log(f"{cell.name}: set-up {setup_s:.3f} s (K = {K}, T = {T})")

    rec = tracing.Recorder()
    restore = tracing.instrument(rec, server) if trace else None
    profiler = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_gpu else [])
        profiler = profile(activities=acts)
        profiler.__enter__()
        window_range = record_function(tracing.PREFIX + tracing.WINDOW)
        window_range.__enter__()
    calls: list[Call] = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while time.perf_counter() < deadline:
        specs = mix.requests(seed, i)
        reqs = [ResourceRequest(**s) for s in specs]
        submitted = time.perf_counter()
        try:
            answers, error = server.serve(archive, reqs), ""
        except Exception as err:  # noqa: BLE001 — a raising call is a failure
            answers, error = None, repr(err)
        calls.append(Call(submitted, time.perf_counter(), specs, answers,
                          error))
        i += 1
    window_s = calls[-1].done - t0
    trace_data = None
    if trace:
        window_range.__exit__(None, None, None)
        sync()
        profiler.__exit__(None, None, None)
        restore()
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "trace.json")
            profiler.export_chrome_trace(path)
            trace_data = tracing.Trace(path)
        del profiler
        _log("trace: launches recorded " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(trace_data.recorded.items())))
    peak = torch.cuda.max_memory_allocated() if on_gpu else 0

    # the program's state: its statistics are read, then everything freed
    prog_stats = np.stack([x.cpu().numpy() for x in archive.score_stats()])
    del archive, server
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()

    answered = sum(len(c.requests) for c in calls if c.answers is not None)
    attempted = sum(len(c.requests) for c in calls)
    latencies = [c.done - c.submitted for c in calls if c.answers is not None
                 for _ in c.requests]

    rows = cat.rows()
    sample = judged_calls(calls, seed)
    t_judge = time.perf_counter()
    checks, ties = _judge(cat, rows, [calls[j] for j in sample], prog_stats,
                          device)
    _log(f"{cell.name}: judged {sum(len(calls[j].requests) for j in sample)}"
         f" of {answered} answers ({len(sample)} of {len(calls)} calls) in "
         f"{time.perf_counter() - t_judge:.3f} s; {ties} pools not bit for "
         f"bit the reference's own (near-ties, within the limits)")
    run = Run(cell=cell, setup_s=setup_s, window_s=window_s, calls=calls,
              latencies_s=latencies, answered=answered,
              memory_peak_bytes=peak, spans=dict(rec.spans), trace=trace_data)
    if trace:
        run.work_s = _work(cat, calls, rows)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = cfg["limits"]
    result = {
        "correct": judge.verdict(attempted, answered, checks, limits),
        "attempted": attempted, "failed": attempted - answered,
        "metrics": metrics,
        "device": _device(torch, on_gpu, peak, trace_data)}
    if trace_data is not None:
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in trace_data.top_ops],
            "idle_gaps": sorted(([k, v] for k, v in
                                 trace_data.idle_by_host.items()),
                                key=lambda kv: -kv[1])[:tracing.TOP]}
    if control:
        low = _control(cat, [calls[j] for j in sample], device)
        result["control"] = {
            "correct": judge.verdict(attempted, answered, low, limits),
            "checks": low}
    for c in calls:
        if c.error:
            _log(f"a call raised: {c.error}")
            break
    result["checks"] = {n: {"value": checks[n], "limit": limits[n]}
                        for n in judge.NUMBERS}
    for n in judge.NUMBERS:
        verdict = "ok" if checks[n] <= limits[n] else "FAIL"
        _log(f"check {n} {checks[n]!r} limit {limits[n]!r} {verdict}")
    return result


def judged_calls(calls: list, seed: int) -> list[int]:
    """The calls whose answers are judged: drawn from the seed, whole calls
    up to ``JUDGE_ANSWERS`` answers, every call where the window holds
    fewer; sorted."""
    if not calls:
        return []
    per_call = len(calls[0].requests)
    n = min(len(calls), math.ceil(JUDGE_ANSWERS / per_call))
    rng = np.random.default_rng((seed, JUDGE_TAG))
    return sorted(rng.choice(len(calls), n, replace=False).tolist())


def _device(torch, on_gpu: bool, peak: int, trace_data) -> dict:
    out = {"platform": "gpu" if on_gpu else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_gpu else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace_data is not None:
        out["busy_s"] = trace_data.busy_s
        out["window_s"] = trace_data.window_s
    return out


def _stats(cat, device, dtype):
    import torch
    t3 = torch.as_tensor(cat.t3, device=device)
    return ref.stats_in_blocks(lambda a, b: t3[a:b], len(cat), dtype)


def _judge(cat, rows, calls, prog_stats, device):
    """The five numbers of ``judge`` over the answers of ``calls``, and the
    count of pools that are not the reference's own bit for bit."""
    import torch
    stats = _stats(cat, device, torch.float64)
    jd = judge.Judge(cat, device)
    worst = dict.fromkeys(judge.NUMBERS, 0.0)
    worst["stats_err"] = judge.stats_err(prog_stats, stats)
    ties = 0
    for c in calls:
        if c.answers is None:
            continue
        for req, rec in zip(c.requests, c.answers):
            got = _answer(rec, cat, rows)
            readings, own = jd.readings(stats, req, got)
            for n, v in readings.items():
                worst[n] = max(worst[n], float(v))
            ties += not judge.same_pool(got, own)
    return worst, ties


def _control(cat, calls, device) -> dict:
    """The control: the reference in bfloat16, put in the program's place
    for the same requests, judged as the program is."""
    import torch
    stats = _stats(cat, device, torch.float64)
    low_stats = _stats(cat, device, torch.bfloat16)
    jd = judge.Judge(cat, device)
    low = judge.Judge(cat, device, dtype=torch.bfloat16)
    worst = dict.fromkeys(judge.NUMBERS, 0.0)
    worst["stats_err"] = judge.stats_err(
        low_stats.to(torch.float64).cpu().numpy(), stats)
    for c in calls:
        if c.answers is None:
            continue
        for req in c.requests:
            readings, _ = jd.readings(stats, req, low.answer(low_stats, req))
            for n, v in readings.items():
                worst[n] = max(worst[n], float(v))
    return worst


def scanned_lanes(got: ref.Answer, max_types) -> int:
    """The lanes Algorithm 1's scan reads for an answer, from its
    iteration count (which the judge holds against the reference's)."""
    if got.iterations >= 2:
        return got.iterations
    m = len(got.counts)
    L = judge.Judge._length(got, m, got.considered, max_types)
    return got.considered + 1 if L == got.considered else 1


def _work(cat, calls, rows) -> dict:
    """The least seconds the window's kernel calls need (``bounds``)."""
    from . import bounds
    K = len(cat)
    out = {"score_fuse": 0.0, "pool_scan": 0.0}
    for c in calls:
        if c.answers is None:
            continue
        B = len(c.requests)
        U = len({judge.filter_key(r) for r in c.requests})
        lanes = sum(min(scanned_lanes(_answer(a, cat, rows), r.get("max_types")),
                        K) for r, a in zip(c.requests, c.answers))
        out["score_fuse"] += bounds.least_s(*bounds.score_fuse_work(B, K, U))
        out["pool_scan"] += bounds.least_s(*bounds.pool_scan_work(B, K, lanes))
    return out
