#!/usr/bin/env python3
"""Compare this checkout's MoE up-projection (B7), WKV6 scan (B5), RG-LRU
scan (B6), fused scoring (B1), pool scan (B2) and stats update (B3)
kernels, and the prefill, serving and ingestion they feed, with another
checkout's, on one NVIDIA GPU, in turns within one process tree.

Usage, from the repository root::

    git archive <commit> | tar -x -C build/other
    python3 chip_ab.py build/other [--skip-lm]

Runs one worker process per side in the order other, this, this, other
(each builds its own checkout's kernels into that checkout's ``build/``)
and prints one JSON line per worker, then the medians per side:

- ``b7_ms``: ``moe_gmm`` (kernel B7) at DeepSeek-V2-Lite's prefill (E = 64,
  C = 240, D = 2048, F = 1408) and decode (C = 8) shapes, on seeded bf16
  operands; ``b5_ms``: ``rwkv6_scan`` (kernel B5) at rwkv6-7b's prefill
  shape (16, 128, 64, 64); ``b6_ms``: ``rglru_scan`` (kernel B6) at
  recurrentgemma-2b's prefill shape (16, 128, 2560); ``b1_ms``:
  ``score_fuse_batch`` (kernel B1) at the serving shape, 16 mixed requests
  (U > 1 unique filter masks) over the K = 32768 archive of
  ``chip_smoke.candidates``.  Each the median over 5 rounds of CUDA events
  around 20 calls, after 3 warm-up calls.  B1's call is host-bound, so
  ``b1_device_ms`` and ``b6_device_ms`` add the kernels' own device time
  per call from a ``torch.profiler`` trace of 20 calls.
- ``b2_device_ms``: every device item (kernels, memsets, copies) of one
  ``pool_scan`` call (kernel B2) on the sorted rows of 16, 64 and 256 such
  requests (the server's buckets; the 16 are B1's), per call over 20
  profiled calls; ``b2_never_device_ms`` the same on 16 rows that never
  stop (all-ones scores and capacities, R = 2e9);
  ``b2_resident_clusters``: how many of B2's clusters the card holds at
  once, where the checkout's B2 is one cluster launch.
- ``append_ms``: per ring tier (float32, int8, bfloat16), the median
  ``LiveIngestor.poll`` of one tick over 200 ticks after 10 warm-ups, on a
  K = 32768 ring of 1008 primed with 504 columns (``chip_smoke``'s feed),
  host clock between two synchronises; ``append_kernels`` /
  ``append_copies``: the device's kernels and copies a poll over 20
  profiled polls; ``b3_device_ms``: every device item of one
  ``stats_update`` call (kernel B3) on that ring's tier.
- ``prefill_ms`` / ``decode_ms``: DeepSeek-V2-Lite, rwkv6-7b and
  recurrentgemma-2b at full width and depth (bf16 weights drawn on the
  card from a seed, ``use_pallas=True``), 16 prompts of 128 tokens: the
  median of 5 prefills after one warm-up, and of the 20 decode steps that
  follow the last 5 (host clock around work that ends in a synchronise);
  ``prefill_device_ms``: the device time of every kernel of one prefill
  (mean of two, from a ``torch.profiler`` trace), which host speed does
  not move.
- ``serve_ms``: ``BatchServer.serve`` of 16 mixed requests on that archive,
  the median of 30 calls after 3 warm-ups (host clock; ``serve`` ends in
  device-to-host copies).

``--skip-lm`` leaves out B7, B5, B6 and the three models.  Both checkouts
must provide ``repro_torch`` with these entry points.  Exits non-zero when
CUDA is unavailable or a worker fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
ARCHS = ("deepseek-v2-lite-16b", "rwkv6-7b", "recurrentgemma-2b")
ROUNDS, CALLS, WARM = 5, 20, 3
PREFILLS, STEPS = 6, 4          # prefills (the first a warm-up), steps each
SERVE_CALLS = 30
TIERS = ("float32", "int8", "bfloat16")
B2_BATCHES = (16, 64, 256)
APPENDS, APPEND_WARM, PROFILED_POLLS = 200, 10, 20


def event_ms(torch, fn) -> float:
    """Median per-call time of ``fn`` over ``ROUNDS`` rounds of ``CALLS``."""
    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(ROUNDS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(CALLS):
            fn()
        b.record()
        torch.cuda.synchronize()
        rounds.append(a.elapsed_time(b) / CALLS)
    return float(np.median(rounds))


def device_ms(torch, fn, names, calls=CALLS, warm=WARM) -> float:
    """Per-call device time of the kernels whose names contain one of
    ``names`` over ``calls`` calls, from a ``torch.profiler`` trace
    (``chip_smoke.profiled``: taken again if it lost device records)."""
    import chip_smoke
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    return sum(ms for key, (_, ms, _) in chip_smoke.profiled(fn, calls).items()
               if any(n in key for n in names))


def device_items(torch, fn, calls) -> tuple[float, float]:
    """Kernels and copies (memcpy, memset) the device runs a call of
    ``fn``, over ``calls`` profiled calls."""
    import chip_smoke
    n = {"kernels": 0, "copies": 0}
    for key, (launches, _, _) in chip_smoke.profiled(fn, calls).items():
        n["copies" if key.startswith(("Memcpy", "Memset")) else "kernels"] += (
            launches)
    return n["kernels"], n["copies"]


def scoring(torch, report, dev) -> None:
    """B1 at the serving shape, and the serve call that launches it."""
    import chip_smoke
    from repro_torch.core import pool as pool_lib
    from repro_torch.core.engine import _dedup_masks
    from repro_torch.core.types import RequestBatch
    from repro_torch.kernels import pool_scan, score_fuse
    from repro_torch.serve import BatchServer, DeviceArchive

    cands = chip_smoke.candidates(chip_smoke.K_FULL, chip_smoke.T_FULL)
    archive = DeviceArchive.stage(cands, device=dev)
    stats = torch.stack(tuple(archive.score_stats()))
    reqs = chip_smoke.mixed_requests(np.random.default_rng(1),
                                     chip_smoke.B_FULL)
    batch = RequestBatch.from_requests(cands, reqs)
    uniq, inv = _dedup_masks(batch.masks)
    on = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    args = (stats, archive.prices, archive.vcpus, archive.memory_gb,
            on(batch.masks), on(batch.use_cpus), on(batch.amounts),
            on(batch.lams), on(batch.weights), on(uniq), inv)
    call = lambda: score_fuse.score_fuse_batch(*args)  # noqa: E731
    report["b1_ms"] = event_ms(torch, call)
    report["b1_device_ms"] = device_ms(
        torch, call, ("score_reduce_kernel", "score_emit_kernel"))
    report["b1_unique_masks"] = int(uniq.shape[0])

    if hasattr(pool_scan, "geometry"):   # this PR's kernel on: one launch
        report["b2_resident_clusters"] = pool_scan.geometry(dev)[3]
    report["b2_device_ms"] = {}
    for B in B2_BATCHES:
        if B != chip_smoke.B_FULL:
            b = RequestBatch.from_requests(cands, chip_smoke.mixed_requests(
                np.random.default_rng(B), B))
            u, i = _dedup_masks(b.masks)
            args = (*args[:4], on(b.masks), on(b.use_cpus), on(b.amounts),
                    on(b.lams), on(b.weights), on(u), i)
        masks, use_cpus, amounts = args[4], args[5], args[6]
        caps = torch.where(use_cpus[:, None], archive.vcpus, archive.memory_gb)
        _, s, c = pool_lib._sort_masked(
            score_fuse.score_fuse_batch(*args).comb, caps, masks)
        csc = pool_scan._clamped_prefix_sums(s)
        report["b2_device_ms"][str(B)] = device_ms(
            torch, lambda: pool_scan.pool_scan(s, c, amounts, csc), ("",))
    ones = torch.ones((chip_smoke.B_FULL, chip_smoke.K_FULL), device=dev)
    never_r = torch.full((chip_smoke.B_FULL,), chip_smoke.NEVER_R, device=dev)
    never_csc = pool_scan._clamped_prefix_sums(ones)
    report["b2_never_device_ms"] = device_ms(
        torch, lambda: pool_scan.pool_scan(ones, ones, never_r, never_csc),
        ("",))
    del archive, stats, args, s, c, csc, ones, never_csc

    server = BatchServer(device=dev, bucket_sizes=chip_smoke.BUCKETS)
    staged = server.cache.get(cands)
    staged.score_stats()
    times = []
    for i in range(WARM + SERVE_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.serve(staged, reqs)
        if i >= WARM:
            times.append((time.perf_counter() - t0) * 1e3)
    report["serve_ms"] = float(np.median(times))
    del server, staged
    torch.cuda.empty_cache()


def ingest(torch, report, dev) -> None:
    """A tick on each ring tier: the poll, its device items, and B3 alone."""
    import chip_smoke
    from repro_torch.core.config import EngineConfig
    from repro_torch.kernels import stats_update

    catalog = chip_smoke.candidates(chip_smoke.K_FULL, 1)
    for key in ("append_ms", "append_kernels", "append_copies",
                "b3_device_ms"):
        report[key] = {}
    for tier in TIERS:
        feed = chip_smoke.SyntheticFeed(catalog, seed=5,
                                        ticks=chip_smoke.INGEST_PRIME)
        ing = EngineConfig(archive_precision=tier).build_ingestor(
            feed, window=chip_smoke.INGEST_WINDOW, name="ab", device=dev)
        arch = ing.prime()

        def poll():
            feed.run(1)
            ing.poll()
        times = []
        for i in range(APPEND_WARM + APPENDS):
            feed.run(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ing.poll()
            torch.cuda.synchronize()
            if i >= APPEND_WARM:
                times.append((time.perf_counter() - t0) * 1e3)
        report["append_ms"][tier] = float(np.median(times))
        report["append_kernels"][tier], report["append_copies"][tier] = (
            device_items(torch, poll, PROFILED_POLLS))
        y_new = arch._buf[(arch._pos - 1) % arch.capacity]
        args = (arch._moments, y_new, arch._buf[arch._pos],
                arch._buf[arch._start], y_new, arch.window_len, True)
        scale = arch.scale if tier == "int8" else None
        report["b3_device_ms"][tier] = device_ms(
            torch, lambda: stats_update.stats_update(*args, scale=scale),
            ("",))
        del ing, arch, args
    torch.cuda.empty_cache()


def worker(root: Path, skip_lm: bool) -> dict:
    """Times of ``root``'s kernels and prefill (see the module docstring)."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from dataclasses import replace
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import moe_gmm, rglru_scan, rwkv6_scan
    from repro_torch.models import get_model

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    report = {"root": str(root)}
    scoring(torch, report, dev)
    ingest(torch, report, dev)
    if skip_lm:
        return report
    report.update(b7_ms={}, prefill_ms={}, decode_ms={}, prefill_device_ms={})
    w1, w3 = ((rnd(64, 2048, 1408) * 2048 ** -0.5).to(torch.bfloat16)
              for _ in range(2))
    for phase, C in (("prefill", 240), ("decode", 8)):
        x = rnd(64, C, 2048).to(torch.bfloat16)
        report["b7_ms"][phase] = event_ms(
            torch, lambda: moe_gmm.moe_gmm(x, w1, w3))
    del x, w1, w3
    r, k, v = ((rnd(16, 128, 64, 64) * 0.5).to(torch.bfloat16)
               for _ in range(3))
    log_w = -torch.exp(rnd(16, 128, 64, 64) * 0.5 - 2.0)
    u, s0 = rnd(64, 64) * 0.5, rnd(16, 64, 64, 64) * 0.1
    report["b5_ms"] = event_ms(
        torch, lambda: rwkv6_scan.rwkv6_scan(r, k, v, log_w, u, s0))
    del r, k, v, log_w, u, s0
    la = -torch.rand((16, 128, 2560), generator=g, device=dev) * 2.0
    x_in, h0 = rnd(16, 128, 2560), rnd(16, 2560)
    b6 = lambda: rglru_scan.rglru_scan(la, x_in, h0)  # noqa: E731
    report["b6_ms"] = event_ms(torch, b6)
    report["b6_device_ms"] = device_ms(torch, b6, ("rglru_kernel",))
    del la, x_in, h0

    for arch in ARCHS:
        cfg = replace(get_config(arch), use_pallas=True)
        model = get_model(cfg, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        prompt = torch.from_numpy(np.random.default_rng(7).integers(
            0, cfg.vocab_size, (16, 128))).to(dev)
        prefill, decode = [], []
        with torch.no_grad():
            for _ in range(PREFILLS):
                cache = model.init_cache(16, 128 + STEPS)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = model.prefill(params, {"tokens": prompt},
                                              cache)
                torch.cuda.synchronize()
                prefill.append((time.perf_counter() - t0) * 1e3)
                tok = logits[:, -1].argmax(-1, keepdim=True)
                for i in range(STEPS):
                    t0 = time.perf_counter()
                    logits, cache = model.decode_step(params, tok, cache,
                                                      128 + i)
                    tok = logits[:, -1].argmax(-1, keepdim=True)
                    torch.cuda.synchronize()
                    decode.append((time.perf_counter() - t0) * 1e3)
        report["prefill_ms"][arch] = float(np.median(prefill[1:]))
        report["decode_ms"][arch] = float(np.median(decode[STEPS:]))

        def two_prefills():
            for _ in range(2):
                model.prefill(params, {"tokens": prompt},
                              model.init_cache(16, 128 + STEPS))
        with torch.no_grad():
            report["prefill_device_ms"][arch] = device_ms(
                torch, two_prefills, ("",), calls=1, warm=0) / 2
        del model, params, cache, logits
        torch.cuda.empty_cache()
    return report


def main() -> None:
    args = sys.argv[1:]
    skip_lm = "--skip-lm" in args
    args = [a for a in args if a != "--skip-lm"]
    if len(args) == 2 and args[0] == "--worker":
        print(json.dumps(worker(Path(args[1]).resolve(), skip_lm)))
        return
    if len(args) != 1:
        sys.exit(__doc__)
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_ab: CUDA is not available")
    other = Path(args[0]).resolve()
    if not (other / "src" / "repro_torch").is_dir():
        sys.exit(f"chip_ab: no src/repro_torch in {other}")
    runs = []
    for side, root in (("other", other), ("this", ROOT), ("this", ROOT),
                       ("other", other)):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--worker", str(root)]
                              + ["--skip-lm"] * skip_lm,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"chip_ab: the {side} worker failed:\n"
                     f"{proc.stderr[-4000:]}")
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        report["side"] = side
        print(json.dumps(report))
        runs.append(report)

    def median(side, *keys):
        vals = []
        for rep in runs:
            if rep["side"] == side:
                val = rep
                for key in keys:
                    val = val[key]
                vals.append(val)
        return float(np.median(vals))

    keys = [("b1_ms",), ("b1_device_ms",)]
    keys += [("b2_device_ms", str(B)) for B in B2_BATCHES]
    keys += [("b2_never_device_ms",), ("serve_ms",)]
    keys += [(kind, tier) for kind in ("b3_device_ms", "append_ms",
                                       "append_kernels", "append_copies")
             for tier in TIERS]
    if not skip_lm:
        keys += [("b7_ms", "prefill"), ("b7_ms", "decode"), ("b5_ms",),
                 ("b6_ms",), ("b6_device_ms",)]
        keys += [(kind, arch)
                 for kind in ("prefill_ms", "prefill_device_ms", "decode_ms")
                 for arch in ARCHS]
    print(json.dumps({"/".join(k): {"other": median("other", *k),
                                    "this": median("this", *k)}
                      for k in keys}))


if __name__ == "__main__":
    main()
