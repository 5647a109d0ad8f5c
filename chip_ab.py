#!/usr/bin/env python3
"""Compare this checkout's MoE up-projection (B7) and WKV6 scan (B5)
kernels, and the prefill they serve, with another checkout's, on one
NVIDIA GPU, in turns within one process tree.

Usage, from the repository root::

    git archive <commit> | tar -x -C build/other
    python3 chip_ab.py build/other

Runs one worker process per side in the order other, this, this, other
(each builds its own checkout's kernels into that checkout's ``build/``)
and prints one JSON line per worker, then the medians per side:

- ``b7_ms``: ``moe_gmm`` (kernel B7) at DeepSeek-V2-Lite's prefill (E = 64,
  C = 240, D = 2048, F = 1408) and decode (C = 8) shapes, on seeded bf16
  operands; ``b5_ms``: ``rwkv6_scan`` (kernel B5) at rwkv6-7b's prefill
  shape (16, 128, 64, 64).  Each the median over 5 rounds of CUDA events
  around 20 calls, after 3 warm-up calls.
- ``prefill_ms`` / ``decode_ms``: DeepSeek-V2-Lite and rwkv6-7b at full
  width and depth (bf16 weights drawn on the card from a seed,
  ``use_pallas=True``), 16 prompts of 128 tokens: the median of 5
  prefills after one warm-up, and of the 20 decode steps that follow the
  last 5 (host clock around work that ends in a synchronise).

Both checkouts must provide ``repro_torch`` with these entry points.  Exits
non-zero when CUDA is unavailable or a worker fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
ARCHS = ("deepseek-v2-lite-16b", "rwkv6-7b")
ROUNDS, CALLS, WARM = 5, 20, 3
PREFILLS, STEPS = 6, 4          # prefills (the first a warm-up), steps each


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


def worker(root: Path) -> dict:
    """Times of ``root``'s kernels and prefill (see the module docstring)."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from dataclasses import replace
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import moe_gmm, rwkv6_scan
    from repro_torch.models import get_model

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    report = {"root": str(root), "b7_ms": {}, "prefill_ms": {},
              "decode_ms": {}}
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
        del model, params, cache, logits
        torch.cuda.empty_cache()
    return report


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        print(json.dumps(worker(Path(sys.argv[2]).resolve())))
        return
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_ab: CUDA is not available")
    other = Path(sys.argv[1]).resolve()
    if not (other / "src" / "repro_torch").is_dir():
        sys.exit(f"chip_ab: no src/repro_torch in {other}")
    runs = []
    for side, root in (("other", other), ("this", ROOT), ("this", ROOT),
                       ("other", other)):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--worker", str(root)],
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

    keys = [("b7_ms", "prefill"), ("b7_ms", "decode"), ("b5_ms",)]
    keys += [(kind, arch) for kind in ("prefill_ms", "decode_ms")
             for arch in ARCHS]
    print(json.dumps({"/".join(k): {"other": median("other", *k),
                                    "this": median("this", *k)}
                      for k in keys}))


if __name__ == "__main__":
    main()
