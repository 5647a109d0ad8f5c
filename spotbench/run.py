#!/usr/bin/env python3
"""Run one benchmark cell once and print its result as the last line.

    python3 spotbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``src/`` beside this folder).  The cell's
files are found through ``BENCHMARK.json``.  ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from a
``torch.profiler`` trace of the window.  Without a CUDA card, or with fewer
cards than the cell asks for, the run prints no result and exits 2; if
the process loaded JAX or the JAX package, it exits 3.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    # the port builds its kernels into build/ of this checkout; keep the
    # CUDA driver's own cache inside it too
    os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "cuda-cache"))

    import repro_torch  # noqa: F401  the program under test: without it, no run
    import torch

    from spotbench import harness, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("spotbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"spotbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"spotbench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
