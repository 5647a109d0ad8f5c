"""Multi-pod dry-run: build and trace every (arch × shape × mesh) cell.

PyTorch counterpart of ``repro.launch.dryrun``.  Proves the distribution
config is coherent without hardware: one rank's step runs on meta tensors
over a fake group of the production mesh's 256 (512) ranks, so DTensor
must propagate every sharding; the collective schedule is recorded for
the roofline.  Nothing is allocated and nothing is sent.  A cell whose
peak exceeds the card's memory (``hw.HBM_BYTES``) still traces ``ok``, as
in the reference, but its record says ``fits_device: false``, its line
says so, and the summary lists it.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only]
Artifacts land in experiments/torch/dryrun/<arch>__<shape>__<mesh>.json.

The record keeps the reference's keys.  ``argument_bytes`` is exact (the
local shard bytes of every argument); ``peak_estimate_bytes`` is the
peak of the rank's live local tensors over the step
(``trace.rank_mem_tracker``), the arguments included, and ``temp_bytes``
that peak less the arguments; ``alias_bytes`` are the arguments the step
updates in place (a serving cache); ``cost`` holds the counted FLOPs
(products only) and eager operand bytes (``launch/trace.py``).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

from ..configs.base import SHAPES, TrainConfig
from ..configs.registry import ARCH_IDS, get_config
from . import hw
from .cells import argument_bytes, build_cell
from .mesh import fake_production_mesh
from .roofline import trace_cell

ART_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "torch" / "dryrun"


def _where() -> str:
    """The innermost frames of the exception being handled."""
    return "".join(traceback.format_exc(limit=-4).splitlines(True)[-9:])


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             verbose: bool = True, save: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape.applicable(cfg)
    mesh_tag = "multi" if multi_pod else "single"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag}
    if not ok:
        rec.update(status="skipped", reason=why)
        if verbose:
            print(f"[skip] {arch} × {shape_name}: {why}")
        return rec

    with fake_production_mesh(multi_pod=multi_pod) as mesh:
        t0 = time.time()
        cell = build_cell(cfg, shape, mesh, TrainConfig(), device="meta")
        t_build = time.time() - t0
        t0 = time.time()
        res = trace_cell(cell, memory=True)
        t_trace = time.time() - t0
        args = argument_bytes(cell)
        alias = argument_bytes(cell, cell.donate)
    coll = res["collectives"]
    rec.update(
        status="ok",
        meta=cell.meta,
        build_s=round(t_build, 2), trace_s=round(t_trace, 2),
        memory={
            "argument_bytes": args,
            "output_bytes": res["output_bytes"],
            "temp_bytes": res["peak_bytes"] - args,
            "alias_bytes": alias,
            "peak_estimate_bytes": res["peak_bytes"],
            "fits_device": res["peak_bytes"] <= hw.HBM_BYTES,
        },
        cost={"flops": res["flops"], "bytes_accessed": res["bytes"]},
        collectives=coll,
    )
    if verbose:
        mem_gb = rec["memory"]["peak_estimate_bytes"] / 2 ** 30
        over = "" if rec["memory"]["fits_device"] else \
            f" (over the card's {hw.HBM_BYTES / 1e9:.0f} GB)"
        print(f"[ok]   {arch} × {shape_name} × {mesh_tag}: "
              f"trace {t_trace:.1f}s, ~{mem_gb:.2f} GiB/device{over}, "
              f"colls {coll['counts']}", flush=True)
    if save:
        ART_DIR.mkdir(parents=True, exist_ok=True)
        out = ART_DIR / f"{arch}__{shape_name}__{mesh_tag}.json"
        out.write_text(json.dumps(rec, indent=1))
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    args = ap.parse_args()

    meshes = [False, True]
    if args.multi_pod_only:
        meshes = [True]
    if args.single_pod_only:
        meshes = [False]

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    n_ok = n_skip = n_fail = 0
    over = []
    for mp in meshes:
        for a in archs:
            for s in shapes:
                try:
                    rec = run_cell(a, s, mp)
                    if rec["status"] == "ok":
                        n_ok += 1
                        if not rec["memory"]["fits_device"]:
                            over.append(rec)
                    else:
                        n_skip += 1
                except Exception as e:  # noqa: BLE001 — report and continue
                    n_fail += 1
                    print(f"[FAIL] {a} × {s} × {'multi' if mp else 'single'}: "
                          f"{type(e).__name__}: {e}\n{_where()}", flush=True)
    print(f"\ndry-run summary: {n_ok} ok, {n_skip} skipped (documented), {n_fail} failed")
    if over:
        print(f"dry-run summary: {len(over)} of the ok cells over the card's "
              f"{hw.HBM_BYTES / 1e9:.0f} GB: " + ", ".join(
                  f"{r['arch']} × {r['shape']} × {r['mesh']} "
                  f"({r['memory']['peak_estimate_bytes'] / 2 ** 30:.2f} GiB)"
                  for r in over))
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
