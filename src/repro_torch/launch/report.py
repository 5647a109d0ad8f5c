"""Assemble the dry-run and roofline tables from the port's artifacts.

PyTorch counterpart of ``repro.launch.report``: the same two tables, read
from ``experiments/torch/dryrun`` and ``experiments/torch/roofline``.

    PYTHONPATH=src python -m repro_torch.launch.report    # print to stdout
"""
from __future__ import annotations

import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[3]
DRY = ROOT / "experiments" / "torch" / "dryrun"
ROOF = ROOT / "experiments" / "torch" / "roofline"

DRYRUN_NOTE = ("*TFLOP/dev counted by the port's trace of one rank's step "
               "(`torch.utils.flop_counter` formulas: products only, every "
               "loop iteration counted).")
ROOFLINE_NOTE = ("*judged with the fused-execution memory floor at the H100's "
                 "3.35 TB/s; the upper value is the eager operand bytes of "
                 "every op (counts every unfused elementwise pass — "
                 "pessimistic for fused kernels).  Compute counts products "
                 "only (`FlopCounterMode`), at 989 TFLOP/s bf16.")


def _fmt_bytes(b):
    return f"{b / 2**30:.2f}"


def dryrun_table(dry=None) -> str:
    rows = []
    for p in sorted((dry or DRY).glob("*.json")):
        d = json.loads(p.read_text())
        if d.get("status") == "skipped":
            rows.append((d["arch"], d["shape"], d["mesh"], "skip",
                         "—", "—", "—", "—"))
            continue
        mem = d["memory"]
        coll = d["collectives"]["counts"]
        coll_s = " ".join(f"{k.split('-')[-1][:4]}:{v}" for k, v in sorted(coll.items()))
        ga = d["meta"].get("grad_accum", "—")
        rows.append((d["arch"], d["shape"], d["mesh"], "ok",
                     _fmt_bytes(mem["peak_estimate_bytes"]),
                     f"{(d['cost']['flops'] or 0) / 1e12:.2f}",
                     str(ga), coll_s))
    out = ["| arch | shape | mesh | status | peak GiB/dev | HLO TFLOP/dev* | ga | collectives |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append("| " + " | ".join(str(x) for x in r) + " |")
    out.append("")
    out.append(DRYRUN_NOTE)
    return "\n".join(out)


def roofline_table(roof=None) -> str:
    rows = []
    for p in sorted((roof or ROOF).glob("*.json")):
        d = json.loads(p.read_text())
        floor = d.get("memory_floor_s", 0.0)
        bound_floor = max(d["compute_s"], floor, d["collective_s"])
        frac = d["compute_s"] / bound_floor if bound_floor else 0.0
        rows.append((d["arch"], d["shape"],
                     f"{d['compute_s']:.3e}",
                     f"{floor:.2e}–{d['memory_s']:.2e}",
                     f"{d['collective_s']:.3e}",
                     d.get("bottleneck_floor", d["bottleneck"]),
                     f"{frac:.2f}", f"{d['useful_ratio']:.2f}"))
    out = ["| arch | shape | compute (s) | memory floor–upper (s) | "
           "collective (s) | bottleneck* | roofline frac* | useful-FLOPs |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append("| " + " | ".join(r) + " |")
    out.append("")
    out.append(ROOFLINE_NOTE)
    return "\n".join(out)


def main() -> None:
    print("## Dry-run\n")
    print(dryrun_table())
    print("\n## Roofline\n")
    print(roofline_table())


if __name__ == "__main__":
    main()
