#!/usr/bin/env python3
"""The readings that the comparison's limits are set from, on the card.

    python3 spotbench/control.py --workload <name> --seeds <a,b,...> --seconds <s>

For each seed, in one process: one run of the cell with a window of
``--seconds`` at the cell's own load, the program's answers judged against
the float64 reference (the sound readings), and the control, the reference
in bfloat16 put in the program's place on the same requests, judged alike
and given its verdict by the same rule as the program (``judge.verdict``).
Prints a JSON line a seed and, last, the widest program reading and the
narrowest control reading of each number.  Exits 1 if the program is not
correct on some seed or the control is correct on some seed.  The
benchmark's own runs never run the control.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    import torch

    from spotbench import harness, judge, spec
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    lower = dict.fromkeys(judge.NUMBERS, 0.0)
    upper = dict.fromkeys(judge.NUMBERS, float("inf"))
    sound = True
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(cell, seed, args.seconds, False, control=True)
        prog = {n: v["value"] for n, v in r["checks"].items()}
        low = r["control"]["checks"]
        for n in judge.NUMBERS:
            lower[n] = max(lower[n], prog[n])
            upper[n] = min(upper[n], low[n])
        sound &= r["correct"] and not r["control"]["correct"]
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": r["correct"],
                          "control_correct": r["control"]["correct"],
                          "attempted": r["attempted"], "program": prog,
                          "control": low}), flush=True)
    print(json.dumps({"workload": cell.name, "program_max": lower,
                      "control_min": upper, "sound": sound}))
    return 0 if sound else 1


if __name__ == "__main__":
    sys.exit(main())
