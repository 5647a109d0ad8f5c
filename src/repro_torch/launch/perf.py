"""Perf hillclimb: evaluate named variants of a cell's roofline terms.

PyTorch counterpart of ``repro.launch.perf``.  Each variant is a config
delta over the arch's production config, counted by the port's
``roofline_cell`` (one rank traced on meta tensors over the fake 16 x 16
group).  Results append to
``experiments/torch/perf/<arch>__<shape>.json``.

    PYTHONPATH=src python -m repro_torch.launch.perf --arch deepseek-v2-lite-16b \\
        --shape train_4k --variant baseline --variant moe_shardmap
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib

from ..configs.base import SHAPES
from ..configs.registry import ARCH_IDS, get_config
from .mesh import fake_production_mesh
from .roofline import roofline_cell

ART = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "torch" / "perf"

# variant name -> config field deltas
VARIANTS: dict[str, dict] = {
    "baseline": {},
    "moe_scatter": {"moe_impl": "scatter"},
    "moe_shardmap": {"moe_impl": "shardmap"},
    "no_sp": {"sp": False},
    "sp": {"sp": True},
    "remat_dots": {"remat_policy": "dots"},
    "remat_nothing": {"remat_policy": "nothing"},
    "chunk_512": {"attn_chunk": 512},
    "chunk_1024": {"attn_chunk": 1024},
    "chunk_2048": {"attn_chunk": 2048},
    "chunk_4096": {"attn_chunk": 4096},
    "no_remat": {"remat": False},
    "fused_ce": {"fused_ce": True},
    "pure_dp": {"dp_only": True, "sp": False},
    "pure_dp_fused_ce": {"dp_only": True, "sp": False, "fused_ce": True},
}


def run_variant(arch: str, shape: str, variant: str, extra: dict | None = None,
                *, mesh=None):
    """One variant's row, appended to the arch's artifact (``mesh``: the
    production mesh over a fake group when ``None``)."""
    if mesh is None:
        with fake_production_mesh() as prod:
            return run_variant(arch, shape, variant, extra, mesh=prod)
    deltas = dict(VARIANTS[variant])
    deltas.update(extra or {})
    cfg = dataclasses.replace(get_config(arch), **deltas)
    res = roofline_cell(arch, shape, cfg_override=cfg, save=False,
                        mesh=mesh, tag=variant)
    row = {
        "variant": variant, "deltas": deltas,
        "compute_s": res.compute_s, "memory_s": res.memory_s,
        "collective_s": res.collective_s, "bottleneck": res.bottleneck,
        "bound_s": max(res.compute_s, res.memory_s, res.collective_s),
        "memory_floor_s": res.memory_floor_s,
        "bound_floor_s": max(res.compute_s, res.memory_floor_s, res.collective_s),
        "bottleneck_floor": res.bottleneck_floor,
        "useful_ratio": res.useful_ratio,
        "coll_detail": res.detail["trace"]["coll_detail"],
    }
    ART.mkdir(parents=True, exist_ok=True)
    path = ART / f"{arch}__{shape}.json"
    log = json.loads(path.read_text()) if path.exists() else []
    log.append(row)
    path.write_text(json.dumps(log, indent=1, default=str))
    return row


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--shape", choices=list(SHAPES), required=True)
    ap.add_argument("--variant", action="append", required=True)
    args = ap.parse_args()
    with fake_production_mesh() as mesh:
        for v in args.variant:
            row = run_variant(args.arch, args.shape, v, mesh=mesh)
            print(f"[{v:>14}] compute {row['compute_s']:.3e}  memory "
                  f"{row['memory_s']:.3e}  collective {row['collective_s']:.3e}  "
                  f"bound {row['bound_s']:.3e} ({row['bottleneck']})", flush=True)


if __name__ == "__main__":
    main()
