"""Roofline terms of a cell, from one rank's step traced on meta tensors.

PyTorch counterpart of ``repro.launch.roofline``.  The reference
differences XLA's ``cost_analysis()`` over two unrolled depths and two
attention chunk counts, because XLA counts a while loop's body once.  The
port's layer stack, attention chunks and recurrent scans are Python loops:
every iteration dispatches its ops, so :class:`~.trace.StepCounter` sees
each one and nothing needs differencing (``tests/test_torch_cells.py``
holds the count equal at two chunk sizes, where a body counted once would
not be).  :func:`roofline_cell` builds the cell on the meta device over a
fake group of the production mesh's size (:func:`~.mesh.fake_production_mesh`)
and counts:

- FLOPs: ``torch.utils.flop_counter``'s formulas (products only) on each
  local op.  A kernel's work is counted through its plain version (the
  meta trace takes the plain route), as the reference counts its ``lax``
  route rather than the Pallas body;
- bytes: each op's operand and result bytes, the eager upper value (the
  counterpart of XLA:CPU's unfused ``bytes accessed``);
  :func:`analytic_memory_floor` stays the floor;
- wire bytes: :func:`collective_wire_bytes` over the collectives the rank
  issues, with the reference's ring factors.

Terms (H100 figures in ``launch/hw.py``)::

    compute    = flops_per_device / PEAK_FLOPS_BF16
    memory     = bytes_per_device / HBM_BW
    collective = wire_bytes_per_device / NVLINK_BW

The reference divides wire bytes by ``2 * ICI_BW_PER_LINK`` (two TPU
links); an H100 moves them over NVLink at 450 GB/s a direction.  As in the
reference the cost pass runs at ``grad_accum=1``: accumulation adds only
O(params) work and defers the same reduction.

    PYTHONPATH=src python -m repro_torch.launch.roofline --arch qwen2-0.5b \\
        --shape train_4k

Artifacts land in ``experiments/torch/roofline/<arch>__<shape>.json``.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from dataclasses import dataclass

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .._tree import tree_leaves
from ..configs.base import SHAPES, ShapeConfig, TrainConfig
from ..configs.registry import get_config
from ..models.param import count_params
from ..parallel import sharding as shd
from . import hw
from .cells import (CellBuild, argument_bytes, build_cell, materialize_cell,
                    tree_local_bytes)
from .mesh import fake_production_mesh
from .trace import (Collective, StepCounter, card_redistributions,
                    rank_mem_tracker)

ART_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "torch" / "roofline"


def collective_wire_bytes(records: list[Collective]) -> dict:
    """Per-device wire bytes with ring-algorithm factors per collective kind."""
    per_kind: dict[str, float] = {}
    for rec in records:
        out_bytes = rec.bytes
        kind = rec.kind
        n = max(rec.group, 1)
        if kind == "all-reduce":
            wire = 2.0 * (n - 1) / n * out_bytes
        elif kind == "all-gather":
            wire = (n - 1) / n * out_bytes
        elif kind == "reduce-scatter":
            wire = (n - 1) / n * out_bytes * n     # input = output * n
        elif kind == "all-to-all":
            wire = (n - 1) / n * out_bytes
        else:                                      # collective-permute
            wire = float(out_bytes)
        per_kind[kind] = per_kind.get(kind, 0.0) + wire
    per_kind["total"] = sum(v for k, v in per_kind.items() if k != "total")
    return per_kind


def trace_cell(cell: CellBuild, *, memory: bool = False) -> dict:
    """Run ``cell`` once on meta arguments (its model must be on the meta
    device) and count one rank's work: ``flops``, ``bytes``, ``wire`` and
    ``coll_detail`` (by kind), ``collectives`` (the reference's
    ``parse_collectives`` record), ``output_bytes`` and
    ``read_argument_bytes`` (the local bytes of the tensor arguments the
    step needs as inputs, ``StepCounter.needs``: what a jitted module keeps
    as arguments).  With ``memory``, also ``peak_bytes``: the peak of the
    rank's live local tensors (``trace.rank_mem_tracker``), the arguments
    included."""
    if cell.model.device.type != "meta":
        raise ValueError("trace_cell traces a cell built on device='meta'")
    args = materialize_cell(cell, None)
    counter = StepCounter()
    tracker = None
    with card_redistributions():
        if memory:
            tracker = rank_mem_tracker()
            tracker.track_external(*[t for t in tree_leaves(args)
                                     if isinstance(t, torch.Tensor)])
            with tracker, counter:
                out = cell.fn(*args)
        else:
            with counter:
                out = cell.fn(*args)
    wire = collective_wire_bytes(counter.collectives)
    local = [t.to_local() if isinstance(t, DTensor) else t
             for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
    res = {"flops": float(counter.flops), "bytes": float(counter.bytes),
           "wire": wire["total"], "coll_detail": wire,
           "collectives": counter.summary(),
           "output_bytes": tree_local_bytes(out),
           "read_argument_bytes": sum(
               t.numel() * t.element_size() for t in local
               if counter.needs(t)),
           "meta": cell.meta}
    if tracker is not None:
        snap = tracker.get_tracker_snapshot("peak")
        res["peak_bytes"] = int(sum(d.get("Total", 0) for d in snap.values()))
    return res


def model_flops(cfg, shape) -> float:
    """6*N*D (train) / 2*N*D (prefill) / per-token (decode), MoE-active-aware."""
    from ..models import get_model
    model = get_model(cfg, device="meta")
    total = count_params(model.structure())
    if cfg.moe is not None:
        m = cfg.moe
        expert_params = (3 * cfg.d_model * m.d_ff) * m.num_experts \
            * (cfg.num_layers - m.first_dense_layers)
        inactive = expert_params * (1.0 - m.top_k / m.num_experts)
        total = total - inactive
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * total * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * total * tokens
    return 2.0 * total * shape.global_batch      # decode: one token per seq


def analytic_memory_floor(cfg, shape, mesh) -> float:
    """Fused-execution HBM-traffic floor (bytes/device/step).

    The eager operand count (``bytes``) counts every unfused elementwise
    pass and is therefore a loose *upper* bound on HBM traffic (a fused
    kernel keeps elementwise chains in registers and shared memory).  This
    floor counts only the irreducible traffic:

    - weights: bf16 params read fwd + bwd + remat-recompute (train) or once;
    - optimizer: fp32 grads/m/v/master read+write (ZeRO-sharded);
    - boundary activations: save + reload per unit per microbatch (SP-sharded);
    - KV/state streaming for attention (cache read per decode/prefill);
    - logits + CE traffic.
    """
    from ..models import get_model
    sizes = shd.mesh_shape(mesh)
    tp = sizes["model"] if "model" in sizes else 1
    dp = mesh.size() // tp
    model = get_model(cfg, device="meta")
    n_params = count_params(model.structure())
    # fraction of params that shard over model: approximate via spec walk
    sharded = 0
    for spec in tree_leaves(model.structure()):
        ps = shd.param_pspec(spec.axes, spec.shape, mesh)
        size = int(np.prod(spec.shape)) * 2
        frac = 1.0
        for dim, p_ in zip(spec.shape, ps):
            if p_ == "model":
                frac /= tp
        sharded += size * frac
    params_dev = sharded                              # bf16 bytes/device

    B_loc = max(shape.global_batch // dp, 1)
    S = shape.seq_len
    D = cfg.d_model
    V_loc = cfg.padded_vocab // tp if cfg.padded_vocab % tp == 0 else cfg.padded_vocab

    if shape.kind == "train":
        weights = params_dev * 3                      # fwd + bwd + remat
        opt = (n_params * 4 / max(dp * tp, 1)) * 8    # grads+m+v+master rw
        sp = tp if (cfg.sp and S % tp == 0) else 1
        units = max(cfg.num_units, 1)
        acts = B_loc * S * D * 2 // sp * units * 2
        logits = B_loc * S * V_loc * (2 + 4) * (1 if cfg.fused_ce else 2)
        kv = B_loc * S * cfg.kv_heads_effective // max(tp, 1) * cfg.head_dim * 2 * 2 \
            * cfg.num_layers * 3
        return float(weights + opt + acts + logits + kv)
    if shape.kind == "prefill":
        weights = params_dev
        kv = B_loc * S * cfg.kv_heads_effective // max(tp, 1) * cfg.head_dim * 2 * 2 \
            * cfg.num_layers * 2                      # write + stream once
        acts = B_loc * S * D * 2 * max(cfg.num_units, 1) // max(tp, 1)
        return float(weights + kv + acts)
    # decode: weights + full cache read per token + state
    weights = params_dev
    if cfg.mla:
        per_tok = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim
        cache = B_loc * S * per_tok * 2 * cfg.num_layers
    elif cfg.family in ("ssm", "hybrid"):
        att_layers = sum(1 for i in range(cfg.num_layers)
                         if cfg.block_pattern[i % cfg.repeat_unit] == "attn")
        win = min(cfg.window or S, S)
        cache = B_loc * win * cfg.kv_heads_effective // max(tp, 1) \
            * cfg.head_dim * 2 * 2 * att_layers
        cache += B_loc * cfg.padded_heads // max(tp, 1) * cfg.head_dim ** 2 \
            * 4 * cfg.num_layers                      # recurrent state rw
    else:
        cache = B_loc * S * cfg.kv_heads_effective // max(tp, 1) \
            * cfg.head_dim * 2 * 2 * cfg.num_layers
    return float(weights + cache)


@dataclass
class RooflineResult:
    arch: str
    shape: str
    compute_s: float
    memory_s: float
    collective_s: float
    flops_dev: float
    bytes_dev: float
    wire_dev: float
    model_flops: float
    hlo_flops_total: float
    useful_ratio: float
    bottleneck: str
    detail: dict
    memory_floor_s: float = 0.0
    bottleneck_floor: str = ""    # bottleneck judged with the fused floor

    def row(self) -> dict:
        return dataclasses.asdict(self)


def roofline_cell(arch: str, shape_name: str, *, save: bool = True, mesh=None,
                  cfg_override=None, tag: str = "",
                  shape: ShapeConfig | None = None,
                  grad_accum: int = 1,
                  memory: bool = False) -> RooflineResult | None:
    """Roofline terms of one rank's step (see the module's docstring), on
    ``mesh`` (the 16 x 16 production mesh over a fake group when
    ``None``).  ``shape`` replaces ``SHAPES[shape_name]`` for a cut cell;
    ``grad_accum`` is the cost pass's microbatch count (1, as the
    reference's; a cut cell's own count for a comparison with its run);
    ``memory`` also records the trace's peak (``trace_cell``)."""
    if mesh is None:
        with fake_production_mesh() as prod:
            return roofline_cell(arch, shape_name, save=save, mesh=prod,
                                 cfg_override=cfg_override, tag=tag,
                                 shape=shape, grad_accum=grad_accum,
                                 memory=memory)
    cfg = cfg_override or get_config(arch)
    shape = shape or SHAPES[shape_name]
    ok, why = shape.applicable(cfg)
    if not ok:
        return None
    cell = build_cell(cfg, shape, mesh, TrainConfig(), grad_accum=grad_accum,
                      device="meta")
    res = trace_cell(cell, memory=memory)
    cfgp = cell.cfg
    compute_s = res["flops"] / hw.PEAK_FLOPS_BF16
    memory_s = res["bytes"] / hw.HBM_BW
    coll_s = res["wire"] / hw.NVLINK_BW
    mf = model_flops(cfgp, shape)
    hlo_total = res["flops"] * mesh.size()
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    floor_s = analytic_memory_floor(cfgp, shape, mesh) / hw.HBM_BW
    terms_floor = {"compute": compute_s, "memory": floor_s, "collective": coll_s}
    res["argument_bytes"] = argument_bytes(cell)
    out = RooflineResult(
        arch=arch, shape=shape_name,
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        flops_dev=res["flops"], bytes_dev=res["bytes"], wire_dev=res["wire"],
        model_flops=mf, hlo_flops_total=hlo_total,
        useful_ratio=mf / hlo_total if hlo_total else 0.0,
        bottleneck=max(terms, key=terms.get),
        memory_floor_s=floor_s,
        bottleneck_floor=max(terms_floor, key=terms_floor.get),
        detail={"trace": res, "tag": tag},
    )
    if save:
        ART_DIR.mkdir(parents=True, exist_ok=True)
        path = ART_DIR / f"{arch}__{shape_name}.json"
        path.write_text(json.dumps(out.row(), indent=1, default=str))
    return out


def main() -> None:
    import argparse

    from .dryrun import _where
    from ..configs.registry import ARCH_IDS
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args()
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    n_fail = 0
    with fake_production_mesh() as mesh:
        for a in archs:
            for s in shapes:
                try:
                    r = roofline_cell(a, s, mesh=mesh)
                except Exception as e:  # noqa: BLE001
                    n_fail += 1
                    print(f"[FAIL] {a} × {s}: {e}\n{_where()}", flush=True)
                    continue
                if r is None:
                    print(f"[skip] {a} × {s}", flush=True)
                    continue
                print(f"[ok]   {a} × {s}: compute {r.compute_s:.3e}s  memory "
                      f"{r.memory_s:.3e}s  collective {r.collective_s:.3e}s  "
                      f"bottleneck={r.bottleneck}  useful={r.useful_ratio:.2f}",
                      flush=True)
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
