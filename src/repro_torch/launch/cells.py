"""Cell builder: (arch x shape x mesh) -> step function, argument stand-ins
and shardings.

PyTorch counterpart of ``repro.launch.cells``, used by the dry-run, the
roofline pass and the card's launch phase.  :func:`build_cell` gives the
step and its arguments as meta tensors of their global shapes (the
reference's ``ShapeDtypeStruct`` trees) with a ``NamedSharding`` a leaf;
:func:`materialize_cell` makes the arguments themselves, in place of the
reference's ``lower_cell``:

- on the cell's device (CUDA unless the caller names another): seeded
  parameters, a fresh optimizer state, seeded inputs, ``init_cache``;
- on a mesh of more than one rank, each a DTensor of its sharding (the
  step is then one DTensor program over ``cfg.mesh``);
- on ``device="meta"``: meta tensors of each rank's shard, nothing
  allocated, for a trace at the production meshes.

:func:`argument_bytes` is the sum of every argument's local shard bytes,
the counterpart of ``memory_analysis().argument_size_in_bytes``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from .._tree import tree_flatten
from ..configs.base import SHAPES, ModelConfig, ShapeConfig, TrainConfig
from ..models import encdec, lm
from ..models.api import Model, get_model
from ..parallel import sharding as shd
from ..parallel.sharding import NamedSharding, P
from ..train import optim as optim_lib
from ..train import step as step_lib


@dataclass
class CellBuild:
    fn: Callable
    args: tuple                 # meta tensors of the global shapes
    in_shardings: tuple
    out_shardings: Any
    model: Model
    cfg: ModelConfig
    tcfg: TrainConfig
    meta: dict
    donate: tuple = ()          # argnums the step updates in place (the cache)
    shape: ShapeConfig | None = None


def _tp(mesh: DeviceMesh) -> int:
    return shd.mesh_shape(mesh).get("model", 1)


def pick_grad_accum(cfg: ModelConfig, shape: ShapeConfig, mesh: DeviceMesh) -> int:
    """Microbatch count so per-microbatch activation residency fits ~5 GiB.

    Accounts for the three dominant per-microbatch terms:
    - remat boundary residuals: (B/G, S, D) bf16 × units (SP-sharded),
    - loss logits: (B/G, S, V/tp) bf16+fp32,
    - attention score transients: (B/G, KV*Grp/tp?, S, chunk) fp32.
    """
    dp = shd.dp_size(mesh)
    tp = _tp(mesh)
    if cfg.dp_only:
        dp, tp = dp * tp, 1
    b_loc = max(shape.global_batch // dp, 1)
    S = shape.seq_len
    sp = tp if (cfg.sp and S % tp == 0) else 1
    units = max(cfg.num_units, 1)

    boundary = b_loc * S * cfg.d_model * 2 * units // sp
    v_loc = cfg.padded_vocab // tp if cfg.padded_vocab % tp == 0 else cfg.padded_vocab
    logits = b_loc * S * v_loc * 6          # bf16 + fp32 copies
    heads_sharded = cfg.padded_heads % tp == 0
    h_loc = cfg.padded_heads // tp if heads_sharded else cfg.padded_heads
    chunk = min(cfg.attn_chunk * 2, S)      # direct path threshold
    scores = b_loc * h_loc * S * chunk * 4
    # empirical fwd+bwd working-set multiplier over the modelled terms
    # (calibrated against compiled temp_bytes on the hybrid/dense cells)
    per_mb_at_g1 = int(3.5 * (boundary + logits + scores))

    budget = 5 * 2 ** 30
    g = int(min(max(1, -(-per_mb_at_g1 // budget)), b_loc))
    while b_loc % g != 0:      # round up to the next divisor of b_loc
        g += 1
    return g


def _replicated(mesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _cut(cfg: ModelConfig, shape: ShapeConfig) -> None:
    """Print how ``shape`` cuts the named cell it stands for."""
    full = SHAPES.get(shape.name)
    if full is None or full == shape:
        return
    parts = [f"{k} {getattr(full, k)} -> {getattr(shape, k)}"
             for k in ("global_batch", "seq_len", "kind")
             if getattr(full, k) != getattr(shape, k)]
    print(f"cell {cfg.arch_id} x {shape.name} cut: {', '.join(parts)}")


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: DeviceMesh,
               tcfg: TrainConfig | None = None, *,
               grad_accum: int | None = None, device=None) -> CellBuild:
    """The cell of ``cfg`` at ``shape`` on ``mesh``; its model lives on
    ``device`` (CUDA when ``None``, ``"meta"`` for a dry-run).  ``shape``
    may be a ``ShapeConfig`` that ``SHAPES`` lacks (a cut batch): the cut
    is printed."""
    _cut(cfg, shape)
    tp = _tp(mesh)
    if cfg.dp_only:
        tp = 1   # weights replicated: no TP padding/kv-replication needed
    cfg = dataclasses.replace(cfg.with_parallelism(tp), mesh=mesh)
    model = get_model(cfg, device=device)
    pstructs = model.shape_structs()
    pshard = shd.param_shardings(model.structure(), mesh, dp_only=cfg.dp_only)
    inputs = model.input_specs(shape)
    bshard = shd.batch_shardings(inputs, mesh, dp_only=cfg.dp_only)
    meta = {"arch": cfg.arch_id, "shape": shape.name,
            "mesh": dict(zip(shd.axis_names(mesh), mesh.shape)),
            "num_params": model.num_params()}

    if shape.kind == "train":
        tcfg = tcfg or TrainConfig()
        ga = grad_accum if grad_accum is not None else pick_grad_accum(cfg, shape, mesh)
        tcfg = dataclasses.replace(tcfg, grad_accum=ga)
        meta["grad_accum"] = ga
        state_structs = step_lib.TrainState(
            params=pstructs, opt=optim_lib.init_opt_state(pstructs, tcfg))
        oshard = shd.opt_shardings(model.structure(), mesh, zero1=tcfg.zero1,
                                   dp_only=cfg.dp_only)
        state_shard = step_lib.TrainState(
            params=pshard,
            opt=optim_lib.OptState(mu=oshard, nu=oshard,
                                   master=oshard if tcfg.master_weights else None,
                                   count=_replicated(mesh)))
        fn = step_lib.build_train_step(model, tcfg, grad_shardings=oshard)
        return CellBuild(fn, (state_structs, inputs),
                         (state_shard, bshard), (state_shard, _replicated(mesh)),
                         model, cfg, tcfg, meta, shape=shape)

    family = encdec if cfg.encdec else lm
    cache = family.init_cache(cfg, shape.global_batch, shape.seq_len, "meta")
    cshard = shd.cache_shardings(cache, mesh)
    if shape.kind == "prefill":
        fn = step_lib.build_prefill_step(model)
        return CellBuild(fn, (pstructs, inputs, cache),
                         (pshard, bshard, cshard), (None, cshard),
                         model, cfg, tcfg or TrainConfig(), meta, donate=(2,),
                         shape=shape)

    # decode: one new token against a seq_len-deep cache
    index = torch.empty((), dtype=torch.int32, device="meta")
    fn = step_lib.build_decode_step(model)
    return CellBuild(fn, (pstructs, inputs["token"], cache, index),
                     (pshard, bshard["token"], cshard, _replicated(mesh)),
                     (None, cshard), model, cfg, tcfg or TrainConfig(), meta,
                     donate=(2,), shape=shape)


def local_bytes(t: torch.Tensor, sharding: NamedSharding) -> int:
    """The bytes of this rank's shard of ``t`` (a stand-in of the global
    shape)."""
    n = 1
    for d in shd.local_shape(tuple(t.shape), sharding):
        n *= d
    return n * t.element_size()


def argument_bytes(cell: CellBuild, argnums=None) -> int:
    """The sum of the local shard bytes of every argument (of ``argnums``
    only, when given)."""
    total = 0
    for i, (arg, shard) in enumerate(zip(cell.args, cell.in_shardings)):
        if argnums is not None and i not in argnums:
            continue
        for a, s in zip(tree_flatten(arg)[0], tree_flatten(shard)[0]):
            total += local_bytes(a, s)
    return total


def tree_local_bytes(tree) -> int:
    """The bytes a tree of tensors and DTensors holds on this rank."""
    total = 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def materialize_cell(cell: CellBuild, generator: torch.Generator | None, *,
                     params=None):
    """The arguments of ``cell.fn`` (see the module's docstring), drawn
    from ``generator`` (a seeded ``torch.Generator`` on the cell's device;
    unused on meta): parameters first, then the inputs.  A decode index is
    ``seq_len - 1``, a plain tensor (a Python int on meta, where the step
    cannot read a tensor's value).  ``params``, whole parameters of the
    cell's model already on its device, are taken instead of a new draw
    (two serving cells on one set of weights)."""
    model, shape = cell.model, cell.shape
    dev = model.device
    mesh = cell.cfg.mesh
    sharded = mesh is not None and mesh.size() > 1

    if dev.type == "meta":
        def make(t, s):
            if not sharded:
                return torch.empty(t.shape, dtype=t.dtype, device="meta")
            loc = shd.local_shape(tuple(t.shape), s)
            return DTensor.from_local(
                torch.empty(loc, dtype=t.dtype, device="meta"), s.mesh,
                s.placements, run_check=False)

        args = []
        for i, (arg, shard) in enumerate(zip(cell.args, cell.in_shardings)):
            if shape.kind == "decode" and i == 3:
                args.append(shape.seq_len - 1)
                continue
            a, rebuild = tree_flatten(arg)
            args.append(rebuild([make(t, s) for t, s in
                                 zip(a, tree_flatten(shard)[0])]))
        return tuple(args)

    if params is None:
        params = model.init(generator)
    if shape.kind == "train":
        whole = (step_lib.TrainState(
            params, optim_lib.init_opt_state(params, cell.tcfg)),
            model.realize_inputs(shape, generator))
    else:
        inputs = model.realize_inputs(shape, generator)
        cache = model.init_cache(shape.global_batch, shape.seq_len)
        if shape.kind == "prefill":
            whole = (params, inputs, cache)
        else:
            whole = (params, inputs["token"], cache,
                     torch.tensor(shape.seq_len - 1, dtype=torch.int32,
                                  device=dev))
    if not sharded:
        return whole
    # the decode index stays a plain tensor: the step reads its value
    return tuple(shd.shard_tree(w, s) if i < 3 else w
                 for i, (w, s) in enumerate(zip(whole, cell.in_shardings)))
