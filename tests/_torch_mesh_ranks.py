"""Gloo ranks on the CPU for the port's mesh tests (``test_torch_mesh.py``).

:func:`spawn` starts ``nprocs`` ranks (``torch.multiprocessing``, start
method ``spawn``) on a ``FileStore`` in a directory of the test's own, each
on one thread, builds the ``("data", "model")`` mesh and calls a rank
function of this module with it; a rank that raises fails the test, and a
run past its timeout is ended.  This module imports torch and the port
only (no JAX), so a rank starts in a few seconds.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SPAWN_TIMEOUT_S = 120.0


def _entry(rank, world, store_path, mesh_shape, device, fn_name, args):
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)            # every rank shares the one card
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        names = ("data", "model") if len(mesh_shape) == 2 \
            else ("pod", "data", "model")
        mesh = init_device_mesh(device, mesh_shape, mesh_dim_names=names)
        globals()[fn_name](mesh, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn_name: str, workdir: Path, *args, mesh_shape=(2, 2),
          device: str = "cpu", timeout: float = SPAWN_TIMEOUT_S) -> None:
    """Run rank function ``fn_name(mesh, *args)`` on ``prod(mesh_shape)``
    gloo ranks (each on ``cuda:0`` where ``device="cuda"``); raise if a rank
    fails or the run outlasts ``timeout``."""
    world = int(np.prod(mesh_shape))
    store = Path(workdir) / f"store_{fn_name}"
    ctx = mp.start_processes(_entry, args=(world, str(store), tuple(mesh_shape),
                                           device, fn_name, args),
                             nprocs=world, start_method="spawn", join=False)
    t0 = time.monotonic()
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() - t0 > timeout:
                raise TimeoutError(f"{fn_name}: ranks still running after "
                                   f"{timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)


# ---------------------------------------------------------------------------
# shared inputs
# ---------------------------------------------------------------------------

def bf16_np(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bfloat16, held as float32 (numpy has no bfloat16)."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def moe_inputs(seed: int, D: int = 32, E: int = 8, F: int = 48, Fs: int = 48,
               shape=(4, 16)) -> dict:
    """Seeded MoE weights and bf16 hidden states as float32 numpy arrays
    (the bf16 ones already rounded): the same numbers go to both packages."""
    rng = np.random.default_rng(seed)
    n = lambda *s, fan: rng.standard_normal(s) / np.sqrt(fan)  # noqa: E731
    out = {"router": n(D, E, fan=D).astype(np.float32),
           "w1": bf16_np(n(E, D, F, fan=D)), "w3": bf16_np(n(E, D, F, fan=D)),
           "w2": bf16_np(n(E, F, D, fan=F)),
           "shared_w1": bf16_np(n(D, Fs, fan=D)),
           "shared_w3": bf16_np(n(D, Fs, fan=D)),
           "shared_w2": bf16_np(n(Fs, D, fan=Fs)),
           "x": bf16_np(rng.standard_normal((*shape, D)))}
    return out


def moe_cfg(capacity_factor: float, **kw):
    """The reduced DeepSeek-style config of ``tests/test_moe_shardmap.py``."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    return ModelConfig(
        arch_id="t", family="moe", num_layers=1, d_model=32, num_heads=4,
        num_kv_heads=4, head_dim=8, d_ff=64, vocab_size=128,
        moe=MoEConfig(num_experts=8, num_shared_experts=1, top_k=2, d_ff=48,
                      capacity_factor=capacity_factor), **kw)


def _torch_params(arrs: dict) -> dict:
    return {k: torch.from_numpy(v).to(torch.float32 if k == "router"
                                      else torch.bfloat16)
            for k, v in arrs.items() if k != "x"}


def _moe_loss(y, aux):
    return (y.float() ** 2).mean() + aux


def _distribute_moe(mesh, cfg, params: dict, x: torch.Tensor):
    """The layer's leaves and ``x`` as DTensors of the EP path's specs, each
    rank keeping its slice of the whole tensors (nothing sent), leaves that
    take gradients."""
    from repro_torch.models.moe import _moe_specs
    from repro_torch.parallel.sharding import (NamedSharding, P, dp_axes,
                                               dp_size, shard_tree)
    specs = _moe_specs(cfg.moe)
    dp = dp_axes(mesh)
    x_spec = P(dp, None, None) if x.shape[0] % dp_size(mesh) == 0 \
        else P(None, None, None)
    pd = shard_tree(params, {k: NamedSharding(mesh, specs[k]) for k in params})
    xd = shard_tree(x, NamedSharding(mesh, x_spec))
    return ({k: v.requires_grad_() for k, v in pd.items()},
            xd.requires_grad_())


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------

def ep_against_reference(mesh, inputs_path: str, out_path: str,
                         factors: tuple) -> None:
    """The EP path on every capacity factor of ``factors``: y, aux and the
    gradients of ``mean(y^2) + aux`` (params and x) gathered, rank 0 saves
    them for the comparison with the reference's ``shard_map``."""
    from repro_torch.models.moe import apply_moe
    arrs = dict(np.load(inputs_path))
    out = {}
    for cf in factors:
        cfg = moe_cfg(cf, mesh=mesh, moe_impl="shardmap")
        pd, xd = _distribute_moe(mesh, cfg, _torch_params(arrs),
                                 torch.from_numpy(arrs["x"]).bfloat16())
        y, aux = apply_moe(cfg, pd, xd)
        _moe_loss(y, aux).backward()
        tag = f"cf{cf:g}"
        out[f"{tag}/y"] = y.full_tensor().detach().float().numpy()
        out[f"{tag}/aux"] = np.float32(aux.full_tensor().detach())
        for k, v in pd.items():
            out[f"{tag}/grad/{k}"] = v.grad.full_tensor().float().numpy()
        out[f"{tag}/grad/x"] = xd.grad.full_tensor().float().numpy()
    if dist.get_rank() == 0:
        np.savez(out_path, **out)


def _bf16_ulps(d: torch.Tensor, ref: torch.Tensor) -> float:
    """max |d| in bf16 ulps of max |ref|."""
    mag = float(ref.detach().abs().max())
    return float(d.detach().abs().max()) / 2.0 ** (np.floor(np.log2(mag)) - 7)


def _grads(loss, params: dict, x) -> dict:
    leaves = [*params.values(), x]
    got = torch.autograd.grad(loss, leaves, retain_graph=True,
                              allow_unused=True)
    return {k: g for k, g in zip([*params, "x"], got) if g is not None}


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def ep_against_one_device(mesh, seed: int, factors: tuple,
                          out_path: str) -> None:
    """The EP path against the one-device path run on each data shard
    separately (the same local capacity): y within 2 bf16 ulps of max|y|,
    aux within 1e-6, and, on the plain route, the gradients of ``mean(y^2)``
    and of ``aux`` apart, each within 5e-2 of its max (the reference's
    bound); with ``use_pallas`` (B7/B8's plain versions on the CPU), y
    against the per-shard kernel route.  Rank 0 saves the measured gaps
    and the drops at each capacity factor."""
    from repro_torch.models.moe import apply_moe, route
    from repro_torch.parallel.sharding import dp_size
    arrs = moe_inputs(seed, shape=(8, 8))
    params = _torch_params(arrs)
    x = torch.from_numpy(arrs["x"]).bfloat16()
    n_dp = dp_size(mesh)
    gaps = {}
    for cf in factors:
        cfg = moe_cfg(cf, mesh=mesh)
        one = moe_cfg(cf)
        pd, xd = _distribute_moe(mesh, cfg, params, x)
        y, aux = apply_moe(cfg, pd, xd)
        lp = {k: v.clone().requires_grad_() for k, v in params.items()}
        lx = x.clone().requires_grad_()
        ys, auxs = zip(*(apply_moe(one, lp, s) for s in lx.chunk(n_dp)))
        y_ref, aux_ref = torch.cat(ys), torch.stack(auxs).mean()

        ulps = _bf16_ulps(y.full_tensor().float() - y_ref.float(),
                          y_ref.float())
        assert ulps <= 2.0, (cf, ulps)
        aux_err = abs(float(aux.full_tensor()) - float(aux_ref))
        assert aux_err <= 1e-6, (cf, aux_err)
        terms = {"y": ((y.float() ** 2).mean(), (y_ref.float() ** 2).mean()),
                 "aux": (aux, aux_ref)}
        for term, (mine, ref) in terms.items():
            got = _grads(mine, pd, xd)
            want = _grads(ref, lp, lx)
            assert got.keys() == want.keys(), (term, got.keys(), want.keys())
            for k, g in got.items():
                r = want[k].float()
                rel = float((_full(g).float() - r).abs().max()
                            / (r.abs().max() + 1e-12))
                assert rel < 5e-2, (cf, term, k, rel)
                gaps[f"cf{cf:g}/grad_{term}/{k}"] = rel

        with torch.no_grad():
            y_k, _ = apply_moe(dataclasses.replace(cfg, use_pallas=True),
                               pd, xd)
            kcfg = dataclasses.replace(one, use_pallas=True)
            y_ref_k = torch.cat([apply_moe(kcfg, params, s)[0]
                                 for s in x.chunk(n_dp)])
            drops = 0
            for s in x.chunk(n_dp):
                *_, pos_flat, C = route(one, params, s.reshape(-1, s.shape[-1]))
                drops += int((pos_flat == C).sum())
        ulps_k = _bf16_ulps(y_k.full_tensor().float() - y_ref_k.float(),
                            y_ref_k.float())
        assert ulps_k <= 2.0, (cf, ulps_k)
        gaps[f"cf{cf:g}/y_ulps"] = ulps
        gaps[f"cf{cf:g}/y_ulps_pallas"] = ulps_k
        gaps[f"cf{cf:g}/aux"] = aux_err
        gaps[f"cf{cf:g}/drops"] = drops
    if dist.get_rank() == 0:
        np.savez(out_path, **gaps)


def constrain_on_ranks(mesh, cases_json: str) -> None:
    """``constrain`` on a replicated DTensor of each case: placements of
    ``constrain_spec``'s spec, values unchanged; a plain tensor raises."""
    import json

    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.models.layers import constrain, constrain_spec
    from repro_torch.parallel.sharding import constrain_activation, placements
    for shape, tpl, sp, dp_only in json.loads(cases_json).values():
        cfg = moe_cfg(8.0, mesh=mesh, sp=sp, dp_only=dp_only)
        x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
        xd = distribute_tensor(x, mesh, [Replicate()] * 2, src_data_rank=None)
        y = constrain(xd, cfg, tuple(tpl))
        want = placements(constrain_spec(tuple(shape), cfg, tuple(tpl)), mesh)
        assert tuple(y.placements) == want, (shape, tpl, y.placements, want)
        assert torch.equal(y.full_tensor(), x)
        try:
            constrain(x, cfg, tuple(tpl))
        except TypeError:
            pass
        else:
            raise AssertionError("a plain tensor on a mesh was constrained")
        if len(shape) == 3:
            z = constrain_activation(xd, mesh, sp=sp)
            assert torch.equal(z.full_tensor(), x)


def _hold_shard(dt, whole: torch.Tensor, what) -> None:
    """``dt``'s local shard against its slice of ``whole`` within 1e-5 of
    max|whole|, a Partial placement summed first (an all-reduce): no
    gather, which gloo ranks on CUDA tensors do not survive."""
    from types import SimpleNamespace

    from torch.distributed.tensor import Partial, Replicate

    from repro_torch.parallel.sharding import local_slices
    pls = tuple(Replicate() if isinstance(p, Partial) else p
                for p in dt.placements)
    if pls != tuple(dt.placements):
        dt = dt.redistribute(dt.device_mesh, pls)
    sl = local_slices(tuple(whole.shape),
                      SimpleNamespace(mesh=dt.device_mesh, placements=pls))
    d = float((dt.to_local() - whole[sl]).abs().max())
    assert d <= 1e-5 * float(whole.abs().max()), (what, d)


def tp_project_rs_on_ranks(mesh, fallbacks: bool = True) -> None:
    """``tp_project_rs`` with ``tp_impl="shardmap"``: the local partial
    einsum reduce-scattered over the sequence dim, against the plain
    einsum on the whole tensors (float32: each shard within 1e-5 of
    max|y|), the gradients too (of the sum of each rank's squares: every
    element of y lies on one rank); with ``fallbacks``, each fallback
    condition takes the plain path (DTensor's einsum and ``constrain``,
    whose gathers gloo ranks on CUDA tensors do not survive: the CPU
    only).  Runs on the mesh's device (the CPU, or ``cuda:0``)."""
    from repro_torch.models import layers
    from repro_torch.parallel.sharding import NamedSharding, P, shard_tree
    dev = torch.device(mesh.device_type)
    calls = []
    real = layers.psum_scatter

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    layers.psum_scatter = counted
    gen = torch.Generator().manual_seed(5)
    cases = {2: ((4, 8, 4, 8), (4, 8, 16), "bshk,hkd->bsd",
                 P("data", None, "model", None), P("model", None, None)),
             1: ((4, 8, 12), (12, 16), "bsf,fd->bsd",
                 P("data", None, "model"), P("model", None))}
    base = moe_cfg(8.0, mesh=mesh, tp_impl="shardmap", sp=True)
    try:
        for dims, (hs, ws, ein, h_spec, w_spec) in cases.items():
            h = torch.randn(hs, generator=gen).to(dev)
            w = torch.randn(ws, generator=gen).to(dev)
            variants = {"shardmap": (base, h)}
            if fallbacks:
                variants.update(
                    decode=(base, h[:, :1]),
                    gspmd=(dataclasses.replace(base, tp_impl="gspmd"), h),
                    no_sp=(dataclasses.replace(base, sp=False), h))
            for name, (cfg, hv) in variants.items():
                hd = shard_tree(hv, NamedSharding(mesh, h_spec)).requires_grad_()
                wd = shard_tree(w, NamedSharding(mesh, w_spec)).requires_grad_()
                n0 = len(calls)
                y = layers.tp_project_rs(hd, wd, cfg, contract_model_dims=dims)
                assert (len(calls) > n0) == (name == "shardmap"), name
                hp, wp = hv.clone().requires_grad_(), w.clone().requires_grad_()
                want = torch.einsum(ein, hp, wp)
                _hold_shard(y, want.detach(), (dims, name, "y"))
                if name == "shardmap":         # y sharded on every mesh dim
                    (y.to_local().float() ** 2).sum().backward()
                else:
                    (y.float() ** 2).sum().backward()
                (want ** 2).sum().backward()
                _hold_shard(hd.grad, hp.grad, (dims, name, "dh"))
                _hold_shard(wd.grad, wp.grad, (dims, name, "dw"))
    finally:
        layers.psum_scatter = real
    try:
        layers.tp_project_rs(h, w, base, contract_model_dims=1)
    except TypeError:
        pass
    else:
        raise AssertionError("tp_project_rs took plain tensors on a mesh")


def small_train_state(seed: int = 0):
    """A reduced qwen2-0.5b ``TrainState`` on the CPU from ``seed``."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models import get_model
    from repro_torch.train import init_train_state
    model = get_model(get_config("qwen2-0.5b").reduced(), device="cpu")
    return init_train_state(model, TrainConfig(),
                            torch.Generator().manual_seed(seed))


def restore_on_ranks(mesh, root: str) -> None:
    """``restore(shardings=)`` of a reduced qwen2-0.5b state: every leaf a
    DTensor of its sharding whose local shard has the spec's shape and is
    bit-equal to its slice of the one-device restore."""
    from repro_torch._tree import tree_flatten
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models import get_model
    from repro_torch.parallel.sharding import local_shape, local_slices
    from repro_torch.train.step import train_state_shardings
    model = get_model(get_config("qwen2-0.5b").reduced(), device="cpu")
    like = small_train_state(1)               # other numbers, same layout
    shardings = train_state_shardings(model, mesh, TrainConfig())
    plain, step = ckpt.restore(root, like)
    got, step2 = ckpt.restore(root, like, shardings=shardings)
    assert step == step2 == 3
    sharded = 0
    for g, p, s in zip(tree_flatten(got)[0], tree_flatten(plain)[0],
                       tree_flatten(shardings)[0]):
        assert tuple(g.placements) == s.placements
        assert g.dtype == p.dtype and tuple(g.shape) == tuple(p.shape)
        local = g.to_local()
        assert tuple(local.shape) == local_shape(tuple(p.shape), s)
        assert torch.equal(local, p[local_slices(tuple(p.shape), s)])
        assert torch.equal(g.full_tensor(), p)
        sharded += local.numel() < p.numel()
    assert sharded > 0


def _step_bound(lr: float, s: float, A: torch.Tensor,
                w_new: torch.Tensor) -> torch.Tensor:
    """Per element, how far float32 reassociation can move a master weight
    after one AdamW step from zero moments: the accumulated gradients part
    by at most 2u * A (A = sum of |microbatch gradient| / G, u = 2^-24);
    the update g s / (|g s| + eps) moves by at most s / eps times that (and
    never more than 2), plus 76 u for its own rounding and the norm's; the
    weight by lr times that plus one ulp of the result."""
    u = 2.0 ** -24
    A = A.double()
    dupd = torch.clamp(s * 2 * u * A / 1e-8, max=2.0) + 76 * u
    w = w_new.double().abs()
    ulp = torch.exp2(torch.floor(torch.log2(w.clamp_min(1e-38))) - 23)
    return lr * dupd + ulp


def sharded_step_on_ranks(mesh) -> None:
    """One step of the reduced qwen2-0.5b with ``grad_shardings =
    opt_shardings`` (each rank its ``batch_pspec`` shard of 8 x 16 tokens,
    ``grad_accum=2``) against the one-device step on the whole batch with
    the same microbatches (``grad_accum = 2 x dp``): the loss within 1e-6
    relative, master weights within :func:`_step_bound`, parameters within
    one bf16 ulp, accumulators and moments resident as their shards."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch._tree import tree_flatten
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models import get_model
    from repro_torch.parallel.sharding import (batch_shardings, dp_size,
                                               shard_tree)
    from repro_torch.train import TrainState, build_train_step
    from repro_torch.train.optim import OptState
    from repro_torch.train.step import (make_loss_fn, train_state_shardings,
                                        value_and_grad)

    cfg = get_config("qwen2-0.5b").reduced()
    model = get_model(cfg, device="cpu")
    tcfg = TrainConfig(grad_accum=2)
    state = small_train_state(0)
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 16)))
             for k in ("tokens", "labels")}
    oshard = train_state_shardings(model, mesh, tcfg).opt.mu
    bshard = batch_shardings(batch, mesh)
    opt = OptState(mu=shard_tree(state.opt.mu, oshard),
                   nu=shard_tree(state.opt.nu, oshard),
                   master=shard_tree(state.opt.master, oshard),
                   count=state.opt.count)
    dbatch = {k: distribute_tensor(v, mesh, bshard[k].placements,
                                   src_data_rank=None)
              for k, v in batch.items()}
    new, metrics = build_train_step(model, tcfg, grad_shardings=oshard)(
        TrainState(state.params, opt), dbatch)

    G = tcfg.grad_accum * dp_size(mesh)
    ocfg = dataclasses.replace(tcfg, grad_accum=G)
    want, wm = build_train_step(model, ocfg)(state, batch)
    rel = abs(float(metrics["loss"]) - float(wm["loss"])) / abs(float(wm["loss"]))
    assert rel <= 1e-6, rel
    assert float(metrics["lr"]) == float(wm["lr"])
    assert abs(float(metrics["grad_norm"]) / float(wm["grad_norm"]) - 1) < 1e-5

    grad_fn = value_and_grad(make_loss_fn(model))
    A = None
    for i in range(G):
        _, g = grad_fn(state.params, {k: v[2 * i:2 * i + 2]
                                      for k, v in batch.items()})
        a = [x.float().abs() / G for x in tree_flatten(g)[0]]
        A = a if A is None else [x + y for x, y in zip(A, a)]
    s = min(1.0, tcfg.grad_clip / (float(wm["grad_norm"]) + 1e-9))
    lr = float(wm["lr"])
    moved = differ = 0
    for got, ref, a, old in zip(tree_flatten(new.opt.master)[0],
                                tree_flatten(want.opt.master)[0], A,
                                tree_flatten(state.opt.master)[0]):
        assert isinstance(got, DTensor)
        d = (got.full_tensor().double() - ref.double()).abs()
        assert bool((d <= _step_bound(lr, s, a, ref)).all()), float(d.max())
        moved += int((ref != old).sum())
        differ += int((d > 0).sum())
    p_differ = 0
    for got, ref in zip(tree_flatten(new.params)[0],
                        tree_flatten(want.params)[0]):
        assert not isinstance(got, DTensor) and got.dtype == ref.dtype
        mag = torch.maximum(got.float().abs(), ref.float().abs()).clamp_min(1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        assert bool(((got.float() - ref.float()).abs() <= ulp).all())
        p_differ += int((got != ref).sum())
    assert moved > 0
    resident = sum(t.to_local().numel() for t in tree_flatten(new.opt.mu)[0])
    whole = sum(t.numel() for t in tree_flatten(want.opt.mu)[0])
    assert resident < whole, (resident, whole)
    if dist.get_rank() == 0:
        print(f"sharded step: loss rel {rel:.3g}; master weights moved "
              f"{moved}, {differ} apart from the one-device step's; "
              f"parameters apart {p_differ}; moments resident {resident} "
              f"of {whole}")


def ep_on_card(mesh, seed: int) -> None:
    """The EP layer through B7/B8 on ``cuda:0`` (reduced width): one launch
    of each a rank, each held against its plain version (one bf16 ulp or
    1e-3 * max), y against the one-device kernel route on each data shard
    within 2 bf16 ulps of max|y|, aux within 1e-6."""
    from _bf16_helpers import assert_within_ulp

    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.models import moe as tmoe
    from repro_torch.parallel.collectives import full_tensor
    from repro_torch.parallel.sharding import dp_size
    dev = torch.device("cuda", 0)
    arrs = moe_inputs(seed, D=128, E=8, F=64, Fs=64, shape=(4, 32))
    params = {k: v.to(dev) for k, v in _torch_params(arrs).items()}
    x = torch.from_numpy(arrs["x"]).bfloat16().to(dev)
    cfg = dataclasses.replace(moe_cfg(8.0, mesh=mesh), d_model=128,
                              use_pallas=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, d_ff=64))
    one = dataclasses.replace(cfg, mesh=None)
    pd, xd = _distribute_moe(mesh, cfg, params, x)

    real = {name: getattr(tmoe, name) for name in ("moe_gmm", "moe_gmm_down")}
    held = []

    def holding(name):
        def wrapper(*args):
            out = real[name](*args)
            held.append(assert_within_ulp(out.float().cpu(), real[name](
                *args, backend="torch").float().cpu()))
            return out
        return wrapper

    gmm.moe_gmm.launches = gmm.moe_gmm_down.launches = 0
    for name in real:
        setattr(tmoe, name, holding(name))
    try:
        with torch.no_grad():
            y, aux = tmoe.apply_moe(cfg, {k: v.detach() for k, v in pd.items()},
                                    xd.detach())
    finally:
        for name, fn in real.items():
            setattr(tmoe, name, fn)
    assert (gmm.moe_gmm.launches, gmm.moe_gmm_down.launches) == (1, 1)
    assert len(held) == 2
    with torch.no_grad():
        y_ref = torch.cat([tmoe.apply_moe(one, params, s)[0]
                           for s in x.chunk(dp_size(mesh))])
        aux_ref = torch.stack([tmoe.apply_moe(one, params, s)[1]
                               for s in x.chunk(dp_size(mesh))]).mean()
    got = full_tensor(y)
    assert got.device == dev
    ulps = _bf16_ulps(got.float() - y_ref.float(), y_ref.float())
    assert ulps <= 2.0, ulps
    assert abs(float(aux.to_local()) - float(aux_ref)) <= 1e-6


# ---------------------------------------------------------------------------
# launch cells (test_torch_launch.py)
# ---------------------------------------------------------------------------

def launch_cells_on_ranks(_mesh, workdir: str, cases_json: str) -> None:
    """Each case ``[arch, kind, S, B, grad_accum, mesh_shape, tcfg,
    float32]`` of ``cases_json`` (``tcfg``: ``TrainConfig``'s keywords) on
    a ``("data", "model")`` mesh of ``mesh_shape`` over the ranks' group
    (:func:`launch_cell_on_mesh`)."""
    import json

    from torch.distributed.device_mesh import init_device_mesh
    for arch, kind, S, B, ga, shape, tcfg, f32 in json.loads(cases_json):
        mesh = init_device_mesh("cpu", tuple(shape),
                                mesh_dim_names=("data", "model"))
        tag = "x".join(map(str, shape)) + "_f32" * f32
        if kind == "serve":
            serve_on_mesh(mesh, workdir, arch, tag, f32)
            continue
        launch_cell_on_mesh(mesh, workdir, arch, kind, S, B, ga, tag, tcfg,
                            f32)


def serve_on_mesh(mesh, workdir: str, arch: str, tag: str,
                  float32: bool = False) -> None:
    """The reduced ``arch`` served on the mesh from the reference's
    parameters (``workdir/<arch>.pkl``, its ``"serve"`` record; under
    ``float32`` the parameters and the cache cast to float32): the
    parameters, the cache and each call's tokens DTensors of the launch
    cells' shardings, the prompt's prefill and the decode steps as the
    launch cells run them; rank 0 writes the gathered logits of each call
    to ``workdir/<arch>_serve_<tag>.pkl``."""
    import pickle

    from repro_torch.configs.registry import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.models import get_model
    from repro_torch.models.param import tree_map
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.collectives import full_tensor
    from repro_torch.train.step import build_decode_step, build_prefill_step

    with open(Path(workdir) / f"{arch}.pkl", "rb") as f:
        ref = pickle.load(f)
    serve = ref["result"]["serve"]
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(
        cfg.with_parallelism(shd.mesh_shape(mesh)["model"]), mesh=mesh)
    model = get_model(cfg, device="cpu")
    cast = (lambda t: t.float()) if float32 else (lambda t: t)
    params = shd.shard_tree(
        tree_map(cast, params_from_jax(ref["params"], device="cpu")),
        shd.param_shardings(model.structure(), mesh))
    prompt = torch.from_numpy(serve["prompt"])
    cache = tree_map(cast, model.init_cache(prompt.shape[0], serve["len"]))
    cache = shd.shard_tree(cache, shd.cache_shardings(cache, mesh))

    def tokens(t):
        return shd.shard_tree(t, shd.batch_shardings(t, mesh))

    logits, cache = build_prefill_step(model)(
        params, {"tokens": tokens(prompt)}, cache)
    out = [full_tensor(logits).float().numpy()]
    decode = build_decode_step(model)
    for i, tok in enumerate(serve["tokens"]):
        logits, cache = decode(params, tokens(torch.from_numpy(tok)), cache,
                               prompt.shape[1] + i)
        out.append(full_tensor(logits).float().numpy())
    if dist.get_rank() == 0:
        with open(Path(workdir) / f"{arch}_serve_{tag}.pkl", "wb") as f:
            pickle.dump(out, f)


def launch_cell_on_mesh(mesh, workdir: str, arch: str, kind: str, S: int,
                        B: int, grad_accum: int, tag: str, tcfg: dict,
                        float32: bool = False) -> None:
    """The reduced launch cell of ``arch`` at ``kind`` on the mesh: its
    arguments from ``materialize_cell`` (DTensors of the cell's shardings)
    on the reference's parameters (``workdir/<arch>.pkl``; cast to float32
    under ``float32``), the batch replaced by the reference's inputs; rank
    0 writes to ``workdir/<arch>_<tag>.pkl`` the gathered logits, or the
    train step's float32 metrics and its new state gathered whole (a tree
    of tensors like the one-rank step's)."""
    import pickle

    from torch.distributed.tensor import DTensor

    from repro_torch._tree import tree_flatten
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.cells import build_cell, materialize_cell
    from repro_torch.models.param import tree_map
    from repro_torch.parallel.collectives import full_tensor
    from repro_torch.parallel.sharding import local_shape, shard_tree

    with open(Path(workdir) / f"{arch}.pkl", "rb") as f:
        ref = pickle.load(f)
    cell = build_cell(get_config(arch).reduced(),
                      ShapeConfig(f"t_{kind}", S, B, kind), mesh,
                      TrainConfig(**tcfg), grad_accum=grad_accum,
                      device="cpu")
    params = params_from_jax(ref["params"], device="cpu")
    if float32:
        params = tree_map(lambda t: t.float(), params)
    args = list(materialize_cell(cell, torch.Generator().manual_seed(0),
                                 params=params))
    for arg, shard in zip(args[:3], cell.in_shardings[:3]):
        for t, s in zip(tree_flatten(arg)[0], tree_flatten(shard)[0]):
            assert isinstance(t, DTensor) and t.placements == s.placements
            assert tuple(t.to_local().shape) == local_shape(tuple(t.shape), s)
    batch = {k: torch.from_numpy(v) if v.dtype == np.int32
             else torch.from_numpy(v).bfloat16()
             for k, v in ref["batch"].items()}
    args[1] = shard_tree(batch, cell.in_shardings[1])
    out = cell.fn(*args)
    if kind == "train":
        new, metrics = out
        leaves, rebuild = tree_flatten(new)
        # the new state keeps the cell's shardings (its out_shardings)
        for t, s in zip(leaves, tree_flatten(cell.out_shardings[0])[0]):
            assert isinstance(t, DTensor) and t.placements == s.placements, \
                (t.placements if isinstance(t, DTensor) else type(t),
                 s.placements)
        result = {k: float(v.to_local() if isinstance(v, DTensor) else v)
                  for k, v in metrics.items()}
        result["state"] = rebuild([full_tensor(t) if isinstance(t, DTensor)
                                   else t for t in leaves])
    else:
        result = {"logits": full_tensor(out[0]).float().numpy()}
    if dist.get_rank() == 0:
        with open(Path(workdir) / f"{arch}_{tag}.pkl", "wb") as f:
            pickle.dump(result, f)
