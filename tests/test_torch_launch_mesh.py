"""The launch cells on four gloo ranks (``repro_torch.launch.cells``): the
reduced qwen2-0.5b train cell and DeepSeek-V2-Lite prefill cell, their
arguments DTensors from ``materialize_cell`` on the reference's weights and
inputs, held against the same cell on one rank and against the
reference's jitted cell on a (2, 2) mesh of four host devices.  A train
cell is held by its metrics and by the whole new state (parameters,
master copy, both moments), gathered from its shards.

The reference's cells run in a subprocess (``tests/_torch_launch_ref.py``);
the ranks, one spawn for every case, come from
``tests/_torch_mesh_ranks.py`` under its spawn timeout.  Every group the
tests make in this process ends with the test.
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch._tree import tree_flatten, tree_map
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.launch.cells import build_cell, materialize_cell
from repro_torch.train.step import make_loss_fn, value_and_grad

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_mesh_ranks as R  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
REF = Path(__file__).resolve().parent / "_torch_launch_ref.py"
SUBPROCESS_TIMEOUT_S = 300
SPAWN_TIMEOUT_S = 300        # four cells in one spawn
KINDS = {"train": (64, 8), "prefill": (64, 4)}   # S, B
SHARDED = {"qwen2-0.5b": "train", "deepseek-v2-lite-16b": "prefill"}
F32_ARCH = "qwen2-0.5b"      # its train cell also runs from float32 weights
SERVE_ARCH = "deepseek-v2-lite-16b"   # also served: a prefill, two decode steps
GRAD_ACCUM = 2
# a short warm-up, so that the first step's learning rate moves the bf16
# parameters (at the default 100 steps it is under half their ulp)
STEP_KW = {"warmup_steps": 2, "total_steps": 10}
MESH_SHAPES = {"2x2": (2, 2), "4x1": (4, 1)}
# On (2, 2) the ranks run a tensor-parallel program: each row-parallel
# projection (attention's wo, the MLP's w2, the experts' sum over "model")
# sums bf16 partials, so the cell parts from the one-rank cell by bf16
# roundings that the random model amplifies layer to layer (ROADMAP C, "the
# sum over model is a bf16 partial sum"): held at the cross-package
# tolerances.  On (4, 1) (data parallel only: no partial sums in the
# forward) it is held at PR 32's limits, against the one-rank step on the
# ranks' own microbatches (each rank's rows of a microbatch give the
# gradients of the same rows alone on one rank, scaled by a power of two):
# the accumulated gradients then part by float32 reassociation only.
STEP_TOL = 1e-3              # tests/test_torch_train.py: a step's metrics
LEAF_TOL = 2e-2              # tests/test_torch_train.py: a leaf of the state
# The gradients of q and k (through the softmax's nearly uniform rows of a
# random model) amplify bf16 roundings about tenfold: where either side
# runs tensor-parallel (the reference always does) the gradient's norm is
# held at GNORM_TP_TOL, and on (2, 2) the moments are held only in the
# float32 cell, where the two routes agree to about 1e-5 of a leaf's norm.
GNORM_TP_TOL = 2e-2
F32_RTOL = 1e-5              # float32 cell: loss and gradient norm
F32_LEAF_TOL = 1e-4          # float32 cell: each tree of the state
# the master's step, g / (|g| + eps) an element, turns over where a
# gradient is within its roundings of 0 (2.3e-4 against the reference)
F32_STEP_TOL = 1e-3
LOGIT_TOL = 5e-2             # tests/test_torch_lm.py: x max|ref logits|
LOSS_RTOL = 1e-6             # (4, 1) against one rank: float32 loss
GNORM_RTOL = 1e-5            # (4, 1) against one rank: the gradient's norm
LOGIT_ULPS = 2.0             # (4, 1) against one rank: bf16 ulps of max
U = 2.0 ** -24


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The reference's numbers (a subprocess), then every case on four
    ranks in one spawn; returns the directory holding both."""
    work = tmp_path_factory.mktemp("launch_mesh")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    try:
        subprocess.run([sys.executable, str(REF), "numbers", str(work),
                        json.dumps(STEP_KW)],
                       env=env, check=True, capture_output=True,
                       timeout=SUBPROCESS_TIMEOUT_S)
    except subprocess.CalledProcessError as err:
        pytest.fail(f"reference numbers failed: {err.stderr[-3000:]}")
    cases = [[arch, kind, *KINDS[kind], GRAD_ACCUM, list(shape), STEP_KW,
              False]
             for arch, kind in SHARDED.items()
             for shape in MESH_SHAPES.values()]
    cases.append([F32_ARCH, "train", *KINDS["train"], GRAD_ACCUM,
                  list(MESH_SHAPES["2x2"]), STEP_KW, True])
    cases += [[SERVE_ARCH, "serve", 0, 0, 0, list(MESH_SHAPES["2x2"]), {},
               f32] for f32 in (False, True)]
    R.spawn("launch_cells_on_ranks", work, str(work), json.dumps(cases),
            timeout=SPAWN_TIMEOUT_S)
    return work


def _one_rank(arch, kind, ref, grad_accum, float32=False):
    """The cell on a one-rank mesh from the reference's parameters (cast to
    float32 under ``float32``) and inputs: (its outputs, its arguments, its
    model)."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        S, B = KINDS[kind]
        cell = build_cell(get_config(arch).reduced(),
                          ShapeConfig(f"t_{kind}", S, B, kind), mesh,
                          TrainConfig(**STEP_KW),
                          grad_accum=grad_accum, device="cpu")
        params = params_from_jax(ref["params"], device="cpu")
        if float32:
            params = tree_map(lambda t: t.float(), params)
        args = list(materialize_cell(cell, torch.Generator().manual_seed(0),
                                     params=params))
        args[1] = {k: torch.from_numpy(v) if v.dtype == np.int32
                   else torch.from_numpy(v).bfloat16()
                   for k, v in ref["batch"].items()}
        return cell.fn(*args), args, cell.model
    finally:
        dist.destroy_process_group()


def _leaves(state):
    """``{"params", "master", "mu", "nu"}``: each a list of leaves."""
    return {"params": tree_flatten(state.params)[0],
            "master": tree_flatten(state.opt.master)[0],
            "mu": tree_flatten(state.opt.mu)[0],
            "nu": tree_flatten(state.opt.nu)[0]}


def _tree_dev(got, want) -> float:
    """The worst leaf's ||got - want|| over the whole of ``want``'s norm
    (``tests/test_torch_train.py``'s measure)."""
    scale = np.sqrt(sum(float(w.double().square().sum()) for w in want))
    return max(float((g.double() - w.double()).norm()) / scale
               for g, w in zip(got, want))


def _hold_state(label, got, want, start, tol, keys) -> None:
    """Trees ``keys`` of a new state within ``tol`` (``_tree_dev``);
    ``"master step"`` is the master copy's step (new less ``start``'s),
    which the master itself, dominated by the weights, would hide."""
    g, w, s0 = _leaves(got), _leaves(want), _leaves(start)
    g["master step"], w["master step"] = (
        [a.double() - b.double() for a, b in zip(t["master"], s0["master"])]
        for t in (g, w))
    devs = {k: _tree_dev(g[k], w[k]) for k in keys}
    print(f"{label}: worst leaf of its tree's norm " + ", ".join(
        f"{k} {v:.3g}" for k, v in devs.items()))
    assert max(devs.values()) <= tol, devs


def _microbatch_grads(model, params, batch, G):
    """The one-rank step's microbatches' gradients: (their sum over G, the
    sum of their magnitudes over G), float32 leaves."""
    grad_fn = value_and_grad(make_loss_fn(model))
    n = next(iter(batch.values())).shape[0] // G
    acc = A = None
    for i in range(G):
        _, g = grad_fn(params, {k: v[i * n:(i + 1) * n]
                                for k, v in batch.items()})
        g = [x.float() / G for x in tree_flatten(g)[0]]
        acc = g if acc is None else [a + b for a, b in zip(acc, g)]
        A = ([x.abs() for x in g] if A is None
             else [a + b.abs() for a, b in zip(A, g)])
    return acc, A


def _hold_bit_close(got, one, metrics, model, args, G, tcfg) -> None:
    """(4, 1) against the one-rank step on the same microbatches: master
    weights within PR 32's reassociation bound (``R._step_bound``), the
    moments within the same bound carried through their products, the
    parameters within one bf16 ulp."""
    acc, A = _microbatch_grads(model, args[0].params, args[1], G)
    s = min(1.0, tcfg.grad_clip / (metrics["grad_norm"] + 1e-9))
    lr = metrics["lr"]
    g, o, s0 = _leaves(got), _leaves(one), _leaves(args[0])
    apart = dict.fromkeys(g, 0)
    moved = 0
    for i, a in enumerate(A):
        a, gs = a.double(), (acc[i].double() * s).abs()
        dgs = s * 2 * U * a + 76 * U * gs          # |g s| apart at most
        bound = {"master": R._step_bound(lr, s, A[i], o["master"][i]),
                 "mu": (1 - tcfg.beta1) * dgs + 4 * U * o["mu"][i].double().abs(),
                 "nu": (1 - tcfg.beta2) * (2 * gs * dgs + dgs.square())
                 + 6 * U * o["nu"][i].double().abs()}
        for k, b in bound.items():
            d = (g[k][i].double() - o[k][i].double()).abs()
            assert bool((d <= b).all()), (k, i, float((d - b).max()))
            apart[k] += int((d > 0).sum())
        p, q = g["params"][i].float(), o["params"][i].float()
        mag = torch.maximum(p.abs(), q.abs()).clamp_min(1e-30)
        assert bool(((p - q).abs() <= torch.exp2(
            torch.floor(torch.log2(mag)) - 7)).all()), ("params", i)
        apart["params"] += int((p != q).sum())
        moved += int((o["params"][i] != s0["params"][i]).sum())
    print(f"elements apart from the one-rank step on the same microbatches: "
          f"{apart}; bf16 parameters the step moved {moved}")
    assert moved > 0


def _train_cells(arch, mesh_name, ref, float32=False):
    """The one-rank steps: on the reference's microbatches (G =
    ``GRAD_ACCUM``) and on the ranks' own (``GRAD_ACCUM`` of each rank's
    rows at a time); their metrics as floats."""
    G = GRAD_ACCUM * MESH_SHAPES[mesh_name][0]
    (one, om), args, _ = _one_rank(arch, "train", ref, GRAD_ACCUM, float32)
    (same, sm), sargs, model = _one_rank(arch, "train", ref, G, float32)
    return ((one, {k: float(v) for k, v in om.items()}),
            (same, {k: float(v) for k, v in sm.items()}), args, sargs, model, G)


def _hold_metrics(label, got, same, one, want, tol: dict) -> None:
    """``tol[k]``: (four ranks against the one-rank step on the same
    microbatches, every other pair)."""
    for k, (t_same, t_any) in tol.items():
        print(f"{label}: {k} four ranks {got[k]!r}, one rank {same[k]!r} "
              f"(same microbatches), {one[k]!r}, reference {want[k]!r}")
        assert abs(got[k] - same[k]) <= t_same * abs(same[k]), k
        for a, b in ((got[k], want[k]), (one[k], want[k]), (same[k], one[k])):
            assert abs(a - b) <= t_any * abs(b), k
    assert got["lr"] == same["lr"] == one["lr"] > 0


def _hold_train(arch, mesh_name, got, ref):
    tp = MESH_SHAPES[mesh_name][1] > 1
    want = ref["result"]
    (one, om), (same, sm), args, sargs, model, G = _train_cells(
        arch, mesh_name, ref)
    label = f"{arch} {mesh_name}"
    _hold_metrics(label, got, sm, om, want, {
        "loss": (STEP_TOL if tp else LOSS_RTOL, STEP_TOL),
        "grad_norm": (GNORM_TP_TOL if tp else GNORM_RTOL, GNORM_TP_TOL)})
    ref_state = train_state_from_jax(want["state"], device="cpu")
    start = args[0]
    all_trees = ("params", "master", "mu", "nu")
    _hold_state(f"{arch}: one rank against the reference", one, ref_state,
                start, LEAF_TOL, all_trees)
    _hold_state(f"{label}: four ranks against the reference", got["state"],
                ref_state, start, LEAF_TOL,
                ("params", "master") if tp else all_trees)
    if tp:
        _hold_state(f"{label}: four ranks against one rank", got["state"],
                    same, start, LEAF_TOL, ("params", "master"))
    else:
        _hold_bit_close(got["state"], same, sm, model, sargs, G,
                        TrainConfig(**STEP_KW))


@pytest.mark.parametrize("mesh_name", list(MESH_SHAPES))
@pytest.mark.parametrize("arch", list(SHARDED))
def test_sharded_cell_matches_one_rank_and_reference(arch, mesh_name, ranks):
    kind = SHARDED[arch]
    tp = MESH_SHAPES[mesh_name][1] > 1
    with open(ranks / f"{arch}.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(ranks / f"{arch}_{mesh_name}.pkl", "rb") as f:
        got = pickle.load(f)
    if kind == "train":
        _hold_train(arch, mesh_name, got, ref)
        return
    one = _one_rank(arch, kind, ref, GRAD_ACCUM)[0][0].float().numpy()
    got, want = got["logits"], ref["result"]["logits"]
    scale = np.abs(one).max()
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    print(f"{arch} {mesh_name}: logits four ranks vs one "
          f"{np.abs(got - one).max():.4g} ({np.abs(got - one).max() / ulp:.3g}"
          f" bf16 ulps of max), four ranks vs the reference "
          f"{np.abs(got - want).max() / np.abs(want).max():.4g} of max, one "
          f"rank vs the reference "
          f"{np.abs(one - want).max() / np.abs(want).max():.4g}")
    assert got.shape == one.shape == want.shape
    assert np.abs(got - one).max() <= (LOGIT_TOL * scale if tp
                                       else LOGIT_ULPS * ulp)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    assert np.abs(one - want).max() <= LOGIT_TOL * np.abs(want).max()


def test_sharded_train_step_in_float32_matches_one_rank_and_reference(ranks):
    """The (2, 2) train cell from float32 weights: no bf16 rounding for the
    gradients to amplify, so the whole new state, the moments and the
    master's step included, is held tightly against the one-rank step and
    the reference's."""
    with open(ranks / f"{F32_ARCH}.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(ranks / f"{F32_ARCH}_2x2_f32.pkl", "rb") as f:
        got = pickle.load(f)
    want = ref["result"]["float32"]
    (one, om), (same, sm), args, _, _, _ = _train_cells(
        F32_ARCH, "2x2", ref, float32=True)
    label = f"{F32_ARCH} 2x2 float32"
    _hold_metrics(label, got, sm, om, want,
                  {k: (F32_RTOL, F32_RTOL) for k in ("loss", "grad_norm")})
    ref_state = train_state_from_jax(want["state"], device="cpu")
    for name, a, b in (("four ranks against one rank", got["state"], same),
                       ("four ranks against the reference", got["state"],
                        ref_state),
                       ("one rank against the reference", one, ref_state)):
        _hold_state(f"{label}: {name}", a, b, args[0], F32_LEAF_TOL,
                    ("params", "master", "mu", "nu"))
        _hold_state(f"{label}: {name}", a, b, args[0], F32_STEP_TOL,
                    ("master step",))


def _serve_one_rank(serve, params, float32: bool) -> list:
    """The mesh-free (one rank's) serve of ``serve``'s prompt and tokens;
    under ``float32`` the parameters and the latent cache in float32."""
    from repro_torch.models import get_model
    model = get_model(get_config(SERVE_ARCH).reduced(), device="cpu")
    cast = (lambda t: t.float()) if float32 else (lambda t: t)
    params = tree_map(cast, params)
    prompt = torch.from_numpy(serve["prompt"])
    cache = tree_map(cast, model.init_cache(prompt.shape[0], serve["len"]))
    logits, cache = model.prefill(params, {"tokens": prompt}, cache)
    out = [logits]
    for i, tok in enumerate(serve["tokens"]):
        logits, cache = model.decode_step(params, torch.from_numpy(tok),
                                          cache, prompt.shape[1] + i)
        out.append(logits)
    return [x.float().numpy() for x in out]


def test_sharded_mla_serving_matches_one_rank_and_reference(ranks):
    """The reduced DeepSeek-V2-Lite served on (2, 2): a prefill of 60
    tokens into a 64-deep latent cache, then two decode steps, each rank
    reconstituting only its batch rows' and heads' K / V from the cache
    (``attention._mla_heads_local``).  From float32 weights and a float32
    latent cache, nothing is rounded for the random model to amplify:
    every call's logits within ``F32_RTOL`` of max of the mesh-free path
    (one rank's), and within ``LOGIT_TOL`` of the reference's jitted model
    on the same weights (its cache is bf16).  In bf16 the mesh-free path
    is held against the reference at ``LOGIT_TOL``; the four ranks' bf16
    run, whose TP partial sums the random model amplifies (3-7% of max
    here), is printed."""
    with open(ranks / f"{SERVE_ARCH}.pkl", "rb") as f:
        ref = pickle.load(f)
    serve = ref["result"]["serve"]
    params = params_from_jax(ref["params"], device="cpu")
    calls = ("prefill", "decode 1", "decode 2")

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    for tag, key, f32 in (("2x2", "logits", False),
                          ("2x2_f32", "logits_f32", True)):
        with open(ranks / f"{SERVE_ARCH}_serve_{tag}.pkl", "rb") as f:
            got = pickle.load(f)
        one = _serve_one_rank(serve, params, f32)
        assert len(got) == len(one) == len(serve[key]) == len(calls)
        for call, g, o, w in zip(calls, got, one, serve[key]):
            print(f"{SERVE_ARCH} {tag} {call}: four ranks vs one "
                  f"{rel(g, o):.4g} of max, vs the reference {rel(g, w):.4g}"
                  f", one rank vs the reference {rel(o, w):.4g}")
            assert g.shape == o.shape == w.shape
            assert np.isfinite(g).all()
            assert rel(o, w) <= LOGIT_TOL
            if f32:
                assert rel(g, o) <= F32_RTOL
                assert rel(g, w) <= LOGIT_TOL
