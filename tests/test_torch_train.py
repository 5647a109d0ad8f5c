"""The port's training path against the reference, on the CPU.

The reduced qwen2-0.5b (2 layers, d_model 64, 4 heads over 2 KV heads,
head_dim 16, vocab 512, attn_chunk 32; the reference's training route,
``use_pallas=False``) trains in both packages from one state: drawn by the
reference from a seed and carried over bit for bit with
``convert.train_state_from_jax``.  Batches come from each package's
``SyntheticLM`` (the same numpy draws).  The reference runs jitted.

Tolerances, with their reasons:

- ``lr_schedule``, ``global_norm`` and ``adamw_update`` on random float32
  trees: 1e-6 relative (float32 ops in the same order; PyTorch's and
  XLA's float32 ``cos``, ``pow`` and ``sqrt`` may differ in the last bit).
- a whole step: loss, ``grad_norm`` and ``lr`` within 1e-3 relative.
  Gradients, and the master weights, mu and nu after the step, leaf by
  leaf within 2e-2 of the norm of the reference's whole tree (for the
  gradients, its ``grad_norm``).  bf16 autodiff sums in another order in
  the two packages, so every leaf carries rounding noise on the scale of
  the gradients that flow through it, not of its own: the key bias's true
  gradient is near zero (a shift of every key moves no softmax but for
  the rotation rope gives it), so its own norm is noise, and Adam's first
  step turns each element's sign into +-lr (measured: bk's gradient 2.4e-2
  of its own norm apart, its master weights 0.93).  The per-leaf
  deviations are printed against both norms.
- ``SyntheticLM`` batches: bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import get_config as jax_config
from repro.data import make_pipeline as jax_pipeline
from repro.models import get_model as jax_model
from repro.train import build_train_step as jax_train_step
from repro.train import init_train_state as jax_init_state
from repro.train import optim as jopt
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config as torch_config
from repro_torch.data import make_pipeline
from repro_torch.launch import train as launcher
from repro_torch.models import get_model as torch_model
from repro_torch.train import build_train_step, optim, step as tstep
from repro_torch.train.optim import tree_flatten

ARCH = "qwen2-0.5b"
B, S = 4, 72              # 72 keys > 2 * attn_chunk: the chunked attend
STEP_TOL = 1e-3
LEAF_TOL = 2e-2


def _rel(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / abs(b)


def _np(t) -> np.ndarray:
    return (t.detach().float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(jnp.asarray(t).astype(jnp.float32)))


def _leaf_devs(got_tree, want_tree, scale=None):
    """Per leaf (in JAX order): |got - want| over the whole reference tree's
    norm (``scale`` when given) and over the leaf's own norm."""
    want = [_np(a) for a in jax.tree.leaves(want_tree)]
    got = [_np(t) for t in tree_flatten(got_tree)[0]]
    assert [a.shape for a in want] == [g.shape for g in got]
    if scale is None:
        scale = np.sqrt(sum(float((a.astype(np.float64) ** 2).sum())
                            for a in want))
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(want_tree)]
    return [(p, float(np.linalg.norm(g - a) / scale),
             float(np.linalg.norm(g - a) / max(np.linalg.norm(a), 1e-30)))
            for p, g, a in zip(paths, got, want)]


def _check_tree(label, got_tree, want_tree, scale=None):
    devs = _leaf_devs(got_tree, want_tree, scale)
    worst = max(d for _, d, _ in devs)
    print(f"{label}: worst leaf {worst:.3g} of the tree's norm; per leaf "
          "(tree, own): " + ", ".join(f"{p} {d:.2g}/{o:.2g}"
                                      for p, d, o in devs))
    assert worst <= LEAF_TOL, [(p, d) for p, d, _ in devs if d > LEAF_TOL]


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def _random_tree(rng, scale=1.0):
    return {"a": {"w": rng.standard_normal((7, 5)) * scale,
                  "b": rng.standard_normal((5,)) * scale},
            "z": [rng.standard_normal((3, 4, 2)) * scale]}


def _as(tree, fn):
    return jax.tree.map(lambda a: fn(np.asarray(a, np.float32)), tree)


@pytest.mark.parametrize("step", [1, 5, 40, 100, 400])
def test_lr_schedule_matches_reference(step):
    jt = JaxTrainConfig(learning_rate=3e-3, warmup_steps=10, total_steps=300)
    tt = TrainConfig(learning_rate=3e-3, warmup_steps=10, total_steps=300)
    want = jopt.lr_schedule(jt, jnp.int32(step))
    got = optim.lr_schedule(tt, torch.tensor(step, dtype=torch.int32))
    print(f"step {step}: lr {float(got):.8g} vs {float(want):.8g}")
    assert _rel(got, want) <= 1e-6


def test_global_norm_matches_reference():
    tree = _random_tree(np.random.default_rng(0))
    want = jopt.global_norm(_as(tree, jnp.asarray))
    got = optim.global_norm(_as(tree, torch.from_numpy))
    print(f"global norm {float(got):.8g} vs {float(want):.8g}")
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("master,clip", [(True, 1.0), (False, 0.0)],
                         ids=["master-clipped", "no-master-unclipped"])
def test_adamw_update_matches_reference(master, clip):
    rng = np.random.default_rng(1)
    params, grads = _random_tree(rng), _random_tree(rng, 0.3)
    mu, nu = _random_tree(rng, 0.1), _as(_random_tree(rng, 0.1), np.abs)
    kw = dict(master_weights=master, grad_clip=clip, warmup_steps=3,
              total_steps=20, learning_rate=1e-2)
    jt, tt = JaxTrainConfig(**kw), TrainConfig(**kw)
    jstate = jopt.OptState(mu=_as(mu, jnp.asarray), nu=_as(nu, jnp.asarray),
                           master=_as(params, jnp.asarray) if master else None,
                           count=jnp.int32(4))
    tstate = optim.OptState(
        mu=_as(mu, torch.from_numpy), nu=_as(nu, torch.from_numpy),
        master=_as(params, torch.from_numpy) if master else None,
        count=torch.tensor(4, dtype=torch.int32))
    jp, jo, jm = jopt.adamw_update(_as(grads, jnp.asarray),
                                   _as(params, jnp.asarray), jstate, jt)
    tp, to, tm = optim.adamw_update(_as(grads, torch.from_numpy),
                                    _as(params, torch.from_numpy), tstate, tt)
    assert int(to.count) == int(jo.count) == 5
    for key in ("grad_norm", "lr"):
        assert _rel(tm[key], jm[key]) <= 1e-6, key
    worst = 0.0
    for name, g, w in (("params", tp, jp), ("mu", to.mu, jo.mu),
                       ("nu", to.nu, jo.nu)) + ((("master", to.master,
                                                  jo.master),) if master else ()):
        for a, b in zip(tree_flatten(g)[0], jax.tree.leaves(w)):
            b = np.asarray(b)
            worst = max(worst, float(np.abs(a.numpy() - b).max()
                                     / np.abs(b).max()))
    print(f"adamw: worst leaf max|d| / max|ref| = {worst:.3g}")
    assert worst <= 1e-6
    assert (to.master is None) == (not master)


def test_tree_flatten_is_jax_order_and_keeps_layout():
    tree = {"b": torch.zeros(1), "a": [torch.ones(2), {"d": torch.zeros(3),
                                                      "c": torch.ones(4)}]}
    leaves, rebuild = tree_flatten(tree)
    jleaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tree))
    assert [t.numel() for t in leaves] == [a.size for a in jleaves] == [2, 4, 3, 1]
    back = rebuild(leaves)
    assert list(back) == ["b", "a"] and list(back["a"][1]) == ["d", "c"]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7)])
def test_synthetic_batches_equal_reference(seed, step):
    cfg = torch_config(ARCH).reduced()
    want = jax_pipeline(jax_config(ARCH).reduced(), 40, 3, seed=seed).batch(step)
    got = make_pipeline(cfg, 40, 3, seed=seed, device="cpu").batch(step)
    for key in ("tokens", "labels"):
        assert got[key].dtype == torch.int32 and got[key].device.type == "cpu"
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert torch.equal(got["tokens"][:, 1:], got["labels"][:, :-1])


# ---------------------------------------------------------------------------
# losses, gradients and whole steps against the reference
# ---------------------------------------------------------------------------

def _cfgs(fused_ce=False):
    over = dict(fused_ce=fused_ce, ce_chunk=200)    # 512 = 200 + 200 + 112
    return (dataclasses.replace(jax_config(ARCH).reduced(), **over),
            dataclasses.replace(torch_config(ARCH).reduced(), **over))


@pytest.fixture(scope="module")
def start():
    """One initial state and batch for both packages."""
    cj, ct = _cfgs()
    jt = JaxTrainConfig(warmup_steps=2, total_steps=10)
    state = jax_init_state(jax_model(cj), jt, jax.random.key(0))
    tstate = convert.train_state_from_jax(jax.tree.map(np.asarray, state),
                                          device="cpu")
    jbatch = jax_pipeline(cj, S, B, seed=1).batch(0)
    tbatch = make_pipeline(ct, S, B, seed=1, device="cpu").batch(0)
    return state, tstate, jbatch, tbatch


def test_train_state_from_jax_is_bit_exact(start):
    state, tstate, _, _ = start
    for tree_j, tree_t in ((state.params, tstate.params),
                           (state.opt.mu, tstate.opt.mu),
                           (state.opt.master, tstate.opt.master)):
        for a, t in zip(jax.tree.leaves(tree_j), tree_flatten(tree_t)[0]):
            a = np.asarray(a)
            if t.dtype == torch.bfloat16:
                np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                              a.view(np.int16))
            else:
                assert t.dtype == torch.float32
                np.testing.assert_array_equal(t.numpy(), a)
    assert int(tstate.opt.count) == 0 and tstate.opt.count.dtype == torch.int32


@pytest.mark.parametrize("fused_ce", [False, True], ids=["ce", "fused-ce"])
def test_loss_and_gradients_match_reference(start, fused_ce):
    state, tstate, jbatch, tbatch = start
    cj, ct = _cfgs(fused_ce)
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        jstep.make_loss_fn(jax_model(cj)), has_aux=True))(state.params, jbatch)
    (lt, mt), gt = tstep.value_and_grad(tstep.make_loss_fn(
        torch_model(ct, device="cpu")))(tstate.params, tbatch)
    print(f"fused_ce={fused_ce}: loss {float(lt):.7g} vs {float(lj):.7g}")
    assert _rel(lt, lj) <= STEP_TOL and _rel(mt["ce"], mj["ce"]) <= STEP_TOL
    for a, t in zip(jax.tree.leaves(gj), tree_flatten(gt)[0]):
        assert t.dtype == {jnp.bfloat16: torch.bfloat16,
                           jnp.float32: torch.float32}[a.dtype.type]
    _check_tree(f"gradients (fused_ce={fused_ce})", gt, gj,
                scale=float(jopt.global_norm(gj)))


def test_fused_cross_entropy_equals_cross_entropy():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 9, 16))).to(torch.bfloat16)
    head = torch.from_numpy(rng.standard_normal((50, 16))).to(torch.bfloat16)
    labels = torch.from_numpy(rng.integers(0, 50, (2, 9)))
    full = tstep.cross_entropy(torch.einsum("bsd,vd->bsv", x, head), labels)
    fused = tstep.fused_cross_entropy(x, head, labels, vocab_size=50, chunk=16)
    want = jstep.fused_cross_entropy(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                     jnp.asarray(head.float().numpy(),
                                                 jnp.bfloat16),
                                     jnp.asarray(labels.numpy()),
                                     vocab_size=50, chunk=16)
    print(f"fused {float(fused):.7g}, full {float(full):.7g}, "
          f"reference {float(want):.7g}")
    assert _rel(fused, full) <= 1e-6 and _rel(fused, want) <= 1e-6


@pytest.mark.parametrize("fused_ce", [False, True], ids=["ce", "fused-ce"])
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_reference(start, grad_accum, fused_ce):
    state, tstate, jbatch, tbatch = start
    cj, ct = _cfgs(fused_ce)
    kw = dict(grad_accum=grad_accum, warmup_steps=2, total_steps=10)
    js, jm = jax.jit(jax_train_step(jax_model(cj), JaxTrainConfig(**kw)))(
        state, jbatch)
    ts, tm = build_train_step(torch_model(ct, device="cpu"),
                              TrainConfig(**kw))(tstate, tbatch)
    for key in ("loss", "grad_norm", "lr", "ce"):
        print(f"{key}: {float(tm[key]):.7g} vs {float(jm[key]):.7g}")
        assert _rel(tm[key], jm[key]) <= STEP_TOL, key
    assert int(ts.opt.count) == int(js.opt.count) == 1
    for name in ("master", "mu", "nu"):
        _check_tree(f"{name} after the step (G={grad_accum}, "
                    f"fused_ce={fused_ce})", getattr(ts.opt, name),
                    getattr(js.opt, name))
    _check_tree("params after the step", ts.params, js.params)
    # the state it started from is untouched
    assert int(tstate.opt.count) == 0


def test_launcher_trains_on_the_cpu(capsys):
    losses = launcher.main(["--arch", ARCH, "--reduced", "--steps", "3",
                            "--batch", "4", "--seq", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    print(out)
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "device cpu" in out
    assert [ln.split()[1] for ln in out.splitlines()
            if ln.startswith("step")] == ["0", "1", "2"]
    assert out.splitlines()[-1].startswith("loss ")
