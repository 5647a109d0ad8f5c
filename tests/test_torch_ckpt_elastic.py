"""Spot-elastic training in the port, against ``repro``'s, on the CPU.

Sizes are ``tests/test_train_ckpt_elastic.py``'s: qwen2-0.5b reduced to 2
layers and a vocabulary of 128 (the reference's training route), the
``_build_trainer`` world (a one-region catalog, 30 targets, 25 USQS
cycles) at seeds 3 and 4, 3 nodes, a checkpoint every 5 steps, batches of
6 x 32 tokens.  Every draw is seeded.  What is held, and at what
tolerance:

- checkpoints: a round trip bit for bit (bf16 leaves, the 0-dim int32
  ``count``), ``keep``, ``AsyncCheckpointer`` against an in-place write
  after ``save``; a checkpoint written by either package restores in the
  other bit for bit, and their manifests agree;
- the int8 gradient exchange on the same numpy gradients: scales bit-equal
  and codes equal except at half-way ties (counted: both packages round
  half to even, so a tie only moves with a scale's last bit); error
  feedback after five rounds within ``ERR_ULPS`` ulps of each error's
  scale; the compressed mean within 0.05 of the exact one, wire bytes
  equal to the reference's and under a third of the exact exchange's;
- ``SpotElasticTrainer`` from the reference's initial state: events, pools,
  wire bytes, final width and the restored step identical; step 0's loss
  within ``LOSS0_TOL`` (it is bit-equal on this seed); later losses within
  ``LOSS_TOL``.  bf16 autodiff sums in another order in the two packages,
  and the run is chaotic at that level: one bf16 ulp added to one
  embedding element of the port's own initial state moves its loss by up
  to 1.8% over the 20 steps (measured on this seed), the reference's and
  the port's runs part by up to 2.1%;
- the launcher's ``--ckpt-dir`` / ``--resume``: a run killed after step
  4's checkpoint and resumed equals an uninterrupted run bit for bit.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.cloudsim import (Catalog as JCatalog,
                            CollectorConfig as JCollectorConfig,
                            DataCollector as JCollector, SpotMarket as JMarket,
                            SPSQueryService as JService)
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import get_config as jax_config
from repro.data import make_pipeline as jax_pipeline
from repro.elastic import ElasticConfig as JElasticConfig
from repro.elastic import SpotElasticTrainer as JTrainer
from repro.models import get_model as jax_model
from repro.parallel import compression as jcomp
from repro.train import init_train_state as jax_init_state
from repro_torch import convert
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.cloudsim import (Catalog, CollectorConfig, DataCollector,
                                  SpotMarket, SPSQueryService)
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config as torch_config
from repro_torch.data import make_pipeline
from repro_torch.elastic import ElasticConfig, SpotElasticTrainer
from repro_torch.launch import train as launcher
from repro_torch.models import get_model as torch_model
from repro_torch.parallel import compression as comp
from repro_torch.train.optim import tree_flatten

ARCH = "qwen2-0.5b"
CPU = "cpu"
NODES = 3
SEQ, BATCH = 32, 6
LOSS0_TOL = 1e-4
LOSS_TOL = 5e-2
ERR_ULPS = 2


def _cfgs():
    shrink = dict(num_layers=2, vocab_size=128)
    return (jax_config(ARCH).reduced(**shrink),
            torch_config(ARCH).reduced(**shrink))


def _bits(x) -> np.ndarray:
    """A leaf's bits as an integer array (bf16 / float32 / int32)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.detach().cpu().view(torch.int16).numpy()
        return x.detach().cpu().numpy().view(f"i{x.element_size()}")
    a = np.asarray(x)
    return a.view(f"i{a.dtype.itemsize}")


def _assert_trees_bit_equal(got, want):
    g = tree_flatten(got)[0] if not isinstance(got, list) else got
    w = (jax.tree.leaves(want) if not isinstance(want, list) else want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.fixture(scope="module")
def states():
    """The reference's initial ``TrainState`` (numpy leaves) and the
    port's copy of it."""
    cj, _ = _cfgs()
    jstate = jax_init_state(jax_model(cj), JTrainConfig(), jax.random.key(1))
    jnp_state = jax.tree.map(np.asarray, jstate)
    return jstate, convert.train_state_from_jax(jnp_state, device=CPU)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_is_bit_exact(states, tmp_path):
    _, state = states
    ckpt.save(tmp_path, state, 7)
    assert ckpt.latest_step(tmp_path) == 7
    assert not list(tmp_path.glob(".tmp_step_*"))
    restored, step = ckpt.restore(tmp_path, state)
    assert step == 7
    leaves, got = tree_flatten(state)[0], tree_flatten(restored)[0]
    assert [x.dtype for x in got] == [x.dtype for x in leaves]
    assert torch.bfloat16 in {x.dtype for x in got}
    assert got[-1].shape == () and got[-1].dtype == torch.int32
    _assert_trees_bit_equal(got, leaves)
    manifest = json.loads((tmp_path / "step_000000007" / "manifest.json")
                          .read_text())
    assert manifest["num_leaves"] == len(leaves)
    assert {m["dtype"] for m in manifest["leaves"]} == {"bfloat16", "float32",
                                                        "int32"}
    # bf16 leaves are stored widened to float32
    bf16 = [i for i, x in enumerate(leaves) if x.dtype == torch.bfloat16]
    arr = np.load(tmp_path / "step_000000007" / f"leaf_{bf16[0]:05d}.npy")
    assert arr.dtype == np.float32
    with pytest.raises(TypeError, match="NamedSharding"):
        ckpt.restore(tmp_path, state, shardings=object())
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "none", state)


def test_checkpoint_keep_gc(states, tmp_path):
    _, state = states
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tmp_path, state, s, keep=2)
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert steps == ["step_000000004", "step_000000005"]
    assert ckpt.latest_step(tmp_path) == 5


def test_async_checkpointer_snapshots_at_save(states, tmp_path):
    _, state = states
    live = convert.train_state_from_jax(
        jax.tree.map(np.asarray, states[0]), device=CPU)
    before = [x.clone() for x in tree_flatten(live)[0]]
    ac = ckpt.AsyncCheckpointer(tmp_path)
    ac.save(live, 3)
    for x in tree_flatten(live)[0]:        # an optimizer step, in place
        x.add_(1)
    ac.save(live, 4)
    ac.close()
    assert ckpt.latest_step(tmp_path) == 4
    at3, _ = ckpt.restore(tmp_path, state, step=3)
    _assert_trees_bit_equal(tree_flatten(at3)[0], before)
    at4, _ = ckpt.restore(tmp_path, state, step=4)
    _assert_trees_bit_equal(tree_flatten(at4)[0], tree_flatten(live)[0])


def test_checkpoints_cross_packages(states, tmp_path):
    jstate, state = states
    jckpt.save(tmp_path / "ref", jstate, 11)
    restored, step = ckpt.restore(tmp_path / "ref", state)
    assert step == 11
    _assert_trees_bit_equal(restored, jstate)

    ckpt.save(tmp_path / "port", state, 11)
    jrestored, jstep = jckpt.restore(tmp_path / "port", jstate)
    assert jstep == 11
    assert [a.dtype for a in jax.tree.leaves(jrestored)] == \
        [a.dtype for a in jax.tree.leaves(jstate)]
    _assert_trees_bit_equal(jax.tree.leaves(jrestored),
                            jax.tree.leaves(jstate))

    mj, mt = (json.loads((tmp_path / d / "step_000000011" / "manifest.json")
                         .read_text()) for d in ("ref", "port"))
    for key in ("step", "num_leaves", "leaves"):
        assert mj[key] == mt[key], key


# ---------------------------------------------------------------------------
# the int8 gradient exchange
# ---------------------------------------------------------------------------

def _grad_trees(seed: int, n: int, *, unit: bool = False):
    """``n`` gradient trees of float32 numpy leaves; each leaf's scale is
    drawn from 1e-6 to 10, or 1 with ``unit``."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (128, 64), "unit": {"b0": {"wq": (64, 4, 16),
                                                  "bk": (2, 16)}},
              "norm": (64,)}
    def draw(shape):  # noqa: E306
        scale = 1.0 if unit else 10.0 ** rng.integers(-6, 2)
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return [jax.tree.map(draw,
                         shapes, is_leaf=lambda x: isinstance(x, tuple))
            for _ in range(n)]


def _codes_equal_but_ties(got_q, want_q, g32, scale) -> int:
    """Codes must agree except where ``g / scale`` sits half-way between
    two integers; returns how many such ties moved a code."""
    got_q, want_q = np.asarray(got_q), np.asarray(want_q)
    diff = got_q != want_q
    r = np.asarray(g32, np.float32) / np.float32(scale)
    tie = np.abs(r - np.floor(r)) == np.float32(0.5)
    assert not (diff & ~tie).any(), int((diff & ~tie).sum())
    return int(diff.sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_reference(dtype):
    ties = 0
    for g in jax.tree.leaves(_grad_trees(0, 4)):
        e = (np.random.default_rng(g.size).standard_normal(g.shape)
             .astype(np.float32) * np.abs(g).max() * 1e-3)
        gj = jnp.asarray(g, dtype)
        gt = torch.from_numpy(g).to(getattr(torch, dtype))
        qj, sj, ej = jcomp.quantize(gj, jnp.asarray(e))
        qt, st, et = comp.quantize(gt, torch.from_numpy(e))
        assert qt.dtype == torch.int8 and st.dtype == et.dtype == torch.float32
        np.testing.assert_array_equal(_bits(st), _bits(np.asarray(sj)))
        g32 = np.asarray(gj.astype(jnp.float32)) + e
        ties += _codes_equal_but_ties(qt.numpy(), qj, g32, np.asarray(sj))
        np.testing.assert_array_equal(
            comp.dequantize(qt, st).numpy(),
            np.asarray(jcomp.dequantize(qj, sj)))
    print(f"{dtype}: {ties} codes moved by half-way ties")


def test_error_feedback_matches_reference():
    rounds = [_grad_trees(10 + r, 1)[0] for r in range(5)]
    fj, ft = jcomp.ErrorFeedback(), comp.ErrorFeedback()
    ties = 0
    for g in rounds:
        ej = (jax.tree.leaves(fj._err) if fj._err is not None
              else [np.zeros(x.shape, np.float32) for x in jax.tree.leaves(g)])
        qj, sj = fj.compress(jax.tree.map(jnp.asarray, g))
        qt, st = ft.compress(jax.tree.map(torch.from_numpy, g))
        for q_t, q_j, s_t, s_j, x, e in zip(
                tree_flatten(qt)[0], jax.tree.leaves(qj), tree_flatten(st)[0],
                jax.tree.leaves(sj), jax.tree.leaves(g), ej):
            np.testing.assert_array_equal(_bits(s_t), _bits(np.asarray(s_j)))
            ties += _codes_equal_but_ties(q_t.numpy(), q_j,
                                          x + np.asarray(e), np.asarray(s_j))
    worst = 0.0
    for et, ej, s in zip(ft.error, jax.tree.leaves(fj._err),
                         jax.tree.leaves(sj)):
        ulp = np.spacing(np.float32(np.asarray(s)))
        worst = max(worst, float(np.abs(et.numpy() - np.asarray(ej)).max()
                                 / ulp))
    print(f"error feedback after 5 rounds: worst {worst:.3g} ulps of the "
          f"scale; {ties} half-way ties")
    assert worst <= ERR_ULPS


def test_allreduce_matches_reference():
    grads = _grad_trees(1, 4, unit=True)
    jg = [jax.tree.map(jnp.asarray, g) for g in grads]
    tg = [jax.tree.map(torch.from_numpy, g) for g in grads]
    exact, wire_exact = comp.allreduce_exact(tg)
    got, wire = comp.allreduce_compressed(
        tg, [comp.ErrorFeedback() for _ in tg])
    want, jwire = jcomp.allreduce_compressed(
        jg, [jcomp.ErrorFeedback() for _ in jg])
    jexact, jwire_exact = jcomp.allreduce_exact(jg)
    assert wire == jwire and wire_exact == jwire_exact
    assert wire < wire_exact / 3
    for a, b, x, y in zip(tree_flatten(got)[0], jax.tree.leaves(want),
                          tree_flatten(exact)[0], jax.tree.leaves(jexact)):
        np.testing.assert_allclose(a.numpy(), x.numpy(), atol=0.05)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _world(pkg, seed):
    Cat, Mkt, Svc, Col, Cfg = pkg
    cat = Cat(seed=seed, n_regions=1)
    mkt = Mkt(cat, seed=seed)
    svc = Svc(mkt, n_accounts=500)
    targets = [(t.name, r, az) for (t, r, az) in mkt.pool_keys[::11][:30]]
    col = Col(svc, targets, Cfg())
    col.run(25)
    return mkt, col.to_candidate_set()


def _trainers(tmp_path, seed):
    """The reference's ``_build_trainer`` and the port's on the same world,
    the port's state the reference's initial one."""
    cj, ct = _cfgs()
    mkt, cands = _world((JCatalog, JMarket, JService, JCollector,
                         JCollectorConfig), seed)
    jtr = JTrainer(jax_model(cj), JTrainConfig(learning_rate=3e-3,
                                               warmup_steps=2,
                                               total_steps=100),
                   mkt, cands, JElasticConfig(nodes_wanted=NODES,
                                              checkpoint_every=5),
                   jax_pipeline(cj, seq_len=SEQ, global_batch=BATCH),
                   tmp_path / "ref", seed=seed)
    mkt, cands = _world((Catalog, SpotMarket, SPSQueryService, DataCollector,
                         CollectorConfig), seed)
    tr = SpotElasticTrainer(
        torch_model(ct, device=CPU),
        TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=100),
        mkt, cands, ElasticConfig(nodes_wanted=NODES, checkpoint_every=5),
        make_pipeline(ct, seq_len=SEQ, global_batch=BATCH, device=CPU),
        tmp_path / "port", seed=seed, device=CPU)
    tr.state = convert.train_state_from_jax(
        jax.tree.map(np.asarray, jtr.state), device=CPU)
    return jtr, tr


def _nodes(tr):
    return [(n.node_id, tuple(str(x) for x in n.pool), n.speed,
             list(n.market_ids), list(n.step_times)) for n in tr.nodes]


def _hold_runs(label, jtr, tr, jout, out, *, learns=True):
    events = lambda o: [(e.step, e.kind, e.detail)  # noqa: E731
                        for e in o["events"]]
    assert events(out) == events(jout)
    assert _nodes(tr) == _nodes(jtr)
    for key in ("wire_bytes", "final_nodes", "restored_from"):
        assert out[key] == jout[key], key
    lj, lt = np.asarray(jout["losses"]), np.asarray(out["losses"])
    assert lt.shape == lj.shape and np.isfinite(lt).all()
    rel = np.abs(lt - lj) / np.abs(lj)
    print(f"{label}: {len(events(out))} events, {out['wire_bytes']} wire "
          f"bytes; loss relative deviations (tolerance {LOSS0_TOL:g} at step "
          f"0, {LOSS_TOL:g} after): {np.array2string(rel, precision=2)}")
    assert rel[0] <= LOSS0_TOL
    assert rel.max() <= LOSS_TOL
    assert lt[-1] < lt[0] or not learns


def test_elastic_trainer_matches_reference(tmp_path):
    jtr, tr = _trainers(tmp_path, seed=3)
    assert _nodes(tr) == _nodes(jtr)
    jout = jtr.train(20, minutes_per_step=5.0)
    out = tr.train(20, minutes_per_step=5.0)
    assert "checkpoint" in {e.kind for e in out["events"]}
    _hold_runs("train(20)", jtr, tr, jout, out)
    # the checkpoints the two wrote are one another's
    for d in ("ref", "port"):
        assert ckpt.latest_step(tmp_path / d) == 20
    restored, _ = ckpt.restore(tmp_path / "ref", tr.state)
    assert len(tree_flatten(restored)[0]) == len(jax.tree.leaves(jtr.state))


def _reclaim_all(tr):
    # exactly as tests/test_train_ckpt_elastic.py forces an interruption
    for n in list(tr.nodes):
        tr.market.terminate(n.market_ids)
        for rec in tr.market.records:
            if rec.node_id in n.market_ids:
                rec.reason = "interrupted"


def test_elastic_trainer_forced_interruption_matches_reference(tmp_path):
    jtr, tr = _trainers(tmp_path, seed=4)
    first = [t.train(6, minutes_per_step=1.0) for t in (jtr, tr)]
    _hold_runs("train(6)", jtr, tr, *first)
    for t in (jtr, tr):
        _reclaim_all(t)
    jout = jtr.train(6, minutes_per_step=1.0)
    out = tr.train(6, minutes_per_step=1.0)
    kinds = [e.kind for e in out["events"]]
    assert "interruption" in kinds and out["restored_from"] == 5
    assert kinds.count("restore") >= 2 and tr.nodes
    # rewound to step 5, the second call runs step 5 alone
    assert len(out["losses"]) == 1
    events = lambda o: [(e.step, e.kind, e.detail)  # noqa: E731
                        for e in o["events"]]
    assert events(out) == events(jout)
    assert _nodes(tr) == _nodes(jtr)
    for key in ("wire_bytes", "final_nodes", "restored_from"):
        assert out[key] == jout[key], key
    rel = abs(out["losses"][0] - jout["losses"][0]) / abs(jout["losses"][0])
    print(f"after the reclaim: loss {out['losses']} vs {jout['losses']} "
          f"({rel:.2g} relative, tolerance {LOSS_TOL:g})")
    assert rel <= LOSS_TOL


SLOW = 4.0      # a node's speed: its gamma(20, speed / 20) step times


def test_elastic_trainer_ejects_a_straggler_as_the_reference_does(tmp_path):
    """One node of each trainer slowed to ``SLOW`` after provisioning: its
    mean step time over the heartbeat window passes 2.5x the median node's
    (whose speeds are 0.8-1.2), so both eject it at the same step and
    re-provision through their engines."""
    jtr, tr = _trainers(tmp_path, seed=3)
    for t in (jtr, tr):
        t.nodes[1].speed = SLOW
    slow = tr.nodes[1].node_id
    jout = jtr.train(8, minutes_per_step=1.0)
    out = tr.train(8, minutes_per_step=1.0)
    ejected = [(e.step, e.detail) for e in out["events"]
               if e.kind == "straggler"]
    assert ejected == [(ElasticConfig().heartbeat_window - 1,
                        f"ejected node {slow}")]
    assert slow not in {n.node_id for n in tr.nodes}
    assert len(tr.nodes) == NODES
    # 8 steps from the warmup: the losses are held, not their trend
    _hold_runs("straggler", jtr, tr, jout, out, learns=False)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

class _Killed(Exception):
    pass


def test_launcher_resume_equals_uninterrupted_run(tmp_path, monkeypatch):
    argv = ["--arch", ARCH, "--reduced", "--steps", "8", "--batch", "4",
            "--seq", "32", "--device", CPU]
    whole = launcher.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    assert ckpt.latest_step(tmp_path / "a") == 8

    real = launcher.make_pipeline

    def dies_at_4(*args, **kw):
        pipe = real(*args, **kw)
        batch = pipe.batch

        def at(step):
            if step == 4:
                raise _Killed
            return batch(step)
        pipe.batch = at
        return pipe

    monkeypatch.setattr(launcher, "make_pipeline", dies_at_4)
    with pytest.raises(_Killed):
        launcher.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    monkeypatch.setattr(launcher, "make_pipeline", real)
    assert ckpt.latest_step(tmp_path / "b") == 4
    resumed = launcher.main(argv + ["--ckpt-dir", str(tmp_path / "b"),
                                    "--resume"])
    assert len(whole) == 8 and len(resumed) == 4
    assert resumed == whole[4:]
    for i in range(len(list((tmp_path / "a" / "step_000000008")
                            .glob("leaf_*.npy")))):
        name = f"step_000000008/leaf_{i:05d}.npy"
        np.testing.assert_array_equal(np.load(tmp_path / "b" / name),
                                      np.load(tmp_path / "a" / name))
