"""The port's mesh paths on gloo ranks on the CPU (``tests/_torch_mesh_ranks.py``).

The reduced DeepSeek-style MoE of ``tests/test_moe_shardmap.py`` goes
through the port's expert-parallel path on a (2, 2) ``("data", "model")``
mesh of four ranks and through the reference's ``_apply_moe_shardmap`` on a
(2, 2) host mesh (a subprocess with four forced host devices), on the same
seeded numbers, with ample capacity and with drops; the reference test's
bounds hold them (3e-2 on y, 1e-3 on aux, 5e-2 relative on gradients).
The port's EP path is also held against its own one-device path run on
each data shard (the same local capacity), ``constrain``'s specs against
the reference's, ``tp_project_rs``'s reduce-scatter against the plain
einsum, ``restore(shardings=)`` on one and four ranks, and the step with
sharded accumulators against the one-device step.  Each spawn and the
subprocess run under their own timeout.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_mesh_ranks as R  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FACTORS = (8.0, 1.0)           # ample capacity (no drops); drops
SUBPROCESS_TIMEOUT_S = 120

# (shape, template) of the constraints the models make, on dims that the
# mesh's 2 divides and does not
CONSTRAIN_CASES = [
    ((4, 8, 6), ("dp", "sp", None)), ((3, 7, 6), ("dp", "sp", None)),
    ((2, 1, 6), ("dp", "sp", None)),
    ((8, 5, 6), ("model", None, None)), ((7, 5, 6), ("model", None, None)),
    ((4, 6, 10), ("dp", None, "model")), ((4, 6, 9), ("dp", None, "model")),
    ((4, 6, 4, 8), ("dp", None, "model", None)),
    ((5, 6, 3, 8), ("dp", None, "model", None)),
]
KNOBS = [(sp, dp_only) for sp in (True, False) for dp_only in (False, True)]

SCRIPT = textwrap.dedent("""
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp

    from repro.configs.base import MoEConfig, ModelConfig
    from repro.launch.mesh import compat_make_mesh
    from repro.models import moe as moe_lib
    from repro.models.layers import constrain

    inp, out, factors, cases = sys.argv[1], sys.argv[2], \\
        json.loads(sys.argv[3]), json.loads(sys.argv[4])
    mesh = compat_make_mesh((2, 2), ("data", "model"))

    def config(cf, **kw):
        return ModelConfig(
            arch_id="t", family="moe", num_layers=1, d_model=32, num_heads=4,
            num_kv_heads=4, head_dim=8, d_ff=64, vocab_size=128,
            moe=MoEConfig(num_experts=8, num_shared_experts=1, top_k=2,
                          d_ff=48, capacity_factor=cf), **kw)

    arrs = dict(np.load(inp))
    params = {k: jnp.asarray(v, jnp.float32 if k == "router" else jnp.bfloat16)
              for k, v in arrs.items() if k != "x"}
    x = jnp.asarray(arrs["x"], jnp.bfloat16)
    res = {}
    for cf in factors:
        cfg = config(cf, mesh=mesh, moe_impl="shardmap")

        def loss(p, x):
            y, aux = moe_lib.apply_moe(cfg, p, x)
            return (y.astype(jnp.float32) ** 2).mean() + aux

        y, aux = jax.jit(lambda p, x: moe_lib.apply_moe(cfg, p, x))(params, x)
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
        tag = f"cf{cf:g}"
        res[f"{tag}/y"] = np.asarray(y.astype(jnp.float32))
        res[f"{tag}/aux"] = np.float32(aux)
        for k, g in gp.items():
            res[f"{tag}/grad/{k}"] = np.asarray(g.astype(jnp.float32))
        res[f"{tag}/grad/x"] = np.asarray(gx.astype(jnp.float32))
    specs = {}
    for key, (shape, tpl, sp, dp_only) in cases.items():
        cfg = config(8.0, mesh=mesh, sp=sp, dp_only=dp_only)
        y = jax.jit(lambda a: constrain(a + 0, cfg, tuple(tpl)))(
            jnp.zeros(shape, jnp.float32))
        specs[key] = [list(p) if isinstance(p, tuple) else p
                      for p in y.sharding.spec]
    np.savez(out, **res)
    with open(out + ".json", "w") as f:
        json.dump(specs, f)
    print("REF_OK")
""")


def _case_key(shape, tpl, sp, dp_only) -> str:
    return f"{shape}|{tpl}|sp={sp}|dp_only={dp_only}"


def _cases() -> dict:
    return {_case_key(shape, tpl, sp, dpo): (list(shape), list(tpl), sp, dpo)
            for shape, tpl in CONSTRAIN_CASES for sp, dpo in KNOBS}


def _trim(spec) -> tuple:
    """A spec without its trailing ``None``s, tuples as tuples."""
    parts = [tuple(p) if isinstance(p, list) else p for p in spec]
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh")


@pytest.fixture(scope="module")
def moe_arrays(workdir):
    arrs = R.moe_inputs(0)
    path = workdir / "moe_inputs.npz"
    np.savez(path, **arrs)
    return path


@pytest.fixture(scope="module")
def reference(workdir, moe_arrays):
    """The reference's ``_apply_moe_shardmap`` (y, aux, gradients) and
    ``constrain`` specs on a (2, 2) host mesh."""
    out = workdir / "reference.npz"
    env = dict(os.environ, PYTHONPATH="src")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(moe_arrays), str(out),
         json.dumps(FACTORS), json.dumps(_cases())],
        env=env, capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT_S,
        cwd=REPO)
    assert res.returncode == 0 and "REF_OK" in res.stdout, res.stderr[-3000:]
    return dict(np.load(out)), json.loads(Path(str(out) + ".json").read_text())


@pytest.fixture(scope="module")
def port_ep(workdir, moe_arrays):
    out = workdir / "port_ep.npz"
    R.spawn("ep_against_reference", workdir, str(moe_arrays), str(out),
            FACTORS)
    return dict(np.load(out))


@pytest.mark.parametrize("factor", FACTORS, ids=["ample", "drops"])
def test_ep_matches_reference_shardmap(reference, port_ep, factor):
    ref, _ = reference
    tag = f"cf{factor:g}"
    err = np.abs(ref[f"{tag}/y"] - port_ep[f"{tag}/y"]).max()
    assert err < 3e-2, err
    aux_err = abs(float(ref[f"{tag}/aux"]) - float(port_ep[f"{tag}/aux"]))
    assert aux_err < 1e-3, aux_err
    grads = [k for k in ref if k.startswith(f"{tag}/grad/")]
    assert len(grads) == 8 and set(grads) == {
        k for k in port_ep if k.startswith(f"{tag}/grad/")}
    for k in grads:
        a, b = ref[k], port_ep[k]
        gerr = np.abs(a - b).max()
        scale = np.abs(a).max() + 1e-6
        assert gerr / scale < 5e-2, (k, gerr, scale)


def test_drops_case_drops_tokens(moe_arrays):
    """The "drops" factor really drops: the reference's capacity at the
    local token count (2 x 16 tokens a data shard) is under its load."""
    from repro_torch.models.moe import route
    arrs = dict(np.load(moe_arrays))
    cfg = R.moe_cfg(FACTORS[1])
    params = R._torch_params(arrs)
    x = torch.from_numpy(arrs["x"]).bfloat16()
    dropped = 0
    for shard in x.chunk(2):
        *_, pos_flat, C = route(cfg, params, shard.reshape(-1, 32))
        dropped += int((pos_flat == C).sum())
    assert dropped > 0


def test_ep_matches_per_shard_one_device(workdir):
    out = workdir / "gaps.npz"
    R.spawn("ep_against_one_device", workdir, 0, FACTORS, str(out))
    gaps = dict(np.load(out))
    assert int(gaps["cf8/drops"]) == 0 and int(gaps["cf1/drops"]) > 0
    print({k: float(v) for k, v in gaps.items()})


@pytest.fixture
def fake_mesh():
    """A (2, 2) mesh on the fake process group (specs only, no compute);
    the group is ended after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_constrain_specs_match_reference(reference, fake_mesh):
    from repro_torch.models.layers import constrain_spec
    _, ref_specs = reference
    for key, (shape, tpl, sp, dp_only) in _cases().items():
        cfg = R.moe_cfg(8.0, mesh=fake_mesh, sp=sp, dp_only=dp_only)
        got = constrain_spec(tuple(shape), cfg, tuple(tpl))
        assert _trim(got) == _trim(ref_specs[key]), (key, got, ref_specs[key])


def test_constrain_redistributes_on_ranks(workdir):
    R.spawn("constrain_on_ranks", workdir, json.dumps(_cases()))


def test_tp_project_rs_shardmap(workdir):
    R.spawn("tp_project_rs_on_ranks", workdir)


def test_restore_one_rank_mesh(tmp_path):
    """The twin of ``test_restore_with_resharding``: restore onto the (1, 1)
    host mesh; every leaf a DTensor on it, bit-equal to the one-device
    restore."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import NamedSharding, P
    from repro_torch.models.param import tree_map
    from repro_torch._tree import tree_flatten

    state = R.small_train_state()
    ckpt.save(tmp_path, state, 1)
    plain, _ = ckpt.restore(tmp_path, state)
    assert not dist.is_initialized()
    mesh = make_host_mesh(device="cpu")
    try:
        shardings = tree_map(lambda x: NamedSharding(mesh, P(*([None] * x.dim()))),
                             state)
        restored, step = ckpt.restore(tmp_path, state, shardings=shardings)
        assert step == 1
        leaves = tree_flatten(restored)[0]
        assert leaves[0].device_mesh.shape == (1, 1)
        assert leaves[0].device_mesh.mesh_dim_names == ("data", "model")
        for got, want in zip(leaves, tree_flatten(plain)[0]):
            assert got.dtype == want.dtype
            assert torch.equal(got.full_tensor(), want)
    finally:
        dist.destroy_process_group()


def test_restore_four_ranks(workdir):
    from repro_torch.ckpt import checkpoint as ckpt
    root = workdir / "ckpt4"
    ckpt.save(root, R.small_train_state(), 3)
    R.spawn("restore_on_ranks", workdir, str(root))


def test_sharded_step_matches_one_device(workdir):
    R.spawn("sharded_step_on_ranks", workdir)
