"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
reference's (``repro.parallel.sharding``).

The reference's rules take a duck-typed mesh (``tests/test_sharding.py``'s
``FakeMesh``); the port's take a ``DeviceMesh``, built here on the fake
process group (``torch.testing._internal.distributed.fake_pg``) at the
production sizes, 16 x 16 and 2 x 16 x 16, and at 1 x 1, with no compute.
Each test ends its group.  The spec-to-placements order for a dim over
``("pod", "data")`` is held against JAX's own device index map on eight
host devices (a subprocess).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs.registry import get_config
from repro.models import get_model
from repro.models.param import is_spec
from repro.parallel import sharding as rshd
from repro_torch._tree import tree_flatten
from repro_torch.configs.registry import get_config as tget_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import get_model as tget_model
from repro_torch.parallel import sharding as tshd

ARCHS = ("qwen3-32b", "llama4-scout-17b-a16e", "deepseek-v2-lite-16b",
         "rwkv6-7b", "recurrentgemma-2b", "seamless-m4t-medium",
         "qwen2-0.5b", "llava-next-mistral-7b")
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class FakeMesh:
    """The reference tests' duck-typed mesh (spec logic only)."""
    def __init__(self, shape):
        self._shape = shape

    @property
    def axis_names(self):
        return tuple(self._shape)

    @property
    def shape(self):
        return self._shape

    @property
    def size(self):
        return int(np.prod(list(self._shape.values())))


def _fake_group(world: int, rank: int = 0):
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


@pytest.fixture(params=list(MESHES))
def meshes(request):
    """(reference mesh, port mesh) of one size; the fake group ends after
    the test."""
    shape, names = MESHES[request.param]
    _fake_group(int(np.prod(shape)))
    try:
        if request.param == "1x1":
            port = init_device_mesh("cpu", shape, mesh_dim_names=names)
        else:
            port = make_production_mesh(multi_pod=len(shape) == 3,
                                        device="cpu")
        yield FakeMesh(dict(zip(names, shape))), port
    finally:
        dist.destroy_process_group()


def _norm(spec) -> tuple:
    return tuple(spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_reference(arch, meshes):
    ref_mesh, mesh = meshes
    tp = ref_mesh.shape["model"]
    ref_leaves = jax.tree.leaves(
        get_model(get_config(arch).with_parallelism(tp)).structure(),
        is_leaf=is_spec)
    port_leaves = tree_flatten(
        tget_model(tget_config(arch).with_parallelism(tp),
                   device="cpu").structure())[0]
    assert len(ref_leaves) == len(port_leaves)
    for r, p in zip(ref_leaves, port_leaves):
        assert tuple(r.shape) == tuple(p.shape) and tuple(r.axes) == tuple(p.axes)
        for dp_only in (False, True):
            assert _norm(tshd.param_pspec(p.axes, p.shape, mesh,
                                          dp_only=dp_only)) \
                == _norm(rshd.param_pspec(r.axes, r.shape, ref_mesh,
                                          dp_only=dp_only)), (arch, r)
            for zero1 in (True, False):
                assert _norm(tshd.opt_pspec(p.axes, p.shape, mesh, zero1=zero1,
                                            dp_only=dp_only)) \
                    == _norm(rshd.opt_pspec(r.axes, r.shape, ref_mesh,
                                            zero1=zero1, dp_only=dp_only)), \
                    (arch, r, zero1, dp_only)


def test_shardings_trees(meshes):
    """``param_shardings`` / ``opt_shardings`` give a ``NamedSharding`` a
    leaf, its spec the rule's and its placements the spec's."""
    _, mesh = meshes
    structure = tget_model(tget_config("deepseek-v2-lite-16b"),
                           device="cpu").structure()
    specs = tree_flatten(structure)[0]
    for tree, rule in ((tshd.param_shardings(structure, mesh), tshd.param_pspec),
                       (tshd.opt_shardings(structure, mesh), tshd.opt_pspec)):
        leaves = tree_flatten(tree)[0]
        assert len(leaves) == len(specs)
        for shd, s in zip(leaves, specs):
            assert shd.mesh is mesh and hasattr(shd, "mesh")
            assert shd.spec == rule(s.axes, s.shape, mesh)
            assert shd.placements == tshd.placements(shd.spec, mesh)


@pytest.mark.parametrize("shape", [(256, 4096), (1, 4096), (512, 8, 16),
                                   (32, 7), (16,)])
def test_batch_specs_match_reference(shape, meshes):
    ref_mesh, mesh = meshes
    for dp_only in (False, True):
        assert _norm(tshd.batch_pspec(mesh, shape, dp_only=dp_only)) \
            == _norm(rshd.batch_pspec(ref_mesh, shape, dp_only=dp_only))
    got = tshd.batch_shardings({"tokens": torch.zeros(shape)}, mesh)
    assert got["tokens"].spec == tshd.batch_pspec(mesh, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, meshes):
    """Each family's serve cache (reduced widths: small caches on the
    CPU) gets the reference's spec on every leaf; seamless's ``cross`` K/V
    (rank 5) take one leading layer dim in front of the ``"k"`` rule."""
    ref_mesh, mesh = meshes
    B = 64
    ref_cfg = get_config(arch).reduced()
    cache = jax.eval_shape(lambda: get_model(ref_cfg).init_cache(B, 16))
    ref = rshd.cache_shardings(cache, ref_mesh)
    ref_specs = [tuple(s.spec) for s in jax.tree.leaves(ref)]
    port_cache = tget_model(tget_config(arch).reduced(),
                            device="cpu").init_cache(B, 16)
    got = tshd.cache_shardings(port_cache, mesh)
    got_specs = [tuple(s.spec) for s in tree_flatten(got)[0]]
    assert got_specs == ref_specs
    leaves = tree_flatten(port_cache)[0]
    assert [tuple(x.shape) for x in leaves] == \
        [tuple(x.shape) for x in jax.tree.leaves(cache)]
    if arch == "seamless-m4t-medium":
        cross = tshd.cache_shardings(port_cache["cross"], mesh)
        for leaf, shd in zip(tree_flatten(port_cache["cross"])[0],
                             tree_flatten(cross)[0]):
            assert leaf.dim() == 5 and shd.spec[0] is None


@pytest.fixture(autouse=True)
def _reference_named_sharding(monkeypatch):
    """The reference's ``cache_shardings`` wraps each spec in a JAX
    ``NamedSharding``, which needs real devices: record the spec instead."""
    class Spec:
        def __init__(self, mesh, spec):
            self.mesh, self.spec = mesh, spec
    monkeypatch.setattr(rshd, "NamedSharding", Spec)


def test_constrain_activation_specs(meshes):
    """``constrain_activation`` is the identity on one rank and
    redistributes (raising on a plain tensor) on more."""
    _, mesh = meshes
    x = torch.zeros(32, 8, 4)
    if mesh.size() == 1:
        assert tshd.constrain_activation(x, mesh, sp=True) is x
    else:
        with pytest.raises(TypeError):
            tshd.constrain_activation(x, mesh, sp=True)
    assert tshd.constrain_activation(x, None) is x


def test_placements_pod_data_order():
    """A dim over ``("pod", "data")`` is split pod-major on the 2 x 16 x 16
    mesh: rank r = 256 pod + 16 data + model holds rows (16 pod + data) of
    32 blocks, as JAX shards it."""
    for rank in (0, 37, 300, 511):
        _fake_group(512, rank)
        try:
            mesh = make_production_mesh(multi_pod=True, device="cpu")
            spec = tshd.P(("pod", "data"), "model")
            pl = tshd.placements(spec, mesh)
            assert pl == (Shard(0), Shard(0), Shard(1))
            sh = tshd.NamedSharding(mesh, spec)
            pod, data, model = rank // 256, rank // 16 % 16, rank % 16
            block = 16 * pod + data
            assert tshd.local_slices((64, 32), sh) == (
                slice(2 * block, 2 * block + 2), slice(2 * model, 2 * model + 2))
            assert tshd.local_shape((64, 32), sh) == (2, 2)
            # DTensor's own split agrees
            from torch.distributed.tensor._utils import (
                compute_local_shape_and_global_offset)
            size, off = compute_local_shape_and_global_offset(
                torch.Size((64, 32)), mesh, pl)
            assert tuple(size) == (2, 2) and tuple(off) == (2 * block, 2 * model)
        finally:
            dist.destroy_process_group()


def test_placements_rules():
    _fake_group(4)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        assert tshd.placements(tshd.P(), mesh) == (Replicate(), Replicate())
        assert tshd.placements(tshd.P(None, "model"), mesh) == \
            (Replicate(), Shard(1))
        assert tshd.placements(tshd.P(("data", "model")), mesh) == \
            (Shard(0), Shard(0))
        with pytest.raises(ValueError, match="order"):
            tshd.placements(tshd.P(("model", "data")), mesh)
        with pytest.raises(ValueError, match="twice"):
            tshd.placements(tshd.P("model", "model"), mesh)
    finally:
        dist.destroy_process_group()
    # canonical entries, as JAX's
    assert tshd.P(("data",), None) == ("data", None)
    assert tshd.P((), "model") == (None, "model")
    assert tuple(tshd.P(("pod", "data"))) == (("pod", "data"),)


ORDER_SCRIPT = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.launch.mesh import compat_make_mesh
    mesh = compat_make_mesh((2, 2, 2), ("pod", "data", "model"))
    out = {}
    for name, spec in {"podata": P(("pod", "data"), "model"),
                       "data_model": P("data", "model"),
                       "all": P(("pod", "data", "model"), None)}.items():
        imap = NamedSharding(mesh, spec).devices_indices_map((8, 4))
        rows = {}
        for pos in np.ndindex(mesh.devices.shape):
            idx = imap[mesh.devices[pos]]
            rank = int(np.ravel_multi_index(pos, mesh.devices.shape))
            rows[rank] = [[s.start or 0, s.stop if s.stop is not None else n]
                          for s, n in zip(idx, (8, 4))]
        out[name] = rows
    print(json.dumps(out))
""")


def test_placements_match_jax_device_order():
    """On a 2 x 2 x 2 mesh each rank's slices are the ones JAX gives the
    device at the same mesh position, for specs over one and several
    axes."""
    env = dict(os.environ, PYTHONPATH="src")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", ORDER_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    specs = {"podata": tshd.P(("pod", "data"), "model"),
             "data_model": tshd.P("data", "model"),
             "all": tshd.P(("pod", "data", "model"), None)}
    for rank in range(8):
        _fake_group(8, rank)
        try:
            mesh = init_device_mesh("cpu", (2, 2, 2),
                                    mesh_dim_names=("pod", "data", "model"))
            for name, spec in specs.items():
                got = tshd.local_slices((8, 4), tshd.NamedSharding(mesh, spec))
                assert [[s.start, s.stop] for s in got] == \
                    want[name][str(rank)], (name, rank)
        finally:
            dist.destroy_process_group()
