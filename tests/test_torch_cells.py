"""The port's launch arithmetic (``repro_torch.launch``) against the
reference's (``repro.launch``): cells, roofline formulas, perf variants,
wire bytes, input specs and the report.

The reference's formulas take ``tests/test_sharding.py``'s duck-typed
``FakeMesh``; the port's take ``DeviceMesh``es over the fake process group
(``torch.testing._internal.distributed.fake_pg``) at 1 x 1, 16 x 16 and
2 x 16 x 16.  Each test ends its group.  The argument bytes of the reduced cells are
held against the reference's compiled ``memory_analysis()`` from
subprocesses with four forced host devices (``tests/_torch_launch_ref.py``).
``repro.launch.roofline`` and
``repro.launch.perf`` set ``XLA_FLAGS`` when they are imported; they are
imported here with JAX's backend already started and the environment put
back right after, so nothing leaks into later subprocesses of this worker.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs.base import SHAPES as RSHAPES
from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as rget_config
from repro.launch import cells as rcells
from repro.launch import report as rreport
from repro.models import get_model as rget_model
from repro_torch._tree import tree_flatten
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import cells, hw, perf, report, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.trace import Collective, StepCounter, storage_key
from repro_torch.models import get_model

jax.devices()                 # the backend starts before the imports below
_env = dict(os.environ)
from repro.launch import perf as rperf  # noqa: E402
from repro.launch import roofline as rroofline  # noqa: E402
os.environ.clear()
os.environ.update(_env)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_sharding import FakeMesh  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
REF = Path(__file__).resolve().parent / "_torch_launch_ref.py"
SUBPROCESS_TIMEOUT_S = 300
FAMILIES = ("qwen2-0.5b", "deepseek-v2-lite-16b", "rwkv6-7b",
            "recurrentgemma-2b", "seamless-m4t-medium", "llava-next-mistral-7b")
KINDS = {"train": (64, 8), "prefill": (64, 4), "decode": (64, 4)}   # S, B
# the decode index is a Python int in the port's meta trace (the step reads
# its value), so the trace cannot tell whether it is needed: rwkv6's decode
# step reads no position, and the reference's jit drops the index there
INDEX_UNUSED = {"rwkv6-7b"}
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
_DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16}


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


@pytest.fixture(scope="module")
def ref_memory(tmp_path_factory):
    """The reference's argument bytes of every reduced cell on a (2, 2)
    mesh, from two subprocesses started together."""
    work = tmp_path_factory.mktemp("launch_mem")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    halves = (FAMILIES[:3], FAMILIES[3:])
    procs = [subprocess.Popen([sys.executable, str(REF), "memory",
                               str(work / f"mem{i}.json"), *archs], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i, archs in enumerate(halves)]
    got = {}

    def get(arch):
        i = 0 if arch in halves[0] else 1
        if i not in got:
            try:
                _, err = procs[i].communicate(timeout=SUBPROCESS_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                procs[i].kill()
                procs[i].communicate()
                pytest.fail(f"reference memory ran past {SUBPROCESS_TIMEOUT_S} s")
            assert procs[i].returncode == 0, err[-3000:]
            got[i] = json.loads((work / f"mem{i}.json").read_text())
        return got[i]

    yield get
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("arch", FAMILIES)
def test_argument_bytes_match_reference(arch, ref_memory):
    """Each kind's reduced cell: the port's ``argument_bytes`` on a fake
    (2, 2) group, less the arguments the step never needs (the one-rank
    meta trace's ``StepCounter.needs``: the encoder at an encoder-decoder
    decode step, the cross cache that its prefill overwrites whole), equals
    the reference's ``argument_size_in_bytes`` on four host devices, whose
    jit drops those same arguments."""
    want = ref_memory(arch)
    for kind, (S, B) in KINDS.items():
        shape = ShapeConfig(f"t_{kind}", S, B, kind)
        cfg = get_config(arch).reduced()
        _fake_group(1)
        try:
            mesh = init_device_mesh("cpu", (1, 1),
                                    mesh_dim_names=("data", "model"))
            one = cells.build_cell(cfg, shape, mesh, device="meta")
            args = cells.materialize_cell(one, None)
            with StepCounter() as counter:
                one.fn(*args)
            leaves = [t for t in tree_flatten(list(args))[0]
                      if isinstance(t, torch.Tensor)]
            needed = [counter.needs(t) for t in leaves]
        finally:
            dist.destroy_process_group()
        _fake_group(4)
        try:
            mesh = init_device_mesh("cpu", (2, 2),
                                    mesh_dim_names=("data", "model"))
            cell = cells.build_cell(cfg, shape, mesh, device="meta")
            total = cells.argument_bytes(cell)
            stand = tree_flatten(list(cell.args))[0]
            shards = tree_flatten(list(cell.in_shardings))[0]
            if kind == "decode":           # the index: last, not in `leaves`
                stand, shards = stand[:-1], shards[:-1]
            # the same leaves in the same order (a KV head dim may be
            # repeated for the "model" axis: kv_repeat)
            assert [t.dim() for t in stand] == [t.dim() for t in leaves]
            kept = sum(cells.local_bytes(t, s)
                       for t, s, n in zip(stand, shards, needed) if n)
        finally:
            dist.destroy_process_group()
        index = 4 if kind == "decode" else 0
        assert total == sum(cells.local_bytes(t, s)
                            for t, s in zip(stand, shards)) + index
        if kind == "decode" and arch not in INDEX_UNUSED:
            kept += index
        print(f"{arch} {kind}: {total} bytes, {kept} needed, reference "
              f"{want[f'{arch}/{kind}']}")
        assert kept == want[f"{arch}/{kind}"], kind


def test_hw_is_the_h100_datasheet():
    assert (hw.PEAK_FLOPS_BF16, hw.PEAK_FLOPS_TF32, hw.PEAK_FLOPS_FP32) \
        == (989e12, 495e12, 67e12)
    assert (hw.HBM_BW, hw.HBM_BYTES, hw.NVLINK_BW) == (3.35e12, 80e9, 450e9)
    assert "H100" in hw.__doc__ and "700" in hw.__doc__


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_arithmetic_matches_reference(arch, meshes):
    """``pick_grad_accum``, ``model_flops`` and ``analytic_memory_floor``
    equal the reference's for every shape of ``arch`` on the mesh; a
    skipped cell gives the reference's (ok, reason)."""
    ref_mesh, mesh = meshes
    tp = ref_mesh.shape["model"]
    for name, rshape in RSHAPES.items():
        rcfg, cfg = rget_config(arch), get_config(arch)
        shape = SHAPES[name]
        assert shape.applicable(cfg) == rshape.applicable(rcfg)
        if not shape.applicable(cfg)[0]:
            continue
        rcfg, cfg = rcfg.with_parallelism(tp), cfg.with_parallelism(tp)
        assert cells.pick_grad_accum(cfg, shape, mesh) \
            == rcells.pick_grad_accum(rcfg, rshape, ref_mesh), name
        assert roofline.model_flops(cfg, shape) \
            == rroofline.model_flops(rcfg, rshape), name
        assert roofline.analytic_memory_floor(cfg, shape, mesh) \
            == rroofline.analytic_memory_floor(rcfg, rshape, ref_mesh), name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    """Every shape's input specs: the reference's names, shapes and dtypes,
    as meta tensors."""
    rmodel = rget_model(rget_config(arch))
    model = get_model(get_config(arch), device="cpu")
    for name, rshape in RSHAPES.items():
        want = rmodel.input_specs(rshape)
        got = model.input_specs(SHAPES[name])
        assert list(got) == list(want), name
        for k, spec in want.items():
            assert tuple(got[k].shape) == tuple(spec.shape), (name, k)
            assert got[k].dtype == _DTYPES[str(spec.dtype)], (name, k)
            assert got[k].device.type == "meta"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_realize_inputs_shapes_dtypes_ranges(arch):
    """Seeded inputs of every kind at one sequence a batch (the specs'
    shapes and dtypes, ids in [0, vocab), finite bf16 embeddings), the
    same from the same seed."""
    cfg = get_config(arch)
    model = get_model(cfg, device="cpu")
    for name, full in SHAPES.items():
        shape = ShapeConfig(name, full.seq_len, 1, full.kind)
        specs = model.input_specs(shape)
        got = model.realize_inputs(shape, torch.Generator().manual_seed(5))
        again = model.realize_inputs(shape, torch.Generator().manual_seed(5))
        assert list(got) == list(specs)
        for k, t in got.items():
            assert t.shape == specs[k].shape and t.dtype == specs[k].dtype
            assert torch.equal(t, again[k])
            if t.dtype == torch.int32:
                assert int(t.min()) >= 0 and int(t.max()) < cfg.vocab_size
            else:
                assert bool(torch.isfinite(t.float()).all())
                assert 0.5 < float(t.float().std()) < 1.5
    meta = get_model(cfg, device="meta")
    for k, t in meta.realize_inputs(SHAPES["decode_32k"], None).items():
        assert t.device.type == "meta"


def test_shape_structs_draw_nothing(monkeypatch):
    from repro_torch.models import param
    monkeypatch.setattr(param, "_draw", lambda *a: pytest.fail("drew"))
    model = get_model(get_config("deepseek-v2-lite-16b"), device="meta")
    structs = model.shape_structs()
    init = model.init(None)
    ref = rget_model(rget_config("deepseek-v2-lite-16b")).shape_structs()
    got = tree_flatten(structs)[0]            # JAX's leaf order
    want = jax.tree.leaves(ref)
    assert len(got) == len(want)
    for g, w, i in zip(got, want, tree_flatten(init)[0]):
        assert tuple(g.shape) == tuple(w.shape) == tuple(i.shape)
        assert g.device.type == "meta" and i.device.type == "meta"
        assert str(g.dtype).split(".")[-1] == str(w.dtype)


def test_perf_variants_match_reference():
    assert perf.VARIANTS == rperf.VARIANTS


# (kind, output shape, HLO dtype, torch dtype) for the wire-byte cases
WIRE_CASES = [("all-reduce", (1024, 16), "f32", 4),
              ("all-gather", (4096, 896), "bf16", 2),
              ("reduce-scatter", (64, 4864), "bf16", 2),
              ("all-to-all", (16, 128, 2048), "bf16", 2),
              ("collective-permute", (8, 512), "f32", 4)]


@pytest.mark.parametrize("groups", ["iota", "list"])
def test_wire_bytes_match_reference(groups):
    """One op of each kind, replica groups as iota and as lists: the
    reference reads HLO lines, the port the equivalent records; the ring
    factors give the same bytes."""
    lines, records = [], []
    for i, (kind, shape, hlo_dtype, size) in enumerate(WIRE_CASES):
        n = 16 if groups == "iota" else 4
        dims = ",".join(map(str, shape))
        if kind == "collective-permute":
            tail = "source_target_pairs={{0,1},{1,0}}"
            n_rec = 16        # the reference's default; unused by the factor
        elif groups == "iota":
            tail = f"replica_groups=[16,{n}]<=[256]"
            n_rec = n
        else:
            tail = "replica_groups={{" + ",".join(map(str, range(n))) \
                + "},{" + ",".join(map(str, range(n, 2 * n))) + "}}"
            n_rec = n
        lines.append(f"  %c{i} = {hlo_dtype}[{dims}]{{1,0}} {kind}("
                     f"{hlo_dtype}[{dims}]{{1,0}} %p{i}), {tail}, "
                     f"metadata={{op_name=\"x\"}}")
        records.append(Collective(kind, int(np.prod(shape)) * size, n_rec))
    want = rroofline.collective_wire_bytes("\n".join(lines))
    got = roofline.collective_wire_bytes(records)
    assert set(got) == set(want) == {k for k, *_ in WIRE_CASES} | {"total"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_step_counter_records_collectives():
    """The counter's records of c10d calls (``parallel.collectives``'s
    route) and of DTensor's redistributions (the functional collectives):
    kind, output bytes, group size; what runs is unchanged."""
    _fake_group(256)
    try:
        mesh = make_production_mesh(device="cpu")
        g = mesh.get_group("model")
        t = torch.empty(32, 8, device="meta")
        with StepCounter() as c:
            dist.all_reduce(t, group=g)
            dist.all_gather_into_tensor(torch.empty(512, 8, device="meta"),
                                        t, group=g)
            dist.reduce_scatter_tensor(torch.empty(2, 8, device="meta"), t,
                                       group=g)
            dist.all_to_all_single(torch.empty_like(t), t, group=g)
        assert c.collectives == [Collective("all-reduce", 1024, 16),
                                 Collective("all-gather", 16384, 16),
                                 Collective("reduce-scatter", 64, 16),
                                 Collective("all-to-all", 1024, 16)]
        x = DTensor.from_local(torch.empty(4, 8, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False)
        with StepCounter() as c:
            y = x.redistribute(mesh, [Replicate(), Replicate()])
        assert y.to_local().shape == (64, 8)
        assert c.collectives == [Collective("all-gather", 64 * 8 * 4, 16)]
        assert c.summary() == {"counts": {"all-gather": 1},
                               "bytes": {"all-gather": 2048},
                               "total_bytes": 2048}
    finally:
        dist.destroy_process_group()


def _artifacts(tmp_path):
    dry, roof = tmp_path / "dryrun", tmp_path / "roofline"
    dry.mkdir()
    roof.mkdir()
    ok = {"arch": "qwen2-0.5b", "shape": "decode_32k", "mesh": "single",
          "status": "ok", "meta": {"arch": "qwen2-0.5b"},
          "memory": {"argument_bytes": 3365776932, "output_bytes": 1,
                     "temp_bytes": 104064380, "alias_bytes": 3221225472,
                     "peak_estimate_bytes": 3469841312},
          "cost": {"flops": 1.25e12, "bytes_accessed": 3.0e9},
          "collectives": {"counts": {"all-reduce": 29, "all-gather": 3,
                                     "all-to-all": 1}}}
    train = dict(ok, shape="train_4k", meta={"grad_accum": 8},
                 cost={"flops": None, "bytes_accessed": 0})
    skip = {"arch": "qwen2-0.5b", "shape": "long_500k", "mesh": "multi",
            "status": "skipped", "reason": "full attention"}
    for i, rec in enumerate((ok, train, skip)):
        (dry / f"{i}.json").write_text(json.dumps(rec))
    row = {"arch": "qwen2-0.5b", "shape": "train_4k", "compute_s": 0.098,
           "memory_s": 1.5, "collective_s": 0.01, "bottleneck": "memory",
           "memory_floor_s": 0.02, "bottleneck_floor": "compute",
           "useful_ratio": 0.71}
    (roof / "a.json").write_text(json.dumps(row))
    (roof / "b.json").write_text(json.dumps(dict(
        row, shape="prefill_32k", memory_floor_s=0.0, collective_s=0.0,
        compute_s=0.0)))
    return dry, roof


def test_report_tables_match_reference(tmp_path, monkeypatch):
    """Both report modules on the same artifacts: the same table rows; the
    footnotes differ by design (the port's say what its counts are)."""
    dry, roof = _artifacts(tmp_path)
    monkeypatch.setattr(rreport, "DRY", dry)
    monkeypatch.setattr(rreport, "ROOF", roof)
    for ours, theirs in ((report.dryrun_table(dry), rreport.dryrun_table()),
                         (report.roofline_table(roof),
                          rreport.roofline_table())):
        ours, theirs = ours.splitlines(), theirs.splitlines()
        assert len(ours) == len(theirs) >= 5
        assert ours[:-1] == theirs[:-1]
        assert ours[-1] != theirs[-1]
    assert "products only" in report.ROOFLINE_NOTE
    assert "3.35 TB/s" in report.ROOFLINE_NOTE
    assert "products only" in report.DRYRUN_NOTE


def test_report_main_prints_both_tables(tmp_path, monkeypatch, capsys):
    dry, roof = _artifacts(tmp_path)
    monkeypatch.setattr(report, "DRY", dry)
    monkeypatch.setattr(report, "ROOF", roof)
    report.main()
    out = capsys.readouterr().out
    assert "## Dry-run" in out and "## Roofline" in out
    assert "| qwen2-0.5b | long_500k | multi | skip |" in out
