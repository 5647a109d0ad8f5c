"""The port's launch cells run (``repro_torch.launch``): FLOPs against a
real run and the reference's count, and the dry-run at full width.

The reference's cost passes run in subprocesses (``tests/_torch_launch_ref.py``),
started once for the module and read as the tests need them.  Every group
the tests make in this process ends with the test.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun, hw
from repro_torch.launch.cells import build_cell, materialize_cell
from repro_torch.launch.roofline import roofline_cell

REPO = Path(__file__).resolve().parents[1]
REF = Path(__file__).resolve().parent / "_torch_launch_ref.py"
SUBPROCESS_TIMEOUT_S = 300
FAMILIES = ("qwen2-0.5b", "deepseek-v2-lite-16b", "rwkv6-7b",
            "recurrentgemma-2b", "seamless-m4t-medium", "llava-next-mistral-7b")
KINDS = {"train": (64, 8), "prefill": (64, 4), "decode": (64, 4)}   # S, B
PARTS = (FAMILIES[:2], FAMILIES[2:4], FAMILIES[4:])   # one subprocess each
FLOPS_OVER_XLA = 1.01        # the port counts products only; XLA adds more


def _shape(kind: str) -> ShapeConfig:
    S, B = KINDS[kind]
    return ShapeConfig(f"t_{kind}", S, B, kind)


def _run_ref(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, str(REF), *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's FLOPs from three subprocesses started together;
    ``reference(i)`` waits for the ``i``-th."""
    work = tmp_path_factory.mktemp("launch_ref")
    procs = {i: _run_ref("flops", str(work / f"flops{i}.json"), *archs)
             for i, archs in enumerate(PARTS)}
    done = {}

    def get(name):
        if name not in done:
            proc = procs[name]
            try:
                _, err = proc.communicate(timeout=SUBPROCESS_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                pytest.fail(f"reference {name} ran past "
                            f"{SUBPROCESS_TIMEOUT_S} s")
            assert proc.returncode == 0, err[-3000:]
            done[name] = work
        return work

    yield get
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _one_rank_mesh():
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    return init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))


@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_flops_equal_real_run_and_stay_under_xla(arch, reference):
    """For each kind on a one-rank mesh: the meta trace's FLOPs equal
    ``FlopCounterMode`` on a real CPU run of the same cell, and stay at
    most 1% above the reference's differenced ``cost_analysis()``."""
    mesh = _one_rank_mesh()
    try:
        ours = {}
        for kind in KINDS:
            shape = _shape(kind)
            cfg = get_config(arch).reduced()
            r = roofline_cell(arch, shape.name, mesh=mesh, cfg_override=cfg,
                              shape=shape, save=False)
            cell = build_cell(cfg, shape, mesh, TrainConfig(), grad_accum=1,
                              device="cpu")
            args = materialize_cell(cell, torch.Generator().manual_seed(1))
            with FlopCounterMode(display=False) as fc:
                cell.fn(*args)
            assert fc.get_total_flops() == int(r.flops_dev), kind
            ours[kind] = r.flops_dev
    finally:
        dist.destroy_process_group()
    part = next(i for i, archs in enumerate(PARTS) if arch in archs)
    want = json.loads((reference(part) / f"flops{part}.json").read_text())
    for kind, flops in ours.items():
        xla = want[f"{arch}/{kind}"]
        print(f"{arch} {kind}: port {flops:.6g} / XLA {xla:.6g} = "
              f"{flops / xla:.4f}")
        assert 0 < flops <= FLOPS_OVER_XLA * xla, (kind, flops, xla)


def test_every_attention_chunk_is_counted():
    """The chunked attend (keys > 2 x chunk) at two chunk sizes: the same
    FLOPs, as a loop whose body were counted once would not give."""
    mesh = _one_rank_mesh()
    try:
        counts = []
        for chunk in (16, 32):
            cfg = get_config("qwen2-0.5b").reduced(attn_chunk=chunk)
            r = roofline_cell("qwen2-0.5b", "t_prefill", mesh=mesh,
                              cfg_override=cfg, save=False,
                              shape=ShapeConfig("t_prefill", 256, 2,
                                                "prefill"))
            counts.append(r.flops_dev)
    finally:
        dist.destroy_process_group()
    assert counts[0] == counts[1] > 0


def test_dryrun_full_width_cell():
    """qwen2-0.5b x decode_32k at full width on the fake 16 x 16 group:
    ``ok``, its ``argument_bytes`` the sum of the local shards' bytes (read
    off the DTensors themselves); the group ends with the cell."""
    rec = dryrun.run_cell("qwen2-0.5b", "decode_32k", False, verbose=False,
                          save=False)
    assert not dist.is_initialized()
    assert rec["status"] == "ok"
    from repro_torch._tree import tree_flatten
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.mesh import fake_production_mesh
    with fake_production_mesh() as mesh:
        cell = build_cell(get_config("qwen2-0.5b"), SHAPES["decode_32k"],
                          mesh, TrainConfig(), device="meta")
        args = materialize_cell(cell, None)
        local = sum(t.to_local().numel() * t.element_size()
                    for t in tree_flatten(list(args[:3]))[0]) + 4   # index
    mem = rec["memory"]
    assert mem["argument_bytes"] == local
    assert mem["alias_bytes"] < mem["argument_bytes"] \
        <= mem["peak_estimate_bytes"]
    assert mem["fits_device"] is (mem["peak_estimate_bytes"] <= hw.HBM_BYTES)
    assert mem["fits_device"]
    assert rec["collectives"]["counts"] and rec["cost"]["flops"] > 0


def test_dryrun_deepseek_decode_cell_fits_the_card():
    """DeepSeek-V2-Lite x decode_32k at full width on the fake 16 x 16
    group: a rank holds 9.43 GiB of arguments (the sum of the local
    shards' bytes) and, with each rank reconstituting only its batch rows'
    and heads' K / V, a peak of at most 12 GiB."""
    rec = dryrun.run_cell("deepseek-v2-lite-16b", "decode_32k", False,
                          verbose=False, save=False)
    assert not dist.is_initialized()
    assert rec["status"] == "ok"
    from repro_torch._tree import tree_flatten
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.mesh import fake_production_mesh
    with fake_production_mesh() as mesh:
        cell = build_cell(get_config("deepseek-v2-lite-16b"),
                          SHAPES["decode_32k"], mesh, TrainConfig(),
                          device="meta")
        args = materialize_cell(cell, None)
        local = sum(t.to_local().numel() * t.element_size()
                    for t in tree_flatten(list(args[:3]))[0]) + 4   # index
    mem = rec["memory"]
    assert mem["argument_bytes"] == local
    assert round(local / 2 ** 30, 2) == 9.43
    assert mem["peak_estimate_bytes"] <= 12 * 2 ** 30
    assert mem["fits_device"]


def test_rank_mem_tracker_leaves_out_propagation_tensors():
    """Tensors made under a fake mode entered inside the tracker (as
    DTensor's sharding propagation makes the global shapes) are not a
    rank's: the peak counts the rank's own meta tensor only."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.trace import rank_mem_tracker
    tracker = rank_mem_tracker()
    with tracker:
        x = torch.empty(2 ** 20, dtype=torch.bfloat16, device="meta")
        with FakeTensorMode():
            torch.empty(2 ** 30, dtype=torch.bfloat16)
    peak = sum(d.get("Total", 0)
               for d in tracker.get_tracker_snapshot("peak").values())
    assert peak == x.numel() * x.element_size()


def test_dryrun_main_lists_cells_over_the_card(monkeypatch, capsys):
    """A traced cell whose peak exceeds ``hw.HBM_BYTES`` stays ``ok`` (the
    exit code is 0) and is listed after the summary line."""
    peaks = {"decode_32k": int(hw.HBM_BYTES) + 1, "prefill_32k": 1}

    def fake_run_cell(arch, shape, multi_pod):
        return {"arch": arch, "shape": shape, "mesh": "single",
                "status": "ok", "memory": {
                    "peak_estimate_bytes": peaks[shape],
                    "fits_device": peaks[shape] <= hw.HBM_BYTES}}

    monkeypatch.setattr(dryrun, "run_cell", fake_run_cell)
    for shape in peaks:
        monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "qwen1.5-4b",
                                          "--shape", shape,
                                          "--single-pod-only"])
        dryrun.main()
    out = capsys.readouterr().out.splitlines()
    assert out.count("dry-run summary: 1 ok, 0 skipped (documented), "
                     "0 failed") == 2
    over = [ln for ln in out if "over the card" in ln]
    assert over == ["dry-run summary: 1 of the ok cells over the card's 80 "
                    "GB: qwen1.5-4b × decode_32k × single (74.51 GiB)"]


def test_dryrun_skips_full_attention_long_context():
    rec = dryrun.run_cell("qwen3-32b", "long_500k", True, verbose=False,
                          save=False)
    from repro.configs.base import SHAPES as RSHAPES
    from repro.configs.registry import get_config as rget_config
    assert rec == {"arch": "qwen3-32b", "shape": "long_500k", "mesh": "multi",
                   "status": "skipped",
                   "reason": RSHAPES["long_500k"].applicable(
                       rget_config("qwen3-32b"))[1]}
    assert not dist.is_initialized()
