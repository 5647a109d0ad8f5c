"""The port stands alone: no jax, no ``repro``, and no silent CPU fallback.

- importing every module of ``repro_torch`` in a fresh interpreter leaves
  no ``jax``/``jaxlib``/``repro`` module in ``sys.modules``;
- no source line of ``src/repro_torch`` or ``chip_smoke.py`` imports them;
- the default device is CUDA, and asking for it without CUDA raises in
  every entry point; kernels route CUDA tensors to the kernel, never to
  the plain version; a missing or failing nvcc raises.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import _device, convert
from repro_torch.configs.registry import get_config
from repro_torch.core.engine import RecommendationEngine
from repro_torch.core.types import CandidateSet
from repro_torch.data import make_pipeline
from repro_torch.launch import train as train_launcher
from repro_torch.kernels import _build
from repro_torch.models import get_model
from repro_torch.serve import ArchiveCache, BatchServer, DeviceArchive
from repro_torch.shard import ShardedArchive, ShardedRollingArchive

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

MODULES = ["repro_torch", "repro_torch.convert", "repro_torch._device",
           "repro_torch.core", "repro_torch.core.engine",
           "repro_torch.core.pool", "repro_torch.core.scoring",
           "repro_torch.core.config", "repro_torch.core.types",
           "repro_torch.kernels._build", "repro_torch.kernels.score_fuse",
           "repro_torch.kernels.pool_scan", "repro_torch.kernels.stats_update",
           "repro_torch.parallel.compression",
           "repro_torch.serve", "repro_torch.serve.archive",
           "repro_torch.serve.server", "repro_torch.serve.histogram",
           "repro_torch.stream", "repro_torch.stream.rolling",
           "repro_torch.stream.ingest", "repro_torch.stream.admission",
           "repro_torch.kernels.moe_gmm", "repro_torch.configs",
           "repro_torch.configs.registry", "repro_torch.models",
           "repro_torch.models.param", "repro_torch.models.layers",
           "repro_torch.models.attention", "repro_torch.models.moe",
           "repro_torch.models.lm", "repro_torch.models.api",
           "repro_torch.kernels.rwkv6_scan", "repro_torch.kernels.rglru_scan",
           "repro_torch.models.rwkv6", "repro_torch.models.rglru",
           "repro_torch.kernels.flash_attention", "repro_torch.train",
           "repro_torch.train.optim", "repro_torch.train.step",
           "repro_torch.data", "repro_torch.data.pipeline",
           "repro_torch.launch", "repro_torch.launch.train",
           "repro_torch.core.quantized", "repro_torch.shard",
           "repro_torch.shard.archive", "repro_torch.shard.compute",
           "repro_torch.core.tstp", "repro_torch.core.usqs",
           "repro_torch.core.entropy", "repro_torch.core.survival",
           "repro_torch.core.mstl", "repro_torch.core.baselines",
           "repro_torch.configs.spotvista", "repro_torch.cloudsim",
           "repro_torch.cloudsim.catalog", "repro_torch.cloudsim.market",
           "repro_torch.cloudsim.sps", "repro_torch.cloudsim.probes",
           "repro_torch.cloudsim.collector", "repro_torch.loadgen",
           "repro_torch.loadgen.arrivals", "repro_torch.loadgen.workload",
           "repro_torch.loadgen.harness"]

FORBIDDEN = re.compile(
    r"^\s*(import\s+jax|from\s+jax\b|from\s+repro(\.|\s+import\b)"
    r"|import\s+repro(\.|\s*$|\s*,|\s+as\b))", re.M)


def test_import_pulls_in_no_jax_and_no_reference():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("line,bad", [
    ("import jax", True), ("import jax.numpy as jnp", True),
    ("from jax import lax", True), ("from repro.core import scoring", True),
    ("from repro import core", True), ("import repro.core", True),
    ("import repro", True), ("from repro_torch.core import scoring", False),
    ("import repro_torch", False), ("from ..core import pool", False),
])
def test_forbidden_import_pattern(line, bad):
    assert bool(FORBIDDEN.search(line)) is bad


def test_sources_do_not_import_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}" for f in files
            for m in FORBIDDEN.finditer(f.read_text())]
    assert not hits, hits


def _tiny_candidates() -> CandidateSet:
    rng = np.random.default_rng(0)
    K = 4
    return CandidateSet(
        names=np.array([f"m5.x{i}" for i in range(K)]),
        regions=np.array(["us-east-1"] * K), azs=np.array(["a"] * K),
        families=np.array(["m5"] * K), categories=np.array(["general"] * K),
        vcpus=np.full(K, 4.0), memory_gb=np.full(K, 16.0),
        prices=rng.uniform(0.1, 1.0, K), t3=rng.uniform(0, 50, (K, 6)))


@pytest.mark.parametrize("make", [
    lambda: _device.resolve_device(),
    lambda: _device.resolve_device("cuda"),
    lambda: RecommendationEngine(),
    lambda: BatchServer(),
    lambda: ArchiveCache(),
    lambda: DeviceArchive.stage(_tiny_candidates()),
    lambda: get_model(get_config("deepseek-v2-lite-16b")),
    lambda: convert.params_from_jax({"w": np.zeros(2, np.float32)}),
    lambda: get_model(get_config("rwkv6-7b")),
    lambda: get_model(get_config("recurrentgemma-2b")),
    lambda: get_model(get_config("qwen2-0.5b")),
    lambda: make_pipeline(get_config("qwen2-0.5b"), 8, 1),
    lambda: convert.train_state_from_jax(
        ({"w": np.zeros(2, np.float32)},
         ({"w": np.zeros(2, np.float32)}, {"w": np.zeros(2, np.float32)},
          None, np.int32(0)))),
    lambda: train_launcher.main(["--arch", "qwen2-0.5b", "--reduced"]),
    lambda: DeviceArchive.stage(_tiny_candidates(), precision="int8"),
    lambda: ShardedArchive.stage(_tiny_candidates(), n_shards=2),
    lambda: ShardedRollingArchive(_tiny_candidates(), n_shards=2),
], ids=["resolve", "resolve-cuda", "engine", "server", "cache", "stage",
        "model", "params", "model-rwkv6", "model-recurrentgemma",
        "model-qwen2", "pipeline", "train-state", "launcher", "stage-int8",
        "stage-sharded", "rolling-sharded"])
def test_default_device_raises_without_cuda(make, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()


def test_cpu_is_only_taken_when_asked():
    assert _device.resolve_device("cpu") == torch.device("cpu")
    assert RecommendationEngine(device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        _device.resolve_device("meta")


def test_route_never_falls_back():
    assert _build.route(None, torch.device("cuda")) == "cuda"
    assert _build.route(None, torch.device("cpu")) == "torch"
    assert _build.route("torch", torch.device("cuda")) == "torch"
    with pytest.raises(ValueError, match="backend"):
        _build.route("triton", torch.device("cuda"))
    with pytest.raises(ValueError, match="no kernel"):
        _build.route(None, torch.device("meta"))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "TOOLKIT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library("pool_scan", {})


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "false")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc failed to build pool_scan.cu"):
        _build.build("pool_scan")
    assert not list(tmp_path.glob("*.so"))
