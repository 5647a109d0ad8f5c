"""Nothing the benchmark runs imports JAX or the JAX package (``repro``),
compared by whole top-level module names; the reference and the yardstick
import nothing of the program; a run without a card or without the program
prints no result."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "spotbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
YARDSTICK = ("reference.py", "judge.py", "gen.py", "bounds.py")


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_the_yardstick_imports_nothing_of_the_program():
    for name in YARDSTICK:
        assert "repro_torch" not in _imports(BENCH / name), name


def test_whole_top_level_names():
    # the port's name begins with the JAX package's: it must not match
    sys.path.insert(0, str(ROOT))
    try:
        from spotbench import harness
    finally:
        sys.path.remove(str(ROOT))
    before = dict(sys.modules)
    try:
        sys.modules["repro_torch_probe"] = object()
        assert "repro_torch_probe" not in harness.forbidden_modules()
        sys.modules["repro.probe"] = object()
        assert "repro.probe" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(before)


def _run(cwd: Path, *args: str, env=None):
    return subprocess.run(
        [sys.executable, "spotbench/run.py", "--workload", "aws6400.mixed8",
         "--seed", "3000000001", "--seconds", "1", "--trace", "0", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_harness_loads_no_jax():
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "from spotbench import harness, judge, spec, tracing\n"
            "import repro_torch.serve\n"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(ROOT, env=env)
    assert out.returncode == 2
    assert out.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "spotbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert not lines or not lines[-1].startswith("{")
    json.loads((tmp_path / "BENCHMARK.json").read_text())
