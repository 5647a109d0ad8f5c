"""The port's spotlint: the fixture corpus pins each rule, the CLI keeps
the reference's contract, and the port's tree stays clean.

Every SPL rule of ``repro_torch.analysis`` has a deliberate-violation
fixture (exactly one finding, with the right rule id) and a clean twin
(zero findings) under ``tests/fixtures/spotlint_torch/``.  Beside the
reference's own contract (suppressions, the corpus skipped by the default
walk, the JSON schema and the exit codes 0 / 1 / 2), the port is held
against the reference: SPL003 gives the same findings on the same files,
the reference's walker skips the port's corpus, and importing the port's
linter loads neither torch nor jax.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import run_paths as ref_run_paths
from repro.analysis.framework import iter_python_files as ref_iter_files
from repro_torch.analysis import (DEFAULT_PATHS, check_file, check_source,
                                  main, run_paths)
from repro_torch.analysis.framework import (FIXTURE_FRAGMENT,
                                            JSON_SCHEMA_VERSION,
                                            iter_python_files)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "spotlint_torch"
REF_FIXTURES = ROOT / "tests" / "fixtures" / "spotlint"
PORT = ROOT / "src" / "repro_torch"
ALL_RULES = ("SPL001", "SPL002", "SPL003", "SPL004", "SPL005")


def _scan(path):
    findings, _ = run_paths([path], include_fixtures=True)
    return findings


# -- per-rule fixtures: one finding each, right id; clean twin is clean ----

@pytest.mark.parametrize("rule", ALL_RULES)
def test_positive_fixture_yields_exactly_one_finding(rule):
    findings = _scan(FIXTURES / f"{rule.lower()}_pos.py")
    assert len(findings) == 1, findings
    assert findings[0].rule == rule


@pytest.mark.parametrize("rule", ALL_RULES)
def test_negative_fixture_is_clean(rule):
    assert _scan(FIXTURES / f"{rule.lower()}_neg.py") == []


def test_ring_view_read_after_the_slot_write_is_spl001():
    # the ring's append with B3 moved after the slot write: the evicted
    # column's view is read once the slot holds the new one
    (f,) = _scan(FIXTURES / "spl001_pos.py")
    assert f.rule == "SPL001" and "`y_old`" in f.message
    assert "self._buf" in f.message and "clone" in f.message


def test_the_port_append_is_spl001_clean():
    # the real ``RollingDeviceArchive.append`` reads before it writes
    assert check_file(PORT / "stream" / "rolling.py") == []


@pytest.mark.parametrize("src,n", [
    ("def f(buf, x):\n    v = buf[:, 3]\n    buf[0] = x\n    return v\n", 1),
    ("def f(s, x):\n    v = s._buf[2]\n    s._buf.zero_()\n    return v\n", 1),
    ("def f(buf, x, i):\n    v = buf[i]\n    buf[i].copy_(x)\n    return v\n",
     1),
    ("def f(buf, x):\n    v = buf[1]\n    buf[1] += x\n    return v\n", 1),
    ("def f(buf, x):\n    v = buf[1].clone()\n    buf[1] = x\n    return v\n",
     0),
    ("def f(buf, i, x):\n    v = buf[i.long()]\n    buf[i] = x\n    return v\n",
     0),
    ("def f(buf, x):\n    v = buf[1]\n    buf[2] = x\n    return v\n", 0),
    ("def f(buf, x):\n    v = buf[1]\n    buf[1] = x\n    v = buf[1]\n"
     "    return v\n", 0),
])
def test_spl001_views_and_writes(src, n):
    findings = check_source(src, "fixtures/spotlint_torch/x.py")
    assert [f.rule for f in findings] == ["SPL001"] * n


def test_float64_host_column_is_spl002():
    (f,) = _scan(FIXTURES / "spl002_pos.py")
    assert f.rule == "SPL002" and "dtype" in f.message


@pytest.mark.parametrize("src,n", [
    ("torch.tensor([1.0])", 1), ("torch.as_tensor(x)", 1),
    ("torch.from_numpy(x).to(dev)", 1), ("x.astype(float)", 1),
    ("x.astype('float64')", 1),
    ("torch.tensor([1.0], dtype=torch.float32)", 0),
    ("torch.as_tensor(x, torch.float32)", 0),
    ("torch.as_tensor(x, device=d).bool()", 0),
    ("torch.from_numpy(x).to(dev, torch.float32)", 0),
    ("torch.from_numpy(x.astype(np.float32))", 0),
    ("torch.from_numpy(np.ascontiguousarray(x, dtype=np.int8))", 0),
    ("torch.as_tensor(x, dtype=torch.float64)", 0),
])
def test_spl002_pins(src, n):
    findings = check_source(f"y = {src}\n", "fixtures/spotlint_torch/x.py")
    assert [f.rule for f in findings] == ["SPL002"] * n


def test_unguarded_stats_write_is_spl003():
    (f,) = _scan(FIXTURES / "spl003_pos.py")
    assert f.rule == "SPL003" and "_stats_lock" in f.message


def test_unversioned_cursor_move_is_spl004():
    (f,) = _scan(FIXTURES / "spl004_pos.py")
    assert f.rule == "SPL004" and "self._pos" in f.message


@pytest.mark.parametrize("body,n", [
    ("    if t.any():\n        return t\n", 1),
    ("    for x in t:\n        pass\n", 1),
    ("    return t if t.sum() > 0 else -t\n", 1),
    ("    while (t > 0).all():\n        t = t - 1\n", 1),
    ("    return [x for x in range(3) if t[x]]\n", 1),
    ("    if t is None or t.shape[0] == 0 or t.dim() > 2:\n"
     "        return t\n", 0),
    ("    if t.device.type == 'cuda' and t.dtype == torch.float32:\n"
     "        return t\n", 0),
    ("    for i in range(len(t)):\n        pass\n", 0),
    ("    if isinstance(t, torch.Tensor) and t.numel():\n        return t\n",
     0),
])
def test_spl005_tensor_parameters(body, n):
    src = f"import torch\n\ndef f(t: torch.Tensor, k: int):\n{body}"
    findings = check_source(src, "fixtures/spotlint_torch/x.py")
    assert [f.rule for f in findings] == ["SPL005"] * n


def test_spl005_reads_only_tensor_annotated_parameters():
    src = "def f(t, k: int):\n    if t.any() or k:\n        return t\n"
    assert check_source(src, "fixtures/spotlint_torch/x.py") == []


# -- suppression comments --------------------------------------------------

def test_suppression_comment_silences_the_line():
    assert _scan(FIXTURES / "suppressed.py") == []


def test_stripping_the_suppression_restores_the_finding():
    src = (FIXTURES / "suppressed.py").read_text()
    stripped = src.replace("  # spotlint: disable=SPL002", "")
    assert stripped != src
    findings = check_source(stripped, "fixtures/spotlint_torch/suppressed.py")
    assert [f.rule for f in findings] == ["SPL002"]


def test_disable_all_silences_every_rule():
    src = (FIXTURES / "spl002_pos.py").read_text()
    silenced = src.replace("* 2.0", "* 2.0  # spotlint: disable=all")
    assert silenced != src
    assert check_source(silenced, "fixtures/spotlint_torch/x.py") == []


# -- corpus hygiene: the default walk never gates on fixtures --------------

def test_default_walk_skips_the_fixture_corpus():
    findings, n_files = run_paths([FIXTURES])
    assert findings == [] and n_files == 0


def test_port_corpus_path_holds_the_shared_fragment():
    assert FIXTURE_FRAGMENT == "fixtures/spotlint"
    assert FIXTURE_FRAGMENT in FIXTURES.as_posix()


def test_port_walker_skips_both_corpora():
    walked = {p.resolve() for p in iter_python_files([ROOT / "tests"])}
    corpora = set(FIXTURES.glob("*.py")) | set(REF_FIXTURES.glob("*.py"))
    assert corpora and not walked & {p.resolve() for p in corpora}


def test_reference_walker_skips_the_port_corpus():
    walked = {p.resolve() for p in ref_iter_files([ROOT / "tests"])}
    port = {p.resolve() for p in FIXTURES.glob("*.py")}
    assert len(port) == 11 and not walked & port


def test_directly_named_file_is_always_scanned():
    assert [f.rule for f in check_file(FIXTURES / "spl004_pos.py")] \
        == ["SPL004"]


# -- CLI: JSON schema and exit-code contract -------------------------------

def test_json_output_schema(capsys):
    rc = main(["--json", "--include-fixtures",
               str(FIXTURES / "spl002_pos.py")])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert doc["tool"] == "spotlint"
    assert doc["schema"] == JSON_SCHEMA_VERSION == 1
    assert doc["files_scanned"] == 1
    assert doc["counts"] == {"SPL002": 1}
    (finding,) = doc["findings"]
    assert set(finding) == {"path", "line", "col", "rule", "message"}
    assert finding["rule"] == "SPL002" and finding["line"] >= 1


def test_check_exit_codes(capsys):
    dirty = str(FIXTURES / "spl002_pos.py")
    clean = str(FIXTURES / "spl002_neg.py")
    assert main(["--check", "--include-fixtures", dirty]) == 1
    assert main(["--check", "--include-fixtures", clean]) == 0
    assert main([dirty, "--include-fixtures"]) == 0      # advisory mode
    assert main(["--rules", "SPL999", dirty]) == 2       # unknown rule
    assert main(["--check", "no/such/path.py"]) == 2
    capsys.readouterr()


def test_rule_subset_filter():
    findings, _ = run_paths([FIXTURES / "spl002_pos.py"],
                            only=["SPL001"], include_fixtures=True)
    assert findings == []
    findings, _ = run_paths([FIXTURES / "spl002_pos.py"],
                            only=["spl002"], include_fixtures=True)
    assert [f.rule for f in findings] == ["SPL002"]


def test_list_rules(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(rule in out for rule in ALL_RULES)


def test_port_tree_is_lint_clean():
    # the gate's exact invocation, default paths, from the repository root
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--check"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout
    assert DEFAULT_PATHS == ("src/repro_torch", "tests", "chip_smoke.py",
                             "chip_ab.py")


# -- held against the reference --------------------------------------------

def _spl003(run, paths):
    findings, _ = run(paths, only=["SPL003"], include_fixtures=True)
    return [(f.path, f.line, f.col, f.rule, f.message) for f in findings]


@pytest.mark.parametrize("paths", [
    [REF_FIXTURES / "spl003_pos.py"], [REF_FIXTURES / "spl003_neg.py"],
    [FIXTURES / "spl003_pos.py"], [FIXTURES / "spl003_neg.py"],
    [PORT / "serve", PORT / "stream", PORT / "operator"],
], ids=["ref-pos", "ref-neg", "port-pos", "port-neg", "port-modules"])
def test_spl003_equals_the_reference(paths):
    ours = _spl003(run_paths, paths)
    theirs = _spl003(ref_run_paths, paths)
    assert [f[:4] for f in ours] == [f[:4] for f in theirs]
    # the port's message drops the reference's history tag, nothing else
    assert [m.replace("(lock discipline)", "") for *_, m in ours] == \
        [m.replace("(PR 5 lock discipline)", "") for *_, m in theirs]


def test_spl003_on_an_edited_port_module_equals_the_reference():
    # a lock dropped from the port's own server: both rules see it alike
    src = (PORT / "serve" / "server.py").read_text()
    edited = src.replace("            with self._stats_lock:\n"
                         "                self.stats.record(chunk_len, bucket)",
                         "            self.stats.record(chunk_len, bucket)")
    assert edited != src
    from repro.analysis import check_source as ref_check_source
    from repro.analysis import resolve_rules as ref_resolve
    from repro_torch.analysis import resolve_rules
    ours = check_source(edited, "serve/server.py", resolve_rules(["SPL003"]))
    theirs = ref_check_source(edited, "serve/server.py",
                              ref_resolve(["SPL003"]))
    assert len(ours) == 1 and [(f.line, f.col) for f in ours] == \
        [(f.line, f.col) for f in theirs]


def test_import_loads_neither_torch_nor_jax():
    code = ("import sys\n"
            "import repro_torch.analysis, repro_torch.analysis.racecheck\n"
            "from repro_torch.analysis import resolve_rules\n"
            "resolve_rules()\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('torch', 'jax', 'jaxlib',\n"
            "                                    'repro', 'numpy'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
