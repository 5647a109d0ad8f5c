"""spotlint core for the port: rule registry, suppression, file walking,
reporting.

PyTorch counterpart of ``repro.analysis.framework``, the same machinery: an
AST-walking framework with

- a rule registry (:func:`register` / :data:`RULES`) of
  :class:`Rule` subclasses, each owning one ``SPLxxx`` id and a path scope;
- per-line, per-rule suppression via ``# spotlint: disable=SPL001`` (or
  ``disable=SPL001,SPL003``, or ``disable=all``) on the offending line;
- a runner (:func:`run_paths` / :func:`check_file`) producing
  :class:`Finding` records sorted by location, for either the human or the
  JSON reporter in :mod:`repro_torch.analysis.cli`.

Its rules encode the port's own invariants: reads of a ring-slot view
after the slot's in-place write (SPL001), float32 pins against float64
host inputs (SPL002), the lock-guarded stats contract (SPL003), the
version bump on archive mutation (SPL004) and host control flow on device
tensors (SPL005).

Rules never *import* the code under analysis — everything is derived from
the AST — so deliberately-broken fixture files are safe to scan, and the
analyzer runs where torch (or CUDA) is missing or broken.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Iterator

#: bumped when the JSON output shape changes (tests pin the schema)
JSON_SCHEMA_VERSION = 1

_RULE_ID_RE = re.compile(r"^SPL\d{3}$")
_DISABLE_RE = re.compile(r"#\s*spotlint:\s*disable=([A-Za-z0-9_,\s]+)")

#: directories the default walker skips entirely
SKIP_DIR_NAMES = frozenset({"__pycache__", ".git", ".mypy_cache",
                            ".pytest_cache", ".hypothesis"})
#: path fragment of the deliberate-violation corpora: excluded from normal
#: runs (the gate scans ``tests/`` and must stay clean), scanned only when a
#: caller passes ``include_fixtures=True`` or names a file directly.  The
#: same fragment as the reference's: it matches both ``fixtures/spotlint/``
#: and the port's ``fixtures/spotlint_torch/``, so either package's walker
#: skips both corpora.
FIXTURE_FRAGMENT = "fixtures/spotlint"


@dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at one source location."""

    path: str
    line: int
    col: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def to_dict(self) -> dict:
        return {"path": self.path, "line": self.line, "col": self.col,
                "rule": self.rule, "message": self.message}


class FileContext:
    """Everything a rule may look at for one file: source, AST, suppressions.

    ``path`` is the path as given (CI passes repo-relative paths, so
    findings print repo-relative).  The AST is parsed once and shared by
    every rule.
    """

    def __init__(self, path: str, source: str):
        self.path = path
        self.posix = Path(path).as_posix()
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self._suppressions = _parse_suppressions(source)

    def suppressed(self, line: int, rule: str) -> bool:
        rules = self._suppressions.get(line)
        return rules is not None and ("all" in rules or rule in rules)

    def finding(self, node: ast.AST, rule: "Rule", message: str) -> Finding:
        return Finding(path=self.path, line=node.lineno,
                       col=node.col_offset + 1, rule=rule.rule_id,
                       message=message)


def _parse_suppressions(source: str) -> dict[int, set[str]]:
    out: dict[int, set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _DISABLE_RE.search(line)
        if m is None:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        out[i] = {r if r == "all" else r.upper() for r in rules}
    return out


class Rule:
    """Base class: subclass, set the class attributes, ``@register``.

    ``scope`` is a tuple of posix path fragments; the rule only runs on
    files whose path contains one of them (``None`` = every scanned file).
    Files under the spotlint fixture corpus always match — that is how the
    fixture tests exercise a rule on a file outside its production scope.
    """

    rule_id: str = ""
    title: str = ""
    #: one line on the origin bug this rule encodes (the README table)
    rationale: str = ""
    scope: tuple[str, ...] | None = None

    def applies(self, posix_path: str) -> bool:
        if FIXTURE_FRAGMENT in posix_path:
            return True
        if self.scope is None:
            return True
        return any(frag in posix_path for frag in self.scope)

    def check(self, ctx: FileContext) -> Iterable[Finding]:  # pragma: no cover
        raise NotImplementedError


#: rule_id -> Rule instance, in registration order
RULES: dict[str, Rule] = {}


def register(cls: type[Rule]) -> type[Rule]:
    if not _RULE_ID_RE.match(cls.rule_id):
        raise ValueError(f"bad rule id {cls.rule_id!r} on {cls.__name__}")
    if cls.rule_id in RULES:
        raise ValueError(f"duplicate rule id {cls.rule_id}")
    RULES[cls.rule_id] = cls()
    return cls


def resolve_rules(only: Iterable[str] | None = None) -> list[Rule]:
    """The selected rules, default all, in SPLxxx order."""
    _ensure_loaded()
    if only is None:
        return [RULES[k] for k in sorted(RULES)]
    out = []
    for rid in only:
        rid = rid.strip().upper()
        if rid not in RULES:
            raise KeyError(f"unknown rule {rid!r} (have {sorted(RULES)})")
        out.append(RULES[rid])
    return out


def _ensure_loaded() -> None:
    # rule modules self-register on import; importing here (not at module
    # top) keeps framework <-> rules acyclic
    from . import rules  # noqa: F401


def check_source(source: str, path: str,
                 rules: Iterable[Rule] | None = None) -> list[Finding]:
    """Run the (scoped, unsuppressed) rules over one source string."""
    rules = resolve_rules() if rules is None else list(rules)
    try:
        ctx = FileContext(path, source)
    except SyntaxError as err:
        return [Finding(path=path, line=err.lineno or 1, col=1, rule="SPL000",
                        message=f"file does not parse: {err.msg}")]
    findings: list[Finding] = []
    for rule in rules:
        if not rule.applies(ctx.posix):
            continue
        for f in rule.check(ctx):
            if not ctx.suppressed(f.line, f.rule):
                findings.append(f)
    # compound statements are visited both as parents and as leaves, which
    # can report one violation twice — findings are value-identical, dedup
    return sorted(set(findings))


def check_file(path: str | Path,
               rules: Iterable[Rule] | None = None) -> list[Finding]:
    p = Path(path)
    return check_source(p.read_text(), str(path), rules)


def iter_python_files(paths: Iterable[str | Path], *,
                      include_fixtures: bool = False) -> Iterator[Path]:
    """Every ``.py`` under ``paths`` (files accepted verbatim), sorted.

    The fixture corpus (:data:`FIXTURE_FRAGMENT`) is skipped during
    directory walks unless ``include_fixtures`` — its files are deliberate
    violations; a directly-named file is always scanned.
    """
    seen: set[Path] = set()
    for root in paths:
        root = Path(root)
        if root.is_file():
            if root.suffix == ".py":
                seen.add(root)
            continue
        if not root.is_dir():
            raise FileNotFoundError(f"no such file or directory: {root}")
        for p in sorted(root.rglob("*.py")):
            if any(part in SKIP_DIR_NAMES for part in p.parts):
                continue
            if not include_fixtures and FIXTURE_FRAGMENT in p.as_posix():
                continue
            seen.add(p)
    return iter(sorted(seen))


def run_paths(paths: Iterable[str | Path], *,
              only: Iterable[str] | None = None,
              include_fixtures: bool = False) -> tuple[list[Finding], int]:
    """Scan ``paths``; returns ``(findings, files_scanned)``."""
    rules = resolve_rules(only)
    findings: list[Finding] = []
    n = 0
    for p in iter_python_files(paths, include_fixtures=include_fixtures):
        n += 1
        findings.extend(check_file(p, rules))
    return sorted(findings), n
