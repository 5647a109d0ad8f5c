"""The port's spotlint CLI: ``python -m repro_torch.analysis [--check]
[--json] paths...``.

Exit-code contract (the same as the reference's):

- ``0`` — scan completed; with ``--check``, additionally zero findings;
- ``1`` — ``--check`` and at least one finding;
- ``2`` — usage error (unknown rule id, missing path).

Without ``--check`` the findings are reported but the exit code stays 0 —
the advisory mode for local iteration.  ``--json`` emits one document on
stdout (schema pinned by ``tests/test_torch_spotlint.py``)::

    {"tool": "spotlint", "schema": 1, "checked_paths": [...],
     "files_scanned": N, "findings": [{path, line, col, rule, message}],
     "counts": {"SPL001": n, ...}}
"""
from __future__ import annotations

import argparse
import json
import sys

from .framework import JSON_SCHEMA_VERSION, resolve_rules, run_paths

#: what a bare invocation scans, relative to the repository root
DEFAULT_PATHS = ("src/repro_torch", "tests", "chip_smoke.py", "chip_ab.py")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="spotlint: project-invariant static analysis "
                    "(SPL001-SPL005)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories to scan (default: "
                         + " ".join(DEFAULT_PATHS) + ")")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 when any finding is reported (CI gate)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report on stdout")
    ap.add_argument("--rules", default=None, metavar="SPL001,SPL003",
                    help="comma-separated subset of rule ids (default: all)")
    ap.add_argument("--include-fixtures", action="store_true",
                    help="also scan the deliberate-violation corpus under "
                         "tests/fixtures/spotlint* (testing the linter)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rule in resolve_rules():
            print(f"{rule.rule_id}  {rule.title}\n    {rule.rationale}")
        return 0
    paths = args.paths or list(DEFAULT_PATHS)
    only = args.rules.split(",") if args.rules else None
    try:
        findings, n_files = run_paths(paths, only=only,
                                      include_fixtures=args.include_fixtures)
    except (KeyError, FileNotFoundError) as err:
        print(f"spotlint: error: {err}", file=sys.stderr)
        return 2
    counts: dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    if args.as_json:
        print(json.dumps({
            "tool": "spotlint", "schema": JSON_SCHEMA_VERSION,
            "checked_paths": [str(p) for p in paths],
            "files_scanned": n_files,
            "findings": [f.to_dict() for f in findings],
            "counts": counts,
        }, indent=2, sort_keys=True))
    else:
        for f in findings:
            print(f.format())
        summary = ", ".join(f"{k}: {v}" for k, v in sorted(counts.items()))
        print(f"spotlint: {len(findings)} finding(s) in {n_files} file(s) "
              f"scanned" + (f" ({summary})" if summary else ""))
    return 1 if (args.check and findings) else 0


if __name__ == "__main__":       # pragma: no cover
    sys.exit(main())
