"""The port's spotlint and race sanitizer.

Static half (``python -m repro_torch.analysis``): AST rules SPL001-SPL005
check the port's correctness invariants — see
:mod:`repro_torch.analysis.framework` and the rule modules under
:mod:`repro_torch.analysis.rules`.

Dynamic half (:mod:`repro_torch.analysis.racecheck`): an instrumented
:class:`~repro_torch.analysis.racecheck.LockRegistry` that wraps the
serving / ingest / operator locks, builds the lock-acquisition-order graph
(a cycle is a potential deadlock), and reports guarded-field writes
performed without the mapped lock held.

Importing this package loads neither torch nor jax: the linter runs where
torch or CUDA is broken, and it never imports the code it checks.
"""
from .framework import (Finding, Rule, check_file, check_source,  # noqa: F401
                        resolve_rules, run_paths)
from .cli import DEFAULT_PATHS, main  # noqa: F401
