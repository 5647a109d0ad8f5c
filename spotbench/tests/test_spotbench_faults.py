"""The comparison has to fail: the bfloat16 control put in the program's
place, and a run whose timed path is broken underneath, on the CPU at the
cells' own size (the harness's look for a card skipped)."""
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from spotbench import harness, judge, spec  # noqa: E402

SEED = 2 ** 31 + 91
CELLS = ("aws6400.mixed8", "aws6400.bulk64")


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    """The program is correct, and the control, given its verdict by the
    same rule, is not."""
    r = harness.run_cell(spec.cell(name), SEED, 1.0, False, device="cpu",
                         control=True)
    assert r["correct"], r["checks"]
    assert r["control"]["correct"] is False, r["control"]
    limits = spec.cell(name).config["limits"]
    assert judge.verdict(r["attempted"], r["attempted"] - r["failed"],
                         r["control"]["checks"], limits) is False


def _half_batch(monkeypatch):
    """Half of each batch left out: its rows are the other half's."""
    from repro_torch.core import engine
    orig = engine.RecommendationEngine.batch_arrays

    def half(self, cands, batch, *, archive=None):
        out = orig(self, cands, batch, archive=archive)
        B = batch.batch_size
        h = (B + 1) // 2
        return tuple(np.concatenate([x[:h], x[:B - h]]) for x in out)
    monkeypatch.setattr(engine.RecommendationEngine, "batch_arrays", half)


def _altered_count(monkeypatch):
    """One node count altered where Algorithm 1 produces it."""
    from repro_torch.core import pool
    orig = pool.pool_scan

    def scan(*args, **kwargs):
        counts, k_stop, found = orig(*args, **kwargs)
        counts = counts.clone()
        counts[0, 0] += 1
        return counts, k_stop, found
    monkeypatch.setattr(pool, "pool_scan", scan)


def _altered_score(monkeypatch):
    """One request's score row altered where the scoring stage (B1 on the
    card, its plain version here) produces it."""
    from repro_torch.core import engine
    orig = engine._batched_scores

    def scored(*args, **kwargs):
        comb, avail, cost = orig(*args, **kwargs)
        comb = comb.clone()
        comb[0] *= 1.01
        return comb, avail, cost
    monkeypatch.setattr(engine, "_batched_scores", scored)


# every fault each cell can have: neither holds a state that steps, and
# there is no exchange between chips to leave out
@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in CELLS
    for fault in (_half_batch, _altered_count, _altered_score)])
def test_a_broken_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    r = harness.run_cell(spec.cell(name), SEED, 1.0, False, device="cpu")
    assert not r["correct"], r["checks"]
