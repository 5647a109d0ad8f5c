"""USQS, TSTP and entropy in the port against ``repro.core``.

The port's ``core/tstp.py``, ``core/usqs.py`` and the numpy half of
``core/entropy.py`` are copies of the reference's, so they are held equal:
the same TSTP results and query counts, the same sampler sequences, the
same T3 estimates and scheduler plans over 300 cycles.  ``entropy_bits`` is
PyTorch in the port and jitted JAX in the reference; it is held within 1e-6
bits.  The properties of ``tests/test_usqs_tstp.py`` are mirrored on the
port, seeded (``derandomize=True``).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from repro.core import entropy as jentropy
from repro.core import tstp as jtstp
from repro.core import usqs as jusqs
from repro_torch.core import (T3Estimator, USQSSampler, empirical_entropy,
                              find_transition_points, full_scan, max_entropy,
                              run_usqs)
from repro_torch.core import entropy, tstp, usqs
from repro_torch.core.usqs import BudgetedProbeScheduler

ENTROPY_TOL = 1e-6


def staircase(t3, t2):
    """Monotone SPS(n): 3 for n<=t3, 2 for n<=t2, else 1."""
    def q(n):
        if n <= t3:
            return 3
        if n <= t2:
            return 2
        return 1
    return q


def drifting(seed, cycles):
    """A seeded staircase whose T3 / T2 walk over ``cycles`` cycles."""
    rng = np.random.default_rng(seed)
    t3 = np.clip(np.cumsum(rng.integers(-4, 5, cycles)) + 25, 0, 50)
    t2 = np.clip(t3 + rng.integers(0, 12, cycles), 0, 50)
    return t3, t2


# ---------------------------------------------------------------------------
# held against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("early_stop", [0, 2, 4])
def test_tstp_equals_reference_over_a_drifting_trace(early_stop):
    t3s, t2s = drifting(3, 300)
    cache = jcache = None
    for t3, t2 in zip(t3s, t2s):
        q = staircase(t3, t2)
        got = find_transition_points(q, 1, 50, cache=cache,
                                     early_stop=early_stop)
        want = jtstp.find_transition_points(q, 1, 50, cache=jcache,
                                            early_stop=early_stop)
        assert (got.t3, got.t2, got.queries) == (want.t3, want.t2,
                                                 want.queries)
        cache, jcache = got, want
        full = full_scan(q, 1, 50)
        jfull = jtstp.full_scan(q, 1, 50)
        assert (full.t3, full.t2, full.queries) == (jfull.t3, jfull.t2,
                                                    jfull.queries)
    assert isinstance(cache, tstp.TSTPResult)


def test_sampler_and_estimator_equal_reference_over_300_cycles():
    t3s, t2s = drifting(4, 300)
    s, js = USQSSampler(5, 50, 5), jusqs.USQSSampler(5, 50, 5)
    np.testing.assert_array_equal(s.grid, js.grid)
    est, jest = T3Estimator(s.grid), jusqs.T3Estimator(js.grid)
    for t, (t3, t2) in enumerate(zip(t3s, t2s)):
        tc, jtc = s.next_target(), js.next_target()
        assert tc == jtc
        sps = staircase(t3, t2)(tc)
        est.observe(tc, sps, t)
        jest.observe(jtc, sps, t)
        assert est.t3() == jest.t3()
        np.testing.assert_array_equal(est._last, jest._last)
        np.testing.assert_array_equal(est._stamp, jest._stamp)
    with pytest.raises(ValueError):
        est.observe(7, 3, 300)


def test_run_usqs_equals_reference():
    t3s, t2s = drifting(5, 300)
    state = {"t": 0}

    def q(n):
        t = min(state["t"] // 10, len(t3s) - 1)
        state["t"] += 1
        return staircase(t3s[t], t2s[t])(n)

    got = run_usqs(q, USQSSampler(5, 50, 5), cycles=300)
    state["t"] = 0
    want = jusqs.run_usqs(q, jusqs.USQSSampler(5, 50, 5), cycles=300)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("limits", [None, {"r0": 3, "r2": 1}])
def test_scheduler_plans_equal_reference_over_300_cycles(limits):
    keys = [f"r{k % 4}" for k in range(37)]
    got = BudgetedProbeScheduler(keys, 7, limits)
    want = jusqs.BudgetedProbeScheduler(keys, 7, limits)
    for cycle in range(300):
        assert got.plan(cycle) == want.plan(cycle)
        np.testing.assert_array_equal(got.staleness(cycle),
                                      want.staleness(cycle))
    assert got.queries_issued == want.queries_issued
    with pytest.raises(ValueError):
        BudgetedProbeScheduler(keys, 0)


@pytest.mark.parametrize("counts", [
    [0, 0, 0], [5], [1, 1, 1, 1], [0, 3, 0, 9, 1],
    list(range(11)), [2 ** 20, 1, 0, 7],
])
def test_entropy_bits_matches_jitted_reference(counts):
    got = entropy.entropy_bits(torch.tensor(counts))
    want = float(jentropy.entropy_bits(jnp.asarray(counts)))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert abs(float(got) - want) <= ENTROPY_TOL


def test_entropy_bits_on_seeded_histograms():
    rng = np.random.default_rng(6)
    for _ in range(20):
        counts = rng.integers(0, 1000, 11) * (rng.random(11) < 0.7)
        got = float(entropy.entropy_bits(torch.as_tensor(counts)))
        want = float(jentropy.entropy_bits(jnp.asarray(counts)))
        assert abs(got - want) <= ENTROPY_TOL
        samples = np.repeat(np.arange(11), counts)
        if samples.size:
            assert (empirical_entropy(samples)
                    == jentropy.empirical_entropy(samples))
            assert abs(got - empirical_entropy(samples)) <= ENTROPY_TOL
    assert max_entropy(11) == jentropy.max_entropy(11)


# ---------------------------------------------------------------------------
# the reference's properties, on the port
# ---------------------------------------------------------------------------

@settings(max_examples=100, deadline=None, derandomize=True)
@given(st.integers(0, 50), st.integers(0, 50))
def test_tstp_exact(t3, t2):
    t2 = max(t2, t3)
    res = find_transition_points(staircase(t3, t2), 1, 50)
    assert res.t3 == t3
    assert res.t2 == t2
    assert res.queries <= 14


@settings(max_examples=60, deadline=None, derandomize=True)
@given(st.integers(0, 50), st.integers(0, 5), st.integers(0, 6))
def test_tstp_early_stop_error_bounded(t3, drift, e):
    prev = max(t3 - drift, 0)
    cache = find_transition_points(staircase(prev, prev), 1, 50)
    res = find_transition_points(staircase(t3, t3), 1, 50, cache=cache,
                                 early_stop=e)
    assert abs(res.t3 - t3) <= max(e, 0)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(st.integers(0, 50), st.integers(0, 4))
def test_tstp_cache_reduces_queries(t3, drift):
    q = staircase(t3, t3)
    cold = find_transition_points(q, 1, 50)
    hi = min(t3 + drift, 50)
    warm = find_transition_points(
        q, 1, 50, cache=find_transition_points(staircase(hi, hi), 1, 50))
    assert warm.t3 == t3
    if drift == 0:
        assert warm.queries <= cold.queries


def test_usqs_sampler_cycles():
    s = usqs.USQSSampler(5, 50, 5)
    targets = list(s.targets(22))
    assert targets[:10] == [5, 10, 15, 20, 25, 30, 35, 40, 45, 50]
    assert targets[10] == 5
    assert s.cycle_length == 10


def test_usqs_estimator_static_and_tracks_change():
    t3s, _, n = run_usqs(staircase(23, 30), USQSSampler(5, 50, 5), cycles=10)
    assert t3s[-1] == 20 and n == 10
    state = {"t3": 40}

    def q(n):
        return 3 if n <= state["t3"] else 1
    sampler = USQSSampler(5, 50, 5)
    est = T3Estimator(sampler.grid)
    for t in range(10):
        tc = sampler.next_target()
        est.observe(tc, q(tc), t)
    assert est.t3() == 40
    state["t3"] = 10
    for t in range(10, 20):
        tc = sampler.next_target()
        est.observe(tc, q(tc), t)
    assert est.t3() == 10


def test_scheduler_staleness_bounded_by_budget():
    sched = BudgetedProbeScheduler([f"r{k % 3}" for k in range(50)], 7)
    for cycle in range(40):
        assert len(sched.plan(cycle)) == 7
    # every target is planned at least once every ceil(50 / 7) cycles
    assert sched.staleness(40).max() <= -(-50 // 7)


def test_entropy_bounds():
    assert empirical_entropy([1, 1, 1, 1]) == 0.0
    assert empirical_entropy(list(range(11))) == pytest.approx(max_entropy(11))
    skewed = [0] * 30 + [50] * 40 + list(range(5, 50, 5)) * 3
    assert empirical_entropy(skewed) < max_entropy(11)
    assert float(entropy.entropy_bits(torch.zeros(4))) == 0.0
