"""Survival, MSTL and Bai-Perron in the port against ``repro.core``.

``core/survival.py`` and ``core/mstl.py`` are numpy copies of the
reference's, so on seeded data their outputs are held equal bit for bit:
Kaplan-Meier curves, the Cox fit (beta, SE, CI, p), MSTL components,
seasonal strength and Bai-Perron breaks.  The properties of
``tests/test_survival_mstl.py`` are mirrored on the port.
"""
from dataclasses import asdict

import numpy as np
import pytest

from repro.core import mstl as jmstl
from repro.core import survival as jsurv
from repro_torch.core import (bai_perron, cox_ph, kaplan_meier,
                              mstl_decompose, seasonal_strength)
from repro_torch.core.survival import fit_survival_model


def lifetimes(seed, n=400, beta=-0.01):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 100, n)
    lam = 0.05 * np.exp(beta * (x - x.mean()))
    dur = np.round(rng.exponential(1.0 / lam), 1)     # rounded: ties occur
    cens = rng.exponential(60.0, n)
    return x, np.minimum(dur, cens), dur <= cens


def seasonal_series(seed, days=28, noise=0.5):
    t = np.arange(24 * days)
    rng = np.random.default_rng(seed)
    return (50 + 10 * np.sin(2 * np.pi * t / 24)
            + 2 * np.sin(2 * np.pi * t / 168) + rng.normal(0, noise, len(t)))


# ---------------------------------------------------------------------------
# held against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kaplan_meier_and_cox_equal_reference(seed):
    x, d, e = lifetimes(seed)
    km, jkm = kaplan_meier(d, e), jsurv.kaplan_meier(d, e)
    np.testing.assert_array_equal(km.times, jkm.times)
    np.testing.assert_array_equal(km.survival, jkm.survival)
    assert km.median() == jkm.median()
    for t in (0.0, 5.0, 17.3, 1e4):
        assert km.at(t) == jkm.at(t)
    cox, jcox = cox_ph(x, d, e), jsurv.cox_ph(x, d, e)
    assert asdict(cox) == asdict(jcox)      # every field, bit for bit
    model = fit_survival_model(x, d, e)
    jmodel = jsurv.fit_survival_model(x, d, e)
    assert model.n_events == jmodel.n_events and model.x_mean == jmodel.x_mean
    np.testing.assert_array_equal(model.survival(30.0, x[:20]),
                                  jmodel.survival(30.0, x[:20]))


def test_degenerate_lifetimes_equal_reference():
    d, e = np.array([5.0, 6.0, 7.0]), np.zeros(3, bool)
    x = np.array([1.0, 2.0, 3.0])
    assert asdict(cox_ph(x, d, e)) == asdict(jsurv.cox_ph(x, d, e))
    model = fit_survival_model(x, d, e)
    assert model.n_events == 0 and model.km.at(100.0) == 1.0


@pytest.mark.parametrize("seed,periods", [(1, (24, 168)), (2, (24,)),
                                          (3, (12, 24, 168))])
def test_mstl_equals_reference(seed, periods):
    y = seasonal_series(seed)
    got = mstl_decompose(y, periods=periods)
    want = jmstl.mstl_decompose(y, periods=periods)
    np.testing.assert_array_equal(got.trend, want.trend)
    np.testing.assert_array_equal(got.residual, want.residual)
    assert got.seasonal.keys() == want.seasonal.keys()
    for p in got.seasonal:
        np.testing.assert_array_equal(got.seasonal[p], want.seasonal[p])
        assert (seasonal_strength(got.seasonal[p], got.residual)
                == jmstl.seasonal_strength(want.seasonal[p], want.residual))
    assert got.variance_decomposition() == want.variance_decomposition()


@pytest.mark.parametrize("seed,levels", [(3, (10.0, 14.0)), (4, (10.0,)),
                                         (5, (8.0, 12.0, 9.0, 15.0))])
def test_bai_perron_equals_reference(seed, levels):
    y = np.concatenate([np.full(15, v) for v in levels])
    y += np.random.default_rng(seed).normal(0, 0.3, len(y))
    for max_breaks in (1, 3, 5):
        assert (asdict(bai_perron(y, max_breaks=max_breaks))
                == asdict(jmstl.bai_perron(y, max_breaks=max_breaks)))
    assert asdict(bai_perron(y[:4])) == asdict(jmstl.bai_perron(y[:4]))


# ---------------------------------------------------------------------------
# the reference's properties, on the port
# ---------------------------------------------------------------------------

def test_km_no_censoring_matches_empirical():
    km = kaplan_meier(np.array([1, 2, 3, 4, 5.0]), np.ones(5, bool))
    np.testing.assert_allclose(km.survival, [0.8, 0.6, 0.4, 0.2, 0.0])
    assert km.median() == 3.0


def test_km_censoring():
    km = kaplan_meier(np.array([1.0, 2.0, 2.0, 3.0]), np.array([1, 0, 1, 1]))
    assert km.at(1.0) == pytest.approx(0.75)
    assert km.at(2.0) == pytest.approx(0.5)


def test_cox_recovers_negative_beta():
    rng = np.random.default_rng(0)
    n = 600
    x = rng.uniform(0, 100, n)
    true_beta = -0.01
    lam = 0.05 * np.exp(true_beta * (x - x.mean()))
    dur = rng.exponential(1.0 / lam)
    cens = rng.exponential(60.0, n)
    res = cox_ph(x, np.minimum(dur, cens), dur <= cens)
    assert res.converged
    assert res.hazard_ratio < 1.0
    assert res.beta == pytest.approx(true_beta, abs=0.004)
    assert res.ci_low < np.exp(true_beta) < res.ci_high
    assert res.p_value < 0.05


def test_mstl_recovers_daily_cycle_and_weak_noise():
    res = mstl_decompose(seasonal_series(1), periods=(24, 168))
    var = res.variance_decomposition()
    assert var["seasonal_24"] > var["seasonal_168"] > var["residual"]
    assert seasonal_strength(res.seasonal[24], res.residual) > 0.9
    noise = np.random.default_rng(2).normal(0, 1, 24 * 14)
    res = mstl_decompose(noise, periods=(24,))
    assert seasonal_strength(res.seasonal[24], res.residual) < 0.5


def test_bai_perron_finds_break_and_none_on_stable():
    y = np.concatenate([np.full(20, 10.0), np.full(20, 14.0)])
    y += np.random.default_rng(3).normal(0, 0.3, 40)
    res = bai_perron(y, max_breaks=3)
    assert res.n_breaks == 1 and abs(res.breakpoints[0] - 20) <= 2
    assert res.max_variation > 0.1
    y = np.full(40, 10.0) + np.random.default_rng(4).normal(0, 0.2, 40)
    res = bai_perron(y, max_breaks=3)
    assert res.n_breaks == 0 and res.max_variation < 0.05
