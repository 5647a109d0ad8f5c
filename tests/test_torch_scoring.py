"""Port scoring (``repro_torch.core.scoring``) against the JAX reference.

Tolerances, and why:

- Eq. 3 statistics are computed independently by each package (other
  summation orders).  They agree within ``STAT_RTOL = 1e-5`` of each
  statistic's range across candidates (measured: <= 1e-6 at K = 48, and
  2.6e-6 at K = 32768, T = 1008).
- Masked Eq. 3 rows from the *same* statistics: RTOL 1e-5 / ATOL 1e-4, the
  reference's own budget (``tests/_score_helpers.py``); from each package's
  own statistics the MinMax step amplifies the statistic error, so the
  end-to-end rows get ``E2E_ATOL = 5e-4`` (measured <= 1.2e-4 at K = 48).
- Masked Eq. 2 rows: exact (a masked min, a ceil of an exact quotient, one
  multiply and one divide — the same single-rounded ops in both).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import scoring as jsc
from repro_torch.core import scoring as tsc

from _score_helpers import ATOL, KW, RTOL, instance

STAT_RTOL = 1e-5
E2E_ATOL = 5e-4


def _mask(seed, k=KW):
    rng = np.random.default_rng(seed)
    mask = rng.random(k) < 0.7
    mask[rng.integers(0, k)] = True
    return mask


@pytest.mark.parametrize("seed,T", [(0, 24), (1, 1), (2, 2), (3, 168)])
def test_candidate_stats_match_jax(seed, T):
    t3 = instance(seed, T=T, const_rows=3, dup_rows=2)[0]
    ref = jsc.candidate_stats(jnp.asarray(t3))
    got = tsc.candidate_stats(t3)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert g.dtype == torch.float32
        span = max(float(r.max() - r.min()), 1e-30)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=STAT_RTOL * span)
    if T == 1:      # slope convention: 0, not 0/0
        np.testing.assert_array_equal(got.slope.numpy(), np.zeros(KW))


def test_candidate_stats_pin_float32():
    t3 = instance(4)[0]
    from64 = tsc.candidate_stats(torch.as_tensor(t3, dtype=torch.float64))
    from32 = tsc.candidate_stats(torch.as_tensor(t3, dtype=torch.float32))
    for a, b in zip(from64, from32):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("seed", range(4))
def test_masked_availability_same_stats_matches_jax(seed):
    t3 = instance(seed)[0]
    mask = _mask(seed)
    stats = [np.asarray(x) for x in jsc.candidate_stats(jnp.asarray(t3))]
    lam = 0.05 + 0.1 * seed
    got = tsc.masked_availability(tsc.CandidateStats(
        *(torch.tensor(x) for x in stats)), lam, torch.as_tensor(mask))
    # the reference's availability_scores_masked, after its stats pass
    a3, sl, sg = (jsc._masked_minmax(jnp.asarray(x), jnp.asarray(mask))
                  for x in stats)
    ref = np.asarray(jnp.clip(100.0 * a3 * (1.0 + lam * (sl - sg)), 0.0, None))
    np.testing.assert_allclose(got.numpy()[mask], ref[mask], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("seed", range(4))
def test_masked_rows_end_to_end_match_jax(seed):
    t3, prices, vcpus, mems = instance(seed, const_rows=seed)
    mask = _mask(seed)
    ref = np.asarray(jsc.availability_scores_masked(
        jnp.asarray(t3, jnp.float32), 0.1, jnp.asarray(mask)))
    got = tsc.availability_scores_masked(t3, 0.1, torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy()[mask], ref[mask], rtol=RTOL,
                               atol=E2E_ATOL)
    for caps, req in ((vcpus, 129.25), (mems, 640.0)):
        ref_c = np.asarray(jsc.cost_scores_masked(
            prices, caps, jnp.float32(req), jnp.asarray(mask)))
        got_c = tsc.cost_scores_masked(prices, caps, req,
                                       torch.as_tensor(mask))
        np.testing.assert_array_equal(got_c.numpy()[mask], ref_c[mask])


def test_masked_rows_batch_axis_equals_rows():
    """A (B, K) mask batch gives each row's single-mask result bit for bit."""
    t3, prices, vcpus, _ = instance(7)
    masks = np.stack([_mask(s) for s in range(4)])
    lams = torch.tensor([[0.1], [0.2], [0.05], [0.3]])
    req = torch.tensor([[64.0], [100.0], [7.0], [1000.0]])
    batched = tsc.availability_scores_masked(t3, lams, torch.as_tensor(masks))
    cost = tsc.cost_scores_masked(prices, vcpus, req, torch.as_tensor(masks))
    for b in range(4):
        one = tsc.availability_scores_masked(t3, float(lams[b]),
                                             torch.as_tensor(masks[b]))
        assert torch.equal(batched[b], one)
        one_c = tsc.cost_scores_masked(prices, vcpus, float(req[b]),
                                       torch.as_tensor(masks[b]))
        assert torch.equal(cost[b], one_c)


@pytest.mark.parametrize("seed", range(3))
def test_unmasked_scores_match_jax(seed):
    t3, prices, vcpus, _ = instance(seed)
    a_ref = np.asarray(jsc.availability_scores(jnp.asarray(t3), 0.2))
    a_got = tsc.availability_scores(t3, 0.2)
    np.testing.assert_allclose(a_got.numpy(), a_ref, rtol=RTOL, atol=E2E_ATOL)
    c_ref = np.asarray(jsc.cost_scores(prices, vcpus, 96.0))
    c_got = tsc.cost_scores(prices, vcpus, 96.0)
    np.testing.assert_array_equal(c_got.numpy(), c_ref)
    comb = tsc.combined_scores(a_got, c_got, 0.3)
    np.testing.assert_allclose(
        comb.numpy(), np.asarray(jsc.combined_scores(a_ref, c_ref, 0.3)),
        rtol=RTOL, atol=E2E_ATOL)
    comp = tsc.availability_scores(t3, 0.2, return_components=True)
    assert torch.equal(comp.score, a_got)


def test_exact_multiple_divides_exactly():
    """``python float / tensor`` would take a reciprocal and flip the ceil
    at exact multiples; the port lifts the scalar to a tensor."""
    cpus = np.array([3.0, 7.0, 10.0, 49.0, 96.0])
    req = 3.0 * 7.0 * 10.0 * 49.0
    got = tsc.pool_costs(np.ones(5), cpus, req).numpy()
    np.testing.assert_array_equal(got, np.ceil(np.float32(req) / cpus.astype(np.float32)))
    np.testing.assert_array_equal(
        got, np.asarray(jsc.pool_costs(np.ones(5), cpus, req)))


def test_numpy_oracles_are_the_reference():
    t3, prices, vcpus, _ = instance(11)
    np.testing.assert_array_equal(tsc.availability_scores_ref(t3, 0.1),
                                  jsc.availability_scores_ref(t3, 0.1))
    np.testing.assert_array_equal(tsc.cost_scores_ref(prices, vcpus, 50.0),
                                  jsc.cost_scores_ref(prices, vcpus, 50.0))
    np.testing.assert_allclose(tsc.cost_scores(prices, vcpus, 50.0).numpy(),
                               jsc.cost_scores_ref(prices, vcpus, 50.0),
                               rtol=1e-6)


def test_resolve_score_impl():
    assert tsc.resolve_score_impl("dense", 10 ** 6) == "dense"
    assert tsc.resolve_score_impl("tiled", 2) == "tiled"
    auto_k = tsc.SCORE_TILED_AUTO_K
    assert auto_k == jsc.SCORE_TILED_AUTO_K
    assert tsc.resolve_score_impl("auto", auto_k - 1) == "dense"
    assert tsc.resolve_score_impl("auto", auto_k) == "tiled"
    with pytest.raises(ValueError, match="score_impl"):
        tsc.resolve_score_impl("sparse", 8)
