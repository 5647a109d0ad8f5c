"""Port Algorithm 1 scans (``repro_torch.core.pool`` / ``kernels.pool_scan``,
plain versions) against the JAX reference and the loop oracle.

Contract:

- inside the port, the dense and the O(K) scans are bit-identical (one
  shared prefix-sum call);
- the port's prefix sums agree with ``jnp.cumsum``'s within 4 float32 ulps
  (``CSC_ULPS``) of the largest partial sum — the two sum in other orders
  (fault F1 in ROADMAP.md), so they are not bit-equal;
- pools (counts row, k_stop, any_term) equal the reference's dense scan and
  its Pallas kernel in interpret mode, except where the decision-margin
  replay (``prefix_sum_tie``) puts a ``ceil`` operand within the two prefix
  sums' disagreement of an integer: such ties are counted, and must stay
  rare, never passed silently.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import pool as jpool
from repro.kernels import pool_scan as jps
from repro_torch.core import pool as tpool
from repro_torch.kernels import pool_scan as tps

from _pool_helpers import (KW, TILE, adversarial_instance, masked_pool,
                           random_mask)

CSC_ULPS = 4

# one compile each: every adversarial case has the full width KW
_ref_dense = jax.jit(jpool._prefix_allocations)
_ref_pallas = jax.jit(functools.partial(jps._pool_scan_pallas, tile=TILE,
                                        interpret=True))


def _sorted_case(seed, n_dup, zero_tail, neg_tail, n_valid):
    scores, cpus = adversarial_instance(seed, n_dup, zero_tail, neg_tail)
    mask = random_mask(seed, n_valid)
    _, s, c = tpool._sort_masked(torch.tensor(scores, dtype=torch.float32),
                                 torch.tensor(cpus, dtype=torch.float32),
                                 torch.as_tensor(mask))
    req = float(np.random.default_rng(seed).integers(16, 4000)) / 4
    return s, c, req


CASES = [(seed, n_dup, zero, neg, n_valid)
         for seed, (n_dup, zero, neg, n_valid) in enumerate(
             [(0, 0, 0, KW), (6, 0, 0, KW), (3, 8, 0, KW), (2, 0, 6, KW),
              (4, 5, 5, 40), (0, 0, 0, 1), (8, 3, 0, 20), (1, 0, 0, 2),
              (0, 12, 0, 30), (5, 0, 0, 33)])]


def _compare(got, ref, s, c, req, csc_t, csc_j):
    """``True`` if equal; a flagged tie returns ``False``; else fail."""
    same = (np.array_equal(got[0], ref[0]) and int(got[1]) == int(ref[1])
            and bool(got[2]) == bool(ref[2]))
    if same:
        return True
    tie, margin, budget = tpool.prefix_sum_tie(
        s, c, req, csc_t, csc_j,
        [(int(got[1]), bool(got[2])), (int(ref[1]), bool(ref[2]))])
    assert tie, f"pools differ with margin {margin} > budget {budget}"
    return False


def test_scans_match_jax_on_adversarial_instances():
    ties = 0
    for case in CASES:
        s, c, req = _sorted_case(*case)
        sj, cj = jnp.asarray(s.numpy()), jnp.asarray(c.numpy())
        csc_j = np.asarray(jps._clamped_prefix_sums(sj))
        csc_t = tps._clamped_prefix_sums(s).numpy()
        scale = np.abs(csc_j).max()
        np.testing.assert_allclose(csc_t, csc_j, rtol=0,
                                   atol=CSC_ULPS * np.spacing(np.float32(scale)))
        dense = [x.numpy() for x in tpool._prefix_allocations(s, c, req)]
        tiled = [x.numpy() for x in tpool._prefix_allocations(s, c, req,
                                                              impl="tiled")]
        for a, b in zip(dense, tiled):
            np.testing.assert_array_equal(a, b)
        ref_dense = jax.device_get(_ref_dense(sj, cj, jnp.float32(req)))
        ref_pallas = jax.device_get(_ref_pallas(sj, cj, jnp.float32(req)))
        for ref in (ref_dense, ref_pallas):
            ties += not _compare(dense, ref, s.numpy(), c.numpy(), req,
                                 csc_t, csc_j)
    print(f"{ties} F1 ties in {2 * len(CASES)} comparisons")
    assert ties <= 2, f"{ties} F1 ties in {2 * len(CASES)} comparisons"


@pytest.mark.parametrize("seed", range(3))
def test_masked_pools_match_jax(seed):
    B = 6
    rng = np.random.default_rng(seed)
    S = rng.uniform(0.0, 50.0, (B, KW)).astype(np.float32)
    C = rng.choice([2, 4, 8, 16], (B, KW)).astype(np.float32)
    R = rng.uniform(50, 500, B).astype(np.float32)
    M = rng.random((B, KW)) < 0.7
    M[0] = False                                      # an all-masked row
    for impl in ("dense", "tiled"):
        order, counts, k_stop, any_term = tpool.greedy_pool_masked(
            torch.tensor(S), torch.tensor(C), torch.tensor(R),
            torch.as_tensor(M), impl=impl)
        for b in range(B):
            ref = jax.device_get(masked_pool(S[b], C[b], R[b], M[b],
                                             impl="dense"))
            np.testing.assert_array_equal(order[b].numpy(), ref[0])
            _, s, c = tpool._sort_masked(torch.tensor(S[b]), torch.tensor(C[b]),
                                         torch.as_tensor(M[b]))
            _compare([counts[b].numpy(), k_stop[b], any_term[b]], ref[1:],
                     s.numpy(), c.numpy(), float(R[b]),
                     tps._clamped_prefix_sums(s).numpy(),
                     np.asarray(jps._clamped_prefix_sums(jnp.asarray(s.numpy()))))


EXACT = [  # ceil operands exactly on integers: R a multiple of every c
    (np.full(4, 10.0), np.full(4, 4.0), 64.0),
    (np.array([30.0, 20.0, 10.0]), np.array([4.0, 8.0, 16.0]), 64.0),
    (np.array([8.0, 8.0, 4.0, 4.0, 2.0]), np.array([2.0, 4.0, 2.0, 8.0, 1.0]), 96.0),
    (np.array([5.0, 5.0, 5.0, 5.0, 0.0]), np.array([1.0, 2.0, 5.0, 10.0, 3.0]), 20.0),
    (np.array([1.0]), np.array([3.0]), 9.0),
]


@pytest.mark.parametrize("scores,cpus,req", EXACT)
def test_exact_multiples_match_reference_and_oracle(scores, cpus, req):
    oracle = tpool.greedy_pool(scores, cpus, req)
    ref_oracle = jpool.greedy_pool(scores, cpus, req)
    np.testing.assert_array_equal(oracle.indices, ref_oracle.indices)
    np.testing.assert_array_equal(oracle.counts, ref_oracle.counts)
    ref = jpool.greedy_pool_vectorized(scores, cpus, req, impl="dense")
    for impl in ("dense", "tiled"):
        got = tpool.greedy_pool_vectorized(scores, cpus, req, impl=impl,
                                           device="cpu")
        np.testing.assert_array_equal(got.indices, ref.indices)
        np.testing.assert_array_equal(got.counts, ref.counts)
        np.testing.assert_array_equal(got.counts, oracle.counts)
        assert got.iterations == ref.iterations


# F5 (ROADMAP C): when Algorithm 1 stops at k = 1 the reference takes the
# row ceil(s0 * R / (s0 * c0)) in float32, which lands one ulp above the
# integer R / c0 on these single-member draws, so the pool holds R / c0 + 1
# nodes where the float64 oracle ``greedy_pool`` holds R / c0.  The values
# (float32 s0, node size c0, R a multiple of c0) come from a seeded numpy
# search (s0 uniform in (0.1, 100), c0 from the adversarial sizes, R = m c0
# with m < 400): 1421 of its 20000 draws over-count.  The port keeps the
# reference's behaviour in both lanes.
F5_OVERCOUNT = [
    (70.24089050292969, 4.0, 60.0),
    (99.4547348022461, 2.0, 392.0),
    (63.23168182373047, 48.0, 1440.0),
    (69.3587417602539, 32.0, 992.0),
]


@pytest.mark.parametrize("s0,c0,req", F5_OVERCOUNT)
def test_single_type_pool_overcounts_as_the_reference_does(s0, c0, req):
    exact = int(req // c0)
    assert req == exact * c0 and np.float32(s0) == s0
    for oracle in (tpool.greedy_pool([s0], [c0], req),
                   jpool.greedy_pool([s0], [c0], req)):
        assert list(oracle.counts) == [exact]
    ref = jpool.greedy_pool_vectorized(np.array([s0]), np.array([c0]), req,
                                       impl="dense")
    assert list(ref.counts) == [exact + 1]
    for impl in ("dense", "tiled"):
        got = tpool.greedy_pool_vectorized(np.array([s0]), np.array([c0]), req,
                                           impl=impl, device="cpu")
        assert list(got.counts) == [exact + 1], impl
    # the masked lanes the engine runs: the member among masked-out others
    S = np.random.default_rng(5).uniform(0.1, 100.0, KW).astype(np.float32)
    C = np.full(KW, 8.0, np.float32)
    M = np.zeros(KW, bool)
    S[7], C[7], M[7] = s0, c0, True
    want = jax.device_get(masked_pool(S, C, np.float32(req), M, impl="tiled",
                                      tile=TILE))
    assert int(want[1].max()) == exact + 1
    for impl in ("dense", "tiled"):
        order, counts, k_stop, any_term = tpool.greedy_pool_masked(
            torch.tensor(S), torch.tensor(C), torch.tensor(np.float32(req)),
            torch.as_tensor(M), impl=impl)
        assert int(order[0]) == int(want[0][0]) == 7
        np.testing.assert_array_equal(counts.numpy(), want[1])
        assert (int(k_stop), bool(any_term)) == (int(want[2]), bool(want[3]))


@pytest.mark.parametrize("k", [1, 2, TILE - 1, TILE, TILE + 1, 2 * TILE, KW])
def test_vectorized_matches_oracle(k):
    rng = np.random.default_rng(k)
    scores = rng.uniform(0.1, 100.0, k)
    cpus = rng.choice([2, 4, 8, 16, 32], k).astype(float)
    for req in (4.0, 129.25, 1000.0):
        oracle = tpool.greedy_pool(scores, cpus, req)
        dense = tpool.greedy_pool_vectorized(scores, cpus, req, impl="dense",
                                             device="cpu")
        tiled = tpool.greedy_pool_vectorized(scores, cpus, req, impl="tiled",
                                             device="cpu")
        assert list(oracle.indices) == list(tiled.indices)
        assert list(oracle.counts) == list(tiled.counts)
        assert list(dense.indices) == list(tiled.indices)
        assert dense.iterations == tiled.iterations


def test_float64_inputs_pinned_to_float32():
    scores = np.array([30.0, 20.0, 10.0, 5.0])
    cpus = np.array([4.0, 8.0, 16.0, 2.0])
    a = tpool.greedy_pool_masked(torch.tensor(scores), torch.tensor(cpus),
                                 64.0, torch.ones(4, dtype=torch.bool))
    b = tpool.greedy_pool_masked(torch.tensor(scores, dtype=torch.float32),
                                 torch.tensor(cpus, dtype=torch.float32),
                                 64.0, torch.ones(4, dtype=torch.bool))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_pool_scan_validates_and_routes():
    s = torch.tensor([3.0, 2.0, 1.0])
    c = torch.tensor([2.0, 2.0, 2.0])
    counts, k_stop, any_term = tps.pool_scan(s, c, 12.0)
    assert counts.dtype == torch.int32 and any_term.dtype == torch.bool
    with pytest.raises(TypeError, match="float32"):
        tps.pool_scan(s.double(), c, 12.0)
    with pytest.raises(ValueError, match="contiguous"):
        tps.pool_scan(torch.tensor([[3.0, 9.0], [2.0, 9.0]]).t()[0:1].expand(2, 2),
                      c[:2].expand(2, 2).contiguous(), 12.0)
    with pytest.raises(ValueError, match="backend"):
        tps.pool_scan(s, c, 12.0, backend="pallas")
    with pytest.raises(ValueError, match="K >= 1"):
        tps.pool_scan(s[:0], c[:0], 12.0)


def test_prefix_sum_tie_flags_only_perturbed_boundaries():
    s = np.array([6.0, 2.0, 0.0])
    c = np.array([1.0, 1.0, 1.0])
    csc = np.cumsum(s)
    runs = [(2, True)]
    # identical sums: nothing to flip, even though 6*8/(6*1) == 8 exactly
    assert not tpool.prefix_sum_tie(s, c, 8.0, csc, csc, runs)[0]
    # a one-ulp disagreement at k = 1 where 6*8/8 == 6 sits on an integer
    other = csc.copy()
    other[1] = np.nextafter(np.float32(8.0), np.float32(9.0))
    tie, margin, budget = tpool.prefix_sum_tie(s, c, 8.0, csc, other, runs)
    assert tie and margin == 0.0 and budget > 0


def test_resolve_pool_impl():
    assert tpool.resolve_pool_impl("dense", 10 ** 6) == "dense"
    assert tpool.resolve_pool_impl("tiled", 2) == "tiled"
    auto_k = tpool.POOL_TILED_AUTO_K
    assert auto_k == jpool.POOL_TILED_AUTO_K
    assert tpool.resolve_pool_impl("auto", auto_k - 1) == "dense"
    assert tpool.resolve_pool_impl("auto", auto_k) == "tiled"
    with pytest.raises(ValueError, match="pool_impl"):
        tpool.resolve_pool_impl("sparse", 8)
