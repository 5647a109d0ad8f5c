"""The static quantized archive tier, ``core/quantized.py`` and ``ilp_pool``
in the port, against ``repro`` on the same numpy inputs.

What is held:

- the stored codes and per-candidate scales of ``DeviceArchive.stage(
  precision="int8" | "bfloat16")`` bit-equal to the reference's;
- the tier's statistics (``score_stats()``, from the decoded window,
  decoded in row chunks) against the reference's at RTOL 1e-5 / ATOL 1e-4
  (``tests/_score_helpers.py``: the two packages sum in other orders), and
  the chunked statistics bit-equal to the unchunked ones;
- on the same stored codes and statistics (``convert``), the port's pools
  equal the reference's except where ``prefix_sum_tie`` certifies an F1
  tie (counted: none on these seeds);
- the tier's surface as the reference's suite pins it: cache keys, nbytes,
  rolling rings, sharded tiers, the ingestor's precision;
- the parity contract of ``core.quantized``: every random-catalog request
  identical or a flagged tie, a separated catalog bit-identical, a tie
  flagged, ``max_types`` refused, and its numbers equal the reference's;
- ``ilp_pool`` against the reference's on the same inputs.

Every input comes from a fixed numpy seed.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import EngineConfig as JConfig
from repro.core import RecommendationEngine as JEngine
from repro.core import ResourceRequest as JReq
from repro.core import pool as jpool
from repro.core import quantized as jqz
from repro.core import scoring as jscoring
from repro.kernels import pool_scan as jps
from repro.serve import DeviceArchive as JArchive
from repro_torch import convert
from repro_torch.core import (EngineConfig, RecommendationEngine,
                              ResourceRequest, scoring)
from repro_torch.core import pool as tpool
from repro_torch.core import quantized as qz
from repro_torch.core.types import RequestBatch
from repro_torch.kernels import pool_scan as tps
from repro_torch.parallel import compression as comp
from repro_torch.serve import ArchiveCache, DeviceArchive, QuantizedDeviceArchive
from repro_torch.serve.archive import decoded_stats
from repro_torch.shard import ShardedArchive, ShardedRollingArchive
from repro_torch.stream import LiveIngestor, RollingDeviceArchive

from _score_helpers import ATOL, RTOL
from test_serve_batch import synth_candidates as _ref_candidates
from test_torch_stream import _collector

CPU = "cpu"
QUANT = ["bfloat16", "int8"]
TIERS = ["float32"] + QUANT


def synth_candidates(seed, K, T=24):
    return convert.as_candidate_set(_ref_candidates(seed=seed, K=K, T=T))


def _assert_stats_close(got, want):
    for name, a, b in zip(("area", "slope", "std"), got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def _codes(t):
    """Stored codes as comparable integers (bf16 by its bit pattern)."""
    t = torch.as_tensor(t)
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _ref_codes(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# staged archives against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", QUANT)
def test_codes_and_scales_bit_equal_reference(precision):
    ref = _ref_candidates(seed=31, K=700, T=200)
    port = convert.as_candidate_set(ref)
    j = JArchive.stage(ref, precision=precision, headroom=1.25)
    t = DeviceArchive.stage(port, device=CPU, precision=precision,
                            headroom=1.25)
    assert t.key == j.key and t.t3_q.dtype == comp.storage_dtype(precision)
    np.testing.assert_array_equal(_codes(t.t3_q), _ref_codes(j.t3_q))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    # the decode is one float32 multiply (or a cast): bit-equal as well
    np.testing.assert_array_equal(t.t3.numpy(), np.asarray(j.t3))


@pytest.mark.parametrize("precision", QUANT)
def test_quantized_stats_match_reference(precision):
    ref = _ref_candidates(seed=32, K=3000, T=48)
    port = convert.as_candidate_set(ref)
    j = JArchive.stage(ref, precision=precision)
    t = DeviceArchive.stage(port, device=CPU, precision=precision)
    _assert_stats_close(t.score_stats(), j.score_stats())


@pytest.mark.parametrize("precision", QUANT)
@pytest.mark.parametrize("chunk", [1, 7, 333])
def test_chunked_stats_bit_equal_unchunked(precision, chunk):
    cands = synth_candidates(33, K=1000, T=200)
    t = DeviceArchive.stage(cands, device=CPU, precision=precision)
    whole = scoring.candidate_stats(t.t3)
    for name, a, b in zip(("area", "slope", "std"),
                          decoded_stats(t.t3_q, t.scale, precision,
                                        chunk=chunk), whole):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


def _tie(port, archive, req, got):
    """Replay one request's scan on the port's rows: an F1 tie?"""
    batch = RequestBatch.from_requests(port, [req])
    comb, _, _, _, _, k_stop, any_term = RecommendationEngine(
        EngineConfig(score_impl="tiled"), device=CPU).batch_arrays(
        port, batch, archive=archive)
    caps = torch.where(torch.as_tensor(batch.use_cpus)[:, None],
                       archive.vcpus, archive.memory_gb)
    _, s, c = tpool._sort_masked(torch.as_tensor(comb), caps,
                                 torch.as_tensor(batch.masks))
    csc_t = tps._clamped_prefix_sums(s[0]).numpy()
    csc_j = np.asarray(jps._clamped_prefix_sums(jnp.asarray(s[0].numpy())))
    run = (int(k_stop[0]), bool(any_term[0]))
    return tpool.prefix_sum_tie(s[0].numpy(), c[0].numpy(),
                                float(batch.amounts[0]), csc_t, csc_j,
                                [run, run])[0]


REQUESTS = [dict(cpus=128.0), dict(memory_gb=256.0, weight=0.8),
            dict(cpus=96.0, weight=0.3, lam=0.25),
            dict(cpus=64.0, regions=["us-east-1"]),
            dict(cpus=200.0, max_types=2), dict(cpus=500.0, weight=1.0)]


@pytest.mark.parametrize("precision", QUANT)
def test_quantized_pools_match_reference(precision):
    """Both packages serve their own staged tier of one catalog; the port
    on the reference's codes and statistics (``convert``) gives the
    reference's pools, ties counted."""
    ref = _ref_candidates(seed=34, K=400, T=48)
    port = convert.as_candidate_set(ref)
    j = JArchive.stage(ref, precision=precision)
    archive = convert.quantized_archive_from_numpy(
        port, np.asarray(j.t3_q), np.asarray(j.scale), precision,
        [np.asarray(x) for x in j.score_stats()], device=CPU, key=j.key)
    np.testing.assert_array_equal(archive.t3.numpy(), np.asarray(j.t3))
    refs = JEngine(JConfig(score_impl="tiled")).recommend_batch(
        ref, [JReq(**kw) for kw in REQUESTS], archive=j)
    reqs = [ResourceRequest(**kw) for kw in REQUESTS]
    gots = RecommendationEngine(EngineConfig(score_impl="tiled"),
                                device=CPU).recommend_batch(
        port, reqs, archive=archive)
    ties = 0
    for req, a, b in zip(reqs, refs, gots):
        if not (list(a.names) == list(b.names)
                and np.array_equal(a.counts, b.counts)
                and a.hourly_cost == b.hourly_cost):
            assert _tie(port, archive, req, b), f"pool differs for {req}"
            ties += 1
            continue
        np.testing.assert_allclose(b.combined, a.combined, rtol=RTOL,
                                   atol=ATOL)
    assert ties == 0


# ---------------------------------------------------------------------------
# the tier's surface (the reference suite's cases that apply to the port)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", QUANT)
def test_staged_quantized_archive_surface(precision):
    cands = synth_candidates(1, K=97)
    arch = DeviceArchive.stage(cands, device=CPU, precision=precision)
    assert isinstance(arch, QuantizedDeviceArchive)
    assert arch.key.endswith(f"#{precision}")
    assert getattr(arch, "dense_capable", True)   # decodes for dense parity
    want = comp.dequantize_window(arch.t3_q, arch.scale, precision)
    np.testing.assert_array_equal(arch.t3.numpy(), want.numpy())
    assert arch.t3 is not arch.t3                 # decoded anew, not kept
    for a, b in zip(arch.score_stats(), scoring.candidate_stats(want)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert arch.t3_operand is arch.score_stats().area
    np.testing.assert_array_equal(arch.prices.numpy(),
                                  cands.prices.astype(np.float32))
    # the dense and tiled stages give the same bits on the decoded window
    reqs = [ResourceRequest(**kw) for kw in REQUESTS]
    outs = [RecommendationEngine(EngineConfig(score_impl=s), device=CPU)
            .recommend_batch(cands, reqs, archive=arch)
            for s in ("dense", "tiled")]
    for a, b in zip(*outs):
        assert list(a.names) == list(b.names)
        np.testing.assert_array_equal(a.combined, b.combined)


def test_staged_tiers_never_share_cache_keys():
    cands = synth_candidates(2, K=33)
    keys = {DeviceArchive.stage(cands, device=CPU, precision=p).key
            for p in TIERS}
    assert len(keys) == 3
    cache = ArchiveCache(capacity=4, device=CPU)
    for p in TIERS:
        cache.put(DeviceArchive.stage(cands, device=CPU, precision=p))
    assert len(cache) == 3


def test_cache_precision_stages_and_keys_that_tier():
    cands = synth_candidates(3, K=41)
    f32_cache = ArchiveCache(capacity=2, device=CPU)
    q_cache = ArchiveCache(capacity=2, precision="int8", headroom=1.5,
                           device=CPU)
    a = f32_cache.get(cands)
    b = q_cache.get(cands)
    assert isinstance(a, DeviceArchive) and isinstance(b, QuantizedDeviceArchive)
    assert b.key == f"{a.key}#int8"
    assert q_cache.get(cands) is b and q_cache.hits == 1
    want = comp.candidate_scales(cands.t3, "int8", headroom=1.5)
    np.testing.assert_array_equal(b.scale.numpy(), want)


def test_engine_config_threads_precision():
    cfg = EngineConfig(archive_precision="int8", archive_headroom=1.25)
    cache = cfg.build_cache(device=CPU)
    assert cache.precision == "int8" and cache.headroom == 1.25
    with pytest.raises(ValueError, match="precision"):
        EngineConfig(archive_precision="int4")
    with pytest.raises(ValueError, match="headroom"):
        EngineConfig(archive_headroom=0.9)


@pytest.mark.parametrize("precision", QUANT)
def test_rolling_quantized_tracks_dequantized_window(precision):
    rng = np.random.default_rng(5)
    cands = synth_candidates(5, K=64, T=12)
    arch = RollingDeviceArchive(cands, capacity=12, precision=precision,
                                headroom=1.5, device=CPU)
    assert arch.key.endswith(f"#{precision}")
    for _ in range(20):
        arch.append(rng.uniform(0.0, 50.0, 64))
        _assert_stats_close(arch.score_stats(),
                            scoring.candidate_stats(arch.materialize()))
    assert arch.clipped_samples == 0
    snap = arch.snapshot()
    assert snap.precision == precision and snap.key == arch.key


def test_rolling_int8_clipping_is_surfaced():
    cands = synth_candidates(6, K=16, T=8)
    arch = RollingDeviceArchive(cands, capacity=8, precision="int8",
                                device=CPU)
    arch.append(np.full(16, 1e4))
    assert arch.clipped_samples == 16


def test_rolling_quantized_append_matches_staged_codes():
    """A ring that absorbed 2T ticks stores the codes a static staging of
    its final window at the ring's scale would."""
    rng = np.random.default_rng(7)
    K, T = 32, 10
    cands = synth_candidates(7, K=K, T=T)
    arch = RollingDeviceArchive(cands, capacity=T, precision="int8",
                                headroom=2.0, device=CPU)
    history = np.asarray(cands.t3, np.float64)
    for _ in range(2 * T):
        col = rng.uniform(0.0, 25.0, K)
        arch.append(col)
        history = np.concatenate([history, col[:, None]], axis=1)
    scale = arch.scale.numpy()
    want = comp.quantize_window(history[:, -T:], scale, "int8")
    np.testing.assert_array_equal(
        arch.materialize(), comp.dequantize_window(want, scale, "int8").numpy())


@pytest.mark.parametrize("precision", TIERS)
def test_staged_nbytes_sums_components(precision):
    cands = synth_candidates(9, K=40, T=16)
    arch = DeviceArchive.stage(cands, device=CPU, precision=precision)
    if precision == "float32":
        parts = [arch.t3, arch.prices, arch.vcpus, arch.memory_gb]
    else:
        parts = [arch.t3_q, arch.scale, arch.prices, arch.vcpus,
                 arch.memory_gb]
    assert arch.nbytes == sum(int(a.nbytes) for a in parts)
    stats = arch.score_stats()
    assert arch.nbytes == sum(int(a.nbytes) for a in parts) \
        + sum(int(a.nbytes) for a in stats)
    j = JArchive.stage(_ref_candidates(seed=9, K=40, T=16),
                       precision=precision)
    j.score_stats()
    assert arch.nbytes == j.nbytes


def test_int8_tier_is_4x_smaller():
    cands = synth_candidates(10, K=256, T=64)
    f32 = DeviceArchive.stage(cands, device=CPU)
    q = DeviceArchive.stage(cands, device=CPU, precision="int8")
    b = DeviceArchive.stage(cands, device=CPU, precision="bfloat16")
    assert int(f32.t3.nbytes) == 4 * int(q.t3_q.nbytes) \
        == 2 * int(b.t3_q.nbytes)


# ---------------------------------------------------------------------------
# sharded tiers and ingestion
# ---------------------------------------------------------------------------

def test_sharded_quantized_matches_single_ring():
    rng = np.random.default_rng(11)
    K, T = 48, 9
    cands = synth_candidates(11, K=K, T=T)
    single = RollingDeviceArchive(cands, capacity=T, precision="int8",
                                  name="arch", headroom=3.0, device=CPU)
    sharded = ShardedRollingArchive(cands, capacity=T, n_shards=3,
                                    name="arch", precision="int8",
                                    headroom=3.0, devices=[CPU])
    assert sharded.key == single.key == "arch@v0#int8"
    for _ in range(2 * T):
        col = rng.uniform(0.0, 50.0, K)
        single.append(col)
        sharded.append(col)
    np.testing.assert_array_equal(sharded.materialize(), single.materialize())
    assert sharded.clipped_samples == single.clipped_samples == 0
    for got, want in zip(zip(*(s.score_stats() for s in sharded.shards)),
                         single.score_stats()):
        np.testing.assert_array_equal(torch.cat(got).numpy(), want.numpy())


@pytest.mark.parametrize("precision", QUANT)
def test_sharded_stage_threads_precision(precision):
    cands = synth_candidates(12, K=30, T=8)
    arch = ShardedArchive.stage(cands, n_shards=2, precision=precision,
                                devices=[CPU])
    single = DeviceArchive.stage(cands, device=CPU, precision=precision)
    assert arch.key == single.key
    for (a, b), shard in zip(arch.bounds, arch.shards):
        assert isinstance(shard, QuantizedDeviceArchive)
        assert shard.key.endswith(f"#{precision}")
        np.testing.assert_array_equal(_codes(shard.t3_q),
                                      _codes(single.t3_q[a:b]))
    want = sum(s.nbytes for s in arch.shards) + sum(
        int(a.nbytes) for a in (arch.prices, arch.vcpus, arch.memory_gb))
    assert arch.nbytes == want


def test_ingestor_precision_from_config():
    col = _collector()
    cfg = EngineConfig(archive_precision="int8", archive_headroom=1.5)
    ing = LiveIngestor(col, window=8, config=cfg, device=CPU)
    arch = ing.prime()
    assert arch.precision == "int8" and arch.key.endswith("#int8")
    assert ing.cache is not None and arch.key in ing.cache
    col.run(2)
    ing.poll()
    assert ing.archive.key in ing.cache and ing.archive.version == 2
    ing2 = LiveIngestor(col, window=8, precision="bfloat16", device=CPU)
    assert ing2.prime().precision == "bfloat16"
    sharded = LiveIngestor(col, window=8, config=cfg, device=CPU, shards=3)
    arch = sharded.prime()
    assert arch.is_sharded and arch.key.endswith("#int8")
    assert all(s.precision == "int8" for s in arch.shards)


# ---------------------------------------------------------------------------
# the error-bound / pool-parity contract
# ---------------------------------------------------------------------------

def _parity_case(cands, requests, precision="int8"):
    """The float32 and quantised tiers' pools and, per request, the bound
    and decision-margin replay of ``core.quantized``."""
    engine = RecommendationEngine(device=CPU)
    f32 = DeviceArchive.stage(cands, device=CPU)
    q = DeviceArchive.stage(cands, device=CPU, precision=precision)
    recs_f = engine.recommend_batch(cands, requests, archive=f32)
    recs_q = engine.recommend_batch(cands, requests, archive=q)
    t3f = f32.t3
    stats = scoring.candidate_stats(t3f)
    bounds = qz.stat_bounds(q.scale.numpy(), cands.t3.shape[1])
    masks = RequestBatch.from_requests(cands, requests).masks
    out = []
    for req, rec_f, rec_q, mask in zip(requests, recs_f, recs_q, masks):
        m = torch.as_tensor(mask)
        avail = scoring.availability_scores_masked(t3f, req.lam, m)
        caps = req.capacity_of(cands)
        cost = scoring.cost_scores_masked(f32.prices, caps, req.amount, m)
        comb = scoring.combined_scores(avail, cost, req.weight).double()
        bound = qz.score_bound(
            scoring.CandidateStats(*(s.numpy() for s in stats)), bounds,
            mask, req.lam, req.weight)
        out.append(qz.check_pool_parity(rec_f, rec_q, comb.numpy(), caps,
                                        req.amount, mask, bound))
    return out


def test_parity_contract_random_catalog():
    """Every request matches bit for bit or is a flagged tie."""
    cands = synth_candidates(21, K=96, T=24)
    requests = [
        ResourceRequest(cpus=128.0),
        ResourceRequest(memory_gb=256.0, weight=0.8),
        ResourceRequest(cpus=96.0, weight=0.3, lam=0.25),
        ResourceRequest(cpus=64.0, regions=[str(cands.regions[0])]),
    ]
    parities = [p for prec in QUANT
                for p in _parity_case(cands, requests, prec)]
    for p in parities:
        assert p.ok, p
        if p.margin > 1.0:
            assert p.identical, p


def _separated(K=12, T=24):
    """Candidates separated in every Eq. 3 statistic by much more than the
    int8 step (the reference suite's catalog)."""
    rng = np.random.default_rng(23)
    cands = synth_candidates(25, K=K, T=T)
    i = np.arange(K)[:, None]
    t = np.arange(T)[None, :]
    t3 = (8.0 + 4.0 * i) + (0.05 * i - 0.3) * (t - T / 2) \
        + (0.5 + 0.8 * i) * rng.uniform(-1.0, 1.0, (K, T))
    return convert.candidate_set_from_numpy(**{**vars(cands), "t3": t3})


def test_parity_contract_separated_catalog_is_bit_identical():
    """The measured quantised score drift stays inside the bound, every
    adjacent masked score gap exceeds twice it, and the pools come out
    bit-identical (the margin itself is <= 1 here for the reason the
    reference suite gives: R / c_0 lands on an integer)."""
    cands = _separated()
    requests = [ResourceRequest(cpus=63.0, weight=1.0, lam=0.01),
                ResourceRequest(cpus=127.0, weight=1.0, lam=0.01)]
    q = DeviceArchive.stage(cands, device=CPU, precision="int8")
    t3f = scoring.f32(cands.t3)
    masks = RequestBatch.from_requests(cands, requests).masks
    for req, mask, p in zip(requests, masks,
                            _parity_case(cands, requests, "int8")):
        assert p.identical and p.ok, p
        assert np.isfinite(p.bound) and p.bound > 0.0, p
        m = torch.as_tensor(mask)
        caps = req.capacity_of(cands)
        cost = scoring.cost_scores_masked(scoring.f32(cands.prices), caps,
                                          req.amount, m)
        combs = [scoring.combined_scores(
            scoring.availability_scores_masked(win, req.lam, m), cost,
            req.weight).double().numpy() for win in (t3f, q.t3)]
        drift = np.abs(combs[1] - combs[0])[mask].max()
        assert drift <= p.bound, (drift, p.bound)
        s = np.sort(combs[0][mask])[::-1]
        assert (s[:-1] - s[1:] > 2.0 * p.bound).all()


def test_tie_is_flagged_not_hidden():
    comb = np.array([10.0, 7.0, 3.0])
    caps = np.array([3.0, 7.0, 13.0])
    mask = np.ones(3, bool)
    tight = qz.pool_decision_margin(comb, caps, 50.0, mask, bound=0.01)
    wide = qz.pool_decision_margin(comb, caps, 50.0, mask, bound=2.0)
    assert tight > 1.0 and wide <= 1.0
    assert qz.QuantizedParity(identical=False, tie=True, margin=wide,
                              bound=2.0).ok
    assert not qz.QuantizedParity(identical=False, tie=False, margin=tight,
                                  bound=0.01).ok
    assert qz.pool_decision_margin(comb, caps, 50.0, mask, 0.0) == np.inf
    exact = qz.pool_decision_margin(comb, np.array([4.0, 7.0, 13.0]),
                                    48.0, mask, bound=1e-9)
    assert exact == 0.0


def test_max_types_margin_is_refused_not_silently_wrong():
    comb = np.array([10.0, 7.0, 3.0])
    caps = np.array([3.0, 7.0, 13.0])
    mask = np.ones(3, bool)
    with pytest.raises(NotImplementedError, match="max_types"):
        qz.pool_decision_margin(comb, caps, 50.0, mask, 0.5, max_types=2)
    with pytest.raises(NotImplementedError, match="max_types"):
        qz.check_pool_parity(None, None, comb, caps, 50.0, mask, 0.5,
                             max_types=2)
    assert qz.pool_decision_margin(comb, caps, 50.0, mask, 0.01,
                                   max_types=None) > 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantized_contract_numbers_match_reference(seed):
    """``stat_bounds``, ``score_bound`` and ``pool_decision_margin`` give
    the reference's numbers on the same host inputs."""
    rng = np.random.default_rng(seed)
    K, T = 60, int(rng.integers(1, 40))
    stats = [rng.uniform(0, 50, K) for _ in range(3)]
    step = rng.uniform(1e-3, 0.5, K)
    mask = rng.random(K) < 0.7
    mask[0] = True
    comb = rng.uniform(0, 100, K)
    caps = rng.choice([2.0, 4.0, 8.0, 16.0, 96.0], K)
    tb, jb = qz.stat_bounds(step, T), jqz.stat_bounds(step, T)
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    got = qz.score_bound(qz.CandidateStats(*stats), tb, mask, 0.2, 0.6)
    want = jqz.score_bound(jscoring.CandidateStats(*stats), jb, mask, 0.2,
                           0.6)
    assert got == want
    for bound in (0.0, 1e-4, 0.3, got, np.inf):
        assert (qz.pool_decision_margin(comb, caps, 333.0, mask, bound)
                == jqz.pool_decision_margin(comb, caps, 333.0, mask, bound))


# ---------------------------------------------------------------------------
# ilp_pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,K,required", [(0, 12, 64.0), (1, 25, 200.0),
                                             (2, 40, 96.0)])
def test_ilp_pool_matches_reference(seed, K, required):
    rng = np.random.default_rng(seed)
    scores = rng.uniform(0.0, 100.0, K)
    cpus = rng.choice([2.0, 4.0, 8.0, 16.0, 32.0, 64.0], K)
    got = tpool.ilp_pool(scores, cpus, required, gamma=2.0)
    want = jpool.ilp_pool(scores, cpus, required, gamma=2.0)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert got.extra["objective"] == want.extra["objective"]
    total = got.total_cpus(cpus)
    assert required <= total <= required + cpus.max()
