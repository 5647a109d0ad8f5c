"""The slice as a whole: the port's engine and server against ``repro``'s.

A small world (K = 200, T = 48, three regions, four families) and a request
mix with region/family filters, memory requests, ``max_types``, W = 1 and
bucket padding.  The Eq. 3 statistics are carried from the reference into
the port with ``repro_torch.convert``, so the comparison is of everything
after them:

- pools (members, order, counts) and hourly cost identical, except a pool
  that ``prefix_sum_tie`` flags as an F1 tie (counted; none expected here);
- scores within RTOL 1e-5 / ATOL 1e-4 (``tests/_score_helpers.py``);
- inside the port: ``recommend`` and ``recommend_batch`` agree, and the
  dense and tiled lanes of both stages give the same bits.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import engine as jeng
from repro.core.config import EngineConfig as JConfig
from repro.core.types import CandidateSet as JCands
from repro.core.types import ResourceRequest as JReq
from repro.kernels import pool_scan as jps
from repro.serve import BatchServer as JServer
from repro.serve import DeviceArchive as JArchive
from repro_torch import convert
from repro_torch.core import engine as teng
from repro_torch.core import pool as tpool
from repro_torch.core.config import EngineConfig
from repro_torch.core.types import RequestBatch
from repro_torch.core.types import ResourceRequest as TReq
from repro_torch.kernels import pool_scan as tps
from repro_torch.serve import (ArchiveCache, BatchServer, DeviceArchive,
                               QuantizedDeviceArchive)

from _score_helpers import ATOL, RTOL

K, T = 200, 48

REQUESTS = [dict(cpus=128.0), dict(memory_gb=256.0, weight=0.8),
            dict(cpus=96.0, weight=0.0, lam=0.3),
            dict(cpus=64.0, regions=["us-east-1"]),
            dict(cpus=200.0, max_types=2), dict(cpus=500.0, weight=1.0),
            dict(memory_gb=48.0, weight=0.9, families=["c5", "r5"]),
            dict(cpus=1000.0, regions=["eu-west-1", "ap-north-1"],
                 families=["m5"], lam=0.2),
            dict(cpus=16.0, weight=0.3), dict(memory_gb=4096.0, max_types=3)]


def _world(seed: int = 23):
    rng = np.random.default_rng(seed)
    fams = rng.choice(["m5", "c5", "r5", "t3"], K)
    ref = JCands(
        names=np.array([f"{fams[i]}.x{i}" for i in range(K)]),
        regions=rng.choice(["us-east-1", "eu-west-1", "ap-north-1"], K),
        azs=rng.choice(["a", "b", "c"], K), families=fams,
        categories=rng.choice(["general", "compute", "memory"], K),
        vcpus=rng.choice([2, 4, 8, 16, 32, 64, 96], K).astype(np.float64),
        memory_gb=rng.choice([4, 8, 16, 64, 128, 384], K).astype(np.float64),
        prices=rng.uniform(0.01, 5.0, K), t3=rng.uniform(0.0, 50.0, (K, T)))
    ref_archive = JArchive.stage(ref)
    stats = [np.array(x) for x in ref_archive.score_stats()]
    port = convert.candidate_set_from_numpy(**vars(ref))
    return ref, ref_archive, port, stats


def _port_tie(port, archive, req_kw, got_rec):
    """Replay one request's scan: is a pool difference an F1 tie?"""
    batch = RequestBatch.from_requests(port, [TReq(**req_kw)])
    eng = teng.RecommendationEngine(EngineConfig(score_impl="tiled"),
                                    device="cpu")
    comb, _, _, _, counts, k_stop, any_term = eng.batch_arrays(
        port, batch, archive=archive)
    caps = torch.where(torch.as_tensor(batch.use_cpus)[:, None],
                       archive.vcpus, archive.memory_gb)
    _, s, c = tpool._sort_masked(torch.as_tensor(comb), caps,
                                 torch.as_tensor(batch.masks))
    s, c = s[0], c[0]
    csc_t = tps._clamped_prefix_sums(s).numpy()
    csc_j = np.asarray(jps._clamped_prefix_sums(jnp.asarray(s.numpy())))
    run = (int(k_stop[0]), bool(any_term[0]))
    return tpool.prefix_sum_tie(s.numpy(), c.numpy(), float(batch.amounts[0]),
                                csc_t, csc_j, [run, run])[0]


def _compare(refs, gots, port, archive):
    ties = 0
    for kw, a, b in zip(REQUESTS * 2, refs, gots):
        same = (list(a.names) == list(b.names)
                and np.array_equal(a.counts, b.counts)
                and a.hourly_cost == b.hourly_cost)
        if not same:
            assert _port_tie(port, archive, kw, b), f"pool differs for {kw}"
            ties += 1
            continue
        assert list(a.regions) == list(b.regions)
        assert (a.diagnostics["greedy_iterations"]
                == b.diagnostics["greedy_iterations"])
        assert (a.diagnostics["candidates_considered"]
                == b.diagnostics["candidates_considered"])
        for x, y in ((a.combined, b.combined), (a.availability, b.availability),
                     (a.cost, b.cost)):
            np.testing.assert_allclose(y, x, rtol=RTOL, atol=ATOL)
    return ties


@pytest.mark.parametrize("pool_impl", ["dense", "tiled"])
def test_recommend_batch_matches_reference(pool_impl):
    ref, ref_archive, port, stats = _world()
    archive = convert.archive_from_numpy(port, stats, device="cpu")
    reqs = REQUESTS
    refs = jeng.RecommendationEngine(
        JConfig(score_impl="tiled", pool_impl=pool_impl)).recommend_batch(
        ref, [JReq(**kw) for kw in reqs], archive=ref_archive)
    gots = teng.RecommendationEngine(
        EngineConfig(score_impl="tiled", pool_impl=pool_impl),
        device="cpu").recommend_batch(port, [TReq(**kw) for kw in reqs],
                                      archive=archive)
    assert _compare(refs, gots, port, archive) == 0


def test_batch_server_matches_reference():
    """Bucketing and padding: 20 requests on a (1, 8, 64) ladder."""
    ref, ref_archive, port, stats = _world(29)
    archive = convert.archive_from_numpy(port, stats, device="cpu")
    jserver = JServer(config=JConfig(score_impl="tiled"), bucket_sizes=(1, 8, 64))
    tserver = BatchServer(config=EngineConfig(score_impl="tiled"),
                          bucket_sizes=(1, 8, 64), device="cpu")
    refs = jserver.serve(ref_archive, [JReq(**kw) for kw in REQUESTS * 2])
    gots = tserver.serve(archive, [TReq(**kw) for kw in REQUESTS * 2])
    assert tserver.plan_chunks(20) == jserver.plan_chunks(20)
    assert tserver.stats.padded_slots == jserver.stats.padded_slots > 0
    assert tserver.stats.bucket_counts == jserver.stats.bucket_counts
    assert _compare(refs, gots, port, archive) == 0


def test_plan_chunks_matches_reference():
    jserver = JServer(bucket_sizes=(1, 8, 64, 256))
    tserver = BatchServer(bucket_sizes=(1, 8, 64, 256), device="cpu")
    for n in range(1, 600, 7):
        assert tserver.plan_chunks(n) == jserver.plan_chunks(n)


def test_recommend_agrees_with_recommend_batch():
    _, _, port, _ = _world(31)
    eng = teng.RecommendationEngine(device="cpu")
    reqs = [TReq(**kw) for kw in REQUESTS]
    for req, bat in zip(reqs, eng.recommend_batch(port, reqs)):
        seq = eng.recommend(port, req)
        assert list(seq.names) == list(bat.names)
        np.testing.assert_array_equal(seq.counts, bat.counts)
        assert seq.hourly_cost == bat.hourly_cost
        assert (seq.diagnostics["greedy_iterations"]
                == bat.diagnostics["greedy_iterations"])
        for a, b in ((seq.combined, bat.combined),
                     (seq.availability, bat.availability), (seq.cost, bat.cost)):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_dense_and_tiled_lanes_are_bitwise():
    _, _, port, _ = _world(37)
    archive = DeviceArchive.stage(port, device="cpu")
    batch = RequestBatch.from_requests(port, [TReq(**kw) for kw in REQUESTS],
                                       pad_to=16)
    outs = [teng.RecommendationEngine(
        EngineConfig(score_impl=s, pool_impl=p), device="cpu").batch_arrays(
        port, batch, archive=archive)
        for s, p in (("dense", "dense"), ("tiled", "tiled"), ("dense", "tiled"))]
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(a, b)


def test_score_archive_matches_reference():
    ref, ref_archive, port, stats = _world(41)
    archive = convert.archive_from_numpy(port, stats, device="cpu")
    want = jeng.RecommendationEngine().score_archive(ref_archive, lam=0.2,
                                                     weight=0.7, amount=64.0)
    got = teng.RecommendationEngine(device="cpu").score_archive(
        archive, lam=0.2, weight=0.7, amount=64.0)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


def test_empty_filter_raises_and_sink_fires():
    _, _, port, _ = _world()
    eng = teng.RecommendationEngine(device="cpu")
    with pytest.raises(ValueError, match="batch row 1"):
        eng.recommend_batch(port, [TReq(cpus=8.0), TReq(cpus=8.0, types=["x"])])
    with pytest.raises(ValueError, match="no candidates"):
        eng.recommend(port, TReq(cpus=8.0, regions=["mars-1"]))
    seen = []
    server = BatchServer(engine=eng, bucket_sizes=(1, 8))
    server.result_sink = lambda req, rec: seen.append(rec.hourly_cost)
    recs = server.serve(port, [TReq(cpus=64.0), TReq(memory_gb=64.0)])
    assert seen == [r.hourly_cost for r in recs]


def test_archives_cache_and_config():
    _, _, port, stats = _world()
    archive = convert.archive_from_numpy(port, stats, device="cpu")
    got = archive.score_stats()
    for a, b in zip(got, stats):
        np.testing.assert_array_equal(a.numpy(), b)
    assert archive.nbytes == 4 * (K * T + 3 * K) + 3 * 4 * K
    cache = ArchiveCache(capacity=2, device="cpu")
    a = cache.get(port)
    assert cache.get(port) is a and cache.hits == 1
    cache.get(port, key="other")
    cache.get(port, key="third")
    assert cache.evictions == 1 and a.key not in cache
    for precision in ("int8", "bfloat16"):
        staged = DeviceArchive.stage(port, device="cpu", precision=precision)
        assert isinstance(staged, QuantizedDeviceArchive)
        assert staged.key == f"{port.fingerprint()}#{precision}"
    ing = EngineConfig(archive_precision="int8").build_ingestor(
        None, window=8, device="cpu")
    assert ing.precision == "int8" and ing.cache.device.type == "cpu"
    eng = teng.RecommendationEngine(device="cpu")
    want = eng.score_archive(archive, lam=0.2, weight=0.7, amount=64.0)
    got = eng.score_archive(
        convert.sharded_archive_from_numpy(port, ((0, 7), (7, 130), (130, K)),
                                           stats, devices=["cpu"]),
        lam=0.2, weight=0.7, amount=64.0)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    with pytest.raises(ValueError, match="pool_impl"):
        EngineConfig(pool_impl="sparse")
    assert EngineConfig().build_engine(device="cpu").device.type == "cpu"
    assert EngineConfig(cache_capacity=3).build_server(
        device="cpu").cache.capacity == 3
