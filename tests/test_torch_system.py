"""The paper's pipeline end to end in the port, against ``repro``'s.

``tests/test_system.py``'s world (seed 11, 2 regions, 60 targets, 800
accounts, 30 USQS cycles) is built twice: market -> rate-limited SPS
service -> collector in ``repro_torch.cloudsim`` and in ``repro.cloudsim``.
What is held, and at what tolerance:

- the collected archives (times, T3 and T2 per target, queries spent) and
  the candidate sets are equal, bit for bit;
- the port's pools, served on the CPU from its own statistics, equal the
  reference engine's on the same candidates: members, order, counts and
  hourly cost exactly, scores at RTOL 1e-5 / ATOL 1e-4
  (``tests/_score_helpers.py``); a pool may differ only where the
  decision-margin replay puts an Algorithm 1 decision within the two
  packages' score difference (an F1 tie, counted; none on this seed);
- the port's ``LiveIngestor`` primes on the port's collector as it is and
  tracks it tick by tick, its window bit-equal to the reference ingestor's;
- the paper's qualitative claims of ``tests/test_system.py``, on the port.
"""
import numpy as np
import pytest
import torch

from repro.cloudsim import (Catalog as JCatalog,
                            CollectorConfig as JCollectorConfig,
                            DataCollector as JCollector, SpotMarket as JMarket,
                            SPSQueryService as JService)
from repro.core import EngineConfig as JConfig
from repro.core import RecommendationEngine as JEngine
from repro.core import ResourceRequest as JReq
from repro.serve import BatchServer as JServer
from repro.serve import DeviceArchive as JArchive
from repro.stream import LiveIngestor as JIngestor
from repro_torch.cloudsim import (Catalog, CollectorConfig, DataCollector,
                                  SpotMarket, SPSQueryService,
                                  probe_real_availability)
from repro_torch.core import (EngineConfig, RecommendationEngine,
                              ResourceRequest, empirical_entropy,
                              find_transition_points, full_scan)
from repro_torch.core.entropy import entropy_bits
from repro_torch.serve import BatchServer, DeviceArchive
from repro_torch.stream import AdmissionQueue, LiveIngestor

from test_torch_stream import REQUESTS, _count_ties

CPU = "cpu"
CYCLES = 30
ENTROPY_TOL = 1e-6


def _world(pkg):
    Cat, Mkt, Svc, Col, Cfg = pkg
    cat = Cat(seed=11, n_regions=2)
    mkt = Mkt(cat, seed=11)
    svc = Svc(mkt, n_accounts=800)
    targets = [(t.name, r, az) for (t, r, az) in mkt.pool_keys[::7][:60]]
    col = Col(svc, targets, Cfg(ring_capacity=64))
    col.run(CYCLES)
    return mkt, svc, col


@pytest.fixture(scope="module")
def world():
    return _world((Catalog, SpotMarket, SPSQueryService, DataCollector,
                   CollectorConfig))


@pytest.fixture(scope="module")
def jworld():
    return _world((JCatalog, JMarket, JService, JCollector, JCollectorConfig))


def test_archives_equal_reference(world, jworld):
    (mkt, svc, col), (jmkt, jsvc, jcol) = world, jworld
    assert col.times == jcol.times and mkt.now == jmkt.now
    assert col.t3_archive == jcol.t3_archive
    assert col.t2_archive == jcol.t2_archive
    assert svc.total_queries == jsvc.total_queries == 60 * CYCLES
    assert svc.capacity_remaining() == jsvc.capacity_remaining()
    a, b = col.to_candidate_set(), jcol.to_candidate_set()
    for name in ("names", "regions", "azs", "families", "categories",
                 "vcpus", "memory_gb", "prices", "t3"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_pools_equal_reference_engine(world, jworld):
    cands, jcands = world[2].to_candidate_set(), jworld[2].to_candidate_set()
    server = BatchServer(RecommendationEngine(EngineConfig(score_impl="tiled"),
                                              device=CPU),
                         bucket_sizes=(1, 4, 8))
    jserver = JServer(JEngine(JConfig(score_impl="tiled")),
                      bucket_sizes=(1, 4, 8))
    arch = DeviceArchive.stage(cands, device=CPU)
    jarch = JArchive.stage(jcands)
    reqs = [ResourceRequest(**kw) for kw in REQUESTS]
    jreqs = [JReq(**kw) for kw in REQUESTS]
    got, want = server.serve(arch, reqs), jserver.serve(jarch, jreqs)
    assert all(r.num_types >= 1 for r in got)
    assert _count_ties(cands, want, got, arch, jarch, reqs) == 0


def test_live_ingestor_tracks_the_port_collector():
    """The port's collector feeds the port's ingestor directly; the
    reference collector (same seed) feeds the reference's: windows and
    versions agree tick by tick and drains serve the newest version."""
    _, _, col = _world((Catalog, SpotMarket, SPSQueryService, DataCollector,
                        CollectorConfig))
    _, _, jcol = _world((JCatalog, JMarket, JService, JCollector,
                         JCollectorConfig))
    ing = LiveIngestor(col, window=16, name="sim", device=CPU)
    jing = JIngestor(jcol, window=16, name="sim")
    arch, jarch = ing.prime(), jing.prime()
    server = BatchServer(device=CPU, bucket_sizes=(1, 4, 8))
    queue = AdmissionQueue(server, lambda: ing.archive, max_wait_s=0.0)
    for _ in range(6):
        col.run(1)
        jcol.run(1)
        assert ing.poll() == 1 and jing.poll() == 1
        assert arch.key == jarch.key
        np.testing.assert_array_equal(arch.materialize(),
                                      jarch.materialize())
        tickets = [queue.submit(ResourceRequest(**kw)) for kw in REQUESTS]
        queue.drain(force=True)
        assert all(t.result().diagnostics["archive_version"] == arch.version
                   for t in tickets)


def test_usqs_vs_full_scan_integrity(world):
    mkt, _, col = world
    errs = [abs(mkt.t3_true(ty, r, az, t=col.times[-1])
                - col.t3_archive[(ty, r, az)][-1])
            for ty, r, az in col.targets[:30]]
    assert np.median(errs) <= 5.0
    assert np.mean(errs) <= 8.0


def test_tstp_more_precise_than_usqs(world):
    mkt = world[0]
    errs, queries = [], []
    for ty, r, az in world[2].targets[:20]:
        truth = full_scan(lambda n: mkt.sps(ty, r, az, n), 1, 50)
        res = find_transition_points(lambda n: mkt.sps(ty, r, az, n), 1, 50)
        errs.append(abs(truth.t3 - res.t3))
        queries.append(res.queries)
    assert np.mean(errs) <= 0.5
    assert np.mean(queries) < 15


def test_entropy_matches_paper_band(world):
    mkt = world[0]
    t3s = [mkt.t3_true(t.name, r, az) for (t, r, az) in mkt.pool_keys]
    snapped = np.clip(np.round(np.array(t3s) / 5) * 5, 0, 50)
    h = empirical_entropy(snapped)
    assert 2.0 <= h <= 3.1
    assert h < np.log2(11) - 0.3
    counts = np.bincount((snapped // 5).astype(np.int64), minlength=11)
    assert abs(float(entropy_bits(torch.as_tensor(counts))) - h) \
        <= ENTROPY_TOL


def test_recommended_pools_more_available(world):
    mkt, _, col = world
    cands = col.to_candidate_set()
    eng = RecommendationEngine(device=CPU)
    _, avail, _ = eng.score(cands, ResourceRequest(cpus=64.0, weight=1.0))
    order = np.argsort(-np.asarray(avail))
    pick = lambda idx: [(str(cands.names[i]), str(cands.regions[i]),  # noqa: E731
                         str(cands.azs[i])) for i in idx]
    best = probe_real_availability(mkt, pick(order[:5]), n_nodes=10,
                                   period_min=30, duration_min=360)
    worst = probe_real_availability(mkt, pick(order[-5:]), n_nodes=10,
                                    period_min=30, duration_min=360)
    assert (np.mean([r.real_availability for r in best])
            > np.mean([r.real_availability for r in worst]) + 20.0)


def test_weight_tradeoff_direction(world):
    cands = world[2].to_candidate_set()
    eng = RecommendationEngine(device=CPU)
    recs = {w: eng.recommend(cands, ResourceRequest(cpus=128.0, weight=w))
            for w in (0.0, 1.0)}
    assert recs[0.0].hourly_cost <= recs[1.0].hourly_cost + 1e-9
    assert recs[1.0].availability.mean() >= recs[0.0].availability.mean() - 1e-9
