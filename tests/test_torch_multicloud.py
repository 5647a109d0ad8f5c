"""The multi-vendor, region-sharded scenario engine in the port
(``repro_torch.multicloud``) against ``repro.multicloud``.

``tests/test_multicloud.py``'s worlds are built in both packages from the
same seeds; the port serves with ``device="cpu"`` (the kernels' plain
PyTorch versions).  What is held, bit for bit unless named:

- every (vendor, region) world of the three vendors' registries: catalog
  types, spot and on-demand prices, AZs, UTC offsets, pool keys and the
  capacity traces (``free`` at several times, the SPS answers with
  Azure's missing responses, interruption-free scores);
- the signal adapters' raw and normalised values on a grid and on live
  probes, missing responses included;
- federation routing, node-id remapping and the interruption log;
- ``MultiCloudCollector``'s ring, columns, times, ``t3_archive`` and
  missing-response count, its scheduler's plans, and its atomicity under a
  raising fault hook;
- ``budget_scaling``'s rows at ``benchmarks/multiregion_compare.py``'s
  smoke budget, and that benchmark's budget gates;
- region-sharded serving: the port's sharded snapshot and rolling ring
  give one ring's pools and score rows bit for bit, and the reference's
  pools (members, counts, hourly cost; scores at ``tests/_score_helpers``'s
  RTOL 1e-5 / ATOL 1e-4: the packages' float32 rows part by an ulp);
- ``compare_setup`` at the benchmark's SMOKE size for its four setups:
  every ``PolicyResult`` equals the reference's, SpotVista's availability
  is at least SpotFleet's and within ``AVAIL_REGRESSION`` of the committed
  ``BENCH_multiregion.json``;
- the reference's own assertions, on the port.
"""
import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.cloudsim as j_cloudsim
import repro.multicloud as j_mc
from repro.core import RecommendationEngine as JEngine
from repro.core import ResourceRequest as JReq
from repro.core.usqs import BudgetedProbeScheduler as JScheduler
from repro.operator import ChaosReplay as JReplay
from repro.operator import ChaosSchedule as JSchedule
from repro.serve import DeviceArchive as JArchive
import repro_torch.multicloud as p_mc
from repro_torch.cloudsim import (Catalog, CollectorConfig, DataCollector,
                                  QueryLimitExceeded, SpotMarket,
                                  SPSQueryService)
from repro_torch.core import RecommendationEngine, ResourceRequest
from repro_torch.core.usqs import BudgetedProbeScheduler
from repro_torch.multicloud import (SETUPS, MarketFederation, MergedCatalog,
                                    ScenarioConfig, ScenarioEngine, VENDORS,
                                    adapter_for, build_region, compare_setup,
                                    get_vendor)
from repro_torch.multicloud.adapters import (AwsSpsAdapter,
                                             AzureEvictionAdapter,
                                             GcpPreemptionAdapter)
from repro_torch.operator import ChaosReplay, ChaosSchedule
from repro_torch.serve import DeviceArchive
from repro_torch.shard import ShardedArchive, check_bounds

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from benchmarks import multiregion_compare as bench  # noqa: E402
from _score_helpers import ATOL, RTOL  # noqa: E402

CPU = "cpu"
WINDOW = 6
ALL_REGIONS = [(v, r) for v, vp in j_mc.VENDORS.items()
               for r in vp.region_names(None)]


@pytest.fixture(scope="module")
def engine():
    return RecommendationEngine(device=CPU)


@pytest.fixture(scope="module")
def jengine():
    return JEngine()


def _config(mc, **overrides):
    base = dict(vendors=("aws", "gcp"), regions_per_vendor=2,
                types_per_region=3, azs_per_region=1, period_min=10.0)
    base.update(overrides)
    return mc.ScenarioConfig(**base)


def _scenario(**overrides):
    return ScenarioEngine(_config(p_mc, **overrides))


def _both(**overrides):
    return (j_mc.ScenarioEngine(_config(j_mc, **overrides)),
            ScenarioEngine(_config(p_mc, **overrides)))


def _requests(cls=ResourceRequest):
    return [cls(cpus=24.0, weight=0.3), cls(cpus=96.0, weight=0.7, lam=0.2),
            cls(memory_gb=64.0, weight=0.5)]


def _assert_bitwise_equal(a, b, ctx=""):
    assert list(a.names) == list(b.names), ctx
    assert list(a.regions) == list(b.regions), ctx
    assert list(a.azs) == list(b.azs), ctx
    np.testing.assert_array_equal(a.counts, b.counts, err_msg=ctx)
    np.testing.assert_array_equal(a.combined, b.combined, err_msg=ctx)
    np.testing.assert_array_equal(a.availability, b.availability, err_msg=ctx)
    np.testing.assert_array_equal(a.cost, b.cost, err_msg=ctx)
    assert a.hourly_cost == b.hourly_cost, ctx


def _assert_same_as_reference(port, ref, ctx=""):
    """The port's pool against the reference's: members, counts and cost
    exactly (no F1 tie on these seeds), scores at the scoring suites'
    RTOL / ATOL (the two packages' float32 sums may part by an ulp)."""
    assert list(port.names) == [str(x) for x in ref.names], ctx
    assert list(port.regions) == [str(x) for x in ref.regions], ctx
    assert list(port.azs) == [str(x) for x in ref.azs], ctx
    np.testing.assert_array_equal(port.counts, np.asarray(ref.counts),
                                  err_msg=ctx)
    assert port.hourly_cost == ref.hourly_cost, ctx
    for name in ("combined", "availability", "cost"):
        np.testing.assert_allclose(
            getattr(port, name), np.asarray(getattr(ref, name)),
            rtol=RTOL, atol=ATOL, err_msg=f"{ctx} {name}")


def _collector_state(coll):
    return (coll.ticks, list(coll.times),
            {t: list(v) for t, v in coll.t3_archive.items()},
            coll._ring.copy(), coll._ring_len, coll.missing_responses)


def _assert_collectors_equal(a, b):
    sa, sb = _collector_state(a), _collector_state(b)
    assert sa[:3] == sb[:3] and sa[4:] == sb[4:]
    assert sa[3].dtype == sb[3].dtype
    np.testing.assert_array_equal(sa[3], sb[3])
    assert list(a.targets) == list(b.targets)
    assert a.region_bounds == b.region_bounds


# ---------------------------------------------------------------------------
# vendor profiles + vendor-salted seeding
# ---------------------------------------------------------------------------

def test_vendor_registry():
    assert set(VENDORS) == set(j_mc.VENDORS) == {"aws", "azure", "gcp"}
    for name, vp in VENDORS.items():
        jvp = j_mc.VENDORS[name]
        assert (vp.name, vp.market_profile, vp.signal,
                vp.region_query_limit) == (jvp.name, jvp.market_profile,
                                           jvp.signal, jvp.region_query_limit)
        assert dict(vp.categories) == dict(jvp.categories)
        assert dict(vp.regions) == dict(jvp.regions)
        assert dict(vp.utc_offsets) == dict(jvp.utc_offsets)
        assert vp.region_names(1)
        assert vp.signal in ("sps", "eviction", "preemption")
        adapter_for(vp.signal)
    assert get_vendor("azure").market_profile == "azure"
    with pytest.raises(KeyError):
        get_vendor("oracle")


def test_region_names_globally_unique():
    seen = {}
    for vp in VENDORS.values():
        for r in vp.region_names(None):
            assert r not in seen, f"{r} in both {seen.get(r)} and {vp.name}"
            seen[r] = vp.name
    assert len(seen) == len(ALL_REGIONS) == 38


@pytest.mark.parametrize("vendor,region", ALL_REGIONS,
                         ids=[f"{v}/{r}" for v, r in ALL_REGIONS])
def test_region_world_equals_reference(vendor, region):
    """One (vendor, region) world in both packages: the same catalog,
    prices and capacity traces, bit for bit."""
    cat, mkt = build_region(vendor, region, seed=0)
    jcat, jmkt = j_mc.build_region(vendor, region, seed=0)
    assert [(t.name, t.family, t.category, t.vcpus, t.memory_gb)
            for t in cat.types] == [(t.name, t.family, t.category, t.vcpus,
                                     t.memory_gb) for t in jcat.types]
    assert cat.azs(region) == jcat.azs(region)
    assert cat.utc_offset(region) == jcat.utc_offset(region)
    for t in cat.types:
        assert cat.spot_price(t.name, region) == \
            jcat.spot_price(t.name, region)
        assert cat.on_demand_price(t.name, region) == \
            jcat.on_demand_price(t.name, region)
    assert [(t.name, r, a) for t, r, a in mkt.pool_keys] == \
        [(t.name, r, a) for t, r, a in jmkt.pool_keys]
    np.testing.assert_array_equal(mkt._base, jmkt._base)
    idx = np.arange(len(mkt.pool_keys))
    for t in (0.0, 123.0, 999.0, 4321.0):
        np.testing.assert_array_equal(mkt.free(t, idx), jmkt.free(t, idx))
    keys = [(t.name, r, a) for t, r, a in mkt.pool_keys[::7]]
    for t in (0.0, 600.0):
        assert [mkt.sps(*k, 1, t=t) for k in keys] == \
            [jmkt.sps(*k, 1, t=t) for k in keys]
    assert [mkt.interruption_free_score(n, r) for n, r, _ in keys] == \
        [jmkt.interruption_free_score(n, r) for n, r, _ in keys]


def test_build_region_deterministic():
    _, m1 = build_region("gcp", "us-central1", seed=3)
    _, m2 = build_region("gcp", "us-central1", seed=3)
    np.testing.assert_array_equal(m1._base, m2._base)
    idx = np.arange(len(m1.pool_keys))
    for t in (0.0, 123.0, 999.0):
        np.testing.assert_array_equal(m1.free(t, idx), m2.free(t, idx))


def test_regions_with_identical_configs_diverge():
    c1, m1 = build_region("gcp", "us-central1", seed=0)
    c2, m2 = build_region("gcp", "us-east1", seed=0)
    assert [t.name for t in c1.types] == [t.name for t in c2.types]
    idx = np.arange(min(len(m1.pool_keys), len(m2.pool_keys)))
    assert not np.array_equal(m1.free(100.0, idx), m2.free(100.0, idx))


def test_vendor_salt_diverges_from_unsalted():
    plain = SpotMarket(Catalog(seed=0, n_regions=1), seed=0)
    salted = SpotMarket(Catalog(seed=0, n_regions=1, vendor="aws"),
                        seed=0, vendor="aws")
    idx = np.arange(min(len(plain.pool_keys), len(salted.pool_keys)))
    assert not np.array_equal(plain.free(50.0, idx), salted.free(50.0, idx))


# ---------------------------------------------------------------------------
# signal adapters
# ---------------------------------------------------------------------------

ADAPTERS = [(AwsSpsAdapter, j_mc.AwsSpsAdapter),
            (AzureEvictionAdapter, j_mc.AzureEvictionAdapter),
            (GcpPreemptionAdapter, j_mc.GcpPreemptionAdapter)]


@pytest.mark.parametrize("cls,jcls", ADAPTERS, ids=["aws", "azure", "gcp"])
def test_adapter_monotone_consistent(cls, jcls):
    adapter, jadapter = cls(t_max=50), jcls(t_max=50)
    fs = np.linspace(0.0, 50.0, 201)
    raw = [adapter.raw_from_free(f) for f in fs]
    assert raw == [jadapter.raw_from_free(f) for f in fs]
    vals = [adapter.normalize(r) for r in raw]
    assert vals == [jadapter.normalize(r) for r in raw]
    assert all(b >= a for a, b in zip(vals, vals[1:]))
    assert min(vals) >= 0 and max(vals) <= 50
    assert all(float(v).is_integer() for v in vals)
    assert vals[0] == 0 and vals[-1] == 50
    assert adapter.normalize(None) is None


@pytest.mark.parametrize("vendor,region", [("aws", "us-east-1"),
                                           ("azure", "eastus"),
                                           ("gcp", "us-central1")])
def test_adapter_probes_equal_reference(vendor, region):
    """Live probes over a day of one region: the same raw and normalised
    values, and on Azure the same missing responses."""
    signal = VENDORS[vendor].signal
    adapter, jadapter = adapter_for(signal), j_mc.adapter_for(signal)
    _, mkt = build_region(vendor, region, seed=5)
    _, jmkt = j_mc.build_region(vendor, region, seed=5)
    targets = [(t.name, r, a) for t, r, a in mkt.pool_keys[::3]]
    missing = 0
    for t in np.arange(0.0, 1440.0, 60.0):
        raw = [adapter.probe(mkt, k, t=t) for k in targets]
        assert raw == [jadapter.probe(jmkt, k, t=t) for k in targets]
        assert [adapter.sample(mkt, k, t=t) for k in targets] == \
            [jadapter.sample(jmkt, k, t=t) for k in targets]
        missing += sum(r is None for r in raw)
    assert (missing > 0) == (vendor == "azure")


def test_adapter_for_unknown_signal():
    with pytest.raises(KeyError):
        adapter_for("tea-leaves")


def test_azure_adapter_missing_response():
    class DarkMarket:
        def sps(self, *a, **kw):
            return None
    adapter = AzureEvictionAdapter(t_max=50)
    assert adapter.probe(DarkMarket(), ("x", "eastus", "a")) is None
    assert adapter.sample(DarkMarket(), ("x", "eastus", "a")) is None


def test_azure_gaps_carry_forward_with_finite_archive():
    jeng, eng = _both(vendors=("azure",), regions_per_vendor=2,
                      types_per_region=4, azs_per_region=2, seed=1)
    jeng.warmup(30)
    eng.warmup(30)
    coll = eng.collector
    _assert_collectors_equal(coll, jeng.collector)
    assert coll.missing_responses > 0
    assert coll.ticks == 30
    assert all(len(s) == 30 for s in coll.t3_archive.values())
    for i in range(coll.ticks):
        col = coll.column(i)
        np.testing.assert_array_equal(col, jeng.collector.column(i))
        assert np.all(np.isfinite(col))
        assert np.all((col >= 0) & (col <= eng.scenario.t_max))


def test_rolling_archive_gets_finite_stats_every_tick(engine, jengine):
    jeng, eng = _both(vendors=("azure", "gcp"), regions_per_vendor=1, seed=2)
    for e in (jeng, eng):
        e.warmup(WINDOW)
    ing = eng.build_ingestor(window=WINDOW, sharded=False, device=CPU)
    jing = jeng.build_ingestor(window=WINDOW, sharded=False)
    ing.prime()
    jing.prime()
    for _ in range(5):
        jeng.warmup(1)
        eng.warmup(1)
        ing.poll()
        jing.poll()
        stats = ing.archive.score_stats()
        assert torch.isfinite(stats.area).all()
        assert torch.isfinite(stats.slope).all()
        rec = engine.recommend_batch(ing.archive.host,
                                     [ResourceRequest(cpus=16.0)],
                                     archive=ing.archive)[0]
        jrec = jengine.recommend_batch(jing.archive.host, [JReq(cpus=16.0)],
                                       archive=jing.archive)[0]
        assert rec.num_types >= 1
        _assert_same_as_reference(rec, jrec)


# ---------------------------------------------------------------------------
# budget-aware probe scheduling
# ---------------------------------------------------------------------------

def _plans(cls, keys, budget, cycles, **kw):
    sched = cls(region_keys=keys, budget_per_cycle=budget, **kw)
    return [sched.plan(c) for c in range(cycles)], sched


def test_scheduler_holds_global_budget():
    keys = [f"r{i // 4}" for i in range(12)]
    (plans, sched), (jplans, _) = (_plans(c, keys, 5, 6) for c in
                                   (BudgetedProbeScheduler, JScheduler))
    assert plans == jplans
    for plan in plans:
        assert len(plan) == 5 and len(set(plan)) == len(plan)
    assert set().union(*plans) == set(range(12))
    assert int(sched.staleness(6).max()) <= math.ceil(12 / 5)


def test_scheduler_rotates_under_uniform_staleness():
    sched = BudgetedProbeScheduler(region_keys=["r"] * 9, budget_per_cycle=3)
    assert sched.plan(0) == [0, 1, 2]
    assert sched.plan(1) == [3, 4, 5]
    assert sched.plan(2) == [6, 7, 8]


def test_scheduler_respects_region_limits():
    keys = ["a"] * 4 + ["b"] * 4
    (plans, _), (jplans, _) = (_plans(c, keys, 4, 8, region_limits={"a": 1})
                               for c in (BudgetedProbeScheduler, JScheduler))
    assert plans == jplans
    for plan in plans:
        assert len(plan) <= 4
        assert sum(1 for k in plan if keys[k] == "a") <= 1


def test_scheduler_validates_budget():
    with pytest.raises(ValueError):
        BudgetedProbeScheduler(region_keys=["r"], budget_per_cycle=0)


def _scheduled_collector(pkg_cls):
    Cat, Mkt, Svc, Col, Cfg, Sched = pkg_cls
    mkt = Mkt(Cat(seed=5, n_regions=2), seed=5)
    svc = Svc(mkt, n_accounts=3000)
    targets = [(t.name, r, az) for (t, r, az) in mkt.pool_keys[:8]]
    sched = Sched(region_keys=[rg for _, rg, _ in targets],
                  budget_per_cycle=3)
    col = Col(svc, targets, Cfg(ring_capacity=16, scheduler=sched))
    col.run(6)
    return col, sched


def test_data_collector_scheduler_integration():
    col, sched = _scheduled_collector((Catalog, SpotMarket, SPSQueryService,
                                       DataCollector, CollectorConfig,
                                       BudgetedProbeScheduler))
    jcol, jsched = _scheduled_collector((
        j_cloudsim.Catalog, j_cloudsim.SpotMarket, j_cloudsim.SPSQueryService,
        j_cloudsim.DataCollector, j_cloudsim.CollectorConfig, JScheduler))
    assert col.ticks == 6
    assert all(q == 3 for q in sched.queries_issued)
    assert list(sched.queries_issued) == list(jsched.queries_issued)
    assert col.t3_archive == jcol.t3_archive and col.times == jcol.times
    for series in col.t3_archive.values():
        assert len(series) == 6


# ---------------------------------------------------------------------------
# int8 host ring + SPS region quotas
# ---------------------------------------------------------------------------

def test_ring_dtype_validation():
    with pytest.raises(ValueError):
        CollectorConfig(ring_dtype="int4")
    with pytest.raises(ValueError):
        CollectorConfig(ring_dtype="int8", t_max=200)
    CollectorConfig(ring_dtype="int8", t_max=127)


def test_int8_ring_exact_roundtrip():
    def make(dtype):
        mkt = SpotMarket(Catalog(seed=7, n_regions=1), seed=7)
        svc = SPSQueryService(mkt, n_accounts=3000)
        targets = [(t.name, r, az) for (t, r, az) in mkt.pool_keys[:10]]
        kw = {} if dtype is None else {"ring_dtype": dtype}
        return DataCollector(svc, targets,
                             CollectorConfig(ring_capacity=16, **kw))
    i8, f64 = make("int8"), make(None)
    for _ in range(8):
        for c in (i8, f64):
            c.collect_once()
            c.market.advance(c.market.now + 10.0)
    for i in range(8):
        a, b = i8.column(i), f64.column(i)
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(i8.to_candidate_set(window=8).t3,
                                  f64.to_candidate_set(window=8).t3)


def test_sps_region_quota():
    mkt = SpotMarket(Catalog(seed=0, n_regions=1), seed=0)
    region = mkt.pool_keys[0][1]
    svc = SPSQueryService(mkt, n_accounts=3000, region_limits={region: 2})
    (t0, r0, a0), (t1, _, a1) = mkt.pool_keys[0][:3], mkt.pool_keys[1][:3]
    svc.query(t0.name, r0, a0, 1)
    svc.query(t0.name, r0, a0, 1)
    svc.query(t1.name, r0, a1, 1)
    with pytest.raises(QueryLimitExceeded):
        svc.query(t1.name, r0, a1, 5)


# ---------------------------------------------------------------------------
# scenario collector
# ---------------------------------------------------------------------------

def test_targets_region_contiguous():
    jeng, eng = _both()
    bounds = eng.region_bounds
    assert bounds == jeng.region_bounds
    assert eng.collector.targets == jeng.collector.targets
    assert bounds[0][0] == 0 and bounds[-1][1] == eng.n_targets
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    for (lo, hi), world in zip(bounds, eng.worlds):
        assert {rg for _, rg, _ in eng.collector.targets[lo:hi]} == \
            {world.region}


def test_collector_equals_reference_under_budget():
    """Three vendors, two regions each, a global budget with the vendors'
    per-region caps: plans, ring, columns, candidate sets bit-equal."""
    jeng, eng = _both(vendors=("aws", "azure", "gcp"), regions_per_vendor=2,
                      types_per_region=5, azs_per_region=2,
                      budget_per_cycle=9, seed=6, ring_capacity=16)
    for e in (jeng, eng):
        e.warmup(24)
    _assert_collectors_equal(eng.collector, jeng.collector)
    assert list(eng.scheduler.queries_issued) == \
        list(jeng.scheduler.queries_issued)
    np.testing.assert_array_equal(eng.scheduler.staleness(24),
                                  jeng.scheduler.staleness(24))
    for i in (0, 7, 8, 23, -1):       # t3_archive and ring paths
        np.testing.assert_array_equal(eng.collector.column(i),
                                      jeng.collector.column(i))
    for window in (None, 8, 16, 20):
        a = eng.collector.to_candidate_set(window=window)
        b = jeng.collector.to_candidate_set(window=window)
        for name in ("names", "regions", "azs", "families", "categories",
                     "vcpus", "memory_gb", "prices", "t3"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_collector_atomic_on_fault():
    boom = {"at": 3}

    def hook(tick):
        if tick == boom["at"]:
            raise RuntimeError("injected")
    eng = _scenario(vendors=("aws",), regions_per_vendor=1, fault_hook=hook)
    jeng = j_mc.ScenarioEngine(_config(j_mc, vendors=("aws",),
                                       regions_per_vendor=1))
    coll = eng.collector
    for _ in range(3):
        coll.collect_once()
    before = _collector_state(coll)
    with pytest.raises(RuntimeError):
        coll.collect_once()
    after = _collector_state(coll)
    assert after[:3] == before[:3] and after[4:] == before[4:]
    np.testing.assert_array_equal(after[3], before[3])
    boom["at"] = -1
    coll.collect_once()
    assert coll.ticks == 4
    for _ in range(4):
        jeng.collector.collect_once()
    _assert_collectors_equal(coll, jeng.collector)


def test_scenario_budget_scaling_holds():
    eng = _scenario(vendors=("aws",), regions_per_vendor=3,
                    types_per_region=4, azs_per_region=2, budget_per_cycle=7)
    eng.warmup(10)
    assert eng.n_targets == 24
    assert all(q <= 7 for q in eng.scheduler.queries_issued)
    assert int(eng.scheduler.staleness(10).max()) <= math.ceil(24 / 7)


def test_budget_scaling_rows_equal_reference_and_hold_gates():
    rows = p_mc.budget_scaling(**bench.BUDGET_SMOKE)
    assert rows == j_mc.budget_scaling(**bench.BUDGET_SMOKE)
    assert [r["regions"] for r in rows] == [1, 4, 17]
    assert bench._gate_failures({}, rows) == []


# ---------------------------------------------------------------------------
# market federation
# ---------------------------------------------------------------------------

def test_merged_catalog_rejects_duplicate_regions():
    eng = _scenario(vendors=("aws",), regions_per_vendor=1)
    with pytest.raises(ValueError, match="more than one world"):
        MergedCatalog(eng.worlds + eng.worlds)


def _federation_trace(eng):
    fed = eng.federation
    w_aws, w_gcp = eng.worlds[0], eng.worlds[2]
    ta, tg = w_aws.targets[0], w_gcp.targets[0]
    ok_a, ids_a = fed.request_spot(*ta, 2)
    ok_g, ids_g = fed.request_spot(*tg, 1)
    counts = (len(w_aws.market.records), len(w_gcp.market.records))
    alive = [fed.node(i).alive for i in ids_a + ids_g]
    fed.terminate([ids_a[1]])
    after_terminate = [fed.node(i).alive for i in ids_a]
    fed.advance(fed.now + 30.0)
    lockstep = all(w.market.now == fed.now for w in eng.worlds)
    cursor = len(fed.interruptions)
    events = fed.reclaim(*tg, 1)
    fresh, end = fed.events_since(cursor)
    return dict(
        ok=(ok_a, ok_g), ids=(ids_a, ids_g), counts=counts, alive=alive,
        after_terminate=after_terminate, lockstep=lockstep,
        events=[(e.node_id, e.end_t, e.reason) for e in events],
        fresh_is_events=fresh == events, end=end,
        reclaimed_alive=fed.node(ids_g[0]).alive,
        records=[(r.node_id, r.pool_idx, r.launch_t, r.end_t, r.reason)
                 for r in fed.records])


def test_federation_routes_and_remaps_ids():
    jeng, eng = _both()
    t, jt = _federation_trace(eng), _federation_trace(jeng)
    assert t == jt
    (ids_a, ids_g) = t["ids"]
    assert t["ok"] == (True, True)
    assert eng.worlds[0].vendor.name == "aws"
    assert eng.worlds[2].vendor.name == "gcp"
    assert ids_g[0] == len(ids_a)
    assert t["counts"] == (2, 1) and all(t["alive"])
    assert t["after_terminate"] == [True, False]
    assert t["lockstep"] and len(t["events"]) == 1 and t["fresh_is_events"]
    assert not t["reclaimed_alive"]


def test_federation_catalog_prices_match_worlds():
    eng = _scenario()
    fed = eng.federation
    for w in eng.worlds:
        ty, rg, _az = w.targets[0]
        assert fed.catalog.spot_price(ty, rg) == w.catalog.spot_price(ty, rg)
        assert fed.catalog.utc_offset(rg) == w.catalog.utc_offset(rg)
        assert fed.catalog.get(ty) == w.catalog.get(ty)
    assert fed.catalog.regions == j_mc.ScenarioEngine(
        _config(j_mc)).federation.catalog.regions
    with pytest.raises(KeyError):
        fed.catalog.spot_price("anything", "atlantis-north-1")


# ---------------------------------------------------------------------------
# region-sharded serving == one ring == the reference
# ---------------------------------------------------------------------------

def _parity_world(mc):
    eng = mc.ScenarioEngine(mc.ScenarioConfig(
        vendors=("aws", "gcp"), regions_per_vendor=3, types_per_region=3,
        azs_per_region=1, period_min=10.0, seed=4))
    eng.warmup(8)
    return eng


@pytest.fixture(scope="module")
def parity_engine():
    return _parity_world(p_mc)


@pytest.fixture(scope="module")
def jparity_engine():
    return _parity_world(j_mc)


def test_region_sharded_snapshot_parity(engine, jengine, parity_engine,
                                        jparity_engine):
    eng, jeng = parity_engine, jparity_engine
    assert len(eng.region_bounds) == 6
    cands = eng.collector.to_candidate_set(window=WINDOW)
    jcands = jeng.collector.to_candidate_set(window=WINDOW)
    np.testing.assert_array_equal(cands.t3, jcands.t3)
    reqs = _requests()
    single = engine.recommend_batch(
        cands, reqs, archive=DeviceArchive.stage(cands, device=CPU))
    sharded = engine.recommend_batch(
        cands, reqs, archive=ShardedArchive.stage(
            cands, bounds=eng.region_bounds, devices=[CPU]))
    ref = jengine.recommend_batch(jcands, _requests(JReq),
                                  archive=JArchive.stage(jcands))
    for i, (a, b, r) in enumerate(zip(sharded, single, ref)):
        _assert_bitwise_equal(a, b, ctx=f"snapshot request {i}")
        _assert_same_as_reference(a, r, ctx=f"snapshot request {i}")


def test_region_sharded_rolling_parity(engine, jengine):
    eng, jeng = _parity_world(p_mc), _parity_world(j_mc)
    reqs, jreqs = _requests(), _requests(JReq)
    sharded_ing = eng.build_ingestor(window=WINDOW, sharded=True, device=CPU)
    single_ing = eng.build_ingestor(window=WINDOW, sharded=False,
                                    name="single-ref", device=CPU)
    jing = jeng.build_ingestor(window=WINDOW, sharded=True)
    for ing in (sharded_ing, single_ing, jing):
        ing.prime()
    assert sharded_ing.archive.is_sharded
    assert sharded_ing.archive.n_shards == 6
    assert sharded_ing.archive.bounds == eng.region_bounds
    for tick in range(4):
        eng.warmup(1)
        jeng.warmup(1)
        assert sharded_ing.poll() == 1 and single_ing.poll() == 1
        jing.poll()
        a_batch = engine.recommend_batch(sharded_ing.archive.host, reqs,
                                         archive=sharded_ing.archive)
        b_batch = engine.recommend_batch(single_ing.archive.host, reqs,
                                         archive=single_ing.archive)
        r_batch = jengine.recommend_batch(jing.archive.host, jreqs,
                                          archive=jing.archive)
        for i, (a, b, r) in enumerate(zip(a_batch, b_batch, r_batch)):
            _assert_bitwise_equal(a, b, ctx=f"tick {tick} request {i}")
            _assert_same_as_reference(a, r, ctx=f"tick {tick} request {i}")
        for x, y in zip(engine.score_archive(sharded_ing.archive),
                        engine.score_archive(single_ing.archive)):
            np.testing.assert_array_equal(x, y)


def test_benchmark_parity_world_on_the_port(engine):
    """``multiregion_compare.parity_failures``'s world and requests (6
    region shards, warmup 10, window 8, 3 rolling ticks) on the port."""
    eng = ScenarioEngine(ScenarioConfig(seed=0, **bench.PARITY))
    eng.warmup(10)
    reqs = [ResourceRequest(cpus=24.0, weight=0.3),
            ResourceRequest(cpus=96.0, weight=0.7, lam=0.2),
            ResourceRequest(memory_gb=128.0, weight=0.5)]
    cands = eng.collector.to_candidate_set(window=8)
    single = engine.recommend_batch(
        cands, reqs, archive=DeviceArchive.stage(cands, device=CPU))
    sharded = engine.recommend_batch(cands, reqs, archive=ShardedArchive.stage(
        cands, bounds=eng.region_bounds, devices=[CPU]))
    fails = [i for i, (a, b) in enumerate(zip(sharded, single))
             if not bench._rec_equal(a, b)]
    s_ing = eng.build_ingestor(window=8, sharded=True, device=CPU)
    o_ing = eng.build_ingestor(window=8, sharded=False, device=CPU,
                               name="multicloud-single")
    s_ing.prime()
    o_ing.prime()
    for tick in range(3):
        eng.warmup(1)
        s_ing.poll()
        o_ing.poll()
        a = engine.recommend_batch(s_ing.archive.host, reqs,
                                   archive=s_ing.archive)
        b = engine.recommend_batch(o_ing.archive.host, reqs,
                                   archive=o_ing.archive)
        fails += [(tick, i) for i, (x, y) in enumerate(zip(a, b))
                  if not bench._rec_equal(x, y)]
    assert fails == []
    assert bench.parity_failures() == []     # and the reference's own gate


def test_check_bounds_validation():
    assert check_bounds([(0, 2), (2, 5)], 5) == ((0, 2), (2, 5))
    for bad in ([(1, 5)], [(0, 2), (3, 5)], [(0, 3), (2, 5)],
                [(0, 2), (2, 2), (2, 5)], [(0, 4)]):
        with pytest.raises(ValueError):
            check_bounds(bad, 5)


# ---------------------------------------------------------------------------
# closed loop + the paper's §6.4 comparison
# ---------------------------------------------------------------------------

def test_multicloud_chaos_replay_end_to_end():
    reports = []
    for mc, Replay, Schedule, kw in ((j_mc, JReplay, JSchedule, {}),
                                     (p_mc, ChaosReplay, ChaosSchedule,
                                      {"device": CPU})):
        eng = mc.ScenarioEngine(_config(mc, period_min=30.0))
        Req = JReq if mc is j_mc else ResourceRequest
        replay = Replay(
            market=eng.federation, collector=eng.collector,
            window=WINDOW, warmup_cycles=WINDOW, cycles=8, period_min=30.0,
            requests=[Req(cpus=32.0, weight=0.5)],
            schedule=Schedule(reclaims={3: 2}),
            shard_bounds=eng.region_bounds, **kw)
        reports.append((replay.run("multicloud-smoke"),
                        len(eng.federation.records)))
    (jrep, jn), (rep, n) = reports
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep) and n == jn
    assert 0.0 <= rep.delivered_availability <= 1.0
    assert rep.interruptions >= 2
    assert rep.stranded_tickets == 0 and rep.worker_alive_at_end
    assert n > 0


@pytest.mark.parametrize("setup", list(SETUPS))
def test_compare_setup_smoke_equals_reference(setup):
    """``multiregion_compare.py --smoke --check``'s comparison on the port:
    every policy's result, the availability gate, the committed floor."""
    res = compare_setup(setup, **bench.SMOKE, device=CPU)
    jres = j_mc.compare_setup(setup, **bench.SMOKE)
    assert set(res) == set(jres) == set(p_mc.POLICIES)
    for policy in res:
        assert res[policy].to_dict() == jres[policy].to_dict(), policy
    dicts = {setup: {p: r.to_dict() for p, r in res.items()}}
    assert bench._gate_failures(dicts, []) == []
    committed = json.loads(bench.ARTIFACT.read_text())
    assert committed["gates_passed"]
    floor = (committed["smoke_setups"][setup]["spotvista"]["availability"]
             - bench.AVAIL_REGRESSION)
    assert res["spotvista"].availability >= floor
    assert res["spotvista"].availability >= res["spotfleet"].availability


def test_compare_setup_spotvista_beats_static_baselines():
    kw = dict(seed=0, period_min=30.0, types_per_region=3, window=6,
              warmup=8, cycles=10, amount=48.0)
    res = compare_setup("multi_cloud", device=CPU, **kw)
    jres = j_mc.compare_setup("multi_cloud", **kw)
    assert {p: r.to_dict() for p, r in res.items()} == \
        {p: r.to_dict() for p, r in jres.items()}
    assert set(res) == {"spotvista", "spotfleet", "spotfleet_lp", "spotverse"}
    sv = res["spotvista"]
    assert sv.interruptions > 0
    for name in ("spotfleet", "spotfleet_lp", "spotverse"):
        assert sv.availability >= res[name].availability
    assert 0.0 < sv.savings_pct < 100.0
    assert set(SETUPS) == {"single_region", "multi_az", "multi_region",
                           "multi_cloud"}


# ---------------------------------------------------------------------------
# the port's device surface
# ---------------------------------------------------------------------------

def test_build_ingestor_takes_the_device_it_is_given():
    eng = _scenario()
    eng.warmup(4)
    ing = eng.build_ingestor(window=4, device=CPU)
    ing.prime()
    assert ing.archive.is_sharded
    assert {s.device.type for s in ing.archive.shards} == {"cpu"}
    assert ing.cache.device.type == "cpu"


def test_cuda_without_cuda_raises(monkeypatch):
    eng = _scenario()
    eng.warmup(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            eng.build_ingestor(window=4, device=device)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            p_mc.replay_spotvista(eng, setup="x", window=4, warmup=0,
                                  cycles=1, amount=8.0, device=device)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compare_setup("single_region", policies=("spotvista",), warmup=2,
                      window=2, cycles=1, types_per_region=2)
