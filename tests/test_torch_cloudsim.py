"""The port's spot-market simulator (``repro_torch.cloudsim``) against
``repro.cloudsim``.

The catalog, market, probes and collector are the reference's numpy code,
so on the same seeds everything is held equal bit for bit: capacity
fields, SPS answers and ``t3_true`` for every pool on all three profiles
and with a vendor salt; request / advance / reclaim event logs; T3 and T2
archives in every collector mode, ring dtype, with a probe scheduler and
across an aborted tick; probes and baselines.  The SPS service keeps its
quota windows incrementally, so it is held on routing: per-account window
sets, ``total_queries``, ``capacity_remaining()`` and the query that raises
(account exhaustion, 24 h expiry, region limits); and a counter pins that
a query inspects a bounded number of accounts whatever ``n_accounts`` is.
"""
from dataclasses import astuple

import numpy as np
import pytest

from repro.cloudsim import (Catalog as JCatalog,
                            CollectorConfig as JCollectorConfig,
                            DataCollector as JCollector,
                            QueryLimitExceeded as JLimit,
                            SpotMarket as JMarket,
                            SPSQueryService as JService,
                            probe_real_availability as jprobe,
                            run_interruption_experiment as jinterrupt)
from repro.cloudsim import sps as jsps
from repro.core import baselines as jbase
from repro.core.usqs import BudgetedProbeScheduler as JScheduler
from repro_torch import convert
from repro_torch.cloudsim import (Catalog, CollectorConfig, DataCollector,
                                  QueryLimitExceeded, SpotMarket,
                                  SPSQueryService, probe_real_availability,
                                  run_interruption_experiment)
from repro_torch.core import baselines
from repro_torch.core.types import CandidateSet
from repro_torch.core.usqs import BudgetedProbeScheduler

PROFILES = ["aws", "azure", "gcp"]


def markets(seed=2, n_regions=2, profile="aws", vendor=None):
    return (SpotMarket(Catalog(seed=seed, n_regions=n_regions, vendor=vendor),
                       seed=seed, profile=profile, vendor=vendor),
            JMarket(JCatalog(seed=seed, n_regions=n_regions, vendor=vendor),
                    seed=seed, profile=profile, vendor=vendor))


def record(rec):
    return (rec.node_id, rec.pool_idx, rec.launch_t, rec.end_t, rec.reason)


# ---------------------------------------------------------------------------
# catalog and market
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vendor", [None, "acme"])
@pytest.mark.parametrize("profile", PROFILES)
def test_capacity_and_sps_bit_equal(profile, vendor):
    m, jm = markets(profile=profile, vendor=vendor)
    assert [(t.name, r, az) for t, r, az in m.pool_keys] == \
        [(t.name, r, az) for t, r, az in jm.pool_keys]
    for name in ("_base", "_daily_amp", "_weekly_amp", "_daily_phase",
                 "_weekly_phase", "_trend", "_noise_amp", "_noise_phase",
                 "_regime_amp", "_regime_period"):
        np.testing.assert_array_equal(getattr(m, name), getattr(jm, name))
    cat, jcat = m.catalog, jm.catalog
    for t, r, _ in m.pool_keys[::97]:
        assert cat.spot_price(t.name, r) == jcat.spot_price(t.name, r)
        assert cat.on_demand_price(t.name, r) == jcat.on_demand_price(t.name, r)
    for t in (0.0, 333.0, 1440.0 * 3 + 17.0, 10080.0 * 2.5):
        np.testing.assert_array_equal(m.capacity(t), jm.capacity(t))
        np.testing.assert_array_equal(m.free(t), jm.free(t))
        for it, r, az in m.pool_keys[::23]:
            assert m.t3_true(it.name, r, az, t=t) == \
                jm.t3_true(it.name, r, az, t=t)
            for n in (1, 7, 30, 50):
                assert m.sps(it.name, r, az, n, t=t) == \
                    jm.sps(it.name, r, az, n, t=t)
    it, r, _ = m.pool_keys[5]
    assert m.interruption_free_score(it.name, r, t=5000.0) == \
        jm.interruption_free_score(it.name, r, t=5000.0)


@pytest.mark.parametrize("profile", PROFILES)
def test_request_advance_reclaim_logs_equal(profile):
    m, jm = markets(seed=6, n_regions=1, profile=profile)
    pools = [p for p in m.pool_keys if m.t3_true(p[0].name, p[1], p[2]) >= 12]
    targets = [(t.name, r, az) for t, r, az in pools[:6]]
    for tgt in targets:
        assert m.request_spot(*tgt, 10) == jm.request_spot(*tgt, 10)
    assert m.request_spot(*targets[0], 10_000) == \
        jm.request_spot(*targets[0], 10_000)
    m.terminate([0, 1, 2])
    jm.terminate([0, 1, 2])
    got = m.advance(m.now + 3 * 1440.0)
    want = jm.advance(jm.now + 3 * 1440.0)
    assert [record(x) for x in got] == [record(x) for x in want]
    for tgt in targets[1:4]:
        got, want = m.reclaim(*tgt, 3), jm.reclaim(*tgt, 3)
        assert [record(x) for x in got] == [record(x) for x in want]
    for cursor in (0, 2, 5):
        (ev, c), (jev, jc) = m.events_since(cursor), jm.events_since(cursor)
        assert c == jc and [record(x) for x in ev] == [record(x) for x in jev]
    assert [record(x) for x in m.records] == [record(x) for x in jm.records]
    assert [record(m.node(i)) for i in range(len(m.records))] == \
        [record(jm.node(i)) for i in range(len(jm.records))]
    np.testing.assert_array_equal(m._used, jm._used)


# ---------------------------------------------------------------------------
# the rate-limited SPS service
# ---------------------------------------------------------------------------

def _drive_services(svc, jsvc, m, jm, keys, rng, steps, step_min):
    """Issue a seeded query trace through both services, advancing both
    markets; after each step hold routing state equal."""
    raised = 0
    for _ in range(steps):
        for _ in range(int(rng.integers(0, 12))):
            it, r, az = keys[int(rng.integers(len(keys)))]
            n = int(rng.integers(1, 8))
            got = want = err = jerr = None
            try:
                got = svc.query(it.name, r, az, n)
            except QueryLimitExceeded as e:
                err = str(e)
            try:
                want = jsvc.query(it.name, r, az, n)
            except JLimit as e:
                jerr = str(e)
            assert (got, err) == (want, jerr)
            raised += err is not None
        assert svc.total_queries == jsvc.total_queries
        assert svc.capacity_remaining() == jsvc.capacity_remaining()
        for i in range(svc.n_accounts):
            assert svc.in_window(i) == jsvc.accounts[i].distinct_in_window(
                jm.now)
        for region, log in jsvc._region_log.items():
            assert svc.region_in_window(region) == \
                log.distinct_in_window(jm.now)
        m.advance(m.now + step_min)
        jm.advance(jm.now + step_min)
    return raised


@pytest.mark.parametrize("n_accounts,limit,region_limits", [
    (1, 5, None), (12, 6, None), (30, 4, {"us-east-1": 90}),
    (200, 50, {"us-east-1": 40, "us-west-2": 25}),
])
def test_sps_service_routes_as_the_reference(n_accounts, limit,
                                             region_limits):
    m, jm = markets(seed=7, n_regions=2)
    svc = SPSQueryService(m, n_accounts, limit, region_limits)
    jsvc = JService(jm, n_accounts, limit, region_limits)
    keys = m.pool_keys[::41]
    # 25 min steps over 3 days: windows fill, exhaust and expire
    raised = _drive_services(svc, jsvc, m, jm, keys,
                             np.random.default_rng(n_accounts), 170, 25.0)
    assert svc.total_queries > 0
    if n_accounts * limit < 100 or region_limits:
        assert raised > 0       # the trace reaches a limit that raises


def test_sps_repeat_scenario_is_free():
    m, _ = markets(seed=7, n_regions=1)
    svc = SPSQueryService(m, n_accounts=1, scenario_limit=5)
    it, r, az = m.pool_keys[0]
    for n in range(1, 6):
        svc.query(it.name, r, az, n)
    svc.query(it.name, r, az, 3)
    with pytest.raises(QueryLimitExceeded):
        svc.query(it.name, r, az, 6)
    m.advance(m.now + 1440.0)
    assert svc.capacity_remaining() == 5      # the window expired
    assert svc.query(it.name, r, az, 6) in (1, 2, 3)


@pytest.mark.parametrize("n_accounts", [150, 1500, 15_000])
def test_quota_book_inspects_bounded_accounts_per_query(n_accounts,
                                                        monkeypatch):
    """About 120 accounts' windows fill a day; the reference walks them
    from the first at every query, the port's book inspects a bounded
    number (counted on the book, amortised) for any ``n_accounts``."""
    walked = [0]
    real = jsps._Account.distinct_in_window

    def counting(self, now):
        walked[0] += 1
        return real(self, now)
    monkeypatch.setattr(jsps._Account, "distinct_in_window", counting)
    m, jm = markets(seed=9, n_regions=2)
    svc = SPSQueryService(m, n_accounts=n_accounts, scenario_limit=5)
    jsvc = JService(jm, n_accounts=150, scenario_limit=5)
    keys = [(it.name, r, az, n) for it, r, az in m.pool_keys[:200]
            for n in (5, 10, 15)]
    for i in range(3000):      # one query a minute, 2 days
        key = keys[(i * 7) % len(keys)]
        assert svc.query(*key) == jsvc.query(*key)
        m.advance(m.now + 1.0)
        jm.advance(jm.now + 1.0)
    assert svc.book.accounts_holding() > 100
    assert svc.book.inspected <= 3 * svc.total_queries
    assert walked[0] >= 30 * jsvc.total_queries


# ---------------------------------------------------------------------------
# the collector
# ---------------------------------------------------------------------------

def collectors(mode, *, seed=8, n_accounts=300, profile="aws", every=17,
               n_targets=30, **cfg):
    m, jm = markets(seed=seed, n_regions=1, profile=profile)
    targets = [(t.name, r, az) for t, r, az in m.pool_keys[::every][:n_targets]]
    sched = cfg.pop("budget", None)
    kw, jkw = dict(cfg), dict(cfg)
    if sched is not None:
        keys = [r for _, r, _ in targets]
        kw["scheduler"] = BudgetedProbeScheduler(keys, sched)
        jkw["scheduler"] = JScheduler(keys, sched)
    col = DataCollector(SPSQueryService(m, n_accounts), targets,
                        CollectorConfig(mode=mode, **kw))
    jcol = JCollector(JService(jm, n_accounts), targets,
                      JCollectorConfig(mode=mode, **jkw))
    return col, jcol


def assert_same_archive(col, jcol):
    assert col.times == jcol.times and col.ticks == jcol.ticks
    assert col.t3_archive == jcol.t3_archive
    assert col.t2_archive == jcol.t2_archive
    assert col.service.total_queries == jcol.service.total_queries
    for window in (None, 1, 5, 8):
        a, b = col.to_candidate_set(window=window), jcol.to_candidate_set(
            window=window)
        assert type(a) is CandidateSet
        for name in ("names", "regions", "azs", "families", "categories",
                     "vcpus", "memory_gb", "prices", "t3"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
            assert getattr(a, name).dtype == getattr(b, name).dtype


@pytest.mark.parametrize("mode,cycles,profile", [
    ("usqs", 25, "aws"), ("usqs", 25, "azure"), ("tstp", 12, "aws"),
    ("full", 6, "gcp"),
])
def test_collector_archives_equal_reference(mode, cycles, profile):
    col, jcol = collectors(mode, profile=profile)
    col.run(cycles)
    jcol.run(cycles)
    assert_same_archive(col, jcol)
    assert col.market.now == jcol.market.now


@pytest.mark.parametrize("ring_dtype", ["float64", "float32", "int16", "int8"])
def test_collector_ring_equals_reference(ring_dtype):
    col, jcol = collectors("usqs", ring_capacity=8, ring_dtype=ring_dtype,
                           budget=11)
    col.run(18)
    jcol.run(18)
    assert_same_archive(col, jcol)
    for i in (0, 5, 10, 17, -1):
        np.testing.assert_array_equal(col.column(i), jcol.column(i))
    with pytest.raises(IndexError):
        col.column(18)
    assert col.cfg.scheduler.queries_issued == jcol.cfg.scheduler.queries_issued
    # the port's LiveIngestor takes the port's candidate set as it is
    cands = col.to_candidate_set(window=8)
    assert convert.as_candidate_set(cands) is cands
    with pytest.raises(ValueError):
        CollectorConfig(ring_dtype="int8", t_max=200)
    with pytest.raises(ValueError):
        CollectorConfig(ring_dtype="uint8")


@pytest.mark.parametrize("mode,n_accounts", [("usqs", 4), ("tstp", 6)])
def test_aborted_tick_leaves_archive_as_reference(mode, n_accounts):
    """A raising ``fault_hook`` and a mid-tick quota raise commit nothing,
    in both packages, and a retried tick continues identically."""
    def hook(tick):
        if tick == 3 and not fired:
            fired.append(tick)
            raise RuntimeError("collector outage")
    fired = []
    col, jcol = collectors(mode, fault_hook=hook, ring_capacity=4,
                           n_accounts=n_accounts)
    for c in (col, jcol):
        fired.clear()
        errors = []
        for _ in range(8):
            try:
                c.collect_once()
            except (RuntimeError, QueryLimitExceeded, JLimit) as e:
                errors.append(type(e).__name__)
            c.market.advance(c.market.now + 10.0)
        c.errors = errors
        lens = {len(v) for v in c.t3_archive.values()}
        assert lens == {c.ticks}      # never ragged
    assert col.errors == jcol.errors and "RuntimeError" in col.errors
    assert any(e.endswith("QueryLimitExceeded") for e in col.errors)
    assert_same_archive(col, jcol)


# ---------------------------------------------------------------------------
# probes and baselines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("launch", [False, True])
def test_probe_real_availability_equals_reference(launch):
    m, jm = markets(seed=4, n_regions=1)
    targets = [(t.name, r, az) for t, r, az in m.pool_keys[::53][:6]]
    got = probe_real_availability(m, targets, n_nodes=10, period_min=30,
                                  duration_min=360, launch=launch)
    want = jprobe(jm, targets, n_nodes=10, period_min=30, duration_min=360,
                  launch=launch)
    assert [astuple(x) for x in got] == [astuple(x) for x in want]
    assert [x.real_availability for x in got] == \
        [x.real_availability for x in want]
    assert m.now == jm.now
    assert [record(x) for x in m.records] == [record(x) for x in jm.records]


def test_interruption_experiment_equals_reference():
    m, jm = markets(seed=4, n_regions=1)
    pools = [(t.name, r, az) for t, r, az in m.pool_keys[::29][:8]]
    scores = list(np.linspace(10.0, 90.0, len(pools)))
    got = run_interruption_experiment(m, pools, scores, n_nodes=6,
                                      horizon_min=2 * 1440.0)
    want = jinterrupt(jm, pools, scores, n_nodes=6, horizon_min=2 * 1440.0)
    for name in ("durations", "events", "covariates"):
        a, b = getattr(got, name), getattr(want, name)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert got.events.sum() > 0       # the horizon saw interruptions
    assert [record(x) for x in m.interruptions] == \
        [record(x) for x in jm.interruptions]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_baselines_equal_reference(seed):
    rng = np.random.default_rng(seed)
    K = 40
    sps = rng.integers(1, 4, K)
    if_s = rng.integers(1, 4, K)
    prices = np.round(rng.uniform(0.1, 3.0, K), 1)     # ties occur
    cap = rng.integers(0, 51, K).astype(np.float64)
    for threshold in (2, 4, 6, 7):
        a = baselines.spotverse_select(sps, if_s, prices, threshold)
        b = jbase.spotverse_select(sps, if_s, prices, threshold)
        assert (a.index, a.reason) == (b.index, b.reason)
    for strategy in ("lowest-price", "capacity-optimized",
                     "price-capacity-optimized"):
        a = baselines.spotfleet_select(strategy, prices, cap)
        b = jbase.spotfleet_select(strategy, prices, cap)
        assert (a.index, a.reason) == (b.index, b.reason)
    for metric in (sps, cap):
        a = baselines.naive_single_point(metric, prices)
        b = jbase.naive_single_point(metric, prices)
        assert (a.index, a.reason) == (b.index, b.reason)
    with pytest.raises(ValueError):
        baselines.spotfleet_select("fastest", prices, cap)


def test_baselines_pick_as_documented():
    sps = np.array([3, 3, 2, 1])
    if_s = np.array([3, 1, 3, 3])
    price = np.array([2.0, 1.0, 0.5, 0.1])
    assert baselines.spotverse_select(sps, if_s, price, threshold=4).index == 3
    assert baselines.spotverse_select(sps, if_s, price, threshold=6).index == 0
    assert baselines.spotfleet_select("lowest-price", price, sps).index == 3
    assert baselines.spotfleet_select(
        "capacity-optimized", price, np.array([10, 50, 50, 2])).index == 2
    assert baselines.naive_single_point(sps, price).index == 1


def test_sps_monotone_and_consistent_with_t3():
    m, _ = markets(seed=5, n_regions=2)
    for it, r, az in m.pool_keys[::173]:
        vals = [m.sps(it.name, r, az, n) for n in range(1, 51)]
        assert all(a >= b for a, b in zip(vals, vals[1:]))
        t3 = m.t3_true(it.name, r, az)
        if t3 >= 1:
            assert m.sps(it.name, r, az, t3) == 3
        if t3 < 50:
            assert m.sps(it.name, r, az, t3 + 1) < 3
