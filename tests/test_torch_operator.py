"""The closed-loop operator in the port (``repro_torch.operator``) against
``repro.operator``.

``tests/test_operator.py``'s scenarios run twice on the same seeds: once
in the reference (JAX on the CPU) and once in the port with
``device="cpu"`` (the kernels' plain PyTorch versions).  What is held:

- the CMDB after registration, adoption, reclaims and syncs (pool ids,
  signatures, rosters, lifetimes, end times and reasons), the survival
  fits, the migration plans and the risk verdicts are equal to the
  reference's, given the same inputs;
- the operator's counters after retried, exhausted and recovered ingests,
  and after a capacity-loss refill, are the reference's;
- ``ChaosReplay`` at ``benchmarks/operator_replay.py``'s SMOKE size (12
  cycles, 24 targets, window 8, warmup 8) gives the reference's
  ``ReplayReport`` field by field for the benchmark's three scenarios, the
  benchmark's gates hold, and delivered availability stays within
  ``DELIVERY_REGRESSION`` of the committed ``BENCH_operator.json``;
- the reference's own assertions hold on the port, the port's
  ``ChaosReplay`` runs clean under the port's ``torch_racecheck`` fixture
  (``tests/_torch_racecheck.py``), and asking
  for CUDA without it raises.

Scores, pools and reports came out bit-equal on these seeds; a pool that
differed would have to be an F1 tie (ROADMAP C), and none is.
"""
import dataclasses
import json
import sys
import threading
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.cloudsim as j_cloudsim
import repro.core as j_core
import repro.operator as j_operator
import repro.stream as j_stream
from repro.core.survival import fit_survival_model as j_fit_survival
from repro.operator.risk import archive_scores as j_archive_scores
from repro.operator.risk import assess_pool as j_assess_pool
import repro_torch.cloudsim as p_cloudsim
import repro_torch.core as p_core
import repro_torch.operator as p_operator
import repro_torch.stream as p_stream
from repro_torch.core.survival import fit_survival_model as p_fit_survival
from repro_torch.operator.risk import archive_scores as p_archive_scores
from repro_torch.operator.risk import assess_pool as p_assess_pool

from _torch_racecheck import torch_racecheck  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from benchmarks import operator_replay as bench  # noqa: E402

WINDOW = 8
#: wall-clock waits for the threaded tests: seconds, never tens of ms
WAIT_S = 30.0


def _pkg(cloudsim, core, operator, stream, fit, archive_scores, assess,
         dev):
    return SimpleNamespace(
        Catalog=cloudsim.Catalog, SpotMarket=cloudsim.SpotMarket,
        SPSQueryService=cloudsim.SPSQueryService,
        DataCollector=cloudsim.DataCollector,
        CollectorConfig=cloudsim.CollectorConfig,
        EngineConfig=core.EngineConfig, Req=core.ResourceRequest,
        Operator=operator.Operator, OperatorConfig=operator.OperatorConfig,
        ChaosReplay=operator.ChaosReplay, ChaosSchedule=operator.ChaosSchedule,
        CollectorOutage=operator.CollectorOutage,
        StaleArchiveWarning=operator.StaleArchiveWarning,
        build_migration_plan=operator.build_migration_plan,
        LiveIngestor=stream.LiveIngestor, AdmissionQueue=stream.AdmissionQueue,
        fit_survival=fit, archive_scores=archive_scores, assess_pool=assess,
        dev=dev)


REF = _pkg(j_cloudsim, j_core, j_operator, j_stream, j_fit_survival,
           j_archive_scores, j_assess_pool, {})
PORT = _pkg(p_cloudsim, p_core, p_operator, p_stream, p_fit_survival,
            p_archive_scores, p_assess_pool, {"device": "cpu"})


def _world(pkg, seed=3, n_targets=32, cycles=WINDOW, period_min=10.0,
           profile="aws"):
    mkt = pkg.SpotMarket(pkg.Catalog(seed=seed, n_regions=2), seed=seed,
                         profile=profile)
    svc = pkg.SPSQueryService(mkt, n_accounts=3000)
    step = max(len(mkt.pool_keys) // n_targets, 1)
    targets = [(t.name, r, az)
               for (t, r, az) in mkt.pool_keys[::step]][:n_targets]
    col = pkg.DataCollector(svc, targets,
                            pkg.CollectorConfig(period_min=period_min,
                                                ring_capacity=32))
    for _ in range(cycles):
        col.collect_once()
        mkt.advance(mkt.now + period_min)
    return mkt, col


def _stack(pkg, mkt, col, *, op_cfg=None, collect=None, sleep=None,
           buckets=(1, 2, 4)):
    server = pkg.EngineConfig().build_server(bucket_sizes=buckets, **pkg.dev)
    ing = pkg.LiveIngestor(col, window=WINDOW, cache=server.cache, **pkg.dev)
    ing.prime()
    op = pkg.Operator(server, ing, mkt,
                      config=op_cfg or pkg.OperatorConfig(backoff_base_s=0.0),
                      collect=collect,
                      sleep=sleep if sleep is not None else (lambda s: None))
    return server, ing, op


def _both(fn, **kw):
    """``fn(pkg, **kw)`` on the reference, then on the port."""
    return fn(REF, **kw), fn(PORT, **kw)


def _cmdb_view(cmdb):
    """Everything the CMDB holds, as plain values."""
    out = []
    for pid, p in sorted(cmdb.pools.items()):
        rec = p.recommendation
        out.append((
            pid, p.pool_id, p.request.signature(), p.issued_t,
            p.recommended_availability, p.active, p.rerecommendations,
            p.last_action_cycle, p.interrupted_total,
            [str(x) for x in rec.names], [str(x) for x in rec.regions],
            [str(x) for x in rec.azs], [int(c) for c in rec.counts],
            [float(a) for a in rec.availability],
            [(m.node_id, m.type_name, m.region, m.az, m.capacity, m.launch_t,
              m.launch_score, m.end_t, m.reason)
             for _, m in sorted(p.members.items())],
            None if p.plan is None else _plan_view(p.plan)))
    return out


def _plan_view(plan):
    return (plan.pool_id, plan.created_t, plan.reason, plan.executed_phases,
            [([(tuple(k), n) for k, n in ph.launches],
              list(ph.retire_node_ids)) for ph in plan.phases])


def _report(rep):
    return {**dataclasses.asdict(rep), "delivery_gap": rep.delivery_gap}


def _schedule(pkg, ref_schedule):
    """The benchmark's (reference) schedule as ``pkg``'s ChaosSchedule."""
    return pkg.ChaosSchedule(**{f.name: getattr(ref_schedule, f.name)
                                for f in dataclasses.fields(ref_schedule)})


# ---------------------------------------------------------------------------
# CMDB: registration, adoption, sync, lifetimes
# ---------------------------------------------------------------------------

def _registration(pkg):
    mkt, col = _world(pkg)
    server, ing, op = _stack(pkg, mkt, col)
    server.serve(ing.archive, [pkg.Req(cpus=32.0), pkg.Req(memory_gb=64.0)])
    first = len(op.cmdb), [p.active for p in op.cmdb.pools.values()]
    server.serve(ing.archive, [pkg.Req(cpus=32.0)])
    return first, _cmdb_view(op.cmdb)


def test_result_sink_registers_every_recommendation():
    ref, port = _both(_registration)
    assert port == ref
    (n, active), view = port
    assert n == 2 and not any(active)
    assert len(view) == 2 and view[0][6] == 1     # one re-recommendation


def _launch_and_sync(pkg):
    mkt, col = _world(pkg)
    server, ing, op = _stack(pkg, mkt, col)
    pool = op.launch(pkg.Req(cpus=48.0))
    launched = (pool.active, pool.alive_capacity, pool.delivered_fraction())
    victim = pool.alive_members[0]
    mkt.reclaim(victim.type_name, victim.region, victim.az, 1)
    deaths = op.cmdb.sync(mkt)
    again = op.cmdb.sync(mkt)
    dead = [(m.node_id, m.end_t, m.reason) for m in deaths[pool.pool_id]]
    return (launched, dead, pool.interrupted_total, again,
            _cmdb_view(op.cmdb), op.stats.launches)


def test_launch_adopts_pool_and_sync_observes_interruptions():
    ref, port = _both(_launch_and_sync)
    assert port == ref
    (active, cap, frac), dead, interrupted, again, _, _ = port
    assert active and cap >= 48.0 and frac == 1.0
    assert len(dead) == 1 and dead[0][2] == "interrupted"
    assert interrupted == 1 and again == {}


def _lifetimes(pkg):
    mkt, col = _world(pkg)
    server, ing, op = _stack(pkg, mkt, col)
    pool = op.launch(pkg.Req(cpus=24.0))
    m = pool.alive_members[0]
    mkt.advance(mkt.now + 30.0)
    mkt.reclaim(m.type_name, m.region, m.az, 1)
    op.cmdb.sync(mkt)
    first = op.cmdb.lifetimes(mkt.now)
    mkt.terminate([pool.alive_members[0].node_id])
    op.cmdb.sync(mkt)
    second = op.cmdb.lifetimes(mkt.now)
    return len(pool.members), first, second


def test_lifetimes_table_censoring():
    ref, port = _both(_lifetimes)
    assert port[0] == ref[0]
    for a, b in zip(port[1] + port[2], ref[1] + ref[2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    n, (x, dur, ev), (_, _, ev2) = port
    assert len(x) == n and ev.sum() == 1 and (dur > 0).all()
    assert ev2.sum() == 1          # an operator-driven terminate is censored


# ---------------------------------------------------------------------------
# ingest backoff
# ---------------------------------------------------------------------------

def _transient(pkg):
    mkt, col = _world(pkg)
    fails = {"n": 2}

    def flaky():
        if fails["n"] > 0:
            fails["n"] -= 1
            raise pkg.CollectorOutage("transient")
        col.collect_once()

    server, ing, op = _stack(pkg, mkt, col, collect=flaky)
    mkt.advance(mkt.now + 10.0)
    op.reconcile_once()
    return (dataclasses.asdict(op.stats), ing.archive.stale, ing.lag,
            ing.version)


def test_transient_collect_fault_is_retried_not_stale():
    ref, port = _both(_transient)
    assert port == ref
    stats, stale, lag, _ = port
    assert stats["ingest_failures"] == 2 and stats["stale_cycles"] == 0
    assert stale is False and lag == 0


def _exhausted(pkg):
    mkt, col = _world(pkg)
    down = {"on": True}

    def feed():
        if down["on"]:
            raise pkg.CollectorOutage("hard outage")
        col.collect_once()

    sleeps = []
    server, ing, op = _stack(
        pkg, mkt, col, buckets=(1, 2), collect=feed, sleep=sleeps.append,
        op_cfg=pkg.OperatorConfig(backoff_base_s=0.01, max_retries=2))
    v0 = ing.version
    with pytest.warns(pkg.StaleArchiveWarning):
        op.reconcile_once()
    after_one = (dataclasses.asdict(op.stats), ing.archive.stale,
                 ing.version == v0, list(sleeps))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        op.reconcile_once()            # same streak: no second warning
    stale_cycles = op.stats.stale_cycles
    down["on"] = False
    op.reconcile_once()
    return (after_one, stale_cycles, ing.archive.stale, ing.version > v0,
            dataclasses.asdict(op.stats))


def test_exhausted_retries_degrade_to_stale_then_recover():
    ref, port = _both(_exhausted)
    assert port == ref
    (stats, stale, same_version, sleeps), stale_cycles, stale_end, moved, _ \
        = port
    assert stats["stale_cycles"] == 1 and stats["ingest_failures"] == 3
    assert stale is True and same_version
    assert len(sleeps) == 2
    assert 0.0075 <= sleeps[0] <= 0.0125 and 0.015 <= sleeps[1] <= 0.025
    assert stale_cycles == 2
    assert stale_end is False and moved


def _stale_diagnostics(pkg):
    mkt, col = _world(pkg)
    server, ing, op = _stack(pkg, mkt, col)
    ing.mark_stale()
    q = pkg.AdmissionQueue(server, lambda: ing.archive, max_wait_s=0.0)
    t = q.submit(pkg.Req(cpus=16.0))
    q.drain(force=True)
    col.collect_once()
    ing.poll()
    t2 = q.submit(pkg.Req(cpus=16.0))
    q.drain(force=True)
    return (t.result().diagnostics["stale_archive"],
            t2.result().diagnostics["stale_archive"])


def test_stale_archive_stamps_served_diagnostics():
    ref, port = _both(_stale_diagnostics)
    assert port == ref == (True, False)


# ---------------------------------------------------------------------------
# risk -> re-recommendation -> phased migration
# ---------------------------------------------------------------------------

def _refill(pkg):
    mkt, col = _world(pkg)
    server, ing, op = _stack(
        pkg, mkt, col, collect=col.collect_once,
        op_cfg=pkg.OperatorConfig(backoff_base_s=0.0, cooldown_cycles=0))
    pool = op.launch(pkg.Req(cpus=48.0))
    left = max(1, len(pool.alive_members) // 2 + 1)
    for key, n in pool.alive_by_key().items():
        if left <= 0:
            break
        left -= len(mkt.reclaim(*key, min(n, left)))
    unsynced = pool.delivered_fraction()
    mkt.advance(mkt.now + 10.0)
    for _ in range(6):
        op.reconcile_once()
        if pool.delivered_fraction() >= 1.0 and (
                pool.plan is None or pool.plan.done):
            break
    return (unsynced, dataclasses.asdict(op.stats), pool.delivered_fraction(),
            _cmdb_view(op.cmdb))


def test_capacity_loss_triggers_rerecommendation_and_refill():
    ref, port = _both(_refill)
    assert port == ref
    unsynced, stats, frac, _ = port
    assert unsynced == 1.0                  # the CMDB had not synced yet
    assert stats["rerecommendations"] >= 1
    assert stats["risk_triggers"].get("capacity_lost", 0) >= 1
    assert stats["migrations_planned"] >= 1
    assert frac == pytest.approx(1.0)


def _plan_with_floor(pkg):
    mkt, col = _world(pkg)
    server, ing, op = _stack(pkg, mkt, col)
    pool = op.launch(pkg.Req(cpus=64.0))
    target = server.serve(ing.archive, [pool.request])[0]
    for m in pool.alive_members[: max(2, len(pool.alive_members) // 3)]:
        mkt.terminate([m.node_id])
    op.cmdb.sync(mkt)
    plan = pkg.build_migration_plan(
        pool, target, now=mkt.now, reason="test",
        max_concurrent_replacements=3, quorum_floor=0.5,
        catalog=mkt.catalog)
    alive = {m.node_id: m.capacity for m in pool.alive_members}
    return _plan_view(plan), alive, pool.amount, mkt


def test_migration_plan_phases_and_quorum_floor():
    ref, port = _both(_plan_with_floor)
    assert port[:3] == ref[:3]
    (pid, _, _, _, phases), alive, amount, mkt = port
    assert sum(sum(n for _, n in la) + len(rt) for la, rt in phases) >= 2
    cap, floor = sum(alive.values()), 0.5 * amount
    for launches, retires in phases:
        assert sum(n for _, n in launches) + len(retires) <= 3
        for (ty, _, _), n in launches:
            cap += n * mkt.catalog.get(ty).vcpus
        for nid in retires:
            cap -= alive[nid]
            assert cap >= floor


def _plan_uncorrelated(pkg):
    mkt, col = _world(pkg)
    server, ing, op = _stack(pkg, mkt, col)
    pool = op.launch(pkg.Req(cpus=32.0))
    target = server.serve(ing.archive, [pool.request])[0]
    keys = [(str(t), str(r), str(a)) for t, r, a in
            zip(target.names, target.regions, target.azs)]
    fams = {k: mkt.catalog.get(k[0]).family for k in keys}
    correlated = {(fams[k], k[2]) for k in keys[1:]}
    for m in pool.alive_members:
        mkt.terminate([m.node_id])
    op.cmdb.sync(mkt)
    plan = pkg.build_migration_plan(
        pool, target, now=mkt.now, reason="test",
        max_concurrent_replacements=2, quorum_floor=0.0,
        catalog=mkt.catalog, correlated=correlated)
    first = tuple(plan.phases[0].launches[0][0])
    return _plan_view(plan), (fams[first], first[2]) in correlated


def test_migration_plan_prefers_uncorrelated_markets():
    ref, port = _both(_plan_uncorrelated)
    assert port == ref
    assert port[1] is False


def _risk_verdicts(pkg):
    """Every pool's verdict with and without a survival model, on one
    stack after a launch, a reclaim and a re-scoring."""
    mkt, col = _world(pkg)
    server, ing, op = _stack(pkg, mkt, col)
    pools = [op.launch(pkg.Req(cpus=48.0)),
             op.launch(pkg.Req(memory_gb=96.0, weight=0.3))]
    server.serve(ing.archive, [pkg.Req(cpus=24.0, weight=0.8)])
    for pool in pools:                      # over half of each roster
        left = len(pool.alive_members) // 2 + 1
        for key, n in pool.alive_by_key().items():
            if left > 0:
                left -= len(mkt.reclaim(*key, min(n, left)))
    mkt.advance(mkt.now + 40.0)
    op.cmdb.sync(mkt)
    scores = pkg.archive_scores(server.engine, ing.archive)
    model = pkg.fit_survival(*op.cmdb.lifetimes(mkt.now))
    verdicts = []
    for m in (None, model):
        for pool in op.cmdb.pools.values():
            verdicts.append(dataclasses.asdict(pkg.assess_pool(
                pool, scores, model=m, horizon=60.0, now=mkt.now,
                risk_threshold=0.85)))
    return scores, verdicts, (model.n_events, model.cox.hazard_ratio)


def test_risk_assessments_equal_reference():
    (j_scores, j_verdicts, j_model), (scores, verdicts, model) = \
        _both(_risk_verdicts)
    assert list(scores) == list(j_scores)
    assert np.array_equal(np.array(list(scores.values()), np.float32),
                          np.array(list(j_scores.values()), np.float32))
    assert verdicts == j_verdicts and model == j_model
    assert {v["reason"] for v in verdicts if v["triggered"]} >= {
        "capacity_lost"}


# ---------------------------------------------------------------------------
# survival model
# ---------------------------------------------------------------------------

def test_survival_model_degenerate_and_direction():
    m0, j0 = (f([50.0, 60.0], [10.0, 20.0], [0, 0])
              for f in (p_fit_survival, j_fit_survival))
    assert m0.n_events == j0.n_events == 0
    assert m0.survival(15.0, 55.0) == j0.survival(15.0, 55.0) == \
        pytest.approx(1.0)
    rng = np.random.default_rng(0)
    x = rng.uniform(10, 90, 200)
    dur = rng.exponential(50 * np.exp(0.03 * (x - 50)))
    m, j = (f(x, dur, np.ones(200, bool))
            for f in (p_fit_survival, j_fit_survival))
    assert m.cox.hazard_ratio == j.cox.hazard_ratio < 1.0
    for t, xi in ((30.0, 90.0), (30.0, 10.0), (5.0, 50.0), (120.0, 70.0)):
        assert m.survival(t, xi) == j.survival(t, xi)
    assert m.survival(30.0, 90.0) > m.survival(30.0, 10.0)


def _score_archive(pkg):
    mkt, col = _world(pkg)
    server, ing, op = _stack(pkg, mkt, col)
    comb, avail, cost = server.engine.score_archive(ing.archive)
    rec = server.serve(ing.archive, [pkg.Req(cpus=64.0)])[0]
    return (np.asarray(comb), np.asarray(avail), np.asarray(cost),
            ing.archive.host, rec)


def test_score_archive_matches_recommendation_scores():
    ref, port = _both(_score_archive)
    comb, avail, cost, host, rec = port
    for a, b in zip(port[:3], ref[:3]):
        assert a.shape == b.shape == (len(host),)
        np.testing.assert_array_equal(a, b)
    assert np.isfinite(comb).all()
    idx = {(str(t), str(r), str(a)): i for i, (t, r, a) in
           enumerate(zip(host.names, host.regions, host.azs))}
    for ty, rg, az, a_s in zip(rec.names, rec.regions, rec.azs,
                               rec.availability):
        np.testing.assert_allclose(avail[idx[(str(ty), str(rg), str(az))]],
                                   a_s, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# failing drains resolve tickets and keep the worker alive
# ---------------------------------------------------------------------------

def _failing_drain(pkg):
    mkt, col = _world(pkg)
    server, ing, _ = _stack(pkg, mkt, col)
    calls = {"n": 0}
    real_serve = server.serve

    def raise_on_second(target, requests, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected: dispatch died mid-drain")
        return real_serve(target, requests, **kw)

    server.serve = raise_on_second
    q = pkg.AdmissionQueue(server, lambda: ing.archive, max_wait_s=0.01)
    q.start()
    try:
        t1 = q.submit(pkg.Req(cpus=16.0))
        n1 = t1.result(timeout=WAIT_S).num_types
        t2 = q.submit(pkg.Req(cpus=24.0))
        with pytest.raises(RuntimeError, match="injected"):
            t2.result(timeout=WAIT_S)
        alive = q.running
        t3 = q.submit(pkg.Req(cpus=32.0))
        n3 = t3.result(timeout=WAIT_S).num_types
    finally:
        q.stop()
    s = q.stats
    return (n1, alive, n3, s.failed_drains, s.failed, s.submitted, s.served,
            s.shed, all(t.done for t in (t1, t2, t3)))


def test_failing_drain_resolves_tickets_and_worker_survives():
    ref, port = _both(_failing_drain)
    assert port == ref
    n1, alive, n3, failed_drains, failed, submitted, served, shed, done = port
    assert n1 >= 1 and alive and n3 >= 1 and done
    assert failed_drains == 1 and failed == 1
    assert submitted == served + shed + failed


# ---------------------------------------------------------------------------
# azure missing-response gaps through the rolling archive
# ---------------------------------------------------------------------------

def _azure_gaps(pkg):
    mkt, col = _world(pkg, seed=11, profile="azure")
    server, ing, _ = _stack(pkg, mkt, col)
    keys, finite = set(), True
    for _ in range(12):
        mkt.advance(mkt.now + 10.0)
        col.collect_once()
        ing.poll()
        keys.add(ing.archive.key)
        finite &= all(np.isfinite(np.asarray(a)).all()
                      for a in ing.archive.score_stats())
    rows = server.engine.score_archive(ing.archive)
    return (len(keys), finite, [np.asarray(r) for r in rows],
            ing.archive.materialize())


def test_azure_gap_ticks_keep_rolling_stats_finite():
    ref, port = _both(_azure_gaps)
    n_keys, finite, rows, window = port
    assert n_keys == ref[0] == 12 and finite and ref[1]
    np.testing.assert_array_equal(window, np.asarray(ref[3], np.float32))
    for a, b in zip(rows, ref[2]):
        assert np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)


def _azure_invalidates(pkg):
    mkt, col = _world(pkg, seed=13, profile="azure")
    server, ing, _ = _stack(pkg, mkt, col)
    old_key = ing.archive.key
    before = server.cache._entries.get(old_key) is ing.archive
    mkt.advance(mkt.now + 10.0)
    col.collect_once()
    ing.poll()
    return (before, old_key not in server.cache._entries,
            server.cache._entries.get(ing.archive.key) is ing.archive)


def test_azure_gap_tick_invalidates_cached_version():
    ref, port = _both(_azure_invalidates)
    assert port == ref == (True, True, True)


# ---------------------------------------------------------------------------
# chaos replay, end to end
# ---------------------------------------------------------------------------

def _full_menu(pkg):
    return pkg.ChaosSchedule(
        collector_outages=frozenset({2}), delayed_ticks=frozenset({4}),
        reclaims={1: 4, 5: 6}, failing_drains=frozenset({3}))


def _replay(pkg, schedule=None, name="replay"):
    return pkg.ChaosReplay(seed=7, n_targets=24, window=6, warmup_cycles=6,
                           cycles=8, schedule=schedule, **pkg.dev).run(name)


def test_chaos_replay_full_fault_menu():
    ref, port = (_replay(p, _full_menu(p), "everything") for p in (REF, PORT))
    assert _report(port) == _report(ref)
    assert port.stranded_tickets == 0 and port.worker_alive_at_end
    assert port.unresolved_pools == 0
    assert port.interruptions >= 1 and port.rerecommendations >= 1
    assert port.failed_drains >= 1
    assert port.failed_tickets == port.failed_drains
    assert port.stale_cycles >= 1
    assert 0.0 < port.delivered_availability <= 1.0


def test_chaos_replay_no_fault_control_delivers_recommended():
    ref, port = (_replay(p, None, "no_fault") for p in (REF, PORT))
    assert _report(port) == _report(ref)
    assert port.stranded_tickets == 0 and port.worker_alive_at_end
    assert port.failed_drains == 0 and port.stale_cycles == 0
    assert port.delivered_availability >= \
        port.recommended_availability - 0.05


@pytest.mark.parametrize("scenario", list(bench.SCENARIOS))
def test_smoke_replay_equals_reference_and_holds_gates(scenario):
    """``operator_replay.py --smoke --check`` on the port: the reference's
    report field by field, the benchmark's gates, the committed floor."""
    kw, schedule = bench.SCENARIOS[scenario]
    ref_sched = schedule(bench.SMOKE["cycles"])
    ref = j_operator.ChaosReplay(seed=0, schedule=ref_sched, **bench.SMOKE,
                                 **kw).run(scenario)
    port = p_operator.ChaosReplay(seed=0, schedule=_schedule(PORT, ref_sched),
                                  device="cpu", **bench.SMOKE,
                                  **kw).run(scenario)
    assert _report(port) == _report(ref)
    assert bench._gate_failures({scenario: port}) == []
    committed = json.loads(bench.ARTIFACT.read_text())
    assert committed["gates_passed"]
    floor = (committed["smoke_scenarios"][scenario]["delivered_availability"]
             - bench.DELIVERY_REGRESSION)
    assert port.delivered_availability >= floor


def _daemon(pkg):
    mkt, col = _world(pkg)
    server, ing, op = _stack(
        pkg, mkt, col, collect=col.collect_once,
        op_cfg=pkg.OperatorConfig(backoff_base_s=0.0, period_s=0.01))
    op.start()
    try:
        running = op.running
        tick = threading.Event()
        waited = 0.0
        while op.stats.cycles < 3 and waited < WAIT_S:
            tick.wait(0.05)
            waited += 0.05
        cycles = op.stats.cycles
    finally:
        op.stop()
    return running, cycles, op.running


def test_operator_daemon_thread_lifecycle():
    running, cycles, after = _daemon(PORT)
    assert running and cycles >= 3 and not after


def test_chaos_replay_under_racecheck_is_clean(torch_racecheck):
    from repro_torch.analysis.racecheck import (instrument_admission_queue,
                                                instrument_cmdb,
                                                instrument_fault_server,
                                                instrument_server)
    rep = p_operator.ChaosReplay(seed=7, n_targets=24, window=6,
                                 warmup_cycles=6, cycles=8,
                                 schedule=_full_menu(PORT), device="cpu")
    instrument_server(torch_racecheck, rep.server)
    instrument_fault_server(torch_racecheck, rep.faulty)
    instrument_admission_queue(torch_racecheck, rep.queue)
    instrument_cmdb(torch_racecheck, rep.operator.cmdb)
    report = rep.run("racecheck")
    assert report.stranded_tickets == 0 and report.worker_alive_at_end
    assert torch_racecheck.problems() == []
    assert _report(report) == _report(_replay(REF, _full_menu(REF),
                                              "racecheck"))


# ---------------------------------------------------------------------------
# the port's own surface
# ---------------------------------------------------------------------------

def test_chaos_replay_takes_the_device_it_is_given():
    rep = p_operator.ChaosReplay(seed=7, n_targets=12, window=4,
                                 warmup_cycles=4, cycles=1, device="cpu")
    assert rep.device == torch.device("cpu")
    assert rep.server.engine.device.type == "cpu"
    assert rep.server.cache.device.type == "cpu"
    assert rep.ingestor.archive.device.type == "cpu"


def test_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p_operator.ChaosReplay(seed=7, n_targets=12, window=4,
                               warmup_cycles=4, cycles=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        p_operator.ChaosReplay(seed=7, n_targets=12, window=4,
                               warmup_cycles=4, cycles=1, device="cuda")
