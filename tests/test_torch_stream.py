"""Live ingestion in the port (``repro_torch.stream``) against ``repro.stream``.

The ingest path on the CPU: the rolling archive's window semantics on every
storage tier, snapshots, versioned cache membership, the collector ->
engine loop, the admission queue and the ingest pump.  The reference's
simulated ``DataCollector`` feeds both packages.

What is held:

- the port's rolling archive against its own cold re-stage: identical
  pools at every version, scores at RTOL 1e-5 / ATOL 1e-4;
- against ``repro``'s rolling archive fed the same columns: the stored
  window, the versioned keys, ``nbytes`` and the clip counts bit-equal, the
  statistics within 1e-5 of each statistic's range (XLA's multiply-add
  contraction, see ``tests/test_torch_stats_update.py``);
- the ingest loop through both packages: the same pools at every version.
  A pool may differ only where a decision-margin replay puts an Algorithm 1
  decision within the two packages' score difference (a tie); ties are
  counted, and there are none on these seeds.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.analysis.racecheck import (instrument_admission_queue,
                                      instrument_pump, instrument_server)
from repro.cloudsim import (Catalog, CollectorConfig, DataCollector,
                            SpotMarket, SPSQueryService)
from repro.core import EngineConfig as JConfig
from repro.core import RecommendationEngine as JEngine
from repro.core import ResourceRequest as JReq
from repro.serve import BatchServer as JServer
from repro.stream import LiveIngestor as JIngestor
from repro.stream import RollingDeviceArchive as JRolling
from repro_torch import convert
from repro_torch.core import EngineConfig, RecommendationEngine, ResourceRequest
from repro_torch.core import scoring
from repro_torch.core.types import RequestBatch
from repro_torch.serve import ArchiveCache, BatchServer, DeviceArchive
from repro_torch.stream import (AdmissionQueue, ArchiveSnapshot, IngestPump,
                                LiveIngestor, RollingDeviceArchive)
from repro_torch.stream.admission import Ticket

from _score_helpers import ATOL, RTOL
from test_serve_batch import synth_candidates as _ref_candidates
from test_stream import FakeClock

WINDOW = 10
CPU = "cpu"
REQUESTS = [dict(cpus=128.0), dict(memory_gb=256.0, weight=0.8),
            dict(cpus=96.0, weight=0.3, lam=0.25), dict(cpus=200.0,
                                                        max_types=2),
            dict(cpus=500.0, weight=1.0), dict(cpus=16.0, weight=0.0)]


def synth_candidates(seed, K, T):
    return convert.as_candidate_set(_ref_candidates(seed=seed, K=K, T=T))


def _requests(cands, cls=ResourceRequest):
    return ([cls(**kw) for kw in REQUESTS]
            + [cls(cpus=64.0, regions=[str(cands.regions[0])])])


def _assert_same_pools(a, b):
    assert list(a.names) == list(b.names)
    assert list(a.regions) == list(b.regions)
    assert list(a.azs) == list(b.azs)
    np.testing.assert_array_equal(a.counts, b.counts)
    assert a.hourly_cost == b.hourly_cost
    np.testing.assert_allclose(a.combined, b.combined, rtol=RTOL, atol=ATOL)


def _collector(seed=3, n_targets=36, cycles=WINDOW, ring=32):
    mkt = SpotMarket(Catalog(seed=seed, n_regions=2), seed=seed)
    svc = SPSQueryService(mkt, n_accounts=3000)
    step = max(len(mkt.pool_keys) // n_targets, 1)
    targets = [(t.name, r, az)
               for (t, r, az) in mkt.pool_keys[::step]][:n_targets]
    col = DataCollector(svc, targets, CollectorConfig(ring_capacity=ring))
    col.run(cycles)
    return col


def _tiled_engine():
    return RecommendationEngine(EngineConfig(score_impl="tiled"), device=CPU)


def _cold(t3, cands):
    """A cold re-stage of ``cands`` (a copy) holding window ``t3``."""
    cold = convert.candidate_set_from_numpy(
        **{**vars(cands), "t3": np.asarray(t3, np.float64)})
    return cold, DeviceArchive.stage(cold, device=CPU)


# ---------------------------------------------------------------------------
# RollingDeviceArchive
# ---------------------------------------------------------------------------

def test_rolling_window_semantics():
    cands = synth_candidates(seed=1, K=17, T=6)
    arch = RollingDeviceArchive(cands, capacity=6, name="ring", device=CPU)
    rng = np.random.default_rng(0)
    host = np.asarray(cands.t3, np.float32)
    assert arch.key == "ring@v0" and arch.window_len == 6
    assert arch._buf.shape == (6, 17)            # slot-major ring
    for v in range(1, 9):                        # wraps the ring twice
        col = rng.uniform(0, 50, 17).astype(np.float32)
        host = np.concatenate([host[:, 1:], col[:, None]], axis=1)
        arch.append(col)
        assert arch.key == f"ring@v{v}"
        np.testing.assert_array_equal(arch.materialize(), host)


def test_rolling_growing_phase():
    cands = synth_candidates(seed=2, K=9, T=3)
    arch = RollingDeviceArchive(cands, capacity=5, device=CPU)
    host = np.asarray(cands.t3, np.float32)
    for i in range(4):                           # grows 3 -> 5, then slides
        col = np.full(9, float(i), np.float32)
        host = (np.concatenate([host, col[:, None]], axis=1)
                if host.shape[1] < 5 else
                np.concatenate([host[:, 1:], col[:, None]], axis=1))
        arch.append(col)
        assert arch.window_len == host.shape[1]
        np.testing.assert_array_equal(arch.materialize(), host)
        ref = scoring.candidate_stats(torch.as_tensor(host))
        for name, x, y in zip(("area", "slope", "std"), arch.score_stats(),
                              ref):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=name)


def test_rolling_single_slot_ring():
    """capacity 1: the new column is both the first and the last."""
    cands = synth_candidates(seed=9, K=5, T=1)
    arch = RollingDeviceArchive(cands, device=CPU)
    for v in range(3):
        col = np.arange(5, dtype=np.float32) + v
        arch.append(col)
        np.testing.assert_array_equal(arch.materialize(), col[:, None])
        np.testing.assert_array_equal(arch.score_stats().area.numpy(),
                                      0.5 * col)
        np.testing.assert_array_equal(arch.score_stats().std.numpy(),
                                      np.zeros(5))


def test_rolling_validation():
    cands = synth_candidates(seed=3, K=4, T=8)
    with pytest.raises(ValueError, match="capacity"):
        RollingDeviceArchive(cands, capacity=4, device=CPU)
    with pytest.raises(ValueError, match="archive precision"):
        RollingDeviceArchive(cands, device=CPU, precision="fp8")
    arch = RollingDeviceArchive(cands, device=CPU)
    with pytest.raises(ValueError, match="column shape"):
        arch.append(np.zeros(5))


def test_rolling_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RollingDeviceArchive(synth_candidates(seed=3, K=4, T=8))


def test_rolling_stats_track_recompute():
    cands = synth_candidates(seed=4, K=33, T=12)
    arch = RollingDeviceArchive(cands, device=CPU)
    rng = np.random.default_rng(7)
    for _ in range(30):
        arch.append(rng.uniform(0, 50, 33))
    ref = scoring.candidate_stats(torch.as_tensor(arch.materialize()))
    for name, x, y in zip(("area", "slope", "std"), arch.score_stats(), ref):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("score_impl", ["tiled", "dense"])
def test_rolling_archive_serves_like_cold_restage(score_impl):
    cands = synth_candidates(seed=5, K=48, T=WINDOW)
    arch = RollingDeviceArchive(cands, device=CPU)
    engine = RecommendationEngine(EngineConfig(score_impl=score_impl),
                                  device=CPU)
    rng = np.random.default_rng(1)
    reqs = _requests(cands)
    for _ in range(5):
        arch.append(rng.uniform(0, 50, 48))
        live = engine.recommend_batch(arch.host, reqs, archive=arch)
        cold_set, cold_arch = _cold(arch.materialize(), cands)
        cold = engine.recommend_batch(cold_set, reqs, archive=cold_arch)
        for a, b in zip(live, cold):
            _assert_same_pools(a, b)


@pytest.mark.parametrize("precision", ["float32", "bfloat16", "int8"])
def test_rolling_tier_matches_reference(precision):
    """Both packages' rolling archives take the same 40 columns (growing
    first, then sliding past a wrap): the stored window, keys, ``nbytes``
    and clip counts are bit-equal, the statistics within 1e-5 of range."""
    ref_cands = _ref_candidates(seed=8, K=50, T=12)
    rng = np.random.default_rng(13)
    kw = dict(capacity=20, name="tier", precision=precision, headroom=1.0)
    jarch = JRolling(ref_cands, **kw)
    tarch = RollingDeviceArchive(convert.as_candidate_set(ref_cands),
                                 device=CPU, **kw)
    for i in range(40):
        # a few samples past the seed's range: int8 clips and counts them
        col = rng.uniform(0, 55, 50)
        jarch.append(col)
        tarch.append(col)
        if i in (0, 7, 8, 39):
            assert tarch.key == jarch.key
            assert tarch.window_len == jarch.window_len
            np.testing.assert_array_equal(tarch.materialize(),
                                          jarch.materialize())
            for name, a, b in zip(("area", "slope", "std"),
                                  tarch.score_stats(), jarch.score_stats()):
                b = np.asarray(b, np.float64)
                err = np.abs(a.numpy() - b).max()
                assert err <= 1e-5 * np.ptp(b), name
    assert tarch.clipped_samples == jarch.clipped_samples
    assert (tarch.clipped_samples > 0) == (precision == "int8")
    assert tarch.nbytes == jarch.nbytes
    if precision != "float32":
        assert tarch.key.endswith("#" + precision)


def test_snapshot_survives_version_bumps():
    """A snapshot pins its version: the parent may absorb further ticks
    while the snapshot keeps serving the same bits."""
    cands = synth_candidates(seed=6, K=40, T=WINDOW)
    arch = RollingDeviceArchive(cands, name="pin", device=CPU)
    engine = _tiled_engine()
    reqs = _requests(cands)
    rng = np.random.default_rng(2)
    arch.append(rng.uniform(0, 50, 40))
    snap = arch.snapshot()
    kept = [x.clone() for x in snap.stats]
    want = engine.recommend_batch(snap.host, reqs, archive=snap)
    for _ in range(3):                      # bump versions under the snapshot
        arch.append(rng.uniform(0, 50, 40))
    assert snap.version == 1 and arch.version == 4
    assert snap.key != arch.key
    for a, b in zip(snap.stats, kept):
        assert torch.equal(a, b)
    got = engine.recommend_batch(snap.host, reqs, archive=snap)
    for a, b in zip(got, want):
        _assert_same_pools(a, b)
        np.testing.assert_array_equal(a.combined, b.combined)
    with pytest.raises(RuntimeError, match="tiled scoring stage only"):
        _ = snap.t3
    # auto resolves to dense at this K; the window-less snapshot must be
    # scored tiled instead of touching .t3
    auto = RecommendationEngine(device=CPU)
    for a, b in zip(auto.recommend_batch(snap.host, reqs, archive=snap),
                    want):
        _assert_same_pools(a, b)


def test_snapshot_is_cheap():
    cands = synth_candidates(seed=7, K=16, T=WINDOW)
    arch = RollingDeviceArchive(cands, device=CPU)
    snap = arch.snapshot()
    assert isinstance(snap, ArchiveSnapshot)
    assert snap.nbytes < arch.nbytes        # no window matrix aboard
    assert len(snap) == len(arch) and snap.device.type == "cpu"
    assert not snap.dense_capable


def test_rolling_tiled_serving_never_gathers_the_window():
    cands = synth_candidates(seed=10, K=30, T=WINDOW)
    arch = RollingDeviceArchive(cands, device=CPU)
    arch.append(np.ones(30))
    _tiled_engine().recommend_batch(arch.host, _requests(cands), archive=arch)
    assert arch._t3_logical is None
    n = arch.nbytes
    arch.t3                                 # memoised per version
    assert arch._t3_logical is not None and arch.nbytes == n + 4 * 30 * WINDOW


# ---------------------------------------------------------------------------
# versioned cache membership and the server
# ---------------------------------------------------------------------------

def test_cache_versioned_put_invalidate():
    cands = synth_candidates(seed=8, K=12, T=WINDOW)
    cache = ArchiveCache(capacity=3, device=CPU)
    arch = RollingDeviceArchive(cands, name="live", device=CPU)
    cache.put(arch)
    assert "live@v0" in cache and len(cache) == 1
    stale = arch.key
    arch.append(np.zeros(12))
    assert cache.invalidate(stale) and stale not in cache
    cache.put(arch)
    assert "live@v1" in cache
    assert not cache.invalidate("live@v0")   # already gone


def test_server_serves_rolling_and_snapshot_directly():
    cands = synth_candidates(seed=11, K=24, T=WINDOW)
    arch = RollingDeviceArchive(cands, name="srv", device=CPU)
    arch.append(np.full(24, 3.0))
    server = BatchServer(_tiled_engine(), bucket_sizes=(1, 4, 8))
    reqs = _requests(cands)
    live = server.serve(arch, reqs)
    pinned = server.serve(arch.snapshot(), reqs)
    for a, b in zip(live, pinned):
        _assert_same_pools(a, b)
    assert len(server.cache) == 0           # bypassed the LRU
    with pytest.raises(ValueError, match="archive_key"):
        server.serve(arch, reqs, archive_key="x")
    with pytest.raises(NotImplementedError, match="sharded"):
        server.serve(type("Sharded", (), {"host": cands,
                                          "is_sharded": True})(), reqs)
    with pytest.raises(TypeError, match="staged archive"):
        server.serve(object(), reqs)


# ---------------------------------------------------------------------------
# LiveIngestor: the collector -> engine loop
# ---------------------------------------------------------------------------

def _decision_margin(comb, caps, amount):
    """Smallest relative distance of an Algorithm 1 decision from flipping:
    the gap between neighbours in score order, and every ``ceil`` operand
    ``s_j R / (sum(s[:k+1]) c_j)`` (j = 0 and j = k) from an integer."""
    order = np.argsort(-comb, kind="stable")
    s = comb[order].astype(np.float64)
    c = caps[order].astype(np.float64)
    gaps = np.abs(np.diff(s)) / np.maximum(np.abs(s[1:]), 1e-30)
    csc = np.where(np.cumsum(s) > 0, np.cumsum(s), 1.0)
    ops = np.concatenate([s[0] * amount / (csc * c[0]),
                          s * amount / (csc * c)])
    ops = ops[ops != 0]
    near = np.abs(ops - np.rint(ops)) / np.abs(ops)
    return float(min(gaps.min(initial=np.inf), near.min(initial=np.inf)))


def _count_ties(cands, jrecs, trecs, tarch, jarch, reqs):
    """Pools that differ between the packages must be ties: the port's
    engine scores the batch on its own statistics and on the reference's,
    and a differing pool needs an Algorithm 1 decision closer to flipping
    than the two score rows differ."""
    batch = RequestBatch.from_requests(cands, reqs)
    eng = _tiled_engine()
    own = eng.batch_arrays(cands, batch, archive=tarch)[0]
    ref_stats = [np.asarray(x) for x in jarch.score_stats()]
    theirs = eng.batch_arrays(cands, batch, archive=convert.archive_from_numpy(
        cands, ref_stats, device=CPU))[0]
    ties = 0
    for b, (a, t) in enumerate(zip(jrecs, trecs)):
        if (list(a.names) == list(t.names)
                and np.array_equal(a.counts, t.counts)
                and a.hourly_cost == t.hourly_cost):
            np.testing.assert_allclose(t.combined, a.combined, rtol=RTOL,
                                       atol=ATOL)
            continue
        m = batch.masks[b]
        budget = (np.abs(own[b][m] - theirs[b][m]).max()
                  / np.abs(theirs[b][m]).max() + 8 * np.finfo(np.float32).eps)
        margin = _decision_margin(own[b][m], reqs[b].capacity_of(cands)[m],
                                  reqs[b].amount)
        assert margin <= budget, (
            f"pool of {reqs[b]} differs with margin {margin} > {budget}")
        ties += 1
    return ties


def test_ingestor_loop_matches_reference_at_every_version():
    """The slice's headline: one collector feeds both packages' ingestors
    for 12 ticks (the ring wraps); at every version the port's served pools
    equal the reference's (ties counted: none) and the port's own cold
    re-stage, and the stored windows are bit-equal."""
    col = _collector()
    cache = ArchiveCache(capacity=4, device=CPU)
    ing = LiveIngestor(col, window=WINDOW, cache=cache, name="live",
                       device=CPU)
    jing = JIngestor(col, window=WINDOW, name="live")
    arch, jarch = ing.prime(), jing.prime()
    engine = _tiled_engine()
    server = BatchServer(engine, bucket_sizes=(1, 4, 8))
    jserver = JServer(JEngine(JConfig(score_impl="tiled")),
                      bucket_sizes=(1, 4, 8))
    cands = arch.host
    reqs, jreqs = _requests(cands), _requests(cands, JReq)
    ties = 0
    for cycle in range(12):
        col.run(1)
        stale = arch.key
        assert ing.lag == 1
        assert ing.poll() == 1 and jing.poll() == 1
        assert ing.lag == 0 and arch.key == jarch.key == f"live@v{cycle + 1}"
        assert arch.key in cache and stale not in cache
        np.testing.assert_array_equal(arch.materialize(),
                                      jarch.materialize())
        live = server.serve(arch, reqs)
        ref = jserver.serve(jarch, jreqs)
        ties += _count_ties(cands, ref, live, arch, jarch, reqs)
        cold_set, cold_arch = _cold(
            col.to_candidate_set(window=WINDOW).t3, cands)
        cold = engine.recommend_batch(cold_set, reqs, archive=cold_arch)
        for a, b in zip(live, cold):
            _assert_same_pools(a, b)
    assert ties == 0


def test_ingestor_validation():
    col = _collector(cycles=0)
    ing = LiveIngestor(col, window=WINDOW, device=CPU)
    with pytest.raises(ValueError, match="no completed ticks"):
        ing.prime()
    with pytest.raises(RuntimeError, match="prime"):
        ing.ingest_tick()
    assert ing.version == -1
    col.run(2)
    ing.prime()
    assert ing.version == 0
    with pytest.raises(RuntimeError, match="no pending"):
        ing.ingest_tick()
    with pytest.raises(ValueError, match="window"):
        LiveIngestor(col, window=0, device=CPU)
    with pytest.raises(TypeError, match="cache= or config="):
        LiveIngestor(col, window=4, cache=ArchiveCache(device=CPU),
                     config=EngineConfig(), device=CPU)


@pytest.mark.parametrize("kw", [{"shards": 2}, {"devices": ["cpu"]},
                                {"shard_bounds": [(0, 4), (4, 8)]}])
def test_sharded_ingestion_is_not_ported(kw):
    with pytest.raises(NotImplementedError, match="sharded"):
        LiveIngestor(_collector(cycles=1), window=4, device=CPU, **kw)


def test_ingestor_catches_up_multiple_ticks():
    col = _collector()
    ing = LiveIngestor(col, window=WINDOW, name="burst", device=CPU)
    ing.prime()
    col.run(3)                               # fall behind by three ticks
    assert ing.lag == 3
    assert ing.poll() == 3
    np.testing.assert_array_equal(
        ing.archive.materialize(),
        np.asarray(col.to_candidate_set(window=WINDOW).t3, np.float32))


def test_ingestor_invalidates_stale_key_before_mutating():
    col = _collector()

    class TracingCache(ArchiveCache):
        def invalidate(self, key):
            trace.append(("invalidate", key))
            return super().invalidate(key)

        def put(self, entry):
            trace.append(("put", entry.key))
            super().put(entry)

    trace = []
    cache = TracingCache(capacity=4, device=CPU)
    ing = LiveIngestor(col, window=WINDOW, cache=cache, name="order",
                       device=CPU)
    ing.prime()
    col.run(1)
    trace.clear()
    ing.poll()
    assert trace == [("invalidate", "order@v0"), ("put", "order@v1")]
    trace.clear()
    ing.prime()                              # re-prime replaces the entry
    assert trace == [("invalidate", "order@v1"), ("put", "order@v0")]


def test_build_ingestor_takes_the_config_tier():
    col = _collector()
    cfg = EngineConfig(archive_precision="int8", archive_headroom=1.5,
                       cache_capacity=2)
    ing = cfg.build_ingestor(col, window=WINDOW, name="q", device=CPU)
    arch = ing.prime()
    assert arch.precision == "int8" and arch.key == "q@v0#int8"
    assert ing.cache.capacity == 2 and arch.key in ing.cache
    shared = ArchiveCache(device=CPU)
    ing2 = cfg.build_ingestor(col, window=WINDOW, cache=shared, device=CPU)
    assert ing2.cache is shared and ing2.headroom == 1.5


# ---------------------------------------------------------------------------
# async admission
# ---------------------------------------------------------------------------

@pytest.fixture()
def admission():
    col = _collector()
    ing = LiveIngestor(col, window=WINDOW, name="adm", device=CPU)
    ing.prime()
    server = BatchServer(_tiled_engine(), bucket_sizes=(1, 4, 8))
    clock = FakeClock()
    q = AdmissionQueue(server, lambda: ing.archive, max_wait_s=1.0,
                       max_pending=4, clock=clock)
    return col, ing, q, clock


def test_admission_batches_by_deadline_not_call_site(admission):
    col, ing, q, clock = admission
    t1 = q.submit(ResourceRequest(cpus=64.0))
    clock.now += 0.5
    t2 = q.submit(ResourceRequest(cpus=128.0))
    assert q.pump() == 0 and not t1.done          # nothing due yet
    clock.now += 0.6                              # t1's deadline passes
    assert q.due()
    assert q.pump() == 2                          # t2 coalesces into the drain
    assert t1.done and t2.done
    assert q.stats.drains == 1 and q.stats.coalesced == 1
    want = q.server.engine.recommend_batch(
        ing.archive.host, [t1.request, t2.request], archive=ing.archive)
    _assert_same_pools(t1.result(), want[0])
    _assert_same_pools(t2.result(), want[1])
    assert t1.result().diagnostics["archive_version"] == ing.version
    assert t1.result().diagnostics["stale_archive"] is False


def test_admission_full_queue_triggers_immediate_drain(admission):
    _, _, q, clock = admission
    tickets = [q.submit(ResourceRequest(cpus=float(8 * (i + 1))))
               for i in range(4)]                 # max_pending == 4
    assert q.due() and q.next_due() == clock.now
    assert q.pump() == 4
    assert all(t.done for t in tickets)
    assert q.stats.versions == {"adm@v0": 4}
    assert q.next_due() is None


def test_admission_drains_across_version_bumps(admission):
    """A mid-flight collector tick never splits a batch across versions."""
    col, ing, q, clock = admission
    t1 = q.submit(ResourceRequest(cpus=64.0))
    col.run(1)
    ing.poll()                                    # bump to v1 while queued
    clock.now += 2.0
    t2 = q.submit(ResourceRequest(cpus=96.0))     # joins the same drain
    assert q.pump() == 2
    v1 = t1.result().diagnostics["archive_version"]
    v2 = t2.result().diagnostics["archive_version"]
    assert v1 == v2 == 1
    assert t1.result().diagnostics["archive_key"] == "adm@v1"


def test_admission_stale_archive_is_stamped(admission):
    col, ing, q, _ = admission
    ing.mark_stale()
    assert q.resolve_archive().stale
    rec = q.submit(ResourceRequest(cpus=32.0)).result()
    assert rec.diagnostics["stale_archive"] is True
    col.run(1)
    ing.poll()                                    # a good tick clears it
    rec = q.submit(ResourceRequest(cpus=32.0)).result()
    assert rec.diagnostics["stale_archive"] is False


def test_admission_sync_result_force_drains(admission):
    _, _, q, _ = admission
    t = q.submit(ResourceRequest(cpus=32.0))
    assert not t.done
    rec = t.result()                              # no worker: force drain
    assert t.done and rec.hourly_cost > 0
    assert q.stats.drains == 1


def test_forced_drain_does_not_count_coalesced(admission):
    _, _, q, clock = admission
    t1 = q.submit(ResourceRequest(cpus=32.0))
    t2 = q.submit(ResourceRequest(cpus=64.0))
    t1.result()                                   # sync fallback: force drain
    assert t1.done and t2.done
    assert q.stats.coalesced == 0
    assert q.stats.forced_drains == 1 and q.stats.drains == 1
    t3 = q.submit(ResourceRequest(cpus=16.0))
    clock.now += 0.5
    q.submit(ResourceRequest(cpus=8.0))
    clock.now += 0.6                              # t3 due, t4 rides along
    assert q.pump() == 2 and t3.done
    assert q.stats.coalesced == 1 and q.stats.forced_drains == 1
    assert q.stats.served == 4 == q.stats.submitted


def test_admission_adaptive_drain_takes_one_bucket(admission):
    _, _, q, clock = admission
    q.adaptive, q.max_pending = True, 100
    tickets = [q.submit(ResourceRequest(cpus=float(8 * (i + 1))),
                        max_wait_s=float(i)) for i in range(11)]
    clock.now += 20.0
    assert q.pump() == 8                          # the largest bucket
    assert [t.done for t in tickets] == [True] * 8 + [False] * 3
    assert q.pending == 3 and q.pump() == 3


def test_admission_sheds_to_the_pool_cache(admission):
    _, ing, q, _ = admission
    q2 = AdmissionQueue(q.server, lambda: ing.archive, max_wait_s=0.5,
                        max_pending=1000, clock=q.clock, shed_depth=4)
    req = ResourceRequest(cpus=64.0)
    t0 = q2.submit(req)
    q2.drain(force=True)
    assert t0.result().diagnostics["degraded"] is False
    backlog = [q2.submit(ResourceRequest(memory_gb=256.0, weight=0.8))
               for _ in range(4)]
    shed = q2.submit(req)
    assert shed.done
    rec = shed.result()
    assert rec.diagnostics["degraded"] is True
    assert rec.diagnostics["shed_queue_depth"] == 4
    cold = q2.submit(ResourceRequest(cpus=200.0, max_types=2))
    assert not cold.done                          # no memo: queues, no drop
    q2.drain(force=True)
    assert cold.done and all(t.done for t in backlog)
    s = q2.stats
    assert s.submitted == s.served + s.shed and s.shed == 1
    assert s.latency.n == s.served and s.shed_latency.n == s.shed


def test_admission_validation(admission):
    _, ing, q, _ = admission
    for kw, match in (({"max_pending": 0}, "max_pending"),
                      ({"max_pending": -3}, "max_pending"),
                      ({"max_wait_s": -1.0}, "max_wait_s"),
                      ({"shed_depth": 0}, "shed_depth")):
        with pytest.raises(ValueError, match=match):
            AdmissionQueue(q.server, lambda: ing.archive, **kw)
    q2 = AdmissionQueue(q.server, lambda: ing.archive)
    assert q2.max_pending == max(q.server.bucket_sizes)


def test_admission_error_fails_the_ticket(admission):
    _, _, q, clock = admission
    t = q.submit(ResourceRequest(cpus=8.0, regions=["nowhere-42"]))
    clock.now += 5.0
    assert q.drain() == 1
    with pytest.raises(ValueError, match="no candidates"):
        t.result()
    assert q.stats.failed_drains == 1 and q.stats.failed == 1
    assert q.stats.submitted == q.stats.served + q.stats.shed + q.stats.failed


def test_admission_source_failure_fails_tickets_not_hangs():
    server = BatchServer(RecommendationEngine(device=CPU), bucket_sizes=(1, 4))
    q = AdmissionQueue(server, lambda: None, max_wait_s=0.0)
    t = q.submit(ResourceRequest(cpus=16.0))
    assert q.drain(force=True) == 1
    assert t.done and q.pending == 0
    with pytest.raises(RuntimeError, match="no archive"):
        t.result(timeout=1.0)
    assert q.stats.failed_drains == 1 and q.stats.forced_drains == 1


def test_threaded_admission_resolves_every_ticket_exactly_once(monkeypatch,
                                                               racecheck):
    """Wall-clock worker and concurrent submitters: every ticket resolves
    exactly once and the queue's and server's ledgers balance, under the
    lock sanitizer."""
    resolve_counts: dict[int, int] = {}
    count_lock = threading.Lock()
    orig_resolve = Ticket._resolve

    def counting_resolve(self, result=None, error=None):
        with count_lock:
            resolve_counts[id(self)] = resolve_counts.get(id(self), 0) + 1
        orig_resolve(self, result=result, error=error)

    monkeypatch.setattr(Ticket, "_resolve", counting_resolve)
    col = _collector()
    ing = LiveIngestor(col, window=WINDOW, name="mt", device=CPU)
    ing.prime()
    server = BatchServer(_tiled_engine(), bucket_sizes=(1, 4, 8))
    q = AdmissionQueue(server, lambda: ing.archive, max_wait_s=0.005)
    instrument_server(racecheck, server)
    instrument_admission_queue(racecheck, q)
    q.start()
    n_threads, per_thread = 4, 6
    tickets: list = []
    tickets_lock = threading.Lock()

    def submitter(i):
        for j in range(per_thread):
            t = q.submit(ResourceRequest(cpus=float(8 * (i + j + 1))))
            with tickets_lock:
                tickets.append(t)

    try:
        threads = [threading.Thread(target=submitter, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        recs = [t.result(timeout=60.0) for t in tickets]
    finally:
        q.stop()
    n = n_threads * per_thread
    assert len(tickets) == n and all(t.done for t in tickets)
    assert all(r.hourly_cost > 0 for r in recs)
    assert len(resolve_counts) == n
    assert all(c == 1 for c in resolve_counts.values())
    assert q.stats.submitted == n and q.stats.served == n
    assert sum(q.stats.versions.values()) == n
    assert server.stats.requests == n
    assert sum(server.stats.bucket_counts.values()) == server.stats.batches
    assert q.pending == 0 and not q.running


def test_admission_background_worker_smoke():
    col = _collector()
    ing = LiveIngestor(col, window=WINDOW, name="bg", device=CPU)
    ing.prime()
    server = BatchServer(_tiled_engine(), bucket_sizes=(1, 4, 8))
    q = AdmissionQueue(server, lambda: ing.archive, max_wait_s=0.01).start()
    try:
        assert q.start() is q                     # already running: no-op
        tickets = [q.submit(ResourceRequest(cpus=float(16 * (i + 1))))
                   for i in range(3)]
        recs = [t.result(timeout=30.0) for t in tickets]
        assert all(r.hourly_cost > 0 for r in recs)
        assert q.stats.served == 3
    finally:
        q.stop()
    assert not q.running


# ---------------------------------------------------------------------------
# IngestPump: collector-push, no caller polling
# ---------------------------------------------------------------------------

def _pump_world(cycles=WINDOW):
    col = _collector(cycles=cycles)
    cache = ArchiveCache(capacity=4, device=CPU)
    ing = LiveIngestor(col, window=WINDOW, cache=cache, name="pumped",
                       device=CPU)
    ing.prime()

    def collect():
        col.collect_once()
        col.market.advance(col.market.now + col.cfg.period_min)

    return col, cache, ing, collect


def test_ingest_pump_advances_versions_without_polling(racecheck):
    col, cache, ing, collect = _pump_world()
    v0, key0 = ing.version, ing.archive.key
    pump = IngestPump(ing, collect)
    instrument_pump(racecheck, pump)
    with pump:
        deadline = time.monotonic() + 30.0
        while ing.version < v0 + 5 and time.monotonic() < deadline:
            time.sleep(0.01)
    assert not pump.running                  # context exit stopped it
    assert ing.version >= v0 + 5
    assert pump.ticks_pumped == ing.version - v0
    assert pump.errors == 0
    assert ing.archive.key in cache and key0 not in cache
    assert ing.lag == 0
    engine = _tiled_engine()
    reqs = _requests(ing.archive.host)
    live = engine.recommend_batch(ing.archive.host, reqs,
                                  archive=ing.archive)
    cold_set, cold_arch = _cold(col.to_candidate_set(window=WINDOW).t3,
                                ing.archive.host)
    cold = engine.recommend_batch(cold_set, reqs, archive=cold_arch)
    for a, b in zip(live, cold):
        _assert_same_pools(a, b)


def test_ingest_pump_clean_start_stop():
    _, _, ing, collect = _pump_world()
    pump = IngestPump(ing, collect, period=0.005)
    assert not pump.running
    pump.stop()                              # stop before start is a no-op
    pump.start()
    assert pump.running
    with pytest.raises(RuntimeError, match="already running"):
        pump.start()
    pump.stop()
    assert not pump.running
    pump.start()                             # restartable after a stop
    pump.stop()
    assert not pump.running
    with pytest.raises(ValueError):
        IngestPump(ing, collect, period=-1.0)


def test_ingest_pump_swallows_flaky_ticks():
    _, _, ing, collect = _pump_world()
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] % 2:
            raise RuntimeError("flaky tick")
        collect()

    pump = IngestPump(ing, flaky)
    with pump:
        deadline = time.monotonic() + 30.0
        while (pump.errors < 2 or pump.ticks_pumped < 2) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pump.running                  # still alive through raises
    assert pump.errors >= 2
    assert pump.ticks_pumped >= 2
    assert isinstance(pump.last_error, RuntimeError)
