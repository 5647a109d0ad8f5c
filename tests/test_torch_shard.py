"""K-axis sharding in the port (``repro_torch.shard``), against itself and
against ``repro.shard``.

The contract: splitting the candidate axis into shards changes no bit of
any pool or score row the single-device tiled path gives on the same
device — members, order, counts, hourly cost, diagnostics — including
after streamed ticks.  On the CPU (and on one card) the shards are slices
on one device.  The chain it rests on, each link pinned here:

1. per-shard ``candidate_stats`` rows equal row slices of the full pass;
2. phase 0 (``score_fuse_phase0``) merges exactly: min / max are
   associative, and its scalars are the reference's bit for bit;
3. phase 1 is elementwise given the merged scalars;
4. the pool stage runs the single-device function on the gathered rows.

Against the reference on the same statistics and bounds (``convert``):
pools exact wherever ``prefix_sum_tie`` certifies no F1 boundary (ties
counted: none on these seeds); rolling shards store the reference's
window and keys.  Every input comes from a fixed numpy seed; the
concurrency test orders its threads with events, not sleeps.
"""
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import EngineConfig as JConfig
from repro.core import RecommendationEngine as JEngine
from repro.core import ResourceRequest as JReq
from repro.kernels import pool_scan as jps
from repro.shard import ShardedArchive as JSharded
from repro.shard import ShardedRollingArchive as JShardedRolling
from repro.shard import check_bounds as jcheck_bounds
from repro.shard import shard_bounds as jshard_bounds
from repro.shard.compute import _shard_phase0
from repro_torch import convert
from repro_torch.core import (EngineConfig, RecommendationEngine,
                              ResourceRequest, scoring)
from repro_torch.core import pool as tpool
from repro_torch.core.engine import _dedup_masks
from repro_torch.core.types import RequestBatch
from repro_torch.kernels import pool_scan as tps
from repro_torch.kernels import score_fuse as tsf
from repro_torch.serve import ArchiveCache, BatchServer, DeviceArchive
from repro_torch.shard import (ShardedArchive, ShardedRollingArchive,
                               ShardedSnapshot, check_bounds, shard_bounds)
from repro_torch.stream import AdmissionQueue, LiveIngestor, RollingDeviceArchive

from test_serve_batch import synth_candidates as _ref_candidates
from test_torch_stream import _collector

CPU = "cpu"
WINDOW = 10


def synth_candidates(seed, K, T=24):
    return convert.as_candidate_set(_ref_candidates(seed=seed, K=K, T=T))


def heterogeneous_requests(cands, cls=ResourceRequest):
    """The reference suite's mix: targets, weights, lambdas, filters, caps."""
    return [
        cls(cpus=128.0), cls(memory_gb=256.0, weight=0.8),
        cls(cpus=96.0, weight=0.0, lam=0.3),
        cls(cpus=64.0, regions=[str(cands.regions[0])]),
        cls(cpus=200.0, max_types=2),
        cls(cpus=32.0, types=[str(cands.names[5])]),
        cls(cpus=500.0, weight=1.0), cls(cpus=77.0, weight=0.37, lam=0.21),
        cls(memory_gb=48.0, weight=0.9, families=["c5", "r5"]),
        cls(cpus=1000.0, weight=0.25, lam=0.05,
            categories=["general", "memory"]),
    ]


@pytest.fixture(scope="module")
def cands():
    return synth_candidates(seed=11, K=72)


@pytest.fixture(scope="module")
def engine():
    # sharded archives serve the tiled stage (dense_capable = False); the
    # single-device baseline is pinned to it too
    return RecommendationEngine(
        EngineConfig(score_impl="tiled", pool_impl="tiled"), device=CPU)


def _assert_bitwise(a, b):
    """Pools and scores bit-identical."""
    assert list(a.names) == list(b.names)
    assert list(a.regions) == list(b.regions)
    assert list(a.azs) == list(b.azs)
    np.testing.assert_array_equal(a.counts, b.counts)
    assert a.hourly_cost == b.hourly_cost
    assert (a.diagnostics["greedy_iterations"]
            == b.diagnostics["greedy_iterations"])
    assert (a.diagnostics["candidates_considered"]
            == b.diagnostics["candidates_considered"])
    np.testing.assert_array_equal(a.combined, b.combined)
    np.testing.assert_array_equal(a.availability, b.availability)
    np.testing.assert_array_equal(a.cost, b.cost)


def _assert_same_pools(a, b):
    assert list(a.names) == list(b.names)
    np.testing.assert_array_equal(a.counts, b.counts)
    assert a.hourly_cost == b.hourly_cost
    np.testing.assert_allclose(a.combined, b.combined, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# bounds + staging surface
# ---------------------------------------------------------------------------

def test_shard_bounds_contiguous_balanced():
    for k, n in ((72, 1), (72, 2), (72, 4), (7, 3), (5, 5), (1001, 3)):
        bounds = shard_bounds(k, n)
        assert bounds == jshard_bounds(k, n)
        assert bounds[0][0] == 0 and bounds[-1][1] == k
        sizes = [b - a for a, b in bounds]
        assert sum(sizes) == k and max(sizes) - min(sizes) <= 1
    with pytest.raises(ValueError, match="n_shards"):
        shard_bounds(4, 0)
    with pytest.raises(ValueError, match="empty shards"):
        shard_bounds(4, 5)
    assert check_bounds([(0, 3), (3, 9)], 9) == jcheck_bounds([(0, 3), (3, 9)], 9)


def test_sharded_archive_surface(cands):
    arch = ShardedArchive.stage(cands, n_shards=3, key="shardtest",
                                devices=[CPU])
    assert arch.n_shards == 3 and len(arch) == len(cands)
    assert arch.key == "shardtest" and arch.device.type == "cpu"
    assert [s.key for s in arch.shards] == [f"shardtest/s{i}"
                                            for i in range(3)]
    assert not arch.dense_capable and arch.is_sharded
    with pytest.raises(RuntimeError, match="no single-device window"):
        _ = arch.t3
    got = np.concatenate([s.t3.numpy() for s in arch.shards], axis=0)
    np.testing.assert_array_equal(got, np.asarray(cands.t3, np.float32))
    for s in arch.shards:
        s.score_stats()
    want = sum(s.nbytes for s in arch.shards) + 3 * 4 * len(cands)
    assert arch.nbytes == want


def test_shards_round_robin_over_devices(cands):
    arch = ShardedArchive.stage(cands, n_shards=5, devices=[CPU, "cpu"])
    assert arch.n_shards == 5
    assert {s.device for s in arch.shards} == {torch.device("cpu")}
    one = ShardedArchive.stage(cands, devices=[CPU])   # n = len(devices)
    assert one.n_shards == 1 and one.bounds == ((0, len(cands)),)


def test_candidate_stats_rows_are_shard_sliceable(cands):
    """Link 1: per-shard statistics equal row slices of the full pass."""
    full = scoring.candidate_stats(cands.t3)
    for a, b in shard_bounds(len(cands), 4) + ((0, 1), (71, 72), (3, 10)):
        part = scoring.candidate_stats(cands.t3[a:b])
        for name, f, p in zip(("area", "slope", "std"), full, part):
            np.testing.assert_array_equal(f[a:b].numpy(), p.numpy(),
                                          err_msg=name)


# ---------------------------------------------------------------------------
# phase 0: exact merge, and the reference's scalars
# ---------------------------------------------------------------------------

def _phase0_operands(cands, reqs, a, b):
    batch = RequestBatch.from_requests(cands, reqs)
    uniq, inv = _dedup_masks(batch.masks)
    stats = torch.stack(tuple(scoring.candidate_stats(cands.t3[a:b])))
    f = lambda x: scoring.f32(np.asarray(x)[a:b])  # noqa: E731
    return batch, uniq, inv, (
        stats, f(cands.prices), f(cands.vcpus), f(cands.memory_gb),
        torch.as_tensor(batch.masks[:, a:b].copy()),
        torch.as_tensor(batch.use_cpus), torch.as_tensor(batch.amounts),
        torch.as_tensor(uniq[:, a:b].copy()))


def test_phase0_entry_is_the_fused_calls_phase0(cands):
    reqs = heterogeneous_requests(cands)
    batch, uniq, inv, args = _phase0_operands(cands, reqs, 0, len(cands))
    ext, cmin = tsf.score_fuse_phase0(*args)
    full = tsf.score_fuse_batch(*args[:7], torch.as_tensor(batch.lams),
                                torch.as_tensor(batch.weights), args[7], inv)
    np.testing.assert_array_equal(ext.numpy(), full.extrema.numpy())
    np.testing.assert_array_equal(cmin.numpy(), full.c_min.numpy())
    assert ext.shape == (uniq.shape[0], 6) and cmin.shape == (len(reqs),)
    with pytest.raises(ValueError, match="uniq_masks"):
        tsf.score_fuse_phase0(*args[:7], args[7][:, :3])


@pytest.mark.parametrize("bounds", [((0, 72),), ((0, 10), (10, 40),
                                                 (40, 41), (41, 72))])
def test_phase0_merges_exactly_and_matches_reference(cands, bounds):
    """Link 2: shard carries merged by min / max equal the full axis's,
    and each shard's carries are the reference's ``_shard_phase0`` bits."""
    reqs = heterogeneous_requests(cands)
    parts = []
    for a, b in bounds:
        batch, uniq, inv, args = _phase0_operands(cands, reqs, a, b)
        ext, cmin = tsf.score_fuse_phase0(*args)
        stats = [jnp.asarray(x.numpy()) for x in args[0]]
        lo, hi, jc = _shard_phase0(
            *stats, *(jnp.asarray(x.numpy()) for x in args[1:4]),
            jnp.asarray(uniq[:, a:b]), jnp.asarray(batch.masks[:, a:b]),
            jnp.asarray(batch.use_cpus), jnp.asarray(batch.amounts))
        np.testing.assert_array_equal(ext[:, 0::2].numpy(), np.asarray(lo))
        np.testing.assert_array_equal(ext[:, 1::2].numpy(), np.asarray(hi))
        np.testing.assert_array_equal(cmin.numpy(), np.asarray(jc))
        parts.append((ext, cmin))
    _, _, _, args = _phase0_operands(cands, reqs, 0, len(cands))
    ext, cmin = tsf.score_fuse_phase0(*args)
    lo = torch.stack([e[:, 0::2] for e, _ in parts]).amin(0)
    hi = torch.stack([e[:, 1::2] for e, _ in parts]).amax(0)
    np.testing.assert_array_equal(ext[:, 0::2].numpy(), lo.numpy())
    np.testing.assert_array_equal(ext[:, 1::2].numpy(), hi.numpy())
    np.testing.assert_array_equal(
        cmin.numpy(), torch.stack([c for _, c in parts]).amin(0).numpy())


# ---------------------------------------------------------------------------
# static archives: sharded == single-device tiled, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_sharded_pools_bit_identical_to_single_device(cands, engine, n_shards):
    reqs = heterogeneous_requests(cands)
    single = engine.recommend_batch(
        cands, reqs, archive=DeviceArchive.stage(cands, device=CPU))
    sharded = engine.recommend_batch(
        cands, reqs, archive=ShardedArchive.stage(cands, n_shards=n_shards,
                                                  devices=[CPU]))
    for a, b in zip(single, sharded):
        _assert_bitwise(a, b)


def test_sharded_batch_arrays_bit_identical(cands, engine):
    """Every array of the batch, masked lanes and padded rows included."""
    reqs = heterogeneous_requests(cands)
    batch = RequestBatch.from_requests(cands, reqs, pad_to=16)
    want = engine.batch_arrays(cands, batch,
                               archive=DeviceArchive.stage(cands, device=CPU))
    got = engine.batch_arrays(cands, batch, archive=ShardedArchive.stage(
        cands, bounds=((0, 5), (5, 6), (6, 72)), devices=[CPU]))
    assert len(got) == len(want) == 7
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_matches_sequential_recommend(cands, engine, n_shards):
    """Sharded == the per-request path, under the batched path's contract
    (pools exact, scores float32-ulp level)."""
    reqs = heterogeneous_requests(cands)
    arch = ShardedArchive.stage(cands, n_shards=n_shards, devices=[CPU])
    for req, bat in zip(reqs, engine.recommend_batch(cands, reqs,
                                                     archive=arch)):
        seq = engine.recommend(cands, req)
        assert list(seq.names) == list(bat.names)
        np.testing.assert_array_equal(seq.counts, bat.counts)
        assert seq.hourly_cost == bat.hourly_cost
        np.testing.assert_allclose(seq.combined, bat.combined, rtol=1e-5,
                                   atol=1e-4)


def test_sharded_padding_is_bit_invariant(cands, engine):
    reqs = heterogeneous_requests(cands)
    arch = ShardedArchive.stage(cands, n_shards=2, devices=[CPU])
    plain = engine.recommend_batch(cands, reqs, archive=arch)
    padded = engine.recommend_batch(cands, reqs, pad_to=16, archive=arch)
    for a, b in zip(plain, padded):
        _assert_bitwise(a, b)


def test_filter_confined_to_one_shard(cands, engine):
    """The other shards' empty masks give +-inf carries that merge away."""
    arch = ShardedArchive.stage(cands, n_shards=4, devices=[CPU])
    a0, b0 = arch.bounds[0]
    only_first = [str(n) for n in cands.names[a0:b0][:3]]
    reqs = [ResourceRequest(cpus=64.0, types=only_first),
            ResourceRequest(cpus=128.0)]
    single = engine.recommend_batch(
        cands, reqs, archive=DeviceArchive.stage(cands, device=CPU))
    sharded = engine.recommend_batch(cands, reqs, archive=arch)
    for a, b in zip(single, sharded):
        _assert_bitwise(a, b)
    assert all(n in only_first for n in sharded[0].names)


def test_sharded_empty_filter_raises(cands, engine):
    arch = ShardedArchive.stage(cands, n_shards=2, devices=[CPU])
    reqs = [ResourceRequest(cpus=8.0),
            ResourceRequest(cpus=8.0, regions=["nowhere-9"])]
    with pytest.raises(ValueError, match="batch row 1"):
        engine.recommend_batch(cands, reqs, archive=arch)


def test_explicit_bounds_pools_bit_identical(cands, engine):
    bounds = ((0, 10), (10, 40), (40, 41), (41, 72))
    reqs = heterogeneous_requests(cands)
    arch = ShardedArchive.stage(cands, bounds=bounds, devices=[CPU])
    assert arch.n_shards == len(bounds)
    assert [len(s) for s in arch.shards] == [10, 30, 1, 31]
    single = engine.recommend_batch(
        cands, reqs, archive=DeviceArchive.stage(cands, device=CPU))
    for a, b in zip(single, engine.recommend_batch(cands, reqs,
                                                   archive=arch)):
        _assert_bitwise(a, b)


def test_explicit_bounds_validation(cands):
    for bad in ([(1, 72)], [(0, 10), (11, 72)], [(0, 12), (10, 72)],
                [(0, 0), (0, 72)], [(0, 80)]):
        with pytest.raises(ValueError):
            ShardedArchive.stage(cands, bounds=bad, devices=[CPU])
        with pytest.raises(ValueError):
            jcheck_bounds(bad, 72)
    with pytest.raises(ValueError, match="conflicts"):
        ShardedArchive.stage(cands, n_shards=2, bounds=[(0, 72)],
                             devices=[CPU])


def _tie(cands, archive, req):
    """Replay one request's scan on the port's rows: an F1 tie?"""
    batch = RequestBatch.from_requests(cands, [req])
    comb, _, _, _, _, k_stop, any_term = RecommendationEngine(
        EngineConfig(score_impl="tiled"), device=CPU).batch_arrays(
        cands, batch, archive=archive)
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


@pytest.mark.parametrize("K,n_shards", [(300, 3), (3000, 4)])
def test_sharded_pools_match_reference(K, n_shards):
    """The reference's sharded archive and the port's on its bounds and
    statistics serve the same pools (ties counted), scores at RTOL 1e-5 /
    ATOL 1e-4."""
    ref = _ref_candidates(seed=41, K=K, T=48)
    port = convert.as_candidate_set(ref)
    jarch = JSharded.stage(ref, n_shards=n_shards)
    stats = [np.concatenate([np.asarray(s.score_stats()[i])
                             for s in jarch.shards]) for i in range(3)]
    arch = convert.sharded_archive_from_numpy(port, jarch.bounds, stats,
                                              devices=[CPU])
    assert arch.bounds == jarch.bounds
    refs = JEngine(JConfig(score_impl="tiled")).recommend_batch(
        ref, heterogeneous_requests(ref, JReq), archive=jarch)
    reqs = heterogeneous_requests(port)
    gots = RecommendationEngine(EngineConfig(score_impl="tiled"),
                                device=CPU).recommend_batch(port, reqs,
                                                            archive=arch)
    ties = 0
    for req, a, b in zip(reqs, refs, gots):
        if not (list(a.names) == list(b.names)
                and np.array_equal(a.counts, b.counts)
                and a.hourly_cost == b.hourly_cost):
            assert _tie(port, arch, req), f"pool differs for {req}"
            ties += 1
            continue
        np.testing.assert_allclose(b.combined, a.combined, rtol=1e-5,
                                   atol=1e-4)
    assert ties == 0


# ---------------------------------------------------------------------------
# rolling archives: per-shard ingest == cold re-stage, at every version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_rolling_ticks_match_cold_restage(engine, n_shards):
    cands = synth_candidates(seed=5, K=48, T=WINDOW)
    arch = ShardedRollingArchive(cands, n_shards=n_shards, name="roll",
                                 devices=[CPU])
    reqs = heterogeneous_requests(cands)[:6]
    rng = np.random.default_rng(1)
    for tick in range(1, 6):
        arch.append(rng.uniform(0, 50, 48))
        assert arch.version == tick and arch.key == f"roll@v{tick}"
        live = engine.recommend_batch(arch.host, reqs, archive=arch)
        cold_set = convert.candidate_set_from_numpy(
            **{**vars(cands), "t3": arch.materialize().astype(np.float64)})
        cold = engine.recommend_batch(
            cold_set, reqs, archive=DeviceArchive.stage(cold_set, device=CPU))
        for a, b in zip(live, cold):
            # streamed moments against one-shot reductions: pools exact,
            # scores at the stream suite's budget
            _assert_same_pools(a, b)


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_rolling_matches_single_device_rolling(engine, n_shards):
    """Against one ring fed the same columns the match is bitwise: the
    rank-1 updates are elementwise along K."""
    cands = synth_candidates(seed=6, K=40, T=WINDOW)
    sharded = ShardedRollingArchive(cands, n_shards=n_shards, name="s",
                                    devices=[CPU])
    single = RollingDeviceArchive(cands, name="m", device=CPU)
    reqs = heterogeneous_requests(cands)[:5]
    rng = np.random.default_rng(2)
    for _ in range(4):
        col = rng.uniform(0, 50, 40)
        sharded.append(col)
        single.append(col)
        np.testing.assert_array_equal(sharded.materialize(),
                                      single.materialize())
        a = engine.recommend_batch(sharded.host, reqs, archive=sharded)
        b = engine.recommend_batch(single.host, reqs, archive=single)
        for x, y in zip(a, b):
            _assert_bitwise(x, y)


@pytest.mark.parametrize("precision", ["float32", "int8"])
def test_sharded_rolling_matches_reference(precision):
    """The reference's sharded ring fed the same columns: the same keys and
    stored window; statistics within 1e-5 of each statistic's range (XLA's
    FMA contraction, F2)."""
    ref = _ref_candidates(seed=8, K=50, T=WINDOW)
    port = convert.as_candidate_set(ref)
    kw = dict(capacity=WINDOW, n_shards=3, name="r", precision=precision,
              headroom=2.0)
    j = JShardedRolling(ref, **kw)
    t = ShardedRollingArchive(port, devices=[CPU], **kw)
    rng = np.random.default_rng(9)
    for _ in range(WINDOW + 3):
        col = rng.uniform(0, 50, 50)
        j.append(col)
        t.append(col)
        assert t.key == j.key and t.bounds == j.bounds
        np.testing.assert_array_equal(t.materialize(), j.materialize())
    assert t.clipped_samples == j.clipped_samples
    for ts, js in zip(t.shards, j.shards):
        for a, b in zip(ts.score_stats(), js.score_stats()):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-5 * max(np.ptp(b), 1.0))


def test_sharded_snapshot_pins_version(engine):
    cands = synth_candidates(seed=7, K=36, T=WINDOW)
    arch = ShardedRollingArchive(cands, n_shards=2, name="pin",
                                 devices=[CPU])
    reqs = heterogeneous_requests(cands)[:4]
    rng = np.random.default_rng(3)
    arch.append(rng.uniform(0, 50, 36))
    snap = arch.snapshot()
    assert isinstance(snap, ShardedSnapshot)
    assert snap.key == "pin@v1" and snap.n_shards == 2 and not snap.stale
    want = engine.recommend_batch(snap.host, reqs, archive=snap)
    for _ in range(3):
        arch.append(rng.uniform(0, 50, 36))
    assert arch.version == 4 and snap.version == 1
    got = engine.recommend_batch(snap.host, reqs, archive=snap)
    for a, b in zip(got, want):
        _assert_bitwise(a, b)
    with pytest.raises(RuntimeError, match="no single-device window"):
        _ = snap.t3
    arch.stale = True
    assert arch.snapshot().stale


def test_sharded_rolling_validation():
    cands = synth_candidates(seed=8, K=9, T=4)
    with pytest.raises(ValueError, match="empty shards"):
        ShardedRollingArchive(cands, n_shards=10, devices=[CPU])
    arch = ShardedRollingArchive(cands, n_shards=3, devices=[CPU])
    with pytest.raises(ValueError, match="column shape"):
        arch.append(np.zeros(5))
    with pytest.raises(RuntimeError, match="no single-device window"):
        _ = arch.t3
    with pytest.raises(ValueError, match="capacity"):
        ShardedRollingArchive(cands, n_shards=3, capacity=2, devices=[CPU])
    with pytest.raises(ValueError, match="shards must be >= 1"):
        LiveIngestor(_collector(cycles=1), window=4, device=CPU, shards=0)


def test_append_holds_the_tick_lock_across_every_shard():
    """A snapshot asked for while a tick is half applied (shard 0 appended,
    shard 1 not yet) waits for the tick and pins every shard at it.  The
    threads are ordered by events: shard 1's append blocks until released."""
    cands = synth_candidates(seed=12, K=24, T=6)
    arch = ShardedRollingArchive(cands, n_shards=3, name="race",
                                 devices=[CPU])
    inside, release = threading.Event(), threading.Event()
    shard1_append = arch.shards[1].append

    def held(col):
        inside.set()
        assert release.wait(30)
        return shard1_append(col)

    arch.shards[1].append = held
    ticker = threading.Thread(target=arch.append, args=(np.ones(24),))
    ticker.start()
    try:
        assert inside.wait(30)
        assert [s.version for s in arch.shards] == [1, 0, 0]
        assert not arch._tick_lock.acquire(blocking=False)
        snaps = []
        taker = threading.Thread(target=lambda: snaps.append(arch.snapshot()))
        taker.start()
    finally:
        release.set()
        ticker.join(30)
    taker.join(30)
    assert not ticker.is_alive() and not taker.is_alive()
    (snap,) = snaps
    assert snap.version == 1 and [s.version for s in snap.shards] == [1] * 3


def test_concurrent_append_snapshot_never_mixes_shard_ticks():
    """Ticks and snapshots from two threads started together (a barrier),
    the ticker stopped by an event: every snapshot pins one tick."""
    cands = synth_candidates(seed=12, K=24, T=6)
    arch = ShardedRollingArchive(cands, n_shards=3, name="race",
                                 devices=[CPU])
    start, stop = threading.Barrier(2), threading.Event()
    errors: list = []

    def ticker():
        rng = np.random.default_rng(0)
        start.wait()
        while not stop.is_set():
            arch.append(rng.uniform(0, 50, 24))

    th = threading.Thread(target=ticker)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)          # interleave the threads finely
    th.start()
    try:
        start.wait(30)
        for _ in range(200):
            snap = arch.snapshot()
            if any(s.version != snap.version for s in snap.shards):
                errors.append([s.version for s in snap.shards]
                              + [snap.version])
    finally:
        stop.set()
        th.join(30)
        sys.setswitchinterval(switch)
    assert not th.is_alive()
    assert not errors, f"mixed shard ticks under one key: {errors[:3]}"


def test_explicit_bounds_rolling_matches_cold_restage(engine):
    bounds = ((0, 7), (7, 36), (36, 72))
    roll_cands = synth_candidates(seed=11, K=72, T=WINDOW)
    arch = ShardedRollingArchive(roll_cands, bounds=bounds, name="regions",
                                 devices=[CPU])
    assert arch.n_shards == 3
    reqs = heterogeneous_requests(roll_cands)[:6]
    rng = np.random.default_rng(17)
    for _ in range(4):
        arch.append(rng.integers(0, 50, 72).astype(np.float64))
        live = engine.recommend_batch(arch.host, reqs, archive=arch)
        cold_set = convert.candidate_set_from_numpy(
            **{**vars(roll_cands),
               "t3": arch.materialize().astype(np.float64)})
        cold = engine.recommend_batch(
            cold_set, reqs, archive=DeviceArchive.stage(cold_set, device=CPU))
        for a, b in zip(live, cold):
            _assert_same_pools(a, b)


# ---------------------------------------------------------------------------
# serve / stream integration
# ---------------------------------------------------------------------------

def test_sharded_ingestor_loop_matches_cold_restage(engine):
    """Collector -> sharded rings -> versioned cache -> BatchServer, pools
    matching a cold re-stage at every version."""
    col = _collector()
    cache = ArchiveCache(capacity=4, device=CPU)
    ing = LiveIngestor(col, window=WINDOW, cache=cache, name="live",
                       shards=2, device=CPU)
    arch = ing.prime()
    assert isinstance(arch, ShardedRollingArchive) and arch.n_shards == 2
    server = BatchServer(engine, bucket_sizes=(1, 4, 8))
    reqs = heterogeneous_requests(arch.host)[:5]
    for _ in range(4):
        col.run(1)
        stale = arch.key
        ing.poll()
        assert arch.key in cache and stale not in cache
        live = server.serve(arch, reqs)
        cold_set = convert.as_candidate_set(
            col.to_candidate_set(window=WINDOW))
        np.testing.assert_array_equal(arch.materialize(),
                                      np.asarray(cold_set.t3, np.float32))
        cold = engine.recommend_batch(
            cold_set, reqs, archive=DeviceArchive.stage(cold_set, device=CPU))
        for a, b in zip(live, cold):
            _assert_same_pools(a, b)
    ing.mark_stale()
    assert arch.stale and arch.snapshot().stale


def test_sharded_admission_drain_pins_snapshot(engine):
    """A drain against a sharded rolling source serves one ShardedSnapshot
    across a tick that lands while the tickets wait."""
    col = _collector()
    ing = LiveIngestor(col, window=WINDOW, name="adm", shards=2, device=CPU)
    ing.prime()
    server = BatchServer(engine, bucket_sizes=(1, 4, 8))
    q = AdmissionQueue(server, lambda: ing.archive, max_wait_s=1.0,
                       max_pending=4, clock=lambda: 100.0)
    t1 = q.submit(ResourceRequest(cpus=64.0))
    col.run(1)
    ing.poll()
    t2 = q.submit(ResourceRequest(cpus=96.0))
    assert q.drain(force=True) == 2
    for t in (t1, t2):
        assert t.result().diagnostics["archive_key"] == "adm@v1"
        assert t.result().diagnostics["archive_version"] == 1
        assert t.result().diagnostics["stale_archive"] is False
