"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips unless CUDA and nvcc are present (decided
inside the fixture, never at import).  Run them on a GPU machine with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Kernels B1-B3 are built with ``--fmad=false`` and keep the plain
version's op order, so their outputs must be bit-identical.  B7/B8 (the
MoE grouped matmuls) sum in the tensor cores' order, so every element must
lie within one bf16 ulp of the plain version's float32 einsum, or within
1e-3 * max|plain|.  B5 (the WKV6 scan) sums its chunk's cumsum and
contractions in another order than the plain version, on 3xTF32 tensor-core
products with ex2.approx exponentials: outputs and states within 1e-4 *
max|plain|, also over the model's whole decay range.  B6 (the RG-LRU scan) keeps the plain version's
doubling order and is built with ``--fmad=false``: bit-identical.  B4 (flash
attention) sums its products in the tensor cores' order: every element
within one bf16 ulp of the plain version, or within 1e-3 * max|plain|.
The reduced qwen2-0.5b (head_dim 64, which B4 takes) is held against the
port's CPU run: its forward's logits within 5e-2 * max|CPU logits|, as
for the other reduced models; a training step's loss and gradient norm
within 1e-3 relative and every master-weight leaf within 2e-2 of the CPU
tree's norm, as the CPU run is held against the reference.  The port's
simulator world, ingested on the card and served through admission, is
held against its CPU run as the main path is (F1 ties only), and the load
harness must shed at twice the card's measured capacity with every ledger
balanced.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch
from _bf16_helpers import assert_within_ulp
from _scan_rows import scan_rows, stop_lanes

from repro_torch import convert
from repro_torch.cloudsim import (Catalog, CollectorConfig, DataCollector,
                                  SpotMarket, SPSQueryService)
from repro_torch.core import EngineConfig
from repro_torch.core import pool as tpool
from repro_torch.core.engine import _dedup_masks
from repro_torch.core.types import CandidateSet, RequestBatch, ResourceRequest
from repro_torch.kernels import _build
from repro_torch.kernels import pool_scan as tps
from repro_torch.kernels import score_fuse as tsf
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.kernels import rglru_scan as trg
from repro_torch.kernels import rwkv6_scan as twkv
from repro_torch.kernels import stats_update as tsu
from repro_torch.parallel import compression as tcomp
from repro_torch.loadgen import LoadHarness, Steady, mixed_mix
from repro_torch.serve import BatchServer, DeviceArchive
from repro_torch.stream import AdmissionQueue, LiveIngestor, RollingDeviceArchive

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    try:
        _build.nvcc_path()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


def _world(K: int, T: int = 96, seed: int = 0) -> CandidateSet:
    rng = np.random.default_rng(seed)
    fams = rng.choice(["m5", "c5", "r5", "t3"], K)
    return CandidateSet(
        names=np.array([f"{fams[i]}.x{i}" for i in range(K)]),
        regions=rng.choice(["us-east-1", "eu-west-1", "ap-north-1"], K),
        azs=rng.choice(["a", "b", "c"], K), families=fams,
        categories=rng.choice(["general", "compute", "memory"], K),
        vcpus=rng.choice([2, 4, 8, 16, 32, 64, 96], K).astype(np.float64),
        memory_gb=rng.choice([4, 8, 16, 64, 128, 384], K).astype(np.float64),
        prices=rng.uniform(0.01, 5.0, K), t3=rng.uniform(0.0, 50.0, (K, T)))


REQS = [ResourceRequest(cpus=128.0), ResourceRequest(memory_gb=256.0, weight=0.8),
        ResourceRequest(cpus=96.0, weight=0.0, lam=0.3),
        ResourceRequest(cpus=64.0, regions=["us-east-1"]),
        ResourceRequest(cpus=200.0, max_types=2),
        ResourceRequest(cpus=500.0, weight=1.0),
        ResourceRequest(memory_gb=48.0, families=["c5", "r5"])]


def _same(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.parametrize("K", [1, 255, 1000, 5000])
def test_kernels_match_plain_versions(cuda, K):
    cands = _world(K)
    archive = DeviceArchive.stage(cands, device=cuda)
    stats = torch.stack(tuple(archive.score_stats()))
    batch = RequestBatch.from_requests(cands, REQS[:1] if K == 1 else REQS)
    uniq, inv = _dedup_masks(batch.masks)
    on = lambda x: torch.as_tensor(x, device=cuda)  # noqa: E731
    masks, use = on(batch.masks), on(batch.use_cpus)
    args = (stats, archive.prices, archive.vcpus, archive.memory_gb, masks,
            use, on(batch.amounts), on(batch.lams), on(batch.weights),
            on(uniq), inv)
    before = tsf.score_fuse_batch.launches
    got = tsf.score_fuse_batch(*args)
    want = tsf.score_fuse_batch(*args, backend="torch")
    assert tsf.score_fuse_batch.launches == before + 1
    for name in ("comb", "avail", "cost"):
        assert _same(getattr(got, name)[masks], getattr(want, name)[masks])
    assert _same(got.extrema, want.extrema) and _same(got.c_min, want.c_min)
    short = tsf.score_fuse_batch(*args, extrema=want.extrema,
                                 cost_floor=want.c_min)
    assert _same(short.comb[masks], want.comb[masks])

    caps = torch.where(use[:, None], archive.vcpus, archive.memory_gb)
    _, s, c = tpool._sort_masked(got.comb, caps, masks)
    before = tps.pool_scan.launches
    pk = tps.pool_scan(s, c, on(batch.amounts))
    pp = tps.pool_scan(s, c, on(batch.amounts), backend="torch")
    assert tps.pool_scan.launches == before + 1
    for a, b in zip(pk, pp):
        assert torch.equal(a, b)


def _score_inputs(K, B, device, seed=0):
    """Seeded B1 operands with NaN and +-0 among the statistics, three base
    filter masks (so U > 1 once B > 1) and a request whose mask keeps one
    lane."""
    rng = np.random.default_rng(seed * 1000 + K + B)
    stats = rng.standard_normal((3, K)).astype(np.float32)
    flat = stats.reshape(-1)
    flat[rng.integers(0, flat.size, max(1, flat.size // 53))] = -0.0
    stats[:, rng.integers(0, K, max(1, K // 7))] = 0.0
    nan_lanes = rng.integers(0, K, 2)
    stats[0, nan_lanes[0]] = stats[2, nan_lanes[1]] = np.nan
    # the first mask takes every lane (its extrema are NaN), the others
    # leave the NaN lanes out
    base = rng.random((3, K)) < np.array([[1.0], [0.6], [0.3]])
    base[1:, nan_lanes] = False
    masks = base[rng.integers(0, 3, B)]
    one = np.zeros(K, bool)
    one[rng.integers(0, K)] = True
    masks[B // 2] = one
    on = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    uniq, inv = _dedup_masks(masks)
    return (on(stats), on(rng.uniform(0.01, 5.0, K).astype(np.float32)),
            on(rng.choice([2, 4, 8, 96], K).astype(np.float32)),
            on(rng.choice([4, 16, 384], K).astype(np.float32)), on(masks),
            on(rng.random(B) < 0.5),
            on(rng.choice([64, 100, 1000], B).astype(np.float32)),
            on(rng.uniform(0.05, 0.3, B).astype(np.float32)),
            on(np.where(rng.random(B) < 0.2, 1.0,
                        rng.uniform(0, 1, B)).astype(np.float32)),
            on(uniq), inv)


@pytest.mark.parametrize("B", [1, 16, 64])
@pytest.mark.parametrize("K", [1, 3, 255, 1001, 32768, 32771])
def test_score_fuse_kernel_bit_identical_on_edge_values(cuda, K, B):
    """B1's K-split partials, merge and 16-byte emit against the plain
    version, every lane of every row, with and without each short-circuit."""
    args = _score_inputs(K, B, cuda)
    want = tsf.score_fuse_batch(*args, backend="torch")
    before = tsf.score_fuse_batch.launches
    for kw in ({}, {"extrema": want.extrema}, {"cost_floor": want.c_min},
               {"extrema": want.extrema, "cost_floor": want.c_min}):
        got = tsf.score_fuse_batch(*args, **kw)
        torch.cuda.synchronize()
        for name in tsf.FusedScores._fields:
            assert _same(getattr(got, name), getattr(want, name)), (name, kw)
    assert tsf.score_fuse_batch.launches == before + 4


def test_pool_scan_kernel_on_adversarial_rows(cuda):
    rng = np.random.default_rng(5)
    B, K = 8, 3000
    s = np.sort(rng.uniform(0.0, 50.0, (B, K)), axis=1)[:, ::-1].copy()
    s[1, 10:] = 0.0                       # zero tail: newest == 0 stops it
    s[2, :] = s[2, 0]                     # all equal scores
    s[3, 5:] = -1.0                       # negative tail: clamped prefix sums
    c = rng.choice([2, 4, 8, 16], (B, K)).astype(np.float64)
    c[4] = 4.0
    req = np.array([64, 128, 96, 4096, 64, 1e5, 7, 1], np.float32)
    st, ct = (torch.tensor(x, dtype=torch.float32, device=cuda) for x in (s, c))
    rt = torch.tensor(req, device=cuda)
    for a, b in zip(tps.pool_scan(st, ct, rt),
                    tps.pool_scan(st, ct, rt, backend="torch")):
        assert torch.equal(a, b)
    head = st[:, :512].contiguous(), ct[:, :512].contiguous(), rt
    dense = tpool._prefix_allocations(*head)
    tiled = tpool._prefix_allocations(*head, impl="tiled")
    for a, b in zip(dense, tiled):
        assert torch.equal(a, b)


@pytest.mark.parametrize("K", [3000, 32768, 32771, 40960])
def test_pool_scan_kernel_on_late_and_missing_terminations(cuda, K):
    """B2 on rows that stop at k = 0, at the edges of its tiles and steps
    and never, on the 16-byte path (K = 32768), lane by lane (K % 4 != 0)
    and on rows that start off a 16-byte boundary."""
    plan = tps.pool_scan_plan(1, K)
    stops = stop_lanes(K, plan.cluster, plan.tile)
    s, c, req, n = scan_rows(K, stops, seed=K)
    st, ct, rt = (torch.as_tensor(x, device=cuda) for x in (s, c, req))
    csc = tps._clamped_prefix_sums(st)
    want = tps.pool_scan(st, ct, rt, csc, backend="torch")
    assert want[1][:n].tolist() == stops and bool(want[2][:n].all())
    assert not bool(want[2][n])                    # the row that never stops
    got = tps.pool_scan(st, ct, rt, csc)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    off = lambda x: torch.empty(x.numel() + 1, device=cuda)[1:].view(  # noqa: E731
        x.shape).copy_(x)
    for a, b in zip(tps.pool_scan(off(st), off(ct), rt, off(csc)), want):
        assert torch.equal(a, b)
    # two stops in different blocks' later tiles: each block ends at its
    # own, and the merge keeps the first
    step = plan.cluster * plan.tile
    pairs = [(x, y) for x, y in ((step + 10, step + plan.tile + 3),
                                 (3 * step + 10, 3 * step + plan.tile + 3),
                                 (2 * step + 2 * plan.tile, step + 5 * plan.tile),
                                 (4 * step + 10, 4 * step + plan.tile + 3))
             if max(x, y) < K]
    if pairs:
        two = torch.ones((len(pairs), K), device=cuda)
        for i, (x, y) in enumerate(pairs):
            two[i, x] = two[i, y] = 0.0
        ones, r2 = torch.ones_like(two), rt[:len(pairs)]
        csc2 = tps._clamped_prefix_sums(two)
        got = tps.pool_scan(two, ones, r2, csc2)
        want = tps.pool_scan(two, ones, r2, csc2, backend="torch")
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert got[1].tolist() == [min(x, y) for x, y in pairs]


def _device_items(fn):
    """Kernels and copies (memcpy / memset) of one call of ``fn`` after a
    warm-up call, by name and count, from a ``torch.profiler`` trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, copies = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            into = copies if e.key.startswith(("Memcpy", "Memset")) else kernels
            into[e.key] = into.get(e.key, 0) + e.count
    return kernels, copies


def test_one_launch_per_pool_scan_call_and_per_tick(cuda):
    """A B2 call is one kernel and nothing else on the device; a tick
    launches B3 once on every tier, and on the bf16 tier no other kernel
    (the column is encoded on the host, the kernel widens bf16 itself)."""
    K = 32768
    s, c, req, _ = scan_rows(K, [5], seed=1)
    st, ct, rt = (torch.as_tensor(x, device=cuda) for x in (s, c, req))
    csc = tps._clamped_prefix_sums(st)
    kernels, copies = _device_items(lambda: tps.pool_scan(st, ct, rt, csc))
    assert list(kernels.values()) == [1] and not copies, (kernels, copies)
    assert "pool_scan_kernel" in next(iter(kernels))
    cands = _world(4000, T=48, seed=2)
    rng = np.random.default_rng(2)
    for precision in ("float32", "int8", "bfloat16"):
        arch = RollingDeviceArchive(cands, device=cuda, capacity=48, name="x",
                                    precision=precision)
        kernels, _ = _device_items(
            lambda: arch.append(rng.uniform(0.0, 50.0, 4000)))
        b3 = sum(n for k, n in kernels.items() if "stats_update_kernel" in k)
        assert b3 == 1, (precision, kernels)
        if precision == "bfloat16":
            assert sum(kernels.values()) == 1, kernels


def test_main_path_matches_cpu_run(cuda):
    """Card against CPU on the card's statistics: score rows bit-identical,
    scans identical unless ``prefix_sum_tie`` flags an F1 tie."""
    cands = _world(6000, seed=3)
    server = BatchServer(device=cuda, bucket_sizes=(1, 8))
    archive = server.cache.get(cands)
    tsf.score_fuse_batch.launches = tps.pool_scan.launches = 0
    got = server.serve(archive, REQS)
    assert tsf.score_fuse_batch.launches > 0 and tps.pool_scan.launches > 0
    _hold_against_cpu(cuda, server, archive, cands, REQS, got)


def _hold_against_cpu(cuda, server, archive, cands, reqs, got):
    """``got`` (served on the card) against the same requests on the CPU on
    the card's statistics: score rows bit-identical, pools identical unless
    ``prefix_sum_tie`` flags an F1 tie."""
    stats = [x.cpu().numpy() for x in archive.score_stats()]
    cpu_archive = convert.archive_from_numpy(cands, stats, device="cpu")
    cpu_server = BatchServer(config=server.config, device="cpu",
                             bucket_sizes=server.bucket_sizes)
    want = cpu_server.serve(cpu_archive, reqs)
    batch = RequestBatch.from_requests(cands, reqs)
    gpu = server.engine.batch_arrays(cands, batch, archive=archive)
    cpu = cpu_server.engine.batch_arrays(cands, batch, archive=cpu_archive)
    for a, b in zip(gpu[:3], cpu[:3]):
        np.testing.assert_array_equal(a[batch.masks], b[batch.masks])
    caps = torch.where(torch.as_tensor(batch.use_cpus)[:, None],
                       cpu_archive.vcpus, cpu_archive.memory_gb)
    _, s, c = tpool._sort_masked(torch.as_tensor(cpu[0]), caps,
                                 torch.as_tensor(batch.masks))
    csc_cpu = tps._clamped_prefix_sums(s).numpy()
    csc_gpu = tps._clamped_prefix_sums(s.to(cuda)).cpu().numpy()
    for b, (x, y) in enumerate(zip(got, want)):
        if (list(zip(x.names, x.regions, x.azs))
                == list(zip(y.names, y.regions, y.azs))
                and np.array_equal(x.counts, y.counts)):
            continue
        runs = [(int(r[5][b]), bool(r[6][b])) for r in (gpu, cpu)]
        assert tpool.prefix_sum_tie(s[b].numpy(), c[b].numpy(),
                                    float(batch.amounts[b]), csc_cpu[b],
                                    csc_gpu[b], runs)[0], reqs[b]


def test_simulated_world_on_the_card_matches_cpu(cuda):
    """``tests/test_system.py``'s world through the port's simulator (every
    pool of its 2 regions, 800 accounts, USQS), ingested on the card and
    served through admission drains: pools equal the CPU run's on the
    card's statistics (F1 ties only), B1, B2 and B3 launched."""
    market = SpotMarket(Catalog(seed=11, n_regions=2), seed=11)
    targets = [(t.name, r, az) for t, r, az in market.pool_keys]
    col = DataCollector(SPSQueryService(market, n_accounts=800), targets,
                        CollectorConfig(ring_capacity=48, ring_dtype="int8"))
    col.run(24)
    config = EngineConfig(score_impl="tiled", pool_impl="tiled")
    ing = LiveIngestor(col, window=48, name="sim", device=cuda)
    arch = ing.prime()
    server = BatchServer(config=config, device=cuda, bucket_sizes=(1, 8))
    queue = AdmissionQueue(server, lambda: ing.archive, max_wait_s=0.0)
    tsf.score_fuse_batch.launches = tps.pool_scan.launches = 0
    tsu.stats_update.launches = 0
    for _ in range(6):
        col.run(1)
        assert ing.poll() == 1
    tickets = [queue.submit(r) for r in REQS]
    queue.drain(force=True)
    got = [t.result() for t in tickets]
    assert tsu.stats_update.launches == 6
    assert tsf.score_fuse_batch.launches > 0 and tps.pool_scan.launches > 0
    snap = arch.snapshot()
    assert all(r.diagnostics["archive_version"] == snap.version for r in got)
    _hold_against_cpu(cuda, server, snap, snap.host, REQS, got)


def test_load_harness_sheds_at_twice_capacity_on_the_card(cuda):
    """The load harness at 2x the card's measured capacity with
    ``shed_depth``: it sheds from a warmed pool cache, every ledger
    balances, every ticket resolves once."""
    cands = _world(6000, seed=4)
    server = BatchServer(device=cuda, bucket_sizes=(1, 4, 16))
    archive = DeviceArchive.stage(cands, device=cuda)
    mix = mixed_mix(cands, n_filters=4)
    reqs = [mix.sample(np.random.default_rng(1)) for _ in range(16)]
    server.serve(archive, reqs)
    best = min(_timed(lambda: server.serve(archive, reqs)) for _ in range(20))
    harness = LoadHarness(server, archive, max_wait_s=0.01, adaptive=True,
                          shed_depth=32)
    harness.warmup(mix)
    assert harness.warm_pool_cache(mix, n_samples=256) > 0
    tsf.score_fuse_batch.launches = tps.pool_scan.launches = 0
    rep = harness.run(mix, Steady(rate=2.0 * 16 / best), horizon_s=1.0,
                      seed=3)
    assert tsf.score_fuse_batch.launches > 0 and tps.pool_scan.launches > 0
    assert rep.shed > 0
    assert rep.submitted == rep.served + rep.shed
    assert rep.dropped == 0 and rep.errors == 0
    assert rep.latency.n == rep.served and rep.shed_latency.n == rep.shed


def _timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _offset(x, off):
    """A contiguous copy of ``x`` starting ``off`` elements into a fresh
    buffer: a row that is off a 16-byte boundary when ``off % 4 != 0``."""
    buf = torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)
    return buf[off:].view(x.shape).copy_(x)


@pytest.mark.parametrize("bounds", [((0, 334), (334, 668), (668, 1001)),
                                    ((0, 400), (400, 1001)), ((1, 401),)])
def test_score_fuse_phase0_and_given_scalar_emit_on_shards(cuda, bounds):
    """B1's phase-0 entry (reduce + merge kernel) and its emit with given
    extrema and C_min, on shard slices of K = 1001 whose offsets and
    lengths break the 16-byte path and on ones that keep it: bit-identical
    to the plain versions, one launch a call each."""
    cands = _world(1001, seed=7)
    full = DeviceArchive.stage(cands, device=cuda)
    stats = torch.stack(tuple(full.score_stats()))
    batch = RequestBatch.from_requests(cands, REQS)
    uniq, inv = _dedup_masks(batch.masks)
    on = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=cuda)  # noqa: E731
    vecs = set()
    for a, b in bounds:
        args = (_offset(stats[:, a:b].contiguous(), a), full.prices[a:b],
                full.vcpus[a:b], full.memory_gb[a:b], on(batch.masks[:, a:b]),
                on(batch.use_cpus), on(batch.amounts), on(uniq[:, a:b]))
        vecs.add(tsf.vec_ok(b - a, args[:4], (args[4], args[7])))
        before = tsf.score_fuse_phase0.launches
        ext, cmin = tsf.score_fuse_phase0(*args)
        assert tsf.score_fuse_phase0.launches == before + 1
        want_ext, want_cmin = tsf.score_fuse_phase0(*args, backend="torch")
        torch.cuda.synchronize()
        assert _same(ext, want_ext) and _same(cmin, want_cmin), (a, b)
        emit = (*args[:7], on(batch.lams), on(batch.weights), args[7], inv)
        got = tsf.score_fuse_batch(*emit, extrema=ext, cost_floor=cmin)
        want = tsf.score_fuse_batch(*emit, extrema=want_ext,
                                    cost_floor=want_cmin, backend="torch")
        torch.cuda.synchronize()
        for name in ("comb", "avail", "cost"):
            assert _same(getattr(got, name), getattr(want, name)), (a, b, name)
    # [0, 400) alone is a multiple of 4 long and starts on a boundary
    assert vecs == ({True, False} if len(bounds) == 2 else {False})


@pytest.mark.parametrize("n_shards,precision", [(3, "float32"), (4, "int8")])
def test_sharded_pools_on_the_card_match_single_device(cuda, n_shards,
                                                       precision):
    """Sharded archives on one card (K = 1001 and 5000): score rows and
    pools bit-identical to the single-device archive's, B1 phase 0 and its
    emit once a shard and batch, B2 once a batch."""
    from repro_torch.core import EngineConfig, RecommendationEngine
    from repro_torch.shard import ShardedArchive
    for K in (1001, 5000):
        cands = _world(K, seed=8)
        eng = RecommendationEngine(EngineConfig(score_impl="tiled"),
                                   device=cuda)
        single = DeviceArchive.stage(cands, device=cuda, precision=precision)
        sharded = ShardedArchive.stage(cands, n_shards=n_shards,
                                       devices=[cuda], precision=precision)
        batch = RequestBatch.from_requests(cands, REQS, pad_to=8)
        want = eng.batch_arrays(cands, batch, archive=single)
        tsf.score_fuse_phase0.launches = tsf.score_fuse_batch.launches = 0
        tps.pool_scan.launches = 0
        got = eng.batch_arrays(cands, batch, archive=sharded)
        assert tsf.score_fuse_phase0.launches == n_shards
        assert tsf.score_fuse_batch.launches == n_shards
        assert tps.pool_scan.launches == 1
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("precision", ["int8", "bfloat16"])
def test_quantized_archive_on_the_card_matches_cpu(cuda, precision):
    """A static quantised archive staged on the card: the CPU's codes and
    scale bit for bit, statistics within RTOL 1e-5 / ATOL 1e-4 of the
    CPU's (other summation orders), and decoded in 4096-row chunks
    bit-equal to the whole decoded window's."""
    from repro_torch.core import scoring
    from repro_torch.serve.archive import decoded_stats
    cands = _world(10000, T=200, seed=9)
    gpu = DeviceArchive.stage(cands, device=cuda, precision=precision)
    cpu = DeviceArchive.stage(cands, device="cpu", precision=precision)
    assert torch.equal(gpu.t3_q.cpu(), cpu.t3_q)
    assert torch.equal(gpu.scale.cpu(), cpu.scale)
    for a, b in zip(gpu.score_stats(), cpu.score_stats()):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-4)
    whole = scoring.candidate_stats(gpu.t3)
    for a, b in zip(decoded_stats(gpu.t3_q, gpu.scale, precision,
                                  chunk=4096), whole):
        assert torch.equal(a, b)


@pytest.mark.parametrize("quantized", [False, True])
def test_stats_update_kernel_matches_plain_version(cuda, quantized):
    """B3 against its plain version on the card over a growing and a
    sliding stream: moments and statistics bit-identical at every tick."""
    rng = np.random.default_rng(7)
    K, C = 3001, 64
    series = rng.uniform(0.0, 50.0, (K, C + 200))
    scale = None
    if quantized:
        scale_np = tcomp.candidate_scales(series, "int8")
        series = tcomp.quantize_window(series, scale_np, "int8").numpy()
        scale = torch.as_tensor(scale_np, device=cuda)
    win = series[:, :8]
    m = tsu.moments_from_window(win, scale=scale_np if quantized else None,
                                device=cuda)
    mk = mp = m
    on = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=cuda)  # noqa: E731
    for t in range(8, series.shape[1]):
        col = series[:, t]
        evict = win.shape[1] == C
        y_old = win[:, 0] if evict else col
        win = (np.concatenate([win[:, 1:], col[:, None]], axis=1) if evict
               else np.concatenate([win, col[:, None]], axis=1))
        args = (on(col), on(y_old), on(win[:, 0]), on(win[:, -1]),
                win.shape[1], evict)
        before = tsu.stats_update.launches
        mk, sk = tsu.stats_update(mk, *args, scale=scale)
        assert tsu.stats_update.launches == before + 1
        mp, sp = tsu.stats_update(mp, *args, scale=scale, backend="torch")
        for a, b in zip((*mk, *sk), (*mp, *sp)):
            assert _same(a, b)


@pytest.mark.parametrize("K", [3001, 4096, 524288, 524291])
@pytest.mark.parametrize("tier", ["float32", "int8", "bfloat16"])
def test_stats_update_kernel_on_every_tier(cuda, tier, K):
    """B3 against its plain version over a growing and a sliding stream on
    each tier, on blocks of one warp (K = 3001, 4096) and of 256 threads
    (524288, 524291): moments and statistics bit-identical at every tick.  The bf16 columns reach the kernel as bf16."""
    rng = np.random.default_rng(K)
    C, ticks = (64, 150) if K < 10 ** 5 else (16, 30)
    series = rng.uniform(0.0, 50.0, (K, C + ticks)).astype(np.float32)
    scale = scale_np = None
    cols = torch.as_tensor(series, device=cuda).T.contiguous()
    if tier == "int8":
        scale_np = tcomp.candidate_scales(series, "int8")
        series = tcomp.quantize_window(series, scale_np, "int8").numpy()
        scale = torch.as_tensor(scale_np, device=cuda)
        cols = torch.as_tensor(series, device=cuda).T.contiguous()
    elif tier == "bfloat16":
        cols = cols.to(torch.bfloat16)
        series = cols.T.float().cpu().numpy()
    mk = mp = tsu.moments_from_window(series[:, :8], scale=scale_np,
                                      device=cuda)
    lo = 0
    for t in range(8, series.shape[1]):
        evict = t - lo == C
        lo += evict
        args = (cols[t], cols[lo - 1] if evict else cols[t], cols[lo],
                cols[t], t + 1 - lo, evict)
        before = tsu.stats_update.launches
        mk, sk = tsu.stats_update(mk, *args, scale=scale)
        assert tsu.stats_update.launches == before + 1
        mp, sp = tsu.stats_update(mp, *args, scale=scale, backend="torch")
        for a, b in zip((*mk, *sk), (*mp, *sp)):
            assert _same(a, b), (tier, K, t)


def test_rolling_archive_on_the_card_matches_cpu(cuda):
    """The float32, int8 and bf16 rings on the card against the same rings
    on the CPU: stored windows, statistics and clip counts bit-identical."""
    cands = _world(4000, T=48, seed=9)
    rng = np.random.default_rng(9)
    for precision in ("float32", "int8", "bfloat16"):
        kw = dict(capacity=48, name="x", precision=precision)
        gpu = RollingDeviceArchive(cands, device=cuda, **kw)
        cpu = RollingDeviceArchive(cands, device="cpu", **kw)
        for _ in range(60):
            col = rng.uniform(0.0, 52.0, 4000)
            gpu.append(col)
            cpu.append(col)
        np.testing.assert_array_equal(gpu.materialize(), cpu.materialize())
        for a, b in zip(gpu.score_stats(), cpu.score_stats()):
            assert _same(a.cpu(), b)
        assert gpu.clipped_samples == cpu.clipped_samples


@pytest.mark.parametrize("E,C,D,F", [
    (64, 8, 2048, 1408),     # decode shape of DeepSeek-V2-Lite
    (8, 240, 2048, 1408),    # prefill rows (eight of the 64 experts)
    (3, 20, 200, 72),        # tails in C, D and F
    (2, 33, 136, 264),       # C between the tile heights
    (2, 5, 37, 19),          # rows not 16-byte aligned: both wrappers pad
])
def test_moe_gmm_kernels_match_plain_versions(cuda, E, C, D, F):
    g = torch.Generator(device=cuda).manual_seed(E * C + D)
    bf = lambda *s, k=1.0: (torch.randn(*s, generator=g, device=cuda) * k  # noqa: E731
                            ).to(torch.bfloat16)
    x, w1, w3, w2 = bf(E, C, D), bf(E, D, F, k=D ** -0.5), \
        bf(E, D, F, k=D ** -0.5), bf(E, F, D, k=F ** -0.5)
    before = (tgmm.moe_gmm.launches, tgmm.moe_gmm_down.launches)
    h = tgmm.moe_gmm(x, w1, w3)
    y = tgmm.moe_gmm_down(h, w2)
    torch.cuda.synchronize()
    assert (tgmm.moe_gmm.launches, tgmm.moe_gmm_down.launches) == (
        before[0] + 1, before[1] + 1)
    assert_within_ulp(h, tgmm.moe_gmm(x, w1, w3, backend="torch"))
    assert_within_ulp(y, tgmm.moe_gmm_down(h, w2, backend="torch"))


@pytest.mark.parametrize("C", [8, 17, 240, 300])
@pytest.mark.parametrize("F,D", [(1416, 200), (200, 1416), (72, 36)])
def test_moe_gmm_down_kernel_matches_plain_version(cuda, C, F, D):
    # F and D no multiples of B8's 64-deep stages or 128-column tiles; C
    # from decode's one m64 tile to two row groups; (72, 36) pads D to 40
    E = 3
    g = torch.Generator(device=cuda).manual_seed(C * F + D)
    h = torch.randn(E, C, F, generator=g, device=cuda).to(torch.bfloat16)
    w2 = (torch.randn(E, F, D, generator=g, device=cuda) * F ** -0.5).to(
        torch.bfloat16)
    before = tgmm.moe_gmm_down.launches
    y = tgmm.moe_gmm_down(h, w2)
    torch.cuda.synchronize()
    assert tgmm.moe_gmm_down.launches == before + 1
    assert_within_ulp(y, tgmm.moe_gmm_down(h, w2, backend="torch"))
    # an operand that starts off a 16-byte boundary is copied, not misread
    h_off = torch.empty(E * C * F + 1, dtype=torch.bfloat16, device=cuda)[1:]
    h_off = h_off.view(E, C, F).copy_(h)
    assert torch.equal(tgmm.moe_gmm_down(h_off, w2), y)


@pytest.mark.parametrize("C", [8, 17, 240, 300])
@pytest.mark.parametrize("D,F", [(1416, 200), (200, 1416), (72, 36)])
def test_moe_gmm_up_kernel_matches_plain_version(cuda, C, D, F):
    # D and F no multiples of B7's 64-deep stages or 64-column tiles; C
    # from decode's one m64 tile to two row groups; (72, 36) pads F to 40
    E = 3
    g = torch.Generator(device=cuda).manual_seed(C * D + F)
    x = torch.randn(E, C, D, generator=g, device=cuda).to(torch.bfloat16)
    w1, w3 = ((torch.randn(E, D, F, generator=g, device=cuda) * D ** -0.5).to(
        torch.bfloat16) for _ in range(2))
    before = tgmm.moe_gmm.launches
    h = tgmm.moe_gmm(x, w1, w3)
    torch.cuda.synchronize()
    assert tgmm.moe_gmm.launches == before + 1
    assert_within_ulp(h, tgmm.moe_gmm(x, w1, w3, backend="torch"))
    # an operand that starts off a 16-byte boundary is copied, not misread
    x_off = torch.empty(E * C * D + 1, dtype=torch.bfloat16, device=cuda)[1:]
    x_off = x_off.view(E, C, D).copy_(x)
    assert torch.equal(tgmm.moe_gmm(x_off, w1, w3), h)


def test_reduced_lm_on_the_card_matches_cpu(cuda):
    """The reduced DeepSeek-V2-Lite served on the card (B7/B8 launched in
    every MoE layer) against the same weights on the CPU."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import get_model
    from repro_torch.models.param import tree_map
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b").reduced(),
                              use_pallas=True)
    gpu, cpu = get_model(cfg, device=cuda), get_model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    gparams = tree_map(lambda t: t.to(cuda), params)
    prompt = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 72)))
    gc, cc = gpu.init_cache(2, 76), cpu.init_cache(2, 76)
    tgmm.moe_gmm.launches = 0
    lg, gc = gpu.prefill(gparams, {"tokens": prompt.to(cuda)}, gc)
    lc, cc = cpu.prefill(params, {"tokens": prompt}, cc)
    tok = lc[:, -1].float().argmax(-1, keepdim=True)
    for i in range(3):
        a, gc = gpu.decode_step(gparams, tok.to(cuda), gc, 72 + i)
        b, cc = cpu.decode_step(params, tok, cc, 72 + i)
        ref = b.float()
        assert float((a.float().cpu() - ref).abs().max()) <= 5e-2 * float(ref.abs().max())
        tok = ref[:, -1].argmax(-1, keepdim=True)
    assert tgmm.moe_gmm.launches == 4          # one MoE layer x 4 forwards
    ref = lc.float()
    assert float((lg.float().cpu() - ref).abs().max()) <= 5e-2 * float(ref.abs().max())


@pytest.mark.parametrize("B,S,H,D", [
    (16, 128, 64, 64),   # rwkv6-7b's prefill at the serving shape
    (2, 77, 3, 64),      # S not a multiple of the chunk
    (3, 20, 2, 16),      # shorter than a chunk; the reduced model's heads
    (1, 40, 5, 32),
])
def test_rwkv6_scan_kernel_matches_plain_version(cuda, B, S, H, D):
    g = torch.Generator(device=cuda).manual_seed(B * S + H * D)
    rnd = lambda *s: torch.randn(*s, generator=g, device=cuda)  # noqa: E731
    r, k, v = ((rnd(B, S, H, D) * 0.5).to(torch.bfloat16) for _ in range(3))
    log_w = -torch.exp(rnd(B, S, H, D) * 0.5 - 2.0)
    u, s0 = rnd(H, D) * 0.5, rnd(B, H, D, D) * 0.1
    before = twkv.rwkv6_scan.launches
    out, s_final = twkv.rwkv6_scan(r, k, v, log_w, u, s0)
    torch.cuda.synchronize()
    assert twkv.rwkv6_scan.launches == before + 1
    p_out, p_s = twkv.rwkv6_scan(r, k, v, log_w, u, s0, backend="torch")
    for got, want in ((out, p_out), (s_final, p_s)):
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("B,S,H,D", [
    (16, 128, 64, 64),   # rwkv6-7b's prefill at the serving shape
    (2, 77, 3, 64),      # S not a multiple of the chunk
])
def test_rwkv6_scan_kernel_over_the_full_decay_range(cuda, B, S, H, D):
    # log_w over the model's whole clamp range, -exp(U(-8, 4)), with every
    # seventh step at -exp(4): chunk cumsums pass -88, where a decay
    # factored against the chunk start would overflow float32
    rng = np.random.default_rng(B * S + D)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa: E731
    r, k, v = (f32(rng.standard_normal((B, S, H, D)) * 0.5).to(torch.bfloat16)
               for _ in range(3))
    lw = -np.exp(rng.uniform(-8.0, 4.0, (B, S, H, D)))
    lw[:, ::7] = -np.exp(4.0)
    log_w = f32(lw)
    u, s0 = f32(rng.standard_normal((H, D)) * 0.5), f32(
        rng.standard_normal((B, H, D, D)) * 0.1)
    assert float(torch.cumsum(log_w[:, :32], 1).min()) < -88.0
    out, s_final = twkv.rwkv6_scan(r, k, v, log_w, u, s0)
    torch.cuda.synchronize()
    p_out, p_s = twkv.rwkv6_scan(r, k, v, log_w, u, s0, backend="torch")
    for got, want in ((out, p_out), (s_final, p_s)):
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("B,S,R", [
    (16, 128, 2560),     # recurrentgemma-2b's prefill at the serving shape
    (2, 300, 100),       # three chunks, the last padded; channel tail
    (3, 50, 64),         # shorter than a chunk
    (1, 1, 33),
])
def test_rglru_scan_kernel_matches_plain_version(cuda, B, S, R):
    g = torch.Generator(device=cuda).manual_seed(B * S + R)
    log_a = -torch.rand((B, S, R), generator=g, device=cuda) * 2.0
    x_in = torch.randn((B, S, R), generator=g, device=cuda)
    h0 = torch.randn((B, R), generator=g, device=cuda)
    before = trg.rglru_scan.launches
    hs, h_last = trg.rglru_scan(log_a, x_in, h0)
    torch.cuda.synchronize()
    assert trg.rglru_scan.launches == before + 1
    p_hs, p_last = trg.rglru_scan(log_a, x_in, h0, backend="torch")
    assert _same(hs, p_hs) and _same(h_last, p_last)


@pytest.mark.parametrize("R", [1, 33, 2560, 2561])
@pytest.mark.parametrize("S", [1, 77, 127, 128, 129, 300])
def test_rglru_scan_kernel_bit_identical_on_edge_values(cuda, S, R):
    """B6's shuffle doubling against the plain version, with whole rows of
    log_a = 0 and -0 in x and h0; at R >= 2560, 16 batch rows, so that
    persistent blocks walk more than one tile."""
    B = 16 if R >= 2560 else 3
    rng = np.random.default_rng(S * 10007 + R)
    log_a = -rng.uniform(0.0, 2.0, (B, S, R)).astype(np.float32)
    log_a[:, rng.integers(0, S, max(1, S // 9))] = 0.0
    x_in = rng.standard_normal((B, S, R)).astype(np.float32)
    x_in.reshape(-1)[rng.integers(0, x_in.size, max(1, x_in.size // 31))] = -0.0
    x_in[:, 0, : (R + 1) // 2] = -0.0
    h0 = rng.standard_normal((B, R)).astype(np.float32)
    h0[:, ::3] = -0.0
    args = [torch.from_numpy(a).to(cuda) for a in (log_a, x_in, h0)]
    before = trg.rglru_scan.launches
    hs, h_last = trg.rglru_scan(*args)
    torch.cuda.synchronize()
    assert trg.rglru_scan.launches == before + 1
    p_hs, p_last = trg.rglru_scan(*args, backend="torch")
    assert _same(hs, p_hs) and _same(h_last, p_last)
    # -0 stays -0 only where the plain version keeps it (row 0 adds the
    # carry, every other row adds +0)
    assert torch.equal(torch.signbit(hs), torch.signbit(p_hs))


@pytest.mark.parametrize("arch,counter", [
    ("rwkv6-7b", twkv.rwkv6_scan), ("recurrentgemma-2b", trg.rglru_scan)],
    ids=["rwkv6", "recurrentgemma"])
def test_reduced_recurrent_lm_on_the_card_matches_cpu(cuda, arch, counter):
    """The reduced recurrent models served on the card (B5 or B6 launched
    in every recurrent layer's prefill) against the same weights on the
    CPU, past the reduced window."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import get_model
    from repro_torch.models.param import tree_map
    cfg = dataclasses.replace(get_config(arch).reduced(), use_pallas=True)
    gpu, cpu = get_model(cfg, device=cuda), get_model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    gparams = tree_map(lambda t: t.to(cuda), params)
    prompt = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40)))
    gc, cc = gpu.init_cache(2, 44), cpu.init_cache(2, 44)
    counter.launches = 0
    lg, gc = gpu.prefill(gparams, {"tokens": prompt.to(cuda)}, gc)
    lc, cc = cpu.prefill(params, {"tokens": prompt}, cc)
    n_rec = sum(k != "attn" for k in cfg.block_pattern) * cfg.num_units
    assert counter.launches == n_rec           # prefill only; decode is inline
    ref = lc.float()
    assert float((lg.float().cpu() - ref).abs().max()) <= 5e-2 * float(ref.abs().max())
    tok = ref[:, -1].argmax(-1, keepdim=True)
    for i in range(3):
        a, gc = gpu.decode_step(gparams, tok.to(cuda), gc, 40 + i)
        b, cc = cpu.decode_step(params, tok, cc, 40 + i)
        ref = b.float()
        assert float((a.float().cpu() - ref).abs().max()) <= 5e-2 * float(ref.abs().max())
        tok = ref[:, -1].argmax(-1, keepdim=True)
    assert counter.launches == n_rec


@pytest.mark.parametrize("S", [77, 300, 4000, 4096])
@pytest.mark.parametrize("G", [1, 7])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_kernel_matches_plain_version(cuda, D, G, S):
    B, KV = (1, 2) if S >= 4000 else (2, 2)
    g = torch.Generator(device=cuda).manual_seed(S * G + D)
    bf = lambda *s: torch.randn(*s, generator=g, device=cuda).to(torch.bfloat16)  # noqa: E731
    q, k, v = bf(B, S, KV * G, D), bf(B, S, KV, D), bf(B, S, KV, D)
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(q, k, v, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    plain = tfa.flash_attention(q, k, v, scale=D ** -0.5, backend="torch")
    far = assert_within_ulp(out, plain)
    print(f"B4 at {(B, S, KV * G, D)}: {far} of {out.numel()} beyond one ulp")


def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 2, 32), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention(q, q, q, scale=0.25)
    q = torch.zeros((1, 8, 2, 64), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        tfa.flash_attention(q, q, q, scale=0.125)


def _reduced_qwen(**over):
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config("qwen2-0.5b").reduced(head_dim=64),
                               **over)


def test_reduced_qwen_forward_on_the_card_matches_cpu(cuda):
    """The reduced qwen2-0.5b's full-sequence forward on the card (B4
    launched in every layer) against the same weights on the CPU."""
    from repro_torch.models import get_model
    from repro_torch.models.param import tree_map
    cfg = _reduced_qwen(use_pallas=True)
    gpu, cpu = get_model(cfg, device=cuda), get_model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    gparams = tree_map(lambda t: t.to(cuda), params)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 200)))
    tfa.flash_attention.launches = 0
    with torch.no_grad():
        lg, _ = gpu.forward(gparams, {"tokens": tokens.to(cuda)}, train=False)
        lc, _ = cpu.forward(params, {"tokens": tokens}, train=False)
    assert tfa.flash_attention.launches == cfg.num_layers
    ref = lc.float()
    dev = float((lg.float().cpu() - ref).abs().max() / ref.abs().max())
    print(f"reduced qwen2-0.5b forward, card vs CPU: {dev:.4g} of max|logits|")
    assert dev <= 5e-2


def test_reduced_train_step_on_the_card_matches_cpu(cuda):
    """One training step of the reduced qwen2-0.5b (plain attention route,
    two microbatches) on the card against the CPU from the same state."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import make_pipeline
    from repro_torch.models import get_model
    from repro_torch.models.param import tree_map
    from repro_torch.train import build_train_step, init_train_state
    from repro_torch.train.optim import tree_flatten
    cfg = _reduced_qwen()
    tcfg = TrainConfig(grad_accum=2, warmup_steps=2, total_steps=10)
    cpu = get_model(cfg, device="cpu")
    state = init_train_state(cpu, tcfg, torch.Generator().manual_seed(0))
    gstate = tree_map(lambda t: t.to(cuda), state)
    batch = make_pipeline(cfg, 72, 4, seed=1, device="cpu").batch(0)
    tfa.flash_attention.launches = 0
    gs, gm = build_train_step(get_model(cfg, device=cuda), tcfg)(
        gstate, {k: v.to(cuda) for k, v in batch.items()})
    cs, cm = build_train_step(cpu, tcfg)(state, batch)
    assert tfa.flash_attention.launches == 0
    for key in ("loss", "grad_norm", "lr"):
        rel = abs(float(gm[key]) - float(cm[key])) / abs(float(cm[key]))
        print(f"{key}: card {float(gm[key]):.7g}, CPU {float(cm[key]):.7g}")
        assert rel <= 1e-3, key
    want = tree_flatten(cs.opt.master)[0]
    norm = float(torch.sqrt(sum((t.double() ** 2).sum() for t in want)))
    worst = max(float((a.cpu().double() - b.double()).norm()) / norm
                for a, b in zip(tree_flatten(gs.opt.master)[0], want))
    print(f"master weights: worst leaf {worst:.3g} of the tree's norm")
    assert worst <= 2e-2

