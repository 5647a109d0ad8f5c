"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips unless CUDA and nvcc are present (decided
inside the fixture, never at import).  Run them on a GPU machine with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Both kernels are built with ``--fmad=false`` and keep the plain version's
op order, so every output must be bit-identical.
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import pool as tpool
from repro_torch.core.engine import _dedup_masks
from repro_torch.core.types import CandidateSet, RequestBatch, ResourceRequest
from repro_torch.kernels import _build
from repro_torch.kernels import pool_scan as tps
from repro_torch.kernels import score_fuse as tsf
from repro_torch.serve import BatchServer, DeviceArchive

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


def test_main_path_matches_cpu_run(cuda):
    """Card against CPU on the card's statistics: score rows bit-identical,
    scans identical unless ``prefix_sum_tie`` flags an F1 tie."""
    cands = _world(6000, seed=3)
    server = BatchServer(device=cuda, bucket_sizes=(1, 8))
    archive = server.cache.get(cands)
    stats = [x.cpu().numpy() for x in archive.score_stats()]
    cpu_archive = convert.archive_from_numpy(cands, stats, device="cpu")
    cpu_server = BatchServer(device="cpu", bucket_sizes=(1, 8))
    tsf.score_fuse_batch.launches = tps.pool_scan.launches = 0
    got = server.serve(archive, REQS)
    assert tsf.score_fuse_batch.launches > 0 and tps.pool_scan.launches > 0
    want = cpu_server.serve(cpu_archive, REQS)
    batch = RequestBatch.from_requests(cands, REQS)
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
        if (list(x.names) == list(y.names)
                and np.array_equal(x.counts, y.counts)):
            continue
        runs = [(int(r[5][b]), bool(r[6][b])) for r in (gpu, cpu)]
        assert tpool.prefix_sum_tie(s[b].numpy(), c[b].numpy(),
                                    float(batch.amounts[b]), csc_cpu[b],
                                    csc_gpu[b], runs)[0], REQS[b]
