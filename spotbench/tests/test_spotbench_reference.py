"""The plain reference against independent formulations and the port's CPU
path, at the cells' own size: every mix's requests; and the generated
inputs against the configuration's layout."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from spotbench import gen, harness, judge, spec  # noqa: E402
from spotbench import reference as ref  # noqa: E402

SEED = 2 ** 31 + 77          # more than 32 signed bits hold
CELLS = ("aws6400.mixed8", "aws6400.bulk64")


def test_window_stats_against_numpy():
    rng = np.random.default_rng(0)
    t3 = rng.uniform(0, 50, (64, 1008)).astype(np.float32)
    got = ref.window_stats(torch.as_tensor(t3), torch.float64).numpy()
    x = t3.astype(np.float64)
    t = np.arange(1008)
    area = np.trapezoid(x, axis=1)
    slope = np.polyfit(t, x.T, 1)[0]
    np.testing.assert_allclose(got[0], area, rtol=1e-12)
    np.testing.assert_allclose(got[1], slope, rtol=1e-9, atol=1e-15)
    np.testing.assert_allclose(got[2], x.std(1), rtol=1e-12)


def test_blocks_equal_whole():
    t3 = torch.as_tensor(np.random.default_rng(1).uniform(0, 50, (300, 40)))
    whole = ref.window_stats(t3, torch.float64)
    parts = ref.stats_in_blocks(lambda a, b: t3[a:b], 300, torch.float64,
                                block=64)
    assert torch.equal(whole, parts)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_algorithm1_against_the_loop(seed):
    """The reference's Algorithm 1 against a line-by-line loop of it."""
    rng = np.random.default_rng(seed)
    K = 500
    s = rng.uniform(0, 100, K)
    c = rng.choice([2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 96.0], K)
    for R in (64.0, 1000.0, 4096.0):
        req = {"cpus": R, "weight": 0.5, "lam": 0.1}
        st = torch.as_tensor(s)
        got = ref.pool(st, st, st, torch.ones(K, dtype=torch.float64),
                       torch.as_tensor(c), torch.ones(K, dtype=torch.bool),
                       req)
        order = np.argsort(-s, kind="stable")
        best, prev_top, iters = {}, np.inf, 0
        for k in range(K):
            pool = order[:k + 1]
            iters += 1
            x = np.ceil(s[pool] * R / (s[pool].sum() * c[pool]))
            if x[0] >= prev_top or x[-1] == 0:
                break
            best, prev_top = dict(zip(pool, x)), x[0]
        assert got.rows.tolist() == list(best)
        assert got.counts.tolist() == [int(v) for v in best.values()]
        assert got.iterations == iters


@pytest.mark.parametrize("name", CELLS)
def test_port_cpu_path_is_correct(name):
    """The port's CPU path (the kernels' plain versions) through the whole
    run of each cell, judged against the reference."""
    r = harness.run_cell(spec.cell(name), SEED, 1.0, False, device="cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["checks"]["score_err"]["value"] > 0   # float32 against float64


def test_reference_pools_equal_the_port_per_request():
    """Request by request on one archive: the reference's own pool and the
    port's recommend_batch agree bit for bit on every request of each mix
    (no near-tie on this seed)."""
    from repro_torch.core.engine import RecommendationEngine
    from repro_torch.core.types import CandidateSet, ResourceRequest
    from repro_torch.serve import DeviceArchive
    config = spec.cell(CELLS[0]).config
    cat = gen.catalog(config, SEED)
    cands = CandidateSet(names=cat.names, regions=cat.regions, azs=cat.azs,
                         families=cat.families, categories=cat.categories,
                         vcpus=cat.vcpus, memory_gb=cat.memory_gb,
                         prices=cat.prices, t3=cat.t3)
    arch = DeviceArchive.stage(cands, key="t", device="cpu")
    eng = RecommendationEngine(device="cpu")
    jd = judge.Judge(cat, "cpu")
    rows = cat.rows()
    stats = ref.window_stats(torch.as_tensor(cat.t3), torch.float64)
    for name in CELLS:
        specs = gen.Mix(config, spec.cell(name).traffic).requests(SEED, 0)
        recs = eng.recommend_batch(cands, [ResourceRequest(**s)
                                           for s in specs], archive=arch)
        for req, rec in zip(specs, recs):
            got = harness._answer(rec, cat, rows)
            readings, own = jd.readings(stats, req, got)
            assert judge.same_pool(got, own), req
            assert readings["decision_gap"] == 0.0
            assert readings["rank_gap"] == 0.0


def test_requests_are_seeded_never_empty_and_as_configured():
    cell = spec.cell(CELLS[1])
    config, traffic = cell.config, cell.traffic
    mix = gen.Mix(config, traffic)
    a = mix.requests(SEED, 5)
    assert a == gen.Mix(config, traffic).requests(SEED, 5)
    assert a != mix.requests(SEED, 6)
    assert a != mix.requests(SEED, 5, tag=gen.WARMUP_TAG)
    cat = gen.catalog(config, SEED)
    jd = judge.Judge(cat, "cpu")
    nodes = set(gen.node_counts(config).tolist())
    caps = {"cpus": set(cat.vcpus.tolist()),
            "memory_gb": set(cat.memory_gb.tolist())}
    assert len(a) == traffic["requests_per_call"]
    for req in a:
        assert bool(jd.mask(req).any())
        # the configuration's W and lambda, n nodes of a catalog type
        assert req["weight"] == config["weight"] and req["lam"] == config["lam"]
        axis = "cpus" if "cpus" in req else "memory_gb"
        assert any(req[axis] / n in caps[axis] for n in nodes), req


def test_catalog_is_seeded_and_laid_out_as_configured():
    config = spec.cell(CELLS[0]).config
    a, b = gen.catalog(config, SEED), gen.catalog(config, SEED)
    assert np.array_equal(a.t3, b.t3) and np.array_equal(a.prices, b.prices)
    assert not np.array_equal(a.t3, gen.catalog(config, SEED + 1).t3)
    n_types = sum(len(c["families"]) for c in config["categories"].values()
                  ) * len(config["sizes"])
    n_zones = sum(config["regions"].values())
    assert a.t3.shape == (n_types * n_zones, config["window"])
    assert len(a.rows()) == len(a)            # each (type, AZ) once
    for z in set(a.azs.tolist()):
        assert z.startswith(a.regions[a.azs == z][0])
    levels = {0.0, *map(float, gen.node_counts(config))}
    assert set(np.unique(a.t3).tolist()) == levels
    # one spot price a (type, region), whatever the zone
    for r in config["regions"]:
        p = a.prices[a.regions == r].reshape(-1, n_types)
        assert (p == p[0]).all()
