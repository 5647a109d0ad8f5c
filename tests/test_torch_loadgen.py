"""The port's load harness (``repro_torch.loadgen``) against ``repro.loadgen``.

Arrival processes and request mixes are the reference's numpy code: on the
same seed they give the same arrival times and the same requests.  The
harness drives the port's ``BatchServer`` and ``AdmissionQueue`` on the
CPU here (``device="cpu"``, the kernels' plain versions) and must keep the
invariants of ``tests/test_loadgen.py``: every ticket resolves exactly
once (``submitted == served + shed``, nothing dropped, no errors), every
full-path ticket is measured, the latency holds the admission deadline,
and 2x-style overload sheds from a warmed pool cache with degraded flags.
"""
from dataclasses import asdict

import numpy as np
import pytest

from repro.core.types import CandidateSet as JCandidateSet
from repro.loadgen import (MMPP2 as JMMPP2, Diurnal as JDiurnal,
                           Steady as JSteady,
                           distinct_mask_mix as jdistinct,
                           filterless_mix as jfilterless,
                           mixed_mix as jmixed)
from repro_torch.core import EngineConfig, ResourceRequest
from repro_torch.core.types import CandidateSet
from repro_torch.loadgen import (MMPP2, Diurnal, LoadHarness, RequestMix,
                                 Steady, VirtualClock, distinct_mask_mix,
                                 filterless_mix, mixed_mix)
from repro_torch.serve import BatchServer, DeviceArchive

from test_serve_batch import synth_candidates

K = 48
CPU = "cpu"


@pytest.fixture(scope="module")
def jcands():
    return synth_candidates(seed=31, K=K)


@pytest.fixture(scope="module")
def cands(jcands):
    return CandidateSet(**{k: getattr(jcands, k) for k in (
        "names", "regions", "azs", "families", "categories", "vcpus",
        "memory_gb", "prices", "t3")})


@pytest.fixture(scope="module")
def server():
    return BatchServer(bucket_sizes=(1, 4, 16), config=EngineConfig(),
                       device=CPU)


def staged(cands):
    return DeviceArchive.stage(cands, device=CPU)


# ---------------------------------------------------------------------------
# held against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pair", [
    (Steady(rate=50.0), JSteady(rate=50.0)),
    (Diurnal(base_rate=10.0, peak_rate=90.0, period_s=30.0),
     JDiurnal(base_rate=10.0, peak_rate=90.0, period_s=30.0)),
    (MMPP2(rate_low=10.0, rate_high=200.0, mean_low_s=5.0, mean_high_s=0.5),
     JMMPP2(rate_low=10.0, rate_high=200.0, mean_low_s=5.0,
            mean_high_s=0.5)),
], ids=["steady", "diurnal", "mmpp2"])
@pytest.mark.parametrize("seed", [0, 7])
def test_arrival_times_equal_reference(pair, seed):
    proc, jproc = pair
    got = proc.times(60.0, np.random.default_rng(seed))
    want = jproc.times(60.0, np.random.default_rng(seed))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and got.size > 0
    assert proc.mean_rate() == jproc.mean_rate()


@pytest.mark.parametrize("which", ["filterless", "distinct", "mixed"])
def test_sampled_requests_equal_reference(which, cands, jcands):
    mix, jmix = {
        "filterless": lambda: (filterless_mix(), jfilterless()),
        "distinct": lambda: (distinct_mask_mix(cands, n_filters=12, seed=3),
                             jdistinct(jcands, n_filters=12, seed=3)),
        "mixed": lambda: (mixed_mix(cands, n_filters=6),
                          jmixed(jcands, n_filters=6)),
    }[which]()
    assert mix.filters == jmix.filters
    assert mix.n_signatures == jmix.n_signatures
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(64):
        a, b = mix.sample(rng), jmix.sample(jrng)
        assert asdict(a) == asdict(b)
        assert a.signature() == b.signature()
        np.testing.assert_array_equal(a.filter_mask(cands),
                                      b.filter_mask(jcands))
    assert isinstance(jcands, JCandidateSet)


# ---------------------------------------------------------------------------
# the reference's invariants, on the port
# ---------------------------------------------------------------------------

def test_arrivals_hit_mean_rate_and_validate():
    for proc in (Steady(rate=80.0),
                 Diurnal(base_rate=20.0, peak_rate=140.0, period_s=25.0),
                 MMPP2(rate_low=20.0, rate_high=300.0, mean_low_s=2.0,
                       mean_high_s=0.25)):
        n = len(proc.times(400.0, np.random.default_rng(0)))
        assert abs(n - proc.mean_rate() * 400.0) / (proc.mean_rate() * 400.0) \
            < 0.15
    with pytest.raises(ValueError):
        Steady(rate=0.0)
    with pytest.raises(ValueError):
        Diurnal(base_rate=5.0, peak_rate=1.0, period_s=10.0)
    with pytest.raises(ValueError):
        MMPP2(rate_low=1.0, rate_high=2.0, mean_low_s=0.0, mean_high_s=1.0)


def test_harness_steady_ledger_balances(cands, server):
    h = LoadHarness(server, staged(cands), max_wait_s=0.02)
    mix = mixed_mix(cands, n_filters=6)
    assert h.warmup(mix) == sum(server.bucket_sizes)
    rep = h.run(mix, Steady(rate=200.0), horizon_s=3.0, seed=1)
    assert rep.submitted > 300
    assert rep.submitted == rep.served + rep.shed
    assert rep.dropped == 0 and rep.errors == 0 and rep.shed == 0
    assert rep.latency.n == rep.served
    assert rep.batch_latency.n == rep.drains > 0
    d = rep.to_dict()
    assert d["dropped"] == 0 and d["latency"]["n"] == rep.served


def test_harness_latency_includes_queueing_and_service(cands, server):
    h = LoadHarness(server, staged(cands), max_wait_s=0.05)
    mix = filterless_mix()
    h.warmup(mix)
    rep = h.run(mix, MMPP2(rate_low=2.0, rate_high=8.0, mean_low_s=1.0,
                           mean_high_s=0.5), horizon_s=4.0, seed=2)
    assert rep.served > 0 and rep.dropped == 0
    assert rep.latency.quantile(0.5) >= 0.04


def test_harness_sheds_under_overload(cands, server):
    h = LoadHarness(server, staged(cands), max_wait_s=0.01, adaptive=True,
                    shed_depth=12, service_time_scale=200.0)
    mix = mixed_mix(cands, n_filters=4)
    h.warmup(mix)
    warmed = h.warm_pool_cache(mix, n_samples=256)
    assert warmed > 0 and len(h.pool_cache) == warmed
    rep = h.run(mix, Steady(rate=800.0), horizon_s=1.5, seed=3)
    assert rep.shed > 0
    assert rep.submitted == rep.served + rep.shed
    assert rep.dropped == 0 and rep.errors == 0
    assert rep.shed_latency.n == rep.shed
    assert rep.extra["pool_cache_len"] > 0


def test_distinct_mask_mix_distinct(cands):
    mix = distinct_mask_mix(cands, n_filters=12)
    rng = np.random.default_rng(0)
    window = [mix.sample(rng) for _ in range(12)]
    masks = {r.filter_mask(cands).tobytes() for r in window}
    assert len(masks) == 12
    assert all(r.filter_mask(cands).any() for r in window)
    assert isinstance(window[0], ResourceRequest)


def test_virtual_clock_and_empty_mix():
    c = VirtualClock()
    c.advance(1.5)
    assert c() == 1.5
    with pytest.raises(ValueError):
        c.advance(-0.1)
    with pytest.raises(ValueError):
        RequestMix(name="empty", filters=[])
