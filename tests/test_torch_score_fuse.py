"""Port ``score_fuse`` (plain version) against the JAX reference.

Both packages get the same JAX-computed statistics, so what is compared is
the scoring stage itself:

- stat extrema and masked C_min are bit-equal (min and max are exact, the
  cost basis is single-rounded ops in the same order);
- the combined / availability / cost rows agree within RTOL 1e-5 /
  ATOL 1e-4 of ``tests/_score_helpers.py`` (XLA may contract the
  elementwise chain into fused multiply-adds; the port never does);
- against the reference's ``backend="lax"`` and the Pallas kernel in
  interpret mode.

The CUDA kernel is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import score_fuse as jsf
from repro_torch.kernels import score_fuse as tsf

from _score_helpers import ATOL, KW, RTOL, TILE, instance, kernel_args


def _case(seed, k=KW, use_cpus=True, req=129.25, lam=0.1, wt=0.5, mask=None):
    t3, prices, vcpus, mems = instance(seed, k)
    if mask is None:
        rng = np.random.default_rng(seed)
        mask = rng.random(k) < 0.7
        mask[rng.integers(0, k)] = True
    jargs = kernel_args(t3, prices, vcpus, mems, mask, use_cpus, req, lam, wt)
    targs = [np.array(a) for a in jargs]       # the same float32 bits
    return jargs, targs, mask


def _assert_rows(got, ref, mask):
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy()[mask], np.asarray(r)[mask],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend,interpret", [("lax", None), ("pallas", True)])
@pytest.mark.parametrize("k,seed,use_cpus,req", [
    (1, 0, True, 129.25), (TILE + 1, 4, False, 640.0), (KW, 5, True, 96.0)])
def test_rows_match_jax(k, seed, use_cpus, req, backend, interpret):
    jargs, targs, mask = _case(seed, k, use_cpus, req)
    ref = jsf.score_fuse(*jargs, tile=TILE, backend=backend,
                         interpret=interpret)
    got = tsf.score_fuse(*targs)
    _assert_rows(got, ref, mask)


@pytest.mark.parametrize("seed", range(3))
def test_extrema_and_cost_min_bit_equal(seed):
    jargs, targs, mask = _case(seed, use_cpus=bool(seed % 2))
    lo, hi = jsf.stat_extrema(jargs[0], jargs[1], jargs[2], jargs[6], tile=TILE)
    tlo, thi = tsf.stat_extrema(targs[0], targs[1], targs[2], mask)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(lo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(hi))
    ref = jsf.cost_min(*jargs[3:9])
    got = tsf.cost_min(*targs[3:9])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_batch_matches_per_request_and_reference():
    """One batched call (shared extrema per unique mask) gives each request
    the one-request result bit for bit, and the reference's extrema."""
    jargs, targs, _ = _case(6)
    rng = np.random.default_rng(6)
    uniq = rng.random((3, KW)) < 0.6
    uniq[:, 0] = True
    inv = np.array([0, 1, 0, 2, 2, 1])
    masks = uniq[inv]
    B = len(inv)
    use = rng.random(B) < 0.5
    amt = rng.uniform(32, 512, B).astype(np.float32)
    lam = rng.uniform(0.05, 0.3, B).astype(np.float32)
    wt = rng.uniform(0.1, 0.9, B).astype(np.float32)
    stats = torch.tensor(np.stack(targs[:3]))
    cat = [torch.tensor(a) for a in targs[3:6]]
    out = tsf.score_fuse_batch(stats, *cat, torch.as_tensor(masks),
                               torch.as_tensor(use), torch.tensor(amt),
                               torch.tensor(lam), torch.tensor(wt),
                               torch.as_tensor(uniq), inv)
    assert out.extrema.shape == (3, 6) and out.c_min.shape == (B,)
    for b in range(B):
        one = tsf.score_fuse(*targs[:6], masks[b], use[b], amt[b], lam[b],
                             wt[b])
        for x, y in zip((out.comb, out.avail, out.cost), one):
            assert torch.equal(x[b], y)
    for u in range(len(uniq)):
        lo, hi = jsf.stat_extrema(*jargs[:3], jnp.asarray(uniq[u]), tile=TILE)
        pairs = np.stack([np.asarray(lo), np.asarray(hi)], -1).reshape(6)
        np.testing.assert_array_equal(out.extrema[u].numpy(), pairs)


def test_extrema_and_cost_floor_short_circuits_are_bitwise():
    jargs, targs, mask = _case(9, req=200.0, lam=0.15, wt=0.4)
    lo, hi = tsf.stat_extrema(targs[0], targs[1], targs[2], mask)
    floor = tsf.cost_min(*targs[3:9])
    full = tsf.score_fuse(*targs)
    for kw in (dict(extrema=(lo, hi)), dict(cost_floor=floor),
               dict(extrema=(lo, hi), cost_floor=floor)):
        short = tsf.score_fuse(*targs, **kw)
        for a, b in zip(full, short):
            assert torch.equal(a, b)
    # a wider (merged) floor is used verbatim, as in the reference
    wide = jsf.score_fuse(*jargs, cost_floor=jnp.float32(float(floor) / 2),
                          tile=TILE, backend="lax")
    got = tsf.score_fuse(*targs, cost_floor=float(floor) / 2)
    _assert_rows(got, wide, mask)


def test_all_masked_semantics():
    """Cost +inf everywhere, availability 0, combined inf for W < 1 and NaN
    for W = 1 — the reference's documented direct-call behaviour."""
    _, targs, _ = _case(4, mask=np.zeros(KW, bool))
    comb, avail, cost = tsf.score_fuse(*targs)
    np.testing.assert_array_equal(avail.numpy(), np.zeros(KW))
    assert torch.isinf(cost).all() and torch.isinf(comb).all()
    targs[-1] = np.float32(1.0)
    comb1, _, _ = tsf.score_fuse(*targs)
    assert torch.isnan(comb1).all()


def test_float64_inputs_pinned_to_float32():
    _, targs, _ = _case(10)
    base = tsf.score_fuse(*targs)
    wide = tsf.score_fuse(*[torch.as_tensor(a, dtype=torch.float64)
                            if a.dtype == np.float32 else a for a in targs])
    for a, b in zip(base, wide):
        assert b.dtype == torch.float32
        assert torch.equal(a, b)


def test_batch_validates_its_inputs():
    _, targs, mask = _case(12)
    stats = torch.tensor(np.stack(targs[:3]))
    cat = [torch.tensor(a) for a in targs[3:6]]
    one = lambda v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
    args = [stats, *cat, torch.as_tensor(mask[None]), torch.tensor([True]),
            one(64.0), one(0.1), one(0.5)]
    tsf.score_fuse_batch(*args)
    with pytest.raises(ValueError, match="inv"):
        tsf.score_fuse_batch(*args, torch.as_tensor(mask[None]), [1])
    with pytest.raises(TypeError, match="stats"):
        tsf.score_fuse_batch(stats.double(), *args[1:])
    with pytest.raises(ValueError, match="masks"):
        tsf.score_fuse_batch(*args[:4], torch.as_tensor(mask[None, :-1]),
                             *args[5:])
    with pytest.raises(ValueError, match="backend"):
        tsf.score_fuse_batch(*args, backend="lax")
