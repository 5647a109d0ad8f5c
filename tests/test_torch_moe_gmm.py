"""Kernels B7/B8's plain PyTorch versions against the reference's MoE
grouped matmuls.

Inputs come from numpy with a seed and go, as the same bf16 values, through

- ``repro.kernels.moe_gmm.moe_gmm`` / ``moe_gmm_down`` in interpret mode
  (the Pallas kernel bodies, float32 accumulators, as ``tests/test_kernels.py``
  runs them), with block sizes that leave tails in C, D and F;
- ``repro.kernels.ref.moe_gmm_ref`` / ``moe_gmm_down_ref`` on the float32
  values of the same inputs (the oracle without bf16 intermediates);
- ``repro_torch.kernels.moe_gmm`` on CPU tensors, which takes the plain
  version.

Tolerance: every element within one bf16 ulp of the reference value, or
within 1e-3 * max|reference|.  The float32 sums run in another order in
XLA and in PyTorch, so an element near a bf16 rounding boundary can land
on the neighbouring value; nothing else may differ.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _bf16_helpers import assert_within_ulp
from repro.kernels import moe_gmm as jgmm
from repro.kernels import ref as jref
from repro_torch.kernels import moe_gmm as tgmm

SHAPES = [(3, 20, 200, 72), (4, 8, 128, 64), (2, 1, 24, 8), (2, 40, 72, 136)]


def _inputs(E, C, D, F, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, D)).astype(np.float32) * 0.5
    w1 = rng.standard_normal((E, D, F)).astype(np.float32) * 0.1
    w3 = rng.standard_normal((E, D, F)).astype(np.float32) * 0.1
    w2 = rng.standard_normal((E, F, D)).astype(np.float32) * 0.1
    return [np.asarray(jnp.asarray(a).astype(jnp.bfloat16)) for a in (x, w1, w3, w2)]


def _t(a) -> torch.Tensor:
    """A numpy bf16 array as a torch bf16 tensor, bit for bit."""
    return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("E,C,D,F", SHAPES)
def test_up_matches_pallas_interpret_and_oracle(E, C, D, F):
    x, w1, w3, _ = _inputs(E, C, D, F)
    got = tgmm.moe_gmm(_t(x), _t(w1), _t(w3))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (E, C, F)
    got = got.float().numpy()
    pallas = jgmm.moe_gmm(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w3),
                          block_c=8, block_f=32, block_d=64, interpret=True)
    assert_within_ulp(got, _f32(pallas))
    oracle = jref.moe_gmm_ref(*(jnp.asarray(_f32(a)) for a in (x, w1, w3)))
    assert_within_ulp(got, np.asarray(oracle))


@pytest.mark.parametrize("E,C,D,F", SHAPES)
def test_down_matches_pallas_interpret_and_oracle(E, C, D, F):
    x, w1, w3, w2 = _inputs(E, C, D, F, seed=1)
    h = np.asarray(jgmm.moe_gmm(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w3),
                                interpret=True))
    got = tgmm.moe_gmm_down(_t(h), _t(w2)).float().numpy()
    pallas = jgmm.moe_gmm_down(jnp.asarray(h), jnp.asarray(w2), block_c=8,
                               block_d=64, block_f=32, interpret=True)
    assert_within_ulp(got, _f32(pallas))
    oracle = jref.moe_gmm_down_ref(jnp.asarray(_f32(h)), jnp.asarray(_f32(w2)))
    assert_within_ulp(got, np.asarray(oracle))


def test_float32_inputs_match_reference():
    rng = np.random.default_rng(2)
    x, w1, w3 = (rng.standard_normal(s).astype(np.float32)
                 for s in ((2, 12, 40), (2, 40, 24), (2, 40, 24)))
    got = tgmm.moe_gmm(*(torch.from_numpy(a) for a in (x, w1, w3)))
    assert got.dtype == torch.float32
    want = jgmm.moe_gmm(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w3),
                        block_c=8, block_f=16, block_d=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cpu_takes_plain_version_and_counts_no_launch():
    x, w1, w3, w2 = _inputs(2, 8, 16, 8)
    before = (tgmm.moe_gmm.launches, tgmm.moe_gmm_down.launches)
    a = tgmm.moe_gmm(_t(x), _t(w1), _t(w3))
    b = tgmm.moe_gmm(_t(x), _t(w1), _t(w3), backend="torch")
    assert torch.equal(a, b)
    tgmm.moe_gmm_down(a, _t(w2))
    assert (tgmm.moe_gmm.launches, tgmm.moe_gmm_down.launches) == before


@pytest.mark.parametrize("case", ["shape", "contiguous", "dtype", "backend"])
def test_wrapper_rejects_bad_operands(case):
    x, w1, w3, _ = (_t(a) for a in _inputs(2, 8, 16, 8))
    if case == "shape":
        with pytest.raises(ValueError, match="w3 must have shape"):
            tgmm.moe_gmm(x, w1, w3[:, :8])
    elif case == "contiguous":
        with pytest.raises(ValueError, match="contiguous"):
            tgmm.moe_gmm(x, w1.transpose(1, 2).contiguous().transpose(1, 2), w3)
    elif case == "dtype":
        with pytest.raises(TypeError, match="w1 must be"):
            tgmm.moe_gmm(x, w1.float(), w3)
    else:
        with pytest.raises(ValueError, match="backend"):
            tgmm.moe_gmm(x, w1, w3, backend="triton")


def test_ulp_helper_is_one_bf16_step():
    assert assert_within_ulp(np.array([1.0 + 2 ** -7]), np.array([1.0])) == 0
    with pytest.raises(AssertionError):
        assert_within_ulp(np.array([1.0 + 2 ** -6, 1.0]), np.array([1.0, 1.0]))
