"""The kernel wrappers B4-B8 refuse autograd, on the CPU.

None of the hand-written kernels has a backward, and neither has the
reference's Pallas call (``jax.grad`` through it fails), so the reference
trains with ``use_pallas=False``.  An output written through a raw pointer
carries no autograd history: a wrapper that ran on inputs requiring grad
would drop their gradients silently.  So each wrapper raises
``NotImplementedError`` naming its kernel and the way out ("train with
use_pallas=False") when grad is enabled and an input requires grad, and
under ``torch.no_grad()`` returns exactly its plain version's result.
The guard sits before the route, so it holds on the card as here.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.kernels import rglru_scan as trg
from repro_torch.kernels import rwkv6_scan as twkv


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(torch.bfloat16)


def _f32(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _moe_gmm(rng):
    return tgmm.moe_gmm, (_bf16(rng, 2, 5, 16), _bf16(rng, 2, 16, 24, scale=0.25),
                          _bf16(rng, 2, 16, 24, scale=0.25)), {}


def _moe_gmm_down(rng):
    return tgmm.moe_gmm_down, (_bf16(rng, 2, 5, 24),
                               _bf16(rng, 2, 24, 16, scale=0.2)), {}


def _rwkv6_scan(rng):
    B, S, H, D = 1, 40, 2, 8
    return twkv.rwkv6_scan, (
        _bf16(rng, B, S, H, D), _bf16(rng, B, S, H, D), _bf16(rng, B, S, H, D),
        -torch.exp(_f32(rng, B, S, H, D)), _f32(rng, H, D, scale=0.1),
        _f32(rng, B, H, D, D, scale=0.1)), {}


def _rglru_scan(rng):
    B, S, R = 2, 20, 12
    return trg.rglru_scan, (-torch.exp(_f32(rng, B, S, R)), _f32(rng, B, S, R),
                            _f32(rng, B, R)), {}


def _flash_attention(rng):
    return tfa.flash_attention, (_bf16(rng, 1, 16, 4, 8), _bf16(rng, 1, 16, 2, 8),
                                 _bf16(rng, 1, 16, 2, 8)), {"scale": 8 ** -0.5}


CASES = {"moe_gmm (B7)": _moe_gmm, "moe_gmm_down (B8)": _moe_gmm_down,
         "rwkv6_scan (B5)": _rwkv6_scan, "rglru_scan (B6)": _rglru_scan,
         "flash attention (B4)": _flash_attention}


def _results(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("kernel", list(CASES))
@pytest.mark.parametrize("which", [0, -1], ids=["first", "last"])
def test_wrapper_refuses_inputs_that_require_grad(kernel, which):
    fn, args, kw = CASES[kernel](np.random.default_rng(0))
    want = _results(fn(*args, backend="torch", **kw))
    args = list(args)
    args[which] = args[which].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError) as err:
        fn(*args, **kw)
    assert kernel in str(err.value)
    assert "train with use_pallas=False" in str(err.value)
    launches = fn.launches
    with torch.no_grad():
        got = _results(fn(*args, **kw))
    assert fn.launches == launches           # the CPU never launches
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert not g.requires_grad
        assert torch.equal(g, w)


@pytest.mark.parametrize("kernel", list(CASES))
def test_inputs_without_grad_pass_while_grad_is_enabled(kernel):
    fn, args, kw = CASES[kernel](np.random.default_rng(1))
    assert torch.is_grad_enabled()
    for g, w in zip(_results(fn(*args, **kw)),
                    _results(fn(*args, backend="torch", **kw))):
        assert torch.equal(g, w)
