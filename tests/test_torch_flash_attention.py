"""The port's flash attention (B4) and the full-sequence forward of the
reduced qwen2-0.5b against the reference, on the CPU.

Inputs come from numpy with a seed; bf16 values are carried between the
packages bit for bit.  Tolerances, with their reasons:

- B4's plain version against the Pallas body (interpret mode): at most 1%
  of elements beyond one bf16 ulp, none beyond 1e-2 * max|ref|.  The plain
  version repeats the body's arithmetic, but XLA's CPU ``exp`` is an ulp
  off the correctly rounded value about 10% of the time (ROADMAP C, F3),
  which can move an output across a bf16 rounding boundary.
- the wrapper against ``ref.flash_attention_ref``: none beyond 1e-2 *
  max|ref|; the share beyond one ulp is printed, not bounded.  The oracle
  rounds the scores to bf16 before a plain softmax (its einsum returns
  bf16), where the kernel keeps them in float32, so about a fifth of the
  outputs land more than an ulp away (measured 0.20-0.26, at most 6e-3 of
  max|ref|).  The interpreter fills the unread rows of a
  ragged key block with NaN, and the Pallas body multiplies them by p = 0,
  so at S = 160 (one block of 128 and one of 32) its output is NaN
  everywhere.  There the body runs with 32-key blocks, which divide S, and
  the plain version with the same blocks; the default blocks are held
  against the oracle.
- the reduced qwen2-0.5b ``Model.forward`` against the jitted reference on
  ``convert.params_from_jax`` weights: logits within 5e-2 * max|ref
  logits|, as for the other reduced models (one-ulp matmul-order flips are
  amplified by the random model; ROADMAP C, F4).

Each test prints what it measures.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _bf16_helpers import beyond_one_ulp
from repro.configs.registry import get_config as jax_config
from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro.models import get_model as jax_model
from repro_torch import convert
from repro_torch.configs.registry import get_config as torch_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattn
from repro_torch.models import get_model as torch_model

ARCH = "qwen2-0.5b"
LOGIT_TOL = 5e-2


def bf16(a):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def to_torch(a) -> torch.Tensor:
    return convert._tensor_from_numpy(np.asarray(a), torch.device("cpu"))


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def assert_close_bf16(got, want, label, *, frac=0.01, rel=1e-2):
    """At most ``frac`` of the elements beyond one bf16 ulp (unbounded when
    ``None``), none beyond ``rel * max|want|``; prints both measures."""
    d, far = beyond_one_ulp(f32(got), f32(want))
    scale = np.abs(f32(want)).max()
    print(f"{label}: {far.mean():.5f} beyond one ulp, max|d| / max|ref| = "
          f"{d.max() / scale:.3g}")
    assert frac is None or far.mean() <= frac, f"{far.mean():.4f} beyond one ulp"
    assert d.max() <= rel * scale, (d.max(), scale)


def _qkv(S, KV, G, D, seed=0, B=2):
    rng = np.random.default_rng(seed)
    return (bf16(rng.standard_normal((B, S, KV * G, D))),
            bf16(rng.standard_normal((B, S, KV, D))),
            bf16(rng.standard_normal((B, S, KV, D))))


# ---------------------------------------------------------------------------
# B4's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("G", [1, 7])
@pytest.mark.parametrize("S", [77, 160])
def test_plain_version_matches_pallas_body(S, G, D):
    q, k, v = _qkv(S, 2, G, D, seed=S + G + D)
    scale = D ** -0.5
    blk = tfa.BLOCK_K if S <= tfa.BLOCK_K else 32   # see the module docstring
    body = jfa.flash_attention(q, k, v, scale=scale, block_k=blk,
                               interpret=True)
    assert np.isfinite(f32(body)).all()
    tq, tk, tv = (to_torch(a) for a in (q, k, v))
    plain = tfa._flash_attention_torch(tq, tk, tv, scale=scale, block_k=blk)
    assert plain.dtype == torch.bfloat16
    assert_close_bf16(plain, body, f"S={S} G={G} D={D} blocks of {blk}, "
                                   "plain vs Pallas body")
    # the wrapper (default blocks) against the oracle
    got = tfa.flash_attention(tq, tk, tv, scale=scale)
    want = jref.flash_attention_ref(q, k, v, scale=scale)
    assert_close_bf16(got, want, f"S={S} G={G} D={D} default blocks, "
                                 "wrapper vs ref", frac=None)


def test_ragged_block_of_the_interpreter_is_nan():
    """Why the ragged case above runs the body with blocks that divide S."""
    q, k, v = _qkv(160, 1, 1, 16)
    out = f32(jfa.flash_attention(q, k, v, scale=0.25, interpret=True))
    print(f"interpret mode at S=160, 128-key blocks: "
          f"{np.isnan(out).mean():.3f} of the outputs NaN")
    assert np.isnan(out).all()
    got = tfa.flash_attention(*(to_torch(a) for a in (q, k, v)), scale=0.25)
    assert bool(torch.isfinite(got).all())


def test_non_causal_plain_version_matches_pallas_body():
    q, k, v = _qkv(96, 2, 3, 16, seed=9)
    body = jfa.flash_attention(q, k, v, scale=0.25, causal=False,
                               interpret=True)
    plain = tfa.flash_attention(*(to_torch(a) for a in (q, k, v)), scale=0.25,
                                causal=False)
    assert_close_bf16(plain, body, "non-causal, plain vs Pallas body")


def test_autograd_guard_raises():
    q, k, v = (to_torch(a) for a in _qkv(8, 1, 2, 16))
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        tfa.flash_attention(q, k, v, scale=0.25)
    with torch.no_grad():                 # the forward alone still runs
        assert tfa.flash_attention(q, k, v, scale=0.25).shape == q.shape


def test_wrapper_checks_its_inputs():
    q, k, v = (to_torch(a) for a in _qkv(8, 2, 2, 16))
    with pytest.raises(ValueError, match="group"):
        tfa.flash_attention(q[:, :, :3].contiguous(), k, v, scale=0.25)
    strided = q.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(strided, k, v, scale=0.25)
    with pytest.raises(ValueError, match="backend"):
        tfa.flash_attention(q, k, v, scale=0.25, backend="triton")


# ---------------------------------------------------------------------------
# the reduced qwen2-0.5b full-sequence forward
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen():
    cj = jax_config(ARCH).reduced()
    ct = torch_config(ARCH).reduced()
    pj = jax_model(cj).init(jax.random.key(0))
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    tokens = np.random.default_rng(12).integers(
        0, cj.vocab_size, (2, 72)).astype(np.int32)
    return cj, ct, pj, pt, tokens


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("use_pallas", [True, False], ids=["B4", "plain"])
def test_reduced_forward_matches_reference(qwen, use_pallas, train):
    cj, ct, pj, pt, tokens = qwen
    cj = dataclasses.replace(cj, use_pallas=use_pallas)
    ct = dataclasses.replace(ct, use_pallas=use_pallas)
    jm = jax_model(cj)
    want, aux_j = jax.jit(lambda p, t: jm.forward(p, {"tokens": t},
                                                  train=train))(
        pj, jnp.asarray(tokens))
    calls = tattn._chunked_attend
    chunked = []
    tattn._chunked_attend = lambda *a, **kw: chunked.append(1) or calls(*a, **kw)
    try:
        got, aux_t = torch_model(ct, device="cpu").forward(
            pt, {"tokens": torch.from_numpy(tokens)}, train=train)
    finally:
        tattn._chunked_attend = calls
    # 72 keys > 2 * attn_chunk (32): the plain route scans chunks
    assert len(chunked) == (0 if use_pallas else ct.num_layers)
    assert got.shape == want.shape == (2, 72, cj.vocab_size)
    assert float(aux_t) == float(aux_j) == 0.0
    dev = np.abs(f32(got) - f32(want)).max() / np.abs(f32(want)).max()
    print(f"use_pallas={use_pallas} train={train}: max|dlogits| / "
          f"max|logits| = {dev:.4g}")
    assert np.isfinite(f32(got)).all()
    assert dev <= LOGIT_TOL
