"""The port's RWKV6 serving path against the reference, on the CPU.

Inputs come from numpy with a seed and reach both packages as the same
values.  Checked:

- kernel B5's plain version (``repro_torch.kernels.rwkv6_scan``, which CPU
  tensors take) against the Pallas kernel in interpret mode and against
  the sequential oracle ``repro.kernels.ref.rwkv6_scan_ref``, including
  sequences that are not a multiple of the 32-step chunk;
- the model's plain route ``wkv_chunked``, the decode step ``wkv_step``,
  the projections and ``apply_rwkv`` (prefill through B5 or the plain
  route, then decode) against the jitted reference;
- the reduced ``rwkv6-7b`` (2 layers, d_model 64, 4 heads of 16;
  ``use_pallas=True``) prefilled and decoded greedily in both packages on
  the same weights (``convert.params_from_jax``), the port fed the
  reference's tokens.

Tolerances, with their reasons:

- scans: float32 throughout, but the in-chunk cumsum, the contractions and
  float32 ``exp`` round differently in XLA and PyTorch (and the oracle is a
  sequential recurrence): outputs and states within ``SCAN_TOL`` = 2e-6 of
  the reference's largest magnitude (measured: at most 4.4e-7).
- bf16 modules: a bf16 matmul may sum in another order, and the decay's
  ``exp`` differs by an ulp between the libraries, so an output can sit one
  bf16 ulp off: at most 1% of the elements beyond one ulp, none beyond
  1e-2 * max|ref|.
- whole model: logits within ``LOGIT_TOL`` = 5e-2 * max|ref logits| at
  prefill and every decode step (``tests/test_torch_lm.py`` gives the
  reason), greedy tokens equal where the reference's top-1 / top-2 margin
  exceeds twice that.  The test prints the deviation it measures.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _bf16_helpers import beyond_one_ulp
from repro.configs.registry import get_config as jax_config
from repro.kernels import ref as jref
from repro.kernels import rwkv6_scan as jwkv
from repro.models import get_model as jax_model
from repro.models import rwkv6 as jrwkv
from repro_torch import convert
from repro_torch.configs.registry import get_config as torch_config
from repro_torch.kernels import rwkv6_scan as twkv
from repro_torch.models import get_model as torch_model
from repro_torch.models import rwkv6 as trwkv

ARCH = "rwkv6-7b"
SCAN_TOL = 2e-6
LOGIT_TOL = 5e-2
B, S, T = 2, 45, 5           # a prompt of one full chunk and a ragged one


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def to_torch(a) -> torch.Tensor:
    return convert._tensor_from_numpy(np.asarray(a), torch.device("cpu"))


def bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def assert_close_bf16(got, want, *, frac=0.01, rel=1e-2):
    d, far = beyond_one_ulp(f32(got), f32(want))
    assert far.mean() <= frac, f"{far.mean():.4f} beyond one ulp"
    assert d.max() <= rel * np.abs(f32(want)).max(), (d.max(), np.abs(f32(want)).max())


def assert_rel(got, want, tol=SCAN_TOL):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    dev = np.abs(got - want).max() / np.abs(want).max()
    assert dev <= tol, dev


def _scan_inputs(Bn, Sn, H, D, seed=0):
    """r/k/v in bf16, log decays in (-inf, 0) float32, u, s0 float32."""
    rng = np.random.default_rng(seed)
    r, k, v = (bf16(rng.standard_normal((Bn, Sn, H, D)) * 0.5) for _ in range(3))
    lw = jnp.asarray(-np.exp(rng.standard_normal((Bn, Sn, H, D)) * 0.5 - 2.0),
                     jnp.float32)
    u = jnp.asarray(rng.standard_normal((H, D)) * 0.5, jnp.float32)
    s0 = jnp.asarray(rng.standard_normal((Bn, H, D, D)) * 0.1, jnp.float32)
    return r, k, v, lw, u, s0


# ---------------------------------------------------------------------------
# kernel B5's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [
    (1, 16, 1, 8),       # shorter than a chunk: one chunk of S
    (2, 40, 2, 16),      # S not a multiple of 32
    (1, 64, 3, 32),      # whole chunks
    (2, 77, 2, 16),      # three chunks, ragged
    (1, 100, 2, 64),     # the model's head size
])
def test_b5_plain_matches_pallas_interpret_and_oracle(shape):
    args = _scan_inputs(*shape)
    before = twkv.rwkv6_scan.launches
    out, s_final = twkv.rwkv6_scan(*(to_torch(a) for a in args))
    assert twkv.rwkv6_scan.launches == before      # CPU: no kernel launch
    assert out.dtype == s_final.dtype == torch.float32
    assert tuple(out.shape) == shape
    p_out, p_s = jwkv.rwkv6_scan(*args, interpret=True)
    assert_rel(out, p_out)
    assert_rel(s_final, p_s)
    o_out, o_s = jref.rwkv6_scan_ref(*args)
    assert_rel(out, o_out)
    assert_rel(s_final, o_s)


def test_b5_wrapper_checks_its_inputs():
    r, k, v, lw, u, s0 = (to_torch(a) for a in _scan_inputs(1, 8, 2, 8))
    with pytest.raises(TypeError):
        twkv.rwkv6_scan(r, k, v, lw.double(), u, s0)
    with pytest.raises(ValueError):
        twkv.rwkv6_scan(r, k, v, lw, u[:1], s0)
    with pytest.raises(ValueError):
        twkv.rwkv6_scan(r.transpose(1, 2).contiguous().transpose(1, 2),
                        k, v, lw, u, s0)
    with pytest.raises(ValueError):
        twkv.rwkv6_scan(r, k, v, lw, u, s0, backend="cuda")


# ---------------------------------------------------------------------------
# the model's routes and module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 16])
def test_wkv_chunked_matches_reference(chunk):
    args = _scan_inputs(2, 50, 2, 16, seed=1)
    want = jax.jit(jrwkv.wkv_chunked, static_argnums=6)(*args, chunk)
    got = trwkv.wkv_chunked(*(to_torch(a) for a in args), chunk)
    for g, w in zip(got, want):
        assert_rel(g, w)


def test_wkv_step_matches_reference():
    r, k, v, lw, u, s0 = _scan_inputs(3, 1, 2, 16, seed=2)
    args = (r[:, 0], k[:, 0], v[:, 0], lw[:, 0], u, s0)
    want = jax.jit(jrwkv.wkv_step)(*args)
    got = trwkv.wkv_step(*(to_torch(a) for a in args))
    for g, w in zip(got, want):
        assert_rel(g, w)


def _layer_weights(seed=0):
    """One rwkv layer of the reduced config, with the zero-initialised
    token-shift weights, decay base and bonus drawn so that they matter."""
    cj = jax_config(ARCH).reduced()
    pj = dict(jax_model(cj).init(jax.random.key(seed))["unit"]["b0"]["mix"])
    pj = {name: a[0] for name, a in pj.items()}
    rng = np.random.default_rng(seed)
    for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
        pj[name] = bf16(rng.uniform(0.0, 1.0, pj[name].shape))
    pj["w0"] = jnp.asarray(rng.uniform(-2.0, 1.0, pj["w0"].shape), jnp.float32)
    pj["u"] = jnp.asarray(rng.standard_normal(pj["u"].shape) * 0.5, jnp.float32)
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    return pj, pt


def test_projections_match_reference():
    cj, ct = jax_config(ARCH).reduced(), torch_config(ARCH).reduced()
    pj, pt = _layer_weights()
    rng = np.random.default_rng(3)
    x = bf16(rng.standard_normal((B, S, 64)) * 2)
    x_prev = bf16(rng.standard_normal((B, 64)))
    want = jax.jit(lambda p, x, xp: jrwkv._projections(cj, p, x, xp))(pj, x, x_prev)
    got = trwkv._projections(ct, pt, to_torch(x), to_torch(x_prev))
    for g, w in zip(got[:4], want[:4]):          # r, k, v, g in bf16
        assert g.dtype == torch.bfloat16
        assert_close_bf16(g, w, frac=1e-3)
    assert got[4].dtype == torch.float32
    assert_rel(got[4], want[4], tol=1e-2)        # a LoRA product one ulp off


@pytest.mark.parametrize("use_pallas", [True, False], ids=["b5", "plain"])
def test_apply_rwkv_prefill_and_decode_match_reference(use_pallas):
    cj = dataclasses.replace(jax_config(ARCH).reduced(), use_pallas=use_pallas)
    ct = dataclasses.replace(torch_config(ARCH).reduced(), use_pallas=use_pallas)
    pj, pt = _layer_weights(seed=1)
    rng = np.random.default_rng(4)
    x = bf16(rng.standard_normal((B, S, 64)) * 2)
    x1 = bf16(rng.standard_normal((B, 1, 64)) * 2)
    run = jax.jit(lambda p, x, s: jrwkv.apply_rwkv(cj, p, x, s))
    step = jax.jit(lambda p, x, s: jrwkv.apply_rwkv(cj, p, x, s, decode=True))
    yj, sj = run(pj, x, jrwkv.init_rwkv_state(cj, B))
    state = trwkv.init_rwkv_state(ct, B, "cpu")
    s_buf = state["s"]
    yt, st = trwkv.apply_rwkv(ct, pt, to_torch(x), state)
    assert st is state and st["s"] is s_buf      # written in place
    assert_close_bf16(yt, yj)
    assert_rel(st["s"], sj["s"], tol=1e-3)
    np.testing.assert_array_equal(f32(st["x_prev"]), f32(sj["x_prev"]))
    yj1, sj1 = step(pj, x1, sj)
    yt1, st1 = trwkv.apply_rwkv(ct, pt, to_torch(x1), st, decode=True)
    assert_close_bf16(yt1, yj1)
    assert_rel(st1["s"], sj1["s"], tol=1e-3)


# ---------------------------------------------------------------------------
# the whole reduced model: prefill + decode
# ---------------------------------------------------------------------------

def test_rwkv_structure_is_ported():
    ct = torch_config(ARCH).reduced()
    model = torch_model(ct, device="cpu")
    full = torch_model(torch_config(ARCH), device="cpu")
    assert full.num_params() == jax_model(jax_config(ARCH)).num_params() == 8_876_462_080
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 8)
    assert cache["unit"]["b0"]["s"].shape == (2, 2, 4, 16, 16)
    assert params["unit"]["b0"]["mix"]["wr"].shape == (2, 64, 4, 16)


def _paths(tree, prefix=()):
    """``{path: leaf}`` of nested dicts and lists."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _paths(sub, prefix + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, sub in enumerate(tree)
                for p, v in _paths(sub, prefix + (i,)).items()}
    return {prefix: tree}


@pytest.mark.parametrize("arch", [ARCH, "recurrentgemma-2b", "qwen2-0.5b"])
def test_params_from_jax_carries_every_leaf(arch):
    """The reference's parameter tree lands on the port's structure leaf
    for leaf: the decay LoRA, ``u``, ``ln_x``, the conv, the RG-LRU gates
    and the MQA/GQA projections keep their layouts, bit for bit."""
    pj = jax.tree.map(np.asarray, jax_model(jax_config(arch).reduced()).init(
        jax.random.key(1)))
    pt = convert.params_from_jax(pj, device="cpu")
    ref, got = _paths(pj), _paths(pt)
    specs = _paths(torch_model(torch_config(arch).reduced(), device="cpu").structure())
    assert set(ref) == set(got) == set(specs)
    for path, a in ref.items():
        t, spec = got[path], specs[path]
        assert tuple(t.shape) == tuple(a.shape) == spec.shape, path
        assert t.dtype == spec.dtype, path
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)


@pytest.fixture(scope="module")
def served():
    """Both packages serve the same prompt on the same weights; the port is
    fed the reference's greedy tokens, so every step compares logits on the
    same context."""
    cj = dataclasses.replace(jax_config(ARCH).reduced(), use_pallas=True)
    ct = dataclasses.replace(torch_config(ARCH).reduced(), use_pallas=True)
    jm, tm = jax_model(cj), torch_model(ct, device="cpu")
    pj = jm.init(jax.random.key(0))
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    prompt = np.random.default_rng(6).integers(0, cj.vocab_size, (B, S)).astype(np.int32)
    jcache, tcache = jm.init_cache(B, S + T), tm.init_cache(B, S + T)
    lj, jcache = jax.jit(jm.prefill)(pj, {"tokens": jnp.asarray(prompt)}, jcache)
    scan = trwkv.rwkv6_scan
    calls = []
    trwkv.rwkv6_scan = lambda *a, **kw: calls.append(1) or scan(*a, **kw)
    try:
        lt, tcache = tm.prefill(pt, {"tokens": torch.from_numpy(prompt).long()},
                                tcache)
    finally:
        trwkv.rwkv6_scan = scan
    assert len(calls) == ct.num_layers      # B5 in every layer's prefill
    ref, got = [f32(lj)], [f32(lt)]
    decode = jax.jit(jm.decode_step)
    for i in range(T):
        tok = np.argmax(ref[-1][:, -1], -1)[:, None].astype(np.int32)
        lj, jcache = decode(pj, jnp.asarray(tok), jcache, jnp.int32(S + i))
        lt, tcache = tm.decode_step(pt, torch.from_numpy(tok).long(), tcache, S + i)
        ref.append(f32(lj))
        got.append(f32(lt))
    return ref, got


def test_whole_model_logits_match_reference(served):
    ref, got = served
    assert len(ref) == T + 1
    for step, (r, g) in enumerate(zip(ref, got)):
        assert g.shape == r.shape == (B, 1, 512)
        assert np.isfinite(g).all()
        dev = np.abs(g - r).max() / np.abs(r).max()
        print(f"step {step}: max|dlogits| / max|logits| = {dev:.4f}")
        assert dev <= LOGIT_TOL, (step, dev)


def test_whole_model_greedy_tokens_match_reference(served):
    ref, got = served
    undecided = 0
    for r, g in zip(ref, got):
        r, g = r[:, -1], g[:, -1]
        top2 = np.sort(r, axis=-1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] > 2 * LOGIT_TOL * np.abs(r).max()
        undecided += int((~decided).sum())
        np.testing.assert_array_equal(g.argmax(-1)[decided], r.argmax(-1)[decided])
    print(f"greedy tokens within the logit tolerance of a tie: {undecided} "
          f"of {B * (T + 1)}")
