"""The port's RecurrentGemma serving path against the reference, on the CPU.

Inputs come from numpy with a seed and reach both packages as the same
values.  Checked:

- kernel B6's plain version (``repro_torch.kernels.rglru_scan``, which CPU
  tensors take) against the Pallas kernel in interpret mode and the
  sequential oracle ``repro.kernels.ref.rglru_scan_ref``, on sequences
  shorter than a chunk, of whole chunks and ragged;
- the model's plain route (``rglru_scan`` / ``rglru_chunked``, the
  associative scan in the reference's order), ``gelu`` on every bf16
  value with a normal result, and ``apply_rglru`` (prefill through B6 or
  the plain route, then decode) against the jitted reference;
- MQA/GQA attention: ``apply_gqa`` with a window and without a cache, with
  a cache (qkv bias), and the ring cache of ``min(max_len, window)`` slots
  across the window boundary, step by step;
- the reduced ``recurrentgemma-2b`` (two units of rglru, rglru, attn;
  d_model 64, window 16, ``use_pallas=True``) prefilled and decoded past
  its window in both packages on the same weights, the port fed the
  reference's tokens.

Tolerances, with their reasons:

- B6: its plain version follows the Pallas body op for op.  The reference
  on the CPU evaluates ``exp`` with XLA's own float32 approximation and
  contracts ``exp(la) * x_sh + x`` into one fused multiply-add; given that
  ``exp`` and a fused multiply-add (emulated in float64, exact for these
  products), the plain version equals the Pallas body bit for bit.  With
  PyTorch's ``exp`` and two roundings, as the kernel computes on the card,
  it stays within ``SCAN_TOL`` = 1e-6 of the largest magnitude (float32
  ulp level; measured under 5e-7).
- bf16 modules and the whole model: as in ``tests/test_torch_lm.py`` (at
  most 1% of elements beyond one bf16 ulp, none beyond 1e-2 * max|ref|;
  logits within ``LOGIT_TOL`` = 5e-2 * max|ref logits|).  On these seeds
  the rglru block, the ring-cache attention and the whole reduced model
  agree with the reference bit for bit; the test prints the deviation.
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
from repro.kernels import rglru_scan as jrg
from repro.models import attention as jattn
from repro.models import get_model as jax_model
from repro.models import lm as jlm
from repro.models import rglru as jrglru
from repro_torch import convert
from repro_torch.configs.registry import get_config as torch_config
from repro_torch.kernels import rglru_scan as trg
from repro_torch.models import attention as tattn
from repro_torch.models import get_model as torch_model
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import rglru as trglru

ARCH = "recurrentgemma-2b"
SCAN_TOL = 1e-6
LOGIT_TOL = 5e-2
B, S, T = 2, 40, 6           # prompt longer than the reduced window (16)


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


def _scan_inputs(Bn, Sn, R, seed=0):
    rng = np.random.default_rng(seed)
    la = (-rng.uniform(0.0, 2.0, (Bn, Sn, R))).astype(np.float32)
    xi = rng.standard_normal((Bn, Sn, R)).astype(np.float32)
    h0 = rng.standard_normal((Bn, R)).astype(np.float32)
    return la, xi, h0


def _xla_exp(t: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.array(jax.jit(jnp.exp)(t.numpy())))


def _fused_mul_add(a, b, c):
    """One rounding of a * b + c: the float32 product is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


SCAN_SHAPES = [
    (1, 16, 8),          # shorter than a chunk: one chunk of S
    (2, 50, 24),         # ragged everything
    (2, 128, 16),        # one whole chunk
    (1, 300, 40),        # three chunks, the last one padded
]


# ---------------------------------------------------------------------------
# kernel B6's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_b6_plain_follows_pallas_body_bit_for_bit(shape):
    la, xi, h0 = _scan_inputs(*shape)
    hs, h_last = trg._rglru_scan_torch(
        *(torch.from_numpy(a) for a in (la, xi, h0)), exp=_xla_exp,
        mul_add=_fused_mul_add)
    p_hs, p_last = jrg.rglru_scan(la, xi, h0, interpret=True)
    np.testing.assert_array_equal(hs.numpy(), np.asarray(p_hs))
    np.testing.assert_array_equal(h_last.numpy(), np.asarray(p_last))


@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_b6_plain_matches_pallas_interpret_and_oracle(shape):
    la, xi, h0 = _scan_inputs(*shape, seed=1)
    before = trg.rglru_scan.launches
    hs, h_last = trg.rglru_scan(*(torch.from_numpy(a) for a in (la, xi, h0)))
    assert trg.rglru_scan.launches == before      # CPU: no kernel launch
    p_hs, p_last = jrg.rglru_scan(la, xi, h0, interpret=True)
    assert_rel(hs, p_hs)
    assert_rel(h_last, p_last)
    o_hs, o_last = jref.rglru_scan_ref(*(jnp.asarray(a) for a in (la, xi, h0)))
    assert_rel(hs, o_hs, tol=1e-5)
    assert_rel(h_last, o_last, tol=1e-5)


def test_b6_wrapper_checks_its_inputs():
    la, xi, h0 = (torch.from_numpy(a) for a in _scan_inputs(2, 8, 4))
    with pytest.raises(TypeError):
        trg.rglru_scan(la.double(), xi, h0)
    with pytest.raises(ValueError):
        trg.rglru_scan(la, xi, h0[:, :2])
    with pytest.raises(ValueError):
        trg.rglru_scan(la, xi.transpose(0, 1).contiguous().transpose(0, 1), h0)
    with pytest.raises(ValueError):
        trg.rglru_scan(la, xi, h0, backend="cuda")


# ---------------------------------------------------------------------------
# the model's plain route and module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Sn,chunk", [(1, 16), (7, 16), (33, 64), (45, 16)])
def test_rglru_plain_route_matches_reference(Sn, chunk):
    la, xi, h0 = _scan_inputs(2, Sn, 12, seed=2)
    want = jax.jit(jrglru.rglru_chunked, static_argnums=3)(la, xi, h0, chunk)
    got = trglru.rglru_chunked(*(torch.from_numpy(a) for a in (la, xi, h0)), chunk)
    for g, w in zip(got, want):
        assert_rel(g, w)


def test_gelu_matches_reference_on_every_bf16_value():
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    x = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    xf = x.float()
    # finite values whose results are normal numbers (XLA flushes subnormal
    # inputs and results to zero; gelu(x) is about x / 2 near 0)
    keep = torch.isfinite(xf) & ((xf.abs() >= 2.0 ** -120) | (xf == 0))
    x = x[keep]
    want = f32(jax.jit(jax.nn.gelu)(bf16(x.float().numpy())))
    got = tlayers.gelu(x)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(got), want)


def _layer_weights(seed=0):
    """One rglru layer of the reduced config, its zero-initialised biases
    and the decay parameter drawn so that they matter."""
    cj = jax_config(ARCH).reduced()
    pj = dict(jax_model(cj).init(jax.random.key(seed))["unit"]["b0"]["mix"])
    pj = {name: a[0] for name, a in pj.items()}
    rng = np.random.default_rng(seed)
    for name in ("conv_b", "ba", "bx"):
        pj[name] = bf16(rng.standard_normal(pj[name].shape) * 0.3)
    pj["lam"] = jnp.asarray(rng.uniform(-1.0, 2.0, pj["lam"].shape), jnp.float32)
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    return pj, pt


@pytest.mark.parametrize("use_pallas", [True, False], ids=["b6", "plain"])
def test_apply_rglru_prefill_and_decode_match_reference(use_pallas):
    cj = dataclasses.replace(jax_config(ARCH).reduced(), use_pallas=use_pallas)
    ct = dataclasses.replace(torch_config(ARCH).reduced(), use_pallas=use_pallas)
    pj, pt = _layer_weights(seed=1)
    rng = np.random.default_rng(4)
    x = bf16(rng.standard_normal((B, 45, 64)) * 2)
    x1 = bf16(rng.standard_normal((B, 1, 64)) * 2)
    run = jax.jit(lambda p, x, s: jrglru.apply_rglru(cj, p, x, s))
    step = jax.jit(lambda p, x, s: jrglru.apply_rglru(cj, p, x, s, decode=True))
    yj, sj = run(pj, x, jrglru.init_rglru_state(cj, B))
    state = trglru.init_rglru_state(ct, B, "cpu")
    h_buf = state["h"]
    yt, st = trglru.apply_rglru(ct, pt, to_torch(x), state)
    assert st is state and st["h"] is h_buf      # written in place
    assert_close_bf16(yt, yj)
    assert_rel(st["h"], sj["h"], tol=1e-5)
    np.testing.assert_array_equal(f32(st["conv"]), f32(sj["conv"]))
    yj1, sj1 = step(pj, x1, sj)
    yt1, st1 = trglru.apply_rglru(ct, pt, to_torch(x1), st, decode=True)
    assert_close_bf16(yt1, yj1)
    assert_rel(st1["h"], sj1["h"], tol=1e-5)
    np.testing.assert_array_equal(f32(st1["conv"]), f32(sj1["conv"]))


# ---------------------------------------------------------------------------
# MQA / GQA attention
# ---------------------------------------------------------------------------

def _attn_weights(arch, seed=0):
    cj = jax_config(arch).reduced()
    pj = jax_model(cj).init(jax.random.key(seed))
    unit = pj["unit"]
    j = cj.block_pattern.index("attn")
    pj = jax.tree.map(lambda a: a[0], unit[f"b{j}"]["mix"])
    if "bq" in pj:                       # draw the zero-initialised biases
        rng = np.random.default_rng(seed)
        pj = {k: (bf16(rng.standard_normal(v.shape) * 0.3) if k[0] == "b" else v)
              for k, v in pj.items()}
    return pj, convert.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")


def test_apply_gqa_with_window_matches_reference():
    cj, ct = jax_config(ARCH).reduced(), torch_config(ARCH).reduced()
    pj, pt = _attn_weights(ARCH)
    x = bf16(np.random.default_rng(5).standard_normal((B, S, 64)) * 2)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    yj, _ = jax.jit(lambda p, x, pos: jattn.apply_gqa(
        cj, p, x, positions=pos, window=cj.window))(pj, x, jnp.asarray(pos))
    yt, cache = tattn.apply_gqa(ct, pt, to_torch(x),
                                positions=torch.from_numpy(pos.copy()),
                                window=ct.window)
    assert cache is None
    assert_close_bf16(yt, yj, frac=1e-3)


def test_apply_gqa_with_cache_matches_reference():
    arch = "qwen2-0.5b"                  # GQA kv=2 with a qkv bias
    cj, ct = jax_config(arch).reduced(), torch_config(arch).reduced()
    pj, pt = _attn_weights(arch, seed=2)
    rng = np.random.default_rng(6)
    x = bf16(rng.standard_normal((B, S, 64)) * 2)
    x1 = bf16(rng.standard_normal((B, 1, 64)) * 2)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    pos1 = np.full((B, 1), S, np.int32)

    def jrun(p, x, pos, cache, idx, valid):
        return jattn.apply_gqa(cj, p, x, positions=pos, cache=cache,
                               cache_index=idx, kv_valid=valid)

    jcache = jattn.init_kv_cache(cj, B, S + 2)
    yj, jcache = jax.jit(jrun)(pj, x, jnp.asarray(pos), jcache, jnp.int32(0),
                               jnp.int32(S))
    tcache = tattn.init_kv_cache(ct, B, S + 2)
    yt, tcache = tattn.apply_gqa(ct, pt, to_torch(x),
                                 positions=torch.from_numpy(pos.copy()),
                                 cache=tcache, cache_index=0, kv_valid=S)
    assert_close_bf16(yt, yj, frac=1e-3)
    for name in ("k", "v"):
        assert_close_bf16(tcache[name], jcache[name], frac=1e-3)
    yj1, _ = jax.jit(jrun)(pj, x1, jnp.asarray(pos1), jcache, jnp.int32(S),
                           jnp.int32(S + 1))
    yt1, _ = tattn.apply_gqa(ct, pt, to_torch(x1),
                             positions=torch.from_numpy(pos1), cache=tcache,
                             cache_index=S, kv_valid=S + 1)
    assert_close_bf16(yt1, yj1, frac=1e-3)


@pytest.mark.parametrize("prompt", [12, 40], ids=["within", "past"])
def test_ring_cache_across_the_window_boundary(prompt):
    """The windowed attention layer with its ring of min(max_len, window)
    slots: prefill, then decode steps until the ring has wrapped; the
    ring's keys, values and slot positions and each step's output against
    the reference."""
    cj, ct = jax_config(ARCH).reduced(), torch_config(ARCH).reduced()
    pj, pt = _attn_weights(ARCH, seed=3)
    W = cj.window
    steps = W + 4
    rng = np.random.default_rng(7)
    x = bf16(rng.standard_normal((B, prompt, 64)) * 2)
    pos = np.broadcast_to(np.arange(prompt, dtype=np.int32), (B, prompt))

    def jrun(p, x, pos, cache, idx, valid):
        return jlm._apply_attn(cj, p, x, pos, cache, idx, valid, False)

    jrun = jax.jit(jrun)
    max_len = prompt + steps
    jcache = jlm._layer_cache(cj, "attn", B, max_len)
    tcache = tlm._layer_cache(ct, "attn", B, max_len)
    assert tcache["k"].shape[1] == min(max_len, W) == W
    yj, jcache = jrun(pj, x, jnp.asarray(pos), jcache, jnp.int32(0),
                      jnp.int32(prompt))
    yt, tcache = tlm._apply_attn(ct, pt, to_torch(x),
                                 torch.from_numpy(pos.copy()), tcache, 0, prompt)
    assert_close_bf16(yt, yj, frac=1e-3)
    for i in range(steps):
        idx = prompt + i
        for name in ("k", "v"):
            assert_close_bf16(tcache[name], jcache[name], frac=1e-3)
        np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
        x1 = bf16(rng.standard_normal((B, 1, 64)) * 2)
        p1 = np.full((B, 1), idx, np.int32)
        yj, jcache = jrun(pj, x1, jnp.asarray(p1), jcache, jnp.int32(idx),
                          jnp.int32(idx + 1))
        yt, tcache = tlm._apply_attn(ct, pt, to_torch(x1), torch.from_numpy(p1),
                                     tcache, idx, idx + 1)
        assert_close_bf16(yt, yj, frac=1e-3)
    assert int(tcache["pos"].min()) == prompt + steps - W     # wrapped


# ---------------------------------------------------------------------------
# the whole reduced model: prefill + decode
# ---------------------------------------------------------------------------

def test_recurrentgemma_structure_is_ported():
    full = torch_model(torch_config(ARCH), device="cpu")
    assert full.num_params() == jax_model(jax_config(ARCH)).num_params() == 3_549_934_080
    model = torch_model(torch_config(ARCH).reduced(), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 40)
    assert params["unit"]["b0"]["mix"]["wa"].shape == (2, 64, 64)
    assert cache["unit"]["b2"]["k"].shape == (2, 2, 16, 1, 16)   # ring of 16
    assert cache["unit"]["b0"]["conv"].shape == (2, 2, 3, 64)
    assert torch_model(torch_config("qwen2-0.5b").reduced(),
                       device="cpu").structure()["unit"]["b0"]["mix"]["bq"].shape == (2, 4, 16)


@pytest.fixture(scope="module", params=[6, 5], ids=["units", "suffix"])
def served(request):
    """Both packages serve the same prompt on the same weights (6 layers:
    two whole units; 5: one unit and a suffix of two rglru layers); the
    port is fed the reference's greedy tokens."""
    over = dict(num_layers=request.param, use_pallas=True)
    cj = dataclasses.replace(jax_config(ARCH).reduced(), **over)
    ct = dataclasses.replace(torch_config(ARCH).reduced(), **over)
    jm, tm = jax_model(cj), torch_model(ct, device="cpu")
    pj = jm.init(jax.random.key(0))
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    prompt = np.random.default_rng(6).integers(0, cj.vocab_size, (B, S)).astype(np.int32)
    jcache, tcache = jm.init_cache(B, S + T), tm.init_cache(B, S + T)
    lj, jcache = jax.jit(jm.prefill)(pj, {"tokens": jnp.asarray(prompt)}, jcache)
    scan = trglru.rglru_kernel
    calls = []
    trglru.rglru_kernel = lambda *a, **kw: calls.append(1) or scan(*a, **kw)
    try:
        lt, tcache = tm.prefill(pt, {"tokens": torch.from_numpy(prompt).long()},
                                tcache)
    finally:
        trglru.rglru_kernel = scan
    n_rglru = sum(tlm._layer_kind(ct, i) == "rglru" for i in range(ct.num_layers))
    assert len(calls) == n_rglru            # B6 in every rglru layer's prefill
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

