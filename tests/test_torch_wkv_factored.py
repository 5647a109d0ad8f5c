"""The algebra of kernel B5 (``csrc/rwkv6_scan.cu``), mirrored in float32
PyTorch on the CPU and held against the reference over the model's whole
decay range.

The kernel splits each 32-step chunk into two sub-chunks of 16 rows at
boundary b = 15.  Inside each sub-chunk it keeps the Pallas body's
pairwise decay ``exp(clip(cw_{i-1} - cw_j, -60, 0))``; between them (i >=
16 > j) it factors the decay as ``q~_i = r_i exp(cw_{i-1} - cw_b)`` times
``k~_j = k_j exp(cw_b - cw_j)``, both exponents <= 0.  The model clamps a
step's log decay to ``-exp(4)`` = -54.6, so a chunk's cumsum passes -88,
where a factorisation against the chunk start (``exp(-cw_j)``) overflows
float32; these tests draw ``log_w = -exp(U(-8, 4))`` with whole rows at
-54.6 so that the hazard is present, and check that every intermediate of
the mirror stays finite.

``mirror`` below is that algebra (not the kernel's summation order or its
3xTF32 products: the card tests hold those).  It is held against the port's
plain version ``wkv_chunked`` and the reference's Pallas body in interpret
mode, each output within ``TOL`` = 1e-4 of the reference's max|.| (the
kernel's contract on the card); the measured deviation is printed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rwkv6_scan as jwkv
from repro_torch import convert
from repro_torch.kernels import rwkv6_scan as twkv

TOL = 1e-4
CHUNK = twkv.CHUNK
SUB = CHUNK // 2             # the kernel's sub-chunk; boundary b = SUB - 1
MAX_DECAY = float(np.exp(4.0))   # the model's clamp: log_w >= -exp(4)


def mirror(r, k, v, log_w, u, s0, seen=None):
    """Kernel B5's per-chunk algebra in float32: chunks of ``CHUNK`` rows
    (the last zero-padded), cw_{i-1} as the previous row's cumsum, pairwise
    decays in the two diagonal sub-blocks, the factored off-diagonal
    block.  ``seen`` collects every intermediate by name."""
    B, S, H, D = r.shape
    n = -(-S // CHUNK)
    pad = n * CHUNK - S
    split = lambda a: torch.nn.functional.pad(  # noqa: E731
        a.float(), (0, 0, 0, 0, 0, pad)).reshape(B, n, CHUNK, H, D)
    rc, kc, vc, wc = split(r), split(k), split(v), split(log_w)
    seen = {} if seen is None else seen
    keep = lambda **kw: [seen.setdefault(k, []).append(x)  # noqa: E731
                         for k, x in kw.items()]
    low = torch.tril(torch.ones(SUB, SUB, dtype=torch.bool), -1)[None, :, :, None]
    s, outs, b = s0.float(), [], SUB - 1
    for c in range(n):
        rb, kb, vb, wb = rc[:, c], kc[:, c], vc[:, c], wc[:, c]
        cw = torch.cumsum(wb, 1)
        cwp = torch.nn.functional.pad(cw, (0, 0, 0, 0, 1, 0))[:, :CHUNK]
        rdec = rb * torch.exp(cwp)
        inter = torch.einsum("bihk,bhkv->bihv", rdec, s)
        att = torch.zeros(B, CHUNK, CHUNK, H)
        for lo in (0, SUB):
            rows = slice(lo, lo + SUB)
            decay = torch.exp(torch.clamp(
                cwp[:, rows, None] - cw[:, None, rows], -60.0, 0.0))
            keep(decay=decay)
            att[:, rows, rows] = torch.einsum(
                "bihd,bijhd,bjhd->bijh", rb[:, rows], decay, kb[:, rows]) * low
        q_t = rb[:, SUB:] * torch.exp(torch.clamp(
            cwp[:, SUB:] - cw[:, b:b + 1], max=0.0))
        k_t = kb[:, :SUB] * torch.exp(torch.clamp(
            cw[:, b:b + 1] - cw[:, :SUB], max=0.0))
        att[:, SUB:, :SUB] = torch.einsum("bihd,bjhd->bijh", q_t, k_t)
        intra = torch.einsum("bijh,bjhv->bihv", att, vb)
        bonus = (rb * u * kb).sum(-1, keepdim=True) * vb
        outs.append(inter + intra + bonus)
        k_state = kb * torch.exp(cw[:, -1:] - cw)
        s = torch.exp(cw[:, -1])[..., None] * s + torch.einsum(
            "bjhk,bjhv->bhkv", k_state, vb)
        keep(cw=cw, rdec=rdec, q_t=q_t, k_t=k_t, att=att, k_state=k_state,
             s=s, out=outs[-1])
    out = torch.stack(outs, 1).reshape(B, n * CHUNK, H, D)[:, :S]
    return out, s


def _inputs(B, S, H, D, decay, seed):
    """numpy-seeded r/k/v (bf16 values), log_w, u, s0 as float32 arrays."""
    rng = np.random.default_rng(seed)
    rkv = [np.asarray(jnp.asarray(rng.standard_normal((B, S, H, D)) * 0.5,
                                  jnp.bfloat16).astype(jnp.float32))
           for _ in range(3)]
    if decay == "full":
        # the model's whole range, and whole rows at its clamp
        lw = -np.exp(rng.uniform(-8.0, 4.0, (B, S, H, D)))
        lw[:, ::7] = -MAX_DECAY
    else:
        # the card test's mild range
        lw = -np.exp(rng.standard_normal((B, S, H, D)) * 0.5 - 2.0)
    u = rng.standard_normal((H, D)) * 0.5
    s0 = rng.standard_normal((B, H, D, D)) * 0.1
    return (*rkv, lw.astype(np.float32), u.astype(np.float32),
            s0.astype(np.float32))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("decay", ["full", "mild"])
@pytest.mark.parametrize("B,S,H,D", [
    (2, 64, 2, 64),      # whole chunks at the model's head size
    (2, 77, 3, 16),      # S not a multiple of the chunk
    (1, 20, 2, 32),      # shorter than a chunk
])
def test_factored_algebra_matches_reference(B, S, H, D, decay):
    arrays = _inputs(B, S, H, D, decay, seed=S + D)
    t = [convert._tensor_from_numpy(a, torch.device("cpu")) for a in arrays]
    t[:3] = [x.to(torch.bfloat16) for x in t[:3]]
    seen = {}
    out, s_final = mirror(*t, seen=seen)
    assert all(bool(torch.isfinite(x).all()) for xs in seen.values() for x in xs)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(s_final).all())
    if decay == "full":
        # the hazard is present: some chunk's cumsum is past -88, where
        # exp(-cw) would overflow float32
        cw_min = min(float(x.min()) for x in seen["cw"])
        assert cw_min < -88.0, cw_min
        assert bool(torch.isinf(torch.exp(-torch.tensor(cw_min))))

    plain = twkv.wkv_chunked(*t, min(CHUNK, S))
    jargs = [jnp.asarray(a) for a in arrays]
    jargs[:3] = [a.astype(jnp.bfloat16) for a in jargs[:3]]
    pallas = jwkv.rwkv6_scan(*jargs, interpret=True)
    devs = {}
    for name, (ref_out, ref_s) in (("plain", plain), ("pallas", pallas)):
        devs[name] = (_rel(out, ref_out), _rel(s_final, ref_s))
    print(f"mirror vs (out, s_final): {devs}")
    for name, (d_out, d_s) in devs.items():
        assert d_out <= TOL and d_s <= TOL, (name, d_out, d_s)


def test_sub_chunk_factors_are_exact_where_the_clip_does_not_act():
    # where cw_{i-1} - cw_j >= -60, q~ k~^T is the pairwise form up to float32
    # rounding: the split changes no term the reference keeps
    rng = np.random.default_rng(7)
    lw = torch.from_numpy(-np.exp(rng.uniform(-8.0, 0.5, (CHUNK, 4)))
                          .astype(np.float32))
    cw = torch.cumsum(lw, 0)
    cwp = torch.nn.functional.pad(cw, (0, 0, 1, 0))[:CHUNK]
    b = SUB - 1
    pair = cwp[SUB:, None] - cw[None, :SUB]
    kept = pair >= -60.0
    factored = (torch.exp(torch.clamp(cwp[SUB:] - cw[b], max=0.0))[:, None]
                * torch.exp(torch.clamp(cw[b] - cw[:SUB], max=0.0))[None])
    assert bool(kept.any())
    torch.testing.assert_close(factored[kept], torch.exp(pair)[kept],
                               rtol=1e-5, atol=0.0)
    # elsewhere the reference adds exp(-60) ~ 8.7e-27 of r k, the split less
    assert bool((factored[~kept] <= np.exp(-60.0) * (1 + 1e-5)).all())
