"""The port's encoder-decoder and vision-prefix families against the
reference, on the CPU.

The reduced configs of ``seamless-m4t-medium`` (2 encoder + 2 decoder
layers) and ``llava-next-mistral-7b`` (2 layers), both d_model 64, 4 heads
over 2 KV heads, ``frontend_len`` 8, run in both packages on the same
weights: drawn by the reference from a seed and carried over bit for bit
with ``convert.params_from_jax``.  Inputs come from numpy with a seed.  The
reference runs jitted with ``use_pallas=True`` (its flash-attention body B4
in interpret mode); the port's B4 takes its plain version on the CPU.  The
decoder's text runs S = 72 tokens, llava's over 8 patches and 64 tokens:
72 keys, inside the reference B4's one key block (F6: a key length that is
no multiple of the block gives NaN in interpret mode), and above
``2 * attn_chunk`` = 64, so that the cached prefill takes the chunked
attend.

Tolerances are ``tests/test_torch_lm.py``'s, with its reasons: modules at
most 1% of elements beyond one bf16 ulp and none beyond 1e-2 * max|ref|;
whole models' logits within ``LOGIT_TOL`` * max|ref logits| and greedy
tokens equal wherever the top-1 / top-2 margin is decided; the loss and
its cross-entropy within ``STEP_TOL`` of ``tests/test_torch_train.py``.
Batches are bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _bf16_helpers import beyond_one_ulp
from repro.configs.registry import get_config as jax_config
from repro.data import make_pipeline as jax_pipeline
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import get_model as jax_model
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs.registry import get_config as torch_config
from repro_torch.data import make_pipeline
from repro_torch.data.pipeline import bf16_embeddings
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.models import get_model as torch_model
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.train import step as tstep

AUDIO, VISION = "seamless-m4t-medium", "llava-next-mistral-7b"
ARCHS = (AUDIO, VISION)
B, S, T = 2, 72, 3         # decoder text (audio), positions in all (vision)
LOGIT_TOL = 5e-2
STEP_TOL = 1e-3


def _cfgs(arch, **over):
    over = dict(use_pallas=True, **over)
    return (dataclasses.replace(jax_config(arch).reduced(), **over),
            dataclasses.replace(torch_config(arch).reduced(), **over))


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def to_torch(a) -> torch.Tensor:
    return convert._tensor_from_numpy(np.asarray(a), torch.device("cpu"))


def bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def assert_close_bf16(got, want, *, frac=0.01, rel=1e-2):
    """At most ``frac`` of the elements beyond one bf16 ulp, none beyond
    ``rel * max|want|``."""
    d, far = beyond_one_ulp(f32(got), f32(want))
    assert far.mean() <= frac, f"{far.mean():.4f} beyond one ulp"
    assert d.max() <= rel * np.abs(f32(want)).max(), (d.max(), np.abs(f32(want)).max())


def _weights(arch):
    cj, ct = _cfgs(arch)
    pj = jax_model(cj).init(jax.random.key(0))
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    return cj, ct, pj, pt


@pytest.fixture(scope="module")
def audio():
    return _weights(AUDIO)


@pytest.fixture(scope="module")
def vision():
    return _weights(VISION)


def _paths(tree, prefix=()):
    """``{path: leaf}`` of nested dicts and lists."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _paths(sub, prefix + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, sub in enumerate(tree)
                for p, v in _paths(sub, prefix + (i,)).items()}
    return {prefix: tree}


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_get_model_builds_both_families(arch):
    """Both families build, at full size and reduced, with the reference's
    tree and parameter count (nothing is drawn at full size)."""
    for reduce in (False, True):
        cj = jax_config(arch).reduced() if reduce else jax_config(arch)
        ct = torch_config(arch).reduced() if reduce else torch_config(arch)
        tm = torch_model(ct, device="cpu")
        jm = jax_model(cj)
        ref = _paths(jm.structure())
        got = _paths(tm.structure())
        assert set(got) == set(ref)
        for path, spec in got.items():
            assert spec.shape == tuple(ref[path].shape), path
        assert tm.num_params() == jm.num_params()
    if arch == AUDIO:
        assert set(tm.structure()) == {"embed", "enc_norm", "final_norm",
                                       "enc_unit", "dec_unit", "lm_head"}


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_round_trip_is_bit_exact(arch, audio, vision):
    cj, ct, pj, pt = audio if arch == AUDIO else vision
    ref = _paths(jax.tree.map(np.asarray, pj))
    got = _paths(pt)
    specs = _paths(torch_model(ct, device="cpu").structure())
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


def test_init_cache_matches_reference_shapes():
    cj, ct = _cfgs(AUDIO)
    ref = jencdec.init_cache(cj, B, S + T)
    got = torch_model(ct, device="cpu").init_cache(B, S + T)
    for part in ("self", "cross"):
        for name in ("k", "v"):
            t = got[part][name]
            assert tuple(t.shape) == tuple(ref[part][name].shape)
            assert t.dtype == torch.bfloat16 and not bool(t.any())
    assert got["cross"]["k"].shape[2] == ct.frontend_len


# ---------------------------------------------------------------------------
# attention: cross and bidirectional
# ---------------------------------------------------------------------------

def test_cross_attention_prefill_and_decode_match_reference(audio):
    cj, ct, pj, pt = audio
    pj_x = jax.tree.map(lambda a: a[0], pj["dec_unit"]["cross_attn"])
    pt_x = tree_map(lambda a: a[0], pt["dec_unit"]["cross_attn"])
    F = cj.frontend_len
    rng = np.random.default_rng(1)
    x = bf16(rng.standard_normal((B, S, 64)) * 2)
    enc = bf16(rng.standard_normal((B, F, 64)) * 2)
    x1 = bf16(rng.standard_normal((B, 1, 64)) * 2)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    pos1 = np.full((B, 1), S, np.int32)

    def jrun(p, x, pos, kv_x, cache):
        return jattn.apply_gqa(cj, p, x, positions=pos, cross=True,
                               kv_x=kv_x, cache=cache)

    jcache0 = jax.tree.map(lambda a: a[0], jencdec.init_cache(cj, B, S)["cross"])
    yj, jcache = jax.jit(jrun)(pj_x, x, jnp.asarray(pos), enc, jcache0)
    tcache = {n: torch.zeros((B, F, 2, 16), dtype=torch.bfloat16)
              for n in ("k", "v")}
    yt, tback = tattn.apply_gqa(ct, pt_x, to_torch(x),
                                positions=torch.from_numpy(pos.copy()),
                                cross=True, kv_x=to_torch(enc), cache=tcache)
    assert tback is tcache                       # written in place
    assert_close_bf16(yt, yj)
    for name in ("k", "v"):
        assert_close_bf16(tcache[name], jcache[name], frac=1e-3)
    # without a cache the fresh K/V are returned, as the reference's
    _, fresh = tattn.apply_gqa(ct, pt_x, to_torch(x),
                               positions=torch.from_numpy(pos.copy()),
                               cross=True, kv_x=to_torch(enc))
    for name in ("k", "v"):
        assert torch.equal(fresh[name], tcache[name])

    # decode: K/V read from the cache the prefill wrote, which stays as it was
    before = {n: t.clone() for n, t in tcache.items()}
    yj1, _ = jax.jit(jrun)(pj_x, x1, jnp.asarray(pos1), None, jcache)
    yt1, _ = tattn.apply_gqa(ct, pt_x, to_torch(x1),
                             positions=torch.from_numpy(pos1), cross=True,
                             cache=tcache)
    assert_close_bf16(yt1, yj1)
    for name in ("k", "v"):
        assert torch.equal(tcache[name], before[name])


def test_cross_cache_of_another_length_is_refused(audio):
    cj, ct, pj, pt = audio
    pt_x = tree_map(lambda a: a[0], pt["dec_unit"]["cross_attn"])
    cache = {n: torch.zeros((1, ct.frontend_len + 1, 2, 16),
                            dtype=torch.bfloat16) for n in ("k", "v")}
    with pytest.raises(ValueError, match="encoder positions"):
        tattn.apply_gqa(ct, pt_x, torch.zeros((1, 3, 64), dtype=torch.bfloat16),
                        positions=torch.zeros((1, 3), dtype=torch.int32),
                        cross=True, cache=cache,
                        kv_x=torch.zeros((1, ct.frontend_len, 64),
                                         dtype=torch.bfloat16))


@pytest.mark.parametrize("use_rope", [True, False], ids=["rope", "no-rope"])
def test_bidirectional_attention_matches_reference(audio, use_rope):
    cj, ct, pj, pt = audio
    pj_a = jax.tree.map(lambda a: a[0], pj["enc_unit"]["attn"])
    pt_a = tree_map(lambda a: a[0], pt["enc_unit"]["attn"])
    rng = np.random.default_rng(2)
    x = bf16(rng.standard_normal((B, S, 64)) * 2)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    yj, _ = jax.jit(lambda p, x, pos: jattn.apply_gqa(
        cj, p, x, positions=pos, causal=False, use_rope=use_rope))(
            pj_a, x, jnp.asarray(pos))
    yt, _ = tattn.apply_gqa(ct, pt_a, to_torch(x),
                            positions=torch.from_numpy(pos.copy()),
                            causal=False, use_rope=use_rope)
    assert_close_bf16(yt, yj)
    causal, _ = tattn.apply_gqa(ct, pt_a, to_torch(x),
                                positions=torch.from_numpy(pos.copy()),
                                use_rope=use_rope)
    # the first row sees one key of 72 under the causal mask, all without
    assert float((causal[:, 0] - yt[:, 0]).abs().max()) > 1.0


# ---------------------------------------------------------------------------
# one encoder layer, one decoder layer
# ---------------------------------------------------------------------------

def test_encoder_layer_matches_reference(audio):
    cj, ct, pj, pt = audio
    cj1, ct1 = (dataclasses.replace(c, enc_layers=1) for c in (cj, ct))
    frames = bf16(np.random.default_rng(3).standard_normal((B, S, 64)))
    pj1 = dict(pj, enc_unit=jax.tree.map(lambda a: a[:1], pj["enc_unit"]))
    pt1 = dict(pt, enc_unit=tree_map(lambda a: a[:1], pt["enc_unit"]))
    want = jax.jit(lambda p, f: jencdec.encode(cj1, p, f, train=False))(pj1, frames)
    got = tencdec.encode(ct1, pt1, to_torch(frames), train=False)
    assert got.dtype == torch.bfloat16
    assert_close_bf16(got, want)


@pytest.mark.parametrize("decode", [False, True], ids=["prefill", "decode"])
def test_decoder_layer_matches_reference(audio, decode):
    cj, ct, pj, pt = audio
    pj0 = jax.tree.map(lambda a: a[0], pj["dec_unit"])
    pt0 = tree_map(lambda a: a[0], pt["dec_unit"])
    rng = np.random.default_rng(4)
    x = bf16(rng.standard_normal((B, S, 64)) * 4)
    enc = bf16(rng.standard_normal((B, cj.frontend_len, 64)))
    x1 = bf16(rng.standard_normal((B, 1, 64)) * 4)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jc = jax.tree.map(lambda a: a[0], jencdec.init_cache(cj, B, S + 1))
    tc = tree_map(lambda a: a[0].clone(), tencdec.init_cache(ct, B, S + 1))

    def jlayer(p, x, pos, enc, sc, cc, idx, valid, dec):
        return jencdec._dec_layer(cj, p, x, pos, enc, sc, cc, idx, valid, dec)

    jl = jax.jit(jlayer, static_argnums=(8,))
    yj, jself, jcross = jl(pj0, x, jnp.asarray(pos), enc, jc["self"],
                           jc["cross"], jnp.int32(0), jnp.int32(S), False)
    yt = tencdec._dec_layer(ct, pt0, to_torch(x), torch.from_numpy(pos.copy()),
                            to_torch(enc), tc["self"], tc["cross"], 0, S, False)
    if decode:
        pos1 = np.full((B, 1), S, np.int32)
        yj, _, _ = jl(pj0, x1, jnp.asarray(pos1), None, jself, jcross,
                      jnp.int32(S), jnp.int32(S + 1), True)
        yt = tencdec._dec_layer(ct, pt0, to_torch(x1), torch.from_numpy(pos1),
                                None, tc["self"], tc["cross"], S, S + 1, True)
    assert yt.dtype == torch.bfloat16
    assert_close_bf16(yt, yj)


# ---------------------------------------------------------------------------
# B4 on the cacheless causal self-attention, and nowhere else
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_flash_runs_on_every_cacheless_causal_self_attention(arch, audio,
                                                             vision,
                                                             monkeypatch):
    cj, ct, pj, pt = audio if arch == AUDIO else vision
    calls = []
    real = tattn.flash_attention

    def counting(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tattn, "flash_attention", counting)
    tm = torch_model(ct, device="cpu")
    batch = _torch_batch(ct, np.random.default_rng(5))
    with torch.no_grad():
        tm.forward(pt, batch, train=False)
    # the decoder's layers (llava: every layer, over patches and tokens);
    # the encoder's bidirectional attention and cross-attention take the
    # plain attend
    assert calls == [((B, S, 4, 16), (B, S, 2, 16))] * ct.num_layers
    calls.clear()
    tm.prefill(pt, batch, tm.init_cache(B, S + 1))
    assert calls == []                              # cached prefill: plain


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _text_len(cfg) -> int:
    return S - cfg.frontend_len if cfg.frontend == "vision" else S


def _torch_batch(cfg, rng):
    tokens = rng.integers(0, cfg.vocab_size, (B, _text_len(cfg))).astype(np.int32)
    emb = bf16(rng.standard_normal((B, cfg.frontend_len, cfg.d_model)))
    key = "frames" if cfg.encdec else "prefix_embeds"
    return {"tokens": torch.from_numpy(tokens).long(), key: to_torch(emb)}


def _jax_batch(batch):
    return {k: (jnp.asarray(v.numpy().astype(np.int32)) if k == "tokens"
                else bf16(v.float().numpy())) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_whole_model_forward_matches_reference(arch, audio, vision):
    cj, ct, pj, pt = audio if arch == AUDIO else vision
    batch = _torch_batch(ct, np.random.default_rng(6))
    want, _ = jax.jit(lambda p, b: jax_model(cj).forward(p, b, train=False))(
        pj, _jax_batch(batch))
    with torch.no_grad():
        got, aux = torch_model(ct, device="cpu").forward(pt, batch, train=False)
    assert tuple(got.shape) == tuple(want.shape) == (B, S, ct.padded_vocab)
    r, g = f32(want), f32(got)
    assert np.isfinite(g).all()
    dev = np.abs(g - r).max() / np.abs(r).max()
    print(f"{arch} forward: max|dlogits| / max|logits| = {dev:.4f}")
    assert dev <= LOGIT_TOL


def _serve(cj, ct, pj, pt, seed):
    """Both packages serve the same prompt; the port is fed the reference's
    greedy tokens, so every step compares logits on the same context."""
    batch = _torch_batch(ct, np.random.default_rng(seed))
    jm, tm = jax_model(cj), torch_model(ct, device="cpu")
    jcache, tcache = jm.init_cache(B, S + T), tm.init_cache(B, S + T)
    lj, jcache = jax.jit(jm.prefill)(pj, _jax_batch(batch), jcache)
    lt, tcache = tm.prefill(pt, batch, tcache)
    ref, got = [f32(lj)], [f32(lt)]
    decode = jax.jit(jm.decode_step)
    for i in range(T):
        tok = np.argmax(ref[-1][:, -1], -1)[:, None].astype(np.int32)
        lj, jcache = decode(pj, jnp.asarray(tok), jcache, jnp.int32(S + i))
        lt, tcache = tm.decode_step(pt, torch.from_numpy(tok).long(), tcache,
                                    S + i)
        ref.append(f32(lj))
        got.append(f32(lt))
    return ref, got


@pytest.fixture(scope="module")
def served(audio, vision):
    return {AUDIO: _serve(*audio, seed=7), VISION: _serve(*vision, seed=8)}


@pytest.mark.parametrize("arch", ARCHS)
def test_whole_model_logits_match_reference(arch, served):
    ref, got = served[arch]
    assert len(ref) == T + 1
    for step, (r, g) in enumerate(zip(ref, got)):
        assert g.shape == r.shape == (B, 1, 512)
        assert np.isfinite(g).all()
        dev = np.abs(g - r).max() / np.abs(r).max()
        print(f"{arch} step {step}: max|dlogits| / max|logits| = {dev:.4f}")
        assert dev <= LOGIT_TOL, (step, dev)


@pytest.mark.parametrize("arch", ARCHS)
def test_whole_model_greedy_tokens_match_reference(arch, served):
    ref, got = served[arch]
    undecided = 0
    for r, g in zip(ref, got):
        r, g = r[:, -1], g[:, -1]
        top2 = np.sort(r, axis=-1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] > 2 * LOGIT_TOL * np.abs(r).max()
        undecided += int((~decided).sum())
        np.testing.assert_array_equal(g.argmax(-1)[decided], r.argmax(-1)[decided])
    print(f"{arch}: greedy tokens within the logit tolerance of a tie: "
          f"{undecided} of {B * (T + 1)}")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_consistency(arch, audio, vision):
    """The port alone, as the reference's
    ``tests/test_arch_smoke.py::test_serve_consistency``: on the reduced
    config's plain route, prefill(S - 1) and decode(S - 1) give the full
    forward's last two logits within 1e-2, at S = 12 positions (llava: 8
    patches and 4 tokens).  (At S = 72, or through B4, the cached and the
    full-sequence routes part by up to 0.2 in both packages alike.)"""
    pt = (audio if arch == AUDIO else vision)[3]
    ct = torch_config(arch).reduced(remat=False)
    tm = torch_model(ct, device="cpu")
    S_ = 12
    rng = np.random.default_rng(9)
    n_text = S_ - ct.frontend_len if ct.frontend == "vision" else S_
    tokens = torch.from_numpy(rng.integers(0, ct.vocab_size, (B, n_text))).long()
    emb = to_torch(bf16(rng.standard_normal((B, ct.frontend_len, ct.d_model))))
    batch = {"tokens": tokens, "frames" if ct.encdec else "prefix_embeds": emb}
    with torch.no_grad():
        full, _ = tm.forward(pt, batch, train=False)
    cache = tm.init_cache(B, S_ + 4)
    lg, cache = tm.prefill(pt, dict(batch, tokens=tokens[:, :-1]), cache)
    lg2, cache = tm.decode_step(pt, tokens[:, -1:], cache, S_ - 1)
    np.testing.assert_allclose(f32(lg[:, 0]), f32(full[:, -2]),
                               atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(f32(lg2[:, 0]), f32(full[:, -1]),
                               atol=1e-2, rtol=1e-2)


# ---------------------------------------------------------------------------
# data and the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7)])
def test_synthetic_batches_equal_reference(arch, seed, step):
    cj, ct = _cfgs(arch)
    want = jax_pipeline(cj, S, 3, seed=seed).batch(step)
    got = make_pipeline(ct, S, 3, seed=seed, device="cpu").batch(step)
    key = "frames" if ct.encdec else "prefix_embeds"
    assert set(got) == set(want) == {"tokens", "labels", key}
    assert got["tokens"].shape[1] == _text_len(ct)
    for name in ("tokens", "labels"):
        assert got[name].dtype == torch.int32
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    emb = got[key]
    assert emb.dtype == torch.bfloat16 and emb.device.type == "cpu"
    assert tuple(emb.shape) == (3, ct.frontend_len, ct.d_model)
    np.testing.assert_array_equal(emb.view(torch.int16).numpy(),
                                  np.asarray(want[key]).view(np.int16))


def test_embedding_rounding_is_the_references():
    """float64 -> bf16 through float32, as ``jnp.asarray(a, jnp.bfloat16)``
    rounds: these values sit just above a bf16 half-way point that float32
    rounds onto, so a direct rounding would land one ulp higher."""
    a = np.array([1 + 2 ** -8 + 2 ** -40, -(1 + 2 ** -8 + 2 ** -40),
                  3 * (1 + 2 ** -8 + 2 ** -35), 0.1, -7.25])
    got = bf16_embeddings(a, torch.device("cpu"))
    want = np.asarray(jnp.asarray(a, jnp.bfloat16))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    assert float(got[0]) == 1.0                     # not 1 + 2^-7


@pytest.mark.parametrize("arch,fused_ce", [(AUDIO, False), (VISION, False),
                                           (VISION, True)],
                         ids=["audio", "vision", "vision-fused-ce"])
def test_loss_matches_reference(arch, fused_ce):
    over = dict(use_pallas=False, fused_ce=fused_ce, ce_chunk=200)
    cj, ct = (dataclasses.replace(c, **over) for c in
              (jax_config(arch).reduced(), torch_config(arch).reduced()))
    pj = jax_model(cj).init(jax.random.key(1))
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    jbatch = jax_pipeline(cj, S, B, seed=1).batch(0)
    tbatch = make_pipeline(ct, S, B, seed=1, device="cpu").batch(0)
    lj, mj = jax.jit(jstep.make_loss_fn(jax_model(cj)))(pj, jbatch)
    (lt, mt), grads = tstep.value_and_grad(tstep.make_loss_fn(
        torch_model(ct, device="cpu")))(pt, tbatch)
    rel = lambda a, b: abs(float(a) - float(b)) / abs(float(b))  # noqa: E731
    print(f"{arch} fused_ce={fused_ce}: loss {float(lt):.7g} vs {float(lj):.7g}")
    assert rel(lt, lj) <= STEP_TOL and rel(mt["ce"], mj["ce"]) <= STEP_TOL
    assert float(lt) > 0
    leaves = tree_leaves(grads)
    assert all(bool(torch.isfinite(g).all()) for g in leaves)
    # every layer of every stack learns (the frontend is a stub: no weights)
    assert sum(float(g.float().abs().sum()) > 0 for g in leaves) == len(leaves)
