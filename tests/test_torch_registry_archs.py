"""The four registry architectures the other port tests never run —
qwen3-32b, llama4-scout-17b-a16e, qwen1.5-4b and qwen1.5-0.5b — against
the reference on the CPU, and a port twin of ``tests/test_arch_smoke.py``'s
forward and train-step smoke for all ten.

``reduced()`` sets 4 heads over at most 2 KV heads of head dim 16, which
erases what sets these models apart, so each reduced config keeps its own
head layout (``HEADS``): qwen3-32b 8 over 1 (G = 8) at head dim 128 with
``qk_norm``; llama4 10 over 2 (G = 5) at 128, its MoE top-1 with one
shared expert in every layer; qwen1.5-4b 4 over 4 (MHA) at 128 with QKV
bias; qwen1.5-0.5b 4 over 4 at 64, QKV bias and tied embeddings.  Weights
are drawn by the reference from a seed and carried over bit for bit with
``convert.params_from_jax``; inputs come from numpy with a seed.  The
reference runs jitted with ``use_pallas=True`` (its B4 and B7/B8 bodies in
interpret mode), the port on its plain kernel versions.  Sequences are S =
128 positions, one whole key block of the reference's B4 (F6: a key
length that is no multiple of its block gives NaN in interpret mode).

Tolerances are ``tests/test_torch_lm.py``'s, with its reasons: whole
models' logits within ``LOGIT_TOL`` = 5e-2 * max|ref logits| (F3: bf16
matmuls sum in another order in XLA and PyTorch, and the random model
amplifies a one-ulp flip), modules at most 1% of elements beyond one bf16
ulp and none beyond 1e-2 * max|ref|; the port's own serve consistency at
the reference's 1e-2 on the plain route at S = 12
(``test_arch_smoke.py::test_serve_consistency``); the q / k norm from
float32 inputs at float32 rounding (``F32_TOL`` of max|ref|).  Every input
is seeded and fixed.  Each test prints what it measures.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _bf16_helpers import beyond_one_ulp
from repro.configs.registry import get_config as jax_config
from repro.kernels import flash_attention as jfa
from repro.models import attention as jattn
from repro.models import get_model as jax_model
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.configs.registry import get_config as torch_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattn
from repro_torch.models import get_model as torch_model
from repro_torch.models import moe as tmoe
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.train import build_train_step, init_train_state

QWEN3, LLAMA4 = "qwen3-32b", "llama4-scout-17b-a16e"
QWEN15_4B, QWEN15_05B = "qwen1.5-4b", "qwen1.5-0.5b"
ARCHS = (QWEN3, LLAMA4, QWEN15_4B, QWEN15_05B)
HEADS = {QWEN3: dict(num_heads=8, num_kv_heads=1, head_dim=128),
         LLAMA4: dict(num_heads=10, num_kv_heads=2, head_dim=128),
         QWEN15_4B: dict(num_heads=4, num_kv_heads=4, head_dim=128),
         QWEN15_05B: dict(num_heads=4, num_kv_heads=4, head_dim=64)}
B, S, T = 2, 128, 3          # batch, positions (one B4 key block), decode steps
LOGIT_TOL = 5e-2
SERVE_TOL = 1e-2             # the reference's test_serve_consistency
F32_TOL = 1e-5               # float32 rounding, relative to max|ref|
# a router top-1 / top-2 probability margin below which a bf16 rounding can
# flip a top-1 pick (measured: 3.3e-4 flips llama4's token (1, 59))
TIE_MARGIN = 1e-3


def _cfgs(arch, **over):
    """Both packages' reduced configs with ``arch``'s head layout (passed to
    ``reduced``, which derives ``padded_heads`` from it)."""
    over = dict(HEADS[arch], use_pallas=True, **over)
    return jax_config(arch).reduced(**over), torch_config(arch).reduced(**over)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def to_torch(a) -> torch.Tensor:
    return convert._tensor_from_numpy(np.asarray(a), torch.device("cpu"))


def bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def assert_close_bf16(got, want, label, *, frac=0.01, rel=1e-2):
    """At most ``frac`` of the elements beyond one bf16 ulp, none beyond
    ``rel * max|want|``; prints both measures."""
    d, far = beyond_one_ulp(f32(got), f32(want))
    scale = np.abs(f32(want)).max()
    print(f"{label}: {far.mean():.5f} beyond one ulp, max|d| / max|ref| = "
          f"{d.max() / scale:.3g}")
    assert far.mean() <= frac, f"{far.mean():.4f} beyond one ulp"
    assert d.max() <= rel * scale, (d.max(), scale)


def _paths(tree, prefix=()):
    """``{path: leaf}`` of nested dicts and lists."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _paths(sub, prefix + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, sub in enumerate(tree)
                for p, v in _paths(sub, prefix + (i,)).items()}
    return {prefix: tree}


@functools.lru_cache(maxsize=None)
def _weights(arch):
    cj, ct = _cfgs(arch)
    pj = jax_model(cj).init(jax.random.key(0))
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    return cj, ct, pj, pt


def _prompt(cfg, seed, n=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


# ---------------------------------------------------------------------------
# configurations and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [1, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference_field_by_field(arch, tp):
    """The published config, and its TP-padded form (``padded_heads`` /
    ``kv_heads_effective``), field for field the reference's."""
    cj, ct = jax_config(arch).with_parallelism(tp), \
        torch_config(arch).with_parallelism(tp)
    want, got = dataclasses.asdict(cj), dataclasses.asdict(ct)
    assert set(got) == set(want)
    for name, value in want.items():
        assert got[name] == value, name
    for prop in ("padded_heads", "kv_heads_effective", "padded_vocab",
                 "repeat_unit", "num_units", "remainder_layers"):
        assert getattr(ct, prop) == getattr(cj, prop), prop
    if tp == 1:
        assert ct.padded_heads == ct.num_heads
        assert ct.kv_heads_effective == ct.num_kv_heads
    print(f"{arch} tp={tp}: heads {ct.padded_heads} over "
          f"{ct.kv_heads_effective}, vocab {ct.padded_vocab}")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_structure_equals_reference(arch):
    """The published tree (nothing drawn): every leaf's shape and dtype, the
    parameter count, and the float32 norms (``q_norm`` / ``k_norm`` of
    qwen3-32b among them)."""
    tm, jm = (torch_model(torch_config(arch), device="cpu"),
              jax_model(jax_config(arch)))
    ref, got = _paths(jm.structure()), _paths(tm.structure())
    assert set(got) == set(ref)
    for path, spec in got.items():
        assert spec.shape == tuple(ref[path].shape), path
        assert str(spec.dtype).split(".")[-1] == jnp.dtype(ref[path].dtype).name, path
    assert tm.num_params() == jm.num_params()
    norms = [p for p in got if p[-1] in ("q_norm", "k_norm")]
    assert bool(norms) == (arch == QWEN3)
    assert all(got[p].dtype == torch.float32 for p in norms)
    assert (("lm_head",) in got) == (arch != QWEN15_05B)
    print(f"{arch}: {tm.num_params()} parameters")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_round_trip_is_bit_exact(arch):
    cj, ct, pj, pt = _weights(arch)
    ref = _paths(jax.tree.map(np.asarray, pj))
    got = _paths(pt)
    specs = _paths(torch_model(ct, device="cpu").structure())
    assert set(ref) == set(got) == set(specs)
    kinds = set()
    for path, a in ref.items():
        t, spec = got[path], specs[path]
        assert tuple(t.shape) == tuple(a.shape) == spec.shape, path
        assert t.dtype == spec.dtype, path
        kinds.add(t.dtype)
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
    assert kinds == {torch.bfloat16, torch.float32}


def test_port_init_keeps_the_norms_float32_and_draws_in_bounded_slices(
        monkeypatch):
    """The port's own init of the reduced qwen3-32b with ``DRAW_CHUNK`` cut
    to 4096 elements: the float32 q / k norms stay float32 ones, every
    float32 draw holds at most ``DRAW_CHUNK`` elements or one leading-axis
    row, every bf16 leaf is drawn at its fan-in's scale, and the slices of
    a leaf differ (no slice repeats the generator's stream)."""
    from repro_torch.models import param
    monkeypatch.setattr(param, "DRAW_CHUNK", 4096)
    sizes = []
    real = torch.randn

    def recording(*shape, **kw):
        out = real(*shape, **kw)
        sizes.append((out.numel(), out.dtype))
        return out

    monkeypatch.setattr(torch, "randn", recording)
    ct = _cfgs(QWEN3)[1]
    params = torch_model(ct, device="cpu").init(torch.Generator().manual_seed(0))
    mix = params["unit"]["b0"]["mix"]
    for name in ("q_norm", "k_norm"):
        assert mix[name].dtype == torch.float32
        assert tuple(mix[name].shape) == (2, ct.head_dim)
        assert bool((mix[name] == 1).all())
    specs = _paths(torch_model(ct, device="cpu").structure())
    rows = {int(np.prod(s.shape[1:])) for s in specs.values()}
    assert sizes and all(dt == torch.float32 for _, dt in sizes)
    assert max(n for n, _ in sizes) <= max(4096, max(rows))
    wq = params["unit"]["b0"]["mix"]["wq"]       # (2, 64, 8, 128), fan-in 8
    assert tuple(wq.shape) == (2, ct.d_model, 8, 128)
    assert wq.dtype == torch.bfloat16
    assert abs(float(wq.float().std()) * np.sqrt(8) - 1) < 0.05
    assert not torch.equal(wq[0, 0], wq[0, 8])   # rows of two slices differ


# ---------------------------------------------------------------------------
# attention: qk_norm, MHA, QKV bias; B4 at the four head layouts
# ---------------------------------------------------------------------------

def _qk_norm_block(rng):
    """qwen3-32b's reduced attention block (8 over 1 heads, head dim 128)
    with seeded float32 weights and q / k norm scales."""
    cj, ct = (dataclasses.replace(c, use_pallas=False) for c in _cfgs(QWEN3))
    D, H, KV, Dh = ct.d_model, ct.num_heads, ct.num_kv_heads, ct.head_dim
    p = {"wq": rng.standard_normal((D, H, Dh)) / 8,
         "wk": rng.standard_normal((D, KV, Dh)) / 8,
         "wv": rng.standard_normal((D, KV, Dh)) / 8,
         "wo": rng.standard_normal((H, Dh, D)) / 32,
         "q_norm": rng.uniform(0.5, 1.5, Dh), "k_norm": rng.uniform(0.5, 1.5, Dh)}
    return cj, ct, {k: v.astype(np.float32) for k, v in p.items()}


def test_qk_norm_attention_matches_reference_in_float32():
    """qwen3-32b's ``apply_gqa`` with its q / k norms, float32 inputs and
    weights, against the reference's at float32 rounding.  The norms are
    live: with their scales doubled the output moves."""
    rng = np.random.default_rng(11)
    cj, ct, p = _qk_norm_block(rng)
    x = rng.standard_normal((B, S, ct.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    want = np.asarray(jax.jit(lambda p, x, pos: jattn.apply_gqa(
        cj, p, x, positions=pos)[0])(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
            jnp.asarray(pos)))
    pt = {k: torch.from_numpy(v) for k, v in p.items()}

    def run(p):
        return tattn.apply_gqa(ct, p, torch.from_numpy(x),
                               positions=torch.from_numpy(pos))[0]

    got = run(pt)
    assert got.dtype == torch.float32
    err, scale = float(np.abs(got.numpy() - want).max()), float(np.abs(want).max())
    print(f"qk_norm in float32: max|d| / max|ref| = {err / scale:.3g}")
    assert err <= F32_TOL * scale
    moved = run(dict(pt, q_norm=pt["q_norm"] * 2, k_norm=pt["k_norm"] * 2))
    assert float((moved - got).abs().max()) > 1e-2 * scale


def test_qk_norm_decode_step_matches_reference():
    """The same block in bf16 (norm scales float32) through a bf16 cache:
    the prefill's K / V rows (normed, then roped) and a decode step
    against the reference's, at the bf16 module tolerance.  (A float32
    query against the bf16 cache is promoted by the reference and refused
    by the port's einsum; no path of either package makes one.)"""
    rng = np.random.default_rng(12)
    cj, ct, p = _qk_norm_block(rng)
    pj = {k: (jnp.asarray(v) if k.endswith("norm") else bf16(v))
          for k, v in p.items()}
    pt = {k: to_torch(v) for k, v in pj.items()}
    x = bf16(rng.standard_normal((B, S, ct.d_model)))
    x1 = bf16(rng.standard_normal((B, 1, ct.d_model)))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    pos1 = np.full((B, 1), S, np.int32)

    def jrun(p, x, pos, cache, idx, valid):
        return jattn.apply_gqa(cj, p, x, positions=pos, cache=cache,
                               cache_index=idx, kv_valid=valid)

    jstep = jax.jit(jrun)
    jc = jattn.init_kv_cache(cj, B, S + 1)
    tc = tattn.init_kv_cache(ct, B, S + 1)
    _, jc = jstep(pj, x, jnp.asarray(pos), jc, jnp.int32(0), jnp.int32(S))
    tattn.apply_gqa(ct, pt, to_torch(x), positions=torch.from_numpy(pos),
                    cache=tc, cache_index=0, kv_valid=S)
    for name in ("k", "v"):
        assert_close_bf16(tc[name], jc[name], f"qk_norm cache {name}", frac=1e-3)
        tc[name].copy_(to_torch(jc[name]))      # the same context for the step
    want, _ = jstep(pj, x1, jnp.asarray(pos1), jc, jnp.int32(S), jnp.int32(S + 1))
    got, back = tattn.apply_gqa(ct, pt, to_torch(x1),
                                positions=torch.from_numpy(pos1), cache=tc,
                                cache_index=S, kv_valid=S + 1)
    assert back is tc and got.dtype == torch.bfloat16
    assert_close_bf16(got, want, "qk_norm decode step")


@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_layer_matches_reference(arch):
    """One attention block of each reduced model (its own head layout, QKV
    bias, q / k norms) in bf16 against the jitted reference, through B4
    (the port's plain version, the reference's body in interpret mode)."""
    cj, ct, pj, pt = _weights(arch)
    pj_a = jax.tree.map(lambda a: a[0], pj["unit"]["b0"]["mix"])
    pt_a = tree_map(lambda a: a[0], pt["unit"]["b0"]["mix"])
    if ct.qkv_bias:                                  # zeros at init: make them live
        rng = np.random.default_rng(12)
        for name in ("bq", "bk", "bv"):
            b = bf16(rng.standard_normal(pj_a[name].shape))
            pj_a[name], pt_a[name] = b, to_torch(b)
    x = bf16(np.random.default_rng(13).standard_normal((B, S, ct.d_model)))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    want, _ = jax.jit(lambda p, x, pos: jattn.apply_gqa(cj, p, x, positions=pos))(
        pj_a, x, jnp.asarray(pos))
    calls = []
    real = tattn.flash_attention

    def counting(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, **kw)

    tattn.flash_attention = counting
    try:
        got, _ = tattn.apply_gqa(ct, pt_a, to_torch(x),
                                 positions=torch.from_numpy(pos))
    finally:
        tattn.flash_attention = real
    H, KV, Dh = ct.num_heads, ct.num_kv_heads, ct.head_dim
    assert calls == [((B, S, H, Dh), (B, S, KV, Dh))]
    assert_close_bf16(got, want, f"{arch} attention (G = {H // KV}, D = {Dh})")


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 5, 8])
def test_flash_plain_version_matches_pallas_body_at_registry_groupings(G, D):
    """B4's plain version against the reference's Pallas body (interpret
    mode) at the groupings and head dims of the four: G = 1 (MHA), 5
    (llama4) and 8 (qwen3-32b), D = 64 and 128, over two KV heads."""
    rng = np.random.default_rng(G * 1000 + D)
    KV = 2
    q = bf16(rng.standard_normal((1, S, KV * G, D)))
    k = bf16(rng.standard_normal((1, S, KV, D)))
    v = bf16(rng.standard_normal((1, S, KV, D)))
    scale = D ** -0.5
    body = jfa.flash_attention(q, k, v, scale=scale, interpret=True)
    assert np.isfinite(f32(body)).all()
    plain = tfa.flash_attention(*(to_torch(a) for a in (q, k, v)), scale=scale)
    assert plain.dtype == torch.bfloat16
    assert_close_bf16(plain, body, f"B4 G={G} D={D}, plain vs Pallas body")


# ---------------------------------------------------------------------------
# llama4's MoE layer: top-1, one shared expert
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["kept", "drops"])
def test_llama4_moe_layer_matches_reference(capacity_factor):
    cj, ct, pj, pt = _weights(LLAMA4)
    assert ct.moe.top_k == 1 and ct.moe.num_shared_experts == 1
    assert ct.moe.first_dense_layers == 0
    moe = lambda c: dataclasses.replace(  # noqa: E731
        c, moe=dataclasses.replace(c.moe, capacity_factor=capacity_factor))
    cj, ct = moe(cj), moe(ct)
    pj_ffn = jax.tree.map(lambda a: a[0], pj["unit"]["b0"]["ffn"])
    pt_ffn = tree_map(lambda a: a[0], pt["unit"]["b0"]["ffn"])
    assert "shared_w1" in pt_ffn
    x = bf16(np.random.default_rng(14).standard_normal((B, S, ct.d_model)) * 2)
    yj, aux_j = jax.jit(lambda p, x: jmoe.apply_moe(cj, p, x))(pj_ffn, x)
    yt, aux_t = tmoe.apply_moe(ct, pt_ffn, to_torch(x))
    assert_close_bf16(yt, yj, f"llama4 MoE, capacity factor {capacity_factor}")
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)

    N = B * S
    xt = to_torch(x).reshape(N, -1)
    probs_t, _, gates, e_flat, pos_flat, C = tmoe.route(ct, pt_ffn, xt)
    assert C == jmoe.capacity_of(cj, N) == tmoe.capacity_of(ct, N)
    sp = np.sort(f32(probs_t), axis=-1)[:, ::-1]
    assert int(((sp[:, 0] - sp[:, 1]) <= 1e-6).sum()) == 0   # no near-ties
    drops = int((pos_flat == C).sum())
    print(f"capacity factor {capacity_factor}: C = {C}, {drops} of {N} "
          "tokens dropped")
    assert (drops > 0) == (capacity_factor < 1.0)
    # a dropped token gets only the shared expert
    if drops:
        dropped = (pos_flat == C).nonzero()[0, 0]
        assert float(gates[dropped].abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _no_drops(cfg):
    """``cfg`` with a capacity factor that gives every token a slot (C =
    N): the full forward's capacity (over B x S tokens) is then the
    decode step's, which a capacity that drops tokens is not."""
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    """``Model.forward`` with ``use_pallas=True``: B4 once a layer at the
    model's head layout, logits within ``LOGIT_TOL``.

    llama4 routes each token to one expert, so a router near-tie (top-1 /
    top-2 probability margin below ``TIE_MARGIN``) can flip its pick under
    the packages' different bf16 roundings (F3), which replaces that token's
    expert output; with capacity drops the flip also moves other tokens
    across their expert's capacity.  So its forward runs without drops
    (``_no_drops``; the MoE layer test holds drops exactly), and the rows
    of tokens the port routes at a near-tie in some layer are counted and
    left out of the bound."""
    cj, ct, pj, pt = _weights(arch)
    if ct.moe:
        cj, ct = _no_drops(cj), _no_drops(ct)
    tokens = _prompt(ct, 15)
    want, aux_j = jax.jit(lambda p, t: jax_model(cj).forward(
        p, {"tokens": t}, train=False))(pj, jnp.asarray(tokens))
    calls, tied, events = [], np.zeros(B * S, bool), []
    real, route = tattn.flash_attention, tmoe.route

    def routing(cfg, p, xt):
        out = route(cfg, p, xt)
        top2 = torch.sort(out[0], dim=-1, descending=True).values[:, :2]
        near = (top2[:, 0] - top2[:, 1]).numpy() < TIE_MARGIN
        tied[:] |= near
        events.append(int(near.sum()))
        return out

    tattn.flash_attention = lambda q, k, v, **kw: (
        calls.append(tuple(q.shape)) or real(q, k, v, **kw))
    tmoe.route = routing
    try:
        with torch.no_grad():
            got, aux_t = torch_model(ct, device="cpu").forward(
                pt, {"tokens": torch.from_numpy(tokens).long()}, train=False)
    finally:
        tattn.flash_attention, tmoe.route = real, route
    assert calls == [(B, S, ct.num_heads, ct.head_dim)] * ct.num_layers
    assert tuple(got.shape) == tuple(want.shape) == (B, S, ct.padded_vocab)
    r, g = f32(want), f32(got)
    assert np.isfinite(g).all()
    rows = ~tied.reshape(B, S)
    dev = np.abs(g - r)[rows].max() / np.abs(r).max()
    print(f"{arch} forward: max|dlogits| / max|logits| = {dev:.4f} over "
          f"{int(rows.sum())} of {B * S} rows ({int(tied.sum())} routed at a "
          f"near-tie)")
    assert tied.mean() <= 0.02
    assert dev <= LOGIT_TOL
    if ct.moe:
        # a flipped pick moves one token's share between two experts: at
        # most 1 / N of the routed fractions, times E * aux_loss_coef
        m = ct.moe
        slack = sum(events) / (B * S) * m.num_experts * m.aux_loss_coef
        assert abs(float(aux_t) - float(aux_j)) <= 1e-4 * abs(float(aux_j)) + slack


@functools.lru_cache(maxsize=None)
def _served(arch):
    """Both packages serve the same prompt (prefill, then ``T`` decode
    steps); the port is fed the reference's greedy tokens, so every step
    compares logits on the same context."""
    cj, ct, pj, pt = _weights(arch)
    prompt = _prompt(ct, 16)
    jm, tm = jax_model(cj), torch_model(ct, device="cpu")
    jcache, tcache = jm.init_cache(B, S + T), tm.init_cache(B, S + T)
    lj, jcache = jax.jit(jm.prefill)(pj, {"tokens": jnp.asarray(prompt)}, jcache)
    lt, tcache = tm.prefill(pt, {"tokens": torch.from_numpy(prompt).long()},
                            tcache)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch):
    ref, got = _served(arch)
    cfg = _weights(arch)[1]
    assert len(ref) == T + 1
    for step, (r, g) in enumerate(zip(ref, got)):
        assert g.shape == r.shape == (B, 1, cfg.padded_vocab)
        assert np.isfinite(g).all()
        dev = np.abs(g - r).max() / np.abs(r).max()
        print(f"{arch} step {step}: max|dlogits| / max|logits| = {dev:.4f}")
        assert dev <= LOGIT_TOL, (step, dev)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_reference(arch):
    ref, got = _served(arch)
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
def test_serve_consistency(arch):
    """The port alone, as the reference's
    ``tests/test_arch_smoke.py::test_serve_consistency``: on the plain
    route, prefill(S - 1) and decode(S - 1) give the full forward's last
    two logits within 1e-2, at S = 12, with each model's own head
    layout.  llama4 runs without capacity drops (``_no_drops``): the
    forward's capacity over B x S tokens drops tokens that the decode
    step's capacity keeps, and then the two routes compute other things
    (the reference's own serve parts by 0.34 there)."""
    pt = _weights(arch)[3]
    ct = torch_config(arch).reduced(remat=False, **HEADS[arch])
    if ct.moe:
        ct = _no_drops(ct)
    tm = torch_model(ct, device="cpu")
    S_ = 12
    tokens = torch.from_numpy(_prompt(ct, 17, S_)).long()
    with torch.no_grad():
        full, _ = tm.forward(pt, {"tokens": tokens}, train=False)
    cache = tm.init_cache(B, S_ + 4)
    lg, cache = tm.prefill(pt, {"tokens": tokens[:, :-1]}, cache)
    lg2, cache = tm.decode_step(pt, tokens[:, -1:], cache, S_ - 1)
    for a, b in ((lg[:, 0], full[:, -2]), (lg2[:, 0], full[:, -1])):
        print(f"{arch}: max|d| = {float((a.float() - b.float()).abs().max()):.3g}")
        np.testing.assert_allclose(f32(a), f32(b), atol=SERVE_TOL,
                                   rtol=SERVE_TOL)


# ---------------------------------------------------------------------------
# the port's twin of tests/test_arch_smoke.py, all ten architectures
# ---------------------------------------------------------------------------

SMOKE_SHAPE = ShapeConfig("smoke", 32, 2, "train")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_smoke(arch):
    cfg = torch_config(arch).reduced()
    model = torch_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = model.realize_inputs(SMOKE_SHAPE, torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, aux = model.forward(params, batch)
    assert logits.shape[0] == SMOKE_SHAPE.global_batch
    assert logits.shape[-1] == cfg.padded_vocab
    assert not bool(torch.isnan(logits.float()).any())
    if cfg.moe is not None:
        assert float(aux) >= 0.0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_smoke(arch):
    cfg = torch_config(arch).reduced()
    model = torch_model(cfg, device="cpu")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                       grad_accum=2)
    state = init_train_state(model, tcfg, torch.Generator().manual_seed(0))
    before = tree_map(torch.clone, state.params)
    batch = model.realize_inputs(SMOKE_SHAPE, torch.Generator().manual_seed(1))
    if "labels" not in batch:
        batch["labels"] = batch["tokens"]
    new_state, metrics = build_train_step(model, tcfg)(state, batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and loss > 0
    assert float(metrics["grad_norm"]) > 0
    moved = [float((a.float() - b.float()).abs().max())
             for a, b in zip(tree_leaves(before), tree_leaves(new_state.params))]
    assert max(moved) > 0
