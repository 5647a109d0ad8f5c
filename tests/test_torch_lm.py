"""The port's DeepSeek-V2-Lite serving path against the reference, on the CPU.

The reduced config of ``deepseek-v2-lite-16b`` (2 layers: one dense, one
MoE of 4 experts top-2; d_model 64, 4 heads; MLA at its published widths;
``use_pallas=True``) runs in both packages on the same weights: drawn by
the reference from a seed and carried over bit for bit with
``convert.params_from_jax``.  Inputs come from numpy with a seed.  The
reference runs jitted, as its serving path does (jit fuses its bf16 graph
differently from eager execution, and the port follows the jitted
rounding: residual sums feed the second norm unrounded, ``silu`` rounds
after every op); its MoE grouped matmuls run their Pallas bodies in
interpret mode.

Tolerances, with their reasons:

- modules: bf16 matmuls accumulate in another order in XLA and in
  PyTorch, so an output can sit one bf16 ulp from the reference.  At most
  1% of elements may be beyond one ulp, none beyond 1e-2 * max|ref|.
- routing: exact where the k-th / (k+1)-th router probability margin
  exceeds 1e-6; near-ties are counted (0 on these seeds).  Drops are
  exact.
- whole model: logits within 5e-2 * max|ref logits| at prefill and at each
  decode step, and greedy tokens equal wherever the reference's top-1 /
  top-2 margin exceeds twice that (a flip needs the two logits to move
  toward each other by the margin); the rest are counted.  The bound is
  wider than the modules' because this random-weight model carries a bf16
  residual of magnitude ~40, so a single 1-ulp flip in one layer's matmul
  (bf16 matmuls sum in another order in XLA and in PyTorch) moves the
  logits by several bf16 ulps of their maximum.  The test prints the
  deviation it measures at each step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _bf16_helpers import beyond_one_ulp
from repro.configs.registry import get_config as jax_config
from repro.models import attention as jattn
from repro.models import get_model as jax_model
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config as torch_config
from repro_torch.models import attention as tattn
from repro_torch.models import get_model as torch_model
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models.param import tree_leaves
from repro_torch.train import step as tstep

ARCH = "deepseek-v2-lite-16b"
B, S, T = 2, 72, 4          # a 72-token prompt: Sk = 76 > 2 * attn_chunk
LOGIT_TOL = 5e-2


def _cfgs(**over):
    cj = dataclasses.replace(jax_config(ARCH).reduced(), use_pallas=True, **over)
    ct = dataclasses.replace(torch_config(ARCH).reduced(), use_pallas=True, **over)
    return cj, ct


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def to_torch(a) -> torch.Tensor:
    return convert._tensor_from_numpy(np.asarray(a), torch.device("cpu"))


def to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def assert_close_bf16(got, want, *, frac=0.01, rel=1e-2):
    """At most ``frac`` of the elements beyond one bf16 ulp, none beyond
    ``rel * max|want|``."""
    d, far = beyond_one_ulp(f32(got), f32(want))
    assert far.mean() <= frac, f"{far.mean():.4f} beyond one ulp"
    assert d.max() <= rel * np.abs(f32(want)).max(), (d.max(), np.abs(f32(want)).max())


@pytest.fixture(scope="module")
def weights():
    cj, ct = _cfgs()
    pj = jax_model(cj).init(jax.random.key(0))
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    return cj, ct, pj, pt


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = bf16(rng.standard_normal((3, 5, 64)) * 20)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    want = jax.jit(jlayers.rmsnorm)(jnp.asarray(scale), x)
    got = tlayers.rmsnorm(torch.from_numpy(scale), to_torch(x))
    assert got.dtype == torch.bfloat16
    assert_close_bf16(got, want, frac=0.0, rel=1e-2)


def test_rope_tables_and_rotation_match_reference():
    pos = np.arange(300, dtype=np.int32).reshape(2, 150)
    cj, sj = jax.jit(lambda p: jlayers.rope_angles(p, 64, 10000.0))(jnp.asarray(pos))
    ct, st = tlayers.rope_angles(torch.from_numpy(pos), 64, 10000.0)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-6)
    x = bf16(np.random.default_rng(1).standard_normal((2, 150, 3, 64)) * 4)
    want = jax.jit(jlayers.apply_rope)(x, cj, sj)
    got = tlayers.apply_rope(to_torch(x), ct, st)
    assert_close_bf16(got, want, frac=1e-3, rel=1e-2)


def test_embedding_scale_is_sqrt_d_model_rounded_to_bf16():
    cj = dataclasses.replace(jax_config(ARCH), use_pallas=True)   # d_model 2048
    ct = dataclasses.replace(torch_config(ARCH), use_pallas=True)
    rng = np.random.default_rng(2)
    emb = bf16(rng.standard_normal((16, 2048)))
    tokens = rng.integers(0, 16, (2, 5)).astype(np.int32)
    want = f32(jlm._embed_inputs(cj, {"embed": emb}, jnp.asarray(tokens), None))
    got = tlm._embed_inputs(ct, {"embed": to_torch(emb)},
                            torch.from_numpy(tokens).long(), None)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(got), want)
    rows = f32(emb)[tokens]
    np.testing.assert_array_equal(
        f32(got), f32(bf16(rows * 45.25)))          # 45.2548 rounded to bf16
    wrong = f32(bf16(rows * np.float32(np.sqrt(2048.0))))
    assert (wrong != f32(got)).any()                # the float32 scalar differs


def _paths(tree, prefix=()):
    """``{path: leaf}`` of nested dicts and lists."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _paths(sub, prefix + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, sub in enumerate(tree)
                for p, v in _paths(sub, prefix + (i,)).items()}
    return {prefix: tree}


def test_params_from_jax_round_trip_is_bit_exact(weights):
    cj, ct, pj, pt = weights
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


def test_port_init_draws_every_leaf_on_its_spec():
    _, ct = _cfgs()
    model = torch_model(ct, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    again = model.init(torch.Generator().manual_seed(0))
    specs = tree_leaves(model.structure())
    leaves = tree_leaves(params)
    assert sum(t.numel() for t in leaves) == model.num_params()
    for spec, t, u in zip(specs, leaves, tree_leaves(again)):
        assert tuple(t.shape) == spec.shape and t.dtype == spec.dtype
        assert torch.equal(t, u)
        if spec.init == "ones":
            assert bool((t == 1).all())
        else:
            assert t.float().std() > 0


# ---------------------------------------------------------------------------
# MLA prefill + decode
# ---------------------------------------------------------------------------

def test_mla_prefill_and_decode_match_reference(weights):
    cj, ct, pj, pt = weights
    pj_mix, pt_mix = pj["prefix"][0]["mix"], pt["prefix"][0]["mix"]
    rng = np.random.default_rng(3)
    x = bf16(rng.standard_normal((B, S, 64)) * 2)
    x1 = bf16(rng.standard_normal((B, 1, 64)) * 2)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    pos1 = np.full((B, 1), S, np.int32)

    def jrun(p, x, pos, cache, idx, valid):
        return jattn.apply_mla(cj, p, x, positions=pos, cache=cache,
                               cache_index=idx, kv_valid=valid)

    jcache = jattn.init_mla_cache(cj, B, S + T)
    yj, jcache = jax.jit(jrun)(pj_mix, x, jnp.asarray(pos), jcache,
                               jnp.int32(0), jnp.int32(S))
    tcache = tattn.init_mla_cache(ct, B, S + T)
    yt, tcache = tattn.apply_mla(ct, pt_mix, to_torch(x),
                                 positions=torch.from_numpy(pos.copy()),
                                 cache=tcache, cache_index=0, kv_valid=S)
    assert_close_bf16(yt, yj)
    for name in ("ckv", "krope"):
        assert_close_bf16(tcache[name], jcache[name], frac=1e-3)

    yj1, _ = jax.jit(jrun)(pj_mix, x1, jnp.asarray(pos1), jcache,
                           jnp.int32(S), jnp.int32(S + 1))
    yt1, _ = tattn.apply_mla(ct, pt_mix, to_torch(x1),
                             positions=torch.from_numpy(pos1), cache=tcache,
                             cache_index=S, kv_valid=S + 1)
    assert_close_bf16(yt1, yj1)


def test_chunked_attention_matches_reference():
    rng = np.random.default_rng(4)
    q = to_torch(bf16(rng.standard_normal((1, S, 2, 1, 24))))
    k = to_torch(bf16(rng.standard_normal((1, S + T, 2, 24))))
    v = to_torch(bf16(rng.standard_normal((1, S + T, 2, 16))))
    qpos = torch.arange(S, dtype=torch.int32)
    kpos = torch.arange(S + T, dtype=torch.int32)
    got = tattn._chunked_attend(q, k, v, qpos, kpos, causal=True, window=0,
                                kv_valid=S, scale=24 ** -0.5, kv_chunk=32)
    assert torch.equal(got, tattn.attend(q, k, v, qpos, kpos, kv_valid=S,
                                         kv_chunk=32))
    want = jax.jit(lambda q, k, v: jattn.attend(
        q, k, v, jnp.asarray(qpos.numpy()), jnp.asarray(kpos.numpy()),
        kv_valid=jnp.int32(S), kv_chunk=32))(*(to_jax(a) for a in (q, k, v)))
    assert_close_bf16(got, want, frac=1e-3)


def test_flash_branch_raises_until_its_slice():
    """Its slice (the full-sequence forward) has come: without a cache,
    ``attend(use_pallas=True)`` takes the flash-attention kernel B4 (its
    plain version on the CPU) and matches the reference's B4 branch, the
    Pallas body in interpret mode, on the grouped (B, S, KV, G, D) query."""
    rng = np.random.default_rng(7)
    Bq, Sq, KV, G, D = 2, 72, 2, 3, 16
    q = bf16(rng.standard_normal((Bq, Sq, KV, G, D)))
    k = bf16(rng.standard_normal((Bq, Sq, KV, D)))
    v = bf16(rng.standard_normal((Bq, Sq, KV, D)))
    pos = np.arange(Sq, dtype=np.int32)
    want = jax.jit(lambda q, k, v: jattn.attend(
        q, k, v, jnp.asarray(pos), jnp.asarray(pos), kv_chunk=32,
        use_pallas=True))(q, k, v)
    got = tattn.attend(to_torch(q), to_torch(k), to_torch(v),
                       torch.from_numpy(pos), torch.from_numpy(pos),
                       kv_chunk=32, use_pallas=True)
    assert tuple(got.shape) == (Bq, Sq, KV, G, D)
    assert_close_bf16(got, f32(want).reshape(Bq, Sq, KV, G, D))


# ---------------------------------------------------------------------------
# MoE layer (use_pallas=True: B7/B8's plain versions on the CPU)
# ---------------------------------------------------------------------------

def _jax_routing(cfg, p, xt):
    """The reference's routing lines (``_apply_moe_local``), jitted."""
    m = cfg.moe
    N = xt.shape[0]
    C = jmoe.capacity_of(cfg, N)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ p["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, m.top_k)
    oh = jax.nn.one_hot(idx, m.num_experts, dtype=jnp.int32).reshape(N * m.top_k, -1)
    pos = ((jnp.cumsum(oh, axis=0) - oh) * oh).sum(-1).reshape(N, m.top_k)
    return probs, idx, jnp.where(pos < C, pos, C).reshape(-1)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["kept", "drops"])
def test_moe_layer_matches_reference(weights, capacity_factor):
    cj, ct, pj, pt = weights
    cj = dataclasses.replace(cj, moe=dataclasses.replace(cj.moe, capacity_factor=capacity_factor))
    ct = dataclasses.replace(ct, moe=dataclasses.replace(ct.moe, capacity_factor=capacity_factor))
    pj_ffn = jax.tree.map(lambda a: a[0], pj["unit"]["b0"]["ffn"])
    pt_ffn = {k: v[0] for k, v in pt["unit"]["b0"]["ffn"].items()}
    x = bf16(np.random.default_rng(5).standard_normal((2, 72, 64)) * 2)

    yj, aux_j = jax.jit(lambda p, x: jmoe.apply_moe(cj, p, x))(pj_ffn, x)
    yt, aux_t = tmoe.apply_moe(ct, pt_ffn, to_torch(x))
    assert_close_bf16(yt, yj)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)

    xt = to_torch(x).reshape(-1, 64)
    probs_j, idx_j, pos_j = jax.jit(lambda p, x: _jax_routing(cj, p, x))(
        pj_ffn, x.reshape(-1, 64))
    probs_t, _, _, e_flat, pos_flat, C = tmoe.route(ct, pt_ffn, xt)
    sp = np.sort(np.asarray(probs_j), axis=-1)[:, ::-1]
    K = cj.moe.top_k
    decided = (sp[:, K - 1] - sp[:, K]) > 1e-6
    near_ties = int((~decided).sum())
    assert near_ties == 0, f"{near_ties} router near-ties on this seed"
    np.testing.assert_array_equal(e_flat.numpy().reshape(-1, K),
                                  np.asarray(idx_j))
    np.testing.assert_array_equal(pos_flat.numpy(), np.asarray(pos_j))
    drops = int((pos_flat == C).sum())
    assert (drops > 0) == (capacity_factor < 1.0)


# ---------------------------------------------------------------------------
# the whole reduced model: prefill + decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(weights):
    """Both packages serve the same prompt; the port is fed the reference's
    greedy tokens, so every step compares logits on the same context."""
    cj, ct, pj, pt = weights
    prompt = np.random.default_rng(6).integers(0, cj.vocab_size, (B, S)).astype(np.int32)
    jm, tm = jax_model(cj), torch_model(ct, device="cpu")
    jcache, tcache = jm.init_cache(B, S + T), tm.init_cache(B, S + T)
    lj, jcache = jax.jit(jm.prefill)(pj, {"tokens": jnp.asarray(prompt)}, jcache)
    chunked = tattn._chunked_attend
    calls = []
    tattn._chunked_attend = lambda *a, **kw: calls.append(1) or chunked(*a, **kw)
    try:
        lt, tcache = tm.prefill(pt, {"tokens": torch.from_numpy(prompt).long()},
                                tcache)
    finally:
        tattn._chunked_attend = chunked
    assert len(calls) == ct.num_layers      # every layer's prefill is chunked
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
    for step, (r, g) in enumerate(zip(ref, got)):
        r, g = r[:, -1], g[:, -1]
        top2 = np.sort(r, axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        decided = margin > 2 * LOGIT_TOL * np.abs(r).max()
        undecided += int((~decided).sum())
        np.testing.assert_array_equal(g.argmax(-1)[decided], r.argmax(-1)[decided])
    print(f"greedy tokens within the logit tolerance of a tie: {undecided} "
          f"of {B * (T + 1)}")


def test_unported_paths_raise():
    # the flash-attention kernel B4 has no backward (nor has the reference's)
    q = torch.zeros((1, 4, 1, 1, 8), dtype=torch.bfloat16, requires_grad=True)
    k = torch.zeros((1, 4, 1, 8), dtype=torch.bfloat16)
    pos = torch.arange(4, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="no backward"):
        tattn.attend(q, k, k, pos, pos, use_pallas=True)
    # the mesh: on a (1, 1) mesh, activation sharding, the MoE layer and the
    # step with sharded accumulators equal the mesh-free path bit for bit
    import torch.distributed as dist
    from repro_torch._tree import tree_flatten
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.param import init_params
    from repro_torch.parallel.sharding import opt_shardings, shard_tree
    from repro_torch.train import TrainState, init_train_state
    from repro_torch.train.optim import OptState

    ct = dataclasses.replace(_cfgs()[1], use_pallas=False)
    assert not dist.is_initialized()
    mesh = make_host_mesh(device="cpu")
    try:
        meshed = dataclasses.replace(ct, mesh=mesh)
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((2, 8, ct.d_model))
                             .astype(np.float32)).bfloat16()
        assert tlayers.constrain(x, meshed, ("dp", "sp", None)) is x
        moe_p = init_params(tmoe.moe_specs(ct), torch.Generator().manual_seed(0),
                            device="cpu")
        y0, a0 = tmoe.apply_moe(ct, moe_p, x)
        y1, a1 = tmoe.apply_moe(meshed, moe_p, x)
        assert torch.equal(y0, y1) and torch.equal(a0, a1)

        model = torch_model(ct, device="cpu")
        tcfg = TrainConfig(grad_accum=2)
        state = init_train_state(model, tcfg, torch.Generator().manual_seed(1))
        batch = {k: torch.from_numpy(rng.integers(0, ct.vocab_size, (4, 8)))
                 for k in ("tokens", "labels")}
        want, wm = tstep.build_train_step(model, tcfg)(state, batch)
        oshard = opt_shardings(model.structure(), mesh)
        sharded = TrainState(state.params, OptState(
            mu=shard_tree(state.opt.mu, oshard),
            nu=shard_tree(state.opt.nu, oshard),
            master=shard_tree(state.opt.master, oshard),
            count=state.opt.count))
        got, gm = tstep.build_train_step(model, tcfg, grad_shardings=oshard)(
            sharded, batch)
        for key in ("loss", "grad_norm", "lr", "ce", "aux"):
            assert torch.equal(gm[key], wm[key]), key
        for a, b in zip(tree_flatten(got.params)[0],
                        tree_flatten(want.params)[0]):
            assert torch.equal(a, b)
        for tree_a, tree_b in ((got.opt.mu, want.opt.mu),
                               (got.opt.nu, want.opt.nu),
                               (got.opt.master, want.opt.master)):
            for a, b in zip(tree_flatten(tree_a)[0], tree_flatten(tree_b)[0]):
                assert a.device_mesh is mesh and torch.equal(a.to_local(), b)
    finally:
        dist.destroy_process_group()
