"""Attention: GQA/MQA (+bias/qk_norm/window) and DeepSeek MLA.

PyTorch counterpart of ``repro.models.attention`` for self-attention.  The
core is the reference's: the flash-attention kernel B4 under
``use_pallas`` for a causal, windowless, cacheless call (the full-sequence
forward; serving always passes ``kv_valid`` and never reaches it), else
direct softmax attention for short keys and decode, and above
``2 * kv_chunk`` keys the KV-chunked online-softmax scan
(`_chunked_attend`, a Python loop over chunks in place of ``lax.scan``,
each chunk recomputed in the backward pass as the reference's
``jax.checkpoint`` does).  Caches are written in place.  ``apply_gqa``
also runs the encoder's bidirectional attention (``causal=False``) and the
decoder's cross-attention over the encoder's output (``cross=True``), which
take the plain attend as in the reference: B4 is causal only.  In a
mesh program (DTensor operands) the core runs on each rank's shard of the
batch and the heads (``local_map``): attention mixes neither, so the
local call is the whole computation for those rows and heads.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels.flash_attention import flash_attention
from ..parallel.sharding import placements
from .layers import (apply_rope, constrain, constrain_spec, rmsnorm,
                     rope_angles, tp_project_rs)
from .param import ParamSpec

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# core attention math
# ---------------------------------------------------------------------------

def _mask(qpos, kpos, *, causal: bool, window: int, kv_valid):
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    # out of place: in a mesh program the positions may be DTensors
    if causal:
        m = m & (qpos[:, None] >= kpos[None, :])
    if window:
        m = m & ((qpos[:, None] - kpos[None, :]) < window)
    if kv_valid is not None:
        m = m & (kpos < kv_valid)[None, :]
    return m


def _direct_attend(q, k, v, qpos, kpos, *, causal, window, kv_valid, scale):
    """q: (B,Sq,KV,G,D); k/v: (B,Sk,KV,D)."""
    s = torch.einsum("bqkgd,bckd->bqkgc", q, k).float() * scale
    m = _mask(qpos, kpos, causal=causal, window=window, kv_valid=kv_valid)
    s = torch.where(m[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqkgc,bckd->bqkgd", p.to(v.dtype), v)


def _chunked_attend(q, k, v, qpos, kpos, *, causal, window, kv_valid, scale,
                    kv_chunk: int):
    """Online-softmax scan over KV chunks (flash-attention recurrence).

    K and V head dims may differ (MLA: 192-dim keys, 128-dim values).
    """
    B, Sq, KV, G, Dk = q.shape
    Dv = v.shape[-1]
    Sk = k.shape[1]
    n_chunks = -(-Sk // kv_chunk)
    pad = n_chunks * kv_chunk - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = torch.nn.functional.pad(kpos, (0, pad), value=2 ** 30)  # never valid

    def body(m, l, o, kb, vb, kp):
        s = torch.einsum("bqkgd,bckd->bqkgc", q, kb).float() * scale
        msk = _mask(qpos, kp, causal=causal, window=window, kv_valid=kv_valid)
        s = torch.where(msk[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None]) * msk[None, :, None, None, :]
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum(
            "bqkgc,bckd->bqkgd", p.to(vb.dtype), vb).float()
        return m_new, l, o

    # under autograd each chunk is recomputed in the backward pass instead
    # of saving its (Sq x chunk) scores, as the reference's jax.checkpoint
    # of the scan body does: memory changes, values do not
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    m = torch.full((B, Sq, KV, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, KV, G), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, Sq, KV, G, Dv), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        args = (m, l, o, k[:, sl], v[:, sl], kpos[sl])
        m, l, o = (checkpoint(body, *args, use_reentrant=False) if grad
                   else body(*args))
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def attend(q, k, v, qpos, kpos, *, causal=True, window=0, kv_valid=None,
           kv_chunk=1024, use_pallas=False):
    """Dispatch: the flash-attention kernel B4 (full-sequence causal
    forward under ``use_pallas``), direct (short keys, decode) or chunked
    scan (long keys).  DTensor operands: the same on each rank's shard
    (:func:`_attend_local`)."""
    if isinstance(q, DTensor):
        return _attend_local(q, k, v, qpos, kpos, causal=causal,
                             window=window, kv_valid=kv_valid,
                             kv_chunk=kv_chunk, use_pallas=use_pallas)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    Sq, Sk = q.shape[1], k.shape[1]
    if use_pallas and Sq > 1 and causal and window == 0 and kv_valid is None:
        B, _, KV, G, D = q.shape
        out = flash_attention(q.reshape(B, Sq, KV * G, D).contiguous(),
                              k.contiguous(), v.contiguous(), scale=scale)
        return out.reshape(B, Sq, KV, G, D)
    if Sq == 1 or Sk <= 2 * kv_chunk:
        return _direct_attend(q, k, v, qpos, kpos, causal=causal, window=window,
                              kv_valid=kv_valid, scale=scale)
    return _chunked_attend(q, k, v, qpos, kpos, causal=causal, window=window,
                           kv_valid=kv_valid, scale=scale, kv_chunk=kv_chunk)


def _attend_local(q, k, v, qpos, kpos, **kw):
    """:func:`attend` on DTensors: q (B, Sq, KV, G, D), k / v (B, Sk, KV,
    D) keep their shards of the batch (dim 0) and the KV heads (dim 2) and
    are replicated over every other mesh dim; each rank attends its own
    rows and heads, the positions whole."""
    mesh = q.device_mesh
    pl = tuple(p if p in (Shard(0), Shard(2)) else Replicate()
               for p in q.placements)
    whole = (Replicate(),) * mesh.ndim

    def pos_pl(t):
        return whole if isinstance(t, DTensor) else None

    return local_map(
        lambda q_, k_, v_, qp, kp: attend(q_, k_, v_, qp, kp, **kw),
        out_placements=(pl,),
        in_placements=(pl, pl, pl, pos_pl(qpos), pos_pl(kpos)),
        device_mesh=mesh, redistribute_inputs=True)(q, k, v, qpos, kpos)


# ---------------------------------------------------------------------------
# GQA / MQA module
# ---------------------------------------------------------------------------

def gqa_specs(cfg: ModelConfig, *, cross: bool = False) -> dict:
    """Parameters of one GQA block (``cross`` has the same keys: its K
    and V project the encoder's output)."""
    D, H, KV, Dh = cfg.d_model, cfg.padded_heads, cfg.kv_heads_effective, cfg.head_dim
    s = {
        "wq": ParamSpec((D, H, Dh), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((D, KV, Dh), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((D, KV, Dh), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, Dh, D), ("heads", "head_dim", "embed"),
                        fan_in_axes=(0, 1)),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((H, Dh), ("heads", "head_dim"), init="zeros")
        s["bk"] = ParamSpec((KV, Dh), ("kv_heads", "head_dim"), init="zeros")
        s["bv"] = ParamSpec((KV, Dh), ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((Dh,), ("head_dim",), dtype=torch.float32,
                                init="ones")
        s["k_norm"] = ParamSpec((Dh,), ("head_dim",), dtype=torch.float32,
                                init="ones")
    return s


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    KV, Dh = cfg.kv_heads_effective, cfg.head_dim
    return {
        "k": torch.zeros((batch, max_len, KV, Dh), dtype=torch.bfloat16,
                         device=device),
        "v": torch.zeros((batch, max_len, KV, Dh), dtype=torch.bfloat16,
                         device=device),
    }


def apply_gqa(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
              positions: torch.Tensor, kv_x: torch.Tensor | None = None,
              cross: bool = False, cache: dict | None = None,
              cache_index: int | None = None, kv_valid=None,
              causal: bool = True, window: int = 0, use_rope: bool = True):
    """Attention with grouped K/V heads.  Returns (output, cache).

    - self-attention (``cross=False``): K/V from ``x``, rope on q and k
      under ``use_rope``; with ``cache``, K/V are written at ``cache_index``
      in place and attention runs against the whole cache (``kv_valid``
      masks the unwritten rows); the same dict is returned.
    - cross-attention (``cross=True``, no rope, never causal): at prefill
      pass ``kv_x`` (the encoder's output), whose K/V are written into
      ``cache`` in place (a fresh dict without one: the reference's values);
      at decode pass ``kv_x=None`` to attend against the cached K/V, which
      ``k_norm`` does not touch again.
    """
    H, KV, Dh = cfg.padded_heads, cfg.kv_heads_effective, cfg.head_dim
    cached_cross = cross and kv_x is None

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if cached_cross:
        k, v = cache["k"], cache["v"]
    else:
        src = kv_x if cross else x
        k = torch.einsum("bsd,dhk->bshk", src, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", src, p["wv"])
        if "bk" in p:
            k, v = k + p["bk"], v + p["bv"]
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q, cfg.rms_eps)
        if not cached_cross:
            k = rmsnorm(p["k_norm"], k, cfg.rms_eps)
    if use_rope and not cross:
        cos, sin = rope_angles(positions, Dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    # on a mesh, heads over "model" where it divides them, else replicated
    # (DTensor would otherwise move the sequence shards onto an uneven
    # heads split, which no reshape can flatten)
    tpl = ("dp", None, "model", None)
    q, k, v = (constrain(t, cfg, tpl) for t in (q, k, v))

    if cross and not cached_cross:
        if cache is None:
            cache = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
        else:
            if cache["k"].shape[1] != k.shape[1]:
                raise ValueError(f"the cross cache holds {cache['k'].shape[1]} "
                                 f"encoder positions, the encoder gave "
                                 f"{k.shape[1]}")
            cache["k"].copy_(k)
            cache["v"].copy_(v)
    elif cache is not None and not cross:
        idx = 0 if cache_index is None else int(cache_index)
        Sq = q.shape[1]
        cache["k"][:, idx:idx + Sq] = k.to(torch.bfloat16)
        cache["v"][:, idx:idx + Sq] = v.to(torch.bfloat16)
        k, v = cache["k"], cache["v"]
    kpos = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)

    G = H // KV
    B, Sq = q.shape[0], q.shape[1]
    qg = q.reshape(B, Sq, KV, G, Dh)
    qpos = positions[0] if positions.dim() == 2 else positions
    out = attend(qg, k, v, qpos, kpos, causal=causal and not cross,
                 window=window, kv_valid=kv_valid, kv_chunk=cfg.attn_chunk,
                 use_pallas=cfg.use_pallas)
    # on a mesh, KV heads that "model" does not divide are replicated before
    # the heads are flattened (DTensor cannot flatten an uneven shard)
    out = constrain(out, cfg, ("dp", None, "model", None, None))
    out = out.reshape(B, Sq, H, Dh)
    return tp_project_rs(out, p["wo"], cfg, contract_model_dims=2), cache


# ---------------------------------------------------------------------------
# DeepSeek MLA (multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_specs(cfg: ModelConfig) -> dict:
    m = cfg.mla
    D, H = cfg.d_model, cfg.padded_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wq": ParamSpec((D, H, qk), ("embed", "heads", "head_dim")),
        "w_dkv": ParamSpec((D, m.kv_lora_rank), ("embed", "lora")),
        "w_krope": ParamSpec((D, m.qk_rope_dim), ("embed", "head_dim")),
        "kv_norm": ParamSpec((m.kv_lora_rank,), ("lora",), dtype=torch.float32,
                             init="ones"),
        "w_uk": ParamSpec((m.kv_lora_rank, H, m.qk_nope_dim),
                          (None, "heads", "head_dim")),
        "w_uv": ParamSpec((m.kv_lora_rank, H, m.v_head_dim),
                          (None, "heads", "head_dim")),
        "wo": ParamSpec((H, m.v_head_dim, D), ("heads", "head_dim", "embed"),
                        fan_in_axes=(0, 1)),
    }


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, max_len, m.kv_lora_rank),
                           dtype=torch.bfloat16, device=device),
        "krope": torch.zeros((batch, max_len, m.qk_rope_dim),
                             dtype=torch.bfloat16, device=device),
    }


def _write_rows(buf: torch.Tensor, rows: torch.Tensor, idx: int) -> None:
    """``buf[:, idx:idx + Sq] = rows`` in place.  On a mesh each rank
    writes its own shard: the new rows take the buffer's placements (the
    cache rules never split dim 1), so no strategy can gather the cache."""
    rows = rows.to(torch.bfloat16)
    if isinstance(buf, DTensor):
        rows = rows.redistribute(buf.device_mesh, buf.placements).to_local()
        buf = buf.to_local()
    buf[:, idx:idx + rows.shape[1]] = rows


def _mla_heads(cfg: ModelConfig, q, ckv, krope, w_uk, w_uv, qpos, kv_valid):
    """Per-head K / V reconstituted from the latents, the rope key broadcast
    over the heads, and the attend: q (B, Sq, H, 1, Dq), ckv (B, T, L),
    krope (B, T, R); returns (B, Sq, H, Dv)."""
    m = cfg.mla
    k_nope = torch.einsum("btl,lhk->bthk", ckv, w_uk)
    v = torch.einsum("btl,lhk->bthk", ckv, w_uv)
    H = k_nope.shape[2]
    k = torch.cat([k_nope, krope[:, :, None, :].expand(
        *krope.shape[:2], H, m.qk_rope_dim)], dim=-1)
    kpos = torch.arange(k.shape[1], dtype=torch.int32, device=k.device)
    out = attend(q, k, v, qpos, kpos, causal=True, kv_valid=kv_valid,
                 kv_chunk=cfg.attn_chunk)
    return out.reshape(*q.shape[:3], m.v_head_dim)


def _mla_heads_local(cfg: ModelConfig, q, ckv, krope, w_uk, w_uv, qpos,
                     kv_valid):
    """:func:`_mla_heads` on DTensors, every placement pinned: q and the
    output split on the batch over the data dims and on the heads over
    "model" (where they divide), the latents on the batch and whole over
    "model", the up-projections on the heads; each rank reconstitutes only
    its (B/dp, T, H/model) block of K / V.  The reference pins the heads
    with sharding constraints, which DTensor's strategies may not honour
    (they differ between torch releases).  An input whole over a mesh dim
    that splits the computation gets a partial gradient there."""
    mesh = cfg.mesh

    def pl(t, template):
        return placements(constrain_spec(tuple(t.shape), cfg, template), mesh)

    q_pl = pl(q, ("dp", None, "model", None, None))
    kv_pl = pl(ckv, ("dp", None, None))
    w_pl = pl(w_uk, (None, "model", None))
    split = [isinstance(p, Shard) for p in q_pl]

    def grad_pl(pls):
        return tuple(p if isinstance(p, Shard) else
                     Partial() if s else Replicate()
                     for p, s in zip(pls, split))

    pos_pl = (Replicate(),) * mesh.ndim if isinstance(qpos, DTensor) else None
    ins = (q_pl, kv_pl, kv_pl, w_pl, w_pl, pos_pl)
    return local_map(
        lambda *a: _mla_heads(cfg, *a, kv_valid),
        out_placements=(q_pl,), in_placements=ins,
        in_grad_placements=tuple(None if p is None else grad_pl(p)
                                 for p in ins),
        device_mesh=mesh, redistribute_inputs=True)(
            q, ckv, krope, w_uk, w_uv, qpos)


def apply_mla(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
              positions: torch.Tensor, cache: dict | None = None,
              cache_index: int | None = None, kv_valid=None):
    """MLA: KV compressed to rank-``kv_lora`` latents + a shared rope key.

    The cache stores only (c_kv, k_rope); per-head K/V are reconstituted
    through the up-projections.  Unlike the reference, which returns a new
    cache, the port writes the new rows into ``cache`` in place (no copy of
    the whole cache a step) and returns the same dict.  On a mesh the
    reconstitution and the attend run on each rank's shard of the batch and
    the heads (:func:`_mla_heads_local`).
    """
    m = cfg.mla
    H = cfg.padded_heads
    B, Sq, D = x.shape

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    cos, sin = rope_angles(positions, m.qk_rope_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)

    ckv = rmsnorm(p["kv_norm"], x @ p["w_dkv"], cfg.rms_eps)
    krope = apply_rope((x @ p["w_krope"])[:, :, None, :], cos, sin)[:, :, 0, :]

    if cache is not None:
        idx = 0 if cache_index is None else int(cache_index)
        _write_rows(cache["ckv"], ckv, idx)
        _write_rows(cache["krope"], krope, idx)
        ckv, krope = cache["ckv"], cache["krope"]

    qg = torch.cat([q_nope, q_rope], dim=-1)[:, :, :, None, :]   # KV=H, G=1
    qpos = positions[0] if positions.dim() == 2 else positions
    heads = _mla_heads_local if isinstance(qg, DTensor) else _mla_heads
    out = heads(cfg, qg.reshape(B, Sq, H, 1, -1), ckv, krope, p["w_uk"],
                p["w_uv"], qpos, kv_valid)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache
