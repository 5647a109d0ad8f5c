"""Decoder-only LM assembly: pattern-based layer stack and caches.

PyTorch counterpart of ``repro.models.lm``: the full-sequence forward
(``forward`` / ``forward_hidden``, for training and evaluation) and the
serving path (``prefill`` and ``decode_step``).  The parameter tree is the
reference's:

    prefix layers   — unrolled (e.g. DeepSeek's first dense layer)
    unit            — ``num_units`` repeats of ``block_pattern``, parameters
                      stacked on a leading "layers" axis
    suffix layers   — unrolled remainder (e.g. RecurrentGemma's last two)

Each layer is a pre-norm mixing block (``attn`` — MLA, or GQA with a ring
cache when the config has a window — ``rwkv`` or ``rglru``) and a pre-norm
FFN block (dense MLP or MoE).  The reference scans the unit with
``lax.scan``; here a Python loop walks the stacked axis (each step a view of
one unit's parameters and cache).  In training (``train`` with
``cfg.remat`` and autograd on) each unit runs under
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` of the
scanned unit: its activations are recomputed in the backward pass.  Caches
are written in place.  Prefix embeddings (the vision frontend's stub
patch embeddings) go in front of the token rows.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import attention as attn_lib
from . import moe as moe_lib
from . import rglru as rglru_lib
from . import rwkv6 as rwkv_lib
from .layers import (apply_rope, constrain, embed_tokens, gather_sequence,
                     mlp_specs, rmsnorm, rmsnorm_spec, rope_angles,
                     swiglu_hidden, tp_project_rs)
from .param import ParamSpec, tree_map

# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------

def _layer_kind(cfg: ModelConfig, layer_idx: int) -> str:
    return cfg.block_pattern[layer_idx % cfg.repeat_unit]


def _is_moe_layer(cfg: ModelConfig, layer_idx: int) -> bool:
    return cfg.moe is not None and layer_idx >= cfg.moe.first_dense_layers


def _layer_specs(cfg: ModelConfig, kind: str, moe_layer: bool) -> dict:
    D = cfg.d_model
    s: dict[str, Any] = {"ln1": rmsnorm_spec(D), "ln2": rmsnorm_spec(D)}
    if kind == "attn":
        s["mix"] = attn_lib.mla_specs(cfg) if cfg.mla else attn_lib.gqa_specs(cfg)
    elif kind == "rwkv":
        s["mix"] = rwkv_lib.rwkv_specs(cfg)
    elif kind == "rglru":
        s["mix"] = rglru_lib.rglru_specs(cfg)
    else:
        raise ValueError(kind)
    s["ffn"] = moe_lib.moe_specs(cfg) if moe_layer else mlp_specs(D, cfg.d_ff)
    return s


def _stack(structure, n: int):
    return tree_map(
        lambda p: ParamSpec((n,) + p.shape, ("layers",) + p.axes, p.dtype,
                            p.init, None if p.fan_in_axes is None
                            else tuple(i + 1 for i in p.fan_in_axes)),
        structure)


def _partition(cfg: ModelConfig):
    """(prefix_idxs, scanned_idxs, suffix_idxs, units) over the layer range."""
    P = cfg.moe.first_dense_layers if cfg.moe else 0
    rest = cfg.num_layers - P
    U = rest // cfg.repeat_unit
    prefix = list(range(P))
    scanned = list(range(P, P + U * cfg.repeat_unit))
    suffix = list(range(P + U * cfg.repeat_unit, cfg.num_layers))
    return prefix, scanned, suffix, U


def structure(cfg: ModelConfig) -> dict:
    D, V = cfg.d_model, cfg.padded_vocab
    prefix, scanned, suffix, U = _partition(cfg)
    s: dict[str, Any] = {
        "embed": ParamSpec((V, D), ("vocab", "embed"), fan_in_axes=(1,)),
        "final_norm": rmsnorm_spec(D),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((V, D), ("vocab", "embed"))
    s["prefix"] = [_layer_specs(cfg, _layer_kind(cfg, i), _is_moe_layer(cfg, i))
                   for i in prefix]
    if U > 0:
        unit = {f"b{j}": _layer_specs(cfg, _layer_kind(cfg, scanned[0] + j),
                                      _is_moe_layer(cfg, scanned[0] + j))
                for j in range(cfg.repeat_unit)}
        s["unit"] = _stack(unit, U)
    s["suffix"] = [_layer_specs(cfg, _layer_kind(cfg, i), _is_moe_layer(cfg, i))
                   for i in suffix]
    return s


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 device=None):
    if kind == "attn":
        if cfg.mla:
            return attn_lib.init_mla_cache(cfg, batch, max_len, device)
        length = min(max_len, cfg.window) if cfg.window else max_len
        c = attn_lib.init_kv_cache(cfg, batch, length, device)
        if cfg.window:
            # the ring's slot positions; -2^30 marks a slot never written
            c["pos"] = torch.full((length,), -(2 ** 30), dtype=torch.int32,
                                  device=device)
        return c
    if kind == "rwkv":
        return rwkv_lib.init_rwkv_state(cfg, batch, device)
    if kind == "rglru":
        return rglru_lib.init_rglru_state(cfg, batch, device)
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """Per-layer caches mirroring the parameter tree: MLA latents, K/V (a
    ring of ``min(max_len, window)`` slots under a window), or the
    recurrent states."""
    prefix, scanned, suffix, U = _partition(cfg)
    layer = lambda i: _layer_cache(cfg, _layer_kind(cfg, i), batch,  # noqa: E731
                                   max_len, device)
    cache: dict[str, Any] = {"prefix": [layer(i) for i in prefix],
                             "suffix": [layer(i) for i in suffix]}
    if U > 0:
        unit = {f"b{j}": layer(scanned[0] + j) for j in range(cfg.repeat_unit)}
        cache["unit"] = tree_map(
            lambda x: x[None].expand((U,) + x.shape).contiguous(), unit)
    return cache


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def _window_cache_write(cfg, cache, k, v, positions):
    """Ring-buffer write for local attention, in place; returns (cache,
    k_all, v_all, kpos)."""
    W = cache["k"].shape[1]
    S = k.shape[1]
    if S > W:
        k, v, positions = k[:, -W:], v[:, -W:], positions[:, -W:]
    slots = (positions[0] % W).long()
    cache["k"][:, slots] = k.to(torch.bfloat16)
    cache["v"][:, slots] = v.to(torch.bfloat16)
    cache["pos"][slots] = positions[0].to(torch.int32)
    return cache, cache["k"], cache["v"], cache["pos"]


def _apply_attn(cfg, p, x, positions, cache, cache_index, kv_valid):
    if cfg.mla:
        return attn_lib.apply_mla(cfg, p, x, positions=positions, cache=cache,
                                  cache_index=cache_index, kv_valid=kv_valid)
    window = cfg.window
    if cache is not None and window:
        # local attention with a ring cache: project, rope, then ring write
        H, KV, Dh = cfg.padded_heads, cfg.kv_heads_effective, cfg.head_dim
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
        k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
        if "bq" in p:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        cos, sin = rope_angles(positions, Dh, cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        cache, k_all, v_all, kpos = _window_cache_write(cfg, cache, k, v,
                                                        positions)
        B, Sq = q.shape[0], q.shape[1]
        qg = q.reshape(B, Sq, KV, H // KV, Dh)
        out = attn_lib.attend(qg, k_all, v_all, positions[0], kpos,
                              causal=True, window=window, kv_valid=kv_valid,
                              kv_chunk=cfg.attn_chunk)
        y = torch.einsum("bshk,hkd->bsd", out.reshape(B, Sq, H, Dh), p["wo"])
        return y, cache
    return attn_lib.apply_gqa(cfg, p, x, positions=positions, cache=cache,
                              cache_index=cache_index, kv_valid=kv_valid,
                              window=window)


def _apply_layer(cfg, kind, moe_layer, p, x, positions, cache, cache_index,
                 kv_valid, decode, x_norm=None):
    """One layer.  Returns ``(x, cache, aux, x_sum)``: the bf16 residual
    stream, the cache (written in place), the MoE auxiliary loss, and the
    float32 sum that ``x`` rounds (what a fused next layer's first norm
    reads).  ``x_norm`` is the float32 value this layer's first norm reads
    (``x`` when ``None``)."""
    h = gather_sequence(rmsnorm(p["ln1"], x if x_norm is None else x_norm,
                                cfg.rms_eps, dtype=x.dtype), cfg)
    if kind == "attn":
        mix, new_cache = _apply_attn(cfg, p["mix"], h, positions, cache,
                                     cache_index, kv_valid)
    elif kind == "rwkv":
        mix, new_cache = rwkv_lib.apply_rwkv(cfg, p["mix"], h, cache,
                                             decode=decode)
    else:
        mix, new_cache = rglru_lib.apply_rglru(cfg, p["mix"], h, cache,
                                               decode=decode)
    # The reference's jitted layer adds the residual in float32 and feeds
    # that unrounded sum to the second norm (XLA fuses the add into the
    # norm's upcast); only the carried residual is rounded to bf16.
    res = x.float() + constrain(mix, cfg, ("dp", "sp", None)).float()
    x = res.to(x.dtype)
    h = gather_sequence(rmsnorm(p["ln2"], res, cfg.rms_eps, dtype=x.dtype),
                        cfg)
    if moe_layer:
        ffn, aux = moe_lib.apply_moe(cfg, p["ffn"], h)
    else:
        hid = swiglu_hidden(h, p["ffn"]["w1"], p["ffn"]["w3"])
        ffn = tp_project_rs(hid, p["ffn"]["w2"], cfg, contract_model_dims=1)
        aux = 0.0
    x_sum = constrain(x.float() + ffn.float(), cfg, ("dp", "sp", None))
    return x_sum.to(x.dtype), new_cache, aux, x_sum


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------

def _embed_inputs(cfg, params, tokens, prefix_embeds):
    """Embedding rows times sqrt(d_model) rounded to bf16, as the reference
    multiplies (sqrt(2048) = 45.2548 becomes 45.25): a bf16 tensor, since
    ``bf16_tensor * python_float`` would multiply by the float32 value.
    ``prefix_embeds`` (B, P, D), the vision frontend's patch embeddings,
    go in front of the token rows in their dtype; positions then run over
    both."""
    emb = params["embed"]
    scale = torch.full((), math.sqrt(float(cfg.d_model)), dtype=torch.float32,
                       device=emb.device).to(torch.bfloat16)
    x = embed_tokens(emb, tokens) * scale
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


def _logits(cfg, params, x):
    return torch.einsum("bsd,vd->bsv", gather_sequence(x, cfg),
                        lm_head_weights(cfg, params))


def _run_stack(cfg, params, x, positions, caches, cache_index, kv_valid,
               decode, train=False):
    """The layer stack and the final norm.

    The reference's jitted stack rounds as XLA fuses it, and the port
    follows: inside one scanned unit, and along the unrolled suffix into
    the final norm, the residual sum a layer ends with feeds the next first
    norm unrounded (only the carried residual is rounded to bf16); the
    scan's carry, and so the input of each unit and of the first suffix
    layer, is the rounded bf16 stream.  With ``train``, ``cfg.remat`` and
    autograd on, each unit is recomputed in the backward pass (every
    ``remat_policy`` recomputes the whole unit here: the policy changes
    what is saved, never a value).
    """
    prefix, scanned, suffix, U = _partition(cfg)
    aux_total = 0.0
    new_caches: dict[str, Any] = {"prefix": [], "suffix": []}

    for n, i in enumerate(prefix):
        c = caches["prefix"][n] if caches else None
        x, nc, aux, _ = _apply_layer(cfg, _layer_kind(cfg, i),
                                     _is_moe_layer(cfg, i), params["prefix"][n],
                                     x, positions, c, cache_index, kv_valid,
                                     decode)
        new_caches["prefix"].append(nc)
        aux_total = aux_total + aux

    if U > 0:
        kinds = [_layer_kind(cfg, scanned[0] + j) for j in range(cfg.repeat_unit)]
        moes = [_is_moe_layer(cfg, scanned[0] + j) for j in range(cfg.repeat_unit)]

        def unit(x, p_u, c_u):
            x_sum, aux = None, 0.0
            for j, (kind, moe_l) in enumerate(zip(kinds, moes)):
                c = c_u[f"b{j}"] if c_u is not None else None
                x, _, a, x_sum = _apply_layer(cfg, kind, moe_l, p_u[f"b{j}"], x,
                                              positions, c, cache_index,
                                              kv_valid, decode, x_norm=x_sum)
                aux = aux + a
            return x, aux

        remat = train and cfg.remat and torch.is_grad_enabled()
        for u in range(U):
            p_u = tree_map(lambda a: a[u], params["unit"])
            c_u = tree_map(lambda a: a[u], caches["unit"]) if caches else None
            if remat:
                x, a = checkpoint(unit, x, p_u, c_u, use_reentrant=False)
            else:
                x, a = unit(x, p_u, c_u)
            aux_total = aux_total + a
        # the unit caches were written in place through the views
        new_caches["unit"] = caches["unit"] if caches else None

    x_sum = None
    for n, i in enumerate(suffix):
        c = caches["suffix"][n] if caches else None
        x, nc, aux, x_sum = _apply_layer(cfg, _layer_kind(cfg, i),
                                         _is_moe_layer(cfg, i),
                                         params["suffix"][n], x, positions, c,
                                         cache_index, kv_valid, decode,
                                         x_norm=x_sum)
        new_caches["suffix"].append(nc)
        aux_total = aux_total + aux

    x = rmsnorm(params["final_norm"], x if x_sum is None else x_sum,
                cfg.rms_eps, dtype=x.dtype)
    return x, new_caches, aux_total


def forward(cfg: ModelConfig, params, tokens, prefix_embeds=None, *,
            train=True):
    """Full-sequence forward (training / evaluation).  Returns (logits,
    aux)."""
    x, aux = forward_hidden(cfg, params, tokens, prefix_embeds, train=train)
    return _logits(cfg, params, x), aux


def forward_hidden(cfg: ModelConfig, params, tokens, prefix_embeds=None, *,
                   train=True):
    """Forward up to the final norm (pre-logits): the fused-CE entry point.
    Attention takes the flash-attention kernel B4 under ``cfg.use_pallas``
    (which has no backward), else the plain route."""
    x = _embed_inputs(cfg, params, tokens, prefix_embeds)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    x, _, aux = _run_stack(cfg, params, x, positions, None, None, None,
                           decode=False, train=train)
    return gather_sequence(x, cfg), aux


def lm_head_weights(cfg: ModelConfig, params):
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens, cache, prefix_embeds=None):
    """Populate caches from a prompt; returns (last-position logits, cache).

    The cache is written in place; the returned dict is the same one.
    """
    x = _embed_inputs(cfg, params, tokens, prefix_embeds)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    x, new_cache, _ = _run_stack(cfg, params, x, positions, cache, 0, S,
                                 decode=False)
    return _logits(cfg, params, x[:, -1:]), new_cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, token, cache, index):
    """One decode step.  token: (B, 1) integer ids; index: the position
    (an int or a 0-dim tensor).  Writes the cache in place."""
    index = int(index)
    x = _embed_inputs(cfg, params, token, None)
    B = x.shape[0]
    positions = torch.full((B, 1), index, dtype=torch.int32, device=x.device)
    x, new_cache, _ = _run_stack(cfg, params, x, positions, cache, index,
                                 index + 1, decode=True)
    return _logits(cfg, params, x), new_cache

