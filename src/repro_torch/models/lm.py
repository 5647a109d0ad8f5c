"""Decoder-only LM assembly: pattern-based layer stack and caches.

PyTorch counterpart of ``repro.models.lm`` for the serving path
(``prefill`` and ``decode_step``).  The parameter tree is the reference's:

    prefix layers   — unrolled (e.g. DeepSeek's first dense layer)
    unit            — ``num_units`` repeats of ``block_pattern``, parameters
                      stacked on a leading "layers" axis
    suffix layers   — unrolled remainder

The reference scans the unit with ``lax.scan``; here a Python loop walks
the stacked axis (each step a view of one unit's parameters and cache).
Caches are written in place.  Ported so far: the ``attn`` kind with MLA,
and dense or MoE FFNs.  The ``rwkv`` and ``rglru`` kinds, GQA attention,
windowed caches and prefix embeddings raise ``NotImplementedError``
naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from ..configs.base import ModelConfig
from . import attention as attn_lib
from . import moe as moe_lib
from .layers import (constrain, mlp_specs, rmsnorm, rmsnorm_spec,
                     swiglu_hidden, tp_project_rs)
from .param import ParamSpec, tree_map

_NOT_YET = {
    "rwkv": "the rwkv kind comes with kernel B5's slice (ROADMAP B.5)",
    "rglru": "the rglru kind comes with kernel B6's slice (ROADMAP B.6)",
    "gqa": "GQA attention comes with kernel B4's slice (ROADMAP B.4)",
    "window": "windowed attention caches come with kernel B6's slice "
              "(ROADMAP B.6)",
    "prefix": "prefix embeddings (vision/audio frontends) are not ported yet "
              "(ROADMAP A.9)",
}


def _check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is what this slice ports: ``attn`` layers with
    MLA and no window (dense or MoE FFNs)."""
    for kind in cfg.block_pattern:
        if kind != "attn":
            raise (NotImplementedError(_NOT_YET[kind]) if kind in _NOT_YET
                   else ValueError(kind))
    if not cfg.mla:
        raise NotImplementedError(_NOT_YET["gqa"])
    if cfg.window:
        raise NotImplementedError(_NOT_YET["window"])


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------

def _is_moe_layer(cfg: ModelConfig, layer_idx: int) -> bool:
    return cfg.moe is not None and layer_idx >= cfg.moe.first_dense_layers


def _layer_specs(cfg: ModelConfig, moe_layer: bool) -> dict:
    D = cfg.d_model
    return {"ln1": rmsnorm_spec(D), "ln2": rmsnorm_spec(D),
            "mix": attn_lib.mla_specs(cfg),
            "ffn": moe_lib.moe_specs(cfg) if moe_layer else mlp_specs(D, cfg.d_ff)}


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
    _check_supported(cfg)
    D, V = cfg.d_model, cfg.padded_vocab
    prefix, scanned, suffix, U = _partition(cfg)
    s: dict[str, Any] = {
        "embed": ParamSpec((V, D), ("vocab", "embed"), fan_in_axes=(1,)),
        "final_norm": rmsnorm_spec(D),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((V, D), ("vocab", "embed"))
    s["prefix"] = [_layer_specs(cfg, _is_moe_layer(cfg, i)) for i in prefix]
    if U > 0:
        unit = {f"b{j}": _layer_specs(cfg, _is_moe_layer(cfg, scanned[0] + j))
                for j in range(cfg.repeat_unit)}
        s["unit"] = _stack(unit, U)
    s["suffix"] = [_layer_specs(cfg, _is_moe_layer(cfg, i)) for i in suffix]
    return s


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """The MLA latent caches, mirroring the parameter tree."""
    _check_supported(cfg)
    prefix, scanned, suffix, U = _partition(cfg)
    layer = lambda: attn_lib.init_mla_cache(cfg, batch, max_len, device)  # noqa: E731
    cache: dict[str, Any] = {"prefix": [layer() for _ in prefix],
                             "suffix": [layer() for _ in suffix]}
    if U > 0:
        unit = {f"b{j}": layer() for j in range(cfg.repeat_unit)}
        cache["unit"] = tree_map(
            lambda x: x[None].expand((U,) + x.shape).contiguous(), unit)
    return cache


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def _apply_layer(cfg, moe_layer, p, x, positions, cache, cache_index, kv_valid):
    h = rmsnorm(p["ln1"], x, cfg.rms_eps)
    mix, new_cache = attn_lib.apply_mla(cfg, p["mix"], h, positions=positions,
                                        cache=cache, cache_index=cache_index,
                                        kv_valid=kv_valid)
    # The reference's jitted layer adds the residual in float32 and feeds
    # that unrounded sum to the second norm (XLA fuses the add into the
    # norm's upcast); only the carried residual is rounded to bf16.
    res = x.float() + constrain(mix, cfg, ("dp", "sp", None)).float()
    x = res.to(x.dtype)
    h = rmsnorm(p["ln2"], res, cfg.rms_eps, dtype=x.dtype)
    if moe_layer:
        ffn, aux = moe_lib.apply_moe(cfg, p["ffn"], h)
    else:
        hid = swiglu_hidden(h, p["ffn"]["w1"], p["ffn"]["w3"])
        ffn = tp_project_rs(hid, p["ffn"]["w2"], cfg, contract_model_dims=1)
        aux = 0.0
    x = constrain(x + ffn, cfg, ("dp", "sp", None))
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------

def _embed_inputs(cfg, params, tokens, prefix_embeds):
    """Embedding rows times sqrt(d_model) rounded to bf16, as the reference
    multiplies (sqrt(2048) = 45.2548 becomes 45.25): a bf16 tensor, since
    ``bf16_tensor * python_float`` would multiply by the float32 value."""
    if prefix_embeds is not None:
        raise NotImplementedError(_NOT_YET["prefix"])
    emb = params["embed"]
    scale = torch.full((), math.sqrt(float(cfg.d_model)), dtype=torch.float32,
                       device=emb.device).to(torch.bfloat16)
    return emb[tokens] * scale


def _logits(cfg, params, x):
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("bsd,vd->bsv", x, head)


def _run_stack(cfg, params, x, positions, caches, cache_index, kv_valid):
    prefix, scanned, suffix, U = _partition(cfg)
    aux_total = 0.0
    new_caches: dict[str, Any] = {"prefix": [], "suffix": []}

    for n, i in enumerate(prefix):
        c = caches["prefix"][n] if caches else None
        x, nc, aux = _apply_layer(cfg, _is_moe_layer(cfg, i), params["prefix"][n],
                                  x, positions, c, cache_index, kv_valid)
        new_caches["prefix"].append(nc)
        aux_total = aux_total + aux

    if U > 0:
        moes = [_is_moe_layer(cfg, scanned[0] + j) for j in range(cfg.repeat_unit)]
        for u in range(U):
            p_u = tree_map(lambda a: a[u], params["unit"])
            c_u = tree_map(lambda a: a[u], caches["unit"]) if caches else None
            for j, moe_l in enumerate(moes):
                c = c_u[f"b{j}"] if c_u is not None else None
                x, _, a = _apply_layer(cfg, moe_l, p_u[f"b{j}"], x, positions,
                                       c, cache_index, kv_valid)
                aux_total = aux_total + a
        # the unit caches were written in place through the views
        new_caches["unit"] = caches["unit"] if caches else None

    for n, i in enumerate(suffix):
        c = caches["suffix"][n] if caches else None
        x, nc, aux = _apply_layer(cfg, _is_moe_layer(cfg, i), params["suffix"][n],
                                  x, positions, c, cache_index, kv_valid)
        new_caches["suffix"].append(nc)
        aux_total = aux_total + aux

    x = rmsnorm(params["final_norm"], x, cfg.rms_eps)
    return x, new_caches, aux_total


@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens, cache, prefix_embeds=None):
    """Populate caches from a prompt; returns (last-position logits, cache).

    The cache is written in place; the returned dict is the same one.
    """
    _check_supported(cfg)
    x = _embed_inputs(cfg, params, tokens, prefix_embeds)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    x, new_cache, _ = _run_stack(cfg, params, x, positions, cache, 0, S)
    return _logits(cfg, params, x[:, -1:]), new_cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, token, cache, index):
    """One decode step.  token: (B, 1) integer ids; index: the position
    (an int or a 0-dim tensor).  Writes the cache in place."""
    _check_supported(cfg)
    index = int(index)
    x = _embed_inputs(cfg, params, token, None)
    B = x.shape[0]
    positions = torch.full((B, 1), index, dtype=torch.int32, device=x.device)
    x, new_cache, _ = _run_stack(cfg, params, x, positions, cache, index,
                                 index + 1)
    return _logits(cfg, params, x), new_cache

