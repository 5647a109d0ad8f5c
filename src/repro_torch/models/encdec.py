"""Encoder-decoder assembly (the SeamlessM4T backbone).

PyTorch counterpart of ``repro.models.encdec``.  Encoder: bidirectional
attention over precomputed modality-frontend frame embeddings (the frontend
itself is a stub, as in the reference).  Decoder: causal self-attention,
cross-attention over the encoder's output, and the gated MLP.  The
parameter tree is the reference's (``enc_unit`` and ``dec_unit`` stacked on
a leading "layers" axis), and a Python loop walks the stacked axis in place
of ``lax.scan``; caches are written in place.

Rounding follows the reference's jitted scan over one layer a step (F3 in
ROADMAP C): a residual sum that feeds the next norm inside a layer is read
unrounded, and the carry between layers, which the final norm reads too,
is the rounded bf16 stream.  In training (``train`` with ``cfg.remat`` and
autograd on) each layer runs under ``torch.utils.checkpoint``, as the
reference's ``jax.checkpoint`` of the scan body.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import attention as attn_lib
from .layers import (gather_sequence, mlp_specs, rmsnorm, rmsnorm_spec,
                     swiglu_hidden)
from .lm import _embed_inputs, _logits, _stack
from .param import ParamSpec, tree_map


def _enc_layer_specs(cfg: ModelConfig) -> dict:
    return {"ln1": rmsnorm_spec(cfg.d_model), "ln2": rmsnorm_spec(cfg.d_model),
            "attn": attn_lib.gqa_specs(cfg),
            "ffn": mlp_specs(cfg.d_model, cfg.d_ff)}


def _dec_layer_specs(cfg: ModelConfig) -> dict:
    return {"ln1": rmsnorm_spec(cfg.d_model), "ln2": rmsnorm_spec(cfg.d_model),
            "ln3": rmsnorm_spec(cfg.d_model),
            "self_attn": attn_lib.gqa_specs(cfg),
            "cross_attn": attn_lib.gqa_specs(cfg, cross=True),
            "ffn": mlp_specs(cfg.d_model, cfg.d_ff)}


def structure(cfg: ModelConfig) -> dict:
    D, V = cfg.d_model, cfg.padded_vocab
    s: dict[str, Any] = {
        "embed": ParamSpec((V, D), ("vocab", "embed"), fan_in_axes=(1,)),
        "enc_norm": rmsnorm_spec(D),
        "final_norm": rmsnorm_spec(D),
        "enc_unit": _stack(_enc_layer_specs(cfg), cfg.enc_layers),
        "dec_unit": _stack(_dec_layer_specs(cfg), cfg.num_layers),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((V, D), ("vocab", "embed"))
    return s


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """The decoder's caches, stacked over its layers: ``self`` K/V of
    ``max_len`` positions, and ``cross`` K/V of the encoder's
    ``frontend_len`` positions (written once, at prefill)."""
    L, F = cfg.num_layers, cfg.frontend_len
    KV, Dh = cfg.kv_heads_effective, cfg.head_dim
    self_c = attn_lib.init_kv_cache(cfg, batch, max_len, device)
    cross = lambda: torch.zeros((L, batch, F, KV, Dh), dtype=torch.bfloat16,  # noqa: E731
                                device=device)
    return {"self": tree_map(lambda x: x[None].expand((L,) + x.shape).contiguous(),
                             self_c),
            "cross": {"k": cross(), "v": cross()}}


def _ffn(p, h):
    return swiglu_hidden(h, p["w1"], p["w3"]) @ p["w2"]


def _remat(train: bool, cfg: ModelConfig) -> bool:
    return train and cfg.remat and torch.is_grad_enabled()


def _enc_layer(cfg, p, x, positions):
    h = gather_sequence(rmsnorm(p["ln1"], x, cfg.rms_eps), cfg)
    mix, _ = attn_lib.apply_gqa(cfg, p["attn"], h, positions=positions,
                                causal=False)
    # the residual sum feeds the second norm unrounded (XLA fuses the add
    # into the norm's upcast); the carried stream is rounded to bf16
    res = x.float() + mix.float()
    h = gather_sequence(rmsnorm(p["ln2"], res, cfg.rms_eps, dtype=x.dtype),
                        cfg)
    return (res.to(x.dtype).float() + _ffn(p["ffn"], h).float()).to(x.dtype)


def encode(cfg: ModelConfig, params, frames, *, train=True):
    """frames: (B, F, D) precomputed frontend embeddings."""
    B, F, _ = frames.shape
    positions = torch.arange(F, dtype=torch.int32,
                             device=frames.device)[None].expand(B, F)
    x = frames.to(torch.bfloat16)
    remat = _remat(train, cfg)
    for u in range(cfg.enc_layers):
        p = tree_map(lambda a: a[u], params["enc_unit"])
        x = (checkpoint(_enc_layer, cfg, p, x, positions, use_reentrant=False)
             if remat else _enc_layer(cfg, p, x, positions))
    return gather_sequence(rmsnorm(params["enc_norm"], x, cfg.rms_eps), cfg)


def _dec_layer(cfg, p, x, positions, enc_out, self_c, cross_c, cache_index,
               kv_valid, decode):
    h = gather_sequence(rmsnorm(p["ln1"], x, cfg.rms_eps), cfg)
    mix, _ = attn_lib.apply_gqa(cfg, p["self_attn"], h, positions=positions,
                                cache=self_c, cache_index=cache_index,
                                kv_valid=kv_valid)
    res = x.float() + mix.float()
    x = res.to(x.dtype)
    h = gather_sequence(rmsnorm(p["ln2"], res, cfg.rms_eps, dtype=x.dtype),
                        cfg)
    mix, _ = attn_lib.apply_gqa(cfg, p["cross_attn"], h, positions=positions,
                                cross=True, kv_x=None if decode else enc_out,
                                cache=cross_c)
    res = x.float() + mix.float()
    x = res.to(x.dtype)
    h = gather_sequence(rmsnorm(p["ln3"], res, cfg.rms_eps, dtype=x.dtype),
                        cfg)
    return (x.float() + _ffn(p["ffn"], h).float()).to(x.dtype)


def decode_stack(cfg: ModelConfig, params, tokens, enc_out, caches=None,
                 cache_index=None, kv_valid=None, *, decode=False, train=True):
    """The decoder over ``tokens`` and the final norm's logits.  Returns
    (logits, caches), the caches written in place."""
    x = _embed_inputs(cfg, params, tokens, None)
    B, S = x.shape[0], x.shape[1]
    if decode:
        positions = torch.full((B, 1), int(cache_index), dtype=torch.int32,
                               device=x.device)
    else:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
    remat = _remat(train, cfg)
    for u in range(cfg.num_layers):
        p = tree_map(lambda a: a[u], params["dec_unit"])
        self_c = tree_map(lambda a: a[u], caches["self"]) if caches else None
        cross_c = tree_map(lambda a: a[u], caches["cross"]) if caches else None
        args = (cfg, p, x, positions, enc_out, self_c, cross_c, cache_index,
                kv_valid, decode)
        x = (checkpoint(_dec_layer, *args, use_reentrant=False) if remat
             else _dec_layer(*args))
    x = rmsnorm(params["final_norm"], x, cfg.rms_eps)
    return _logits(cfg, params, x), caches


def forward(cfg: ModelConfig, params, tokens, frames, *, train=True):
    """Training forward: (B, S) text tokens and (B, F, D) frames ->
    (logits, aux)."""
    enc_out = encode(cfg, params, frames, train=train)
    logits, _ = decode_stack(cfg, params, tokens, enc_out, train=train)
    return logits, 0.0


@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens, frames, cache):
    """Encode the frames, fill both caches from the prompt; returns the last
    position's logits and the cache (the same dict)."""
    enc_out = encode(cfg, params, frames, train=False)
    S = tokens.shape[1]
    logits, cache = decode_stack(cfg, params, tokens, enc_out, cache,
                                 cache_index=0, kv_valid=S, train=False)
    return logits[:, -1:], cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, token, cache, index):
    """One decode step at position ``index``: self-attention over the
    positions up to it, cross-attention over the cached encoder K/V."""
    index = int(index)
    return decode_stack(cfg, params, token, None, cache, cache_index=index,
                        kv_valid=index + 1, decode=True, train=False)
