"""Mixture-of-Experts: top-k router + capacity-based scatter dispatch.

PyTorch counterpart of ``repro.models.moe`` (the single-device path,
``_apply_moe_local``).  Tokens are scattered into a dense (experts,
capacity, d_model) buffer and the expert MLPs run as batched products over
it: with ``cfg.use_pallas`` through the hand-written kernels B7/B8
(``kernels.moe_gmm``), otherwise through the reference's own einsum
branch.  Routing, capacity positions, drops and the gather are the
reference's, op for op.  The expert-parallel shard_map path waits for a
multi-device slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.moe_gmm import moe_gmm, moe_gmm_down
from .layers import constrain, silu, swiglu_hidden
from .param import ParamSpec


def moe_specs(cfg: ModelConfig) -> dict:
    m = cfg.moe
    D, E, Fe = cfg.d_model, m.num_experts, m.d_ff
    s = {
        "router": ParamSpec((D, E), ("embed", "experts"), dtype=torch.float32),
        "w1": ParamSpec((E, D, Fe), ("experts", "embed", "ffn")),
        "w3": ParamSpec((E, D, Fe), ("experts", "embed", "ffn")),
        "w2": ParamSpec((E, Fe, D), ("experts", "ffn", "embed")),
    }
    if m.num_shared_experts:
        Fs = m.d_ff * m.num_shared_experts
        s["shared_w1"] = ParamSpec((D, Fs), ("embed", "ffn"))
        s["shared_w3"] = ParamSpec((D, Fs), ("embed", "ffn"))
        s["shared_w2"] = ParamSpec((Fs, D), ("ffn", "embed"))
    return s


def capacity_of(cfg: ModelConfig, n_tokens: int) -> int:
    m = cfg.moe
    c = int(m.top_k * n_tokens / m.num_experts * m.capacity_factor)
    return max(8, -(-c // 8) * 8)  # multiple of 8, as the reference pads it


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, descending,
    equal values in ascending index order (a stable descending sort;
    ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg: ModelConfig, p: dict, xt: torch.Tensor):
    """Router, top-k and capacity positions for tokens ``xt`` (N, D).

    Returns ``(probs, onehot, gate_vals, e_flat, pos_flat, C)``: gates are
    renormalised over the k picks and zeroed where a pick overflowed its
    expert's capacity ``C``; ``pos_flat`` is ``C`` (the drop slot) there.
    Positions are the exclusive cumsum of the flattened (N*K, E) one-hot,
    token-major, as in the reference.
    """
    m = cfg.moe
    N = xt.shape[0]
    E, K = m.num_experts, m.top_k
    C = capacity_of(cfg, N)

    logits = xt.float() @ p["router"]                          # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, K)                    # (N, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    onehot = F.one_hot(expert_idx, E).to(torch.int32)          # (N, K, E)
    flat_oh = onehot.reshape(N * K, E)
    pos_in_expert = torch.cumsum(flat_oh, dim=0, dtype=torch.int32) - flat_oh
    pos = (pos_in_expert * flat_oh).sum(-1).reshape(N, K)     # (N, K)
    keep = pos < C
    gate_vals = gate_vals * keep

    e_flat = expert_idx.reshape(-1)
    pos_flat = torch.where(keep, pos, C).reshape(-1)           # overflow -> C
    return probs, onehot, gate_vals, e_flat, pos_flat, C


def expert_mlp(cfg: ModelConfig, p: dict, buf: torch.Tensor) -> torch.Tensor:
    """The batched expert MLP over the (E, C, D) dispatch buffer."""
    if cfg.use_pallas:
        hid = moe_gmm(buf, p["w1"], p["w3"])
        return moe_gmm_down(hid, p["w2"])
    hid = silu(torch.einsum("ecd,edf->ecf", buf, p["w1"])) \
        * torch.einsum("ecd,edf->ecf", buf, p["w3"])
    return torch.einsum("ecf,efd->ecd", hid, p["w2"])


def apply_moe(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x: (B, S, D) -> (y, aux_loss), on one device."""
    if cfg.mesh is not None:
        raise NotImplementedError("the expert-parallel shard_map path is not "
                                  "ported yet (ROADMAP A.9c)")
    m = cfg.moe
    B, S, D = x.shape
    N = B * S
    E, K = m.num_experts, m.top_k
    xt = x.reshape(N, D)
    probs, onehot, gate_vals, e_flat, pos_flat, C = route(cfg, p, xt)

    # Scatter tokens into the (E, C + 1, D) buffer; slot C takes the drops.
    buf = torch.zeros((E, C + 1, D), dtype=x.dtype, device=x.device)
    src = xt.repeat_interleave(K, dim=0) if K > 1 else xt
    buf[e_flat, pos_flat] = src
    buf = constrain(buf[:, :C].contiguous(), cfg, ("model", None, None))

    out_buf = expert_mlp(cfg, p, buf)                          # (E, C, D)

    # Gather back, weighted by gates: the reference's products stay float32
    # inside the sum (XLA drops their rounding), and the sum rounds once.
    gathered = out_buf[e_flat, torch.clamp(pos_flat, max=C - 1)]   # (N*K, D)
    gates = gate_vals[..., None].to(x.dtype).float()
    y = (gathered.reshape(N, K, D).float() * gates).sum(1).to(x.dtype)

    if m.num_shared_experts:
        y = y + swiglu_hidden(xt, p["shared_w1"], p["shared_w3"]) @ p["shared_w2"]

    # Switch-style load-balancing auxiliary loss.
    me = probs.mean(0)                                         # (E,)
    ce = (onehot.sum(1) > 0).float().mean(0)                   # fraction routed
    aux = (me * ce).sum() * E * m.aux_loss_coef
    return y.reshape(B, S, D), aux
