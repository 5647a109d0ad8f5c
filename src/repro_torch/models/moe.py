"""Mixture-of-Experts: top-k router + capacity-based scatter dispatch.

PyTorch counterpart of ``repro.models.moe`` (the single-device path,
``_apply_moe_local``).  Tokens are scattered into a dense (experts,
capacity, d_model) buffer and the expert MLPs run as batched products over
it: with ``cfg.use_pallas`` through the hand-written kernels B7/B8
(``kernels.moe_gmm``), otherwise through the reference's own einsum
branch.  Routing, capacity positions, drops and the gather are the
reference's, op for op.

On a mesh whose "model" axis has more than one rank and divides the
experts, :func:`apply_moe` takes the expert-parallel path
(:func:`_apply_moe_shardmap`, the reference's ``shard_map`` as
``local_map``); the one-device path is its oracle.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ModelConfig
from ..kernels.moe_gmm import moe_gmm, moe_gmm_down
from ..parallel.collectives import psum
from ..parallel.sharding import (P, axis_names, dp_axes, dp_size, mesh_shape,
                                 placements)
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
    """x: (B, S, D) -> (y, aux_loss).  Dispatches to the expert-parallel
    path on a mesh (see :func:`_apply_moe_shardmap`); the one-device
    scatter path below doubles as its correctness oracle."""
    mesh = cfg.mesh
    if (cfg.moe_impl in ("auto", "shardmap")
            and mesh is not None and "model" in axis_names(mesh)
            and mesh_shape(mesh)["model"] > 1
            and cfg.moe.num_experts % mesh_shape(mesh)["model"] == 0):
        return _apply_moe_shardmap(cfg, p, x)
    return _apply_moe_local(cfg, p, x)


def _apply_moe_local(cfg: ModelConfig, p: dict, x: torch.Tensor):
    m = cfg.moe
    B, S, D = x.shape
    N = B * S
    E, K = m.num_experts, m.top_k
    xt = x.reshape(N, D)
    probs, onehot, gate_vals, e_flat, pos_flat, C = route(cfg, p, xt)

    # Scatter tokens into the (E, C + 1, D) buffer; slot C takes the drops
    # (``new_zeros``: a DTensor in a mesh program, whose scatter DTensor
    # then places).
    buf = xt.new_zeros((E, C + 1, D))
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


# ---------------------------------------------------------------------------
# expert-parallel path (a mesh)
# ---------------------------------------------------------------------------
#
# On the (data, model) mesh, boundary activations are replicated over the
# "model" axis while experts are sharded over it.  Each rank therefore
# already holds every token it could need: it routes locally, runs *its*
# E/tp experts on the tokens assigned to them, and one sum over "model"
# adds the partial expert outputs (the same collective pattern as TP-FFN).

def _moe_specs(m) -> dict:
    specs = {
        "router": P(),
        "w1": P("model", None, None),
        "w3": P("model", None, None),
        "w2": P("model", None, None),
    }
    if m.num_shared_experts:
        specs["shared_w1"] = P(None, "model")
        specs["shared_w3"] = P(None, "model")
        specs["shared_w2"] = P("model", None)
    return specs


def _apply_moe_shardmap(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """The reference's ``_apply_moe_shardmap``: ``x`` and every leaf of
    ``p`` are DTensors on ``cfg.mesh`` (redistributed to the specs below
    where they are placed otherwise); returns ``y`` sharded as ``x`` and a
    replicated ``aux``.

    Gradients: ``y``'s sum over "model" passes its cotangent back
    unchanged, so the ranks' gradients of what is replicated over "model"
    (``x``, the router) are partial sums over it, and over the data axes
    for the weights where ``x`` is sharded there.  ``aux`` is computed alike
    on every "model" rank, so its cotangent is spread over them (1 / tp).
    """
    m = cfg.moe
    mesh = cfg.mesh
    sizes = mesh_shape(mesh)
    names = axis_names(mesh)
    tp = sizes["model"]
    dp = dp_axes(mesh)
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    E_loc = E // tp
    sharded_b = bool(dp) and B % dp_size(mesh) == 0

    x_spec = P(dp, None, None) if sharded_b else P(None, None, None)
    p_specs = _moe_specs(m)
    keys = sorted(p_specs)
    for name, t in [("x", x)] + [(k, p[k]) for k in keys]:
        if not isinstance(t, DTensor):
            raise TypeError(f"the expert-parallel MoE path takes DTensors; "
                            f"{name} is a {type(t).__name__}")

    def grad_placements(spec):
        # a Replicate input's gradient sums over "model", and over the data
        # axes where the tokens are sharded
        return tuple(
            Partial() if pl == Replicate() and (
                axis == "model" or (sharded_b and axis in dp)) else pl
            for axis, pl in zip(names, placements(spec, mesh)))

    j = mesh.get_local_rank("model")
    model_group = [mesh.get_group("model")]
    dp_groups = [mesh.get_group(a) for a in dp] if sharded_b else []
    n_dp = dp_size(mesh) if sharded_b else 1

    def local_moe(x_loc, *leaves):
        p_loc = dict(zip(keys, leaves))
        Bl, Sl, _ = x_loc.shape
        N = Bl * Sl
        xt = x_loc.reshape(N, D)
        # capacity from the local token count, routing over all E experts
        probs, onehot, gate_vals, e_flat, pos_flat, C = route(cfg, p_loc, xt)

        # keep only the experts this model rank owns; slot C drops the rest
        e_lo = j * E_loc
        mine = (e_flat >= e_lo) & (e_flat < e_lo + E_loc)
        e_local = torch.clamp(e_flat - e_lo, 0, E_loc - 1)
        slot = torch.where(mine, pos_flat, C)

        buf = torch.zeros((E_loc, C + 1, D), dtype=x_loc.dtype,
                          device=x_loc.device)
        src = xt.repeat_interleave(K, dim=0) if K > 1 else xt
        buf[e_local, slot] = src
        out_buf = expert_mlp(cfg, p_loc, buf[:, :C].contiguous())

        gathered = out_buf[e_local, torch.clamp(slot, max=C - 1)]
        gates = (gate_vals * mine.reshape(N, K))[..., None].to(x_loc.dtype)
        y = (gathered.reshape(N, K, D).float() * gates.float()).sum(1) \
            .to(x_loc.dtype)

        if m.num_shared_experts:                # TP-sharded shared experts
            y = y + swiglu_hidden(xt, p_loc["shared_w1"],
                                  p_loc["shared_w3"]) @ p_loc["shared_w2"]
        y = psum(y, model_group)                # sum partial expert outputs

        me = probs.mean(0)
        ce = (onehot.sum(1) > 0).float().mean(0)
        aux = (me * ce).sum() * E * m.aux_loss_coef
        aux = psum(aux, dp_groups, grad_scale=1.0 / tp)
        if n_dp > 1:
            aux = aux / n_dp                    # pmean over the data axes
        return y.reshape(Bl, Sl, D), aux

    fn = local_map(
        local_moe,
        out_placements=(placements(x_spec, mesh), (Replicate(),) * len(names)),
        in_placements=(placements(x_spec, mesh),
                       *(placements(p_specs[k], mesh) for k in keys)),
        in_grad_placements=(grad_placements(x_spec),
                            *(grad_placements(p_specs[k]) for k in keys)),
        device_mesh=mesh, redistribute_inputs=True)
    return fn(x, *(p[k] for k in keys))
