"""AdamW with float32 master weights, global-norm clipping, cosine schedule.

PyTorch counterpart of ``repro.train.optim``.  The optimizer state is a
plain tree mirroring the parameters.  Leaves are walked in the reference's
tree order (dict keys sorted, as JAX flattens them), every update runs in
float32, and the new parameters are cast back to each leaf's dtype.
Scalars are divided as tensors on the leaves' device (a division by a
Python float is a reciprocal multiply on the card).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..configs.base import TrainConfig
from .._tree import tree_flatten, tree_map  # noqa: F401  (tree_flatten re-exported)


class OptState(NamedTuple):
    mu: dict
    nu: dict
    master: dict | None   # float32 master copy (None if disabled)
    count: torch.Tensor   # 0-dim int32: updates taken


def init_opt_state(params, tcfg: TrainConfig) -> OptState:
    zeros = lambda: tree_map(  # noqa: E731
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
    master = (tree_map(lambda p: p.detach().float().clone(), params)
              if tcfg.master_weights else None)
    device = next(iter(tree_flatten(params)[0])).device
    return OptState(mu=zeros(), nu=zeros(), master=master,
                    count=torch.zeros((), dtype=torch.int32, device=device))


def lr_schedule(tcfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to 0.1x, in float32."""
    dev = step.device
    f = lambda v: torch.full((), v, dtype=torch.float32, device=dev)  # noqa: E731
    step = step.float()
    warm = torch.clamp(step / f(max(tcfg.warmup_steps, 1)), max=1.0)
    prog = torch.clamp((step - f(tcfg.warmup_steps))
                       / f(max(tcfg.total_steps - tcfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = f(0.5) * (f(1.0) + torch.cos(f(math.pi) * prog))
    return f(tcfg.learning_rate) * warm * (f(0.1) + f(0.9) * cos)


def global_norm(tree) -> torch.Tensor:
    leaves = [x.float().square().sum() for x in tree_flatten(tree)[0]]
    return torch.sqrt(torch.stack(leaves).sum())


@torch.no_grad()
def adamw_update(grads, params, opt: OptState, tcfg: TrainConfig,
                 gnorm: torch.Tensor | None = None):
    """One AdamW step.  Returns (new_params, new_opt, metrics).  Every leaf
    is updated elementwise, so the leaves may be matching shards; ``gnorm``
    is then the norm of the whole gradient (``global_norm(grads)`` when
    ``None``)."""
    gnorm = global_norm(grads) if gnorm is None else gnorm
    dev = gnorm.device
    f = lambda v: torch.full((), v, dtype=torch.float32, device=dev)  # noqa: E731
    scale = (torch.clamp(f(tcfg.grad_clip) / (gnorm + f(1e-9)), max=1.0)
             if tcfg.grad_clip else f(1.0))
    count = opt.count + 1
    lr = lr_schedule(tcfg, count)
    b1, b2 = tcfg.beta1, tcfg.beta2
    bc1 = f(1.0) - torch.pow(f(b1), count.float())
    bc2 = f(1.0) - torch.pow(f(b2), count.float())

    def leaf(g, p, m, v, w):
        g = g.float() * scale
        m = f(b1) * m + f(1 - b1) * g
        v = f(b2) * v + f(1 - b2) * g * g
        upd = (m / bc1) / (torch.sqrt(v / bc2) + f(1e-8))
        base = w if w is not None else p.float()
        return m, v, base - lr * (upd + f(tcfg.weight_decay) * base)

    flat_g, rebuild = tree_flatten(grads)
    flat_p = tree_flatten(params)[0]
    flat_m = tree_flatten(opt.mu)[0]
    flat_v = tree_flatten(opt.nu)[0]
    flat_w = (tree_flatten(opt.master)[0] if opt.master is not None
              else [None] * len(flat_p))
    new_m, new_v, new_w = [], [], []
    for g, p, m, v, w in zip(flat_g, flat_p, flat_m, flat_v, flat_w):
        m2, v2, w2 = leaf(g, p, m, v, w)
        new_m.append(m2)
        new_v.append(v2)
        new_w.append(w2)

    new_params = rebuild([w.to(p.dtype) for w, p in zip(new_w, flat_p)])
    new_opt = OptState(mu=rebuild(new_m), nu=rebuild(new_v),
                       master=rebuild(new_w) if opt.master is not None else None,
                       count=count)
    return new_params, new_opt, {"grad_norm": gnorm, "lr": lr}
