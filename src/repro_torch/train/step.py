"""Training and serving step functions.

PyTorch counterpart of ``repro.train.step``.  ``build_train_step`` returns
a function (state, batch) -> (state, metrics): the loss and its gradients
by autograd, with ``grad_accum`` microbatches accumulated in float32 as
``g / G``, then the AdamW update.  The forward runs the model's training
route: ``cfg.remat`` recomputes each layer unit in the backward pass, and
attention takes the plain route unless ``cfg.use_pallas`` asks for the
flash-attention kernel B4, which has no backward (as in the reference) and
raises under autograd.  ``build_prefill_step`` / ``build_decode_step`` wrap
the serving paths.  The vision frontend's patch positions are cut from the
logits (or the hidden states) before the loss, as in the reference.
Sharded gradient accumulators (``grad_shardings``) are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import TrainConfig
from ..models import lm
from ..models.api import Model
from ..models.param import tree_leaves, tree_map
from . import optim


class TrainState(NamedTuple):
    params: dict
    opt: optim.OptState


def init_train_state(model: Model, tcfg: TrainConfig,
                     generator: torch.Generator) -> TrainState:
    """Parameters drawn from ``generator`` (a seeded ``torch.Generator`` on
    the model's device) and a fresh optimizer state."""
    params = model.init(generator)
    return TrainState(params=params, opt=optim.init_opt_state(params, tcfg))


def cross_entropy(logits, labels):
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def fused_cross_entropy(x, head, labels, *, vocab_size: int,
                        chunk: int = 16384):
    """Chunked-vocab CE: never materialises the full (B, S, V) logits.

    Walks vocab chunks of the head matrix, keeping an online (max, sumexp)
    and the gold logit.  Under autograd each chunk is recomputed in the
    backward pass instead of saving its logits, as the reference's
    ``jax.checkpoint`` of the chunk body does.  Rows beyond ``vocab_size``
    (padding for TP divisibility) are masked out of the partition function.
    """
    B, S, D = x.shape
    V = head.shape[0]
    nc = -(-V // chunk)
    pad = nc * chunk - V
    if pad:
        head = torch.nn.functional.pad(head, (0, 0, 0, pad))
    dev = x.device
    labels = labels.long()
    offs = torch.arange(chunk, device=dev)

    def body(m, l, gold, hc, c0):
        logits = torch.einsum("bsd,vd->bsv", x, hc).float()
        logits = torch.where((c0 + offs)[None, None, :] < vocab_size, logits,
                             -1e30)
        m_new = torch.maximum(m, logits.amax(-1))
        l = l * torch.exp(m - m_new) + torch.exp(
            logits - m_new[..., None]).sum(-1)
        in_chunk = (labels >= c0) & (labels < c0 + chunk)
        local = torch.clamp(labels - c0, 0, chunk - 1)
        val = logits.gather(-1, local[..., None])[..., 0]
        return m_new, l, torch.where(in_chunk, val, gold)

    grad = torch.is_grad_enabled() and (x.requires_grad or head.requires_grad)
    m = torch.full((B, S), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((B, S), dtype=torch.float32, device=dev)
    gold = torch.zeros((B, S), dtype=torch.float32, device=dev)
    for ci in range(nc):
        args = (m, l, gold, head[ci * chunk:(ci + 1) * chunk], ci * chunk)
        m, l, gold = (checkpoint(body, *args, use_reentrant=False) if grad
                      else body(*args))
    return (m + torch.log(torch.clamp(l, min=1e-30)) - gold).mean()


def make_loss_fn(model: Model):
    cfg = model.cfg
    # the vision frontend's patches lead the sequence and have no labels
    skip = cfg.frontend_len if cfg.frontend == "vision" else 0

    def loss_fn(params, batch):
        if cfg.fused_ce and not cfg.encdec:
            x, aux = lm.forward_hidden(cfg, params, batch["tokens"],
                                       batch.get("prefix_embeds"), train=True)
            loss = fused_cross_entropy(x[:, skip:],
                                       lm.lm_head_weights(cfg, params),
                                       batch["labels"],
                                       vocab_size=cfg.vocab_size,
                                       chunk=cfg.ce_chunk)
        else:
            logits, aux = model.forward(params, batch, train=True)
            loss = cross_entropy(logits[:, skip:], batch["labels"])
        aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
        return loss + aux, {"ce": loss, "aux": aux}

    return loss_fn


def value_and_grad(loss_fn):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` by autograd: returns a
    function (params, batch) -> ((loss, metrics), grads), the gradients a
    tree like ``params`` in each leaf's dtype (zeros for a leaf the loss
    does not reach), everything detached."""

    def grad_fn(params, batch):
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(
                p.is_floating_point()), params)
            leaves = tree_leaves(live)
            loss, metrics = loss_fn(live, batch)
            wrt = [p for p in leaves if p.requires_grad]
            got = torch.autograd.grad(loss, wrt, allow_unused=True)
        by_id = {id(p): g for p, g in zip(wrt, got) if g is not None}
        grads = tree_map(lambda p: by_id[id(p)] if id(p) in by_id
                         else torch.zeros_like(p), live)
        return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
                grads)

    return grad_fn


def build_train_step(model: Model, tcfg: TrainConfig, grad_shardings=None):
    """The training step: ``train_step(state, batch) -> (state, metrics)``.

    With ``tcfg.grad_accum`` = G > 1 the batch is split into G microbatches
    along its first axis; each one's gradients are cast to float32 and
    divided by G before they are summed, and the loss is the sum of the
    microbatch losses over G.  Metrics: ``loss``, ``ce``, ``aux`` (means
    over microbatches), ``grad_norm`` and ``lr``.
    """
    if grad_shardings is not None:
        raise NotImplementedError("sharded gradient accumulators are not "
                                  "ported yet (ROADMAP A.9c)")
    grad_fn = value_and_grad(make_loss_fn(model))
    G = tcfg.grad_accum

    def train_step(state: TrainState, batch: dict):
        params = state.params
        if G == 1:
            (loss, metrics), grads = grad_fn(params, batch)
        else:
            micro = {k: v.reshape(G, v.shape[0] // G, *v.shape[1:])
                     for k, v in batch.items()}
            loss = None
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            flat_acc = tree_leaves(grads)
            per_step = []
            for i in range(G):
                (l_i, m_i), g_i = grad_fn(params,
                                          {k: v[i] for k, v in micro.items()})
                loss = l_i / G if loss is None else loss + l_i / G
                for acc, g in zip(flat_acc, tree_leaves(g_i)):
                    acc.add_(g.float() / G)
                per_step.append(m_i)
            metrics = {k: torch.stack([m[k] for m in per_step]).mean()
                       for k in per_step[0]}
        new_params, new_opt, opt_metrics = optim.adamw_update(
            grads, params, state.opt, tcfg)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return TrainState(new_params, new_opt), metrics

    return train_step


def build_prefill_step(model: Model):
    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)
    return prefill_step


def build_decode_step(model: Model):
    def decode_step(params, token, cache, index):
        return model.decode_step(params, token, cache, index)
    return decode_step
