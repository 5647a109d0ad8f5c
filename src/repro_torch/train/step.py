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

On a mesh, ``build_train_step(grad_shardings=...)`` (the optimizer's
shardings, as the reference's cells pass them) keeps each float32
accumulator and each optimizer moment as its shard only.  With a mesh-free
model (``cfg.mesh`` unset) each rank takes the gradients of its shard of
the batch with whole parameters, and each microbatch's are
reduce-scattered into the accumulators (ZeRO-2); the norm and AdamW run on
the shards, and the new parameters come back replicated.  With the model
itself on a mesh of more than one rank (``cfg.mesh``, as the launch cells
build it) the step is one DTensor program, the counterpart of the
reference's GSPMD step: parameters, batch and state are DTensors of their
shardings, and DTensor places the collectives; on a mesh of one rank it is
the plain step.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.checkpoint import checkpoint

from ..configs.base import TrainConfig
from ..models import lm
from ..models.api import Model
from ..models.layers import take_along_vocab
from ..models.param import tree_leaves, tree_map
from ..parallel.collectives import (full_tensor, gather_shards, mesh_groups,
                                    reduce_shards)
from ..parallel.sharding import (NamedSharding, P, local_shape, local_slices,
                                 opt_shardings, param_shardings, redistribute)
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
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    return (lse - take_along_vocab(logits, labels)).mean()


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
            if isinstance(loss, DTensor):    # a mesh program: sum the partials
                loss, metrics = _replicated(loss), {
                    k: _replicated(v) for k, v in metrics.items()}
            wrt = [p for p in leaves if p.requires_grad]
            got = torch.autograd.grad(loss, wrt, allow_unused=True)
        by_id = {id(p): g for p, g in zip(wrt, got) if g is not None}
        grads = tree_map(lambda p: by_id[id(p)] if id(p) in by_id
                         else torch.zeros_like(p), live)
        return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
                grads)

    return grad_fn


def _replicated(t):
    """A DTensor reduced to the same value on every rank (its partial sums
    summed); anything else as it is."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def build_train_step(model: Model, tcfg: TrainConfig, grad_shardings=None):
    """The training step: ``train_step(state, batch) -> (state, metrics)``.

    With ``tcfg.grad_accum`` = G > 1 the batch is split into G microbatches
    along its first axis; each one's gradients are cast to float32 and
    divided by G before they are summed, and the loss is the sum of the
    microbatch losses over G.  Metrics: ``loss``, ``ce``, ``aux`` (means
    over microbatches), ``grad_norm`` and ``lr``.
    """
    grad_fn = value_and_grad(make_loss_fn(model))
    G = tcfg.grad_accum
    mesh = model.cfg.mesh
    if grad_shardings is not None and mesh is not None:
        if mesh.size() > 1:
            return _mesh_train_step(grad_fn, tcfg, grad_shardings)
        grad_shardings = None    # one rank: every shard is the whole tensor
    if grad_shardings is not None:
        return _sharded_train_step(grad_fn, tcfg, grad_shardings)

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


# ---------------------------------------------------------------------------
# sharded accumulators (a mesh)
# ---------------------------------------------------------------------------

def train_state_shardings(model: Model, mesh, tcfg: TrainConfig) -> TrainState:
    """A ``TrainState`` of shardings, as the reference's cells build it:
    ``param_shardings`` for the parameters, ``opt_shardings`` (ZeRO-1 per
    ``tcfg.zero1``) for the moments and the master copy, the count
    replicated.  Its ``opt.mu`` is the step's ``grad_shardings``."""
    oshard = opt_shardings(model.structure(), mesh, zero1=tcfg.zero1)
    return TrainState(
        params=param_shardings(model.structure(), mesh),
        opt=optim.OptState(mu=oshard, nu=oshard,
                           master=oshard if tcfg.master_weights else None,
                           count=NamedSharding(mesh, P())))


def _sharded_train_step(grad_fn, tcfg: TrainConfig, grad_shardings):
    """The step with ``grad_shardings``' accumulators (see the module's
    docstring).  ``state.params`` are whole tensors on every rank (a
    DTensor leaf is gathered first); ``state.opt``'s trees are DTensors of
    ``grad_shardings`` (``parallel.sharding.shard_tree``); the batch's
    leaves are DTensors whose batch dim is sharded over some mesh dims
    (``batch_shardings``), or whole tensors on a mesh of one rank.  The
    loss of the whole batch is the mean of the ranks' losses over the mesh
    dims the batch is split on, and so is each gradient."""
    G = tcfg.grad_accum
    flat_shd, _ = optim.tree_flatten(grad_shardings)
    mesh = flat_shd[0].mesh
    groups = [group for _, _, group in mesh_groups(mesh)]

    def local_batch(batch):
        dims = None
        out = {}
        for k, v in batch.items():
            if isinstance(v, DTensor):
                here = {i for i, pl in enumerate(v.placements)
                        if pl == Shard(0) and mesh.shape[i] > 1}
                v = v.to_local()
            elif mesh.size() == 1:
                here = set()
            else:
                raise TypeError(f"batch[{k!r}] is a {type(v).__name__} on a "
                                f"mesh of {mesh.size()} ranks; pass DTensors "
                                "(batch_shardings)")
            if dims is not None and here != dims:
                raise ValueError("the batch's leaves are split over "
                                 "different mesh dims")
            dims = here
            out[k] = v
        return out, dims

    def mean_over(x: torch.Tensor, batch_dims, n_b: int) -> torch.Tensor:
        x = x.clone()
        for i, _, group in mesh_groups(mesh):
            if i in batch_dims:
                dist.all_reduce(x, group=group)
        return x / n_b if n_b > 1 else x

    def train_step(state: TrainState, batch: dict):
        params = tree_map(lambda p: full_tensor(p)
                          if isinstance(p, DTensor) else p, state.params)
        flat_p, rebuild = optim.tree_flatten(params)
        batch, batch_dims = local_batch(batch)
        n_b = 1
        for i in batch_dims:
            n_b *= mesh.shape[i]
        micro = {k: v.reshape(G, v.shape[0] // G, *v.shape[1:])
                 for k, v in batch.items()}
        acc = [torch.zeros(local_shape(tuple(p.shape), s), dtype=torch.float32,
                           device=p.device)
               for p, s in zip(flat_p, flat_shd)]
        loss, per_step = None, []
        for i in range(G):
            (l_i, m_i), g_i = grad_fn(params, {k: v[i] for k, v in micro.items()})
            l_i = mean_over(l_i, batch_dims, n_b)
            loss = l_i / G if loss is None else loss + l_i / G
            per_step.append({k: mean_over(v, batch_dims, n_b)
                             for k, v in m_i.items()})
            for a, g, s in zip(acc, optim.tree_flatten(g_i)[0], flat_shd):
                g = reduce_shards(g.float() / G, s.placements, mesh, batch_dims)
                a.add_(g / n_b if n_b > 1 else g)
            del g_i
        metrics = {k: torch.stack([m[k] for m in per_step]).mean()
                   for k in per_step[0]}

        # the norm of the whole gradient: each shard's squares once (a
        # shard held by r ranks counts 1 / r on each), summed over the mesh
        sq = []
        for a, s in zip(acc, flat_shd):
            rep = 1
            for i, pl in enumerate(s.placements):
                if not isinstance(pl, Shard):
                    rep *= mesh.shape[i]
            sq.append(a.square().sum() / rep if rep > 1 else a.square().sum())
        total = torch.stack(sq).sum()
        for group in groups:
            dist.all_reduce(total, group=group)
        gnorm = torch.sqrt(total)

        def local(tree):
            return [t.to_local() for t in optim.tree_flatten(tree)[0]]

        local_p = [p[local_slices(tuple(p.shape), s)]
                   for p, s in zip(flat_p, flat_shd)]
        opt = state.opt
        shard_opt = optim.OptState(
            mu=rebuild(local(opt.mu)), nu=rebuild(local(opt.nu)),
            master=rebuild(local(opt.master)) if opt.master is not None
            else None, count=opt.count)
        new_p, new_opt, opt_metrics = optim.adamw_update(
            rebuild(acc), rebuild(local_p), shard_opt, tcfg, gnorm=gnorm)
        new_params = rebuild([
            gather_shards(t, s.placements, mesh)
            for t, s in zip(optim.tree_flatten(new_p)[0], flat_shd)])

        def as_dtensors(tree):
            return rebuild([
                DTensor.from_local(t, s.mesh, s.placements, run_check=False)
                for t, s in zip(optim.tree_flatten(tree)[0], flat_shd)])

        new_opt = optim.OptState(
            mu=as_dtensors(new_opt.mu), nu=as_dtensors(new_opt.nu),
            master=as_dtensors(new_opt.master)
            if new_opt.master is not None else None, count=new_opt.count)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return TrainState(new_params, new_opt), metrics

    return train_step


def _mesh_train_step(grad_fn, tcfg: TrainConfig, grad_shardings):
    """The step as one DTensor program (see the module's docstring).
    ``state``'s leaves are DTensors of the cell's shardings (parameters by
    ``param_shardings``, the optimizer's trees by ``grad_shardings``) and
    the batch's are DTensors of ``batch_shardings``.  Microbatch ``i`` is
    the ``i``-th of ``G`` equal slices of every rank's rows (the same rows
    in all, in another grouping than the one-device step's, whose sum is
    the same); each microbatch's gradients, float32 over ``G``, are
    redistributed into the accumulators' shardings (a reduce-scatter where
    a gradient's partial sums meet a sharded accumulator).  AdamW runs on
    the shards; the new parameters are redistributed back to their own
    shardings."""
    G = tcfg.grad_accum
    flat_shd, _ = optim.tree_flatten(grad_shardings)

    def micro(v: DTensor, i: int) -> DTensor:
        if G == 1:
            return v
        loc = v.to_local()
        loc = loc.reshape(G, loc.shape[0] // G, *loc.shape[1:])[i]
        return DTensor.from_local(loc, v.device_mesh, v.placements,
                                  run_check=False)

    def train_step(state: TrainState, batch: dict):
        for k, v in batch.items():
            if not isinstance(v, DTensor):
                raise TypeError(f"batch[{k!r}] is a {type(v).__name__} on a "
                                "mesh; pass DTensors (batch_shardings)")
        with implicit_replication():
            flat_p, rebuild = optim.tree_flatten(state.params)
            loss, acc, per_step = None, None, []
            for i in range(G):
                (l_i, m_i), g_i = grad_fn(
                    state.params, {k: micro(v, i) for k, v in batch.items()})
                loss = l_i / G if loss is None else loss + l_i / G
                per_step.append(m_i)
                g = [redistribute(g.float() / G, s) for g, s in
                     zip(optim.tree_flatten(g_i)[0], flat_shd)]
                acc = g if acc is None else [a + b for a, b in zip(acc, g)]
                del g_i
            metrics = {k: torch.stack([m[k] for m in per_step]).mean()
                       for k in per_step[0]}
            total = None
            for a in acc:
                sq = a.square().sum()
                total = sq if total is None else total + sq
            gnorm = torch.sqrt(_replicated(total))
            new_p, new_opt, opt_metrics = optim.adamw_update(
                rebuild(acc), state.params, state.opt, tcfg, gnorm=gnorm)
            new_params = rebuild([
                t.redistribute(p.device_mesh, p.placements)
                for t, p in zip(optim.tree_flatten(new_p)[0], flat_p)])
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return TrainState(new_params, new_opt), metrics

    return train_step


def _mesh_program(model: Model):
    """DTensor's treatment of plain tensors inside a mesh program (the
    model's own constants, positions and masks: replicated), off a mesh
    nothing."""
    mesh = model.cfg.mesh
    if mesh is not None and mesh.size() > 1:
        return implicit_replication()
    return contextlib.nullcontext()


def build_prefill_step(model: Model):
    def prefill_step(params, batch, cache):
        with _mesh_program(model):
            return model.prefill(params, batch, cache)
    return prefill_step


def build_decode_step(model: Model):
    def decode_step(params, token, cache, index):
        with _mesh_program(model):
            return model.decode_step(params, token, cache, index)
    return decode_step
