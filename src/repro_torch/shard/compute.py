"""The sharded batched-recommendation pipeline: per-shard phase-0 carries,
an exact scalar merge, per-shard row emission, and a merge-device pool scan.

PyTorch counterpart of ``repro.shard.compute``.  For B masked requests over
a K-candidate axis split into contiguous shards
(:mod:`repro_torch.shard.archive`), one batch becomes:

  phase 0 (per shard, on its device)
      ``score_fuse_phase0``: the masked min/max of the three Eq. 3
      statistics per unique filter mask and the masked Eq. 2 C_min per
      request (kernel B1's reduction and merge on the card).

  merge (merge device)
      elementwise ``min`` / ``max`` across shards.  Min and max are exact
      and associative, so the merged scalars equal a single-device masked
      reduction over the full axis: the property the layer leans on.

  phase 1 (per shard, on its device)
      ``score_fuse_batch(..., extrema=merged, cost_floor=merged)``: given
      the scalars the emission is elementwise, so each shard's (B, K_shard)
      rows equal the corresponding lanes of a single-device emission bit
      for bit (kernel B1's emit alone on the card).

  pool (merge device)
      the shards' rows are concatenated in bounds order, which restores the
      global candidate axis (O(B K) scalars move; nothing (K, T)-shaped),
      and the single-device engine's pool stage runs on them
      (``core.engine._pool_stage``: the same caps, stable sort, prefix-sum
      call and kernel B2), so pools are bit-identical to the single-device
      path on the same device.

The pool scan is not itself sharded: Algorithm 1's termination reads
prefix sums over the score-descending order, which interleaves shards, and
float addition is not associative, so per-shard sums plus offsets would
change the summation order and the pools.  Every shard's work is queued
before anything is read back, so on several devices the shards overlap.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.engine import _pool_stage
from ..kernels import score_fuse as score_fuse_lib


def sharded_batch_arrays(archive, masks, use_cpus, weights, lams, amounts,
                         uniq_masks, uniq_inv, *, pool_impl: str):
    """Run the sharded scoring and pool pipeline for one request batch.

    ``archive`` is any K-sharded archive (``is_sharded = True``): its
    ``shards`` (each with ``score_stats()`` and its catalog slice on its
    device), ``bounds``, and full-width catalog columns on the merge device
    (``archive.device``).  ``masks`` (B, K), ``use_cpus``, ``weights``,
    ``lams``, ``amounts`` (B,), ``uniq_masks`` (U, K) and ``uniq_inv`` (B,)
    are host arrays.  ``pool_impl`` must be resolved.  Returns host arrays
    ``(comb, avail, cost, order, counts, k_stop, any_term)`` with the
    single-device batch's semantics and, for the pool, its exact bits.
    """
    merge = archive.device

    def on(x, dev, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=dev)

    shard_inputs = []
    for (a, b), shard in zip(archive.bounds, archive.shards):
        dev = shard.device
        shard_inputs.append(dict(
            stats=torch.stack(tuple(shard.score_stats())),
            prices=shard.prices, vcpus=shard.vcpus,
            memory_gb=shard.memory_gb, masks=on(masks[:, a:b], dev),
            use_cpus=on(use_cpus, dev), amount=on(amounts, dev),
            uniq_masks=on(uniq_masks[:, a:b], dev)))
    phase0 = [score_fuse_lib.score_fuse_phase0(**inp) for inp in shard_inputs]
    # exact merge: min / max are associative, so these equal the full-axis
    # masked reductions bit for bit
    ext = [e.to(merge) for e, _ in phase0]
    lo = torch.stack([e[:, 0::2] for e in ext]).amin(0)
    hi = torch.stack([e[:, 1::2] for e in ext]).amax(0)
    extrema = torch.stack([lo, hi], -1).reshape(-1, 6)
    cost_floor = torch.stack([c.to(merge) for _, c in phase0]).amin(0)

    emitted = []
    for inp in shard_inputs:
        dev = inp["stats"].device
        emitted.append(score_fuse_lib.score_fuse_batch(
            **inp, lam=on(lams, dev), weight=on(weights, dev),
            inv=uniq_inv, extrema=extrema.to(dev),
            cost_floor=cost_floor.to(dev)))
    # gather: contiguous bounds, so concatenation restores the global axis
    comb, avail, cost = (torch.cat([getattr(e, name).to(merge)
                                    for e in emitted], dim=1)
                         for name in ("comb", "avail", "cost"))
    order, counts, k_stop, any_term = _pool_stage(
        comb, archive.vcpus, archive.memory_gb, on(masks, merge),
        on(use_cpus, merge), on(amounts, merge), pool_impl=pool_impl)
    return tuple(x.cpu().numpy() for x in
                 (comb, avail, cost, order, counts, k_stop, any_term))
