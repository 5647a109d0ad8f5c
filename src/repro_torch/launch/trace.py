"""One rank's work, counted as it runs: FLOPs, operand bytes and the
collectives it issues.

The port's counterpart of reading ``cost_analysis()`` and the collective
ops out of a compiled HLO module (``repro.launch.dryrun`` /
``repro.launch.roofline``).  :class:`StepCounter` is a
``TorchDispatchMode``: it lets DTensor desugar first (a DTensor op returns
``NotImplemented`` here), so it sees each rank's local ops and the
collectives they lower to, on real or meta tensors, and never changes what
runs.

- FLOPs: ``torch.utils.flop_counter``'s formulas, decomposing an op they
  do not cover as ``FlopCounterMode`` does, so a one-rank count equals
  ``FlopCounterMode``'s exactly.  Those formulas count products
  (matmuls, convolutions, attention), not elementwise work.
- Bytes: each op's tensor operands and results, views, metadata queries,
  ``empty`` and collectives left out.  Every elementwise pass counts, as
  XLA:CPU's unfused ``bytes accessed`` does: an upper value of the HBM
  traffic, where ``roofline.analytic_memory_floor`` is the floor.
- Collectives: one record a call, its kind in the reference's HLO names
  (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``), the bytes of its output and its group's size,
  from the ``c10d`` ops (``torch.distributed``'s calls, as
  ``parallel.collectives`` makes them) and the ``_c10d_functional`` ops
  (DTensor's redistributions).
- Reads and writes: the storages of every operand an op other than a view
  reads, and the bytes ``copy_`` writes into each, so that
  :meth:`StepCounter.needs` tells the arguments a step needs as inputs
  (XLA drops the others from a jitted module's arguments).
"""
from __future__ import annotations

import contextlib
from collections import Counter
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch._guards import active_fake_mode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten

# the ops FlopCounterMode passes over (metadata queries)
_SKIP = {_aten.sym_is_contiguous.default, _aten.is_contiguous.default,
         _aten.is_contiguous.memory_format,
         _aten.is_strides_like_format.default,
         _aten.is_non_overlapping_and_dense.default, _aten.size.default,
         _aten.sym_size.default, _aten.stride.default,
         _aten.sym_stride.default, _aten.storage_offset.default,
         _aten.sym_storage_offset.default, _aten.numel.default,
         _aten.sym_numel.default, _aten.dim.default,
         torch.ops.prim.layout.default}
# allocations that touch no memory
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_like.default,
               _aten.empty_strided.default, _aten.new_empty.default,
               _aten.new_empty_strided.default}
_COLL_NAMESPACES = ("c10d", "_c10d_functional", "_c10d_functional_autograd",
                    "_dtensor")
# op name fragments -> the reference's HLO kind
_KINDS = (("reduce_scatter", "reduce-scatter"),
          ("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
          ("allgather", "all-gather"), ("all_gather", "all-gather"),
          ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"),
          ("broadcast", "collective-permute"), ("send", "collective-permute"),
          ("recv", "collective-permute"), ("p2p", "collective-permute"))


@dataclass(frozen=True)
class Collective:
    """One collective call: its kind (an HLO name), the bytes of its
    output on this rank, and the number of ranks in its group."""
    kind: str
    bytes: int
    group: int


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _group_size(args, kwargs) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:          # a ReduceOp, not a group
                continue
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (ValueError, RuntimeError, KeyError):
                continue
    return 1


def storage_key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage (shared by its views; meta tensors
    have one too)."""
    return t.untyped_storage()._cdata


def collective_kind(func) -> str | None:
    """The HLO kind of a collective op, ``None`` for any other op (and for
    waits, barriers and autograd wrappers, which move nothing)."""
    if func.namespace not in _COLL_NAMESPACES:
        return None
    name = func.__name__
    for frag, kind in _KINDS:
        if frag in name:
            return kind
    return None


class StepCounter(TorchDispatchMode):
    """Counts one rank's FLOPs, operand bytes and collectives (see the
    module's docstring) for as long as it is entered."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: list[Collective] = []
        self.read: set[int] = set()
        self.written: dict[int, int] = {}

    def needs(self, t: torch.Tensor) -> bool:
        """Whether the step needs ``t``'s storage as an input: it read it,
        or wrote part of it (the rest then stands in the result); a
        storage that was never touched, or overwritten whole, it does
        not."""
        key = storage_key(t)
        written = self.written.get(key, 0)
        return key in self.read \
            or 0 < written < t.untyped_storage().nbytes()

    def summary(self) -> dict:
        """The reference's ``parse_collectives`` record: counts and output
        bytes by kind, and their total."""
        counts: Counter = Counter()
        by_kind: Counter = Counter()
        for c in self.collectives:
            counts[c.kind] += 1
            by_kind[c.kind] += c.bytes
        return {"counts": dict(counts), "bytes": dict(by_kind),
                "total_bytes": sum(by_kind.values())}

    def __enter__(self):
        self._fake_on_entry = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor desugars to local ops
        if active_fake_mode() is not self._fake_on_entry:
            # DTensor's sharding propagation runs ops on fake tensors to
            # learn their outputs' shapes (once per new op and input
            # specs): no rank runs them
            return func(*args, **kwargs)
        if func in _SKIP:
            return NotImplemented
        kind = collective_kind(func)
        if kind is None and func not in flop_registry \
                and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if not func.is_view:
            operands = tree_leaves((args, kwargs))
            if func is _aten.copy_.default:  # the destination is written
                key = storage_key(args[0])
                self.written[key] = self.written.get(key, 0) \
                    + args[0].numel() * args[0].element_size()
                operands = operands[1:]
            self.read.update(storage_key(t) for t in operands
                             if isinstance(t, torch.Tensor))
        if kind is not None:
            # a c10d op that returns no tensor writes its first argument
            nbytes = _tensor_bytes(out) or _tensor_bytes(args[0])
            self.collectives.append(Collective(kind, nbytes,
                                               _group_size(args, kwargs)))
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view and func not in _NO_TRAFFIC \
                and func.namespace == "aten":
            self.bytes += _tensor_bytes(args) + _tensor_bytes(kwargs) \
                + _tensor_bytes(out)
        return out


def rank_mem_tracker():
    """A ``MemTracker`` of the rank's own tensors: it skips the ops that
    DTensor's sharding propagation runs on fake tensors of the global
    shapes (as :class:`StepCounter` does), which no rank allocates.
    torch 2.13's tracker skips them itself; 2.11's counted them, so that
    selecting one unit of DeepSeek-V2-Lite's stacked (26, 128, 32768, 512)
    latent cache added 104 GiB to the ``decode_32k`` cell's peak."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class RankMemTracker(MemTracker):
        def __enter__(self):
            self._rank_fake_mode = active_fake_mode()
            return super().__enter__()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if active_fake_mode() is not self._rank_fake_mode:
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return RankMemTracker()


@contextlib.contextmanager
def card_redistributions():
    """DTensor's shard-to-shard redistribution as the card's program issues
    it: on a CPU mesh DTensor replaces the all-to-all by an all-gather and
    a slice (gloo has no all-to-all); on meta tensors (a dry-run, where
    nothing is sent) this takes the all-to-all, as NCCL on the card
    would.  Real tensors keep the CPU mesh's route."""
    from torch.distributed.tensor import placement_types as pt
    original = pt.shard_dim_alltoall

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        if input.device.type != "meta":
            return original(input, gather_dim, shard_dim, mesh, mesh_dim)
        from torch.distributed import _functional_collectives as funcol
        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, funcol._group_or_group_name(group))

    pt.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = original
