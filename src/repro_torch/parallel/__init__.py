"""Archive storage tiers (``compression``) and the device mesh
(``sharding``).

The port's mesh model, the counterpart of the reference's JAX sharding:

- A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
  ``mesh_dim_names`` are the reference's axis names, ``("data", "model")``
  or ``("pod", "data", "model")`` (``repro_torch.launch.mesh``).
- A spec is the port's own :class:`~.sharding.PartitionSpec`, a tuple of
  ``None | str | tuple[str, ...]`` canonicalised as JAX's is, so the rules
  of ``sharding`` read line for line as the reference's.
- :func:`~.sharding.placements` turns a spec into DTensor placements:
  ``Shard(i)`` on each mesh dim that tensor dim ``i`` names, ``Replicate()``
  elsewhere; a dim over ``("pod", "data")`` is split pod-major, as in JAX.
  :class:`~.sharding.NamedSharding` (``.mesh``, ``.spec``,
  ``.placements``) is the leaf of every ``*_shardings`` tree.
- ``with_sharding_constraint`` is ``DTensor.redistribute``; ``shard_map``
  is ``torch.distributed.tensor.experimental.local_map``; ``psum`` /
  ``psum_scatter`` are collectives over the mesh dim's process group, on
  the tensors' own device; ``jax.lax.axis_index(name)`` is
  ``mesh.get_local_rank(name)``.
- On a mesh of one rank every mesh path is the identity or the plain
  path, as the reference's early returns are.  On a larger mesh a mesh
  program's activations are DTensors: a plain tensor where one is
  constrained raises ``TypeError``.
"""
from .sharding import (NamedSharding, PartitionSpec, batch_pspec,  # noqa: F401
                       batch_shardings, cache_shardings, constrain_activation,
                       dp_axes, dp_size, opt_pspec, opt_shardings,
                       param_pspec, param_shardings, placements)
