"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``) with their plain
PyTorch versions beside them.

- score_fuse : masked Eq. 2-4 scoring for a request batch (kernel B1,
               replaces ``repro.kernels.score_fuse._score_fuse_kernel``)
- pool_scan  : Algorithm 1 all-prefix termination scan for a request batch
               (kernel B2, replaces ``repro.kernels.pool_scan._pool_scan_kernel``)

CPU tensors take the plain version, CUDA tensors the kernel; ``_build``
compiles ``csrc/*.cu`` with nvcc on first use.
"""
