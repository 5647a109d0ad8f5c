"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``) with their plain
PyTorch versions beside them.

- score_fuse : masked Eq. 2-4 scoring for a request batch (kernel B1,
               replaces ``repro.kernels.score_fuse._score_fuse_kernel``)
- pool_scan  : Algorithm 1 all-prefix termination scan for a request batch
               (kernel B2, replaces ``repro.kernels.pool_scan._pool_scan_kernel``)
- stats_update : the live-ingest rank-1 update of the Eq. 3 statistics
               (kernel B3, replaces ``repro.kernels.stats_update._stats_update_kernel``)
- moe_gmm    : MoE grouped expert matmuls over (E, C, D) capacity buffers
               (kernels B7 and B8, replace ``repro.kernels.moe_gmm``'s
               ``_gmm_up_kernel`` and ``_gmm_down_kernel``)
- rwkv6_scan : the chunked WKV6 scan of RWKV6's prefill (kernel B5,
               replaces ``repro.kernels.rwkv6_scan._wkv_kernel``)
- rglru_scan : the chunked RG-LRU recurrence of RecurrentGemma's prefill
               (kernel B6, replaces ``repro.kernels.rglru_scan._rglru_kernel``)
- flash_attention : causal GQA attention of the full-sequence forward
               (kernel B4, replaces
               ``repro.kernels.flash_attention._flash_kernel``)

CPU tensors take the plain version, CUDA tensors the kernel; ``_build``
compiles ``csrc/*.cu`` with nvcc on first use.
"""
