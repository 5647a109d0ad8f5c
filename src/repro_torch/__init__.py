"""SpotVista in PyTorch for one NVIDIA H100: the port of ``repro``.

The package mirrors ``repro``'s layout and public names.  It imports torch
and numpy, never jax and nothing of ``repro``.  The serving main path —
``serve.BatchServer`` -> ``core.RecommendationEngine.recommend_batch`` —
runs on the card through two hand-written CUDA kernels,
``kernels.score_fuse`` (Eq. 2-4) and ``kernels.pool_scan`` (Algorithm 1),
built from ``csrc/`` on first use.  Live ingestion (``stream``) updates
the statistics through ``kernels.stats_update``, and LM serving
(``models``: prefill and decode) runs DeepSeek-V2-Lite's MoE expert MLPs
through ``kernels.moe_gmm``, RWKV6's WKV6 scan through
``kernels.rwkv6_scan`` and RecurrentGemma's RG-LRU scan through
``kernels.rglru_scan``.  The full-sequence forward (``Model.forward``)
runs its attention through ``kernels.flash_attention`` under
``use_pallas``, and ``train`` trains on the plain route
(``python -m repro_torch.launch.train``, batches from ``data``).  Entry
points run on CUDA unless the caller passes ``device="cpu"``, which takes
the kernels' plain PyTorch versions.
"""
