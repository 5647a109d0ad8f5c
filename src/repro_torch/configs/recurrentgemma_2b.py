"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427] — RG-LRU + local attn 2:1.

26 layers: 8 × (rglru, rglru, attn) + trailing (rglru, rglru); MQA kv=1,
head_dim 256, window 2048, rnn width 2560.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000,
    block_pattern=("rglru", "rglru", "attn"), window=2048, rnn_width=2560,
    # 10 heads / kv=1 don't shard over a 16-way TP axis; keep window-attention
    # score transients bounded with a small KV chunk instead.
    attn_chunk=512,
)
