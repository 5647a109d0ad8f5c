"""Qwen2-0.5B [arXiv:2407.10671; hf] — dense, GQA kv=2, QKV bias."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-0.5b", family="dense",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151936,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
    # 14 heads stay replicated at TP=16; chunk attention scores.
    attn_chunk=512,
)
