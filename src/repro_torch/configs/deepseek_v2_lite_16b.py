"""DeepSeek-V2-Lite [arXiv:2405.04434] — MLA + fine-grained MoE.

Task sheet lists both "MoE 64e top-6" and "160 routed"; the published
V2-Lite config is 64 routed experts top-6 + 2 shared, moe_ff=1408, first
layer dense (dense d_ff=10944), MLA kv_lora=512/rope 64/nope 128/v 128 —
we follow the published config and note the sheet's internal inconsistency.
"""
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=10944, vocab_size=102400,
    mla=MLAConfig(kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128),
    moe=MoEConfig(num_experts=64, num_shared_experts=2, top_k=6, d_ff=1408,
                  first_dense_layers=1),
)
