"""qwen3-moe-30b-a3b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab_size=151936,
    n_experts=128, top_k=8, moe_d_ff=768,
    rope_theta=1e6,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=32, moe_d_ff=32, vocab_size=256,
                       n_experts=8, top_k=2, capacity_factor=8.0)
