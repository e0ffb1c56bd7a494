"""starcoder2-3b [dense] — GQA, RoPE [arXiv:2402.19173]."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
    d_ff=12288, vocab_size=49152,
    rope_theta=1e5,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab_size=256)
