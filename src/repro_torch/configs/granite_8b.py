"""granite-8b [dense] — llama-arch, code [arXiv:2405.04324]."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=49152,
    rope_theta=1e4,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab_size=256)
