"""gemma2-9b [dense] — local+global alternating attention, logit softcap
[arXiv:2408.00118]."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
    d_ff=14336, vocab_size=256000,
    local_global_period=2, sliding_window=4096,
    attn_softcap=50.0, logit_softcap=30.0,
    tie_embeddings=True, embed_scale=True, act="gelu",
)

SMOKE = CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab_size=256, sliding_window=8)
