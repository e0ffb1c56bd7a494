"""mamba2-780m [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060]."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_conv=4, ssm_chunk=256,
    ssm_head_dim=64, ssm_groups=1,
    tie_embeddings=True, use_rope=False,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, vocab_size=256,
                       ssm_state=16, ssm_head_dim=32, ssm_chunk=8)
