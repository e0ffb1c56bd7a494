"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e
top-2 every other layer [arXiv:2403.19887].

Layer pattern period 8: attention at index 4, SSD (Mamba) elsewhere;
MoE replaces the MLP on odd layer indices.  Jamba's Mamba-1 recurrence
is instantiated with the SSD block (d_state=16), as in the reference.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    n_experts=16, top_k=2, moe_d_ff=14336, moe_period=2,
    hybrid_period=8, hybrid_attn_index=4,
    ssm_state=16, ssm_expand=2, ssm_conv=4, ssm_chunk=256, ssm_head_dim=64,
    use_rope=False,               # jamba uses no positional encoding
)

SMOKE = CONFIG.replace(n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, moe_d_ff=128, vocab_size=256,
                       n_experts=4, top_k=2, capacity_factor=8.0, ssm_state=8, ssm_head_dim=32,
                       ssm_chunk=8)
