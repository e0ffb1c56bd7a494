"""whisper-small [audio] — enc-dec, conv frontend (STUB)
[arXiv:2212.04356].

The conv/mel frontend is a STUB per the assignment: ``input_specs``
provides precomputed frame embeddings (B, n_frames, d_model) consumed
by the encoder; shapes' seq_len applies to the decoder.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865,
    is_encoder_decoder=True, n_encoder_layers=12, n_frames=1500,
    use_rope=False, sinusoidal_pos=True, act="gelu",
)

SMOKE = CONFIG.replace(n_layers=2, n_encoder_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
                       n_frames=16)
