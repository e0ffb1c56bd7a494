"""pixtral-12b [vlm] — pixtral-ViT + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409].

The modality frontend is a STUB per the assignment: ``input_specs``
provides precomputed patch embeddings (B, n_image_patches, d_model)
which replace the first n_image_patches token positions.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=131072,
    n_image_patches=256, rope_theta=1e9,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab_size=256, n_image_patches=4)
