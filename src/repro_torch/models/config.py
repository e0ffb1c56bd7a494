"""Model configuration for every assigned architecture family.

The port's own copy of ``repro/models/config.py`` (pure Python, so it
is carried over unchanged: the same fields, defaults, derived
properties and shapes).  ``param_count`` counts through the port's
``transformer.count_params``, which covers the dense family so far."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # dense | moe | hybrid | vlm | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    head_dim: int = 0                # 0 => d_model // n_heads

    # attention options
    rope_theta: float = 10_000.0
    use_rope: bool = True
    sinusoidal_pos: bool = False     # whisper: absolute positions
    qkv_bias: bool = False
    attn_softcap: float = 0.0        # gemma2: 50.0
    logit_softcap: float = 0.0       # gemma2: 30.0
    sliding_window: int = 0          # 0 = full attention
    local_global_period: int = 0     # gemma2: 2 (alternating local/global)
    embed_scale: bool = False        # gemma2: x * sqrt(d_model)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_period: int = 1              # jamba: 2 (every other layer)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # "sharded_buf": scatter directly into the expert-sharded capacity
    # buffer (baseline; XLA may materialize cross-shard all-reduces).
    # "replicated_buf": scatter locally (buffer replicated over 'model'),
    # experts read their slice via the weight sharding — the §Perf
    # optimization for EP-heavy MoE (see EXPERIMENTS.md §Perf cell C).
    moe_variant: str = "sharded_buf"

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_head_dim: int = 64
    ssm_groups: int = 1

    # hybrid (jamba): layer kinds repeat with this period
    hybrid_period: int = 0           # jamba: 8
    hybrid_attn_index: int = 4       # position of the attention layer

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_frames: int = 1500             # stub frame-embedding frontend

    # VLM (pixtral): stub patch embeddings for the first n positions
    n_image_patches: int = 0

    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"

    # ------------------------------------------------------------- derived
    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows: vocab rounded up to a 128 multiple so the
        vocab dim shards over any power-of-two TP extent (granite-moe's
        49155, whisper's 51865, mamba2's 50280 are not 16-divisible).
        Logits beyond vocab_size are masked to -inf (transformer._unembed)."""
        return -(-self.vocab_size // 128) * 128

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:        # SSD inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def conv_dim(self) -> int:       # conv runs over [x, B, C]
        return self.d_inner + 2 * self.ssm_groups * self.ssm_state

    @property
    def scan_period(self) -> int:
        """Layers per scan body (stacked bodies = n_layers // period)."""
        if self.hybrid_period:
            return self.hybrid_period
        if self.local_global_period:
            return self.local_global_period
        return 1

    @property
    def n_bodies(self) -> int:
        assert self.n_layers % self.scan_period == 0, \
            f"{self.arch_id}: n_layers {self.n_layers} % period {self.scan_period}"
        return self.n_layers // self.scan_period

    def layer_kind(self, i: int) -> str:
        """'attn' or 'ssm' for absolute layer index i."""
        if self.family == "ssm":
            return "ssm"
        if self.hybrid_period:
            return "attn" if i % self.hybrid_period == self.hybrid_attn_index \
                else "ssm"
        return "attn"

    def layer_window(self, i: int) -> int:
        """Sliding window for layer i (0 = full)."""
        if self.local_global_period:
            # even slots local (sliding window), odd slots global
            return self.sliding_window if i % self.local_global_period == 0 else 0
        return self.sliding_window

    def layer_is_moe(self, i: int) -> bool:
        if not self.n_experts:
            return False
        return i % self.moe_period == (self.moe_period - 1) \
            if self.moe_period > 1 else True

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True when decode cost is sub-quadratic in context (SSM state or
        few-attention-layer hybrid)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # --------------------------------------------------- analytic accounting
    def param_count(self) -> int:
        """Exact parameter count (matches init_params)."""
        from . import transformer  # lazy, avoids cycles
        return transformer.count_params(self)

    def active_param_count(self) -> int:
        from . import transformer
        return transformer.count_params(self, active_only=True)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason).  long_500k needs sub-quadratic decode."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention architecture: 512k-token KV decode is "
                       "quadratic-cost/KV-bound by construction (DESIGN.md "
                       "§Arch-applicability)")
    return True, ""
