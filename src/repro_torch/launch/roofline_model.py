"""Analytic HBM-traffic model: the port of
``repro/launch/roofline_model.py``, the same closed forms.

The traced ``bytes`` of the dry run count every operand of every
operation, unfused (an upper bound); this closed-form estimate of fused
traffic is the other end, per device:

train  = optimizer(28 B/param/dev) + grad-accum(8 B x M)
         + weights-read (3 passes x bf16 x gathered shard) x M
         + activations (~16 tensors x tokens_loc x d_model x 2 B / layer)
         + logits (3 x tokens_loc x V/tp x 4 B)
prefill= weights-read + activations + KV-cache write
decode = weights-read (gathered shard) + full KV-cache shard read + write

With ``n_dev = dp = tp = 1`` it is one card's traffic, the byte side of
the one-card bounds of ``chip_smoke.py``'s measured phases.
"""

from __future__ import annotations

from ..models import transformer as T
from ..models.config import ModelConfig, ShapeConfig


def estimate_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig, *, n_dev: int,
                       dp: int, tp: int, n_micro: int = 1) -> float:
    P = T.count_params(cfg)
    P_active = T.count_params(cfg, active_only=True)
    B, S = shape.global_batch, shape.seq_len
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    tok_loc = max(1, B // dp) * (S if shape.kind != "decode" else 1)
    tok_micro = tok_loc / max(n_micro, 1)

    # per-device weight bytes touched per full pass (bf16 compute copies,
    # gathered over the FSDP axis -> 1/tp of the total remains sharded)
    w_pass = 2.0 * P_active / tp

    total = 0.0
    if shape.kind == "train":
        p_loc = P / n_dev
        total += 28.0 * p_loc                        # AdamW update r/w f32
        total += 8.0 * p_loc * n_micro               # grad accumulation
        total += 3.0 * w_pass * n_micro              # fwd + remat + bwd
        act = 16.0 * tok_micro * D * 2.0 * L
        total += act * n_micro
        total += 3.0 * tok_micro * (V / tp) * 4.0 * n_micro   # logits f32
    elif shape.kind == "prefill":
        total += w_pass
        total += 8.0 * tok_loc * D * 2.0 * L
        total += _cache_bytes(cfg, shape) / n_dev    # cache write
        total += tok_loc * (V / tp) * 4.0 / max(S, 1)  # last-pos logits
    else:  # decode
        total += w_pass                              # every weight, once
        total += 2.0 * _cache_bytes(cfg, shape) / n_dev / 2  # read + 1-row
        total += max(1, B // dp) * (V / tp) * 4.0
    return total


def _cache_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Global KV/state cache size in bytes for this cell: every tensor of
    the per-layer ``init_cache`` (meta tensors; an encoder-decoder's
    cross k/v in each layer's dict), which the reference holds stacked
    over bodies, the same total."""
    cache = T.init_cache(cfg, shape.global_batch, shape.seq_len,
                         abstract=True)
    return float(sum(t.numel() * t.element_size()
                     for layer in cache for t in layer.values()))
