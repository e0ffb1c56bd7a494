"""The yardstick's frozen arithmetic: the card's peaks, parameter counts,
model FLOPs and the attention kernel's operations and bytes.

Everything here is computed from a configuration's ``model`` section (a
plain dict, the fields of ``perfbench/configs/<name>.json``) and from
shapes; nothing is read from the program.

- Model FLOPs of a served token are 2 x the active parameters of its
  matrix products (the embedding is a lookup and counts none; a prefill
  unembeds only each prompt's last position) plus attention: 4 x head dim
  FLOPs per head and per visible (query, key) pair (Q.K^T and P.V).  The
  SSD scan's own arithmetic and the depthwise convolution are not model
  FLOPs here (about 1 % of a Jamba period's).
- An attention call's bytes count q, k, v read once and the output
  written once; its operations count the pairs its mask leaves visible.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np

#: NVIDIA H100 SXM data sheet, dense rates, at the full 700 W limit
PEAKS = {
    "bf16_flop_per_s": 989e12,
    "fp32_flop_per_s": 67e12,
    "hbm_bytes_per_s": 3.35e12,
    "hbm_bytes": 80e9,
}


def head_dim(m: Dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def layer_kind(m: Dict, layer: int) -> str:
    """'attn' or 'ssm': a hybrid's layer pattern repeats with its period."""
    if m["family"] == "ssm":
        return "ssm"
    if m.get("hybrid_period"):
        return ("attn" if layer % m["hybrid_period"] == m["hybrid_attn_index"]
                else "ssm")
    return "attn"


def layer_is_moe(m: Dict, layer: int) -> bool:
    if not m.get("n_experts"):
        return False
    period = m.get("moe_period", 1)
    return layer % period == period - 1 if period > 1 else True


def attention_layers(m: Dict) -> int:
    return sum(layer_kind(m, l) == "attn" for l in range(m["n_layers"]))


def _layer_params(m: Dict, layer: int, active: bool) -> int:
    """Parameters of one layer's matrix products (norms and the SSD
    block's per-head vectors and convolution are counted by
    ``param_count`` alone)."""
    D = m["d_model"]
    if layer_kind(m, layer) == "attn":
        H, KV, hd = m["n_heads"], m["n_kv_heads"], head_dim(m)
        n = D * H * hd + 2 * D * KV * hd + H * hd * D
    else:
        inner = m["ssm_expand"] * D
        GN = m.get("ssm_groups", 1) * m["ssm_state"]
        heads = inner // m["ssm_head_dim"]
        n = D * (2 * inner + 2 * GN + heads) + inner * D
    if m["family"] == "ssm":             # the SSD block is the whole layer
        return n
    if layer_is_moe(m, layer):
        experts = m["top_k"] if active else m["n_experts"]
        n += D * m["n_experts"] + experts * 3 * D * m["moe_d_ff"]
    else:
        n += 3 * D * m["d_ff"]
    return n


def padded_vocab(m: Dict) -> int:
    return -(-m["vocab_size"] // 128) * 128


def param_count(m: Dict, active: bool = False) -> int:
    """Every parameter held (``active``: a MoE layer's routed experts
    counted top_k of n_experts), the embedding tables at their padded
    rows, as the port holds them."""
    D, V = m["d_model"], padded_vocab(m)
    total = V * D * (1 if m.get("tie_embeddings") else 2) + D   # final norm
    for l in range(m["n_layers"]):
        total += _layer_params(m, l, active) + D                 # ln1
        total += D if m["family"] != "ssm" else 0                # ln2
        if layer_kind(m, l) == "ssm":
            inner = m["ssm_expand"] * D
            conv = inner + 2 * m.get("ssm_groups", 1) * m["ssm_state"]
            heads = inner // m["ssm_head_dim"]
            total += conv * m["ssm_conv"] + conv + 3 * heads + inner
    return total


def body_params(m: Dict) -> int:
    """Active parameters of the layers' matrix products: a token's FLOPs
    through the layers are twice this (before attention)."""
    return sum(_layer_params(m, l, True) for l in range(m["n_layers"]))


def unembed_params(m: Dict) -> int:
    return m["d_model"] * m["vocab_size"]


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(q, k) pairs a top-left-aligned causal mask and a sliding window
    leave visible, per batch row and head."""
    q = np.arange(Sq)
    hi = np.minimum(q, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(Sq, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_call(B: int, Sq: int, Sk: int, H: int, KV: int, D: int,
                   causal: bool, window: int, elem_bytes: int = 2):
    """(FLOPs, bytes) of one attention call."""
    flops = 4 * D * B * H * visible_pairs(Sq, Sk, causal, window)
    nbytes = elem_bytes * D * (2 * B * Sq * H + 2 * B * Sk * KV)
    return flops, nbytes


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    at the bf16 peak and the bytes at HBM's rate."""
    return max(flops / PEAKS["bf16_flop_per_s"],
               nbytes / PEAKS["hbm_bytes_per_s"])


def prefill_flops(m: Dict, batch: int, length: int) -> float:
    """Model FLOPs of one causal prefill of ``batch`` prompts of
    ``length`` tokens that unembeds each prompt's last position."""
    H = m["n_heads"]
    attn = attention_layers(m) * 4 * head_dim(m) * H * batch * \
        visible_pairs(length, length, True, 0)
    return (2.0 * body_params(m) * batch * length
            + 2.0 * unembed_params(m) * batch + attn)


def decode_flops(m: Dict, contexts: Iterable[int]) -> float:
    """Model FLOPs of one decode step: one token per sequence, each
    attending over its own ``context`` positions (itself included)."""
    contexts = list(contexts)
    per_token = 2.0 * (body_params(m) + unembed_params(m))
    attn = attention_layers(m) * 4 * head_dim(m) * m["n_heads"] * \
        sum(contexts)
    return per_token * len(contexts) + attn
