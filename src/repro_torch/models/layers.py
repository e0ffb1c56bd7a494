"""Model building blocks in PyTorch: the dense half of
``repro/models/layers.py``.

Everything takes explicit parameter dicts of tensors.  Attention has
three interchangeable implementations with the same math:

- ``naive``     — materializes the (…, Sq, Sk) scores; CPU tests, decode.
- ``blockwise`` — flash-style streaming over kv blocks with a running
                  log-sum-exp, as Python loops over blocks.
- ``flash``     — the hand-written CUDA kernel (``kernels/ops.py``); the
                  port's name for the reference's ``pallas``.

Single-device code has no counterpart of the reference's sharding
annotations (``lshard``) or tensor-parallel head padding
(``pad_heads_for_tp``): both are no-ops without a rules context.
Weights keep the reference's ``x @ w`` orientation and are cast to the
activations' type at every use, as in the reference.  MoE,
``rms_norm_gated``, ``cross_attention_layer`` and
``sinusoidal_positions`` come with their families (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 1024
INT32_MAX = 2 ** 31 - 1

#: a layout leaf is (shape, init_std); a layout is a nested dict of them
Layout = Dict[str, object]


# --------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def softcap(x: torch.Tensor, cap: float):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, D); positions: (B, S) int.  Rotates the two halves of
    the head dim (not interleaved pairs), as the reference does."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)              # (d/2,)
    ang = positions[..., None].float() * freqs                 # (B,S,d/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.split(x.float(), d // 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention
def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int):
    """Additive mask bias (..., Sq, Sk) from position vectors.  The
    difference is taken in int64, so a masked slot's ``int32 max``
    position can never wrap round into a visible one."""
    diff = q_pos.long()[..., :, None] - k_pos.long()[..., None, :]  # q - k
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok &= diff >= 0
    if window:
        ok &= diff < window
    zero = torch.zeros((), dtype=torch.float32, device=diff.device)
    return torch.where(ok, zero, float("-inf"))


def attention_core_naive(q, k, v, q_pos, k_pos, *, causal=True, window=0,
                         cap=0.0, scale=None):
    """q: (B,Sq,H,D); k,v: (B,Sk,KV,D); GQA by head grouping.
    Returns (B,Sq,H,D)."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = scale or D ** -0.5
    qg = q.reshape(B, Sq, KV, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    scores = softcap(scores, cap)
    bias = _mask_bias(q_pos, k_pos, causal, window)   # (B,Sq,Sk) or (Sq,Sk)
    while bias.dim() < scores.dim():
        bias = bias[:, None] if bias.dim() >= 3 else bias[None]
    scores = scores + bias
    probs = torch.softmax(scores, dim=-1)
    del scores
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def attention_core_blockwise(q, k, v, q_pos, k_pos, *, causal=True, window=0,
                             cap=0.0, scale=None, block_q=DEFAULT_BLOCK_Q,
                             block_k=DEFAULT_BLOCK_K):
    """Flash-style streaming attention (same semantics as naive): a loop
    over q blocks, and inside it a loop over kv blocks with a running
    (max, denom, acc).

    Unlike the reference, a row whose first kv blocks are wholly masked
    (a sliding window over more than one kv block) stays finite: the
    running max is read as 0 while it is still -inf."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale or D ** -0.5
    block_q = min(block_q, Sq)
    block_k = min(block_k, Sk)
    nq = -(-Sq // block_q)
    nk = -(-Sk // block_k)
    pq, pk = nq * block_q - Sq, nk * block_k - Sk
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
        q_pos = F.pad(q_pos, (0, pq), value=-1)
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
        k_pos = F.pad(k_pos, (0, pk), value=INT32_MAX)

    outs = []
    for i in range(nq):
        sl = slice(i * block_q, (i + 1) * block_q)
        qi = q[:, sl].reshape(B, block_q, KV, G, D).float()
        qp = q_pos[:, sl]
        acc = torch.zeros(B, KV, G, block_q, D, dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, KV, G, block_q), float("-inf"),
                       dtype=torch.float32, device=q.device)
        l = torch.zeros(B, KV, G, block_q, dtype=torch.float32,
                        device=q.device)
        for j in range(nk):
            sk = slice(j * block_k, (j + 1) * block_k)
            s = torch.einsum("bqkgd,btkd->bkgqt", qi, k[:, sk].float()) * scale
            s = softcap(s, cap)
            s = s + _mask_bias(qp, k_pos[:, sk], causal, window)[:, None, None]
            m_new = torch.maximum(m, s.amax(dim=-1))
            base = torch.where(torch.isinf(m_new), torch.zeros_like(m_new),
                               m_new)
            p = torch.exp(s - base[..., None])
            corr = torch.exp(m - base)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", p, v[:, sk].float())
            m = m_new
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        outs.append((acc / l[..., None]).permute(0, 3, 1, 2, 4))  # B,bq,KV,G,D
    out = torch.cat(outs, dim=1).reshape(B, nq * block_q, H, D)
    return out[:, :Sq].to(q.dtype)


def attention_core(q, k, v, q_pos, k_pos, impl="naive", **kw):
    if impl == "blockwise":
        return attention_core_blockwise(q, k, v, q_pos, k_pos, **kw)
    kw.pop("block_q", None), kw.pop("block_k", None)
    if impl == "flash":
        from ..kernels import ops as kops
        return kops.flash_attention(q, k, v, q_pos, k_pos, **kw)
    if impl != "naive":
        raise ValueError(f"unknown attention impl {impl!r}: naive, "
                         "blockwise or flash (the reference's 'pallas')")
    return attention_core_naive(q, k, v, q_pos, k_pos, **kw)


# ------------------------------------------------------------ attention layer
def attn_params_layout(cfg: ModelConfig) -> Layout:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    lay: Layout = {
        "wq": ((D, H * hd), D ** -0.5),
        "wk": ((D, KV * hd), D ** -0.5),
        "wv": ((D, KV * hd), D ** -0.5),
        "wo": ((H * hd, D), (H * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        lay.update({"bq": ((H * hd,), 0.0), "bk": ((KV * hd,), 0.0),
                    "bv": ((KV * hd,), 0.0)})
    return lay


def _split_heads(x, n: int, hd: int):
    return x.reshape(*x.shape[:-1], n, hd)


def _proj_qkv(p, x, cfg: ModelConfig, rope: bool, positions):
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q, k, v = (q + p["bq"].to(x.dtype), k + p["bk"].to(x.dtype),
                   v + p["bv"].to(x.dtype))
    q, k, v = (_split_heads(q, H, hd), _split_heads(k, KV, hd),
               _split_heads(v, KV, hd))
    if rope and cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def run_attention(q, k, v, q_pos, k_pos, cfg: ModelConfig, *, causal=True,
                  window=0, impl="naive"):
    """Full-sequence attention; returns (B,S,H,hd)."""
    return attention_core(q, k, v, q_pos, k_pos, impl=impl, causal=causal,
                          window=window, cap=cfg.attn_softcap)


def attention_layer(p, x, cfg: ModelConfig, *, positions, window=0,
                    impl="naive"):
    """Self-attention over the full (causal) sequence: (B,S,D)->(B,S,D)."""
    q, k, v = _proj_qkv(p, x, cfg, rope=True, positions=positions)
    out = run_attention(q, k, v, positions, positions, cfg, causal=True,
                        window=window, impl=impl)
    out = out.reshape(*x.shape[:-1], -1)
    return out @ p["wo"].to(x.dtype)


def decode_attention(p, x, cache_k, cache_v, pos, cfg: ModelConfig,
                     window=0):
    """Single-token decode: x (B,1,D), cache (B,Skv,KV,hd), pos (B,) int.

    Sliding-window layers use a RING-BUFFER cache of exactly ``window``
    slots (slot j holds the newest position p with p % window == j) —
    the cache read per step is O(window), not O(context).  The new k/v
    row is written into the cache tensors in place (``_cache_insert``).
    Returns (out (B,1,D), cache_k, cache_v)."""
    B = x.shape[0]
    S_slot = cache_k.shape[1]
    ring = bool(window) and S_slot == window
    q, k, v = _proj_qkv(p, x, cfg, rope=True, positions=pos[:, None])
    write_pos = pos % S_slot if ring else pos
    cache_k = _cache_insert(cache_k, k, write_pos)
    cache_v = _cache_insert(cache_v, v, write_pos)
    slots = torch.arange(S_slot, dtype=torch.int32, device=x.device)[None, :]
    if ring:
        # logical position held by each slot, given the current pos
        k_pos = pos[:, None] - (pos[:, None] - slots) % S_slot
        valid = k_pos >= 0
    else:
        k_pos = slots.expand(B, S_slot)
        valid = k_pos <= pos[:, None]
        if window:
            valid &= k_pos > pos[:, None] - window
    k_pos_masked = torch.where(valid, k_pos,
                               torch.full_like(k_pos, INT32_MAX))
    out = attention_core_naive(q, cache_k, cache_v, pos[:, None],
                               k_pos_masked, causal=True, window=0,
                               cap=cfg.attn_softcap)
    out = out.reshape(B, 1, -1)
    return out @ p["wo"].to(x.dtype), cache_k, cache_v


def _cache_insert(cache, new, pos):
    """cache (B,S,KV,hd), new (B,1,KV,hd), pos (B,): write one row per
    batch element INTO ``cache`` (in place) and return it."""
    B = cache.shape[0]
    cache[torch.arange(B, device=cache.device), pos.long()] = \
        new[:, 0].to(cache.dtype)
    return cache


# ----------------------------------------------------------------------- MLP
def mlp_params_layout(cfg: ModelConfig, d_ff: Optional[int] = None) -> Layout:
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    return {
        "w_gate": ((D, Fd), D ** -0.5),
        "w_up": ((D, Fd), D ** -0.5),
        "w_down": ((Fd, D), Fd ** -0.5),
    }


def _act(x, kind: str):
    """silu, or gelu in its tanh form (``jax.nn.gelu``'s default)."""
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def mlp_layer(p, x, cfg: ModelConfig):
    h = _act(x @ p["w_gate"].to(x.dtype), cfg.act) * \
        (x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype)
