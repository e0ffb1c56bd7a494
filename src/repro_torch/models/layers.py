"""Model building blocks in PyTorch: the port of
``repro/models/layers.py`` (norms, RoPE and sinusoidal positions,
attention, cross attention, the MLP, the MoE and the gated norm of the
SSD block).

Everything takes explicit parameter dicts of tensors.  Attention has
three interchangeable implementations with the same math:

- ``naive``     — materializes the (…, Sq, Sk) scores; CPU tests, decode
                  on the CPU (decode on the card takes the split-KV
                  kernel of ``kernels/decode_attention.py``).
- ``blockwise`` — flash-style streaming over kv blocks with a running
                  log-sum-exp, as Python loops over blocks.
- ``flash``     — the hand-written CUDA kernel (``kernels/ops.py``); the
                  port's name for the reference's ``pallas``.

The reference's sharding annotations (``lshard``) and tensor-parallel
head padding (``pad_heads_for_tp``) stand where the reference has them;
both are no-ops without a rules context (``runtime.sharding``).  Under
rules activations are DTensors: attention runs on each rank's local
batch and heads (``sharding.map_local_heads``), and decode attention on
each rank's slice of the cache, merged across the ranks that hold the
other slices (``_decode_dtensor``).  Weights keep the reference's
``x @ w`` orientation and are cast to the activations' type at every
use, as in the reference.  The MoE layer's
``moe_variant`` only places tensors across devices, so on one device
both variants are the same computation.  ``cross_attention_layer``
attends with ``naive`` always: the reference hard-codes it there, so it
launches no kernel.

``rms_norm``, ``apply_rope``, ``attention_core``, ``decode_attention``
and ``moe_layer`` are spans of ``obs.spans`` (recorded only while a
profiler records), and ``moe_layer`` counts its routed, kept and
capacity slots there while a profiler records a serving call.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..kernels.decode_attention import decode_attention_bshd
from ..obs import spans
from ..runtime.sharding import (at_use, axis_size, is_dtensor, keep_whole,
                                like, lshard, map_local_heads, shard_block)
from .config import ModelConfig

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 1024
INT32_MAX = 2 ** 31 - 1

#: a layout leaf is (shape, logical_axes, init_std); a layout is a nested
#: dict of them
Layout = Dict[str, object]


# --------------------------------------------------------------------- norms
@spans.span("rms_norm")
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + at_use(w, torch.float32))).to(dt)


def rms_norm_gated(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-6):
    """Mamba2 output norm: RMSNorm(x * silu(z))."""
    x = x * F.silu(z.float()).to(x.dtype)
    return rms_norm(x, w, eps)


def softcap(x: torch.Tensor, cap: float):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


@spans.span("rope")
def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, D); positions: (B, S) int.  Rotates the two halves of
    the head dim (not interleaved pairs), as the reference does."""
    d = x.shape[-1]
    freqs = like(rope_freqs(d, theta, device=x.device), positions)  # (d/2,)
    ang = positions[..., None].float() * freqs                 # (B,S,d/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.split(x.float(), d // 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None):
    """(n, d) fp32 absolute positions: sin on the even columns, cos on the
    odd ones, of ``position * 10000 ** (-2i / d)``.  The frequencies are
    the correctly rounded fp32 exponentials (taken in float64 and rounded
    once), so the table is the same on every device; the reference's come
    from XLA:CPU's fp32 ``exp``, which misses the correctly rounded value
    in some of them (ROADMAP.md, caveats)."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    expo = torch.arange(0, d, 2, dtype=torch.float32, device=device) * \
        (-math.log(10000.0) / d)
    div = torch.exp(expo.double()).float()
    pe = torch.zeros(n, d, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


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


_grid = threading.local()


@contextlib.contextmanager
def coarse_blocks():
    """While active (in this thread), blockwise attention takes blocks of
    at least an eighth of each sequence: the reference's probe mode
    (``UNROLL_BLOCKS``), for a trace that counts every block.  The same
    FLOPs (every block is computed, masked or not) in at most 8 x 8
    blocks."""
    prev = getattr(_grid, "coarse", False)
    _grid.coarse = True
    try:
        yield
    finally:
        _grid.coarse = prev


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
    if getattr(_grid, "coarse", False):
        block_q = max(block_q, -(-Sq // 8))
        block_k = max(block_k, -(-Sk // 8))
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


@spans.span("attention_core")
def attention_core(q, k, v, q_pos, k_pos, impl="naive", **kw):
    if impl != "flash" and is_dtensor(q):
        # each rank's batch and heads, with its q heads' kv heads
        return map_local_heads(attention_core, q, k, v, q_pos, k_pos,
                               impl=impl, **kw)
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
def attn_params_layout(cfg: ModelConfig, cross: bool = False) -> Layout:
    """q, k, v and output projections, with q/k/v biases where the config
    has them; a cross-attention layout (``cross``) carries no biases."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    lay: Layout = {
        "wq": ((D, H * hd), ("embed", "qkv"), D ** -0.5),
        "wk": ((D, KV * hd), ("embed", "qkv"), D ** -0.5),
        "wv": ((D, KV * hd), ("embed", "qkv"), D ** -0.5),
        "wo": ((H * hd, D), ("qkv", "embed"), (H * hd) ** -0.5),
    }
    if cfg.qkv_bias and not cross:
        lay.update({"bq": ((H * hd,), ("qkv",), 0.0),
                    "bk": ((KV * hd,), ("qkv",), 0.0),
                    "bv": ((KV * hd,), ("qkv",), 0.0)})
    return lay


def _split_heads(x, n: int, hd: int):
    if is_dtensor(x):
        x = keep_whole(x, -1, n)
    return x.reshape(*x.shape[:-1], n, hd)


def _proj_qkv(p, x, cfg: ModelConfig, rope: bool, positions):
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ at_use(p["wq"], x.dtype)
    k = x @ at_use(p["wk"], x.dtype)
    v = x @ at_use(p["wv"], x.dtype)
    if "bq" in p:
        q, k, v = (q + at_use(p["bq"], x.dtype), k + at_use(p["bk"], x.dtype),
                   v + at_use(p["bv"], x.dtype))
    q, k, v = (_split_heads(q, H, hd), _split_heads(k, KV, hd),
               _split_heads(v, KV, hd))
    if rope and cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _pad(x, pad):
    """``F.pad`` of trailing dimensions; a DTensor is padded shard by shard
    (``local_map``) once no rank splits a padded dimension: torch 2.11's
    DTensor cannot plan a pad's redistribution."""
    if not is_dtensor(x):
        return F.pad(x, pad)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    padded = range(x.ndim - len(pad) // 2, x.ndim)
    pl = [Replicate() if isinstance(p, Shard) and p.dim % x.ndim in padded
          else p for p in x.placements]
    x = x.redistribute(x.device_mesh, pl)
    return local_map(lambda t: F.pad(t, pad), out_placements=pl,
                     in_placements=(pl,), device_mesh=x.device_mesh)(x)


def pad_heads_for_tp(q, k, v):
    """Pad heads so the q-head count divides the tensor-parallel extent,
    preserving the GQA q->kv grouping (zero-padded heads produce zeros
    that are sliced off afterwards).  Two strategies, cheapest wins:
    (A) pad the per-kv-group fan-out G; (B) pad whole kv groups."""
    tp = axis_size("heads")
    H, KV = q.shape[2], k.shape[2]
    if tp <= 1 or (H % tp == 0 and H % KV == 0):
        return q, k, v, H
    G = H // KV

    def ceil_to(g, mod):
        while (g * mod) % tp:
            g += 1
        return g

    GA = ceil_to(G, KV)              # strategy A: H2 = KV * GA
    KVB = KV
    while (KVB * G) % tp:
        KVB += 1                     # strategy B: H2 = KVB * G
    if KV * GA <= KVB * G:           # pad fan-out within each kv group
        B_, S, _, D = q.shape
        qg = q.reshape(B_, S, KV, G, D)
        qg = _pad(qg, (0, 0, 0, GA - G))
        return qg.reshape(B_, S, KV * GA, D), k, v, H
    # pad whole kv groups (adds zero kv heads and their zero q heads)
    q2 = _pad(q, (0, 0, 0, (KVB - KV) * G))
    k2 = _pad(k, (0, 0, 0, KVB - KV))
    v2 = _pad(v, (0, 0, 0, KVB - KV))
    return q2, k2, v2, H


def run_attention(q, k, v, q_pos, k_pos, cfg: ModelConfig, *, causal=True,
                  window=0, impl="naive"):
    """Sharded full-sequence attention with TP head padding; returns
    (B,S,H,hd) with the ORIGINAL head count and grouping."""
    H, KV = q.shape[2], k.shape[2]
    q2, k2, v2, H_orig = pad_heads_for_tp(q, k, v)
    q2 = lshard(q2, "batch", "seq", "heads", "head_dim")
    k2 = lshard(k2, "batch", "seq", "kv_heads", "head_dim")
    v2 = lshard(v2, "batch", "seq", "kv_heads", "head_dim")
    out = attention_core(q2, k2, v2, q_pos, k_pos, impl=impl, causal=causal,
                         window=window, cap=cfg.attn_softcap)
    if out.shape[2] != H_orig:
        if k2.shape[2] == KV:                       # strategy A: regroup
            G2 = out.shape[2] // KV
            B_, S = out.shape[0], out.shape[1]
            out = out.reshape(B_, S, KV, G2, -1)[:, :, :, :H // KV, :]
            out = out.reshape(B_, S, H_orig, -1)
        else:                                       # strategy B: tail slice
            out = out[:, :, :H_orig, :]
    return out


def attention_layer(p, x, cfg: ModelConfig, *, positions, window=0,
                    impl="naive"):
    """Self-attention over the full (causal) sequence: (B,S,D)->(B,S,D)."""
    q, k, v = _proj_qkv(p, x, cfg, rope=True, positions=positions)
    out = run_attention(q, k, v, positions, positions, cfg, causal=True,
                        window=window, impl=impl)
    out = out.reshape(*x.shape[:-1], -1)
    return out @ at_use(p["wo"], x.dtype)


def cross_attention_layer(p, x, enc_kv, cfg: ModelConfig):
    """Decoder-to-encoder attention: q from x (B,S,D), k and v
    precomputed from the encoder's output, ``enc_kv = (k, v)`` each
    (B, F, KV, hd).  Every position sees every frame (zero positions, no
    mask); plain PyTorch (``naive``), as in the reference."""
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    q = _split_heads(x @ at_use(p["wq"], x.dtype), H, hd)
    k, v = enc_kv
    B, Sq = q.shape[0], q.shape[1]
    q_pos = torch.zeros(B, Sq, dtype=torch.int32, device=x.device)
    k_pos = torch.zeros(B, k.shape[1], dtype=torch.int32, device=x.device)
    out = run_attention(q, k, v, q_pos, k_pos, cfg, causal=False,
                        impl="naive")
    out = out.reshape(*x.shape[:-1], -1)
    return out @ at_use(p["wo"], x.dtype)


@spans.span("decode_attention")
def decode_attention(p, x, cache_k, cache_v, pos, cfg: ModelConfig,
                     window=0):
    """Single-token decode: x (B,1,D), cache (B,Skv,KV,hd), pos (B,) int.

    Sliding-window layers use a RING-BUFFER cache of exactly ``window``
    slots (slot j holds the newest position p with p % window == j) —
    the cache read per step is O(window), not O(context).  The new k/v
    row is written into the cache tensors in place (``_cache_insert``).
    On CUDA tensors the attention over the cache is the hand-written
    kernel (``kernels.decode_attention``); elsewhere
    ``attention_core_naive``.
    Returns (out (B,1,D), cache_k, cache_v)."""
    B = x.shape[0]
    S_slot = cache_k.shape[1]
    q, k, v = _proj_qkv(p, x, cfg, rope=True, positions=pos[:, None])
    cache_k = lshard(cache_k, "batch", "seq_kv", "kv_heads", "head_dim")
    cache_v = lshard(cache_v, "batch", "seq_kv", "kv_heads", "head_dim")
    if is_dtensor(q):
        out, cache_k, cache_v = _decode_dtensor(
            q, k, v, cache_k, cache_v, pos, window=window,
            cap=cfg.attn_softcap)
    else:
        ring = _is_ring(window, S_slot)
        write_pos = pos % S_slot if ring else pos
        cache_k = _cache_insert(cache_k, k, write_pos)
        cache_v = _cache_insert(cache_v, v, write_pos)
        if q.device.type == "cuda":
            out = decode_attention_bshd(q, cache_k, cache_v, pos,
                                        window=window, ring=ring,
                                        cap=cfg.attn_softcap)
        else:
            out = attention_core_naive(
                q, cache_k, cache_v, pos[:, None],
                _decode_k_pos(pos, 0, S_slot, S_slot, window), causal=True,
                window=0, cap=cfg.attn_softcap)
    out = out.reshape(B, 1, -1)
    return out @ at_use(p["wo"], x.dtype), cache_k, cache_v


def _is_ring(window: int, n_slots: int) -> bool:
    return bool(window) and n_slots == window


def _decode_k_pos(pos, slot0: int, n_local: int, n_slots: int, window: int):
    """(B, n_local) logical position held by cache slots ``[slot0,
    slot0 + n_local)`` of ``n_slots``, given the current ``pos``;
    ``INT32_MAX`` where a slot is not visible."""
    B = pos.shape[0]
    slots = torch.arange(slot0, slot0 + n_local, dtype=torch.int32,
                         device=pos.device)[None, :]
    if _is_ring(window, n_slots):
        # logical position held by each slot, given the current pos
        k_pos = pos[:, None] - (pos[:, None] - slots) % n_slots
        valid = k_pos >= 0
    else:
        k_pos = slots.expand(B, n_local)
        valid = k_pos <= pos[:, None]
        if window:
            valid &= k_pos > pos[:, None] - window
    return torch.where(valid, k_pos, torch.full_like(k_pos, INT32_MAX))


def _attention_parts(q, k, v, q_pos, k_pos, cap=0.0):
    """``attention_core_naive`` (causal) before its normalisation:
    ``(acc (B,Sq,KV,G,D) fp32, row max, denominator)``, the last two
    (B,KV,G,Sq,1).  A row with nothing visible has max -inf, and 0 in
    both others."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * \
        D ** -0.5
    scores = softcap(scores, cap) + \
        _mask_bias(q_pos, k_pos, True, 0)[:, None, None]
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - torch.where(torch.isinf(m), 0.0, m))
    acc = torch.einsum("bkgst,btkd->bskgd", e, v.float())
    return acc, m, e.sum(dim=-1, keepdim=True)


def _decode_dtensor(q, k, v, cache_k, cache_v, pos, *, window, cap):
    """Decode attention on DTensors, through ``local_map``: each rank
    writes the new k/v row where its slice of the cache holds the slot
    and attends over its slice with every head; the slices' softmax
    parts are merged by all-reduces (the max, then the sums) over the
    mesh dimensions that split the cache's slots (``seq_kv``), also
    where such a dimension has one rank.  Writes the caches in place;
    returns (out (B,1,H,hd), cache_k, cache_v), all sharded by batch as
    the caches are."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = cache_k.device_mesh
    cp = [p if p in (Shard(0), Shard(1)) else Replicate()
          for p in cache_k.placements]
    bp = [Shard(0) if p == Shard(0) else Replicate() for p in cp]
    seq_dims = [i for i, p in enumerate(cp) if p == Shard(1)]
    S_slot = cache_k.shape[1]
    block, n_seq = shard_block(mesh, cp, 1)
    if S_slot % n_seq:
        raise ValueError(f"{S_slot} cache slots do not split evenly over "
                         f"{n_seq} ranks")
    S_local = S_slot // n_seq
    lo = block * S_local

    def local(ql, kl, vl, ck, cv, posl):
        write_pos = (posl % S_slot if _is_ring(window, S_slot)
                     else posl).long()
        mine = ((write_pos >= lo) & (write_pos < lo + S_local))[:, None, None]
        idx = torch.clamp(write_pos - lo, 0, S_local - 1)
        b = torch.arange(ck.shape[0], device=ck.device)
        for cache, new in ((ck, kl), (cv, vl)):
            cache[b, idx] = torch.where(mine, new[:, 0].to(cache.dtype),
                                        cache[b, idx])
        acc, m, den = _attention_parts(
            ql, ck, cv, posl[:, None],
            _decode_k_pos(posl, lo, S_local, S_slot, window), cap=cap)
        groups = [mesh.get_group(i) for i in seq_dims]
        m_all = m.clone()
        for g in groups:
            dist.all_reduce(m_all, op=dist.ReduceOp.MAX, group=g)
        corr = torch.exp(m - torch.where(torch.isinf(m_all), 0.0, m_all))
        den = den * corr                                 # (B,KV,G,1,1)
        acc = acc * corr[:, :, :, 0, 0][:, None, :, :, None]
        for g in groups:
            dist.all_reduce(den, group=g)
            dist.all_reduce(acc, group=g)
        den = den[:, :, :, 0, 0][:, None, :, :, None]
        out = acc / torch.where(den == 0, 1.0, den)
        return out.reshape(ql.shape).to(ql.dtype)

    q, k, v = (t.redistribute(mesh, bp) for t in (q, k, v))
    pos = lshard(pos, "batch").redistribute(mesh, bp)
    cache_k, cache_v = (t.redistribute(mesh, cp) for t in (cache_k, cache_v))
    run = local_map(local, out_placements=bp,
                    in_placements=(bp, bp, bp, cp, cp, bp),
                    device_mesh=mesh)
    return run(q, k, v, cache_k, cache_v, pos), cache_k, cache_v


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
        "w_gate": ((D, Fd), ("embed", "mlp"), D ** -0.5),
        "w_up": ((D, Fd), ("embed", "mlp"), D ** -0.5),
        "w_down": ((Fd, D), ("mlp", "embed"), Fd ** -0.5),
    }


def _act(x, kind: str):
    """silu, or gelu in its tanh form (``jax.nn.gelu``'s default)."""
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def mlp_layer(p, x, cfg: ModelConfig):
    h = _act(x @ at_use(p["w_gate"], x.dtype), cfg.act) * \
        (x @ at_use(p["w_up"], x.dtype))
    h = lshard(h, "batch", "seq", "mlp")
    return h @ at_use(p["w_down"], x.dtype)


# ----------------------------------------------------------------------- MoE
#: the expert leaves of ``moe_params_layout`` (stacked over experts; the
#: router is not one of them)
EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def moe_params_layout(cfg: ModelConfig) -> Layout:
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    return {
        "w_router": ((D, E), ("embed", None), D ** -0.5),
        "w_gate": ((E, D, Fd), ("experts", "embed", "expert_mlp"), D ** -0.5),
        "w_up": ((E, D, Fd), ("experts", "embed", "expert_mlp"), D ** -0.5),
        "w_down": ((E, Fd, D), ("experts", "expert_mlp", "embed"),
                   Fd ** -0.5),
    }


def moe_capacity(cfg: ModelConfig, S: int) -> int:
    """Slots per expert and batch row for ``S`` tokens, the reference's
    expression evaluated in Python floats."""
    E, K = cfg.n_experts, cfg.top_k
    return max(1, min(S, int(math.ceil(S * K / E * cfg.capacity_factor))))


def _dispatch_positions(expert_ids: torch.Tensor, n_experts: int):
    """expert_ids: (..., T) int — position of each entry within its
    expert's capacity buffer (its rank among the earlier entries of the
    same row routed to that expert), by a stable sort (no T x E
    one-hot).  Rows of a batched input are independent, as under the
    reference's ``vmap``."""
    T = expert_ids.shape[-1]
    e = expert_ids.long()
    order = torch.argsort(e, dim=-1, stable=True)
    sorted_e = torch.gather(e, -1, order).contiguous()
    experts = torch.arange(n_experts, device=e.device)
    starts = torch.searchsorted(
        sorted_e, experts.expand(*e.shape[:-1], n_experts).contiguous(),
        side="left")
    pos_sorted = (torch.arange(T, device=e.device)
                  - torch.gather(starts, -1, sorted_e))
    return torch.zeros_like(e).scatter_(-1, order, pos_sorted)


class MoeRoute(NamedTuple):
    """What the router decided for x (B, S, D), K = top_k choices a
    token; the (token, k) slots are flattened token-major to S*K."""
    probs: torch.Tensor     # (B, S, E) fp32 softmax of the router
    top_p: torch.Tensor     # (B, S, K) fp32, renormalised over the K
    top_e: torch.Tensor     # (B, S, K) int64 experts, best first
    pos: torch.Tensor       # (B, S*K) int64 slot in the expert's buffer
    keep: torch.Tensor      # (B, S*K) bool: within capacity (not dropped)
    aux: torch.Tensor       # () fp32 Switch load-balance loss


def route_slots(top_e: torch.Tensor, top_p: torch.Tensor, n_experts: int,
                capacity: int):
    """Each (token, k) slot's position in its expert's buffer and
    whether it is kept: ``(pos, keep)``, both (B, S*K)."""
    B = top_e.shape[0]
    pos = _dispatch_positions(top_e.reshape(B, -1), n_experts)
    keep = (pos < capacity) & (top_p.reshape(B, -1) > 0)
    return pos, keep


def _route_rows(logits, K: int, capacity: int):
    """The router's work that stays within each batch row: the fp32
    softmax, top-k renormalised, the experts' choice counts over these
    rows, and each slot's place in the capacity."""
    E = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    sorted_p, sorted_e = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    top_p, top_e = sorted_p[..., :K], sorted_e[..., :K]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # counts by scatter-add, not ``bincount``, which waits on the device
    # for its input's max; integer counts are exact in fp32 in any order
    counts = torch.zeros(E, device=logits.device).scatter_add_(
        0, top_e.reshape(-1), torch.ones(top_e.numel(),
                                         device=logits.device))
    pos, keep = route_slots(top_e, top_p, E, capacity)
    return probs, top_p, top_e, pos, keep, counts


def _batch_local(fn, out_placements, *xs):
    """``fn`` on each rank's batch rows, through ``local_map``: ``xs`` are
    ``(tensor, batch_dim)`` pairs, each redistributed so that only its
    batch dimension stays sharded, as the first one's is;
    ``out_placements`` maps that placement list of the batch
    (``Shard(0)`` on the mesh dimensions that shard it) to the outputs'
    placements.  It reads no rules: a layer recomputed in the backward
    pass runs on autograd's thread, where none are set."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    t0, d0 = xs[0]
    mesh = t0.device_mesh
    bp = [Shard(0) if p == Shard(d0) else Replicate() for p in t0.placements]

    def at(dim):
        return [Shard(dim) if p == Shard(0) else p for p in bp]

    ins = tuple(like(t, t0).redistribute(mesh, at(d)) for t, d in xs)
    run = local_map(fn, out_placements=out_placements(bp),
                    in_placements=tuple(at(d) for _, d in xs),
                    device_mesh=mesh)
    return run(*ins)


def moe_route(p, x, cfg: ModelConfig, capacity: int) -> MoeRoute:
    """Softmax router in fp32, top-k renormalised, the Switch aux loss,
    and each slot's place in a capacity of ``capacity`` per expert.

    Top-k is the first K of a stable descending sort: on equal
    probabilities the lower expert index comes first, as ``lax.top_k``
    gives it (``torch.topk`` breaks such ties otherwise, and bf16 router
    logits tie often).  On DTensors the rows' work runs on each rank's
    batch rows (``local_map``), the counts summed over the ranks."""
    E, K = cfg.n_experts, cfg.top_k
    logits = x @ at_use(p["w_router"], x.dtype)
    if is_dtensor(logits):
        from torch.distributed.tensor import Partial, Replicate
        probs, top_p, top_e, pos, keep, counts = _batch_local(
            lambda lg: _route_rows(lg, K, capacity),
            lambda bp: (bp,) * 5 + (
                [Partial() if b != Replicate() else b for b in bp],),
            (logits, 0))
    else:
        probs, top_p, top_e, pos, keep, counts = _route_rows(
            logits, K, capacity)
    me = probs.mean(dim=(0, 1))
    ce = counts / max(top_e.numel(), 1)
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)
    return MoeRoute(probs, top_p, top_e, pos, keep, aux)


def _dispatch_rows(x, top_e, pos, keep, n_experts: int, capacity: int):
    B, S, D = x.shape
    K = top_e.shape[-1]
    keep = keep.reshape(B, S, K)
    buf = x.new_zeros(n_experts + 1, B, capacity, D)
    e = torch.where(keep, top_e, n_experts)
    pos = torch.where(keep, pos.reshape(B, S, K), 0)
    b = torch.arange(B, device=x.device)[:, None, None]
    buf[e, b, pos] = x[:, :, None, :]
    return buf[:n_experts]


def moe_dispatch(x, route: MoeRoute, n_experts: int, capacity: int):
    """The capacity buffer, held expert-major as (E, B, C, D) so that the
    expert products batch over E without a copy (``.transpose(0, 1)`` is
    the reference's (B, E, C, D)): each kept slot's token at its
    position, zeros elsewhere.  Kept slots never share a position, so
    one indexed write gives the reference's scatter-add (whose dropped
    slots add exact zeros); dropped slots write to a spare expert row
    past the last, which is cut off, so nothing waits on the device to
    count the kept slots.  On DTensors each rank writes its batch rows
    (``local_map``)."""
    if is_dtensor(x):
        from torch.distributed.tensor import Shard
        return _batch_local(
            lambda *a: _dispatch_rows(*a, n_experts, capacity),
            lambda bp: [Shard(1) if b == Shard(0) else b for b in bp],
            (x, 0), (route.top_e, 0), (route.pos, 0), (route.keep, 0))
    return _dispatch_rows(x, route.top_e, route.pos, route.keep, n_experts,
                          capacity)


def moe_experts(p, buf, cfg: ModelConfig):
    """The expert FFN over the (E, B, C, D) buffer: three products
    batched over E, weights cast to the activations' type."""
    E, B, C, D = buf.shape
    dt = buf.dtype
    flat = buf.reshape(E, B * C, D)
    h = _act(torch.bmm(flat, at_use(p["w_gate"], dt)), cfg.act)
    h = h * torch.bmm(flat, at_use(p["w_up"], dt))
    h = lshard(h, "experts", "batch", "expert_mlp")     # (E, B*C, F)
    return torch.bmm(h, at_use(p["w_down"], dt)).reshape(E, B, C, D)


def _combine_rows(out_buf, top_e, top_p, pos, keep):
    E, B, C, D = out_buf.shape
    S, K = top_e.shape[1], top_e.shape[-1]
    dt = out_buf.dtype
    flat_e = top_e.reshape(B, S * K)
    bidx = torch.arange(B, device=out_buf.device)[:, None]
    gathered = out_buf[flat_e, bidx, pos.clamp(0, C - 1)]
    weight = keep.to(dt) * top_p.reshape(B, S * K).to(dt)
    g = (gathered * weight[..., None]).reshape(B, S, K, D)
    out = torch.zeros(B, S, D, dtype=dt, device=out_buf.device)
    for k in range(K):
        out = out + g[:, :, k]
    return out


def moe_combine(out_buf, route: MoeRoute):
    """Each token's output: its K slots' expert outputs weighted by the
    router (dropped slots weigh 0), added one k after another in the
    activations' type, the order of the reference's scatter-add.  On
    DTensors each rank gathers its batch rows' slots from every expert
    (``local_map`` over the buffer replicated along the experts)."""
    args = (route.top_e, route.top_p, route.pos, route.keep)
    if is_dtensor(out_buf):
        return _batch_local(_combine_rows, lambda bp: bp, (out_buf, 1),
                            *((t, 0) for t in args))
    return _combine_rows(out_buf, *args)


@spans.span("moe_layer")
def moe_layer(p, x, cfg: ModelConfig, capacity: Optional[int] = None):
    """Scatter dispatch into per-expert capacity buffers (groups = batch
    rows) -> expert FFN -> weighted combine.  x: (B,S,D).
    Returns (out, aux_loss)."""
    C = capacity or moe_capacity(cfg, x.shape[1])
    route = moe_route(p, x, cfg, C)
    spans.count_moe_slots(route.keep, cfg.n_experts, C)
    buf = moe_dispatch(x, route, cfg.n_experts, C)
    # the reference's (B, E, C, D) buffer annotations, on the port's
    # expert-major (E, B, C, D): with ``replicated_buf`` the scatter stays
    # rank-local and the expert outputs are gathered once before the
    # combine
    replicated = cfg.moe_variant == "replicated_buf"
    buf_axes = (None if replicated else "experts", "batch", None, None)
    buf = lshard(buf, *buf_axes)
    out_buf = lshard(moe_experts(p, buf, cfg), *buf_axes)
    del buf
    return moe_combine(out_buf, route), route.aux
