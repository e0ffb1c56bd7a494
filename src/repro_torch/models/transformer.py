"""The decoder-only dense transformer in PyTorch: the dense half of
``repro/models/transformer.py``.

The reference stacks its layers into scan *bodies* of
``cfg.scan_period`` slots and iterates them with ``lax.scan``; the port
runs eagerly, so its parameters hold one dict per layer
(``params["layers"][l]``, layer ``l`` being slot ``l % scan_period``)
and every pass is a Python loop over layers.

Parameters are plain nested dicts of tensors.  ``param_layout`` is the
single source of truth: every leaf is (shape, init_std).  The matmul
weights, embeddings and biases are held in the compute type (bf16) and
the norm weights in fp32: the reference holds fp32 weights but casts
each one to bf16 at every use and reads norm weights as fp32, so the
rounding is the same and the card holds half the bytes.
``params_from_jax`` carries the reference's parameters across.

Other families (MoE, SSD, hybrid, encoder-decoder, VLM) raise
``NotImplementedError`` naming the ROADMAP.md item that brings them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from . import layers as L
from .config import ModelConfig

COMPUTE_DTYPE = torch.bfloat16
#: layout keys whose weights stay fp32 (read as fp32 by ``rms_norm``)
NORM_KEYS = frozenset({"ln1", "ln2", "final_norm"})

_FAMILY_ITEM = {
    "moe": "ROADMAP.md Queue 1, item 1 (MoE)",
    "ssm": "ROADMAP.md Queue 1, item 2 (SSD and the hybrid)",
    "hybrid": "ROADMAP.md Queue 1, item 2 (SSD and the hybrid)",
    "vlm": "ROADMAP.md Queue 1, item 3 (image embeddings and the "
           "encoder-decoder)",
    "audio": "ROADMAP.md Queue 1, item 3 (image embeddings and the "
             "encoder-decoder)",
}


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.arch_id}: the {cfg.family!r} family is not ported yet "
            f"({_FAMILY_ITEM.get(cfg.family, 'ROADMAP.md Queue 1')})")


def resolve_device(device=None) -> torch.device:
    """The device a model runs on: the card unless the caller asks for
    the CPU.  Raises when the card was asked for (explicitly or by
    default) and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"models run on cuda or cpu, not {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the host")
    return dev


# ------------------------------------------------------------------ layout
def _layer_layout(cfg: ModelConfig) -> L.Layout:
    """Layout of one dense layer: attention + MLP (a layer's slot in its
    body sets only its attention window)."""
    D = cfg.d_model
    return {"ln1": ((D,), 0.0), "attn": L.attn_params_layout(cfg),
            "ln2": ((D,), 0.0), "mlp": L.mlp_params_layout(cfg)}


def param_layout(cfg: ModelConfig) -> Dict:
    _require_dense(cfg)
    D, V = cfg.d_model, cfg.padded_vocab
    out: Dict = {
        "embed": ((V, D), D ** -0.5),
        "final_norm": ((D,), 0.0),
    }
    if not cfg.tie_embeddings:
        out["unembed"] = ((D, V), D ** -0.5)
    out["layers"] = [_layer_layout(cfg) for _ in range(cfg.n_layers)]
    return out


def _walk(layout, f, path=()):
    """Map ``f(path, leaf)`` over a layout (dicts and per-layer lists)."""
    if isinstance(layout, dict):
        return {k: _walk(v, f, path + (k,)) for k, v in layout.items()}
    if isinstance(layout, list):
        return [_walk(v, f, path + (i,)) for i, v in enumerate(layout)]
    return f(path, layout)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters of ``cfg`` (dense: every parameter is active)."""
    total = 0

    def add(path, leaf):
        nonlocal total
        total += int(np.prod(leaf[0]))

    _walk(param_layout(cfg), add)
    return total


def _leaf_dtype(path, dtype):
    return torch.float32 if path[-1] in NORM_KEYS else dtype


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None,
                dtype: torch.dtype = COMPUTE_DTYPE) -> Dict:
    """Random parameters: normals times each leaf's std, drawn from one
    ``torch.Generator`` seeded by ``seed`` on the target device, in the
    layout's order; zeros where the std is 0.  Matmul weights and
    embeddings in ``dtype``, norm weights in fp32; each leaf is drawn in
    fp32 and rounded once, one leaf at a time."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def init(path, leaf):
        shape, std = leaf
        dt = _leaf_dtype(path, dtype)
        if std == 0.0:
            return torch.zeros(shape, dtype=dt, device=dev)
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return x.mul_(std).to(dt)

    return _walk(param_layout(cfg), init)


def params_from_jax(tree: Dict, *, device=None,
                    dtype: torch.dtype = COMPUTE_DTYPE) -> Dict:
    """The port's parameters from the reference's parameter pytree as
    numpy arrays (``jax.tree.map(np.asarray, params)``).  A stacked body
    leaf ``[n_bodies, ...]`` of slot ``s`` becomes layer
    ``body * scan_period + s``; weights keep the ``x @ w`` orientation;
    matmul weights go to ``dtype``, norm weights stay fp32."""
    dev = resolve_device(device)
    body = tree["body"]
    period = len(body)
    if sorted(body) != [f"slot{i}" for i in range(period)]:
        raise ValueError(f"unexpected body slots {sorted(body)}")
    slots = [body[f"slot{i}"] for i in range(period)]
    if any(k not in ("ln1", "attn", "ln2", "mlp") for s in slots for k in s):
        raise NotImplementedError(
            "only dense layers (ln1, attn, ln2, mlp) are ported; "
            f"got {sorted(set(k for s in slots for k in s))}")
    n_bodies = len(np.asarray(slots[0]["ln1"]))

    def conv(path, a):
        a = np.array(a, copy=True, order="C")
        return torch.from_numpy(a).to(device=dev,
                                      dtype=_leaf_dtype(path, dtype))

    def layer(b, s):
        return _walk(slots[s], lambda path, a: conv(path, np.asarray(a)[b]))

    out = {k: conv((k,), tree[k]) for k in ("embed", "final_norm",
                                            "unembed") if k in tree}
    out["layers"] = [layer(b, s) for b in range(n_bodies)
                     for s in range(period)]
    return out


# ----------------------------------------------------------------- forward
def _embed(params, cfg: ModelConfig, tokens):
    x = params["embed"][tokens.long()].to(COMPUTE_DTYPE)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=COMPUTE_DTYPE,
                             device=x.device)
    return x


def _unembed(params, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        logits = x @ params["embed"].to(COMPUTE_DTYPE).T   # (V_pad, D)
    else:
        logits = x @ params["unembed"].to(COMPUTE_DTYPE)
    logits = L.softcap(logits.float(), cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:                 # mask pad rows
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _layer_forward(lp, x, cfg: ModelConfig, l: int, positions, impl):
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + L.attention_layer(lp["attn"], h, cfg, positions=positions,
                              window=cfg.layer_window(l % cfg.scan_period),
                              impl=impl)
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + L.mlp_layer(lp["mlp"], h2, cfg)


def forward(params, cfg: ModelConfig, tokens, *, impl="naive"):
    """Full-sequence forward: tokens (B,S) -> (logits (B,S,V) f32, aux),
    aux being the reference's auxiliary loss (0 for dense layers)."""
    _require_dense(cfg)
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = _positions(B, S, x.device)
    for l, lp in enumerate(params["layers"]):
        x = _layer_forward(lp, x, cfg, l, positions, impl)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (_unembed(params, cfg, x),
            torch.zeros((), dtype=torch.float32, device=x.device))


# ----------------------------------------------------------- decode caches
def _cache_slots(cfg: ModelConfig, l: int, max_seq: int) -> int:
    w = cfg.layer_window(l % cfg.scan_period)
    return min(max_seq, w) if w else max_seq               # ring buffer


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype: torch.dtype = COMPUTE_DTYPE, device=None) -> List:
    """One ``{"k", "v"}`` dict per layer, each (batch, slots, KV, hd):
    ``max_seq`` slots for full attention, ``min(max_seq, window)`` (a
    ring buffer) for sliding-window layers."""
    _require_dense(cfg)
    dev = resolve_device(device)
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return [{name: torch.zeros(batch, _cache_slots(cfg, l, max_seq), KV, hd,
                               dtype=dtype, device=dev)
             for name in ("k", "v")} for l in range(cfg.n_layers)]


def decode_step(params, cfg: ModelConfig, token, cache, pos):
    """One decode step.  token (B,1) int; pos (B,) int = position of
    this token.  Returns (logits (B,1,V) f32, cache); the cache tensors
    are written in place."""
    _require_dense(cfg)
    x = _embed(params, cfg, token)
    new_cache = []
    for l, lp in enumerate(params["layers"]):
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        out, ck, cv = L.decode_attention(
            lp["attn"], h, cache[l]["k"], cache[l]["v"], pos, cfg,
            window=cfg.layer_window(l % cfg.scan_period))
        new_cache.append({"k": ck, "v": cv})
        x = x + out
        h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.mlp_layer(lp["mlp"], h2, cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x), new_cache


def prefill(params, cfg: ModelConfig, tokens, *,
            max_seq: Optional[int] = None, impl="naive"):
    """Run the full prompt, return (logits_last (B,V), cache) with the KV
    cache sized to max_seq (>= prompt length)."""
    _require_dense(cfg)
    B, Sq = tokens.shape
    max_seq = max_seq or Sq
    x = _embed(params, cfg, tokens)
    positions = _positions(B, Sq, x.device)

    def to_cache(k, v, l):
        """Lay k/v (B,Sq,KV,hd) out as layer l's decode cache: padded to
        max_seq for full attention; a ring buffer of ``window`` slots
        (slot = position % window) for sliding-window layers."""
        slots = _cache_slots(cfg, l, max_seq)
        kp = k.new_zeros(B, slots, *k.shape[2:])
        vp = v.new_zeros(B, slots, *v.shape[2:])
        if not cfg.layer_window(l % cfg.scan_period):
            kp[:, :Sq], vp[:, :Sq] = k, v
        else:
            tail = min(Sq, slots)
            idx = torch.arange(Sq - tail, Sq, device=k.device) % slots
            kp[:, idx], vp[:, idx] = k[:, Sq - tail:], v[:, Sq - tail:]
        return {"k": kp, "v": vp}

    cache = []
    for l, lp in enumerate(params["layers"]):
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = L._proj_qkv(lp["attn"], h, cfg, rope=True,
                              positions=positions)
        o = L.run_attention(q, k, v, positions, positions, cfg, causal=True,
                            window=cfg.layer_window(l % cfg.scan_period),
                            impl=impl)
        x = x + o.reshape(B, Sq, -1) @ lp["attn"]["wo"].to(x.dtype)
        cache.append(to_cache(k, v, l))
        h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.mlp_layer(lp["mlp"], h2, cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _unembed(params, cfg, x[:, -1:, :])
    return logits[:, 0, :], cache
