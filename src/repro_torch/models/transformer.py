"""The decoder-only transformer in PyTorch: the port of
``repro/models/transformer.py`` for the dense, MoE, SSM and hybrid
families.

The reference stacks its layers into scan *bodies* of
``cfg.scan_period`` slots and iterates them with ``lax.scan``; the port
runs eagerly, so its parameters hold one dict per layer
(``params["layers"][l]``, layer ``l`` being slot ``l % scan_period``)
and every pass is a Python loop over layers.  A layer holds ``attn`` or
``ssm`` by ``cfg.layer_kind``, and ``moe`` or ``mlp`` by
``cfg.layer_is_moe``; an SSM-family layer (mamba2) is the SSD block
alone, with no ``ln2`` and no MLP.  Each MoE layer's auxiliary loss is
summed into ``forward``'s ``aux``.

Parameters are plain nested dicts of tensors.  ``param_layout`` is the
single source of truth: every leaf is (shape, init_std).  The matmul
weights, embeddings and biases are held in the compute type (bf16), and
the leaves the reference reads as fp32 stay fp32 (``FP32_KEYS``: the
norms and the SSD block's ``dt_bias``, ``A_log``, ``skip_D``, ``w_norm``
and ``conv_b``): the reference holds fp32 weights but casts each matmul
weight to bf16 at every use, so the rounding is the same and the card
holds half the bytes.
``params_from_jax`` carries the reference's parameters across and
``params_to_jax`` takes them back (checkpoints are written in the
reference's layout).  Training keeps fp32 master weights
(``init_params(dtype=torch.float32)``), as the reference does; the
layers cast them at use.

``forward(remat=True)`` recomputes each layer in the backward pass with
``torch.utils.checkpoint`` (non-reentrant), one checkpoint per layer
where the reference wraps its scan body in ``jax.checkpoint``; the
reference's policies map by name (``REMAT_POLICIES``).

The encoder-decoder and VLM families raise ``NotImplementedError``
naming the ROADMAP.md item that brings them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import layers as L
from . import ssd as S
from .config import ModelConfig

COMPUTE_DTYPE = torch.bfloat16
#: layout keys whose weights stay fp32: the norms (read as fp32 by
#: ``rms_norm``) and the SSD leaves the reference reads as fp32 or casts
#: at use
FP32_KEYS = frozenset({"ln1", "ln2", "final_norm", "dt_bias", "A_log",
                       "skip_D", "w_norm", "conv_b"})
#: the families the port runs
FAMILIES = ("dense", "moe", "ssm", "hybrid")
_FAMILY_ITEM = {
    "vlm": "ROADMAP.md Queue 1, item 4 (image embeddings and the "
           "encoder-decoder)",
    "audio": "ROADMAP.md Queue 1, item 4 (image embeddings and the "
             "encoder-decoder)",
}


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
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
def _layer_layout(cfg: ModelConfig, l: int) -> L.Layout:
    """Layout of layer ``l``, by the rules of the reference's
    ``_slot_layout`` for its slot ``l % scan_period``."""
    D = cfg.d_model
    i = l % cfg.scan_period
    out: L.Layout = {"ln1": ((D,), 0.0)}
    if cfg.layer_kind(i) == "ssm":
        out["ssm"] = S.ssd_params_layout(cfg)
    else:
        out["attn"] = L.attn_params_layout(cfg)
    if cfg.family == "ssm":          # mamba2: the SSD block is the layer
        return out
    out["ln2"] = ((D,), 0.0)
    if cfg.layer_is_moe(i):
        out["moe"] = L.moe_params_layout(cfg)
    else:
        out["mlp"] = L.mlp_params_layout(cfg)
    return out


def param_layout(cfg: ModelConfig) -> Dict:
    _require_ported(cfg)
    D, V = cfg.d_model, cfg.padded_vocab
    out: Dict = {
        "embed": ((V, D), D ** -0.5),
        "final_norm": ((D,), 0.0),
    }
    if not cfg.tie_embeddings:
        out["unembed"] = ((D, V), D ** -0.5)
    out["layers"] = [_layer_layout(cfg, l) for l in range(cfg.n_layers)]
    return out


def _walk(layout, f, path=()):
    """Map ``f(path, leaf)`` over a layout (dicts and per-layer lists)."""
    if isinstance(layout, dict):
        return {k: _walk(v, f, path + (k,)) for k, v in layout.items()}
    if isinstance(layout, list):
        return [_walk(v, f, path + (i,)) for i, v in enumerate(layout)]
    return f(path, layout)


def _is_expert_leaf(path) -> bool:
    return len(path) >= 2 and path[-2] == "moe" and \
        path[-1] in L.EXPERT_KEYS


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters of ``cfg``; with ``active_only`` each expert leaf counts
    ``top_k / n_experts`` of its size, as the reference counts it."""
    total = 0

    def add(path, leaf):
        nonlocal total
        n = int(np.prod(leaf[0]))
        if active_only and _is_expert_leaf(path):
            n = int(n * cfg.top_k / max(cfg.n_experts, 1))
        total += n

    _walk(param_layout(cfg), add)
    return total


def _leaf_dtype(path, dtype):
    return torch.float32 if path[-1] in FP32_KEYS else dtype


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None,
                dtype: torch.dtype = COMPUTE_DTYPE) -> Dict:
    """Random parameters: normals times each leaf's std, drawn from one
    ``torch.Generator`` seeded by ``seed`` on the target device, in the
    layout's order; where the std is 0, the reference's initial values
    (zeros, but ``A_log = log(linspace(1, 8, H))`` and ``skip_D = 1``).
    Matmul weights and embeddings in ``dtype``, ``FP32_KEYS`` leaves in
    fp32; each leaf is drawn in fp32 and rounded once, one leaf at a
    time."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def init(path, leaf):
        shape, std = leaf
        dt = _leaf_dtype(path, dtype)
        if std == 0.0:
            if path[-1] == "A_log":
                return torch.log(torch.linspace(1.0, 8.0, shape[-1],
                                                device=dev)).to(dt)
            if path[-1] == "skip_D":
                return torch.ones(shape, dtype=dt, device=dev)
            return torch.zeros(shape, dtype=dt, device=dev)
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return x.mul_(std).to(dt)

    return _walk(param_layout(cfg), init)


def params_to_jax(params: Dict, cfg: ModelConfig) -> Dict:
    """The inverse of ``params_from_jax``: the reference's parameter tree
    as fresh host numpy arrays, layer ``l`` stacked into body
    ``l // scan_period``, slot ``l % scan_period`` (``body/slot{i}``).
    Each leaf keeps the dtype held; bf16, which numpy lacks, widens to
    fp32 (exactly).  Also takes any tree shaped like the parameters (the
    optimizer's moments)."""
    _require_ported(cfg)
    period = cfg.scan_period
    layers = params["layers"]
    if len(layers) % period:
        raise ValueError(f"{len(layers)} layers do not fill bodies of "
                         f"{period} slots")

    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()

    def stack(*leaves):
        return np.stack([host(t) for t in leaves])

    def stack_tree(trees):
        first = trees[0]
        if isinstance(first, dict):
            return {k: stack_tree([t[k] for t in trees]) for k in first}
        return stack(*trees)

    out = {k: host(params[k]) for k in ("embed", "final_norm", "unembed")
           if k in params}
    out["body"] = {f"slot{s}": stack_tree(layers[s::period])
                   for s in range(period)}
    return out


#: what a layer of a ported family holds
_LAYER_KEYS = ("ln1", "attn", "ssm", "ln2", "mlp", "moe")


def params_from_jax(tree: Dict, *, device=None,
                    dtype: torch.dtype = COMPUTE_DTYPE) -> Dict:
    """The port's parameters from the reference's parameter pytree as
    numpy arrays (``jax.tree.map(np.asarray, params)``).  A stacked body
    leaf ``[n_bodies, ...]`` of slot ``s`` becomes layer
    ``body * scan_period + s``; weights keep the ``x @ w`` orientation;
    matmul weights go to ``dtype``, ``FP32_KEYS`` leaves stay fp32."""
    dev = resolve_device(device)
    body = tree["body"]
    period = len(body)
    if sorted(body) != [f"slot{i}" for i in range(period)]:
        raise ValueError(f"unexpected body slots {sorted(body)}")
    slots = [body[f"slot{i}"] for i in range(period)]
    if any(k not in _LAYER_KEYS for s in slots for k in s):
        raise NotImplementedError(
            f"only layers of {', '.join(_LAYER_KEYS)} are ported; "
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


def _ffn(lp, x, cfg: ModelConfig):
    """The layer's second half, ``ln2`` then its MoE or MLP: (x, aux),
    aux None without MoE.  A layer without ``ln2`` (mamba2) has none."""
    if "ln2" not in lp:
        return x, None
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        out, aux = L.moe_layer(lp["moe"], h2, cfg)
        return x + out, aux
    return x + L.mlp_layer(lp["mlp"], h2, cfg), None


def _layer_forward(lp, x, cfg: ModelConfig, l: int, positions, impl):
    """One layer over the full sequence: (x, aux or None)."""
    i = l % cfg.scan_period
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.layer_kind(i) == "ssm":
        x = x + S.ssd_layer(lp["ssm"], h, cfg)
    else:
        x = x + L.attention_layer(lp["attn"], h, cfg, positions=positions,
                                  window=cfg.layer_window(i), impl=impl)
    return _ffn(lp, x, cfg)


#: the reference's remat policies (``runtime/steps.py::REMAT_POLICIES``)
#: by name; what each layer keeps for the backward pass:
#: ``dots`` the outputs of its unbatched matrix products (JAX's
#: ``dots_with_no_batch_dims_saveable``: a ``(B, S, D) @ (D, F)``
#: projection folds to ``aten.mm``, attention's batched products are
#: ``aten.bmm`` and are recomputed), ``none`` only its input
#: (``nothing_saveable``), ``everything`` all of it (no recompute)
REMAT_POLICIES = ("dots", "none", "everything")
_SAVED_BY_DOTS = frozenset({torch.ops.aten.mm.default,
                            torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_save_dots)


def forward(params, cfg: ModelConfig, tokens, *, impl="naive",
            remat: bool = False, remat_policy: Optional[str] = None):
    """Full-sequence forward: tokens (B,S) -> (logits (B,S,V) f32, aux),
    aux being the reference's auxiliary loss: the sum over MoE layers of
    each one's load-balance loss, in layer order (0 without MoE).

    ``remat``: recompute each layer in the backward pass, keeping what
    ``remat_policy`` (a name of ``REMAT_POLICIES``; None means ``dots``,
    the reference's default) saves."""
    _require_ported(cfg)
    policy = remat_policy or "dots"
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}: "
                         f"{', '.join(REMAT_POLICIES)}")
    recompute = remat and policy != "everything" and torch.is_grad_enabled()
    ckpt_kw = {"context_fn": _dots_context} if policy == "dots" else {}
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = _positions(B, S, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l, lp in enumerate(params["layers"]):
        if recompute:
            x, a = checkpoint(_layer_forward, lp, x, cfg, l, positions, impl,
                              use_reentrant=False, **ckpt_kw)
        else:
            x, a = _layer_forward(lp, x, cfg, l, positions, impl)
        if a is not None:
            aux = aux + a
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x), aux


# -------------------------------------------------------------------- loss
def loss_fn(params, cfg: ModelConfig, tokens, labels, **fw_kw):
    """Mean next-token cross-entropy (log-sum-exp minus the label's
    logit) plus the auxiliary loss: ``(total, (loss, aux))``."""
    logits, aux = forward(params, cfg, tokens, **fw_kw)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = torch.mean(lse - ll)
    return loss + aux, (loss, aux)


# ----------------------------------------------------------- decode caches
def _cache_slots(cfg: ModelConfig, l: int, max_seq: int) -> int:
    w = cfg.layer_window(l % cfg.scan_period)
    return min(max_seq, w) if w else max_seq               # ring buffer


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype: torch.dtype = COMPUTE_DTYPE, device=None) -> List:
    """One dict per layer.  An attention layer's ``{"k", "v"}`` are each
    (batch, slots, KV, hd): ``max_seq`` slots for full attention,
    ``min(max_seq, window)`` (a ring buffer) for sliding-window layers.
    An SSD layer's dict holds ``"conv"`` (batch, K-1, conv_dim) in
    ``dtype`` and ``"state"`` (batch, H, P, N) in fp32."""
    _require_ported(cfg)
    dev = resolve_device(device)
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim

    def layer(l):
        if cfg.layer_kind(l % cfg.scan_period) == "ssm":
            return {"conv": torch.zeros(batch, cfg.ssm_conv - 1, cfg.conv_dim,
                                        dtype=dtype, device=dev),
                    "state": torch.zeros(batch, cfg.ssm_heads,
                                         cfg.ssm_head_dim, cfg.ssm_state,
                                         dtype=torch.float32, device=dev)}
        return {name: torch.zeros(batch, _cache_slots(cfg, l, max_seq), KV,
                                  hd, dtype=dtype, device=dev)
                for name in ("k", "v")}

    return [layer(l) for l in range(cfg.n_layers)]


def decode_step(params, cfg: ModelConfig, token, cache, pos):
    """One decode step.  token (B,1) int; pos (B,) int = position of
    this token.  Returns (logits (B,1,V) f32, cache); the cache tensors
    are written in place."""
    _require_ported(cfg)
    x = _embed(params, cfg, token)
    new_cache = []
    for l, lp in enumerate(params["layers"]):
        i = l % cfg.scan_period
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cfg.layer_kind(i) == "ssm":
            out, layer_cache = S.ssd_decode(lp["ssm"], h, cache[l], cfg)
        else:
            out, ck, cv = L.decode_attention(
                lp["attn"], h, cache[l]["k"], cache[l]["v"], pos, cfg,
                window=cfg.layer_window(i))
            layer_cache = {"k": ck, "v": cv}
        new_cache.append(layer_cache)
        x, _ = _ffn(lp, x + out, cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x), new_cache


def prefill(params, cfg: ModelConfig, tokens, *,
            max_seq: Optional[int] = None, impl="naive"):
    """Run the full prompt, return (logits_last (B,V), cache) with the KV
    cache sized to max_seq (>= prompt length)."""
    _require_ported(cfg)
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
        i = l % cfg.scan_period
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cfg.layer_kind(i) == "ssm":
            out, layer_cache = S.ssd_layer(lp["ssm"], h, cfg,
                                           return_cache=True)
            x = x + out
        else:
            q, k, v = L._proj_qkv(lp["attn"], h, cfg, rope=True,
                                  positions=positions)
            o = L.run_attention(q, k, v, positions, positions, cfg,
                                causal=True, window=cfg.layer_window(i),
                                impl=impl)
            x = x + o.reshape(B, Sq, -1) @ lp["attn"]["wo"].to(x.dtype)
            layer_cache = to_cache(k, v, l)
        cache.append(layer_cache)
        x, _ = _ffn(lp, x, cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _unembed(params, cfg, x[:, -1:, :])
    return logits[:, 0, :], cache
