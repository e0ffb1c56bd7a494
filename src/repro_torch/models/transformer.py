"""The unified model in PyTorch: the port of
``repro/models/transformer.py`` for all six families (dense, MoE, SSM,
hybrid, VLM and the encoder-decoder).

The reference stacks its layers into scan *bodies* of
``cfg.scan_period`` slots and iterates them with ``lax.scan``; the port
runs eagerly, so its parameters hold one dict per layer
(``params["layers"][l]``, layer ``l`` being slot ``l % scan_period``)
and every pass is a Python loop over layers.  A layer holds ``attn`` or
``ssm`` by ``cfg.layer_kind``, and ``moe`` or ``mlp`` by
``cfg.layer_is_moe``; an SSM-family layer (mamba2) is the SSD block
alone, with no ``ln2`` and no MLP.  Each MoE layer's auxiliary loss is
summed into ``forward``'s ``aux``.

A VLM (pixtral) replaces its first ``n_image_patches`` token embeddings
with precomputed image-patch embeddings (``image_embeds``).  An
encoder-decoder (whisper) runs an encoder stack over precomputed frame
embeddings (``frames``; ``params["enc_layers"]``, one dict per layer:
``ln1``, ``attn``, ``ln2``, ``mlp``, then ``enc_norm``) with
bidirectional self-attention and no RoPE; each decoder layer adds
``lnx`` and ``xattn``, attention to the encoder's output, whose k and v
it computes once (``_enc_kv``) and keeps in its decode cache.  Both
positions tables are sinusoidal where ``cfg.sinusoidal_pos`` is set.

Parameters are plain nested dicts of tensors.  ``param_layout`` is the
single source of truth: every leaf is (shape, logical_axes, init_std),
from which come random init, the abstract parameters (``device="meta"``
tensors, the counterpart of ``jax.ShapeDtypeStruct``) and the axes that
place them on a mesh (``param_axes``; ``cache_axes`` for the decode
cache).  The matmul
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

``prefill`` and ``decode_step`` are the root spans of ``obs.spans``
(recorded only while a profiler records): every layer span of a serving
step nests inside one of them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..obs import spans
from ..runtime.sharding import (at_use, current_rules, full,
                                grad_placed_as, is_dtensor, keep_whole, like,
                                lshard, use_rules,
                                vocab_parallel_cross_entropy)
from . import layers as L
from . import ssd as S
from .config import ModelConfig

COMPUTE_DTYPE = torch.bfloat16
#: layout keys whose weights stay fp32: the norms (read as fp32 by
#: ``rms_norm``) and the SSD leaves the reference reads as fp32 or casts
#: at use
FP32_KEYS = frozenset({"ln1", "ln2", "lnx", "final_norm", "enc_norm",
                       "dt_bias", "A_log", "skip_D", "w_norm", "conv_b"})
#: the families the port runs: all of the reference's
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


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
    out: L.Layout = {"ln1": ((D,), ("embed",), 0.0)}
    if cfg.layer_kind(i) == "ssm":
        out["ssm"] = S.ssd_params_layout(cfg)
    else:
        out["attn"] = L.attn_params_layout(cfg)
    if cfg.family == "ssm":          # mamba2: the SSD block is the layer
        return out
    if cfg.is_encoder_decoder:
        out["lnx"] = ((D,), ("embed",), 0.0)
        out["xattn"] = L.attn_params_layout(cfg, cross=True)
    out["ln2"] = ((D,), ("embed",), 0.0)
    if cfg.layer_is_moe(i):
        out["moe"] = L.moe_params_layout(cfg)
    else:
        out["mlp"] = L.mlp_params_layout(cfg)
    return out


def _enc_layer_layout(cfg: ModelConfig) -> L.Layout:
    """Layout of an encoder layer (the reference's ``enc_body/slot0``)."""
    D = cfg.d_model
    return {"ln1": ((D,), ("embed",), 0.0), "attn": L.attn_params_layout(cfg),
            "ln2": ((D,), ("embed",), 0.0), "mlp": L.mlp_params_layout(cfg)}


def param_layout(cfg: ModelConfig) -> Dict:
    D, V = cfg.d_model, cfg.padded_vocab
    out: Dict = {
        "embed": ((V, D), ("vocab", "embed"), D ** -0.5),
        "final_norm": ((D,), ("embed",), 0.0),
    }
    if not cfg.tie_embeddings:
        out["unembed"] = ((D, V), ("embed", "vocab"), D ** -0.5)
    out["layers"] = [_layer_layout(cfg, l) for l in range(cfg.n_layers)]
    if cfg.is_encoder_decoder:
        out["enc_layers"] = [_enc_layer_layout(cfg)
                             for _ in range(cfg.n_encoder_layers)]
        out["enc_norm"] = ((D,), ("embed",), 0.0)
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


def model_flops_per_token(cfg: ModelConfig) -> float:
    """MODEL_FLOPS convention: 6·N (dense) / 6·N_active (MoE) per token
    of a training step (forward and backward); a forward pass alone is a
    third of it."""
    return 6.0 * count_params(cfg, active_only=True)


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
        shape, _axes, std = leaf
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


def abstract_params(cfg: ModelConfig, dtype: torch.dtype = torch.float32
                    ) -> Dict:
    """The parameters as ``device="meta"`` tensors (shapes and dtypes,
    no storage): matmul weights and embeddings in ``dtype``,
    ``FP32_KEYS`` leaves in fp32, as ``init_params`` makes them."""
    return _walk(param_layout(cfg), lambda path, leaf: torch.empty(
        leaf[0], dtype=_leaf_dtype(path, dtype), device="meta"))


def param_axes(cfg: ModelConfig) -> Dict:
    """The logical axes of every parameter, in the parameters' layout."""
    return _walk(param_layout(cfg), lambda path, leaf: leaf[1])


def params_to_jax(params: Dict, cfg: ModelConfig) -> Dict:
    """The inverse of ``params_from_jax``: the reference's parameter tree
    as fresh host numpy arrays, layer ``l`` stacked into body
    ``l // scan_period``, slot ``l % scan_period`` (``body/slot{i}``),
    and the encoder's layers stacked into ``enc_body/slot0``.  Each leaf
    keeps the dtype held; bf16, which numpy lacks, widens to
    fp32 (exactly).  Also takes any tree shaped like the parameters (the
    optimizer's moments)."""
    period = cfg.scan_period
    layers = params["layers"]
    if len(layers) % period:
        raise ValueError(f"{len(layers)} layers do not fill bodies of "
                         f"{period} slots")

    def host(t: torch.Tensor) -> np.ndarray:
        t = full(t).detach()
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

    out = {k: host(params[k]) for k in _TOP_KEYS if k in params}
    out["body"] = {f"slot{s}": stack_tree(layers[s::period])
                   for s in range(period)}
    if "enc_layers" in params:
        out["enc_body"] = {"slot0": stack_tree(params["enc_layers"])}
    return out


#: what a layer holds, and the leaves outside the layers
_LAYER_KEYS = ("ln1", "attn", "ssm", "lnx", "xattn", "ln2", "mlp", "moe")
_TOP_KEYS = ("embed", "final_norm", "unembed", "enc_norm")


def params_from_jax(tree: Dict, *, device=None,
                    dtype: torch.dtype = COMPUTE_DTYPE) -> Dict:
    """The port's parameters from the reference's parameter pytree as
    numpy arrays (``jax.tree.map(np.asarray, params)``).  A stacked body
    leaf ``[n_bodies, ...]`` of slot ``s`` becomes layer
    ``body * scan_period + s``, and encoder layer ``l`` is body ``l`` of
    ``enc_body/slot0``; weights keep the ``x @ w`` orientation; matmul
    weights go to ``dtype``, ``FP32_KEYS`` leaves stay fp32."""
    dev = resolve_device(device)

    def conv(path, a):
        a = np.array(a, copy=True, order="C")
        return torch.from_numpy(a).to(device=dev,
                                      dtype=_leaf_dtype(path, dtype))

    def unstack(body):
        period = len(body)
        if sorted(body) != [f"slot{i}" for i in range(period)]:
            raise ValueError(f"unexpected body slots {sorted(body)}")
        slots = [body[f"slot{i}"] for i in range(period)]
        if any(k not in _LAYER_KEYS for s in slots for k in s):
            raise ValueError(
                f"a layer holds {', '.join(_LAYER_KEYS)}; got "
                f"{sorted(set(k for s in slots for k in s))}")
        n_bodies = len(np.asarray(slots[0]["ln1"]))
        return [_walk(slots[s], lambda path, a: conv(path, np.asarray(a)[b]))
                for b in range(n_bodies) for s in range(period)]

    out = {k: conv((k,), tree[k]) for k in _TOP_KEYS if k in tree}
    out["layers"] = unstack(tree["body"])
    if "enc_body" in tree:
        out["enc_layers"] = unstack(tree["enc_body"])
    return out


# ----------------------------------------------------------------- forward
def _embed(params, cfg: ModelConfig, tokens, image_embeds=None):
    """Token embeddings in the compute type; with ``image_embeds``
    (B, n_image_patches, D) on a VLM the first ``n_image_patches``
    positions are those embeddings instead, cast to the compute type.
    The prompt must hold the patches: a shorter one raises (the
    reference fails later, in RoPE)."""
    tokens = lshard(tokens, "batch", None)
    table = params["embed"]
    if is_dtensor(table):
        # whole along the vocabulary on every rank first: DTensor cannot
        # reduce a lookup's masked partial rows into a batch shard
        table = keep_whole(table, 0, 1)
    # ``F.embedding``, not indexing: the same rows, and a backward that
    # DTensor can shard (indexing's ``index_put`` has no rule for a
    # batch-sharded gradient in torch 2.11)
    x = F.embedding(tokens.long(), at_use(table, table.dtype)).to(
        COMPUTE_DTYPE)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=COMPUTE_DTYPE,
                             device=x.device)
    if image_embeds is not None and cfg.n_image_patches:
        n = cfg.n_image_patches
        B, S, D = x.shape
        if S < n or tuple(image_embeds.shape) != (B, n, D):
            raise ValueError(
                f"{cfg.arch_id}: image_embeds {list(image_embeds.shape)} "
                f"must be ({B}, {n}, {D}) and fill the first {n} positions "
                f"of the prompt, which has {S}")
        image_embeds = lshard(image_embeds, "batch", None, None)
        x = torch.cat([image_embeds.to(device=x.device, dtype=COMPUTE_DTYPE),
                       x[:, n:]], 1)
    return x


def _unembed(params, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        logits = x @ at_use(params["embed"], COMPUTE_DTYPE).T  # (V_pad, D)
    else:
        logits = x @ at_use(params["unembed"], COMPUTE_DTYPE)
    logits = L.softcap(logits.float(), cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:                 # mask pad rows
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(like(pad, logits), -1e30)
    return lshard(logits, "batch", "seq", "vocab")


def _positions(B: int, S: int, device) -> torch.Tensor:
    pos = torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)
    return lshard(pos, "batch", "seq")


def _summed(x):
    """The residual stream placed as the layers read it, batch-sharded
    and whole along d_model: a row-parallel product's output (the
    attention's ``wo``, the SSD block's ``w_out``, the MLP's ``w_down``)
    leaves a partial sum over the tensor-parallel ranks, which is
    all-reduced here, before a norm, as Megatron does; DTensor would
    otherwise carry the partial sum into the next products and gather
    their weights whole.  Its gradient is all-reduced here too
    (``grad_placed_as``), for the same reason in the backward pass."""
    return grad_placed_as(lshard(x, "batch", "seq", None))


def _cross(lp, x, cfg: ModelConfig, enc_kv):
    """A decoder layer's attention to the encoder (``lnx`` then
    ``xattn`` over ``enc_kv``), where the layer has it."""
    if "xattn" not in lp:
        return x
    x = _summed(x)
    hx = L.rms_norm(x, lp["lnx"], cfg.norm_eps)
    return x + L.cross_attention_layer(lp["xattn"], hx, enc_kv, cfg)


def _ffn(lp, x, cfg: ModelConfig):
    """The layer's second half, ``ln2`` then its MoE or MLP: (x, aux),
    aux None without MoE.  A layer without ``ln2`` (mamba2) has none."""
    if "ln2" not in lp:
        return x, None
    x = _summed(x)
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        out, aux = L.moe_layer(lp["moe"], h2, cfg)
        return x + out, aux
    return x + L.mlp_layer(lp["mlp"], h2, cfg), None


def _layer_forward(lp, x, cfg: ModelConfig, l: int, positions, impl,
                   enc_kv=None):
    """One decoder layer over the full sequence: (x, aux or None)."""
    i = l % cfg.scan_period
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.layer_kind(i) == "ssm":
        x = x + S.ssd_layer(lp["ssm"], h, cfg)
    else:
        x = x + L.attention_layer(lp["attn"], h, cfg, positions=positions,
                                  window=cfg.layer_window(i), impl=impl)
    return _ffn(lp, _cross(lp, x, cfg, enc_kv), cfg)


def _enc_layer(lp, x, cfg: ModelConfig, positions, impl):
    """One encoder layer: bidirectional self-attention with no RoPE
    (through ``attention_core``, so ``flash`` launches the kernel with
    no causal mask), then the MLP."""
    B, F, _ = x.shape
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = L._proj_qkv(lp["attn"], h, cfg, rope=False,
                          positions=positions)
    o = L.run_attention(q, k, v, positions, positions, cfg, causal=False,
                        impl=impl)
    x = _summed(x + o.reshape(B, F, -1) @ at_use(lp["attn"]["wo"], x.dtype))
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + L.mlp_layer(lp["mlp"], h2, cfg)


def _encode(params, cfg: ModelConfig, frames, impl="naive"):
    """The encoder over frame embeddings (B, F, D): sinusoidal positions
    added in the compute type, the encoder layers, ``enc_norm``."""
    if frames is None:
        raise ValueError(f"{cfg.arch_id} is an encoder-decoder: pass "
                         "frames (B, n_frames, d_model)")
    B, F, D = frames.shape
    frames = lshard(frames, "batch", "frames", None)
    x = frames.to(COMPUTE_DTYPE) + like(L.sinusoidal_positions(
        F, D, device=frames.device)[None].to(COMPUTE_DTYPE), frames)
    positions = _positions(B, F, x.device)
    for lp in params["enc_layers"]:
        x = _summed(_enc_layer(lp, x, cfg, positions, impl))
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _enc_kv(params, cfg: ModelConfig, enc_out) -> List:
    """Each decoder layer's cross-attention k and v from the encoder's
    output: a list of ``(k, v)``, each (B, F, KV, hd)."""
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    out = []
    for lp in params["layers"]:
        p = lp["xattn"]
        out.append((L._split_heads(enc_out @ at_use(p["wk"], enc_out.dtype),
                                   KV, hd),
                    L._split_heads(enc_out @ at_use(p["wv"], enc_out.dtype),
                                   KV, hd)))
    return out


def _decoder_input(params, cfg: ModelConfig, tokens, frames, image_embeds,
                   impl):
    """The embedded prompt with its sinusoidal positions where the config
    has them, and each decoder layer's cross k/v (None but for an
    encoder-decoder)."""
    x = _embed(params, cfg, tokens, image_embeds)
    if cfg.sinusoidal_pos:
        x = x + like(L.sinusoidal_positions(x.shape[1], cfg.d_model,
                                            device=x.device)[None].to(x.dtype),
                     x)
    x = lshard(x, "batch", "seq", None)
    if not cfg.is_encoder_decoder:
        return x, None
    return x, _enc_kv(params, cfg, _encode(params, cfg, frames, impl=impl))


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


def forward(params, cfg: ModelConfig, tokens, *, frames=None,
            image_embeds=None, impl="naive", remat: bool = False,
            remat_policy: Optional[str] = None):
    """Full-sequence forward: tokens (B,S) -> (logits (B,S,V) f32, aux),
    aux being the reference's auxiliary loss: the sum over MoE layers of
    each one's load-balance loss, in layer order (0 without MoE).
    ``frames`` (B, n_frames, D) feed an encoder-decoder's encoder;
    ``image_embeds`` (B, n_image_patches, D) a VLM's first positions.

    ``remat``: recompute each decoder layer (with its cross k/v as an
    input) in the backward pass, keeping what ``remat_policy`` (a name
    of ``REMAT_POLICIES``; None means ``dots``, the reference's default)
    saves.  The encoder is not recomputed, as in the reference."""
    policy = remat_policy or "dots"
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}: "
                         f"{', '.join(REMAT_POLICIES)}")
    recompute = remat and policy != "everything" and torch.is_grad_enabled()
    ckpt_kw = {"context_fn": _dots_context} if policy == "dots" else {}
    B, Sq = tokens.shape
    x, enc_kv = _decoder_input(params, cfg, tokens, frames, image_embeds,
                               impl)
    positions = _positions(B, Sq, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    rules = current_rules()

    def layer_forward(*args):
        # the recompute runs on autograd's thread on the card: the rules
        # (thread-local) go with it
        with use_rules(rules):
            return _layer_forward(*args)

    for l, lp in enumerate(params["layers"]):
        kv = None if enc_kv is None else enc_kv[l]
        if recompute:
            x, a = checkpoint(layer_forward, lp, x, cfg, l, positions, impl,
                              kv, use_reentrant=False, **ckpt_kw)
        else:
            x, a = _layer_forward(lp, x, cfg, l, positions, impl, kv)
        x = _summed(x)
        if a is not None:
            aux = aux + a
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x), aux


# -------------------------------------------------------------------- loss
def token_losses(logits, labels):
    """Each position's cross entropy (log-sum-exp minus the label's
    logit), (B, S).  DTensor logits under rules take the vocab-parallel
    path (``sharding.vocab_parallel_cross_entropy``: a max and two sums
    over the vocabulary's ranks, as XLA reduces the reference's; with
    the vocabulary whole, the local reductions alone); left to DTensor,
    ``logsumexp`` would gather every row whole."""
    if is_dtensor(logits):
        return vocab_parallel_cross_entropy(
            logits, lshard(labels, "batch", None))
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - ll


def loss_fn(params, cfg: ModelConfig, tokens, labels, **fw_kw):
    """Mean next-token cross-entropy (``token_losses``) plus the
    auxiliary loss: ``(total, (loss, aux))``."""
    logits, aux = forward(params, cfg, tokens, **fw_kw)
    loss = torch.mean(token_losses(logits, labels))
    return loss + aux, (loss, aux)


# ----------------------------------------------------------- decode caches
def _cache_slots(cfg: ModelConfig, l: int, max_seq: int) -> int:
    w = cfg.layer_window(l % cfg.scan_period)
    return min(max_seq, w) if w else max_seq               # ring buffer


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype: torch.dtype = COMPUTE_DTYPE, device=None,
               abstract: bool = False) -> List:
    """One dict per layer.  An attention layer's ``{"k", "v"}`` are each
    (batch, slots, KV, hd): ``max_seq`` slots for full attention,
    ``min(max_seq, window)`` (a ring buffer) for sliding-window layers;
    a decoder layer of an encoder-decoder adds its cross k/v,
    ``"cross_k"`` and ``"cross_v"``, each (batch, n_frames, KV, hd).
    An SSD layer's dict holds ``"conv"`` (batch, K-1, conv_dim) in
    ``dtype`` and ``"state"`` (batch, H, P, N) in fp32.  With ``abstract``
    the tensors are ``device="meta"`` (shapes and dtypes only)."""
    dev = torch.device("meta") if abstract else resolve_device(device)
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim

    def zeros(*shape, dt=dtype):
        return torch.zeros(*shape, dtype=dt, device=dev)

    def layer(l):
        if cfg.layer_kind(l % cfg.scan_period) == "ssm":
            return {"conv": zeros(batch, cfg.ssm_conv - 1, cfg.conv_dim),
                    "state": zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                   cfg.ssm_state, dt=torch.float32)}
        out = {name: zeros(batch, _cache_slots(cfg, l, max_seq), KV, hd)
               for name in ("k", "v")}
        if cfg.is_encoder_decoder:
            out.update({name: zeros(batch, cfg.n_frames, KV, hd)
                        for name in ("cross_k", "cross_v")})
        return out

    return [layer(l) for l in range(cfg.n_layers)]


def cache_axes(cfg: ModelConfig) -> List:
    """Logical axes matching ``init_cache``'s structure."""
    kv = ("batch", "seq_kv", "kv_heads", "head_dim")
    cross = ("batch", "frames", "kv_heads", "head_dim")

    def layer(l):
        if cfg.layer_kind(l % cfg.scan_period) == "ssm":
            return {"conv": ("batch", None, "ssm_inner"),
                    "state": ("batch", "ssm_heads", None, "state")}
        out = {"k": kv, "v": kv}
        if cfg.is_encoder_decoder:
            out.update({"cross_k": cross, "cross_v": cross})
        return out

    return [layer(l) for l in range(cfg.n_layers)]


def _max_pos(cache: List) -> int:
    """Positions the decoder's sinusoidal table covers: the first
    attention cache's length (4096 without one), as in the reference."""
    for layer in cache:
        if "k" in layer:
            return layer["k"].shape[1]
    return 4096


@spans.span("decode_step")
def decode_step(params, cfg: ModelConfig, token, cache, pos):
    """One decode step.  token (B,1) int; pos (B,) int = position of
    this token.  Returns (logits (B,1,V) f32, cache); the cache tensors
    are written in place."""
    x = _embed(params, cfg, token)
    pos = lshard(pos, "batch")
    if cfg.sinusoidal_pos:
        pe = like(L.sinusoidal_positions(_max_pos(cache), cfg.d_model,
                                         device=x.device), pos)
        x = x + pe[pos.long()][:, None, :].to(x.dtype)
    x = lshard(x, "batch", "seq", None)
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
            layer_cache = {**cache[l], "k": ck, "v": cv}
        new_cache.append(layer_cache)
        x = x + out
        if "xattn" in lp:
            x = _cross(lp, x, cfg, (cache[l]["cross_k"], cache[l]["cross_v"]))
        x, _ = _ffn(lp, x, cfg)
        x = lshard(x, "batch", "seq", None)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x), new_cache


@spans.span("prefill")
def prefill(params, cfg: ModelConfig, tokens, *, frames=None,
            image_embeds=None, max_seq: Optional[int] = None, impl="naive"):
    """Run the full prompt, return (logits_last (B,V), cache) with the KV
    cache sized to max_seq (>= prompt length).  ``frames`` and
    ``image_embeds`` as for ``forward``; an encoder-decoder's cache
    keeps each decoder layer's cross k/v."""
    B, Sq = tokens.shape
    max_seq = max_seq or Sq
    x, enc_kv = _decoder_input(params, cfg, tokens, frames, image_embeds,
                               impl)
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
            idx = like(torch.arange(Sq - tail, Sq, device=k.device) % slots,
                       k)
            kp[:, idx], vp[:, idx] = k[:, Sq - tail:], v[:, Sq - tail:]
        return {"k": lshard(kp, "batch", "seq_kv", "kv_heads", "head_dim"),
                "v": lshard(vp, "batch", "seq_kv", "kv_heads", "head_dim")}

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
            x = x + o.reshape(B, Sq, -1) @ at_use(lp["attn"]["wo"], x.dtype)
            layer_cache = to_cache(k, v, l)
        if enc_kv is not None:
            layer_cache["cross_k"], layer_cache["cross_v"] = enc_kv[l]
            x = _cross(lp, x, cfg, enc_kv[l])
        cache.append(layer_cache)
        x, _ = _ffn(lp, x, cfg)
        x = lshard(x, "batch", "seq", None)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _unembed(params, cfg, x[:, -1:, :])
    return logits[:, 0, :], cache
