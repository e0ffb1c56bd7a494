"""Input specs and placements for every (arch x shape x mesh) cell: the
port of ``repro/runtime/specs.py``.

``batch_struct`` and the ``*_cell`` functions give ``device="meta"``
stand-ins for every model input (shapes and dtypes, no storage), the
counterpart of the reference's ``jax.ShapeDtypeStruct``s, in the port's
layout (one dict per layer).  Where the reference gives a
``NamedSharding``, the port gives DTensor placements (``shardings_of``,
a tree of placement lists).  ``cell_rules`` adapts the logical->mesh
mapping to the cell (the batch unsharded when it does not divide the DP
axes), and ``place`` distributes host or device tensors by a tree of
logical axes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..models import transformer as T
from ..models.config import ModelConfig, ShapeConfig
from ..optim import adamw
from .sharding import LogicalRules, mesh_names, mesh_size


def cell_rules(cfg: ModelConfig, shape: ShapeConfig, mesh,
               overrides: Optional[Dict[str, Any]] = None) -> LogicalRules:
    rules = LogicalRules(mesh, overrides)
    dp = mesh_size(mesh, rules.rules["batch"])
    if shape.global_batch % dp != 0:
        # e.g. long_500k batch=1: replicate the batch dimension
        rules.rules["batch"] = None
    return rules


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg: ModelConfig, shape: ShapeConfig,
                 kind: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Abstract training/prefill batch: tokens/labels (+ stub modality
    frontends)."""
    kind = kind or shape.kind
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": _meta((B, S), torch.int32)}
    if kind == "train":
        out["labels"] = _meta((B, S), torch.int32)
    if cfg.is_encoder_decoder:
        out["frames"] = _meta((B, cfg.n_frames, cfg.d_model), torch.bfloat16)
    if cfg.n_image_patches:
        out["image_embeds"] = _meta((B, cfg.n_image_patches, cfg.d_model),
                                    torch.bfloat16)
    return out


def batch_axes(cfg: ModelConfig, shape: ShapeConfig,
               kind: Optional[str] = None) -> Dict[str, Tuple]:
    kind = kind or shape.kind
    out = {"tokens": ("batch", None)}
    if kind == "train":
        out["labels"] = ("batch", None)
    if cfg.is_encoder_decoder:
        out["frames"] = ("batch", "frames", None)
    if cfg.n_image_patches:
        out["image_embeds"] = ("batch", None, None)
    return out


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def map_axes(fn, axes_tree, *trees):
    """``fn(axes, *leaves)`` over an axes tree (dicts and lists whose
    leaves are tuples of logical names) and trees of its structure."""
    if _is_axes(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v, *(t[k] for t in trees))
                for k, v in axes_tree.items()}
    return [map_axes(fn, v, *(t[i] for t in trees))
            for i, v in enumerate(axes_tree)]


def replicate(rules: LogicalRules) -> list:
    """Placements of a value replicated on every rank (``P()``)."""
    from torch.distributed.tensor import Replicate
    return [Replicate() for _ in mesh_names(rules.mesh)]


def shardings_of(rules: LogicalRules, axes_tree):
    """The placements of every leaf of an axes tree."""
    return map_axes(rules.placements, axes_tree)


def place(rules: LogicalRules, tree, axes_tree):
    """Distribute every tensor of ``tree`` (equal on every rank) over the
    rules' mesh by its logical axes, leaf by leaf."""
    from torch.distributed.tensor import distribute_tensor
    return map_axes(lambda axes, t: distribute_tensor(
        t, rules.mesh, rules.placements(axes)), axes_tree, tree)


def train_cell(cfg: ModelConfig, shape: ShapeConfig, rules: LogicalRules,
               param_dtype=None):
    """(abstract_args, in_placements, out_placements) for train_step."""
    params = T.abstract_params(cfg, param_dtype or torch.float32)
    opt = adamw.abstract_state(params)
    batch = batch_struct(cfg, shape)
    p_shard = shardings_of(rules, T.param_axes(cfg))
    opt_shard = adamw.AdamWState(step=replicate(rules), m=p_shard,
                                 v=shardings_of(rules, T.param_axes(cfg)))
    b_shard = shardings_of(rules, batch_axes(cfg, shape))
    metrics_shard = {k: replicate(rules) for k in ("loss", "grad_norm", "lr")}
    return ((params, opt, batch),
            (p_shard, opt_shard, b_shard),
            (p_shard, opt_shard, metrics_shard))


def prefill_cell(cfg: ModelConfig, shape: ShapeConfig, rules: LogicalRules,
                 param_dtype=None):
    params = T.abstract_params(cfg, param_dtype or torch.float32)
    batch = batch_struct(cfg, shape, kind="prefill")
    p_shard = shardings_of(rules, T.param_axes(cfg))
    b_shard = shardings_of(rules, batch_axes(cfg, shape, kind="prefill"))
    cache_shard = shardings_of(rules, T.cache_axes(cfg))
    logits_shard = rules.placements(("batch", "vocab"))
    return ((params, batch), (p_shard, b_shard),
            (logits_shard, cache_shard))


def decode_cell(cfg: ModelConfig, shape: ShapeConfig, rules: LogicalRules,
                param_dtype=None):
    B, S = shape.global_batch, shape.seq_len
    params = T.abstract_params(cfg, param_dtype or torch.float32)
    cache = T.init_cache(cfg, B, S, abstract=True)
    token = _meta((B, 1), torch.int32)
    pos = _meta((B,), torch.int32)
    p_shard = shardings_of(rules, T.param_axes(cfg))
    cache_shard = shardings_of(rules, T.cache_axes(cfg))
    tok_shard = rules.placements(("batch", None))
    pos_shard = rules.placements(("batch",))
    logits_shard = rules.placements(("batch", "vocab"))
    return ((params, cache, token, pos),
            (p_shard, cache_shard, tok_shard, pos_shard),
            (logits_shard, cache_shard))
