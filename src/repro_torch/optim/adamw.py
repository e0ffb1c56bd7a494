"""AdamW with decoupled weight decay, a cosine schedule and global-norm
clipping: the port of ``repro/optim/adamw.py``.

The reference maps pure functions over the parameter pytree and returns
new trees.  The port works one leaf at a time and in place on the
gradients, the moments and the parameters: one fp32 copy of a 4.3 B
parameter tree is 17.25 GB, and a step already holds four (parameters,
gradients, m, v).  Each leaf keeps the reference's order of operations,
so fp32 results agree with it to rounding.

``AdamWState.step`` is a host integer: the learning rate and the bias
corrections are computed on the host in float32, as the reference
computes them on the device, and the card never waits on a copy of the
step.  Trees are nested dicts and lists of tensors (the port's
parameter layout); ``leaves`` walks them in one fixed order.

Leaves may be DTensors (a trainer on a mesh): the moments take the
parameters' placements, each update runs on each rank's shards, and the
global norm sums each leaf's square over its ranks (a reduction across
them) before it is added on the host's order of leaves.
"""

from __future__ import annotations

import math
from typing import Any, List, NamedTuple, Tuple

import numpy as np
import torch

from ..runtime.sharding import full

_F32 = np.float32


class AdamWState(NamedTuple):
    step: int
    m: Any
    v: Any


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts and lists, dicts in key order of
    insertion, lists in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` over every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def init(params) -> AdamWState:
    """Zero fp32 moments shaped (and placed) like ``params``, on their
    devices."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)
    return AdamWState(step=0, m=tree_map(zeros, params),
                      v=tree_map(zeros, params))


def abstract_state(abstract_params) -> AdamWState:
    """The state of ``init`` as ``device="meta"`` tensors: fp32 moments
    shaped like the parameters, and the step as a 0-d int32."""
    def meta(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")
    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      m=tree_map(meta, abstract_params),
                      v=tree_map(meta, abstract_params))


def cosine_lr(step: int, *, peak: float, warmup: int, total: int,
              floor_frac: float = 0.1) -> float:
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine to
    ``floor_frac * peak`` at ``total``; in float32, as the reference's
    jitted step computes it: XLA folds each division by a constant into a
    product with its reciprocal, and ``peak`` into that product.  The
    warmup is bit-equal to the reference's; the cosine (rounded from
    float64 here, XLA's own float32 ``cos`` there) may differ in its last
    bits."""
    if step < warmup:
        return float(_F32(step + 1) *
                     (_F32(peak) * (_F32(1.0) / _F32(max(warmup, 1)))))
    t = _F32(step - warmup) * (_F32(1.0) / _F32(max(total - warmup, 1)))
    t = min(max(t, _F32(0.0)), _F32(1.0))
    cos = _F32(peak) * (_F32(floor_frac) + _F32((1 - floor_frac) * 0.5) *
                        (_F32(1.0) + _F32(math.cos(_F32(math.pi) * t))))
    return float(cos)


def clip_by_global_norm(grads, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """Scale ``grads`` in place so that their global norm is at most
    ``max_norm``; returns ``(grads, norm before clipping)``, the norm a
    0-d fp32 tensor summed leaf by leaf."""
    gl = leaves(grads)
    total = torch.zeros((), dtype=torch.float32, device=gl[0].device)
    for g in gl:
        total += full(torch.sum(torch.square(g.float())))
    gn = torch.sqrt(total)
    scale = torch.minimum(
        torch.ones_like(gn),
        torch.full_like(gn, max_norm) / (gn + 1e-9))
    for g in gl:
        g.mul_(scale)
    return grads, gn


@torch.no_grad()
def update(grads, state: AdamWState, params, *, lr: float, b1: float = 0.9,
           b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
           max_norm: float = 1.0):
    """One AdamW step, in place: clips ``grads``, updates ``state.m``,
    ``state.v`` and ``params``.  Returns ``(params, new state, grad
    norm before clipping)``; the trees are the ones passed in."""
    grads, gnorm = clip_by_global_norm(grads, max_norm)
    step = state.step + 1
    bc1 = float(_F32(1.0) - _F32(b1) ** _F32(step))
    bc2 = float(_F32(1.0) - _F32(b2) ** _F32(step))
    for g, m, v, p in zip(leaves(grads), leaves(state.m), leaves(state.v),
                          leaves(params)):
        g = g.float()
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
        del g
        denom = torch.sqrt(v / bc2).add_(eps)
        u = (m / bc1).div_(denom)
        del denom
        u.add_(weight_decay * p)
        p.sub_(u.mul_(lr))
    return params, AdamWState(step=step, m=state.m, v=state.v), gnorm
