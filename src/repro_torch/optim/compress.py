"""Error-feedback int8 gradient compression for the data-parallel
all-reduce: the port of ``repro/optim/compress.py`` over
``torch.distributed``.

``compressed_psum`` quantizes each leaf to int8 with a per-leaf scale
(the group's largest ``|g|`` over 127, shared by an all-reduce with
``MAX``), all-reduces the payload, dequantizes, and keeps the local
quantization residual in an error-feedback buffer that is added to the
next step's gradient — the standard EF-SGD construction.

The payload is all-reduced as int32, as the reference psums it
(``q.astype(int32)``): an int8 sum would overflow at two ranks of
±127.  So, like the reference, it moves as many bytes as a float32
all-reduce, not the eighth its docstring claims (ROADMAP.md, caveats).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from .adamw import leaves, tree_map


def _quantize(g: torch.Tensor, scale=None):
    if scale is None:
        scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _unflatten(tree, flat):
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


def compressed_psum(grads, err, group=None) -> Tuple[Any, Any]:
    """Returns (mean-reduced grads, new error buffers) over the ranks of
    ``group`` (the default group for None).  ``err`` matches ``grads``;
    pass zeros initially.

    Scheme: all-reduce one scale scalar per leaf with MAX (negligible
    traffic), quantize, all-reduce the int32 payload with SUM,
    dequantize; the local quantization residual goes into the
    error-feedback buffer."""
    n = dist.get_world_size(group)
    means, errs = [], []
    for g, e in zip(leaves(grads), leaves(err)):
        g = g.float() + e
        gmax = torch.max(torch.abs(g))
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
        scale = gmax / 127.0 + 1e-12
        q, _ = _quantize(g, scale)
        deq_local = q.float() * scale
        errs.append(g - deq_local)                 # residual stays local
        q_sum = q.to(torch.int32)
        dist.all_reduce(q_sum, op=dist.ReduceOp.SUM, group=group)
        means.append(q_sum.float() * scale / n)
    return _unflatten(grads, means), _unflatten(grads, errs)


def plain_psum_mean(grads, group=None):
    """The exact mean of ``grads`` over the ranks of ``group``."""
    n = dist.get_world_size(group)

    def mean(g):
        s = g.clone()
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
        return s / n

    return tree_map(mean, grads)


def payload_bytes(grads) -> int:
    """Bytes ``compressed_psum`` all-reduces for ``grads``: each leaf's
    int32 payload and its float32 scale."""
    return sum(4 * g.numel() + 4 for g in leaves(grads))
