"""Logical-axis sharding (MaxText-style rules) over a ``DeviceMesh``: the
port of ``repro/runtime/sharding.py``.

Model code annotates parameters and activations with *logical* axis
names; a ``LogicalRules`` context maps them to mesh axes.  Outside a
rules context every annotation is a no-op, so the same model code runs
on one device, on a one-rank mesh and on many ranks.

The reference maps a spec to a ``NamedSharding`` and lets XLA partition
the program; the port maps it to DTensor placements, one per mesh
dimension (``placements``), and ``lshard`` redistributes a ``DTensor``
to them.  ``spec`` keeps the reference's per-dimension entries (``None``,
a mesh axis name, or a tuple of names) so the two can be compared entry
for entry.  ``map_local_heads`` runs an attention function on each
rank's local batch and heads, with the kv heads of its own q heads.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]

# default rules for the single-pod (data, model) mesh
DEFAULT_RULES: Dict[str, Axis] = {
    "batch": "data",          # global batch
    "seq": None,              # sequence (replicated by default)
    "seq_kv": "model",        # cached KV sequence in decode
    "embed": "data",          # d_model rows of weights (FSDP shards here)
    "mlp": "model",           # d_ff / ffn hidden (tensor parallel)
    "heads": "model",         # attention heads (tensor parallel)
    "kv_heads": None,         # kv heads (replicated; small for GQA)
    "head_dim": None,
    "qkv": "model",           # fused q/k/v output dim
    "vocab": "model",         # embedding/logit vocab dim
    "experts": "model",       # expert parallelism
    "expert_mlp": None,       # per-expert ffn hidden
    "layers": None,           # stacked scan bodies
    "conv": None,
    "ssm_inner": "model",     # SSD inner width
    "ssm_heads": "model",
    "state": None,
    "frames": None,
}

# multi-pod: DP spans ("pod", "data")
MULTIPOD_OVERRIDES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
}


def mesh_names(mesh) -> Tuple[str, ...]:
    """A mesh's axis names, in mesh-dimension order."""
    return tuple(mesh.mesh_dim_names)


def mesh_size(mesh, ax: Axis) -> int:
    """Ranks along mesh axis ``ax`` (a name or a tuple of names; 1 for
    ``None``)."""
    if ax is None:
        return 1
    names = mesh_names(mesh)
    flat = (ax,) if isinstance(ax, str) else tuple(ax)
    n = 1
    for a in flat:
        n *= int(mesh.shape[names.index(a)])
    return n


class LogicalRules:
    """The logical-to-mesh mapping over ``mesh``: a ``DeviceMesh`` with
    ``mesh_dim_names`` (or anything with ``mesh_dim_names`` and a
    ``shape`` tuple, for specs alone)."""

    def __init__(self, mesh, rules: Optional[Dict[str, Axis]] = None):
        if not getattr(mesh, "mesh_dim_names", None):
            raise ValueError("LogicalRules needs a mesh with mesh_dim_names")
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if "pod" in mesh_names(mesh):
            self.rules.update(MULTIPOD_OVERRIDES)
        if rules:
            self.rules.update(rules)

    def spec(self, logical_axes: Sequence[Optional[str]]) -> Tuple[Axis, ...]:
        """One entry per tensor dimension: ``None``, a mesh axis name or
        a tuple of them, the reference's ``PartitionSpec`` entries."""
        out = []
        used = set()
        for name in logical_axes:
            ax = self.rules.get(name) if name else None
            # a mesh axis may be used at most once per spec
            if ax is not None:
                flat = (ax,) if isinstance(ax, str) else tuple(ax)
                if any(a in used for a in flat):
                    ax = None
                else:
                    used.update(flat)
            out.append(ax)
        return tuple(out)

    def placements(self, logical_axes: Sequence[Optional[str]]) -> List:
        """DTensor placements of ``spec(logical_axes)``, one per mesh
        dimension: ``Shard(d)`` where tensor dimension ``d`` names that
        mesh axis, ``Replicate()`` otherwise."""
        from torch.distributed.tensor import Replicate, Shard
        names = mesh_names(self.mesh)
        out = [Replicate() for _ in names]
        for d, ax in enumerate(self.spec(logical_axes)):
            if ax is None:
                continue
            flat = (ax,) if isinstance(ax, str) else tuple(ax)
            dims = [names.index(a) for a in flat]
            if dims != sorted(dims):
                # DTensor shards one tensor dimension over several mesh
                # dimensions in mesh order only
                raise ValueError(f"mesh axes {flat} of dimension {d} are "
                                 f"not in the mesh's order {names}")
            for i in dims:
                out[i] = Shard(d)
        return out


_tls = threading.local()


def current_rules() -> Optional[LogicalRules]:
    return getattr(_tls, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[LogicalRules]):
    prev = getattr(_tls, "rules", None)
    _tls.rules = rules
    try:
        yield rules
    finally:
        _tls.rules = prev


def axis_size(logical_name: str) -> int:
    """Mesh extent the given logical axis maps to (1 without rules)."""
    rules = current_rules()
    if rules is None:
        return 1
    return mesh_size(rules.mesh, rules.rules.get(logical_name))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicated(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x``, equal on every rank, as a DTensor replicated over ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def like(x: torch.Tensor, ref) -> torch.Tensor:
    """``x`` (equal on every rank) replicated over ``ref``'s mesh when
    ``ref`` is a DTensor, else ``x`` itself: what a tensor made from
    sizes or positions needs before it meets a DTensor."""
    if is_dtensor(ref) and not is_dtensor(x):
        return replicated(x, ref.device_mesh)
    return x


def at_use(w, dtype):
    """Weight ``w`` cast to ``dtype`` for use in a product.  Under rules,
    a DTensor's shards over the mesh axes that shard ``batch`` (FSDP's
    shards of ``embed``) are gathered after the cast: the all-gather XLA
    inserts for the reference's annotations.  Left to itself, DTensor
    may move the activations onto the weight's shards instead (its
    cheapest redistribution by bytes), and every rank then multiplies
    the whole batch."""
    w = w.to(dtype)
    rules = current_rules()
    if rules is None or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate, Shard
    batch = rules.placements(("batch",))
    want = [Replicate() if b == Shard(0) else p
            for p, b in zip(w.placements, batch)]
    return w if want == list(w.placements) else \
        w.redistribute(w.device_mesh, want)


def grad_placed_as(x):
    """``x`` itself in the forward pass; in the backward pass its gradient
    is redistributed to ``x``'s own placements.  A partial sum over the
    tensor-parallel ranks, which the products reading ``x`` leave in its
    gradient, is all-reduced here (Megatron's f) before it reaches a
    row-parallel product's backward: carried into it, DTensor gathers
    that product's weight whole and every tensor-parallel rank repeats
    its work.  A no-op off a DTensor, or where no gradient is taken."""
    if not is_dtensor(x) or not x.requires_grad:
        return x
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def full(x):
    """The whole tensor of a DTensor (a collective over its mesh), or
    ``x`` itself."""
    return x.full_tensor() if is_dtensor(x) else x


def keep_whole(x, dim: int, groups: int):
    """DTensor ``x`` with dimension ``dim`` replicated along every mesh
    dimension whose shards would cut one of its ``groups`` equal groups
    (heads of a fused projection that do not split over the ranks), so
    that a reshape into ``(groups, -1)`` keeps each group on one rank."""
    from torch.distributed.tensor import Replicate, Shard
    dim %= x.ndim
    cut = [Replicate() if p == Shard(dim) and groups % x.device_mesh.size(i)
           else p for i, p in enumerate(x.placements)]
    return x if cut == list(x.placements) else \
        x.redistribute(x.device_mesh, cut)


def _fitted(placements, shape, mesh) -> List:
    """``placements`` with each ``Shard(d)`` replicated instead where
    dimension ``d`` has a single row or does not split into equal shards
    over its mesh dimension: a microbatch of one stays whole (DTensor
    cannot view a sharded dimension of one row away), as the reference's
    ``cell_rules`` keeps a batch that does not divide the DP axes
    whole."""
    from torch.distributed.tensor import Replicate, Shard
    out = list(placements)
    for i, p in enumerate(out):
        if isinstance(p, Shard):
            n, size = shape[p.dim], mesh.size(i)
            if n == 1 or n % size:
                out[i] = Replicate()
    return out


def lshard(x, *logical_axes):
    """Constrain ``x`` to the mapping of ``logical_axes`` (no-op without
    an active rules context).  Under rules a DTensor is redistributed to
    the axes' placements; a plain tensor, which must be equal on every
    rank, is first taken as replicated.  A dimension that does not split
    evenly over its mesh axis, or has a single row, stays replicated
    (``_fitted``)."""
    rules = current_rules()
    if rules is None:
        return x
    if x.ndim != len(logical_axes):
        raise ValueError(f"rank {x.ndim} vs axes {logical_axes}")
    if not is_dtensor(x):
        x = replicated(x, rules.mesh)
    want = tuple(_fitted(rules.placements(logical_axes), x.shape, rules.mesh))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(rules.mesh, want)


def _local_kv(k: torch.Tensor, first: int, n_q: int, group: int):
    """The kv heads of global q heads ``[first, first + n_q)`` (q head
    ``h`` reads kv head ``h // group``), laid out so that local q head
    ``j`` reads local kv head ``j // (n_q / len)``: a contiguous slice
    where the q heads cover whole groups or lie in one group, else one
    kv head per q head."""
    # host integers: the layout depends on shapes only, never on data
    idx = [h // group for h in range(first, first + n_q)]
    kv = sorted(set(idx))
    per = n_q // len(kv)
    if per * len(kv) == n_q and idx == [h for h in kv for _ in range(per)]:
        return k[:, :, kv[0]:kv[0] + len(kv)]
    return k[:, :, torch.tensor(idx, device=k.device)]


def shard_block(mesh, placements, dim: int) -> Tuple[int, int]:
    """(this rank's block, blocks) of tensor dimension ``dim`` split as
    ``placements`` say: the mesh dimensions that shard it, major first."""
    from torch.distributed.tensor import Shard
    block, n_blocks = 0, 1
    for i, p in enumerate(placements):
        if p == Shard(dim):
            block = block * mesh.size(i) + mesh.get_local_rank(i)
            n_blocks *= mesh.size(i)
    return block, n_blocks


class _VocabParallelCE(torch.autograd.Function):
    """One rank's part of the cross entropy of logits split over the
    vocabulary (Megatron's): ``x`` (..., V_local) holds columns
    ``[offset, offset + V_local)``, ``labels`` (...) the global label
    ids, ``groups`` the process groups of the mesh dimensions that split
    the vocabulary.  The forward all-reduces three float32 vectors a
    token (the max of the local log-sum-exps, the sum of their
    exponentials shifted by it, and the label logit, which one rank
    holds); the backward is local.  On one rank every all-reduce is the
    identity and ``lse`` is the local ``logsumexp`` plus ``log(1) = 0``,
    so the values and the gradient are those autograd gives for
    ``logsumexp`` minus ``gather``, bit for bit."""

    @staticmethod
    def forward(ctx, x, labels, offset: int, groups):
        import torch.distributed as dist
        lse_r = torch.logsumexp(x, dim=-1)
        m = lse_r.clone()
        for g in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        s = torch.exp(lse_r - m)
        for g in groups:
            dist.all_reduce(s, group=g)
        lse = m + torch.log(s)
        local = labels.long() - offset
        mine = (local >= 0) & (local < x.shape[-1])
        idx = torch.where(mine, local, 0)[..., None]
        ll = torch.where(mine, torch.gather(x, -1, idx)[..., 0], 0.0)
        for g in groups:
            dist.all_reduce(ll, group=g)
        ctx.save_for_backward(x, lse, idx, mine)
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        # logsumexp's backward (grad * exp(x - lse)), then the label
        # logit's (-grad at the label's column, on the rank holding it)
        x, lse, idx, mine = ctx.saved_tensors
        grad = g[..., None] * torch.exp(x - lse[..., None])
        grad.scatter_add_(-1, idx, torch.where(mine, -g, 0.0)[..., None])
        return grad, None, None, None


def vocab_parallel_cross_entropy(logits, labels):
    """Per-token cross entropy, ``logsumexp(logits) - logits[label]``,
    of DTensor ``logits`` (B, S, V) and integer ``labels`` (B, S),
    through ``local_map``: each rank reduces its own columns and the
    ranks that split the vocabulary combine a max and two sums, where
    DTensor would gather every row of logits whole (B x S x V float32).
    With the vocabulary whole, no rank combines anything.  Batch stays
    sharded as the logits have it; returns (B, S), whole along the
    vocabulary's mesh dimensions."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    vd = logits.ndim - 1
    lp = [p if p in (Shard(0), Shard(vd)) else Replicate()
          for p in logits.placements]
    bp = [Shard(0) if p == Shard(0) else Replicate() for p in lp]
    logits = logits.redistribute(mesh, lp)
    labels = like(labels, logits).redistribute(mesh, bp)
    block, n_blocks = shard_block(mesh, lp, vd)
    V = logits.shape[vd]
    if V % n_blocks:
        raise ValueError(f"{V} vocabulary columns do not split evenly over "
                         f"{n_blocks} ranks")
    offset = block * (V // n_blocks)
    groups = [mesh.get_group(i) for i, p in enumerate(lp) if p == Shard(vd)]
    run = local_map(
        lambda x, y: _VocabParallelCE.apply(x, y, offset, groups),
        out_placements=bp, in_placements=(lp, bp), device_mesh=mesh)
    return run(logits, labels)


def map_local_heads(fn, q, k, v, *rest, **kw):
    """``fn(q, k, v, *rest, **kw)`` on each rank's local shard of DTensor
    q (B, Sq, H, D), k and v (B, Sk, KV, D), through ``local_map``.

    Batch (dim 0) stays sharded as q has it, and so do q's heads (dim
    2); everything else is gathered first (a no-op under the default
    rules).  Each rank gets the kv heads of its own q heads, since
    ``fn`` maps local q head ``j`` to local kv head ``j // G``: rank r of
    tp holds q heads ``[r H/tp, (r+1) H/tp)``, which read kv heads from
    ``r H/tp // G`` on.  ``rest`` are position tensors (B, S), sharded
    by batch like q.  Returns q's placements."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    H, KV = q.shape[2], k.shape[2]
    group = H // KV
    qp = [p if p in (Shard(0), Shard(2)) else Replicate()
          for p in q.placements]
    bp = [Shard(0) if p == Shard(0) else Replicate() for p in qp]
    q = q.redistribute(mesh, qp)
    k, v = (like(t, q).redistribute(mesh, bp) for t in (k, v))
    rest = tuple(like(t, q).redistribute(mesh, bp) for t in rest)
    # the rank's block of q heads: mesh dims sharding heads, major first
    block, n_blocks = shard_block(mesh, qp, 2)
    if H % n_blocks:
        raise ValueError(f"{H} q heads do not split evenly over "
                         f"{n_blocks} ranks; pad them (pad_heads_for_tp)")
    n_q = H // n_blocks

    def local(ql, kl, vl, *restl):
        kl = _local_kv(kl, block * n_q, n_q, group)
        vl = _local_kv(vl, block * n_q, n_q, group)
        return fn(ql, kl.contiguous(), vl.contiguous(), *restl, **kw)

    run = local_map(local, out_placements=qp,
                    in_placements=(qp, bp, bp) + (bp,) * len(rest),
                    device_mesh=mesh)
    return run(q, k, v, *rest)
