"""Per-device cost accounting of a traced step, collective bytes and the
roofline: the port of ``repro/launch/hlo_analysis.py``.

There is no HLO here.  The reference reads FLOPs and bytes from XLA's
``cost_analysis()`` of the per-device program and parses the collectives
out of its HLO text.  The port runs the step once on ``meta`` tensors
placed on a mesh over a fake process group (``launch.dryrun``) with
``OpCounter`` active, a dispatch mode that sees each rank's *local* aten
operations: it returns ``NotImplemented`` for a DTensor operation, so
that DTensor runs its sharding propagation and redistributions and hands
the local operations (and the c10d collectives it issues) back to the
mode.  What it counts is therefore per device, on the local shapes
DTensor's propagation picked.

Convention (the reference's): a collective's size is its OUTPUT tensor's
bytes per device; an all-reduce counts x2 (ring reduce-scatter +
all-gather); the (N-1)/N ring factor is folded into ~1.  So

    collective_s = collective_bytes / link bytes/s   (per card)
    compute_s    = flops_per_device / peak FLOP/s    (per card)
    memory_s     = bytes_per_device / HBM bytes/s    (per card)
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16, "s4": 1, "u4": 1,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: the c10d operations (functional ones from DTensor, in-place ones from
#: ``torch.distributed``) and the collective each is
C10D_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
#: c10d operations that move no data of their own
_C10D_BOOKKEEPING = frozenset({"wait_tensor", "_wrap_tensor_autograd"})
_C10D_NAMESPACES = ("_c10d_functional", "c10d")

#: a collective seen by ``OpCounter``: (type in COLLECTIVES, output bytes)
Record = Tuple[str, int]


def collective_bytes(records: List[Record]) -> Dict[str, Dict[str, float]]:
    """Per collective type: {'bytes': ..., 'count': ...} from the
    per-device collective records of a traced step."""
    out = {c: {"bytes": 0, "count": 0} for c in COLLECTIVES}
    for op, size in records:
        mult = 2 if op == "all-reduce" else 1
        out[op]["bytes"] += size * mult
        out[op]["count"] += 1
    return out


def total_collective_bytes(per_type: Dict[str, Dict[str, float]]) -> int:
    return int(sum(v["bytes"] for v in per_type.values()))


def roofline(flops_per_dev: float, bytes_per_dev: float,
             coll_bytes_per_dev: float, *, peak_flops: float, hbm_bw: float,
             ici_bw: float) -> Dict[str, float]:
    compute_s = flops_per_dev / peak_flops
    memory_s = bytes_per_dev / hbm_bw
    collective_s = coll_bytes_per_dev / ici_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    return {**terms, "dominant": dominant,
            "step_time_lower_bound_s": bound,
            # fraction of the step the compute roofline would occupy if
            # the dominant term were fully overlapped-free:
            "roofline_fraction": compute_s / bound if bound > 0 else 0.0}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _is_view(func) -> bool:
    """An operation whose result aliases an input without writing it."""
    rets = func._schema.returns
    return bool(rets) and rets[0].alias_info is not None and \
        not rets[0].alias_info.is_write


class OpCounter(TorchDispatchMode):
    """Counts each rank's local operations on ``meta`` tensors while it
    is active:

    - ``flops``: of every operation in ``torch.utils.flop_counter``'s
      registry (the matrix products; elementwise work counts 0, as in
      ``FlopCounterMode``), on its local shapes;
    - ``bytes``: operand plus result bytes of every local operation that
      is not a view or a collective, an unfused upper bound;
    - ``records``: every collective, ``(type, output bytes)``;
    - ``peak``: the most bytes of local storage alive at once, from the
      storages ``track`` was given and every operation's results, each
      freed when its storage is.

    A DTensor operation is handed back (``NotImplemented``): DTensor then
    runs its sharding propagation and redistributions and issues the
    local operations, which come back here.  What propagation computes
    (output shapes, on global shapes, under a fake mode of its own) and
    DTensor's bookkeeping on host tensors touch no ``meta`` tensor
    outside a fake mode, and are not counted.  A collective the table
    does not name raises."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        from torch.utils.weak import WeakIdKeyDictionary
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.records: List[Record] = []
        self._storages = WeakIdKeyDictionary()
        self.live = 0
        self.peak = 0

    def track(self, tree) -> int:
        """Count the storages of ``tree``'s tensors (DTensors by their
        local shard) as alive; returns the bytes newly tracked."""
        from torch.distributed.tensor import DTensor
        before = self.live
        for t in _tensors(tree):
            if isinstance(t, DTensor):
                # (while the counter is active, this view is itself
                # dispatched, and its storage tracked)
                t = t.to_local()
            st = t.untyped_storage()
            if st in self._storages:
                continue
            n = st.nbytes()
            self._storages[st] = n
            weakref.finalize(st, self._free, n)
            self.live += n
        self.peak = max(self.peak, self.live)
        return self.live - before

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not None or not any(
                t.device.type == "meta"
                for t in _tensors((args, kwargs, out))):
            return out
        ns = func.namespace
        name = func._overloadpacket.__name__
        if ns in _C10D_NAMESPACES:
            if name in C10D_COLLECTIVES:
                done = out[0] if name.endswith("_") else out
                self.records.append((C10D_COLLECTIVES[name],
                                     _nbytes(done)))
            elif name not in _C10D_BOOKKEEPING:
                raise NotImplementedError(
                    f"collective {func} is not accounted for "
                    f"({', '.join(C10D_COLLECTIVES)})")
        elif not _is_view(func):
            self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
            count = self._flop_registry.get(func._overloadpacket)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
        self.track(out)
        return out
