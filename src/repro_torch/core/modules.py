"""Stream pre-processing modules (paper §III-A).

The paper's proxy loads shared-library modules that pre-process the
record stream before redistribution — e.g. "records can be dropped for
operations that compensate each other (creat/unlink) or re-ordered to
optimize downchain processing".  Same contract here, but the unit of
flow is a ``RecordBatch``: a module is a callable ``batch -> batch``
that inspects only the header *columns* it needs (type, target fid,
index — read zero-copy out of the packed buffer) and restructures the
batch with ``select``/``permute`` views.  No record is ever fully
decoded, repacked, or copied by a module.

For compatibility (and unit testing), every module also accepts a plain
``list[ChangelogRecord]`` and returns a list; the selection logic is
shared between both representations.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Set, Tuple, Union

import numpy as np

from . import records as R

Batch = Union[R.RecordBatch, List[R.ChangelogRecord]]


def _types(batch: Batch) -> List[int]:
    if isinstance(batch, R.RecordBatch):
        return batch.types()
    return [r.type for r in batch]


def _keys(batch: Batch) -> List[Tuple[int, int, int]]:
    if isinstance(batch, R.RecordBatch):
        return batch.keys()
    return [r.key() for r in batch]


def _indices(batch: Batch) -> List[int]:
    if isinstance(batch, R.RecordBatch):
        return batch.indices()
    return [r.index for r in batch]


def _take(batch: Batch, rows: Sequence[int]) -> Batch:
    """Rows ``rows`` of ``batch``, in order — a zero-copy view for a
    ``RecordBatch``, a plain sub-list otherwise."""
    if isinstance(batch, R.RecordBatch):
        return batch.select(rows)
    return [batch[i] for i in rows]


class CancelCompensating:
    """Drop (CREAT, UNLNK) pairs on the same target within a batch —
    the paper's canonical example.  Extended with the training-event
    analogue: a CKPT_WRITE superseded by a newer CKPT_WRITE of the same
    shard within the batch (only the latest write matters to the
    committer, exactly like creat/unlink compensating each other)."""

    CANCEL = {(R.CL_CREATE, R.CL_UNLINK), (R.CL_MKDIR, R.CL_RMDIR)}

    def __init__(self, supersede_ckpt: bool = True):
        self.supersede_ckpt = supersede_ckpt
        self._destroy_of = {d: c for c, d in self.CANCEL}

    def __call__(self, batch: Batch) -> Batch:
        if isinstance(batch, R.RecordBatch):
            # column precheck: a drop needs a destroy op (to pair with
            # an earlier create) or >1 checkpoint write — the vast
            # majority of batches have neither and pass through with
            # two vectorized scans and no per-record work
            t = batch.types_np()
            destroys = sorted(d for _, d in self.CANCEL)
            interesting = bool(np.isin(t, destroys).any())
            if not interesting and self.supersede_ckpt:
                interesting = int((t == R.CL_CKPT_WRITE).sum()) > 1
            if not interesting:
                return batch
        types, keys = _types(batch), _keys(batch)
        drop: Set[int] = set()
        open_by_key: Dict[tuple, List[int]] = defaultdict(list)
        creates = {c for c, _ in self.CANCEL}
        for i, t in enumerate(types):
            if t in creates:
                open_by_key[(keys[i], t)].append(i)
            else:
                c = self._destroy_of.get(t)
                if c is not None and open_by_key.get((keys[i], c)):
                    drop.add(open_by_key[(keys[i], c)].pop())
                    drop.add(i)
        if self.supersede_ckpt:
            last: Dict[tuple, int] = {}
            for i, t in enumerate(types):
                if t == R.CL_CKPT_WRITE:
                    k = keys[i][:2]            # (run, shard) identity
                    if k in last:
                        drop.add(last[k])
                    last[k] = i
        if not drop:
            return batch
        return _take(batch, [i for i in range(len(types)) if i not in drop])


class ReorderByTarget:
    """Stable-sort a batch by target fid then index, so a downstream
    consumer touching per-object state (robinhood's DB rows) gets runs of
    records on the same object — 'reordered to optimize downchain
    processing'."""

    def __call__(self, batch: Batch) -> Batch:
        if isinstance(batch, R.RecordBatch):
            seq, oid, ver = batch.tfid_cols()
            order = np.lexsort((batch.indices_np(), ver, oid, seq))
            if bool((order[1:] > order[:-1]).all()):
                return batch               # a sorted permutation is identity
            return batch.select(order)
        keys, indices = _keys(batch), _indices(batch)
        order = sorted(range(len(keys)),
                       key=lambda i: (keys[i], indices[i]))
        if order == list(range(len(keys))):
            return batch
        return _take(batch, order)


class TypeFilter:
    """Keep only the requested operation types (the administrator 'can
    select which operations to log' — the proxy can narrow further)."""

    def __init__(self, keep: Iterable[int]):
        self.keep = set(keep)
        self._keep_arr = np.array(sorted(self.keep), dtype=np.int64)

    def __call__(self, batch: Batch) -> Batch:
        if isinstance(batch, R.RecordBatch):
            mask = np.isin(batch.types_np(), self._keep_arr)
            if bool(mask.all()):
                return batch
            return batch.select(np.flatnonzero(mask))
        types = _types(batch)
        rows = [i for i, t in enumerate(types) if t in self.keep]
        if len(rows) == len(types):
            return batch
        return _take(batch, rows)


class CoalesceHeartbeats:
    """Keep only the newest heartbeat per host within a batch (liveness
    is level-triggered; history adds nothing downstream)."""

    def __call__(self, batch: Batch) -> Batch:
        if isinstance(batch, R.RecordBatch):
            t = batch.types_np()
            hb = np.flatnonzero(t == R.CL_HEARTBEAT)
            if hb.size <= 1:
                return batch
            host = batch.tfid_cols()[1][hb]    # oid = host id
            # first occurrence in the reversed host column is the last
            # heartbeat of that host in batch order
            _, first_rev = np.unique(host[::-1], return_index=True)
            mask = np.ones(len(batch), dtype=bool)
            mask[hb] = False
            mask[hb[hb.size - 1 - first_rev]] = True
            if bool(mask.all()):
                return batch
            return batch.select(np.flatnonzero(mask))
        types = _types(batch)
        last: Dict[int, int] = {}
        keys = None
        for i, t in enumerate(types):
            if t == R.CL_HEARTBEAT:
                if keys is None:
                    keys = _keys(batch)        # only when heartbeats exist
                last[keys[i][1]] = i           # oid = host id
        if not last:
            return batch
        rows = [i for i, t in enumerate(types)
                if t != R.CL_HEARTBEAT or last[keys[i][1]] == i]
        if len(rows) == len(types):
            return batch
        return _take(batch, rows)
