"""Windowed aggregation over the live changelog stream.
The port of ``repro/obs/aggregator.py``.

``ActivityAggregator`` is an ordinary consumer (``_GroupWorker`` on the
Session API — it runs against a single proxy, a TCP service, or a whole
cluster) that folds every batch into **tumbling windows** keyed by
stream time (``cr_time // window_ns``) of per-(op-type, jobid,
producer, shard-host) record counts and value sums (the first
CLF_METRICS gauge: loss, bytes written, step seconds — whatever the op
carries).

The fold is columnar end to end: window ids, op types, jobids, shard
hosts and metric values are gathered as whole columns from the
``RecordBatch`` header table and payload extensions, grouped with one
``lexsort`` + change-point scan, and reduced with ``np.add.reduceat`` —
per *unique group* Python, never per record.

Windows live in a bounded ring (``retention`` newest window ids);
records older than the evicted horizon count as ``late_dropped``.
**Sliding views** are sums over the last *k* panes; **trend deltas**
(rate, diff vs the previous window) come from comparing adjacent panes.
Built with ``replay=True`` the aggregator warm-starts from the
compacted history tier before tailing live — the stanford-rc HSM
viewer's bootstrap-then-follow shape.

Delivery is at-least-once: in a clean run (no failover) counters match
an exact offline SQL aggregation record for record (equivalence-tested
against ``MetricsDB``); across a shard kill, redelivered records can
count twice — trends, not ledgers.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..core import records as R
from ..track.consumers import _GroupWorker

__all__ = ["ActivityAggregator", "WindowKey"]

#: aggregation key: (op type, jobid, producer, shard host)
WindowKey = Tuple[int, str, str, int]

#: dimension name -> position in WindowKey
DIMS = {"op": 0, "jobid": 1, "producer": 2, "shard": 3}


class ActivityAggregator(_GroupWorker):
    def __init__(self, target, group: str = "obs",
                 window_ns: int = 1_000_000_000, retention: int = 120,
                 flags: Optional[int] = None,
                 types: Optional[Iterable[int]] = None,
                 name: Optional[str] = None, mode: str = "persistent",
                 replay=None):
        if window_ns <= 0:
            raise ValueError("window_ns must be positive")
        # jobid + shard are the aggregation dimensions; ask the proxy to
        # keep (only) them unless the caller projects differently
        if flags is None:
            flags = R.CLF_JOBID | R.CLF_SHARD | R.CLF_METRICS
        # zero_fill off: the column gathers read absent extensions as
        # zeros already, so delivery stays strip-only (usually identity)
        super().__init__(target, group, flags=flags, types=types,
                         name=name, mode=mode, replay=replay,
                         zero_fill=False)
        self.window_ns = int(window_ns)
        self.retention = int(retention)
        self._lock = threading.Lock()
        #: window id -> {WindowKey: [count, value_sum]}
        self._windows: Dict[int, Dict[WindowKey, list]] = {}
        self._evict_hi = -(1 << 62)          # newest evicted window id
        self._jobid_ids: Dict[bytes, int] = {}
        self._jobid_names: List[str] = []
        self.stats = {"records": 0, "batches": 0, "late_dropped": 0,
                      "windows_evicted": 0}

    # ------------------------------------------------------------- the fold
    def _intern_jobids(self, batch: R.RecordBatch) -> np.ndarray:
        """Map each record's 32-byte jobid to a small int id (stable for
        the aggregator's lifetime); one ``np.unique`` per batch, one
        dict probe per *distinct* jobid."""
        mat = batch.jobid_col()
        void = np.ascontiguousarray(mat).view(
            np.dtype((np.void, mat.shape[1]))).ravel()
        uniq, inverse = np.unique(void, return_inverse=True)
        ids = np.empty(len(uniq), dtype=np.int64)
        for j, raw in enumerate(uniq):
            key = raw.tobytes()
            known = self._jobid_ids.get(key)
            if known is None:
                known = self._jobid_ids[key] = len(self._jobid_names)
                self._jobid_names.append(
                    key.rstrip(b"\0").decode("utf-8", errors="replace"))
            ids[j] = known
        return ids[inverse]

    def handle_batch(self, pid: str, batch: R.RecordBatch) -> None:
        n = len(batch)
        if not n:
            return
        h = batch.header()
        wins = (h["time"].astype(np.int64) // self.window_ns)
        ops = h["type"].astype(np.int64)
        jids = self._intern_jobids(batch)
        _pod, hosts = batch.shard_cols()
        vals = batch.metric0_col()

        order = np.lexsort((hosts, jids, ops, wins))
        w = wins[order]
        o = ops[order]
        j = jids[order]
        s = hosts[order]
        v = vals[order]
        change = np.empty(n, dtype=bool)
        change[0] = True
        change[1:] = ((w[1:] != w[:-1]) | (o[1:] != o[:-1])
                      | (j[1:] != j[:-1]) | (s[1:] != s[:-1]))
        starts = np.flatnonzero(change)
        counts = np.diff(np.append(starts, n))
        vsums = np.add.reduceat(v, starts)

        with self._lock:
            names = self._jobid_names
            for st, c, vs in zip(starts.tolist(), counts.tolist(),
                                 vsums.tolist()):
                win = int(w[st])
                if win <= self._evict_hi:
                    self.stats["late_dropped"] += c
                    continue
                wd = self._windows.get(win)
                if wd is None:
                    wd = self._windows[win] = {}
                key = (int(o[st]), names[int(j[st])], pid, int(s[st]))
                cell = wd.get(key)
                if cell is None:
                    wd[key] = [c, vs]
                else:
                    cell[0] += c
                    cell[1] += vs
            self.stats["records"] += n
            self.stats["batches"] += 1
            while len(self._windows) > self.retention:
                oldest = min(self._windows)
                del self._windows[oldest]
                if oldest > self._evict_hi:
                    self._evict_hi = oldest
                self.stats["windows_evicted"] += 1

    # ------------------------------------------------------------- queries
    def window_ids(self) -> List[int]:
        with self._lock:
            return sorted(self._windows)

    @property
    def current_window(self) -> Optional[int]:
        with self._lock:
            return max(self._windows) if self._windows else None

    def counters(self, window: Optional[int] = None,
                 ) -> Dict[WindowKey, Tuple[int, float]]:
        """The full key table of one window (default: newest)."""
        with self._lock:
            if window is None:
                if not self._windows:
                    return {}
                window = max(self._windows)
            wd = self._windows.get(window, {})
            return {k: (c, vs) for k, (c, vs) in wd.items()}

    def sliding(self, k: int, end: Optional[int] = None,
                ) -> Dict[WindowKey, Tuple[int, float]]:
        """Counters summed over the last ``k`` panes ending at ``end``
        (default: newest) — the sliding-window view of the same fold."""
        with self._lock:
            if end is None:
                if not self._windows:
                    return {}
                end = max(self._windows)
            out: Dict[WindowKey, list] = {}
            for win in range(end - k + 1, end + 1):
                for key, (c, vs) in self._windows.get(win, {}).items():
                    cell = out.get(key)
                    if cell is None:
                        out[key] = [c, vs]
                    else:
                        cell[0] += c
                        cell[1] += vs
            return {k_: (c, vs) for k_, (c, vs) in out.items()}

    def totals(self) -> List[Tuple[int, int, float]]:
        """Per retained window: (window id, records, value sum)."""
        with self._lock:
            return [(win,
                     sum(c for c, _ in wd.values()),
                     sum(vs for _, vs in wd.values()))
                    for win, wd in sorted(self._windows.items())]

    def top(self, dim: str = "jobid", k: int = 10,
            window: Optional[int] = None,
            sliding: Optional[int] = None) -> List[dict]:
        """The busiest labels of one dimension, with trend deltas.

        Each row: ``label``, ``count``, ``value_sum``, ``rate`` (records
        per second across the measured span) and ``delta`` (count minus
        the previous same-width span — positive = heating up)."""
        pos = DIMS[dim]
        span = max(1, int(sliding or 1))
        with self._lock:
            if window is None:
                if not self._windows:
                    return []
                window = max(self._windows)
        cur = self._fold_dim(self.sliding(span, end=window), pos)
        prev = self._fold_dim(self.sliding(span, end=window - span), pos)
        secs = span * self.window_ns / 1e9
        rows = []
        for label, (c, vs) in cur.items():
            if dim == "op":
                label = R.TYPE_NAMES.get(label, f"?{label}")
            rows.append({"label": label, "count": c, "value_sum": vs,
                         "rate": c / secs,
                         "delta": c - prev.get(label, (0, 0.0))[0]})
        rows.sort(key=lambda r: (-r["count"], str(r["label"])))
        return rows[:k]

    @staticmethod
    def _fold_dim(table: Dict[WindowKey, Tuple[int, float]],
                  pos: int) -> Dict[object, Tuple[int, float]]:
        out: Dict[object, list] = {}
        for key, (c, vs) in table.items():
            cell = out.get(key[pos])
            if cell is None:
                out[key[pos]] = [c, vs]
            else:
                cell[0] += c
                cell[1] += vs
        return {k: (c, vs) for k, (c, vs) in out.items()}

    def rate(self, window: Optional[int] = None) -> float:
        """Aggregate records/second of one window (default: newest)."""
        table = self.counters(window)
        secs = self.window_ns / 1e9
        return sum(c for c, _ in table.values()) / secs

    # ------------------------------------------------------------ plumbing
    def run_once(self, max_records: int = 4096) -> int:
        """Drain whatever the stream has buffered right now (replay
        bootstrap included); returns records folded."""
        moved = 0
        while True:
            got = self.poll(max_records)
            if not got:
                return moved
            moved += got

    def collector(self, labels: Optional[Dict[str, str]] = None):
        """A registry collector exporting the newest *closed* pane (the
        one before the still-filling newest window) as labeled gauges —
        hook with ``registry.register_collector(agg.collector())``."""
        base = dict(labels or {})

        def _collect():
            with self._lock:
                wins = sorted(self._windows)
                stats = dict(self.stats)
            out = [(f"lcap_agg_{key}_total", "counter",
                    f"aggregator stats[{key}]", base, val)
                   for key, val in stats.items()]
            out.append(("lcap_agg_windows_retained", "gauge",
                        "window panes currently held", base, len(wins)))
            target = wins[-2] if len(wins) > 1 else None
            if target is not None:
                for (op, jobid, pid, host), (c, vs) in \
                        self.counters(target).items():
                    lb = dict(base, op=R.TYPE_NAMES.get(op, str(op)),
                              jobid=jobid, producer=pid, shard=str(host),
                              window=str(target))
                    out.append(("lcap_window_records", "gauge",
                                "records in the newest closed window",
                                lb, c))
                    out.append(("lcap_window_value_sum", "gauge",
                                "metric-0 sum in the newest closed window",
                                lb, vs))
            return out

        return _collect
