"""Acknowledgement watermark tracking for at-least-once delivery.

Per (group, producer): the upstream-ackable watermark is the highest
index W such that every *delivered* index <= W has been acknowledged.
Acks may arrive out of order (batched/delayed, paper §II) and — because
proxy modules may reorder or drop records (paper §III-A) — deliveries
may be out of index order and sparse.

Internals are a min-heap plus membership sets: ``deliver``/``ack`` are
O(log n) even when a consumer group runs tens of thousands of records
behind.  The columnar dispatch path hands in whole batches at once, so
``deliver_many``/``ack_many`` take index arrays and amortize the
filtering (one vectorized compare against the watermark) and the heap
maintenance (a sorted run *is* a valid min-heap, so an idle tracker
adopts it wholesale; a busy one extends and re-heapifies in O(n)).
The drain has a matching bulk exit: when every in-flight index is
acked — the steady state of a consumer that commits everything it
fetches — the whole heap collapses in one pass instead of a pop per
record.
"""

from __future__ import annotations

import bisect
import heapq
from typing import List, Set

import numpy as np


class AckTracker:
    def __init__(self, start: int = 0):
        self._heap: List[int] = []          # delivered & un-drained, min-first
        # _heap is always a valid min-heap; when _sorted it is fully
        # sorted (a stronger invariant bulk delivery maintains for free)
        # and the drain walks a prefix instead of popping per record
        self._sorted = True
        self._delivered: Set[int] = set()   # membership mirror of _heap
        self._acked: Set[int] = set()       # acked but blocked by a hole
        self._watermark = start
        self.delivered_total = 0            # cumulative, for metrics

    @property
    def watermark(self) -> int:
        return self._watermark

    @property
    def in_flight(self) -> int:
        return len(self._delivered)

    @property
    def acked_total(self) -> int:
        """Cumulative indices retired (every delivery eventually acks,
        so this is delivered_total minus what is still in flight)."""
        return self.delivered_total - len(self._delivered)

    def deliver(self, index: int) -> None:
        if index <= self._watermark or index in self._acked \
                or index in self._delivered:
            return
        self._delivered.add(index)
        self.delivered_total += 1
        heap = self._heap
        if self._sorted and (not heap or index >= heap[-1]):
            heap.append(index)              # common case: ascending arrival
        else:
            heapq.heappush(self._heap, index)
            self._sorted = False

    def deliver_many(self, indices) -> int:
        """Bulk ``deliver``: record a whole batch of indices (any order,
        duplicates tolerated) in one pass; returns how many were new."""
        arr = np.unique(np.asarray(indices, dtype=np.int64))
        arr = arr[arr > self._watermark]
        new = arr.tolist()
        if self._acked or self._delivered:
            acked, delivered = self._acked, self._delivered
            new = [i for i in new if i not in acked and i not in delivered]
        if not new:
            return 0
        self._delivered.update(new)
        self.delivered_total += len(new)
        heap = self._heap
        if heap:
            heap.extend(new)
            heap.sort()      # merge of (at most) two sorted runs: O(n)
        else:
            self._heap = new
        self._sorted = True
        return len(new)

    def _drain(self) -> int:
        heap = self._heap
        acked = self._acked
        if not heap or not acked:
            return self._watermark
        if self._delivered == acked:
            # steady state: everything in flight is acked — collapse in
            # one pass instead of visiting every entry below
            self._watermark = max(self._watermark, max(heap))
            heap.clear()
            self._delivered.clear()
            acked.clear()
            return self._watermark
        if not self._sorted and len(acked) > 64:
            heap.sort()                     # nearly sorted: cheap
            self._sorted = True
        if self._sorted:
            delivered = self._delivered
            # batched commits usually ack exactly the oldest run of the
            # heap: one superset test retires the whole prefix at C speed
            k = len(acked)
            if k <= len(heap):
                prefix = heap[:k]
                if acked.issuperset(prefix):
                    if prefix[-1] > self._watermark:
                        self._watermark = prefix[-1]
                    delivered.difference_update(prefix)
                    acked.difference_update(prefix)
                    del heap[:k]
                    return self._watermark
            pos, n = 0, len(heap)
            while pos < n and heap[pos] in acked:
                idx = heap[pos]
                acked.discard(idx)
                delivered.discard(idx)
                pos += 1
            if pos:
                if heap[pos - 1] > self._watermark:
                    self._watermark = heap[pos - 1]
                del heap[:pos]
            return self._watermark
        while heap and heap[0] in acked:
            idx = heapq.heappop(heap)
            acked.discard(idx)
            self._delivered.discard(idx)
            if idx > self._watermark:
                self._watermark = idx
        return self._watermark

    def ack(self, index: int) -> int:
        """Acknowledge one delivered index; returns the watermark."""
        if index > self._watermark:
            self._acked.add(index)
        return self._drain()

    def ack_many(self, indices) -> int:
        """Acknowledge a batch of delivered indices with one drain pass;
        returns the watermark."""
        wm = self._watermark
        if type(indices) is np.ndarray:
            self._acked.update(indices[indices > wm].tolist())
        else:
            acked = self._acked
            for index in indices:
                if index > wm:
                    acked.add(index)
        return self._drain()

    def ack_through(self, index: int) -> int:
        """Cumulative acknowledgement of every delivered index <= index."""
        heap = self._heap
        if self._sorted:
            pos = bisect.bisect_right(heap, index)
            if pos:
                if heap[pos - 1] > self._watermark:
                    self._watermark = heap[pos - 1]
                for idx in heap[:pos]:
                    self._acked.discard(idx)
                    self._delivered.discard(idx)
                del heap[:pos]
            return self._drain()
        while heap and heap[0] <= index:
            idx = heapq.heappop(heap)
            self._acked.discard(idx)
            self._delivered.discard(idx)
            if idx > self._watermark:
                self._watermark = idx
        return self._drain()
