"""Straggler mitigation policy: the port of ``repro/runtime/straggler.py``.

Detection lives in track.consumers.StragglerDetector (EWMA of per-host
step durations from HEARTBEAT/STEP records vs fleet median).  This
module is the *response*: rebalance data-shard ownership away from
flagged hosts proportionally to their measured slowdown, so the
synchronous step time tracks the median host, not the slowest.

Decisions are emitted as CL_STRAGGLER records so every consumer group
(metrics, elastic controller) observes them — the same changelog
backbone the paper provides.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..core import records as R
from ..track.consumers import StragglerDetector
from ..track.tracker import ActivityTracker


def rebalance_shards(n_shards: int, hosts: Sequence[int],
                     ewma: Dict[int, float]) -> Dict[int, List[int]]:
    """Assign data shards inversely proportional to per-host EWMA step
    time (missing hosts get median weight).  Every shard is assigned
    exactly once; every host keeps >= 1 shard unless fully flagged out."""
    if not hosts:
        return {}
    times = [ewma.get(h) for h in hosts]
    known = sorted(t for t in times if t)
    median = known[len(known) // 2] if known else 1.0
    speed = {h: median / (ewma.get(h) or median) for h in hosts}
    total = sum(speed.values())
    # largest-remainder apportionment
    quota = {h: n_shards * speed[h] / total for h in hosts}
    alloc = {h: int(quota[h]) for h in hosts}
    rem = n_shards - sum(alloc.values())
    for h in sorted(hosts, key=lambda h: quota[h] - alloc[h], reverse=True):
        if rem <= 0:
            break
        alloc[h] += 1
        rem -= 1
    out: Dict[int, List[int]] = {h: [] for h in hosts}
    shard = 0
    for h in hosts:
        for _ in range(alloc[h]):
            out[h].append(shard)
            shard += 1
    return out


class StragglerMitigator:
    def __init__(self, detector: StragglerDetector, n_shards: int,
                 tracker: Optional[ActivityTracker] = None):
        self.detector = detector
        self.n_shards = n_shards
        self.tracker = tracker
        self.assignment: Dict[int, List[int]] = {}

    def maybe_rebalance(self, hosts: Sequence[int],
                        step: int = 0) -> Optional[Dict[int, List[int]]]:
        """Returns a new shard assignment when stragglers are flagged
        (and logs the decision), else None."""
        if not self.detector.flagged:
            return None
        new = rebalance_shards(self.n_shards, hosts, self.detector.ewma)
        if new == self.assignment:
            return None
        self.assignment = new
        if self.tracker is not None:
            for h in sorted(self.detector.flagged):
                self.tracker._log(  # noqa: SLF001 — same-package protocol
                    R.CL_STRAGGLER, oid=h, ver=step,
                    xattr={"shards": {str(k): v for k, v in new.items()}})
        return new
