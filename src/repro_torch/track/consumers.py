"""LCAP consumer groups used by the serving runtime, on the Session API:
the port of ``_GroupWorker`` and ``CacheInvalidator`` from
``repro/track/consumers.py``.

- ``CacheInvalidator`` — the Ganesha analogue (§IV-C-1): ephemeral
  consumer of EVICT records that invalidates a local cache (in the
  serving runtime, each replica's KV/page cache).

Workers subscribe declaratively (``session.subscribe``) and name the op
types they consume, so the proxy's server-side pushdown never copies
irrelevant records into their outbox.  The other workers (metrics
database, checkpoint committer, straggler detector, elastic controller)
come with the tracking slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from ..core import records as R
from ..core.session import Subscription, connect


class _GroupWorker:
    """Base: subscribe a Stream, process batches, commit after each poll
    round (acks "may be delayed and batched", paper §II).

    ``replay`` passes straight through to the ``Subscription``: a worker
    built with ``replay=True`` bootstraps from the compacted history
    tier before its live stream starts (``bootstrapping`` reports the
    phase) — the policy engine's namespace mirror rides on this."""

    def __init__(self, proxy, group: str, flags: Optional[int] = None,
                 types: Optional[Iterable[int]] = None,
                 name: Optional[str] = None, mode: str = "persistent",
                 replay=None, zero_fill: bool = True):
        self.session = connect(proxy)
        self.stream = self.session.subscribe(Subscription(
            group=None if mode == "ephemeral" else group, mode=mode,
            flags=flags, types=types, name=name, auto_commit=False,
            replay=replay, zero_fill=zero_fill))

    @property
    def bootstrapping(self) -> bool:
        """True while the history replay is still streaming."""
        return self.stream.replaying

    def poll(self, max_records: int = 256) -> int:
        n = 0
        batches = self.stream.fetch(max_records)
        done = 0
        try:
            for pid, batch in batches:
                self.handle_batch(pid, batch)
                done += 1
                n += len(batch)
        except Exception:
            # a failed handler must not let a later commit() ack the
            # unprocessed records: requeue them so the next poll
            # retries exactly where this one failed
            self.stream.requeue(batches[done:])
            raise
        self.stream.commit()
        return n

    def handle_batch(self, pid: str, batch: R.RecordBatch) -> None:
        """Default: decode lazily, process record by record.  Workers
        with a batch-shaped sink (e.g. one DB transaction per batch)
        override this — the batch arrives with its header columns
        attached (v2 wire frames ship them), so columnar handlers read
        ``batch.header()`` / the payload gathers with zero per-record
        decode."""
        for i in range(len(batch)):
            self.handle(pid, batch.record(i))

    def handle(self, pid: str, rec: R.ChangelogRecord) -> None:
        raise NotImplementedError

    def close(self, failed: bool = False) -> None:
        self.stream.close(failed=failed)
        self.session.close()


class CacheInvalidator(_GroupWorker):
    """Ephemeral consumer invalidating a local cache on EVICT records —
    the Ganesha/pNFS metadata-cache analogue (§IV-C-1).  In the serving
    runtime this is the per-replica KV/page cache."""

    def __init__(self, proxy, cache: Dict[Tuple[int, int], object],
                 mode: str = "ephemeral"):
        # pushdown: only EVICT records ever reach this consumer's outbox
        super().__init__(proxy, "evict", types={R.CL_EVICT}, mode=mode)
        self.cache = cache
        self.invalidated = 0

    def handle_batch(self, pid: str, batch: R.RecordBatch) -> None:
        # type + tfid straight from the decoded header columns — an
        # invalidator never needs the record body.  Delivery goes
        # through the base poll(), whose requeue-on-failure guard keeps
        # a persistent-mode invalidator at-least-once when a handler
        # round dies mid-way.
        rows = np.flatnonzero(batch.types_np() == R.CL_EVICT)
        if not rows.size:
            return
        _, oid, ver = batch.tfid_cols()
        pop = self.cache.pop
        for key in zip(oid[rows].tolist(), ver[rows].tolist()):
            if pop(key, None) is not None:
                self.invalidated += 1
