"""Stateful namespace mirror — the policy engine's ground truth.
The port of ``repro/policy/mirror.py``.

A Robinhood policy engine replays namespace activity into a database
and decides archive/purge actions against that state (PAPERS.md).  The
``NamespaceMirror`` is that database, kept directly on the changelog
fabric:

- it **bootstraps** from the compacted history tier
  (``Subscription(replay=True)``) and then applies the live stream —
  a fresh mirror reconstructs the same per-FID state as a mirror that
  consumed the stream from the beginning, because its reducer commutes
  with the ``Compactor``'s folding rules (history.py):

  * CREATE/MKDIR/MKNOD/SOFTLINK insert an entry (annihilation only
    drops lifetimes whose UNLINK the mirror would apply anyway);
  * HARDLINK adds a name (``nlink`` += 1) — hardlinked lifetimes are
    never annihilated, so the mirror sees every link/unlink;
  * UNLINK/RMDIR remove one name, and the entry once the last name is
    gone;
  * RENAME rewrites name/parent (rename-chain folding keeps exactly
    the final name the mirror would have ended at);
  * SETATTR records the last writer (last-writer-wins thinning keeps
    exactly that record).

- it is **redelivery-safe**: per-target delivery order is guaranteed
  (single proxy, and FID-hash routing in a cluster), so a per-(producer,
  target) index high-watermark makes applying at-least-once redelivery
  (proxy restart, shard failover) exactly-once on the state.

Entries carry what policy rules match on: name, parent, link count,
creation/modification stream time, and the last writer's
shard/jobid/metrics.  ``clock`` is the newest record timestamp seen —
rules measure ages against stream time, never wall time, so a mirror
replaying history does not see every file as ancient.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Set, Tuple

from ..core import records as R
from ..core.history import CREATES, DESTROYS
from ..track.consumers import _GroupWorker

Key = Tuple[int, int, int]

#: the op types a namespace mirror consumes (pushed down to dispatch)
MIRROR_TYPES = frozenset(CREATES | DESTROYS
                         | {R.CL_HARDLINK, R.CL_RENAME, R.CL_SETATTR})


class MirrorEntry:
    """Per-FID ground truth: one live namespace object."""

    __slots__ = ("name", "parent", "nlink", "ctime", "mtime", "last_type",
                 "attr_time", "attr_shard", "attr_jobid", "attr_metrics")

    def __init__(self, name: bytes, parent: Key, ctime: int):
        self.name = name
        self.parent = parent
        self.nlink = 1
        self.ctime = ctime          # stream time (cr_time ns) of creation
        self.mtime = ctime          # stream time of the last touch
        self.last_type = R.CL_CREATE
        self.attr_time: int = 0     # last SETATTR stream time
        self.attr_shard = None      # last writer's (pod, host, row, col)
        self.attr_jobid: bytes = b""
        self.attr_metrics = None

    def age_ns(self, clock: int) -> int:
        return max(0, clock - self.ctime)

    def idle_ns(self, clock: int) -> int:
        return max(0, clock - self.mtime)

    def snapshot(self) -> dict:
        """Comparable view (tests: live mirror == bootstrapped mirror)."""
        return {"name": self.name, "parent": self.parent,
                "nlink": self.nlink, "attr_time": self.attr_time,
                "attr_shard": self.attr_shard,
                "attr_jobid": self.attr_jobid,
                "attr_metrics": self.attr_metrics}


class NamespaceMirror(_GroupWorker):
    """A consumer group member holding the namespace state.

    ``replay=True`` (default) bootstraps from history; pass
    ``replay=None`` for a mirror that only tracks from now on.  Drive
    it with ``poll()`` (or ``bootstrap()`` to drain the whole history
    phase); ``entries`` maps target FID -> ``MirrorEntry``.
    """

    def __init__(self, proxy, group: str = "mirror",
                 name: Optional[str] = None, replay=True,
                 types: Optional[Iterable[int]] = None):
        super().__init__(proxy, group, types=types or MIRROR_TYPES,
                         name=name, replay=replay)
        self.entries: Dict[Key, MirrorEntry] = {}
        self.clock = 0                      # newest cr_time seen (ns)
        #: (producer, target) -> highest applied journal index; per-target
        #: order is guaranteed end to end, so this makes at-least-once
        #: redelivery exactly-once on the state
        self._applied: Dict[Tuple[str, Key], int] = {}
        #: targets touched since the policy engine last drained them
        self.dirty: Set[Key] = set()
        self.stats = {"applied": 0, "deduped": 0}

    # -- state ----------------------------------------------------------------
    def snapshot(self) -> Dict[Key, dict]:
        return {k: e.snapshot() for k, e in self.entries.items()}

    def drain_dirty(self) -> Set[Key]:
        """Targets changed since the last drain (incremental rule
        evaluation); includes targets that were removed."""
        dirty, self.dirty = self.dirty, set()
        return dirty

    # -- reduction -------------------------------------------------------------
    def handle_batch(self, pid: str, batch: R.RecordBatch) -> None:
        applied = self._applied
        for i in range(len(batch)):
            rec = batch.record(i)
            key = rec.key()
            mark = (pid, key)
            if rec.index <= applied.get(mark, 0):
                self.stats["deduped"] += 1   # failover/restart redelivery
                continue
            applied[mark] = rec.index
            self._apply(rec, key)
            self.stats["applied"] += 1

    def _apply(self, rec: R.ChangelogRecord, key: Key) -> None:
        if rec.time > self.clock:
            self.clock = rec.time
        t = rec.type
        e = self.entries.get(key)
        if t in CREATES:
            e = MirrorEntry(rec.name,
                            (rec.pfid.seq, rec.pfid.oid, rec.pfid.ver),
                            rec.time)
            e.last_type = t
            self.entries[key] = e
        elif t == R.CL_HARDLINK:
            if e is None:
                # link to an object that predates the stream: the
                # lifetime is still hardlinked, so materialize it
                e = MirrorEntry(rec.name,
                                (rec.pfid.seq, rec.pfid.oid, rec.pfid.ver),
                                rec.time)
                self.entries[key] = e
            e.nlink += 1
            e.mtime = rec.time
            e.last_type = t
        elif t in DESTROYS:
            if e is not None:
                if e.nlink > 1:
                    e.nlink -= 1
                    e.mtime = rec.time
                    e.last_type = t
                else:
                    del self.entries[key]
        elif t == R.CL_RENAME:
            if e is not None:
                e.name = rec.name
                e.parent = (rec.pfid.seq, rec.pfid.oid, rec.pfid.ver)
                e.mtime = rec.time
                e.last_type = t
        elif t == R.CL_SETATTR:
            if e is not None:
                e.attr_time = rec.time
                # local remap zero-fills extensions the producer did not
                # send (§IV-A), so an all-zero value means "absent" —
                # the only presence signal that survives the remap
                e.attr_shard = rec.shard if (rec.shard and
                                             any(rec.shard)) else None
                e.attr_jobid = rec.jobid or b""
                e.attr_metrics = rec.metrics or None
                e.mtime = rec.time
                e.last_type = t
        else:
            return
        self.dirty.add(key)

    def compact_applied(self, trim_points: Dict[str, int]) -> int:
        """Bound the dedup map: drop per-target watermarks below a
        journal's trim point (``{pid: Llog.first_index}``).  Safe
        because every redelivery path — proxy restart, cluster shard
        failover — re-reads from the journal, which no longer holds
        records below its trim point, so those indices can never
        arrive again.  Refused mid-bootstrap: a failover-rewound
        history replay may still revisit old indices.  Returns the
        number of watermarks dropped."""
        if self.bootstrapping:
            return 0
        before = len(self._applied)
        self._applied = {mark: idx for mark, idx in self._applied.items()
                         if idx >= trim_points.get(mark[0], 0)}
        return before - len(self._applied)

    # -- driving ---------------------------------------------------------------
    def bootstrap(self, rounds: int = 10000,
                  max_records: int = 4096) -> int:
        """Drain the whole history phase (and whatever live records are
        already queued); returns records applied."""
        n = 0
        for _ in range(rounds):
            moved = self.poll(max_records)
            n += moved
            if not moved and not self.bootstrapping:
                return n
        raise RuntimeError("mirror bootstrap did not drain")
