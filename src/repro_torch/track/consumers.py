"""LCAP consumer groups used by the framework, on the Session API.
The port of ``repro/track/consumers.py``.

Every worker subscribes declaratively (``session.subscribe``) and names
the op types it consumes, so the proxy's server-side pushdown never
copies irrelevant records into its outbox:

- ``MetricsDB`` — the Robinhood analogue: N load-balanced instances of
  one group replicate the record stream into one shared SQLite database
  (paper §III: "multiple instances of robinhood operating on a shared
  database").  Subscribes to everything (it is the audit log).
- ``CheckpointCommitter`` — CKPT_WRITE only; once every shard of a step
  has been seen (across all producers), publishes the checkpoint-commit
  manifest.  Runs as a load-balanced group; members coordinate through
  the shared manifest store.
- ``StragglerDetector`` — HEARTBEAT + STEP_COMMIT; EWMA per host
  against the fleet median flags stragglers.
- ``ElasticController`` — ELASTIC_JOIN/LEAVE; recomputes the device
  plan for the next restart window.
- ``CacheInvalidator`` — the Ganesha analogue (§IV-C-1): ephemeral
  consumer of EVICT records that invalidates a local cache.

Workers may pass ``name=`` to become durable consumers: a crashed
worker that reconnects under the same name resumes at its acknowledged
cursor instead of triggering a group-wide redelivery storm.
"""

from __future__ import annotations

import json
import math
import os
import sqlite3
import threading
from typing import Dict, Iterable, List, Optional, Set, Tuple

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


class MetricsDB(_GroupWorker):
    """Replicates the activity stream into a shared SQLite DB."""

    SCHEMA = """
    CREATE TABLE IF NOT EXISTS events (
        producer TEXT, idx INTEGER, type INTEGER, time INTEGER,
        run INTEGER, oid INTEGER, ver INTEGER, name TEXT, jobid TEXT,
        pod INTEGER, host INTEGER, m0 REAL, m1 REAL, m2 REAL,
        PRIMARY KEY (producer, idx) ON CONFLICT REPLACE
    );
    """

    def __init__(self, proxy, db_path: str, group: str = "metrics",
                 name: Optional[str] = None):
        super().__init__(proxy, group, name=name)
        self.db_path = db_path
        self.conn = sqlite3.connect(db_path, timeout=30.0,
                                    check_same_thread=False)
        self.conn.execute("PRAGMA journal_mode=WAL")
        self.conn.execute(self.SCHEMA)
        self.conn.commit()

    @staticmethod
    def _row(pid: str, rec: R.ChangelogRecord) -> tuple:
        m = (list(rec.metrics or []) + [None] * 3)[:3]
        shard = rec.shard or (0, 0, 0, 0)
        return (pid, rec.index, rec.type, rec.time, rec.tfid.seq,
                rec.tfid.oid, rec.tfid.ver, rec.name.decode(errors="replace"),
                (rec.jobid or b"").decode(errors="replace"),
                shard[0], shard[1], m[0], m[1], m[2])

    @staticmethod
    def _rows(pid: str, batch: R.RecordBatch) -> List[tuple]:
        """Column-built rows, value-identical to mapping ``_row`` over
        the decoded records: header columns + the vectorized payload
        gathers, no per-record ``unpack``."""
        h = batch.header()
        names = [nm.decode(errors="replace") for nm in batch.name_col()]
        jraw = batch.jobid_col().tobytes()
        jobs = [jraw[o:o + 32].rstrip(b"\0").decode(errors="replace")
                for o in range(0, len(jraw), 32)]
        pod, host = batch.shard_cols()
        mat, cnt = batch.metrics_cols(3)
        rows = []
        for i, (ix, tp, tm, sq, od, vr, po, ho, c, mv) in enumerate(zip(
                h["index"].tolist(), h["type"].tolist(), h["time"].tolist(),
                h["tseq"].tolist(), h["toid"].tolist(), h["tver"].tolist(),
                pod.tolist(), host.tolist(), cnt.tolist(), mat.tolist())):
            rows.append((pid, ix, tp, tm, sq, od, vr, names[i], jobs[i],
                         po, ho,
                         mv[0] if c > 0 else None,
                         mv[1] if c > 1 else None,
                         mv[2] if c > 2 else None))
        return rows

    def handle_batch(self, pid: str, batch: R.RecordBatch) -> None:
        # one transaction per batch — the whole point of batch flow for
        # a DB-shaped consumer; rows come straight off the columns
        self.conn.executemany(
            "INSERT INTO events VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
            self._rows(pid, batch))
        self.conn.commit()

    def handle(self, pid: str, rec: R.ChangelogRecord) -> None:
        self.conn.execute(
            "INSERT INTO events VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
            self._row(pid, rec))
        self.conn.commit()

    def query(self, sql: str, args=()) -> List[tuple]:
        return list(self.conn.execute(sql, args))

    def close(self, failed: bool = False) -> None:
        # keep the base signature: a crashed worker is closed with
        # failed=True so its durable cursor parks instead of
        # deregistering (resume picks up exactly at the ack cursor)
        super().close(failed=failed)
        self.conn.close()


class CheckpointCommitter(_GroupWorker):
    """Watches CKPT_WRITE records; commits when all shards of a step are
    present.  The shared manifest dir is the coordination point, so the
    group can be load-balanced (any member may complete a step).

    Coordination is lock-free across processes: each CKPT_WRITE record
    becomes its *own* ``step-S.shard-N.json`` file (atomic tmp+rename,
    idempotent — the content is a pure function of the record), and a
    step commits when the directory holds ``total_shards`` shard files.
    A shared read-modify-write state file would lose updates between
    group members in different processes (a per-instance lock cannot
    order their write-backs); per-shard files cannot collide, and two
    members racing to commit write byte-identical manifests."""

    def __init__(self, proxy, manifest_dir: str, group: str = "ckpt",
                 name: Optional[str] = None):
        super().__init__(proxy, group, types={R.CL_CKPT_WRITE}, name=name)
        self.dir = manifest_dir
        os.makedirs(manifest_dir, exist_ok=True)
        self.committed: Set[int] = set()

    def _shard_path(self, step: int, shard_id: int) -> str:
        return os.path.join(self.dir,
                            f"step-{step:08d}.shard-{shard_id:08d}.json")

    def manifest_path(self, step: int) -> str:
        return os.path.join(self.dir, f"step-{step:08d}.manifest.json")

    def _shard_files(self, step: int) -> List[str]:
        prefix = f"step-{step:08d}.shard-"
        return [os.path.join(self.dir, f) for f in os.listdir(self.dir)
                if f.startswith(prefix) and f.endswith(".json")]

    def handle(self, pid: str, rec: R.ChangelogRecord) -> None:
        if rec.type != R.CL_CKPT_WRITE:
            return
        step = rec.tfid.ver
        shard_id = rec.tfid.oid
        total = (rec.xattr or {}).get("total_shards", 0)
        if step in self.committed or os.path.exists(self.manifest_path(step)):
            return    # redelivered record of a committed step: no litter
        path = self._shard_path(step, shard_id)
        # unique tmp per writer: two processes landing the same shard
        # (redelivery) must not corrupt each other's rename source
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as fh:
            json.dump({"shard": shard_id, "total": total,
                       "path": rec.name.decode(), "producer": pid,
                       "bytes": (rec.metrics or (0.0,))[0]}, fh)
        os.replace(tmp, path)
        self._try_commit(step, total)

    def _try_commit(self, step: int, total_hint: int = 0) -> None:
        paths = self._shard_files(step)
        if total_hint and len(paths) < total_hint:
            return      # cannot be complete yet: skip the JSON read pass
        shards: Dict[str, dict] = {}
        total = total_hint
        for path in paths:
            try:
                with open(path) as fh:
                    entry = json.load(fh)
            except (OSError, ValueError):
                continue        # racing writer; the next record retries
            total = max(total, entry.get("total", 0))
            shards[str(entry["shard"])] = {
                "path": entry["path"], "producer": entry["producer"],
                "bytes": entry["bytes"]}
        if total and len(shards) >= total:
            tmp = (self.manifest_path(step)
                   + f".tmp.{os.getpid()}.{threading.get_ident()}")
            with open(tmp, "w") as fh:
                json.dump({"step": step, "complete": True,
                           "shards": shards}, fh)
            os.replace(tmp, self.manifest_path(step))
            self.committed.add(step)
            # the manifest is the durable record; dropping the shard
            # files keeps the directory (and the per-record listdir in
            # _shard_files) bounded by *in-flight* steps only
            for path in paths:
                try:
                    os.remove(path)
                except OSError:
                    pass        # a racing member already cleaned it

    def latest_committed(self) -> Optional[int]:
        steps = [int(f.split("-")[1].split(".")[0])
                 for f in os.listdir(self.dir) if f.endswith(".manifest.json")]
        return max(steps) if steps else None


class StragglerDetector(_GroupWorker):
    """EWMA of per-host step durations; a host whose EWMA exceeds
    ``threshold`` x the fleet median is flagged.

    Hosts that leave the fleet are evicted from the EWMA map: an
    ELASTIC_LEAVE record drops the host immediately, and a host whose
    last sample is more than ``stale_after_s`` (record time) behind the
    newest sample in the stream is aged out.  Without eviction a
    departed straggler's entry skews the fleet median forever and keeps
    ``flagged`` pinned on a host that no longer exists."""

    def __init__(self, proxy, group: str = "health", alpha: float = 0.3,
                 threshold: float = 1.5, stale_after_s: float = 60.0,
                 name: Optional[str] = None):
        super().__init__(proxy, group,
                         types={R.CL_HEARTBEAT, R.CL_STEP_COMMIT,
                                R.CL_ELASTIC_LEAVE}, name=name)
        self.alpha = alpha
        self.threshold = threshold
        self.stale_after_ns = int(stale_after_s * 1e9)
        self.ewma: Dict[int, float] = {}
        self.last_seen: Dict[int, int] = {}    # host -> cr_time (ns)
        self.flagged: Set[int] = set()
        self._clock = 0                        # newest cr_time seen

    def handle(self, pid: str, rec: R.ChangelogRecord) -> None:
        self._clock = max(self._clock, rec.time)
        host = rec.tfid.oid
        if rec.type == R.CL_ELASTIC_LEAVE:
            self._evict(host)
            return
        if rec.type not in (R.CL_HEARTBEAT, R.CL_STEP_COMMIT):
            return
        m = rec.metrics or ()
        if rec.type == R.CL_STEP_COMMIT:
            # step_commit metrics are (loss, step_time_s, tokens); be
            # robust to truncated records instead of crashing the poll
            dt = m[-2] if len(m) >= 2 else (m[0] if m else 0.0)
        else:
            dt = m[0] if m else 0.0
        prev = self.ewma.get(host)
        self.ewma[host] = dt if prev is None else \
            self.alpha * dt + (1 - self.alpha) * prev
        self.last_seen[host] = max(self.last_seen.get(host, 0), rec.time)
        self._evict_stale()
        self._reflag()

    def _evict(self, host: int) -> None:
        self.ewma.pop(host, None)
        self.last_seen.pop(host, None)
        self.flagged.discard(host)
        self._reflag()

    def _evict_stale(self) -> None:
        horizon = self._clock - self.stale_after_ns
        for host in [h for h, t in self.last_seen.items() if t < horizon]:
            self.ewma.pop(host, None)
            self.last_seen.pop(host, None)
            self.flagged.discard(host)

    def _reflag(self) -> None:
        # flagged can only shrink below 2 known hosts: a lone survivor
        # has no fleet to straggle behind
        self.flagged &= set(self.ewma)
        if len(self.ewma) < 2:
            return
        vals = sorted(self.ewma.values())
        median = vals[len(vals) // 2]
        if median <= 0:
            return
        self.flagged = {h for h, v in self.ewma.items()
                        if v > self.threshold * median}


class ElasticController(_GroupWorker):
    """Tracks fleet membership from ELASTIC_JOIN/LEAVE records and
    proposes the largest usable mesh for the next restart window."""

    def __init__(self, proxy, group: str = "elastic",
                 chips_per_host: int = 4, name: Optional[str] = None):
        super().__init__(proxy, group,
                         types={R.CL_ELASTIC_JOIN, R.CL_ELASTIC_LEAVE},
                         name=name)
        self.chips_per_host = chips_per_host
        self.members: Set[int] = set()
        self.generation = 0

    def handle(self, pid: str, rec: R.ChangelogRecord) -> None:
        if rec.type == R.CL_ELASTIC_JOIN:
            self.members.add(rec.tfid.oid)
            self.generation += 1
        elif rec.type == R.CL_ELASTIC_LEAVE:
            self.members.discard(rec.tfid.oid)
            self.generation += 1

    def plan(self) -> Dict[str, int]:
        """Largest power-of-two device count usable as (data x model)."""
        chips = len(self.members) * self.chips_per_host
        usable = 1 << max(0, int(math.log2(chips))) if chips else 0
        data = 1 << (int(math.log2(usable)) // 2) if usable else 0
        return {"chips": chips, "usable": usable,
                "data": data, "model": usable // data if data else 0,
                "generation": self.generation}


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
