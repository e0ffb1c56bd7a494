"""Sharded LCAP cluster — horizontal fan-out of the changelog proxy.

The paper's headline claim is *distributed* changelog processing; a
single ``LcapProxy`` serializes every producer through one dispatch
loop and one ingest buffer.  ``LcapCluster`` puts N independent proxy
shards behind one coordinator:

- **FID-hash routing**: every record is routed to a shard by a stable
  hash of its target FID (``fid_slot``), so the ``cr_prev`` chain of
  one target always lands on the same shard and per-target ordering is
  preserved.  The hash maps FIDs onto a fixed ring of *slots*; slots
  map onto shards, which is what makes failover re-routing a slot
  reassignment instead of a re-hash.
- **producers registered once**: the coordinator is the only registered
  changelog reader per journal (resume-aware, like the proxy itself);
  shards see push-fed ``PushSource`` producers and receive their record
  subsets via ``LcapProxy.offer``.  A shard that owns none of a read
  range still receives the watermark advance, so it never holds the
  collective ack back.
- **collective upstream ack**: each shard's per-journal watermark (the
  ``PushSource.acked`` its own collective ack writes) is collected by
  the coordinator; the minimum across live shards acknowledges the real
  journal, which trims exactly as with a single proxy.
- **epoch-versioned routing**: slot ownership lives in an immutable
  ``RoutingTable`` snapshot (routing.py).  Every topology change —
  migration drain/commit/cancel, shard add, failover — derives a new
  table at ``epoch + 1``; within one epoch the owner of a slot never
  changes, and the bump is published (piggybacked on offer/fetch/caps
  replies) before any record is offered under the new assignment, so
  consumers re-resolve their shard fan-in instead of assuming a fixed
  shard set.
- **one migration invariant, two speeds**: planned rebalancing
  (``migrate_slots`` / ``add_shard`` / ``split_shard``) and failover
  (``kill_shard``) share the same contract — *records above a
  per-producer handoff watermark whose slots moved are (re)offered to
  the new owners at the next epoch*.  A **graceful** migration marks
  slots draining, parks newly read records for them in a bounded
  buffer, waits until every source shard's watermark reaches the
  handoff (its in-flight share fully consumed and acknowledged), then
  commits and hands the parked journal tail to the new owner — zero
  loss *and* zero duplication.  A **forced** migration (shard death)
  cannot wait: the handoff collapses to the dead shard's own last
  watermark and the unacknowledged backlog ``(acked, cursor]`` is
  re-read from the journals for the new owners — zero loss,
  at-least-once (the journal never trimmed past the dead shard's own
  watermark).  (Records re-offered to survivors are covered by shard
  memory, not the journal, until consumed: a *second* failure inside
  that window can lose them — the documented cascading-failure caveat.)

Shards are in-process (``LocalShard`` over ``LcapProxy``); the
reference's daemon deployment (``RemoteShard``, ``run_shard_daemon``,
``LcapClusterService``) needs the wire and is not part of this port
yet.  Consumers never talk to the coordinator:
``session.connect(cluster)`` fans a ``Subscription`` in from every
shard — one logical stream, per-(shard, producer) cursors, commits
routed back to the owning shard (session.py, ``FanInStream``).

Routing runs on the card: ``SlotRouter`` copies each journal read's
64-byte header rows to the GPU through a pinned staging buffer and
hashes them there with the hand-written CUDA kernel in
``kernels/stream_ops.py``.  ``LcapCluster(device="cpu")`` routes with
that kernel's plain PyTorch version instead (the tests' path).
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import stream_ops
from . import records as R
from .errors import ClusterError
from .history import JournalReplayReader
from .llog import Llog
from .proxy import LcapProxy, PushSource
from .routing import RoutingTable

DEFAULT_SLOTS = 64

_MIX = 0x9E3779B97F4A7C15          # splitmix64 increment (golden ratio)
_MASK = (1 << 64) - 1


def fid_slot(key: Tuple[int, int, int], n_slots: int = DEFAULT_SLOTS) -> int:
    """Stable slot of a target FID ``(seq, oid, ver)``.

    A splitmix64-style integer mix — deterministic across processes and
    runs (unlike ``hash()``), cheap, and uniform even for the dense
    small integers FIDs are made of.
    """
    z = (key[0] * 0xBF58476D1CE4E5B9 ^ key[1] * 0x94D049BB133111EB
         ^ key[2] * _MIX) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return (z ^ (z >> 31)) % n_slots


def fid_slots(seq: np.ndarray, oid: np.ndarray, ver: np.ndarray,
              n_slots: int = DEFAULT_SLOTS) -> np.ndarray:
    """Vectorized ``fid_slot`` over FID columns (``batch.tfid_cols``):
    the identical splitmix64 mix, computed with wrapping uint64
    arithmetic across a whole batch at once."""
    with np.errstate(over="ignore"):
        z = (seq.astype(np.uint64) * np.uint64(0xBF58476D1CE4E5B9)
             ^ oid.astype(np.uint64) * np.uint64(0x94D049BB133111EB)
             ^ ver.astype(np.uint64) * np.uint64(_MIX))
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return ((z ^ (z >> np.uint64(31)))
                % np.uint64(n_slots)).astype(np.int64)


def _resolve_device(device=None) -> torch.device:
    """The device routing runs on: the card unless the caller asks for
    the CPU.  Raises when the card was asked for (explicitly or by
    default) and there is none — routing never moves to the host
    behind the caller's back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"routing runs on cuda or cpu, not {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for routing; "
                           "pass device='cpu' to route on the host")
    return dev


class SlotRouter:
    """Hashes batches' target FIDs to slots on one device.

    On the card, each batch's header rows are copied into a pinned
    staging buffer (reused across calls, grown on demand), moved to the
    GPU as one ``uint8 [N, 64]`` tensor, hashed by the CUDA kernel, and
    the int64 slots come back through a second pinned buffer.  On the
    CPU the kernel's plain PyTorch version hashes a copy of the rows.
    The lock covers replay reads racing the routing loop."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._rows: Optional[torch.Tensor] = None    # pinned uint8 [cap, 64]
        self._slots: Optional[torch.Tensor] = None   # pinned int64 [cap]
        self._lock = threading.Lock()

    def slots(self, batch: "R.RecordBatch", n_slots: int) -> np.ndarray:
        # a view that may be read-only (sealed segment, received frame):
        # copied, never handed to torch as it is
        rows = batch.header_rows()
        n = rows.shape[0]
        if n == 0:
            return np.empty(0, dtype=np.int64)
        if self.device.type == "cpu":
            return stream_ops.fid_slots_rows(torch.from_numpy(rows.copy()),
                                             n_slots).numpy()
        with self._lock:
            if self._rows is None or self._rows.shape[0] < n:
                cap = max(n, 1024)
                self._rows = torch.empty((cap, R.HDR_SIZE),
                                         dtype=torch.uint8, pin_memory=True)
                self._slots = torch.empty(cap, dtype=torch.int64,
                                          pin_memory=True)
            host = self._rows[:n]
            host.numpy()[...] = rows
            dev = host.to(self.device, non_blocking=True)
            out = self._slots[:n]
            out.copy_(stream_ops.fid_slots_rows(dev, n_slots),
                      non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            return out.numpy().copy()


_routers: Dict[torch.device, SlotRouter] = {}


def batch_slots(batch: "R.RecordBatch", n_slots: int = DEFAULT_SLOTS,
                device="cuda") -> np.ndarray:
    """Slot of every record's target FID, hashed from the batch's
    header rows on ``device`` (the CUDA kernel on the card, its plain
    PyTorch version on the CPU).  One ``SlotRouter`` per device, and its
    staging buffers, serve every call; a cluster keeps its own."""
    dev = _resolve_device(device)
    router = _routers.get(dev)
    if router is None:
        router = _routers.setdefault(dev, SlotRouter(dev))
    return router.slots(batch, n_slots)


class ClusterReplayReader:
    """Shard-filtered replay source over a cluster journal's history
    tier: reads the journal's compacted history + retained records
    (``JournalReplayReader``) and keeps only the rows whose target FID
    currently routes to this shard, so a replay-bootstrap subscription
    fanned in from every shard covers the stream exactly once.  Slot
    ownership is read at call time: a consumer bootstrapping *after* a
    failover sees the dead shard's history from the slots' new owners,
    and a bootstrap *interrupted* by a failover is rewound to its start
    on the survivors (``kill_shard`` → ``rewind_active_replays``) so
    re-routed slots are not skipped — redelivery, not loss.  The
    residual window mirrors the live path's cascading-failure caveat:
    a shard whose bootstrap already finished cannot be rewound (the
    client stopped polling ``fetch_replay``), so a failover in that
    window loses the dead shard's *unreplayed* share for that consumer.
    """

    def __init__(self, cluster: "LcapCluster", pid: str, shard_index: int):
        self.cluster = cluster
        self.pid = pid
        self.shard_index = shard_index
        self._reader = JournalReplayReader(cluster.journals[pid])

    def available_lo(self) -> int:
        return self._reader.available_lo()

    @property
    def floor_is_retention(self) -> bool:
        return self._reader.floor_is_retention

    def read(self, start: int, max_records: int = 1024):
        batch, nxt = self._reader.read(start, max_records)
        if len(batch):
            owner = self.cluster.routing.owner_array()
            mine = owner[self.cluster.batch_slots(batch)] \
                == self.shard_index
            if not bool(mine.all()):
                batch = batch.select(np.flatnonzero(mine))
        return batch, nxt


# ---------------------------------------------------------------------------
# Shard handles: one protocol, two deployments.
# ---------------------------------------------------------------------------
class LocalShard:
    """An in-process shard: direct method calls into an ``LcapProxy``."""

    #: in-process watermarks are a dict copy — never worth skipping
    remote = False

    def __init__(self, proxy: LcapProxy, index: int = 0):
        self.proxy = proxy
        self.index = index

    def add_source(self, pid: str, first: int = 1) -> None:
        self.proxy.add_source(pid, first)

    def set_replay_reader(self, pid: str, reader) -> None:
        src = self.proxy.producers.get(pid)
        if isinstance(src, PushSource):
            src.history_reader = reader

    def rewind_replays(self) -> None:
        self.proxy.rewind_active_replays()

    def offer_many(self, offers: Sequence[Tuple[str, R.RecordBatch, int]],
                   ) -> Dict[str, int]:
        self.proxy.offer_many(offers)
        return self.watermarks()

    # in-process: "send" applies immediately, "recv" reports the result
    def offer_send(self, offers: Sequence[Tuple[str, R.RecordBatch, int]],
                   ) -> None:
        self._pending = self.offer_many(offers)

    def offer_recv(self) -> Dict[str, int]:
        pending, self._pending = getattr(self, "_pending", {}), {}
        return pending

    def watermarks(self) -> Dict[str, int]:
        return dict(self.proxy.upstream_acked)

    def metrics(self) -> Dict[str, dict]:
        return self.proxy.metrics_snapshot()

    def lag(self) -> Dict[str, Dict[str, Dict[str, int]]]:
        return self.proxy.lag()

    def pump(self) -> int:
        moved = self.proxy.pump()
        self.proxy.flush_upstream()
        return moved

    def backend(self):
        from .session import _LocalBackend
        return _LocalBackend(self.proxy)

    def close(self) -> None:
        pass


class _Migration:
    """The one in-flight graceful migration: which slots are draining,
    where they are going, which shards must drain, and the per-producer
    handoff watermark recorded when the drain began (the highest
    journal index routed so far — exactly the replay-bootstrap handoff
    convention of ``LcapProxy._arm_replay_locked``)."""

    __slots__ = ("slots", "target", "sources", "handoff")

    def __init__(self, slots, target, sources, handoff):
        self.slots = frozenset(slots)
        self.target = int(target)
        self.sources = frozenset(sources)
        self.handoff: Dict[str, int] = dict(handoff)


class LcapCluster:
    """N proxy shards behind one coordinator; see the module docstring.

    ``producers`` are registered once, with the coordinator.  Shards
    are built in-process (``n_shards``) unless explicit handles are
    passed (``shards=[LocalShard(proxy), ...]``).  ``device`` is where
    routing hashes run: the card by default (``"cuda"``; raises when
    there is none), ``"cpu"`` for the kernel's plain version.
    """

    def __init__(self, producers: Dict[str, Llog], n_shards: int = 2,
                 shards: Optional[Sequence] = None,
                 n_slots: int = DEFAULT_SLOTS, batch_size: int = 1024,
                 modules=None, park_cap: int = 1 << 16, device=None,
                 **proxy_kwargs):
        if not 1 <= n_slots < stream_ops.MAX_SLOTS:
            raise ClusterError(f"n_slots must be in [1, 2^31), got {n_slots}")
        self.device = _resolve_device(device)
        self._router = SlotRouter(self.device)
        #: non-empty batches hashed to slots (one kernel launch each on
        #: the card)
        self.routing_reads = 0
        self._modules = list(modules or [])
        self._proxy_defaults = dict(proxy_kwargs)
        if shards is None:
            shards = [LocalShard(LcapProxy({}, modules=list(self._modules),
                                           batch_size=batch_size,
                                           **proxy_kwargs), index=i)
                      for i in range(n_shards)]
        if not shards:
            raise ClusterError("a cluster needs at least one shard")
        self.shards = list(shards)
        for i, shard in enumerate(self.shards):
            shard.index = i
        self.n_slots = n_slots
        self.batch_size = batch_size
        #: the current ownership snapshot; replaced (never mutated) on
        #: every topology change — see routing.RoutingTable
        self.routing = RoutingTable.initial(n_slots, len(self.shards))
        self.alive: List[bool] = [True] * len(self.shards)
        self.journals: Dict[str, Llog] = {}
        self.reader_ids: Dict[str, str] = {}
        self.cursors: Dict[str, int] = {}       # next journal index to route
        self.journal_acked: Dict[str, int] = {}
        #: shard index -> (pid -> last known shard watermark)
        self.shard_acked: List[Dict[str, int]] = [dict() for _ in self.shards]
        self._lock = threading.RLock()
        #: the one in-flight graceful migration (None when settled)
        self._migration: Optional[_Migration] = None
        #: records read for draining slots, held until the commit hands
        #: them to the new owner: (pid, batch, hi) in journal order
        self._parked: List[Tuple[str, R.RecordBatch, int]] = []
        self._parked_count = 0
        #: parking-buffer bound: when reached, the routing loop stops
        #: reading journals (backpressure) until the migration settles
        self.park_cap = park_cap
        self.stats = {"routed": 0, "routing_rounds": 0, "shards_failed": 0,
                      "failover_redelivered": 0, "journal_acks": 0,
                      "epoch_bumps": 0, "migrations_started": 0,
                      "migrations_completed": 0, "migrations_cancelled": 0,
                      "slots_migrated": 0, "parked_records": 0,
                      "shards_added": 0}
        for pid, log in producers.items():
            self.add_producer(pid, log)

    # ------------------------------------------------------------ topology
    @property
    def slot_owner(self) -> List[int]:
        """Read-only view of the current table's ownership; topology
        changes go through the routing operations (migrate/add/kill)."""
        return list(self.routing.slot_owner)

    @property
    def epoch(self) -> int:
        """The routing table's current epoch."""
        return self.routing.epoch

    def shard_of(self, key: Tuple[int, int, int]) -> int:
        """The shard currently owning target FID ``key``."""
        return self.routing.slot_owner[fid_slot(key, self.n_slots)]

    @property
    def live_shards(self) -> List:
        return [s for i, s in enumerate(self.shards) if self.alive[i]]

    # ------------------------------------------------------------ producers
    def add_producer(self, pid: str, log: Llog) -> None:
        """Register journal ``pid`` once, with the coordinator; every
        shard gains a push-fed source for it.  Like the single proxy
        (``Llog.attach_reader``), a fresh coordinator owes acks for the
        journal's whole live backlog, and a restarted one resumes at
        its own acked watermark, not at a trim point another reader may
        be holding back."""
        with self._lock:
            rid, start = log.attach_reader(f"lcap-{pid}")
            self.journals[pid] = log
            self.reader_ids[pid] = rid
            self.cursors[pid] = start
            self.journal_acked[pid] = start - 1
            for i, shard in enumerate(self.shards):
                if self.alive[i]:
                    self._shard_call(i, shard.add_source, pid, start)
                    self._shard_call(i, shard.set_replay_reader, pid,
                                     ClusterReplayReader(self, pid, i))
                self.shard_acked[i].setdefault(pid, start - 1)
            if self._migration is not None:
                # nothing of this journal was routed before the drain
                self._migration.handoff.setdefault(pid, start - 1)

    # -------------------------------------------------------------- routing
    def batch_slots(self, batch: R.RecordBatch) -> np.ndarray:
        """Slots of ``batch``'s target FIDs, hashed on the cluster's
        device — every routing decision of the cluster goes through
        here."""
        if len(batch):
            self.routing_reads += 1
        return self._router.slots(batch, self.n_slots)

    def _partition(self, batch: R.RecordBatch) -> List[np.ndarray]:
        """Row indices per shard, in batch (= journal) order."""
        owner = self.routing.owner_array()[self.batch_slots(batch)]
        return [np.flatnonzero(owner == i) for i in range(len(self.shards))]

    def _route(self) -> Tuple[int, List[int]]:
        """One routing round: read every journal forward, partition by
        FID slot, push one deep-batched offer burst per shard —
        including empty ones, which carry the watermark advance.
        Rows whose slot is draining (mid-migration) are parked instead
        of offered; when the parking buffer is full the round stops
        reading (backpressure) until the migration settles.
        Returns ``(records routed, remote shards whose offer replies
        already piggybacked their watermarks this round)``."""
        n = 0
        offers: List[List[Tuple[str, R.RecordBatch, int]]] = \
            [[] for _ in self.shards]
        owner_arr = self.routing.owner_array()
        drain = (self.routing.draining_mask()
                 if self._migration is not None else None)
        for pid, log in self.journals.items():
            while True:
                if drain is not None and self._parked_count >= self.park_cap:
                    break
                batch = log.read(self.cursors[pid], self.batch_size)
                if not batch:
                    break
                got = len(batch)
                hi = batch.packed_index(got - 1)
                self.cursors[pid] = hi + 1
                slots = self.batch_slots(batch)
                if drain is not None and bool(drain[slots].any()):
                    dmask = drain[slots]
                    parked_rows = np.flatnonzero(dmask)
                    self._parked.append((pid, batch.select(parked_rows), hi))
                    self._parked_count += int(parked_rows.size)
                    self.stats["parked_records"] += int(parked_rows.size)
                    keep = np.flatnonzero(~dmask)
                    owner = owner_arr[slots[keep]]
                    rows = [keep[owner == i]
                            for i in range(len(self.shards))]
                else:
                    owner = owner_arr[slots]
                    rows = [np.flatnonzero(owner == i)
                            for i in range(len(self.shards))]
                for i, shard_rows in enumerate(rows):
                    if self.alive[i]:
                        offers[i].append((pid, batch.select(shard_rows), hi))
                n += got
                if got < self.batch_size:
                    break
        # two-phase: fire every shard's burst first, then drain the
        # replies — the shards ingest their shares concurrently instead
        # of the coordinator serializing on one shard at a time
        sent = []
        for i, shard_offers in enumerate(offers):
            if shard_offers and self.alive[i]:
                self._shard_call(i, self.shards[i].offer_send, shard_offers)
                if self.alive[i]:          # send did not fail the shard
                    sent.append(i)
        covered = []
        for i in sent:
            if self.alive[i]:
                wm = self._shard_call(i, self.shards[i].offer_recv)
                if wm is not None:
                    self.shard_acked[i].update(wm)
                    if getattr(self.shards[i], "remote", False):
                        covered.append(i)
        self.stats["routed"] += n
        self.stats["routing_rounds"] += 1
        return n, covered

    def _shard_call(self, i: int, fn, *args):
        """Invoke a shard operation; a dead connection — or a shard
        that rejects the verb (``ClusterError`` from an error reply) —
        fails the shard over (slots re-routed, backlog redelivered)
        instead of killing the coordinator's routing loop."""
        try:
            return fn(*args)
        except (ConnectionError, OSError, ClusterError) as exc:
            self.kill_shard(i, reason=str(exc))
            return None

    def pump(self, pump_shards: bool = True) -> int:
        """One routing round; with ``pump_shards`` (in-process shards)
        also one dispatch cycle per shard, then collective-ack
        propagation."""
        with self._lock:
            moved, covered = self._route()
            if pump_shards:
                for i, shard in enumerate(self.shards):
                    if self.alive[i]:
                        got = self._shard_call(i, shard.pump)
                        moved += got or 0
                self._collect_watermarks(skip=covered)
            self._advance_migration_locked()
            self._ack_journals()
            return moved

    # ------------------------------------------------ elastic operations
    def migrate_slots(self, slots: Sequence[int], target: int) -> int:
        """Begin a live migration of ``slots`` to shard ``target``.

        The slots are marked draining at ``epoch + 1``: their current
        owners keep dispatching what they already ingested, while the
        routing loop parks newly read records for them.  The migration
        commits (on a later ``pump``/``collect_watermarks``) once every
        source shard's per-journal watermark reaches the handoff
        recorded here — i.e. its in-flight share of the drained slots
        is fully consumed and acknowledged — at which point ownership
        flips at ``epoch + 2`` and the parked journal tail is offered
        to the new owner.  No record is lost or delivered twice.

        Returns the number of slots actually draining (slots already
        owned by ``target`` are skipped).  One migration may be in
        flight at a time."""
        with self._lock:
            if self._migration is not None:
                raise ClusterError("a migration is already in flight")
            if not (0 <= target < len(self.shards)) or not self.alive[target]:
                raise ClusterError(f"migration target {target} is not a "
                                   "live shard")
            owner = self.routing.slot_owner
            move = sorted({int(s) for s in slots})
            if any(s < 0 or s >= self.n_slots for s in move):
                raise ClusterError("slot out of range")
            move = [s for s in move if owner[s] != target]
            if not move:
                return 0
            sources = {owner[s] for s in move}
            self.routing = self.routing.drain(move, target)
            self.stats["epoch_bumps"] += 1
            self.stats["migrations_started"] += 1
            self._migration = _Migration(
                slots=move, target=target, sources=sources,
                handoff={pid: self.cursors[pid] - 1
                         for pid in self.journals})
            # nothing in flight on the sources → commits immediately
            self._advance_migration_locked()
            return len(move)

    def _advance_migration_locked(self) -> None:
        """Commit the in-flight migration once every source shard's
        watermark shows its share of the drained slots consumed and
        acknowledged up to the handoff."""
        m = self._migration
        if m is None:
            return
        for src in m.sources:
            if not self.alive[src]:
                return                    # kill_shard cancels/absorbs it
            acked = self.shard_acked[src]
            for pid, h in m.handoff.items():
                if acked.get(pid, -1) < h:
                    return
        self._migration = None
        self.routing = self.routing.commit_drain()
        self.stats["epoch_bumps"] += 1
        self.stats["migrations_completed"] += 1
        self.stats["slots_migrated"] += len(m.slots)
        parked, self._parked, self._parked_count = self._parked, [], 0
        if self.alive[m.target]:
            if parked:
                wm = self._shard_call(m.target,
                                      self.shards[m.target].offer_many,
                                      parked)
                if wm is not None:
                    self.shard_acked[m.target].update(wm)
            # an interrupted replay bootstrap on the target has already
            # scanned (and filtered out) indices whose slots just moved
            # here; rewind it so they are revisited at the new epoch
            self._shard_call(m.target, self.shards[m.target].rewind_replays)

    def add_shard(self, shard=None, **proxy_kwargs) -> int:
        """Spin up shard N+1 while traffic flows: a fresh in-process
        shard (or an explicit handle) joins with zero slots and owes
        nothing routed before it joined — its push sources start at the
        current cursors, so it never holds the collective ack back.
        The epoch bumps so live consumers discover the wider shard set;
        records land on it once slots are migrated over
        (``migrate_slots`` / ``split_shard``)."""
        with self._lock:
            i = len(self.shards)
            if shard is None:
                kw = dict(self._proxy_defaults)
                kw.update(proxy_kwargs)
                shard = LocalShard(LcapProxy({}, modules=list(self._modules),
                                             batch_size=self.batch_size,
                                             **kw), index=i)
            shard.index = i
            self.shards.append(shard)
            self.alive.append(True)
            self.shard_acked.append({})
            self.stats["shards_added"] += 1
            for pid in self.journals:
                first = self.cursors[pid]
                self._shard_call(i, shard.add_source, pid, first)
                self._shard_call(i, shard.set_replay_reader, pid,
                                 ClusterReplayReader(self, pid, i))
                self.shard_acked[i][pid] = first - 1
            obs = getattr(self, "_obs", None)
            proxy = getattr(shard, "proxy", None)
            if obs is not None and proxy is not None:
                proxy.attach_registry(obs, {"shard": str(i)})
            if proxy is not None:
                # replicate group registrations: records routed to the
                # new shard park in each group's pending backlog until
                # that group's fan-in stream discovers the shard (epoch
                # bump) and subscribes — no window where the new shard
                # consumes-and-acks what a group never saw
                for other in self.shards[:i]:
                    peer = getattr(other, "proxy", None)
                    if peer is None:
                        continue
                    for gname in list(peer.groups):
                        proxy.ensure_group(gname)
            self.routing = self.routing.bumped()
            self.stats["epoch_bumps"] += 1
            return i

    def split_shard(self, source: Optional[int] = None,
                    **proxy_kwargs) -> int:
        """Shard split under load: add shard N+1 and migrate half of
        ``source``'s slot range (the most-loaded live shard when
        unspecified) to it while producers keep offering.  Returns the
        new shard's index; the migration commits asynchronously."""
        with self._lock:
            if self._migration is not None:
                raise ClusterError("a migration is already in flight")
            if source is None:
                counts = self.routing.counts(len(self.shards))
                live = [i for i in range(len(self.shards)) if self.alive[i]]
                source = max(live, key=lambda i: counts[i])
            elif not (0 <= source < len(self.shards)
                      and self.alive[source]):
                raise ClusterError(f"split source {source} is not a "
                                   "live shard")
            new = self.add_shard(**proxy_kwargs)
            mine = self.routing.slots_of(source)
            if mine:
                self.migrate_slots(mine[:(len(mine) + 1) // 2], new)
            return new

    def _redeliver_locked(self, moved: Sequence[int],
                          handoff: Dict[str, int]) -> int:
        """The shared migration invariant, forced flavor: re-read every
        journal above the per-producer handoff watermark and re-offer
        the rows whose slots are in ``moved`` to their current owners.
        Returns the number of records redelivered."""
        redelivered = 0
        owner_arr = self.routing.owner_array()
        moved_mask = np.zeros(self.n_slots, dtype=bool)
        moved_mask[list(moved)] = True
        for pid, log in self.journals.items():
            lo = max(log.first_index, handoff.get(pid, 0) + 1)
            end = self.cursors[pid]          # routed so far
            offers: List[List[Tuple[str, R.RecordBatch, int]]] = \
                [[] for _ in self.shards]
            while lo < end:
                batch = log.read(lo, self.batch_size)
                if not batch:
                    break
                slots = self.batch_slots(batch)
                idx = batch.indices_np().astype(np.int64)
                keep = np.flatnonzero((idx < end) & moved_mask[slots])
                hi = int(idx[-1])
                if keep.size:
                    owner = owner_arr[slots[keep]]
                    for o in np.unique(owner).tolist():
                        rows = keep[owner == o]
                        offers[o].append((pid, batch.select(rows),
                                          int(idx[rows[-1]])))
                    redelivered += int(keep.size)
                lo = hi + 1
            for i, shard_offers in enumerate(offers):
                if shard_offers and self.alive[i]:
                    self._shard_call(i, self.shards[i].offer_many,
                                     shard_offers)
        return redelivered

    def _reoffer_parked_locked(self, parked, moved_mask: np.ndarray,
                               drop_above: Dict[str, int]) -> None:
        """Hand a cancelled migration's parked records back to their
        current owners.  Rows in ``moved_mask`` slots above the dead
        shard's watermark (``drop_above``) are dropped — the forced
        journal re-read already redelivers them — so a cancel does not
        double-offer what both paths cover."""
        owner_arr = self.routing.owner_array()
        offers: List[List[Tuple[str, R.RecordBatch, int]]] = \
            [[] for _ in self.shards]
        for pid, batch, hi in parked:
            slots = self.batch_slots(batch)
            idx = batch.indices_np().astype(np.int64)
            cut = drop_above.get(pid, -1)
            keep = np.flatnonzero(~(moved_mask[slots] & (idx > cut)))
            if not keep.size:
                continue
            owner = owner_arr[slots[keep]]
            for o in np.unique(owner).tolist():
                rows = keep[owner == o]
                offers[o].append((pid, batch.select(rows), hi))
        for i, shard_offers in enumerate(offers):
            if shard_offers and self.alive[i]:
                wm = self._shard_call(i, self.shards[i].offer_many,
                                      shard_offers)
                if wm is not None:
                    self.shard_acked[i].update(wm)

    # ------------------------------------------------------------- acks
    def _collect_watermarks(self, skip: Sequence[int] = ()) -> None:
        """Poll live shards for their per-journal watermarks; remote
        shards whose offer replies already piggybacked them this round
        (``skip``) are not re-polled — the offer path replaced the
        separate watermark round-trip."""
        for i, shard in enumerate(self.shards):
            if self.alive[i] and i not in skip:
                wm = self._shard_call(i, shard.watermarks)
                if wm is not None:
                    self.shard_acked[i].update(wm)

    def collect_watermarks(self) -> None:
        """Refresh every live shard's per-journal watermark (the push
        sources' ``acked``) and propagate the collective minimum."""
        with self._lock:
            self._collect_watermarks()
            self._advance_migration_locked()
            self._ack_journals()

    def _ack_journals(self) -> None:
        live = [i for i in range(len(self.shards)) if self.alive[i]]
        if not live:
            return
        for pid, log in self.journals.items():
            horizon = min(self.shard_acked[i].get(pid,
                                                  self.journal_acked[pid])
                          for i in live)
            if horizon > self.journal_acked[pid]:
                log.ack(self.reader_ids[pid], horizon)
                self.journal_acked[pid] = horizon
                self.stats["journal_acks"] += 1

    # ------------------------------------------------------- observability
    def attach_registry(self, registry) -> None:
        """Publish coordinator metrics into ``registry`` and attach it
        to every in-process shard proxy (labeled by shard index).
        Remote shards keep their own registries, read via the
        ``metrics`` wire verb and merged by :meth:`metrics`."""
        self._obs = registry
        registry.register_collector(self._collect_samples)
        for i, shard in enumerate(self.shards):
            proxy = getattr(shard, "proxy", None)
            if proxy is not None:
                proxy.attach_registry(registry, {"shard": str(i)})

    def _collect_samples(self):
        with self._lock:
            stats = dict(self.stats)
            alive = list(self.alive)
            routing = self.routing
            owned = routing.counts(len(self.shards))
            acked = dict(self.journal_acked)
            cursors = dict(self.cursors)
            migrating = self._migration is not None
            parked = self._parked_count
            shard_lag = [sum(max(0, cursors[pid] - 1
                                 - self.shard_acked[i].get(
                                     pid, cursors[pid] - 1))
                             for pid in cursors)
                         for i in range(len(self.shards))]
        out = []
        for key, v in stats.items():
            out.append((f"lcap_cluster_{key}_total", "counter",
                        f"cluster stats[{key}]", {}, v))
        out.append(("lcap_routing_epoch", "gauge",
                    "routing table epoch (bumps on every topology "
                    "change)", {}, routing.epoch))
        out.append(("lcap_migration_in_flight", "gauge",
                    "1 while a slot migration is draining", {},
                    int(migrating)))
        out.append(("lcap_migration_parked_records", "gauge",
                    "records parked for draining slots", {}, parked))
        for i in range(len(alive)):
            lb = {"shard": str(i)}
            out.append(("lcap_shard_alive", "gauge",
                        "1 while the shard serves traffic", lb,
                        int(alive[i])))
            out.append(("lcap_shard_slots_owned", "gauge",
                        "routing slots currently owned", lb, owned[i]))
            out.append(("lcap_shard_dispatch_lag", "gauge",
                        "records routed but not yet acknowledged by "
                        "the shard (autoscaling signal)", lb,
                        shard_lag[i]))
        for pid in acked:
            lb = {"producer": pid}
            out.append(("lcap_journal_acked", "gauge",
                        "collective journal ack watermark", lb, acked[pid]))
            out.append(("lcap_journal_routed", "gauge",
                        "highest journal index routed to shards", lb,
                        cursors.get(pid, 1) - 1))
        return out

    def autoscale_signals(self) -> Dict[str, Dict[str, int]]:
        """Backpressure signals an external operator loop feeds into
        add/migrate decisions, per live shard: ``offer_queue_depth``
        (records admitted but not yet dispatched; ``-1`` for remote
        shards, whose depth is read from their own registry),
        ``dispatch_lag`` (records routed to the shard but not yet
        acknowledged by it) and ``slots_owned``.  The same numbers are
        exported through the registry as ``lcap_buffered_records`` and
        ``lcap_shard_dispatch_lag``."""
        with self._lock:
            counts = self.routing.counts(len(self.shards))
            out: Dict[str, Dict[str, int]] = {}
            for i, shard in enumerate(self.shards):
                if not self.alive[i]:
                    continue
                proxy = getattr(shard, "proxy", None)
                depth = proxy.buffered if proxy is not None else -1
                lag = sum(max(0, self.cursors[pid] - 1
                              - self.shard_acked[i].get(
                                  pid, self.cursors[pid] - 1))
                          for pid in self.journals)
                out[str(i)] = {"offer_queue_depth": depth,
                               "dispatch_lag": lag,
                               "slots_owned": counts[i]}
            return out

    def retention_horizons(self) -> Dict[str, int]:
        """Per producer, the oldest still-live cursor: the smallest
        journal index any current reader may still (re)read — the
        collective ack frontier (no group ever revisits below it), any
        unfinished replay bootstrap's rewind point on a live shard
        (active or parked durable), and the in-flight migration's
        handoff.  The stream-janitor (history.StreamJanitor) trims
        ``HistoryStore`` strictly below this, minus its floor."""
        with self._lock:
            out: Dict[str, int] = {}
            for pid in self.journals:
                h = self.journal_acked[pid] + 1
                if self._migration is not None:
                    h = min(h, self._migration.handoff.get(pid, h) + 1)
                for i, shard in enumerate(self.shards):
                    if not self.alive[i]:
                        continue
                    proxy = getattr(shard, "proxy", None)
                    if proxy is not None:
                        floor = proxy.replay_floor(pid)
                        if floor is not None:
                            h = min(h, floor)
                out[pid] = h
            return out

    def set_tenant_quota(self, tenant: str, **kw) -> None:
        """Install per-tenant delivery token buckets on every live
        in-process shard (see ``LcapProxy.set_tenant_quota``).  The
        rates apply *per shard* — a cluster-wide budget divides by the
        shard count at the caller."""
        with self._lock:
            for i, shard in enumerate(self.shards):
                proxy = getattr(shard, "proxy", None)
                if self.alive[i] and proxy is not None:
                    proxy.set_tenant_quota(tenant, **kw)

    def metrics(self) -> Dict[str, dict]:
        """One merged cluster registry snapshot.  Merging needs the
        observability plane (``obs/registry.merge_snapshots``), which
        this port does not carry yet: see ROADMAP.md, Queue 1, item 6
        (``obs/``, ``policy/`` and the rest of ``track/``)."""
        raise NotImplementedError(
            "LcapCluster.metrics needs the obs/ port (ROADMAP.md, "
            "Queue 1, item 6)")

    def lag(self) -> Dict[str, Dict[str, Dict[str, int]]]:
        """Consumer lag per (group, producer), aggregated over live
        shards: lags sum (each shard's lag is its own re-routed share),
        ``dispatch_hw`` takes the furthest shard, ``ack`` the slowest.
        Dead shards are excluded — after a kill, lag is reported
        against the survivors' watermarks only."""
        with self._lock:
            out: Dict[str, Dict[str, Dict[str, int]]] = {}
            for i, shard in enumerate(self.shards):
                if not self.alive[i]:
                    continue
                shard_lag = self._shard_call(i, shard.lag)
                for gname, pids in (shard_lag or {}).items():
                    gout = out.setdefault(gname, {})
                    for pid, ent in pids.items():
                        cur = gout.get(pid)
                        if cur is None:
                            gout[pid] = dict(ent)
                        else:
                            cur["lag"] += ent["lag"]
                            cur["in_flight"] += ent["in_flight"]
                            cur["dispatch_hw"] = max(cur["dispatch_hw"],
                                                     ent["dispatch_hw"])
                            cur["ack"] = min(cur["ack"], ent["ack"])
            return out

    # ------------------------------------------------------------ failover
    def kill_shard(self, index: int, reason: str = "killed") -> None:
        """Fail shard ``index`` — a *forced zero-handoff migration*
        through the same invariant as ``migrate_slots``: records above
        the handoff watermark whose slots moved are re-offered to the
        new owners at the next epoch.  Forced means the handoff cannot
        be negotiated — it collapses to the dead shard's own last
        per-journal watermark — so the unacknowledged backlog
        ``(acked, cursor]`` is re-read from the journals and
        redelivered: zero loss, at-least-once (the journal never
        trimmed past the dead shard's own watermark).  The dead shard's
        slots are reassigned round-robin to the survivors; a graceful
        migration the dead shard participated in is cancelled first and
        its parked records folded into the redelivery."""
        with self._lock:
            if not self.alive[index]:
                return
            self.alive[index] = False
            self.stats["shards_failed"] += 1
            survivors = [i for i in range(len(self.shards))
                         if self.alive[i]]
            if not survivors:
                raise ClusterError(
                    f"shard {index} failed ({reason}); no shards left")
            carry = []
            m = self._migration
            if m is not None and (index == m.target or index in m.sources):
                # the graceful path lost a participant: cancel it and
                # let the forced path below absorb the parked records
                self._migration = None
                self.routing = self.routing.cancel_drain()
                self.stats["epoch_bumps"] += 1
                self.stats["migrations_cancelled"] += 1
                carry, self._parked, self._parked_count = self._parked, [], 0
            # forced migration: handoff = the dead shard's own watermark
            handoff = {pid: self.shard_acked[index].get(pid, 0)
                       for pid in self.journals}
            moved = set(self.routing.slots_of(index))
            rr = itertools.cycle(survivors)
            self.routing = self.routing.reassign({s: next(rr)
                                                  for s in sorted(moved)})
            self.stats["epoch_bumps"] += 1
            # a bootstrap in progress on a survivor has already scanned
            # indices whose slots just moved here and filtered them out;
            # restart those replays from their start (at-least-once
            # through failover — the reducers re-apply a prefix)
            for i in survivors:
                self._shard_call(i, self.shards[i].rewind_replays)
            redelivered = self._redeliver_locked(moved, handoff)
            self.stats["failover_redelivered"] += redelivered
            if carry:
                moved_mask = np.zeros(self.n_slots, dtype=bool)
                if moved:
                    moved_mask[list(moved)] = True
                self._reoffer_parked_locked(carry, moved_mask, handoff)
            # the dead shard no longer gates the collective ack
            self._ack_journals()

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        for i, shard in enumerate(self.shards):
            try:
                shard.close()
            except OSError:
                pass
