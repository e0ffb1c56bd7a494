"""LCAP proxy — Lustre Changelog Aggregate and Publish (paper §III).

Broker between N producers (each exposing an ``Llog``) and M consumers:

- **greedy batched reads**: each ``pump()`` drains every producer's
  journal into an in-memory buffer (bounded; persistence stays upstream,
  which is what makes at-least-once acceptable — paper §III-A);
- **stream modules** pre-process batches at ingest (drop compensating
  pairs, reorder, filter — paper: shared-library modules);
- **consumer groups**: every record is delivered to *each* group and to
  exactly *one member* within a group (least-loaded dispatch →
  load-balanced processing);
- **ephemeral readers** receive only records ingested after they
  subscribed and never acknowledge (paper §IV-B);
- **collective acknowledgement**: a record is acknowledged upstream to
  the producer's journal only once every group has acknowledged it;
- **at-least-once**: when a consumer dies, its in-flight records are
  redelivered to surviving group members;
- **per-group backpressure**: a group with a saturated member parks its
  records (``Group.pending``, bounded by the outbox cap) while the
  other groups keep draining — one slow consumer never stalls the rest
  of the fleet;
- **restart resume**: the proxy registers as a named changelog reader
  per producer and, on restart, resumes at its *own* acked watermark —
  never at a trim point a slower co-registered reader holds back;
- **push-fed producers**: ``add_source``/``offer`` let a cluster
  coordinator (cluster.py) route record batches in by FID hash instead
  of the proxy pulling from a journal — the building block of the
  sharded deployment.

The unit of flow is a ``RecordBatch`` end to end: journals hand the
proxy zero-copy batch views, stream modules restructure them without
decoding payloads, and dispatch reads only the 8-byte packed index of
each record.  Records are materialized (one memcpy, still no decode)
only when placed in a consumer's outbox; per-consumer flag remapping
uses the plan cache in ``records`` and is a no-op for consumers that
ask for everything.

Subscriptions may carry an **op-type mask** in addition to the §IV-A
flag projection; both are enforced here at dispatch (server-side filter
pushdown): a record no subscriber asked for is acknowledged in place —
never materialized, never copied into an outbox.  Consumers that name a
**durable identity** (``name=``) survive disconnects: the proxy parks
their unacknowledged records and per-producer ack watermark under
``(group, name)`` for ``resume_ttl`` seconds, and a reconnecting
consumer under the same name resumes exactly at its cursor (its own
unacked records are replayed to it alone — no group-wide redelivery
storm).  Only when the park expires is the backlog redelivered to the
surviving members.

The core is synchronous (``pump()``) for determinism; ``LcapService``
(server.py) wraps it with a polling thread + TCP transport.
"""

from __future__ import annotations

import bisect
import itertools
import operator
import threading
import time
from collections import deque
from typing import (Callable, Deque, Dict, Iterable, List, Optional, Tuple)

import numpy as np

from . import records as R
from .ack import AckTracker
from .errors import (SubscriptionError, TenantError, UnknownConsumerError,
                     UnknownProducerError)
from .history import JournalReplayReader
from .llog import Llog
from .tenancy import TenantAccount, TenantPrincipal

Module = Callable[[R.RecordBatch], R.RecordBatch]

PERSISTENT = "persistent"
EPHEMERAL = "ephemeral"

_by_load = operator.attrgetter("load")   # Consumer.load, single definition


class PushSource:
    """Llog-protocol facade for a *push-fed* producer: a cluster
    coordinator (cluster.py) routes already-read record batches into the
    proxy with ``offer()`` instead of the proxy pulling from a journal.
    Reads return nothing, and upstream acks are recorded here for the
    coordinator to collect (the shard's per-journal watermark)."""

    __slots__ = ("producer_id", "first_index", "last_index", "acked",
                 "history_reader")

    def __init__(self, pid: str, first: int = 1):
        self.producer_id = pid
        self.first_index = first
        self.last_index = first - 1      # highest offered index
        self.acked = first - 1           # this shard's upstream watermark
        # replay source for push-fed shards: the cluster coordinator
        # installs a journal-backed, slot-filtered reader here so a
        # replay-bootstrap consumer on this shard can stream history
        self.history_reader = None

    def has_reader(self, rid: str) -> bool:
        return False

    def register_reader(self, name=None, resume: bool = False) -> str:
        return name or "push"

    def attach_reader(self, name: str) -> Tuple[str, int]:
        return name, self.first_index

    def read(self, start: int, max_records: int = 1024) -> R.RecordBatch:
        return R.RecordBatch.empty()     # push model: never pulled

    def ack(self, rid: str, index: int) -> None:
        if index > self.acked:
            self.acked = index


class _Outbox:
    """A consumer's delivery queue.  Entries are either single
    ``(pid, idx, packed)`` tuples (the per-record dispatch path) or
    whole stamped ``RecordBatch`` chunks (the columnar path) — a chunk
    enqueues and drains in O(1) and ``fetch_batches`` hands its rows
    out as a view, so the steady state never touches individual
    records.  ``len()`` counts *records*, matching the old deque of
    tuples that backpressure caps are written against."""

    __slots__ = ("_q", "_n")

    def __init__(self):
        self._q: Deque = deque()
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0

    def append(self, item: Tuple[str, int, bytes]) -> None:
        self._q.append(item)
        self._n += 1

    def append_chunk(self, pid: str, batch: R.RecordBatch,
                     idx: np.ndarray) -> None:
        self._q.append([pid, batch, idx, 0])   # mutable: [.., cursor]
        self._n += len(idx)

    def popleft(self) -> Tuple[str, int, bytes]:
        q = self._q
        e = q[0]
        if type(e) is tuple:
            q.popleft()
            self._n -= 1
            return e
        pid, batch, idx, pos = e               # explode one chunk row
        out = (pid, int(idx[pos]), batch.packed(pos))
        pos += 1
        if pos == len(idx):
            q.popleft()
        else:
            e[3] = pos
        self._n -= 1
        return out

    def pop_batches(self, max_records: int) -> List[Tuple[str,
                                                          R.RecordBatch]]:
        """Drain up to ``max_records`` as ``(pid, RecordBatch)`` runs.
        Chunks pop whole (or split at the budget boundary, a view);
        consecutive same-producer singles coalesce into one batch."""
        out: List[Tuple[str, R.RecordBatch]] = []
        q = self._q
        taken = 0
        run_pid: Optional[str] = None
        run_bufs: Optional[List[bytes]] = None
        while q and taken < max_records:
            e = q[0]
            if type(e) is tuple:
                pid, _idx, buf = e
                if run_pid != pid or run_bufs is None:
                    if run_bufs:
                        out.append((run_pid,
                                    R.RecordBatch.from_packed(run_bufs)))
                    run_pid, run_bufs = pid, []
                run_bufs.append(buf)
                q.popleft()
                self._n -= 1
                taken += 1
                continue
            if run_bufs:
                out.append((run_pid, R.RecordBatch.from_packed(run_bufs)))
                run_pid, run_bufs = None, None
            pid, batch, idx, pos = e
            avail = len(idx) - pos
            k = min(avail, max_records - taken)
            sub = batch if (pos == 0 and k == avail) else batch[pos:pos + k]
            out.append((pid, sub))
            taken += k
            self._n -= k
            if k == avail:
                q.popleft()
            else:
                e[3] = pos + k
        if run_bufs:
            out.append((run_pid, R.RecordBatch.from_packed(run_bufs)))
        return out


class _InFlight:
    """``(pid, idx) -> packed record`` for redelivery, stored either
    singly (dict) or as whole original-batch chunks with an alive mask
    so a columnar dispatch records a thousand in-flight entries in O(1)
    and a batched commit retires them with one vectorized membership
    test.  ``len()`` counts records (feeds ``Consumer.load``)."""

    __slots__ = ("_map", "_chunks", "_nchunk")

    def __init__(self):
        self._map: Dict[Tuple[str, int], bytes] = {}
        # [pid, batch, idx, alive mask (None == all), alive count]
        self._chunks: List[list] = []
        self._nchunk = 0

    def __len__(self) -> int:
        return len(self._map) + self._nchunk

    def __bool__(self) -> bool:
        return bool(self._map) or self._nchunk > 0

    def __setitem__(self, key: Tuple[str, int], buf: bytes) -> None:
        self._map[key] = buf

    def add_chunk(self, pid: str, batch: R.RecordBatch,
                  idx: np.ndarray) -> None:
        self._chunks.append([pid, batch, idx, None, len(idx)])
        self._nchunk += len(idx)

    def discard_many(self, pid: str, arr: np.ndarray) -> None:
        """Retire every ``(pid, i)`` for i in ``arr`` (int64 array);
        absent indices are ignored, like ``dict.pop(..., None)``."""
        if self._map:
            if len(self._map) * 4 < arr.size:
                # few singles, big ack batch: test each key against the
                # sorted ack array instead of popping per index
                lst = arr.tolist()
                n = len(lst)
                for key in [k for k in self._map if k[0] == pid]:
                    j = bisect.bisect_left(lst, key[1])
                    if j < n and lst[j] == key[1]:
                        del self._map[key]
            else:
                pop = self._map.pop
                for i in arr.tolist():
                    pop((pid, i), None)
        if not self._nchunk:
            return
        kept = []
        removed = 0
        for ch in self._chunks:
            if ch[0] != pid:
                kept.append(ch)
                continue
            hit = np.isin(ch[2], arr)
            if ch[3] is not None:
                hit &= ch[3]
            nhit = int(np.count_nonzero(hit))
            if nhit == 0:
                kept.append(ch)
                continue
            removed += nhit
            if nhit == ch[4]:
                continue                       # chunk fully retired
            ch[3] = ~hit if ch[3] is None else ch[3] & ~hit
            ch[4] -= nhit
            kept.append(ch)
        self._chunks = kept
        self._nchunk -= removed

    def items(self):
        yield from self._map.items()
        for pid, batch, idx, alive, nalive in self._chunks:
            rows = range(len(idx)) if alive is None \
                else np.flatnonzero(alive).tolist()
            for j in rows:
                yield (pid, int(idx[j])), batch.packed(j)


class Consumer:
    def __init__(self, cid: str, group: Optional[str], flags: int, mode: str,
                 types: Optional[Iterable[int]] = None,
                 name: Optional[str] = None,
                 tenant: Optional[TenantPrincipal] = None):
        self.cid = cid
        self.group = group
        self.flags = R.normalize_flags(flags)
        self.mode = mode
        self.types = frozenset(types) if types is not None else None
        self.name = name                     # durable identity within group
        #: visibility scope; None = trusted unscoped consumer.  Scope is
        #: enforced at dispatch exactly like the op-type mask (pushdown)
        self.tenant = tenant
        #: the proxy's per-tenant accounting record (quota buckets,
        #: delivered counters); installed at attach, shared per tenant
        self.account: Optional[TenantAccount] = None
        self.outbox = _Outbox()
        # (producer, index) -> packed record, for redelivery
        self.in_flight = _InFlight()
        self.acked_hi: Dict[str, int] = {}   # pid -> highest acked index
        self.alive = True
        self.delivered = 0
        # replay-bootstrap state: while any pid is listed here the
        # consumer streams history (fetch_replay); live fetches wait
        self.replay_src: Dict[str, object] = {}   # pid -> replay reader
        self.replay_pos: Dict[str, int] = {}      # pid -> next index
        self.replay_hw: Dict[str, int] = {}       # pid -> handoff watermark
        self.replay_lo: Dict[str, int] = {}       # pid -> bootstrap start

    @property
    def load(self) -> int:
        return len(self.outbox) + len(self.in_flight)

    def wants(self, rtype: int) -> bool:
        return self.types is None or rtype in self.types


class Group:
    def __init__(self, name: str):
        self.name = name
        self.members: Dict[str, Consumer] = {}
        self.trackers: Dict[str, AckTracker] = {}
        self.pending: Deque[Tuple[str, int, bytes]] = deque()  # no member yet
        self.durable: Dict[str, str] = {}    # durable name -> active cid
        # durable name -> (parked consumer, resume deadline)
        self.parked: Dict[str, Tuple[Consumer, float]] = {}

    def tracker(self, pid: str) -> AckTracker:
        if pid not in self.trackers:
            self.trackers[pid] = AckTracker()
        return self.trackers[pid]


class LcapProxy:
    def __init__(self, producers: Dict[str, Llog],
                 modules: Optional[List[Module]] = None,
                 batch_size: int = 1024, max_buffer: int = 1 << 20,
                 outbox_cap: int = 1 << 16, resume_ttl: float = 30.0,
                 dispatch_quantum: Optional[int] = None):
        self.producers = dict(producers)
        self.modules = list(modules or [])
        self.batch_size = batch_size
        self.max_buffer = max_buffer          # records, across buffered batches
        self.outbox_cap = outbox_cap
        self.resume_ttl = resume_ttl          # durable park window (seconds)
        # records dispatched per _dispatch call (None = drain the whole
        # buffer).  A server proxy sets a quantum so one pump never
        # holds the lock across a huge buffer while fetch/commit
        # requests from live consumers queue behind it.
        self.dispatch_quantum = dispatch_quantum
        self._lock = threading.RLock()
        self._cid_seq = itertools.count(1)
        self._ingest_rotation = itertools.count()  # producer fairness
        self.reader_ids: Dict[str, str] = {}
        self.cursors: Dict[str, int] = {}
        self.ingested: Dict[str, int] = {}
        self.upstream_acked: Dict[str, int] = {}
        # register as a regular changelog reader with every producer (§III)
        for pid, log in self.producers.items():
            self._register_producer(pid, log)
        self.groups: Dict[str, Group] = {}
        self.consumers: Dict[str, Consumer] = {}
        self._buffer: Deque[Tuple[str, R.RecordBatch]] = deque()
        self._buffered = 0                    # records currently in _buffer
        self.stats = {"ingested": 0, "dispatched": 0, "dropped_by_modules": 0,
                      "redelivered": 0, "acked_upstream": 0,
                      "ephemeral_drops": 0, "batches_ingested": 0,
                      "filtered_out": 0, "parked": 0, "resumed": 0,
                      "resume_replayed": 0, "parks_expired": 0,
                      "replayed": 0, "tenant_filtered": 0}
        #: tenant name -> TenantAccount (quota buckets + delivery
        #: counters), created lazily on first attach or set_tenant_quota
        self.tenants: Dict[str, TenantAccount] = {}
        # observability plane (attach_registry): None until attached, so
        # the hot path pays a single identity check when unused
        self._obs = None
        self._obs_pump_hist = None

    def _register_producer(self, pid: str, log: Llog) -> None:
        """Register with ``log`` as the lcap reader and position the
        ingest cursor (``Llog.attach_reader``).  A fresh proxy consumes
        the journal's whole live backlog and owes acks for it; a
        *restarted* proxy resumes at its own acked watermark, not at
        the journal's ``first_index`` — another registered reader
        lagging behind holds the trim point back, and re-ingesting
        records this proxy already delivered and acked would duplicate
        them to every group."""
        rid, start = log.attach_reader(f"lcap-{pid}")
        self.reader_ids[pid] = rid
        self.cursors[pid] = start
        self.ingested[pid] = start - 1
        self.upstream_acked[pid] = start - 1

    # ------------------------------------------------------------------ API
    def add_producer(self, pid: str, log: Llog) -> None:
        with self._lock:
            self.producers[pid] = log
            self._register_producer(pid, log)
            # live ephemeral consumers connected before this producer
            # joined: stamp their connection point, or ``since.get(pid,
            # -1)`` hands them every record already in the journal —
            # history, which §IV-B forbids
            for cons in self.consumers.values():
                if cons.mode == EPHEMERAL:
                    cons.since[pid] = log.last_index  # type: ignore

    def add_source(self, pid: str, first: int = 1) -> None:
        """Register a push-fed producer: the records of journal ``pid``
        arrive via ``offer()`` (routed there by a cluster coordinator)
        instead of being pulled.  ``first`` is the journal index the
        feed starts at; the shard's collective watermark for the journal
        is collected from the source's ``acked``."""
        self.add_producer(pid, PushSource(pid, first))

    def offer(self, pid: str, batch: R.RecordBatch,
              hi: Optional[int] = None) -> int:
        """Push a batch of journal ``pid`` records into the ingest
        buffer (the cluster-routing counterpart of ``_ingest``).

        ``hi`` is the highest journal index *scanned* on the caller's
        side — it may exceed the batch's own highest index when the
        records in between were routed to other shards, and the ingest
        watermark advances to it so a shard that owns none of a range
        still lets the collective upstream ack progress.  Re-offering
        records below the watermark (failover redelivery) never moves
        it backwards.  Returns the number of records admitted."""
        with self._lock:
            src = self.producers.get(pid)
            if src is None:
                raise UnknownProducerError(f"unknown producer {pid!r}")
            got = len(batch)
            if hi is None:
                if not got:
                    return 0
                hi = batch.packed_index(got - 1)
            if isinstance(src, PushSource) and hi > src.last_index:
                src.last_index = hi
            if got:
                kept = self._admit_locked(pid, batch, hi)
            else:                          # bare watermark advance
                kept = 0
                if hi > self.ingested.get(pid, -1):
                    self.ingested[pid] = hi
            self.stats["ingested"] += got
            if not kept:
                # a pure watermark advance (or a fully module-dropped
                # batch) completes this shard's position without any
                # consumer commit — propagate, exactly like the
                # filter-pushdown path in pump()
                self._flush_upstream_locked()
            return kept

    def offer_many(self, offers: Iterable[Tuple[str, R.RecordBatch,
                                                Optional[int]]]) -> int:
        """A whole routing round of ``(pid, batch, hi)`` offers admitted
        under one lock acquisition — the deep-batched cluster ingest
        path (one wire call, one lock, N batches)."""
        admitted = 0
        with self._lock:
            for pid, batch, hi in offers:
                admitted += self.offer(pid, batch, hi)
        return admitted

    def ensure_group(self, name: str) -> None:
        """Pre-create consumer group ``name`` with no members: records
        dispatched to it park in the group's pending backlog (and gate
        the collective ack) until a member subscribes.  This is how the
        cluster replicates existing group registrations onto a shard
        that joins *after* the groups did — nothing routed to the new
        shard is consumed-and-acked before the groups' fan-in streams
        discover it."""
        with self._lock:
            self.groups.setdefault(name, Group(name))

    def subscribe(self, group: Optional[str], flags: Optional[int] = None,
                  mode: str = PERSISTENT, cid: Optional[str] = None,
                  types: Optional[Iterable[int]] = None,
                  name: Optional[str] = None,
                  tenant: Optional[TenantPrincipal] = None) -> str:
        """Register a consumer; returns its cid.  See ``attach`` for the
        full subscription contract (this is the thin historical form)."""
        return self.attach(group, flags=flags, mode=mode, cid=cid,
                           types=types, name=name, tenant=tenant)["cid"]

    def attach(self, group: Optional[str], flags: Optional[int] = None,
               mode: str = PERSISTENT, cid: Optional[str] = None,
               types: Optional[Iterable[int]] = None,
               name: Optional[str] = None,
               resume: Optional[bool] = None,
               replay: Optional[object] = None,
               tenant: Optional[TenantPrincipal] = None) -> Dict:
        """Register a consumer and return ``{"cid", "resumed", "token"}``.

        Persistent consumers name a group and share its stream; ephemeral
        consumers pass ``mode=EPHEMERAL`` (group may be None) and only see
        records ingested afterwards.  ``flags`` is the §IV-A field
        projection (None = everything supported; unknown bits are masked
        here, the single enforcement point) and ``types`` the op-type
        mask — both pushed down to dispatch.  Masks are evaluated
        against the *live* membership at dispatch/redelivery time: a
        record no live member asks for is acknowledged in place, so
        groups that care about completeness should keep member masks
        homogeneous.  ``name`` makes a persistent consumer durable: if
        parked state exists under ``(group, name)`` the consumer
        resumes at its ack cursor, inheriting the parked flags/types
        unless new ones are passed (``resume=True`` demands that state
        exists, ``resume=False`` forbids using it).  The returned
        ``token`` maps producer -> highest acked index.

        ``replay`` bootstraps the consumer from the compacted history
        tier: ``True`` replays from the beginning, an integer from that
        journal index.  History batches are streamed first (via
        ``fetch_replay``); the live stream takes over at a per-producer
        handoff watermark recorded at attach time — no gap, no
        duplicate.  Replay requires every producer to have a replayable
        history source and, for persistent mode, a *fresh* group (a
        group with existing delivery state already consumed part of the
        stream and would double-apply it).

        ``tenant`` scopes the consumer to a ``TenantPrincipal``: only
        records whose jobid matches the tenant's scope are ever
        delivered (live, replay, redelivery, resume); everything else
        is acknowledged in place server-side, like the type mask.  A
        durable consumer's tenant parks with it — resuming under a
        *different* tenant (or dropping a parked tenant) raises
        ``TenantError``.
        """
        tenant = TenantPrincipal.from_wire(tenant)
        with self._lock:
            self._expire_parked_locked()
            if resume and not name:
                raise SubscriptionError("resume requires a durable "
                                        "consumer name")
            if replay not in (None, False):
                if resume:
                    raise SubscriptionError("replay cannot be combined "
                                            "with resume: a resumed durable "
                                            "consumer already has a cursor")
                if mode == PERSISTENT and group in self.groups:
                    raise SubscriptionError(
                        f"replay-bootstrap requires a fresh group "
                        f"({group!r} already has delivery state)")
            cid = cid or f"c{next(self._cid_seq)}"
            if cid in self.consumers:
                raise SubscriptionError(f"consumer {cid} exists")
            if mode == PERSISTENT:
                if not group:
                    raise SubscriptionError("persistent consumers need a "
                                            "group")
                grp = self.groups.setdefault(group, Group(group))
                if name:
                    if name in grp.durable:
                        raise SubscriptionError(
                            f"durable consumer {group}/{name} is already "
                            f"attached as {grp.durable[name]}")
                    if name in grp.parked:
                        if resume is False:
                            raise SubscriptionError(
                                f"durable consumer {group}/{name} has "
                                f"parked state; resume or forget it first")
                        return self._resume_locked(grp, name, cid, flags,
                                                   types, tenant)
                if resume:
                    raise UnknownConsumerError(
                        f"no parked state for durable consumer "
                        f"{group}/{name!r}")
                cons = Consumer(cid, group, flags, mode, types=types,
                                name=name, tenant=tenant)
                self._bind_tenant(cons)
                self._join_group(grp, cons)
                self._flush_upstream_locked()   # drain may ack in place
            elif mode == EPHEMERAL:
                if name:
                    raise SubscriptionError("ephemeral consumers cannot be "
                                            "durable")
                cons = Consumer(cid, None, flags, mode, types=types,
                                tenant=tenant)
                self._bind_tenant(cons)
                # connection point: nothing *emitted* before now (§IV-B).
                # Producer last_index, not the ingest cursor — records
                # journaled but not yet pumped at attach time are
                # history, regardless of poller timing.
                cons.since = {  # type: ignore[attr-defined]
                    pid: log.last_index
                    for pid, log in self.producers.items()}
            else:
                raise SubscriptionError(f"unknown mode {mode}")
            if replay not in (None, False):
                try:
                    self._arm_replay_locked(cons, replay)
                except Exception:
                    # the group was fresh (checked above): undo its
                    # creation so a failed replay attach leaves no state
                    if cons.mode == PERSISTENT:
                        self.groups.pop(cons.group, None)
                    raise
            self.consumers[cid] = cons
            return {"cid": cid, "resumed": False, "flags": cons.flags,
                    "token": dict(cons.acked_hi),
                    "replay": bool(cons.replay_pos)}

    def _join_group(self, grp: Group, cons: Consumer) -> None:
        grp.members[cons.cid] = cons
        if cons.name:
            grp.durable[cons.name] = cons.cid
        # drain records parked while the group had no members through
        # normal group dispatch (deliver is a dedup no-op).  The batch
        # hot loop in _dispatch inlines this same policy — keep the two
        # in step when changing either.
        pending, grp.pending = grp.pending, deque()
        for pid, idx, buf in pending:
            self._dispatch_to_group(grp, pid, idx, buf)

    def _resume_locked(self, grp: Group, name: str, cid: str,
                       flags: Optional[int],
                       types: Optional[Iterable[int]],
                       tenant: Optional[TenantPrincipal] = None) -> Dict:
        old = grp.parked[name][0]
        # tenant identity is part of the durable cursor: a bare resume
        # inherits the parked tenant, but a *different* principal can
        # never take over the cursor, and a parked scope can never be
        # widened by resuming with a different one — that would hand
        # one tenant another tenant's in-flight records
        if old.tenant is not None and tenant is not None \
                and tenant != old.tenant:
            raise TenantError(
                f"durable consumer {grp.name}/{name} is owned by tenant "
                f"{old.tenant.name!r}; cannot resume as {tenant.name!r}")
        if old.tenant is None and tenant is not None:
            raise TenantError(
                f"durable consumer {grp.name}/{name} parked unscoped; "
                f"resuming it under tenant {tenant.name!r} would "
                f"re-scope another identity's cursor")
        grp.parked.pop(name)
        # the parked subscription spec is the default: a bare
        # resume(group, name) keeps the filters the consumer declared;
        # passing flags/types explicitly overrides them
        cons = Consumer(cid, grp.name,
                        old.flags if flags is None else flags,
                        PERSISTENT,
                        types=old.types if types is None else types,
                        name=name, tenant=old.tenant)
        self._bind_tenant(cons)
        cons.acked_hi = old.acked_hi
        # an interrupted replay bootstrap continues where it stopped
        cons.replay_src = old.replay_src
        cons.replay_pos = old.replay_pos
        cons.replay_hw = old.replay_hw
        cons.replay_lo = old.replay_lo
        # exact cursor resume: everything the old incarnation had not
        # acked is replayed to the resuming consumer alone — the group
        # never sees a redelivery storm.  Records an explicitly
        # narrowed type mask no longer covers go back through group
        # dispatch instead (another member that wants them, or acked in
        # place) — cons is not yet a member, so it cannot get them.
        replayed = 0
        for (pid, idx), buf in sorted(old.in_flight.items()):
            if cons.wants(R.packed_type(buf)):
                self._hand_to(cons, pid, idx, buf)
                replayed += 1
            else:
                self._dispatch_to_group(grp, pid, idx, buf)
        self.stats["resumed"] += 1
        self.stats["resume_replayed"] += replayed
        self._join_group(grp, cons)
        self.consumers[cid] = cons
        self._flush_upstream_locked()       # narrowing may ack in place
        return {"cid": cid, "resumed": True, "flags": cons.flags,
                "token": dict(cons.acked_hi),
                "replay": bool(cons.replay_pos)}

    def unsubscribe(self, cid: str, failed: bool = False) -> None:
        """Remove a consumer for good (durable state included).  Its
        undelivered/unacked records go back to the group
        (at-least-once)."""
        with self._lock:
            cons = self.consumers.pop(cid, None)
            if cons is None:
                return
            cons.alive = False
            if cons.mode == EPHEMERAL:
                return
            grp = self.groups[cons.group]
            del grp.members[cid]
            if cons.name:
                grp.durable.pop(cons.name, None)
            # in_flight covers everything undelivered OR unacked (records
            # are tracked there from dispatch until ack), so it alone is
            # the redelivery backlog — using outbox too would duplicate
            # queued-but-unfetched records.
            self._redeliver(grp, cons)
            self._flush_upstream_locked()   # redelivery may ack in place

    def _redeliver(self, grp: Group, cons: Consumer) -> None:
        backlog = sorted(
            (pid, idx, buf) for (pid, idx), buf in cons.in_flight.items())
        self.stats["redelivered"] += len(backlog)
        for pid, idx, buf in backlog:
            self._dispatch_to_group(grp, pid, idx, buf)

    fail = lambda self, cid: self.unsubscribe(cid, failed=True)  # noqa: E731

    def disconnect(self, cid: str) -> None:
        """A consumer's connection went away without a clean close.
        Durable consumers are parked: their unacked records and ack
        cursor wait ``resume_ttl`` seconds under ``(group, name)`` for
        the same name to reconnect.  Anonymous consumers fail
        immediately (backlog redelivered to the group)."""
        with self._lock:
            cons = self.consumers.get(cid)
            if cons is None:
                return
            if cons.mode == EPHEMERAL or not cons.name:
                self.unsubscribe(cid, failed=True)
                return
            del self.consumers[cid]
            cons.alive = False
            grp = self.groups[cons.group]
            del grp.members[cid]
            grp.durable.pop(cons.name, None)
            grp.parked[cons.name] = (cons, self._now() + self.resume_ttl)
            self.stats["parked"] += 1

    def forget(self, group: str, name: str) -> None:
        """Drop a parked durable consumer without waiting for its TTL;
        its backlog is redelivered to the surviving members."""
        with self._lock:
            grp = self.groups.get(group)
            if grp is None or name not in grp.parked:
                raise UnknownConsumerError(
                    f"no parked state for durable consumer {group}/{name!r}")
            cons, _ = grp.parked.pop(name)
            self._redeliver(grp, cons)
            self._flush_upstream_locked()   # redelivery may ack in place

    _now = staticmethod(time.monotonic)

    def _expire_parked_locked(self) -> None:
        now = self._now()
        expired = False
        for grp in self.groups.values():
            if not grp.parked:
                continue
            for name in [n for n, (_, dl) in grp.parked.items() if dl <= now]:
                cons, _ = grp.parked.pop(name)
                self.stats["parks_expired"] += 1
                self._redeliver(grp, cons)
                expired = True
        if expired:
            self._flush_upstream_locked()   # redelivery may ack in place

    def expire_parked(self) -> None:
        """Redeliver the backlog of parked durable consumers whose
        resume window has lapsed (also runs on every ``pump``)."""
        with self._lock:
            self._expire_parked_locked()

    def _consumer(self, cid: str) -> Consumer:
        try:
            return self.consumers[cid]
        except KeyError:
            raise UnknownConsumerError(
                f"unknown or unsubscribed consumer {cid!r}") from None

    # ------------------------------------------------------------- ingest
    def _ingest(self) -> int:
        n = 0
        # rotate the producer order across pumps: draining dict order
        # first starves late producers whenever the buffer cap is hit
        # before the loop reaches them
        items = list(self.producers.items())
        if len(items) > 1:
            k = next(self._ingest_rotation) % len(items)
            items = items[k:] + items[:k]
        for pid, log in items:
            while self._buffered < self.max_buffer:
                batch = log.read(self.cursors[pid], self.batch_size)
                if not batch:
                    break
                got = len(batch)
                hi = batch.packed_index(got - 1)   # journal order: ascending
                self.cursors[pid] = hi + 1
                self._admit_locked(pid, batch, hi)
                n += got
                if got < self.batch_size:
                    break
        self.stats["ingested"] += n
        return n

    def _admit_locked(self, pid: str, batch: R.RecordBatch, hi: int) -> int:
        """Run the stream modules over ``batch`` and buffer the
        survivors; advance the ingest watermark to ``hi`` (the highest
        *scanned* journal index, which may exceed the highest kept one).
        Shared by the pull path (``_ingest``) and the push path
        (``offer``); returns how many records were kept."""
        got = len(batch)
        kept = batch
        for mod in self.modules:
            kept = mod(kept)
        if not isinstance(kept, R.RecordBatch):      # legacy list module
            kept = R.RecordBatch.from_records(kept)
        self.stats["dropped_by_modules"] += got - len(kept)
        if len(kept):
            self._buffer.append((pid, kept))
            self._buffered += len(kept)
        if hi > self.ingested.get(pid, -1):
            self.ingested[pid] = hi
        self.stats["batches_ingested"] += 1
        return len(kept)

    # ----------------------------------------------------------- dispatch
    def _hand_to(self, cons: Consumer, pid: str, idx: int, buf: bytes) -> None:
        # remote remap: strip fields the consumer did not ask for (§IV-A)
        out = R.remap_cached(buf, R.packed_flags(buf) & cons.flags)
        cons.outbox.append((pid, idx, out))
        cons.in_flight[(pid, idx)] = buf
        cons.delivered += 1
        if cons.account is not None:
            cons.account.charge(1, len(buf))
        self.stats["dispatched"] += 1

    def _dispatch_to_group(self, grp: Group, pid: str, idx: int,
                           buf: bytes) -> None:
        grp.tracker(pid).deliver(idx)
        live = [m for m in grp.members.values() if m.alive]
        if not live:
            grp.pending.append((pid, idx, buf))
            return
        want = [m for m in live if m.wants(R.packed_type(buf))]
        if want and any(m.tenant is not None for m in want):
            jb = R.packed_jobid(buf)
            kept = [m for m in want
                    if m.tenant is None or m.tenant.allows(jb)]
            if not kept and want:
                self.stats["tenant_filtered"] += 1
            want = kept
        if not want:                             # pushdown: nobody asked
            grp.tracker(pid).ack(idx)
            self.stats["filtered_out"] += 1
            return
        cons = min(want, key=_by_load)           # least-loaded (§III-A)
        self._hand_to(cons, pid, idx, buf)

    def _saturated(self, grp: Group) -> bool:
        cap = self.outbox_cap
        return any(len(m.outbox) >= cap
                   for m in grp.members.values() if m.alive)

    # ------------------------------------------------------------- tenancy
    def _bind_tenant(self, cons: Consumer) -> None:
        """Point the consumer at its tenant's shared accounting record
        (created on first sight) so the hot path charges quota with one
        attribute read instead of a dict lookup."""
        if cons.tenant is not None:
            cons.account = self.tenants.setdefault(
                cons.tenant.name, TenantAccount(cons.tenant.name))

    def set_tenant_quota(self, tenant: str,
                         records_per_s: Optional[float] = None,
                         bytes_per_s: Optional[float] = None,
                         burst_records: Optional[float] = None,
                         burst_bytes: Optional[float] = None) -> None:
        """Install (or clear, with both rates None) delivery token
        buckets for ``tenant``.  An over-quota tenant's groups park
        through the per-group backpressure path and resume as the
        buckets refill — records are delayed, never lost."""
        with self._lock:
            acct = self.tenants.setdefault(tenant, TenantAccount(tenant))
            acct.set_quota(records_per_s, bytes_per_s,
                           burst_records, burst_bytes)

    def _quota_blocked(self, grp: Group) -> bool:
        """True when any live member's tenant has an exhausted bucket:
        the whole group parks (backpressure is per group, and a group
        is one logical subscriber)."""
        for m in grp.members.values():
            if m.alive and m.account is not None and m.account.exhausted:
                return True
        return False

    def _blocked(self, grp: Group) -> bool:
        return self._saturated(grp) or self._quota_blocked(grp)

    def _refill_quota_locked(self) -> None:
        if self.tenants:
            now = self._now()
            for acct in self.tenants.values():
                acct.refill(now)

    @staticmethod
    def _spread(loads: List[int], k: int) -> List[int]:
        """How many of ``k`` records each member takes when every record
        goes to the currently least-loaded member.  Matches the scalar
        loop exactly: each assignment raises that member's load by 2
        (outbox + in_flight), ties break on list position.

        Closed form instead of simulating k heap pops: member ``j``'s
        successive pick keys are ``loads[j], loads[j]+2, loads[j]+4,
        ...`` and the scalar loop takes the k lexicographically
        smallest ``(key, j)`` pairs, so counts fall out of the k-th
        smallest key (binary search) plus position-ordered tie-breaks
        at that key."""
        if len(loads) == 1:
            return [k]
        if not k:
            return [0] * len(loads)
        arr = np.asarray(loads, dtype=np.int64)
        # smallest T with >= k pick keys valued <= T
        lo, hi = int(arr.min()), int(arr.min()) + 2 * k
        while lo < hi:
            mid = (lo + hi) // 2
            if int(np.where(arr <= mid,
                            (mid - arr) // 2 + 1, 0).sum()) >= k:
                hi = mid
            else:
                lo = mid + 1
        counts = np.where(arr <= lo - 1, (lo - 1 - arr) // 2 + 1, 0)
        rem = k - int(counts.sum())
        if rem:                       # members holding a key == T, in
            at = np.flatnonzero(      # list position order
                (arr <= lo) & ((lo - arr) % 2 == 0))
            counts[at[:rem]] += 1
        return counts.tolist()

    def _fast_eligible(self, groups, ephemerals, states_sat, total: int,
                       done: int) -> bool:
        """Whole-batch columnar dispatch preserves the scalar loop's
        observable behavior only when nothing can interrupt the batch:
        no quantum boundary, no group without live members or with a
        parked backlog, and enough outbox headroom that not even the
        most loaded member could hit the cap mid-batch."""
        q = self.dispatch_quantum
        if q is not None and done + total > q:
            return False
        cap = self.outbox_cap
        for g in groups:
            if states_sat[g.name] or g.pending:
                return False
            live_out = [len(m.outbox) for m in g.members.values() if m.alive]
            if not live_out or max(live_out) + total >= cap:
                return False
        return all(len(c.outbox) + total <= cap for c in ephemerals)

    def _dispatch_batch(self, pid: str, batch: R.RecordBatch,
                        groups, ephemerals) -> Tuple[int, int]:
        """Columnar whole-batch dispatch (the hot path): one header
        decode, one bulk tracker delivery per group, boolean-mask type
        pushdown, water-fill assignment, and O(1) chunk handoff to each
        chosen member.  Returns (dispatched, filtered_out)."""
        total = len(batch)
        idx = batch.indices_np().astype(np.int64)
        types: Optional[np.ndarray] = None
        jobids: Optional[np.ndarray] = None
        dispatched = 0
        filtered_out = 0
        tenant_filtered = 0
        all_rows = np.arange(total)

        def jobid_cols() -> np.ndarray:
            # one jobid gather per batch, shared by every scoped
            # consumer in this call: the uint64 word form when every
            # scope fits a machine word (the overwhelmingly common
            # case), else a byte matrix trimmed to the widest scope
            # entry (NUL padding makes the tail bytes redundant)
            w = 1
            word = True
            for g2 in groups:
                for m2 in g2.members.values():
                    if m2.alive and m2.tenant is not None:
                        w = max(w, m2.tenant.mask_width)
                        word = word and m2.tenant.word_scoped
            for c2 in ephemerals:
                if c2.tenant is not None:
                    w = max(w, c2.tenant.mask_width)
                    word = word and c2.tenant.word_scoped
            return batch.jobid_word() if word else batch.jobid_col(w)
        for g in groups:
            live = [m for m in g.members.values() if m.alive]
            tracker = g.tracker(pid)
            tracker.deliver_many(idx)
            scoped = any(m.tenant is not None for m in live)
            if scoped and len(live) == 1:
                # the common shape — one scoped member — needs no
                # bitset partition: one scope mask, a two-way split
                # (and no split at all when every row is in scope)
                m = live[0]
                if jobids is None:
                    jobids = jobid_cols()
                sm = m.tenant.scope_mask(jobids)
                if m.types is not None:
                    if types is None:
                        types = batch.types_np()
                    tm = np.isin(types, sorted(m.types))
                    sm &= tm
                    nf = int(tm.sum() - sm.sum())
                else:
                    nf = int(total - sm.sum())
                tenant_filtered += nf
                if nf and m.account is not None:
                    m.account.filtered_records += nf
                if sm.all():
                    parts = [(live, all_rows)]
                else:
                    parts = [(live, np.flatnonzero(sm)),
                             ([], np.flatnonzero(~sm))]
            elif scoped:
                # tenant pushdown: eligibility depends on (type, jobid),
                # so rows partition by the per-member eligibility bitset
                # — one vectorized scope mask per scoped member, one
                # water-fill per distinct set, never per record
                if types is None:
                    types = batch.types_np()
                if jobids is None:
                    jobids = jobid_cols()
                key = np.zeros(total, dtype=np.int64)
                key_any = np.zeros(total, dtype=bool)  # type-eligible only
                for bit, m in enumerate(live):
                    if m.types is None and m.tenant is None:
                        key |= np.int64(1) << bit
                        key_any[:] = True
                        continue
                    if m.types is not None:
                        tmask = np.isin(types, sorted(m.types))
                    else:
                        tmask = np.ones(total, dtype=bool)
                    key_any |= tmask
                    if m.tenant is not None:
                        sm = tmask & m.tenant.scope_mask(jobids)
                        if m.account is not None:
                            nf = int(tmask.sum() - sm.sum())
                            if nf:
                                m.account.filtered_records += nf
                        tmask = sm
                    key |= tmask.astype(np.int64) << bit
                parts = []
                for k in np.unique(key).tolist():
                    rows = np.flatnonzero(key == k)
                    members = [m for bit, m in enumerate(live)
                               if (k >> bit) & 1]
                    if not members:
                        # out-of-scope rows a type-eligible member would
                        # otherwise have received: the tenant mask (not
                        # the type mask) is what acked them in place
                        tenant_filtered += int(key_any[rows].sum())
                    parts.append((members, rows))
            elif any(m.types is not None for m in live):
                if types is None:
                    types = batch.types_np()
                # rows partition by *eligible member set*: one water-fill
                # per distinct set, never per record
                classes: Dict[tuple, List[int]] = {}
                for t in np.unique(types).tolist():
                    want = tuple(m.cid for m in live if m.wants(t))
                    classes.setdefault(want, []).append(t)
                parts = []
                for want, ts in classes.items():
                    rows = np.flatnonzero(np.isin(types, ts))
                    members = [m for m in live if m.cid in set(want)]
                    parts.append((members, rows))
            else:
                parts = [(live, all_rows)]
            for members, rows in parts:
                if not members:              # pushdown: nobody asked
                    tracker.ack_many(idx[rows])
                    filtered_out += len(rows)
                    continue
                counts = self._spread([m.load for m in members], len(rows))
                lo = 0
                for m, cnt in zip(members, counts):
                    if not cnt:
                        continue
                    sel = rows[lo:lo + cnt]
                    lo += cnt
                    sub = batch if len(sel) == total else batch.select(sel)
                    m.outbox.append_chunk(pid, sub.project(m.flags),
                                          idx[sel])
                    m.in_flight.add_chunk(pid, sub, idx[sel])
                    m.delivered += cnt
                    if m.account is not None:
                        m.account.charge(cnt, sub.nbytes)
                    dispatched += cnt
        for c in ephemerals:
            mask = idx > c.since.get(pid, -1)   # type: ignore[attr-defined]
            if c.types is not None:
                if types is None:
                    types = batch.types_np()
                mask &= np.isin(types, sorted(c.types))
            if c.tenant is not None:
                if jobids is None:
                    jobids = jobid_cols()
                sm = mask & c.tenant.scope_mask(jobids)
                if c.account is not None:
                    nf = int(mask.sum() - sm.sum())
                    if nf:
                        c.account.filtered_records += nf
                mask = sm
            rows = np.flatnonzero(mask)
            if not rows.size:
                continue
            sub = batch if rows.size == total else batch.select(rows)
            c.outbox.append_chunk(pid, sub.project(c.flags), idx[rows])
            if c.account is not None:
                c.account.charge(rows.size, sub.nbytes)
        if tenant_filtered:
            self.stats["tenant_filtered"] += tenant_filtered
        return dispatched, filtered_out

    def _dispatch(self) -> int:
        n = 0
        cap = self.outbox_cap
        groups = list(self.groups.values())
        ephemerals = [c for c in self.consumers.values()
                      if c.mode == EPHEMERAL and c.alive]
        # per-tenant quota: refill the token buckets once per dispatch;
        # a group whose tenant is over quota parks exactly like a group
        # with a saturated member (the same backpressure path) and
        # drains again as the buckets refill
        self._refill_quota_locked()
        # backpressure is per *group*: a group with a saturated member
        # parks its records under grp.pending while the other groups
        # keep draining.  Groups that have recovered drain their parked
        # backlog first (journal order is older than the buffer).
        for g in groups:
            if not any(m.alive for m in g.members.values()):
                continue    # memberless: records stay parked until join
            while g.pending and not self._blocked(g):
                pid, idx, buf = g.pending.popleft()
                self._dispatch_to_group(g, pid, idx, buf)
        n_sat = 0
        states_sat = {}
        for g in groups:
            s = self._saturated(g)
            if not s and self._quota_blocked(g):
                s = True
                for m in g.members.values():
                    if m.alive and m.account is not None \
                            and m.account.exhausted:
                        m.account.quota_blocked_pumps += 1
            states_sat[g.name] = s
            n_sat += s
        # every group saturated: stall the whole dispatch — requeued
        # batch views are cheaper than per-record parked copies, and
        # nothing could drain anyway (ephemerals wait too, as before)
        if groups and n_sat == len(groups):
            return 0
        pflags = R.packed_flags
        remap = R.remap_cached
        by_load = _by_load

        def stamp(cons: Consumer, buf: bytes) -> bytes:
            # remote remap: strip fields the consumer did not ask for
            # (§IV-A); identity (no copy) when it asked for everything
            src = pflags(buf)
            want = src & cons.flags
            return buf if want == src else remap(buf, want)

        dispatched = 0
        filtered_out = 0
        halt = False
        quantum = self.dispatch_quantum
        while self._buffer:
            pid, batch = self._buffer.popleft()
            self._buffered -= len(batch)
            if self._fast_eligible(groups, ephemerals, states_sat,
                                   len(batch), n):
                d, f = self._dispatch_batch(pid, batch, groups, ephemerals)
                dispatched += d
                filtered_out += f
                n += len(batch)
                if quantum is not None and n >= quantum:
                    break
                continue
            # per-(batch, group) state — membership cannot change while
            # the proxy lock is held: [group, tracker, live members,
            # pushdown active, rtype -> eligible-members cache,
            # saturated, tenant-scoped]
            states = []
            for g in groups:
                live = [m for m in g.members.values() if m.alive]
                states.append([g, g.tracker(pid), live,
                               any(m.types is not None for m in live), {},
                               states_sat[g.name],
                               any(m.tenant is not None for m in live)])
            need_type = any(st[3] for st in states) or \
                any(c.types is not None for c in ephemerals)
            pjobid = R.packed_jobid
            packed_index = batch.packed_index
            packed_type = batch.packed_type
            packed = batch.packed
            total = len(batch)
            stop = None
            for i in range(total):
                idx = packed_index(i)
                rtype = packed_type(i) if need_type else -1
                # pushdown means a record may reach no outbox at all:
                # materialize the packed bytes only on first real use
                buf = None
                jb = None          # lazily extracted jobid, shared by groups
                for st in states:
                    grp, tracker, live, filtered, eligible, full_g, \
                        scoped = st
                    tracker.deliver(idx)
                    if not live or full_g:
                        # no member yet, or per-group backpressure:
                        # park for this group alone; drained on join /
                        # recovery.  A group whose parked backlog
                        # reaches the outbox cap halts the whole
                        # dispatch: beyond that window the healthy
                        # groups intentionally degrade to a trickle
                        # (one record per pump) rather than let parked
                        # copies grow unboundedly — operators should
                        # fail or expire a consumer stuck that long.
                        if buf is None:
                            buf = packed(i)
                        grp.pending.append((pid, idx, buf))
                        if full_g and len(grp.pending) >= cap:
                            halt = True
                        continue
                    if filtered:
                        want = eligible.get(rtype)
                        if want is None:
                            want = eligible[rtype] = \
                                [m for m in live if m.wants(rtype)]
                        if not want:
                            # nobody in this group asked for this op
                            # type: acknowledged in place, never copied
                            tracker.ack(idx)
                            filtered_out += 1
                            continue
                    else:
                        want = live
                    if scoped:
                        # tenant pushdown, scalar flavor: out-of-scope
                        # records are acked in place for the scoped
                        # members, never copied
                        if buf is None:
                            buf = packed(i)
                        if jb is None:
                            jb = pjobid(buf)
                        kept = []
                        for m in want:
                            if m.tenant is None or m.tenant.allows(jb):
                                kept.append(m)
                            elif m.account is not None:
                                m.account.filtered_records += 1
                        if not kept:
                            tracker.ack(idx)
                            filtered_out += 1
                            self.stats["tenant_filtered"] += 1
                            continue
                        want = kept
                    cons = want[0] if len(want) == 1 else min(want,
                                                              key=by_load)
                    if buf is None:
                        buf = packed(i)
                    cons.outbox.append((pid, idx, stamp(cons, buf)))
                    cons.in_flight[(pid, idx)] = buf
                    cons.delivered += 1
                    if cons.account is not None:
                        cons.account.charge(1, len(buf))
                    dispatched += 1
                    if len(cons.outbox) >= cap:
                        st[5] = True
                        states_sat[grp.name] = True
                        n_sat += 1
                        if n_sat == len(groups):
                            halt = True   # nobody left to drain for
                for cons in ephemerals:
                    if idx <= cons.since.get(pid, -1):  # type: ignore
                        continue  # emitted before connection (§IV-B)
                    if not cons.wants(rtype):
                        continue  # pushdown for ephemerals: just skip
                    if cons.tenant is not None:
                        if buf is None:
                            buf = packed(i)
                        if jb is None:
                            jb = pjobid(buf)
                        if not cons.tenant.allows(jb):
                            if cons.account is not None:
                                cons.account.filtered_records += 1
                            continue  # out of scope: skip, like the mask
                    if len(cons.outbox) >= cap:
                        self.stats["ephemeral_drops"] += 1   # radio semantics
                        continue
                    if buf is None:
                        buf = packed(i)
                    cons.outbox.append((pid, idx, stamp(cons, buf)))
                    if cons.account is not None:
                        cons.account.charge(1, len(buf))
                n += 1
                if halt or (quantum is not None and n >= quantum):
                    halt = True
                    stop = i + 1
                    break
            if stop is not None:
                if stop < total:
                    # the rest of the batch goes back (a view — no copy)
                    rest = batch[stop:]
                    self._buffer.appendleft((pid, rest))
                    self._buffered += len(rest)
                break
        self.stats["dispatched"] += dispatched
        self.stats["filtered_out"] += filtered_out
        return n

    def pump(self) -> int:
        """One synchronous ingest+dispatch cycle; returns records moved."""
        hist = self._obs_pump_hist
        t0 = time.monotonic() if hist is not None else 0.0
        with self._lock:
            self._expire_parked_locked()
            filtered_before = self.stats["filtered_out"]
            a = self._ingest()
            b = self._dispatch()
            if self.stats["filtered_out"] != filtered_before:
                # in-place acks (pushdown) can complete a producer's
                # collective watermark without any consumer commit —
                # propagate, or a fully-filtered journal never trims
                self._flush_upstream_locked()
        if hist is not None and a + b:
            hist.observe(time.monotonic() - t0)
        return a + b

    # ------------------------------------------------------------- replay
    def _replay_reader(self, src):
        """The replay source of a producer: journals read their own
        history tier + retained records; push-fed sources use whatever
        reader the cluster coordinator installed."""
        if isinstance(src, PushSource):
            return src.history_reader
        if isinstance(src, Llog):
            return JournalReplayReader(src)
        return getattr(src, "history_reader", None)

    def _arm_replay_locked(self, cons: Consumer, replay) -> None:
        """Record, per producer, the replay range ``[start, hw]`` where
        ``hw`` is the handoff watermark: the highest index the live
        stream will *not* deliver to this consumer.  For a fresh
        persistent group that is everything already dispatched (the
        buffered backlog and all later ingests arrive live); for an
        ephemeral consumer it is the §IV-B connection point."""
        start = 1 if replay is True else int(replay)
        if start < 1:
            raise SubscriptionError(f"replay index must be >= 1 ({start})")
        buf_lo: Dict[str, int] = {}
        for pid, batch in self._buffer:
            if len(batch):
                lo = int(batch.indices_np().min())
                if lo < buf_lo.get(pid, lo + 1):
                    buf_lo[pid] = lo
        for pid, src in self.producers.items():
            reader = self._replay_reader(src)
            if reader is None:
                raise SubscriptionError(
                    f"producer {pid!r} has no replayable history "
                    f"(attach a HistoryStore, or subscribe without replay)")
            lo = reader.available_lo()
            pid_start = start
            if pid_start < lo:
                if replay is not True or \
                        not getattr(reader, "floor_is_retention", False):
                    raise SubscriptionError(
                        f"history of {pid!r} starts at index {lo}; cannot "
                        f"replay from {start}")
                # replay=True means "from the oldest retained history";
                # a retention trim (history.StreamJanitor) legitimately
                # moves that point forward.  Only with a history tier
                # attached, though — a bare journal whose head trimmed
                # has no retention policy, the records are just gone.
                pid_start = lo
            if cons.mode == EPHEMERAL:
                hw = cons.since.get(pid, 0)  # type: ignore[attr-defined]
            elif pid in buf_lo:
                hw = buf_lo[pid] - 1
            else:
                hw = self.ingested.get(pid, 0)
            if hw >= pid_start:
                cons.replay_src[pid] = reader
                cons.replay_pos[pid] = pid_start
                cons.replay_hw[pid] = hw
                cons.replay_lo[pid] = pid_start

    def fetch_replay(self, cid: str, max_records: int = 1024,
                     ) -> Tuple[List[Tuple[str, R.RecordBatch]], bool]:
        """Stream the next slice of the consumer's replay bootstrap as
        ``(batches, done)``.  Batches carry compacted history (sparse
        indices) up to each producer's handoff watermark, filtered and
        remapped exactly like live dispatch; once ``done`` the live
        stream continues at watermark + 1 with no gap and no
        duplicate."""
        with self._lock:
            cons = self._consumer(cid)
            out: List[Tuple[str, R.RecordBatch]] = []
            taken = 0
            for pid in sorted(cons.replay_pos):
                if taken >= max_records:
                    break
                reader = cons.replay_src[pid]
                hw = cons.replay_hw[pid]
                pos = cons.replay_pos[pid]
                while pos <= hw and taken < max_records:
                    batch, nxt = reader.read(
                        pos, min(self.batch_size, max_records - taken))
                    nxt = max(nxt, pos + 1)          # always advance
                    bidx = batch.indices_np()
                    rows = np.flatnonzero((bidx >= pos) & (bidx <= hw))
                    if len(rows) != len(batch):
                        batch = batch.select(rows)
                    # same pre-processing as ingest (_admit_locked): a
                    # replay consumer must see the stream the modules
                    # produce, not the raw archive, or its state
                    # diverges from every live consumer's
                    for mod in self.modules:
                        batch = mod(batch)
                    if not isinstance(batch, R.RecordBatch):
                        batch = R.RecordBatch.from_records(batch)
                    if cons.types is not None:
                        rows = np.flatnonzero(
                            np.isin(batch.types_np(), sorted(cons.types)))
                        if len(rows) != len(batch):
                            batch = batch.select(rows)
                    if cons.tenant is not None and len(batch):
                        # replay honors the same scope pushdown as live
                        # dispatch: history a tenant may not see never
                        # leaves the proxy, even on bootstrap
                        rows = np.flatnonzero(
                            cons.tenant.scope_mask(batch.jobid_col()))
                        if len(rows) != len(batch):
                            self.stats["tenant_filtered"] += \
                                len(batch) - len(rows)
                            batch = batch.select(rows)
                    if len(batch):
                        if cons.account is not None:
                            cons.account.replayed_records += len(batch)
                        out.append((pid, batch.remap(cons.flags)))
                        taken += len(batch)
                    pos = min(nxt, hw + 1)
                cons.replay_pos[pid] = pos
                if pos > hw:
                    del cons.replay_pos[pid]
                    del cons.replay_src[pid]
                    del cons.replay_hw[pid]
            self.stats["replayed"] += taken
            return out, not cons.replay_pos

    def rewind_active_replays(self) -> int:
        """Restart every unfinished replay bootstrap from its original
        start index.  A cluster coordinator calls this on the surviving
        shards after a failover: re-routed slots now pass this shard's
        slot filter, and indices the bootstrap already scanned while
        the dead shard owned them would otherwise never be revisited.
        Re-replaying a prefix redelivers records (at-least-once during
        failover, exactly like the live path's backlog re-offer); a
        bootstrap that already *finished* cannot be rewound — the
        client stopped polling ``fetch_replay`` — which is the
        documented residual window of the cluster's cascading-failure
        caveat.  Returns the number of consumers rewound."""
        with self._lock:
            n = 0
            parked = (c for g in self.groups.values()
                      for c, _dl in g.parked.values())
            for cons in (*self.consumers.values(), *parked):
                if cons.replay_pos:
                    for pid in cons.replay_pos:
                        cons.replay_pos[pid] = cons.replay_lo[pid]
                    n += 1
            return n

    @property
    def buffered(self) -> int:
        """Records admitted but not yet dispatched — the offer-queue
        depth, the primary backpressure/autoscaling signal (also
        exported as ``lcap_buffered_records``)."""
        return self._buffered

    def replay_floor(self, pid: str) -> Optional[int]:
        """The lowest history index an *unfinished* replay bootstrap of
        producer ``pid`` may still (re)read, across active consumers
        and parked durables — a rewind (``rewind_active_replays``)
        sends the bootstrap back to its start, so the start is what
        pins retention, not the current position.  None when no
        bootstrap of ``pid`` is in flight."""
        with self._lock:
            floor = None
            parked = (c for g in self.groups.values()
                      for c, _dl in g.parked.values())
            for cons in (*self.consumers.values(), *parked):
                if pid in cons.replay_pos:
                    lo = cons.replay_lo[pid]
                    if floor is None or lo < floor:
                        floor = lo
            return floor

    def retention_horizons(self) -> Dict[str, int]:
        """Per journal-backed producer, the oldest still-live cursor
        (see ``LcapCluster.retention_horizons`` for the cluster
        flavor): the collective ack frontier, held back by any
        unfinished replay bootstrap's rewind point.  Input to the
        history tier's ``StreamJanitor``."""
        with self._lock:
            out: Dict[str, int] = {}
            for pid, src in self.producers.items():
                if not isinstance(src, Llog):
                    continue
                h = self.upstream_acked.get(pid, 0) + 1
                floor = self.replay_floor(pid)
                if floor is not None:
                    h = min(h, floor)
                out[pid] = h
            return out

    # -------------------------------------------------------------- fetch
    def fetch(self, cid: str,
              max_records: int = 256) -> List[Tuple[str, int, bytes]]:
        with self._lock:
            cons = self._consumer(cid)
            if cons.replay_pos:
                return []     # bootstrap first: drain fetch_replay
            out = []
            while cons.outbox and len(out) < max_records:
                out.append(cons.outbox.popleft())
            return out

    def fetch_batches(self, cid: str, max_records: int = 1024,
                      ) -> List[Tuple[str, R.RecordBatch]]:
        """Drain up to ``max_records`` from the consumer's outbox as
        per-producer ``RecordBatch``es (consecutive same-producer runs
        stay one batch — the unit that goes on the wire).  A consumer
        with an unfinished replay bootstrap gets nothing here until
        ``fetch_replay`` reports done — history strictly precedes the
        live stream."""
        with self._lock:
            cons = self._consumer(cid)
            if cons.replay_pos:
                return []
            return cons.outbox.pop_batches(max_records)

    # ---------------------------------------------------------------- ack
    def ack(self, cid: str, pid: str, index: int) -> None:
        self.commit(cid, {pid: (index,)})

    def ack_batch(self, cid: str, pid: str, indices: List[int]) -> None:
        """Acknowledge many records of one producer under a single lock
        acquisition and a single upstream-watermark propagation."""
        self.commit(cid, {pid: indices})

    def commit(self, cid: str, acks: Dict[str, Iterable[int]]) -> None:
        """Acknowledge records of any number of producers in one call
        (one lock acquisition, one upstream propagation per producer).
        Also advances the consumer's durable ack watermark — the cursor
        a resuming consumer of the same name picks up."""
        with self._lock:
            cons = self._consumer(cid)
            if cons.mode == EPHEMERAL:
                return  # ephemeral readers are not expected to ack (§IV-B)
            grp = self.groups[cons.group]
            for pid in acks:               # validate first: all or nothing
                if pid not in self.producers:
                    raise UnknownProducerError(f"unknown producer {pid!r}")
            for pid, indices in acks.items():
                if not isinstance(indices, (list, tuple, np.ndarray)):
                    indices = list(indices)
                arr = np.sort(np.asarray(indices, dtype=np.int64))
                if not arr.size:
                    continue
                cons.in_flight.discard_many(pid, arr)
                hi = int(arr[-1])
                if hi > cons.acked_hi.get(pid, 0):
                    cons.acked_hi[pid] = hi
                grp.tracker(pid).ack_many(arr)
                self._ack_upstream(pid)

    def _group_position(self, grp: Group, pid: str) -> int:
        tr = grp.tracker(pid)
        if tr.in_flight or grp.pending:
            return tr.watermark
        # nothing outstanding: the group is current through everything
        # ingested (records dropped by modules must not block the trim)
        return max(tr.watermark, self.ingested.get(pid, 0))

    def _ack_upstream(self, pid: str) -> None:
        if not self.groups:
            return
        horizon = min(self._group_position(g, pid)
                      for g in self.groups.values())
        if horizon > self.upstream_acked.get(pid, 0):
            self.producers[pid].ack(self.reader_ids[pid], horizon)
            self.upstream_acked[pid] = horizon
            self.stats["acked_upstream"] += 1

    def _flush_upstream_locked(self) -> None:
        for pid in self.producers:
            self._ack_upstream(pid)

    def flush_upstream(self) -> None:
        """Propagate collective acks for producers with no outstanding
        records (e.g. after module-dropped batches)."""
        with self._lock:
            self._flush_upstream_locked()

    # ------------------------------------------------------- observability
    def attach_registry(self, registry, labels: Optional[Dict[str, str]]
                        = None) -> None:
        """Publish this proxy's metrics into ``registry`` (any object
        with the ``MetricsRegistry`` factory surface).  Everything except
        the pump-latency histogram is exported by a pull collector read
        at snapshot time, so the dispatch hot path pays nothing."""
        base = dict(labels or {})
        names = tuple(sorted(base))
        self._obs = registry
        self._obs_pump_hist = registry.histogram(
            "lcap_pump_latency_seconds",
            "latency of one ingest+dispatch pump cycle",
            labels=names).labels(**base)
        registry.register_collector(lambda: self._collect_samples(base))

    def _collect_samples(self, base: Dict[str, str]):
        with self._lock:
            stats = dict(self.stats)
            buffered = self._buffered
            groups = [(g.name,
                       [(pid, tr.watermark, tr.in_flight,
                         tr.delivered_total, tr.acked_total)
                        for pid, tr in g.trackers.items()],
                       len(g.pending), len(g.parked))
                      for g in self.groups.values()]
            consumers = [(c.cid, c.group or "", c.mode, len(c.outbox),
                          len(c.in_flight)) for c in self.consumers.values()
                         if c.alive]
            live_by_tenant: Dict[str, int] = {}
            for c in self.consumers.values():
                if c.alive and c.tenant is not None:
                    live_by_tenant[c.tenant.name] = \
                        live_by_tenant.get(c.tenant.name, 0) + 1
            tenants = [(a.name, a.delivered_records, a.delivered_bytes,
                        a.replayed_records, a.filtered_records,
                        a.quota_blocked_pumps,
                        a.record_bucket.level if a.record_bucket else None,
                        a.byte_bucket.level if a.byte_bucket else None,
                        live_by_tenant.get(a.name, 0))
                       for a in self.tenants.values()]
            ingested_hw = dict(self.ingested)
            upstream = dict(self.upstream_acked)
        out = []
        for key, v in stats.items():
            out.append((f"lcap_proxy_{key}_total", "counter",
                        f"proxy stats[{key}]", base, v))
        out.append(("lcap_buffered_records", "gauge",
                    "records admitted but not yet dispatched", base,
                    buffered))
        for pid in ingested_hw:
            lb = dict(base, producer=pid)
            out.append(("lcap_ingest_watermark", "gauge",
                        "highest journal index ingested", lb,
                        ingested_hw[pid]))
            out.append(("lcap_upstream_acked", "gauge",
                        "collective ack watermark sent upstream", lb,
                        upstream.get(pid, 0)))
        for gname, trackers, pending, parked in groups:
            glb = dict(base, group=gname)
            out.append(("lcap_group_pending", "gauge",
                        "records parked by group backpressure", glb,
                        pending))
            out.append(("lcap_group_parked_consumers", "gauge",
                        "durable members parked awaiting resume", glb,
                        parked))
            for pid, wm, infl, deliv, acked in trackers:
                lb = dict(glb, producer=pid)
                out.append(("lcap_ack_watermark", "gauge",
                            "contiguous acked index per group/producer",
                            lb, wm))
                out.append(("lcap_ack_in_flight", "gauge",
                            "delivered but unacknowledged records", lb,
                            infl))
                out.append(("lcap_ack_delivered_records_total", "counter",
                            "records handed to the group (ack layer)", lb,
                            deliv))
                out.append(("lcap_ack_acked_records_total", "counter",
                            "records acknowledged by the group (ack layer)",
                            lb, acked))
        for cid, gname, mode, outbox, infl in consumers:
            lb = dict(base, consumer=cid, group=gname, mode=mode)
            out.append(("lcap_consumer_outbox_depth", "gauge",
                        "records staged for fetch", lb, outbox))
            out.append(("lcap_consumer_in_flight", "gauge",
                        "records fetched but uncommitted", lb, infl))
        for (tname, deliv, nbytes, replayed, filtered, blocked,
             rec_lvl, byte_lvl, live) in tenants:
            lb = dict(base, tenant=tname)
            out.append(("lcap_tenant_delivered_records_total", "counter",
                        "records delivered to this tenant's consumers",
                        lb, deliv))
            out.append(("lcap_tenant_delivered_bytes_total", "counter",
                        "payload bytes delivered to this tenant", lb,
                        nbytes))
            out.append(("lcap_tenant_replayed_records_total", "counter",
                        "history-tier records replayed to this tenant",
                        lb, replayed))
            out.append(("lcap_tenant_filtered_records_total", "counter",
                        "records this tenant's scope denied its "
                        "consumers (acked in place)", lb, filtered))
            out.append(("lcap_tenant_quota_blocked_pumps_total", "counter",
                        "dispatch rounds this tenant's groups parked on "
                        "quota", lb, blocked))
            out.append(("lcap_tenant_consumers", "gauge",
                        "live consumers under this tenant", lb, live))
            if rec_lvl is not None:
                out.append(("lcap_tenant_quota_level_records", "gauge",
                            "record token-bucket level (<=0 parks)", lb,
                            rec_lvl))
            if byte_lvl is not None:
                out.append(("lcap_tenant_quota_level_bytes", "gauge",
                            "byte token-bucket level (<=0 parks)", lb,
                            byte_lvl))
        return out

    def metrics_snapshot(self) -> Dict[str, dict]:
        """Snapshot of the attached registry (``{}`` when none)."""
        reg = self._obs
        return reg.snapshot() if reg is not None else {}

    def lag(self) -> Dict[str, Dict[str, Dict[str, int]]]:
        """Consumer lag per (group, producer): the distance between the
        dispatch watermark (highest journal index this proxy has
        ingested) and the group's collective ack cursor.  Never
        negative; exactly zero once nothing is outstanding, because the
        group position then jumps to the ingest watermark (module-
        dropped and filter-acked records don't hold lag up)."""
        with self._lock:
            out: Dict[str, Dict[str, Dict[str, int]]] = {}
            for gname, grp in self.groups.items():
                gout = out[gname] = {}
                for pid in self.producers:
                    hw = self.ingested.get(pid, 0)
                    tr = grp.trackers.get(pid)
                    pos = self._group_position(grp, pid)
                    gout[pid] = {
                        "dispatch_hw": hw,
                        "ack": pos,
                        "lag": max(0, hw - pos),
                        "in_flight": tr.in_flight if tr is not None else 0,
                    }
            return out
