"""Unified changelog client API: Subscription / Session / Stream.

One consumer-facing surface over both bindings (in-process proxy and
TCP), replacing the ``LocalReader``/``RemoteReader`` split:

- a ``Subscription`` declares *what* to consume: group, optional durable
  consumer name, delivery mode, §IV-A field projection (``flags``) and
  an op-type mask (``types``).  Both filters are pushed down to
  ``LcapProxy._dispatch`` — filtered records are never copied into the
  consumer's outbox, extending the paper's "remote remap" idea from
  fields to whole records;
- a ``Session`` is a connection: ``connect(proxy_or_address)`` returns
  one object with one implementation, backed by either the in-process
  proxy or the wire protocol (``subscribe``/``resume``/``commit``
  verbs, versioned messages);
- a ``Stream`` is a live subscription: iterate it for ``(producer,
  RecordBatch)`` pairs with per-producer cursor tracking and automatic
  batched acknowledgement (commit-on-iterate), or drive ``fetch()`` /
  ``commit()`` explicitly.

Durable consumers (``name=``) survive disconnects: the proxy parks
their unacked records and ack watermark under ``(group, name)``, and
``session.resume(group, name)`` (or a plain ``subscribe`` under the
same name) picks up exactly at the cursor — the stream's
``resume_token`` reports the per-producer watermark that was restored.

    session = lcap.connect(service.address)      # or connect(proxy)
    stream = session.subscribe(
        "ckpt", name="committer-0", types={R.CL_CKPT_WRITE})
    for pid, batch in stream:                    # auto-commits batches
        handle(pid, batch)

Failures surface as typed exceptions (``UnknownConsumerError``,
``SubscriptionError``) on both bindings, never as error strings.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, replace
from typing import Any, Deque, Dict, Iterator, List, Optional, Tuple, Union

from . import records as R
from .errors import (SessionError, SubscriptionError,  # noqa: F401 (re-export)
                     TenantError, UnknownConsumerError, raise_reply_error)
from .proxy import EPHEMERAL, PERSISTENT, LcapProxy
from .tenancy import TenantPrincipal
from .transport import PROTOCOL_VERSION, RpcClient

Address = Union[str, Tuple[str, int]]


@dataclass(frozen=True)
class Subscription:
    """Declarative consumer spec.

    group        consumer group (required for persistent mode)
    name         durable identity within the group; survives disconnects
    mode         PERSISTENT (default) or EPHEMERAL (§IV-B radio semantics)
    flags        CLF_* field projection; None = everything supported
    types        CL_* op-type mask; None = every operation
    auto_commit  iterate-commits-previous-batch (True) vs explicit commit()
    max_records  fetch granularity (records per fetch round)
    zero_fill    local remap fills requested-but-absent fields with
                 zeros (§IV-A, the default).  Columnar consumers whose
                 gathers already read absent extensions as zeros set
                 False: delivery becomes strip-only — identity, no
                 per-record work, when the proxy projection already
                 matched (the aggregation tier's hot path).
    replay       bootstrap from the compacted history tier: True = from
                 the beginning, an int = from that journal index.  The
                 stream yields history batches first, then hands off to
                 the live stream at a recorded watermark (no gap, no
                 duplicate).  Requires a fresh group for persistent mode.
    tenant       a ``TenantPrincipal`` (or its dict form) scoping the
                 subscription to the tenant's jobid namespace.  Scope is
                 enforced server-side at dispatch (pushdown): records
                 outside it are acknowledged in place and never leave
                 the proxy — isolation holds against impolite clients.
    """

    group: Optional[str] = None
    name: Optional[str] = None
    mode: str = PERSISTENT
    flags: Optional[int] = None
    types: Optional[frozenset] = None
    auto_commit: bool = True
    max_records: int = 1024
    replay: Optional[Union[bool, int]] = None
    zero_fill: bool = True
    tenant: Optional[TenantPrincipal] = None

    def __post_init__(self):
        if self.types is not None and not isinstance(self.types, frozenset):
            object.__setattr__(self, "types", frozenset(self.types))
        if self.tenant is not None and \
                not isinstance(self.tenant, TenantPrincipal):
            object.__setattr__(self, "tenant",
                               TenantPrincipal.from_wire(self.tenant))
        if self.mode == PERSISTENT and not self.group:
            raise SubscriptionError("persistent subscriptions need a group")
        if self.mode == EPHEMERAL and self.name:
            raise SubscriptionError("ephemeral subscriptions cannot be "
                                    "durable")


# ---------------------------------------------------------------------------
# One Session implementation, two backends.  A backend speaks attach /
# fetch / commit / unsubscribe / disconnect — the in-process one calls
# the proxy directly, the wire one frames the same verbs over TCP.
# ---------------------------------------------------------------------------
class _LocalBackend:
    def __init__(self, proxy: LcapProxy):
        self.proxy = proxy

    def attach(self, spec: Subscription,
               resume: Optional[bool] = None) -> Dict:
        return self.proxy.attach(spec.group, flags=spec.flags,
                                 mode=spec.mode, types=spec.types,
                                 name=spec.name, resume=resume,
                                 replay=spec.replay, tenant=spec.tenant)

    def fetch(self, cid: str, max_records: int,
              ) -> List[Tuple[str, R.RecordBatch]]:
        return self.proxy.fetch_batches(cid, max_records)

    def fetch_replay(self, cid: str, max_records: int,
                     ) -> Tuple[List[Tuple[str, R.RecordBatch]], bool]:
        return self.proxy.fetch_replay(cid, max_records)

    def commit(self, cid: str, acks: Dict[str, List[int]]) -> None:
        self.proxy.commit(cid, acks)

    def unsubscribe(self, cid: str) -> None:
        self.proxy.unsubscribe(cid)

    def disconnect(self, cid: str) -> None:
        self.proxy.disconnect(cid)

    crash = disconnect          # an in-process "connection" just vanishes

    def stats(self) -> Dict:
        return dict(self.proxy.stats)

    def metrics(self) -> Dict:
        return self.proxy.metrics_snapshot()

    def lag(self) -> Dict:
        return self.proxy.lag()

    def close(self) -> None:
        pass


class _WireBackend:
    def __init__(self, address: Tuple[str, int]):
        self.rpc = RpcClient(address)
        #: record-frame generation the server will emit, learned from
        #: the subscribe/resume reply (v1 until negotiated)
        self.wire = R.WIRE_V1
        #: highest routing epoch piggybacked on any reply from this
        #: shard (0 until a topology-aware peer stamps one); the fan-in
        #: layer watches it to detect topology changes mid-stream
        self.epoch = 0

    def _call(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        msg.setdefault("v", PROTOCOL_VERSION)
        reply = self.rpc.call(msg)
        raise_reply_error(reply)
        e = reply.get(R.CAP_EPOCH)
        if e is not None and int(e) > self.epoch:
            self.epoch = int(e)
        return reply

    def topology(self) -> Optional[Dict[str, Any]]:
        """The cluster topology snapshot (epoch, shard count, shard
        addresses) served by a topology-aware shard; None when the
        peer does not speak the verb."""
        try:
            return self._call({"op": "topology"})
        except SessionError:
            return None

    def attach(self, spec: Subscription,
               resume: Optional[bool] = None) -> Dict:
        reply = self._call({
            "op": "resume" if resume else "subscribe",
            "group": spec.group, "name": spec.name, "mode": spec.mode,
            "flags": spec.flags, "resume": resume, "replay": spec.replay,
            "types": sorted(spec.types) if spec.types is not None else None,
            "tenant": spec.tenant.to_wire() if spec.tenant is not None
            else None,
            # offer the column-bearing v2 record frame; an old server
            # ignores the key and keeps sending v1 (from_wire sniffs
            # the frame magic, so either way decodes transparently)
            "wire": R.WIRE_V2,
        })
        self.wire = int(reply.get("wire", R.WIRE_V1))
        return {"cid": reply["cid"], "resumed": reply.get("resumed", False),
                "flags": reply.get("flags"),
                "token": reply.get("token") or {},
                "replay": reply.get("replay", False)}

    def fetch(self, cid: str, max_records: int,
              ) -> List[Tuple[str, R.RecordBatch]]:
        reply = self._call({"op": "fetch", "cid": cid, "max": max_records})
        return [(pid, R.RecordBatch.from_wire(blob))
                for pid, blob in reply["batches"]]

    def fetch_replay(self, cid: str, max_records: int,
                     ) -> Tuple[List[Tuple[str, R.RecordBatch]], bool]:
        reply = self._call({"op": "fetch_replay", "cid": cid,
                            "max": max_records})
        return ([(pid, R.RecordBatch.from_wire(blob))
                 for pid, blob in reply["batches"]], reply["done"])

    def commit(self, cid: str, acks: Dict[str, List[int]]) -> None:
        self._call({"op": "commit", "cid": cid,
                    "acks": {pid: list(ix) for pid, ix in acks.items()}})

    def unsubscribe(self, cid: str) -> None:
        self._call({"op": "close", "cid": cid})

    def disconnect(self, cid: str) -> None:
        self._call({"op": "detach", "cid": cid})

    def crash(self, cid: str) -> None:
        # simulate a crash: drop the socket without deregistering; the
        # service's disconnect hook parks (durable) or fails (anonymous)
        self.rpc.close()

    def stats(self) -> Dict:
        return self._call({"op": "stats"})["stats"]

    def metrics(self) -> Dict:
        return self._call({"op": "metrics"})["metrics"]

    def lag(self) -> Dict:
        return self._call({"op": "lag"})["lag"]

    def close(self) -> None:
        self.rpc.close()


class Stream:
    """A live subscription: an iterator of ``(producer, RecordBatch)``
    pairs with cursor tracking and batched acknowledgement.

    Iterating auto-commits: each time the stream needs a new fetch
    round, every batch yielded so far is acknowledged in one ``commit``
    call (disable with ``auto_commit=False`` and call ``commit()``
    yourself — at-least-once either way).  Iteration stops when the
    proxy has nothing queued; poll again (or iterate again) later.
    """

    def __init__(self, session: "Session", spec: Subscription, info: Dict):
        self.session = session
        self.spec = spec
        self.cid: str = info["cid"]
        self.resumed: bool = info["resumed"]
        #: producer -> highest acked index (the durable cursor restored
        #: on resume, advanced by every commit)
        self.resume_token: Dict[str, int] = dict(info["token"])
        #: producer -> highest index delivered to the application
        self.cursors: Dict[str, int] = {}
        #: records delivered from the compacted history tier
        self.replayed = 0
        self._replaying: bool = bool(info.get("replay"))
        self._uncommitted: Dict[str, List[int]] = {}
        # (producer, batch, from_replay) — replayed batches are already
        # acknowledged upstream and are never commit-pending
        self._queue: Deque[Tuple[str, R.RecordBatch, bool]] = deque()
        # the proxy reports the *effective* projection (a resumed
        # consumer may have inherited a narrower parked mask); the
        # local remap must match it, not the spec's default
        flags = info.get("flags")
        self._flags = R.normalize_flags(spec.flags if flags is None
                                        else flags)
        self._closed = False

    # -- delivery ------------------------------------------------------------
    def _remap(self, batch: R.RecordBatch) -> R.RecordBatch:
        # local remap: zero-fill requested-but-absent fields (§IV-A).
        # With zero_fill=False only over-delivered fields are stripped
        # (columnar project; identity when the proxy already matched).
        if self.spec.zero_fill:
            return batch.remap(self._flags)
        return batch.project(self._flags)

    def _note(self, pid: str, batch: R.RecordBatch,
              track: bool = True) -> None:
        indices = batch.indices()
        if indices:
            # max, not last: a proxy module may reorder within a batch
            self.cursors[pid] = max(self.cursors.get(pid, 0), max(indices))
            if track and self.spec.mode != EPHEMERAL:
                self._uncommitted.setdefault(pid, []).extend(indices)

    @property
    def replaying(self) -> bool:
        """True while the history bootstrap is still streaming."""
        return self._replaying

    def _fetch_replay_round(self, cap: int,
                            ) -> List[Tuple[str, R.RecordBatch, bool]]:
        """One replay round: returns queued-entry triples; flips
        ``_replaying`` off when the proxy reports the bootstrap done."""
        out: List[Tuple[str, R.RecordBatch, bool]] = []
        while self._replaying and not out:
            batches, done = self.session._backend.fetch_replay(self.cid, cap)
            if done:
                self._replaying = False
            if not batches and not done:
                break                        # defensive: never spin
            for pid, batch in batches:
                out.append((pid, self._remap(batch), True))
        return out

    def fetch(self, max_records: Optional[int] = None,
              ) -> List[Tuple[str, R.RecordBatch]]:
        """Explicitly drain up to ``max_records`` queued records; every
        returned *live* batch becomes commit-pending (replayed history
        is already acknowledged upstream).  Locally requeued batches
        (see ``requeue``) are returned first."""
        cap = max_records or self.spec.max_records
        out, taken = [], 0
        while self._queue and taken < cap:
            pid, batch, from_replay = self._queue.popleft()
            self._note(pid, batch, track=not from_replay)
            if from_replay:
                self.replayed += len(batch)
            out.append((pid, batch))
            taken += len(batch)
        while self._replaying and taken < cap:
            round_ = self._fetch_replay_round(cap - taken)
            if not round_:
                break
            for pid, batch, _ in round_:
                self._note(pid, batch, track=False)
                self.replayed += len(batch)
                out.append((pid, batch))
                taken += len(batch)
        if taken < cap and not self._replaying:
            for pid, batch in self.session._backend.fetch(self.cid,
                                                          cap - taken):
                batch = self._remap(batch)
                self._note(pid, batch)
                out.append((pid, batch))
        return out

    def __iter__(self) -> Iterator[Tuple[str, R.RecordBatch]]:
        return self

    def __next__(self) -> Tuple[str, R.RecordBatch]:
        if not self._queue:
            if self.spec.auto_commit:
                self.commit()
            if self._replaying:
                self._queue.extend(
                    self._fetch_replay_round(self.spec.max_records))
            if not self._queue and not self._replaying:
                for pid, batch in self.session._backend.fetch(
                        self.cid, self.spec.max_records):
                    self._queue.append((pid, self._remap(batch), False))
            if not self._queue:
                raise StopIteration
        pid, batch, from_replay = self._queue.popleft()
        self._note(pid, batch, track=not from_replay)
        if from_replay:
            self.replayed += len(batch)
        return pid, batch

    def records(self) -> Iterator[Tuple[str, R.ChangelogRecord]]:
        """Record-level convenience over the batch iterator."""
        for pid, batch in self:
            for i in range(len(batch)):
                yield pid, batch.record(i)

    # -- acknowledgement -----------------------------------------------------
    @property
    def pending_commit(self) -> int:
        return sum(len(v) for v in self._uncommitted.values())

    def requeue(self, pairs: List[Tuple[str, R.RecordBatch]]) -> None:
        """Return delivered-but-unprocessed batches to the stream (a
        handler failed): they are withdrawn from the commit-pending set
        and handed out again at the front of the next fetch/iteration
        round, so a retrying consumer reprocesses them instead of
        wedging them in flight or acknowledging them unhandled."""
        for pid, batch in reversed(pairs):
            drop = set(batch.indices())
            left = [i for i in self._uncommitted.get(pid, ())
                    if i not in drop]
            if left:
                self._uncommitted[pid] = left
            else:
                self._uncommitted.pop(pid, None)
            # requeued batches re-enter as live; committing a replayed
            # index the group never delivered is a no-op upstream
            self._queue.appendleft((pid, batch, False))

    def commit(self) -> int:
        """Acknowledge every delivered-but-uncommitted record in one
        call; returns how many were acknowledged.  A failed commit
        keeps the records commit-pending, so a later retry still
        acknowledges them (at-least-once)."""
        if not self._uncommitted:
            return 0
        acks, self._uncommitted = self._uncommitted, {}
        try:
            self.session._backend.commit(self.cid, acks)
        except Exception:
            for pid, indices in acks.items():
                self._uncommitted.setdefault(pid, [])[:0] = indices
            raise
        for pid, indices in acks.items():
            self.resume_token[pid] = max(self.resume_token.get(pid, 0),
                                         max(indices))
        return sum(len(v) for v in acks.values())

    # -- lifecycle -----------------------------------------------------------
    def detach(self) -> None:
        """Let go of the connection but keep the durable identity: a
        later ``resume`` under the same (group, name) continues at the
        cursor.  For anonymous consumers this is a failure (backlog
        redelivered)."""
        if not self._closed:
            self._closed = True
            self.session._backend.disconnect(self.cid)
            self.session._forget(self)

    def close(self, failed: bool = False) -> None:
        """Deregister.  ``failed=True`` simulates a crash instead; on
        the wire binding that drops the Session's socket — taking every
        sibling stream of the same Session down with it, exactly like a
        real process death (use one Session per consumer when streams
        must fail independently)."""
        if self._closed:
            return
        self._closed = True
        if failed:
            self.session._backend.crash(self.cid)
        else:
            self.session._backend.unsubscribe(self.cid)
        self.session._forget(self)


def _make_spec(subscription: Union[Subscription, str, None],
               spec_kwargs: Dict) -> Subscription:
    """A ``Subscription``, or one built from kwargs (a plain string is
    shorthand for the group name) — shared by both session kinds."""
    if isinstance(subscription, Subscription):
        if spec_kwargs:
            raise SubscriptionError("pass either a Subscription or "
                                    "spec kwargs, not both")
        return subscription
    return Subscription(group=subscription, **spec_kwargs)


class FanInStream:
    """One logical stream over every shard of a cluster.

    A ``Subscription`` against a cluster attaches on each live shard;
    this facade owns one child ``Stream`` per shard and presents the
    single-stream surface: ``fetch``/iteration round-robin the shards,
    cursors stay per-(shard, producer) in the children, and ``commit``
    routes each batch's acknowledgement back to the shard that owns it
    (the child that delivered it) — never broadcast.

    A shard that dies mid-session is dropped (its index lands in
    ``lost``); its unacknowledged records are re-routed by the cluster
    coordinator to the surviving shards, so the group still sees them
    (at-least-once) through the remaining children.

    The stream also tracks the cluster's routing ``epoch``: every fetch
    round compares the session's current epoch against the one this
    stream last saw, and on a bump (slot migration, shard add/split,
    forced failover) re-resolves the shard set — shards that joined
    since subscribe get a fresh child ``Stream``, without restarting
    the consumer or disturbing the existing children's cursors.
    """

    def __init__(self, session: "ClusterSession", spec: Subscription,
                 children: List[Tuple[int, Stream]]):
        self.session = session
        self.spec = spec
        self._children = list(children)        # [(shard index, Stream)]
        self._rr = 0
        self._sources: Dict[int, Stream] = {}  # id(batch) -> owning child
        self.lost: List[int] = []
        #: routing epoch at which the shard set was last resolved
        self.epoch: int = session.current_epoch()

    def _maybe_refresh(self) -> None:
        """Re-resolve the shard set when the routing epoch moved past
        the one this stream subscribed under."""
        current = self.session.current_epoch()
        if current <= self.epoch:
            return
        self.epoch = current
        self.session._ensure_sessions()
        have = {i for i, _ in self._children} | set(self.lost)
        # a shard that joined after this stream subscribed: attach a
        # live child there.  No replay bootstrap — any history the new
        # shard's slots carry was already delivered by their previous
        # owners before the migration committed.
        child_spec = (replace(self.spec, replay=None)
                      if self.spec.replay else self.spec)
        for i, sess in self.session._sessions:
            if i in have or not self.session._shard_alive(i):
                continue
            try:
                self._children.append((i, sess._open(child_spec,
                                                     resume=None)))
            except (ConnectionError, OSError):
                continue

    # -- topology ------------------------------------------------------------
    @property
    def shards(self) -> List[int]:
        return [i for i, _ in self._children]

    @property
    def resumed(self) -> bool:
        return any(s.resumed for _, s in self._children)

    @property
    def resume_token(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for _, s in self._children:
            for pid, idx in s.resume_token.items():
                out[pid] = max(out.get(pid, 0), idx)
        return out

    @property
    def cursors(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for _, s in self._children:
            for pid, idx in s.cursors.items():
                out[pid] = max(out.get(pid, 0), idx)
        return out

    @property
    def shard_cursors(self) -> Dict[int, Dict[str, int]]:
        """Per-(shard, producer) delivery cursors."""
        return {i: dict(s.cursors) for i, s in self._children}

    @property
    def pending_commit(self) -> int:
        return sum(s.pending_commit for _, s in self._children)

    @property
    def replaying(self) -> bool:
        """True while any shard's history bootstrap is still
        streaming."""
        return any(s.replaying for _, s in self._children)

    @property
    def replayed(self) -> int:
        return sum(s.replayed for _, s in self._children)

    # -- failure handling ----------------------------------------------------
    def _drop(self, pair: Tuple[int, Stream]) -> None:
        if pair in self._children:
            self._children.remove(pair)
            self.lost.append(pair[0])

    def _live(self) -> List[Tuple[int, Stream]]:
        dead = [p for p in self._children
                if not self.session._shard_alive(p[0])]
        for p in dead:
            self._drop(p)
        return self._children

    # -- delivery ------------------------------------------------------------
    def fetch(self, max_records: Optional[int] = None,
              ) -> List[Tuple[str, R.RecordBatch]]:
        """Drain up to ``max_records`` across the shards, round-robin so
        one busy shard cannot starve the others.  Every returned batch
        becomes commit-pending on its owning shard."""
        cap = max_records or self.spec.max_records
        out: List[Tuple[str, R.RecordBatch]] = []
        self._maybe_refresh()
        children = self._live()
        taken = 0
        for k in range(len(children)):
            if taken >= cap:
                break
            pair = children[(self._rr + k) % len(children)]
            try:
                pairs = pair[1].fetch(cap - taken)
            except (ConnectionError, OSError):
                self._drop(pair)
                continue
            for pid, batch in pairs:
                self._sources[id(batch)] = pair[1]
                out.append((pid, batch))
                taken += len(batch)
        if children:
            self._rr = (self._rr + 1) % max(1, len(children))
        return out

    def __iter__(self) -> Iterator[Tuple[str, R.RecordBatch]]:
        return self

    def __next__(self) -> Tuple[str, R.RecordBatch]:
        """Round-robin the child iterators; each child keeps its own
        auto-commit contract (a batch is acknowledged one fetch round
        after it was yielded).  Stops when every shard is drained."""
        self._maybe_refresh()
        children = self._live()
        for k in range(len(children)):
            pair = children[(self._rr + k) % len(children)]
            try:
                item = next(pair[1])
            except StopIteration:
                continue
            except (ConnectionError, OSError):
                self._drop(pair)
                continue
            self._sources[id(item[1])] = pair[1]   # requeue routing
            self._rr = (self._rr + k + 1) % max(1, len(self._live()))
            return item
        raise StopIteration

    def records(self) -> Iterator[Tuple[str, R.ChangelogRecord]]:
        for pid, batch in self:
            for i in range(len(batch)):
                yield pid, batch.record(i)

    # -- acknowledgement -----------------------------------------------------
    def requeue(self, pairs: List[Tuple[str, R.RecordBatch]]) -> None:
        """Hand unprocessed batches back to their owning shard's stream
        (withdrawn from commit-pending, redelivered first).  Batches of
        one shard are requeued in one call so their relative order is
        preserved."""
        by_child: Dict[int, Tuple[Stream, List]] = {}
        for pid, batch in pairs:
            child = self._sources.get(id(batch))
            if child is None:
                raise SessionError("requeue of a batch this stream did "
                                   "not deliver")
            by_child.setdefault(id(child), (child, []))[1].append(
                (pid, batch))
        for child, child_pairs in by_child.values():
            child.requeue(child_pairs)

    def commit(self) -> int:
        """One logical commit: each shard receives exactly the
        acknowledgements for the records it delivered.  Returns the
        total acknowledged; a dead shard's pending acks are dropped
        (the cluster redelivers its records — at-least-once)."""
        total = 0
        for pair in list(self._children):
            try:
                total += pair[1].commit()
            except (ConnectionError, OSError):
                self._drop(pair)
        self._sources.clear()
        return total

    # -- lifecycle -----------------------------------------------------------
    def detach(self) -> None:
        for pair in list(self._children):
            try:
                pair[1].detach()
            except (ConnectionError, OSError):
                self._drop(pair)

    def close(self, failed: bool = False) -> None:
        for pair in list(self._children):
            try:
                pair[1].close(failed=failed)
            except (ConnectionError, OSError):
                self._drop(pair)


class ClusterSession:
    """A connection to a sharded cluster: one child ``Session`` per
    shard, one declarative surface.  ``subscribe``/``resume`` return a
    ``FanInStream`` that spans every live shard.

    The session is *topology-aware*: it can report the cluster's
    current routing epoch (``current_epoch``) and grow its shard set
    when the cluster does (``_ensure_sessions``).  Three discovery
    paths, in order of directness:

    - ``cluster=``   in-process ``LcapCluster`` — epoch and shard list
      read straight off the coordinator's routing table;
    - ``topology=``  a callable returning ``{"epoch", "shards",
      "addresses"}`` (``LcapClusterService.cluster_info``);
    - neither        the highest epoch piggybacked on any shard reply,
      with the ``topology`` wire verb probed for addresses when a bump
      is seen (falls back to a static shard set against pre-epoch
      daemons).
    """

    def __init__(self, sessions: List[Tuple[int, Session]],
                 alive=None, cluster=None, topology=None):
        self._sessions = list(sessions)
        self._alive = alive                  # callable: shard index -> bool
        self._cluster = cluster              # in-process LcapCluster
        self._topology = topology            # callable -> topology snapshot
        self._topology_unsupported = False

    def _shard_alive(self, index: int) -> bool:
        if self._alive is not None:
            return self._alive(index)
        if self._cluster is not None:
            alive = self._cluster.alive
            return index < len(alive) and alive[index]
        return True

    # -- topology ------------------------------------------------------------
    def current_epoch(self) -> int:
        """The cluster's routing epoch as this session can best see it
        (0 against a target with no epoch source at all)."""
        if self._cluster is not None:
            return self._cluster.routing.epoch
        if self._topology is not None:
            try:
                return int(self._topology()["epoch"])
            except (ConnectionError, OSError, KeyError, TypeError):
                pass
        # piggybacked epochs: the max any shard stamped on a reply
        return max((getattr(sess._backend, "epoch", 0)
                    for _i, sess in self._sessions), default=0)

    def _topology_snapshot(self) -> Optional[Dict]:
        """Current ``{"epoch", "shards", "addresses"}``, or None when
        no discovery path works (static wire shard set)."""
        if self._topology is not None:
            try:
                return self._topology()
            except (ConnectionError, OSError):
                return None
        if self._topology_unsupported:
            return None
        for i, sess in self._sessions:
            if not self._shard_alive(i):
                continue
            probe = getattr(sess._backend, "topology", None)
            if probe is None:                # in-process backend
                self._topology_unsupported = True
                return None
            try:
                reply = probe()
            except (ConnectionError, OSError):
                continue
            if reply is None:                # pre-epoch daemon
                self._topology_unsupported = True
                return None
            return reply
        return None

    def _ensure_sessions(self) -> None:
        """Open child sessions for shards that joined the cluster after
        this session connected (shard add / split)."""
        have = {i for i, _ in self._sessions}
        if self._cluster is not None:
            for i, shard in enumerate(self._cluster.shards):
                if i not in have and self._cluster.alive[i]:
                    self._sessions.append((i, Session(shard.backend())))
            return
        info = self._topology_snapshot()
        if not info:
            return
        for i, addr in enumerate(info.get("addresses") or []):
            if i not in have:
                try:
                    backend = _WireBackend(_parse_address(addr))
                except (ConnectionError, OSError):
                    continue
                self._sessions.append((i, Session(backend)))

    def subscribe(self, subscription: Union[Subscription, str, None] = None,
                  *, resume: Optional[bool] = None,
                  **spec_kwargs) -> FanInStream:
        spec = _make_spec(subscription, spec_kwargs)
        self._ensure_sessions()   # the shard set may have grown since connect
        children = []
        resumed_any = False
        for i, sess in self._sessions:
            if not self._shard_alive(i):
                continue
            if resume:
                # per-shard resume: a durable whose slots migrated (or
                # whose cluster grew) has parked state on *some* shards
                # only — resume where it exists, attach fresh elsewhere,
                # and fail only when no shard resumed at all
                try:
                    child = sess._open(spec, resume=True)
                    resumed_any = True
                except UnknownConsumerError:
                    child = sess._open(spec, resume=None)
            else:
                child = sess._open(spec, resume=resume)
            children.append((i, child))
        if not children:
            raise SessionError("no live shards to subscribe on")
        if resume and not resumed_any:
            for _i, child in children:
                try:
                    child.close()
                except (ConnectionError, OSError):
                    pass
            raise UnknownConsumerError(
                f"no shard holds parked state for durable consumer "
                f"{spec.group}/{spec.name!r}")
        return FanInStream(self, spec, children)

    def resume(self, group: str, name: str, **spec_kwargs) -> FanInStream:
        spec = Subscription(group=group, name=name, **spec_kwargs)
        return self.subscribe(spec, resume=True)

    def stats(self) -> Dict:
        """Summed proxy counters across live shards, plus the raw
        per-shard dicts under ``"per_shard"``."""
        per_shard: Dict[int, Dict] = {}
        total: Dict[str, int] = {}
        for i, sess in self._sessions:
            if not self._shard_alive(i):
                continue
            try:
                st = sess.stats()
            except (ConnectionError, OSError):
                continue
            per_shard[i] = st
            for key, val in st.items():
                if isinstance(val, (int, float)):
                    total[key] = total.get(key, 0) + val
        total["per_shard"] = per_shard
        return total

    def metrics(self) -> Dict:
        """Merged registry snapshots across live shards (counters and
        histograms summed, gauges labeled by shard)."""
        from ..obs.registry import merge_snapshots
        per_shard = {}
        for i, sess in self._sessions:
            if not self._shard_alive(i):
                continue
            try:
                snap = sess.metrics()
            except (ConnectionError, OSError):
                continue
            if snap:
                per_shard[str(i)] = snap
        return merge_snapshots(per_shard)

    def lag(self) -> Dict:
        """Per-(group, producer) lag aggregated over live shards: lags
        and in-flight sum, ``dispatch_hw`` takes the furthest shard,
        ``ack`` the slowest; per-shard views under ``"per_shard"``."""
        per_shard: Dict[int, Dict] = {}
        merged: Dict[str, Dict] = {}
        for i, sess in self._sessions:
            if not self._shard_alive(i):
                continue
            try:
                shard_lag = sess.lag()
            except (ConnectionError, OSError):
                continue
            per_shard[i] = shard_lag
            for gname, pids in shard_lag.items():
                gout = merged.setdefault(gname, {})
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
        merged["per_shard"] = per_shard
        return merged

    def close(self) -> None:
        for _i, sess in self._sessions:
            try:
                sess.close()
            except (ConnectionError, OSError):
                pass

    def __enter__(self) -> "ClusterSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Session:
    """A connection to one changelog proxy, local or remote.  Make one
    with ``connect``; open any number of subscriptions on it."""

    def __init__(self, backend):
        self._backend = backend
        self._streams: List[Stream] = []

    def subscribe(self, subscription: Union[Subscription, str, None] = None,
                  *, resume: Optional[bool] = None, **spec_kwargs) -> Stream:
        """Open a subscription.  Accepts a ``Subscription`` or builds one
        from kwargs (a plain string is shorthand for the group name).
        A durable name with parked state resumes transparently;
        ``resume=False`` refuses parked state instead (fresh identity or
        error), ``resume=True`` demands it (same as ``resume()``)."""
        return self._open(_make_spec(subscription, spec_kwargs),
                          resume=resume)

    def resume(self, group: str, name: str, **spec_kwargs) -> Stream:
        """Re-attach a durable consumer at its acknowledged cursor.
        Raises ``UnknownConsumerError`` when no parked state exists
        (never attached, expired, or already resumed)."""
        spec = Subscription(group=group, name=name, **spec_kwargs)
        return self._open(spec, resume=True)

    def _open(self, spec: Subscription, resume: Optional[bool]) -> Stream:
        info = self._backend.attach(spec, resume=resume)
        stream = Stream(self, spec, info)
        self._streams.append(stream)
        return stream

    def _forget(self, stream: Stream) -> None:
        if stream in self._streams:
            self._streams.remove(stream)

    def stats(self) -> Dict:
        return self._backend.stats()

    def metrics(self) -> Dict:
        """Typed metrics snapshot from the proxy's attached registry
        (``{}`` when no registry is attached); works over the wire."""
        return self._backend.metrics()

    def lag(self) -> Dict:
        """Per-(group, producer) consumer lag — dispatch watermark
        minus collective ack cursor; see ``LcapProxy.lag``."""
        return self._backend.lag()

    def close(self) -> None:
        try:
            for stream in list(self._streams):
                try:
                    stream.close()
                except OSError:
                    pass    # connection already gone; nothing to undo
        finally:
            self._backend.close()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _parse_address(address) -> Tuple[str, int]:
    if isinstance(address, str):
        host, _, port = address.rpartition(":")
        return (host, int(port))
    return tuple(address)


def connect(target: Union[LcapProxy, "LcapService", "LcapCluster",
                          "LcapClusterService", Address, List[Address]],
            ) -> Union[Session, ClusterSession]:
    """Open a ``Session`` (or, for sharded targets, a ``ClusterSession``
    that transparently fans subscriptions in from every shard) — one
    client API over every binding:

    - ``LcapProxy``                  in-process, single proxy
    - ``LcapService`` / ``(host, port)`` / ``"host:port"``   wire, single
    - ``LcapCluster``                in-process shards, fan-in
    - ``LcapClusterService``         its shard daemons' addresses, fan-in
    - a *list* of addresses          one wire session per shard, fan-in

    Close the session (or use it as a context manager) to release wire
    connections; closing individual streams only deregisters consumers.
    """
    from .cluster import LcapCluster, LcapClusterService
    if isinstance(target, LcapProxy):
        return Session(_LocalBackend(target))
    if isinstance(target, LcapCluster):
        sessions = [(i, Session(shard.backend()))
                    for i, shard in enumerate(target.shards)
                    if target.alive[i]]
        return ClusterSession(sessions, cluster=target)
    if isinstance(target, LcapClusterService):
        return ClusterSession(
            [(i, Session(_WireBackend(_parse_address(a))))
             for i, a in enumerate(target.addresses)],
            topology=target.cluster_info)
    if isinstance(target, list):           # a list of shard addresses
        return ClusterSession(
            [(i, Session(_WireBackend(_parse_address(a))))
             for i, a in enumerate(target)])
    address = getattr(target, "address", target)   # LcapService duck-type
    return Session(_WireBackend(_parse_address(address)))
