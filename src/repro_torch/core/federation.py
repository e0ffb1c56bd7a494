"""Federation — one global activity stream over many filesystems.

A site runs one LCAP plane (proxy or sharded cluster) per Lustre
filesystem; the audit/accounting layer wants a *single* stream across
all of them.  ``Federation`` joins named member planes — ``{"fs0":
cluster_a, "fs1": cluster_b}`` — into one consumer surface:

- ``subscribe`` opens the same declarative ``Subscription`` on every
  member and returns a ``FederatedStream`` of ``(origin, producer,
  batch)`` triples.  Each delivered ``RecordBatch`` is stamped with its
  member's origin tag (``batch.origin``, carried batch-level on the v2
  wire as a trailing frame — never per-record bytes), so downstream
  consumers can attribute activity to a filesystem without sniffing
  producer ids;
- per-member delivery positions live in a ``GlobalCursor``: one
  ``(origin, producer) -> index`` watermark map, advanced on delivery
  and snapshot-able for checkpointing.  Cursors never mix origins —
  producer ids are only unique *within* a member;
- members are consumed through their own sessions (``connect()`` per
  member), so a sharded member's epoch bumps, slot migrations and
  ``kill_shard`` failovers are absorbed by its ``FanInStream`` and
  stay invisible to the federated consumer;
- ``replay=`` bootstraps each member from *its own* history tier — a
  scalar applies to every origin, a ``{origin: value}`` dict gives
  per-origin start points (True = from the beginning, int = from that
  journal index, None/absent = live only);
- tenant scoping (``Subscription.tenant``) is pushed down to every
  member's proxies, so isolation holds per filesystem with no
  federation-level filtering;
- ``metrics()`` merges every member's registry snapshot with gauges
  relabeled by origin (``shard_label="origin"``), and ``stats()`` /
  ``lag()`` aggregate with per-origin breakdowns.

A member that dies mid-stream is dropped into ``FederatedStream.lost``
and the survivors keep flowing; unlike an intra-cluster shard death
there is no cross-member redelivery — filesystems are sovereign, their
records do not migrate between planes.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, Iterator, List, Optional, Tuple, Union

from . import records as R
from .errors import SessionError, UnknownConsumerError
from .session import (ClusterSession, FanInStream, Session, Stream,
                      Subscription, _make_spec, connect)

#: per-member child stream kinds a federation fans in
MemberStream = Union[Stream, FanInStream]


class GlobalCursor:
    """Per-(origin, producer) delivery watermarks for a federated
    stream: the federation-level analogue of ``Stream.cursors``, keyed
    by origin first because producer ids are only unique within one
    member filesystem."""

    __slots__ = ("positions",)

    def __init__(self,
                 positions: Optional[Dict[str, Dict[str, int]]] = None):
        #: origin -> producer -> highest index delivered
        self.positions: Dict[str, Dict[str, int]] = {
            o: dict(p) for o, p in (positions or {}).items()}

    def advance(self, origin: str, pid: str, index: int) -> None:
        per = self.positions.setdefault(origin, {})
        if index > per.get(pid, 0):
            per[pid] = index

    def position(self, origin: str, pid: str) -> int:
        return self.positions.get(origin, {}).get(pid, 0)

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        """A deep copy safe to checkpoint."""
        return {o: dict(p) for o, p in self.positions.items()}

    def merge(self, other: "GlobalCursor") -> None:
        for origin, per in other.positions.items():
            for pid, idx in per.items():
                self.advance(origin, pid, idx)

    def __eq__(self, other) -> bool:
        return (isinstance(other, GlobalCursor)
                and self.positions == other.positions)

    def __repr__(self) -> str:
        return f"GlobalCursor({self.positions!r})"


class FederatedStream:
    """One logical subscription spanning every federation member.

    Owns one child stream per origin (a plain ``Stream`` for a proxy
    member, a ``FanInStream`` for a cluster member) and yields
    ``(origin, producer, batch)`` triples, round-robin across origins
    so one busy filesystem cannot starve the others.  Every delivered
    batch is stamped ``batch.origin = origin`` and advances the
    ``GlobalCursor``.

    ``commit()`` routes each member's acknowledgements back to exactly
    that member.  A member that dies mid-stream lands in ``lost`` and
    the rest keep flowing — records never migrate across filesystems,
    so there is nothing to redeliver elsewhere.
    """

    def __init__(self, federation: "Federation", spec: Subscription,
                 children: List[Tuple[str, MemberStream]]):
        self.federation = federation
        self.spec = spec
        self._children = list(children)      # [(origin, child stream)]
        self._rr = 0
        self.cursor = GlobalCursor()
        self.lost: List[str] = []

    # -- topology ------------------------------------------------------------
    @property
    def origins(self) -> List[str]:
        return [o for o, _ in self._children]

    @property
    def resumed(self) -> bool:
        return any(s.resumed for _, s in self._children)

    @property
    def replaying(self) -> bool:
        """True while any member's history bootstrap still streams."""
        return any(s.replaying for _, s in self._children)

    @property
    def replayed(self) -> int:
        return sum(s.replayed for _, s in self._children)

    @property
    def pending_commit(self) -> int:
        return sum(s.pending_commit for _, s in self._children)

    def _drop(self, pair: Tuple[str, MemberStream]) -> None:
        if pair in self._children:
            self._children.remove(pair)
            self.lost.append(pair[0])

    # -- delivery ------------------------------------------------------------
    def _stamp(self, origin: str, pid: str,
               batch: R.RecordBatch) -> R.RecordBatch:
        batch.origin = origin
        indices = batch.indices()
        if indices:
            self.cursor.advance(origin, pid, max(indices))
        return batch

    def fetch(self, max_records: Optional[int] = None,
              ) -> List[Tuple[str, str, R.RecordBatch]]:
        """Drain up to ``max_records`` across the members, round-robin.
        Every returned live batch is commit-pending on its own member."""
        cap = max_records or self.spec.max_records
        out: List[Tuple[str, str, R.RecordBatch]] = []
        children = list(self._children)
        taken = 0
        for k in range(len(children)):
            if taken >= cap:
                break
            pair = children[(self._rr + k) % len(children)]
            if pair not in self._children:
                continue
            origin, child = pair
            try:
                pairs = child.fetch(cap - taken)
            except (ConnectionError, OSError):
                self._drop(pair)
                continue
            for pid, batch in pairs:
                out.append((origin, pid, self._stamp(origin, pid, batch)))
                taken += len(batch)
        if self._children:
            self._rr = (self._rr + 1) % len(self._children)
        return out

    def __iter__(self) -> Iterator[Tuple[str, str, R.RecordBatch]]:
        return self

    def __next__(self) -> Tuple[str, str, R.RecordBatch]:
        """Round-robin the member iterators; each child keeps its own
        auto-commit contract.  Stops when every member is drained."""
        children = list(self._children)
        for k in range(len(children)):
            pair = children[(self._rr + k) % len(children)]
            if pair not in self._children:
                continue
            origin, child = pair
            try:
                pid, batch = next(child)
            except StopIteration:
                continue
            except (ConnectionError, OSError):
                self._drop(pair)
                continue
            self._rr = (self._rr + k + 1) % max(1, len(self._children))
            return origin, pid, self._stamp(origin, pid, batch)
        raise StopIteration

    def records(self) -> Iterator[Tuple[str, str, R.ChangelogRecord]]:
        """Record-level convenience: ``(origin, producer, record)``."""
        for origin, pid, batch in self:
            for i in range(len(batch)):
                yield origin, pid, batch.record(i)

    # -- acknowledgement -----------------------------------------------------
    def requeue(self,
                triples: List[Tuple[str, str, R.RecordBatch]]) -> None:
        """Hand unprocessed triples back to their owning member stream
        (withdrawn from commit-pending, redelivered first)."""
        by_origin: Dict[str, List[Tuple[str, R.RecordBatch]]] = {}
        for origin, pid, batch in triples:
            by_origin.setdefault(origin, []).append((pid, batch))
        children = dict(self._children)
        for origin, pairs in by_origin.items():
            child = children.get(origin)
            if child is None:
                raise SessionError(
                    f"requeue for unknown or lost origin {origin!r}")
            child.requeue(pairs)

    def commit(self) -> int:
        """One logical commit: each member receives exactly the acks
        for the records it delivered.  A dead member's pending acks are
        dropped (its plane redelivers on resume — at-least-once)."""
        total = 0
        for pair in list(self._children):
            try:
                total += pair[1].commit()
            except (ConnectionError, OSError):
                self._drop(pair)
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


class Federation:
    """Named member activity planes joined into one global stream.

    ``members`` maps origin tags to anything ``connect()`` accepts —
    an in-process ``LcapProxy`` or ``LcapCluster``, a service address,
    or a list of shard addresses.  Member order is subscription
    round-robin order.

        fed = Federation({"fs0": cluster_a, "fs1": cluster_b})
        stream = fed.subscribe("audit", tenant=acme,
                               replay={"fs0": True})
        for origin, pid, batch in stream:
            ...
    """

    def __init__(self, members: Dict[str, object]):
        if not members:
            raise SessionError("a federation needs at least one member")
        self.members: Dict[str, object] = dict(members)
        self.sessions: Dict[str, Union[Session, ClusterSession]] = {}
        opened: List[str] = []
        try:
            for origin, target in self.members.items():
                self.sessions[origin] = connect(target)
                opened.append(origin)
        except Exception:
            for origin in opened:
                try:
                    self.sessions[origin].close()
                except (ConnectionError, OSError):
                    pass
            raise

    # -- subscriptions -------------------------------------------------------
    def _member_spec(self, spec: Subscription, origin: str,
                     replay) -> Subscription:
        """The spec one member attaches with: the ``replay=`` kwarg
        (scalar or per-origin dict) overrides the spec's own replay,
        which may itself be a per-origin dict."""
        per = replay if replay is not None else spec.replay
        if isinstance(per, dict):
            per = per.get(origin)
        return replace(spec, replay=per)

    def subscribe(self, subscription: Union[Subscription, str, None] = None,
                  *, resume: Optional[bool] = None,
                  replay=None, **spec_kwargs) -> FederatedStream:
        """Open the subscription on every member.  ``replay`` may be a
        scalar (every origin bootstraps the same way) or an ``{origin:
        value}`` dict (per-origin start points; absent origins attach
        live).  With ``resume=True``, members holding parked durable
        state resume at their cursor and the rest attach fresh; it is
        an error only when *no* member resumed."""
        spec = _make_spec(subscription, spec_kwargs)
        children: List[Tuple[str, MemberStream]] = []
        resumed_any = False
        try:
            for origin, sess in self.sessions.items():
                mspec = self._member_spec(spec, origin, replay)
                if resume:
                    try:
                        child = sess.subscribe(mspec, resume=True)
                        resumed_any = True
                    except UnknownConsumerError:
                        child = sess.subscribe(mspec, resume=None)
                else:
                    child = sess.subscribe(mspec, resume=resume)
                children.append((origin, child))
        except Exception:
            for _o, child in children:
                try:
                    child.close()
                except (ConnectionError, OSError):
                    pass
            raise
        if resume and not resumed_any:
            for _o, child in children:
                try:
                    child.close()
                except (ConnectionError, OSError):
                    pass
            raise UnknownConsumerError(
                f"no federation member holds parked state for durable "
                f"consumer {spec.group}/{spec.name!r}")
        return FederatedStream(self, spec, children)

    def resume(self, group: str, name: str, **spec_kwargs) -> FederatedStream:
        spec = Subscription(group=group, name=name, **spec_kwargs)
        return self.subscribe(spec, resume=True)

    # -- operations ----------------------------------------------------------
    def pump(self) -> int:
        """Advance every in-process member (proxy or cluster) one
        dispatch round; wire members pump themselves via their service
        pollers.  Returns the total records moved."""
        moved = 0
        for target in self.members.values():
            fn = getattr(target, "pump", None)
            if callable(fn):
                moved += int(fn() or 0)
        return moved

    def set_tenant_quota(self, tenant: str, **kw) -> None:
        """Install per-tenant delivery quotas on every member that
        exposes the knob (in-process proxies and clusters).  Rates
        apply per proxy — a federation-wide budget divides by the
        member/shard count at the caller."""
        for target in self.members.values():
            fn = getattr(target, "set_tenant_quota", None)
            if callable(fn):
                fn(tenant, **kw)

    # -- observability -------------------------------------------------------
    def stats(self) -> Dict:
        """Summed numeric proxy counters across members, with the raw
        per-origin views under ``"per_origin"``."""
        per_origin: Dict[str, Dict] = {}
        total: Dict[str, Union[int, float]] = {}
        for origin, sess in self.sessions.items():
            try:
                st = sess.stats()
            except (ConnectionError, OSError):
                continue
            per_origin[origin] = st
            for key, val in st.items():
                if isinstance(val, (int, float)):
                    total[key] = total.get(key, 0) + val
        total["per_origin"] = per_origin
        return total

    def metrics(self) -> Dict:
        """One federated registry snapshot: every member's metrics
        merged — counters and histograms summed, gauges relabeled with
        an ``origin`` label (the cluster tier already labeled its own
        gauges per shard)."""
        from ..obs.registry import merge_snapshots
        per_origin = {}
        for origin, sess in self.sessions.items():
            try:
                snap = sess.metrics()
            except (ConnectionError, OSError):
                continue
            if snap:
                per_origin[origin] = snap
        return merge_snapshots(per_origin, shard_label="origin")

    def lag(self) -> Dict[str, Dict]:
        """Per-origin consumer lag views (origins are sovereign —
        there is no meaningful cross-filesystem lag sum)."""
        out: Dict[str, Dict] = {}
        for origin, sess in self.sessions.items():
            try:
                out[origin] = sess.lag()
            except (ConnectionError, OSError):
                continue
        return out

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        for sess in self.sessions.values():
            try:
                sess.close()
            except (ConnectionError, OSError):
                pass

    def __enter__(self) -> "Federation":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["Federation", "FederatedStream", "GlobalCursor"]
