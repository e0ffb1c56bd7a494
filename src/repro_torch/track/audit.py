"""Audit trails over the (tenant-scoped, possibly federated) stream.
The port of ``repro/track/audit.py``.

The audit use case from the source paper's lineage: changelog records
carry a ``jobid`` naming who caused each operation, so a consumer can
reconstruct *who did what, where, and when* without scanning the
filesystem.  ``AuditTrail`` is that consumer: it subscribes to an
activity plane — a single proxy, a sharded cluster, or a whole
``Federation`` of filesystems — and folds the stream into per-jobid /
per-user trails (operation counts by type, first/last activity, and a
per-origin breakdown when the stream is federated).

Tenancy composes by construction: pass ``tenant=`` and the proxies
enforce the scope server-side (pushdown), so a tenant-scoped audit
trail can only ever contain that tenant's activity — the trail is
trustworthy *because the consumer never saw anything else*, not
because it filtered politely.

Jobids follow the Lustre ``procname_uid`` convention (``"dd.1000"``):
the default user extractor takes the suffix after the last ``"."``.
Pass ``user_of=`` to override.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..core import records as R
from ..core.federation import FederatedStream, Federation
from ..core.session import Subscription, connect
from ..core.tenancy import TenantPrincipal


def default_user(jobid: bytes) -> str:
    """Lustre ``procname_uid`` convention: ``b"dd.1000"`` -> ``"1000"``
    (the whole jobid when there is no dot)."""
    _head, sep, tail = jobid.rpartition(b".")
    return (tail if sep else jobid).decode(errors="replace")


@dataclass
class JobTrail:
    """The audit trail of one jobid: who, what, when, where."""

    jobid: str
    user: str
    records: int = 0
    first_ns: Optional[int] = None      # earliest record time seen
    last_ns: Optional[int] = None       # latest record time seen
    by_type: Dict[int, int] = field(default_factory=dict)
    by_origin: Dict[str, int] = field(default_factory=dict)

    def note(self, rtype: int, time_ns: int, origin: Optional[str]) -> None:
        self.records += 1
        self.by_type[rtype] = self.by_type.get(rtype, 0) + 1
        if origin is not None:
            self.by_origin[origin] = self.by_origin.get(origin, 0) + 1
        if self.first_ns is None or time_ns < self.first_ns:
            self.first_ns = time_ns
        if self.last_ns is None or time_ns > self.last_ns:
            self.last_ns = time_ns


class AuditTrail:
    """Folds an activity stream into per-jobid and per-user trails.

    ``target`` is anything ``connect()`` accepts *or* a ``Federation``
    — a federated trail records which filesystem (origin) each jobid
    touched.  Records without a jobid are counted in ``unattributed``
    but never become trails: there is no one to attribute them to (and
    a tenant-scoped stream never contains them at all — unattributed
    activity matches no tenant scope).
    """

    def __init__(self, target, group: str = "audit",
                 name: Optional[str] = None,
                 tenant: Optional[TenantPrincipal] = None,
                 types=None, replay=None,
                 user_of: Callable[[bytes], str] = default_user):
        spec = Subscription(group=group, name=name, types=types,
                            tenant=tenant, auto_commit=False,
                            replay=None if isinstance(replay, dict)
                            else replay)
        if isinstance(target, Federation):
            self.session = None
            self.stream = target.subscribe(spec, replay=replay)
        else:
            if isinstance(replay, dict):
                raise ValueError("per-origin replay dicts need a "
                                 "Federation target")
            self.session = connect(target)
            self.stream = self.session.subscribe(spec)
        self.tenant = tenant
        self.user_of = user_of
        self.trails: Dict[str, JobTrail] = {}
        self.unattributed = 0

    # ---------------------------------------------------------------- intake
    @property
    def bootstrapping(self) -> bool:
        return self.stream.replaying

    def poll(self, max_records: int = 1024) -> int:
        """One fetch/fold/commit round; returns records folded."""
        n = 0
        if isinstance(self.stream, FederatedStream):
            for origin, _pid, batch in self.stream.fetch(max_records):
                n += self._fold(batch, origin)
        else:
            for _pid, batch in self.stream.fetch(max_records):
                n += self._fold(batch, batch.origin)
        self.stream.commit()
        return n

    def _fold(self, batch: R.RecordBatch, origin: Optional[str]) -> int:
        # columnar fold: jobid matrix + header columns, no per-record
        # decode — the audit consumer reads no record bodies at all
        h = batch.header()
        types = h["type"].tolist()
        times = h["time"].tolist()
        jraw = batch.jobid_col().tobytes()
        for i, (tp, tm) in enumerate(zip(types, times)):
            jobid = jraw[i * 32:(i + 1) * 32].rstrip(b"\0")
            if not jobid:
                self.unattributed += 1
                continue
            key = jobid.decode(errors="replace")
            trail = self.trails.get(key)
            if trail is None:
                trail = self.trails[key] = JobTrail(
                    jobid=key, user=self.user_of(jobid))
            trail.note(tp, tm, origin)
        return len(batch)

    # --------------------------------------------------------------- queries
    def trail(self, jobid) -> Optional[JobTrail]:
        if isinstance(jobid, bytes):
            jobid = jobid.decode(errors="replace")
        return self.trails.get(jobid)

    def users(self) -> Dict[str, int]:
        """Per-user record totals across their jobids."""
        out: Dict[str, int] = {}
        for t in self.trails.values():
            out[t.user] = out.get(t.user, 0) + t.records
        return out

    def top(self, n: int = 10) -> List[JobTrail]:
        """The ``n`` most active jobids."""
        return sorted(self.trails.values(),
                      key=lambda t: (-t.records, t.jobid))[:n]

    def report(self) -> Dict:
        """A serializable audit report: per-jobid trails plus user and
        origin rollups."""
        origins: Dict[str, int] = {}
        for t in self.trails.values():
            for o, c in t.by_origin.items():
                origins[o] = origins.get(o, 0) + c
        return {
            "tenant": self.tenant.name if self.tenant else None,
            "jobs": {
                t.jobid: {
                    "user": t.user, "records": t.records,
                    "first_ns": t.first_ns, "last_ns": t.last_ns,
                    "by_type": dict(t.by_type),
                    "by_origin": dict(t.by_origin),
                } for t in self.trails.values()},
            "users": self.users(),
            "origins": origins,
            "unattributed": self.unattributed,
        }

    # -------------------------------------------------------------- lifecycle
    def close(self, failed: bool = False) -> None:
        self.stream.close(failed=failed)
        if self.session is not None:
            self.session.close()


__all__ = ["AuditTrail", "JobTrail", "default_user"]
