"""Tenant principals, scope matching, and per-tenant rate accounting.

The multi-tenant refactor's data model: a ``TenantPrincipal`` names who
a subscription acts for and which slice of the jobid namespace it may
observe.  Scope is enforced *server-side* in ``LcapProxy._dispatch`` as
a columnar pushdown predicate over ``RecordBatch.jobid_col`` — exactly
where op-type masks already live — so isolation is a property of the
proxy, not of polite clients: out-of-scope records are acknowledged in
place and never copied into a tenant's outbox (the ``filtered_out``
discipline, per-tenant under ``tenant_filtered``).

Scope semantics (audit-paper motivated: per-user/per-jobid trails with
isolation guarantees):

- ``jobids``     exact jobid match (a frozen set of bytes)
- ``prefixes``   jobid prefix match (``jobid.startswith(p)`` for any p)
- a record *without* a jobid matches no tenant scope — invisible to
  every scoped consumer, visible to unscoped (trusted) ones.  The
  isolation-safe default: unattributed activity leaks to nobody.
- empty scope entries are rejected (``TenantError``): an empty prefix
  would match everything and an empty jobid would match unattributed
  records, both silent scope widenings.

``TokenBucket`` is the proxy's per-tenant delivery throttle (records
and bytes); an over-quota tenant's groups park through the existing
per-group backpressure path and drain when the bucket refills.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np

from .errors import TenantError

_JOBID_LEN = 32      # records._JOBID_LEN; kept literal to avoid a cycle


def _as_bytes(v: Union[str, bytes]) -> bytes:
    return v.encode("utf-8") if isinstance(v, str) else bytes(v)


@dataclass(frozen=True)
class TenantPrincipal:
    """Who a subscription acts for, and which jobids it may observe.

    ``name`` identifies the tenant for quota/audit accounting;
    ``jobids`` and ``prefixes`` define the visibility scope (either or
    both; at least one entry).  Principals are value objects: equality
    is by (name, scope), so a resumed durable consumer can prove it is
    the same tenant that parked.
    """

    name: str
    jobids: frozenset = frozenset()
    prefixes: Tuple[bytes, ...] = ()

    def __post_init__(self):
        if not self.name:
            raise TenantError("tenant principals need a name")
        jobids = frozenset(_as_bytes(j) for j in self.jobids)
        prefixes = tuple(sorted(_as_bytes(p) for p in self.prefixes))
        if not jobids and not prefixes:
            raise TenantError(
                f"tenant {self.name!r} has an empty scope; grant at "
                f"least one jobid or prefix")
        for v in (*jobids, *prefixes):
            if not v:
                raise TenantError(
                    f"tenant {self.name!r}: empty scope entries are "
                    f"forbidden (they would widen the scope)")
            if len(v) > _JOBID_LEN:
                raise TenantError(
                    f"tenant {self.name!r}: scope entry {v!r} exceeds "
                    f"the {_JOBID_LEN}-byte jobid field")
        object.__setattr__(self, "jobids", jobids)
        object.__setattr__(self, "prefixes", prefixes)
        need = max([len(j) + 1 for j in jobids] +
                   [len(p) for p in prefixes])
        if need <= 8 and sys.byteorder == "little":
            # every scope entry fits one machine word: round the mask
            # width up to 8 so ``scope_mask`` can test each entry with
            # a single masked-uint64 compare over the jobid column
            object.__setattr__(self, "_mask_width", 8)
            tests = []
            for j in jobids:          # entry + NUL (see scope_mask)
                v = j + b"\0"
                tests.append(
                    (np.uint64(int.from_bytes(b"\xff" * len(v), "little")),
                     np.uint64(int.from_bytes(v, "little"))))
            for p in prefixes:
                tests.append(
                    (np.uint64(int.from_bytes(b"\xff" * len(p), "little")),
                     np.uint64(int.from_bytes(p, "little"))))
            object.__setattr__(self, "_u64_tests", tuple(tests))
        else:
            object.__setattr__(self, "_mask_width", min(need, _JOBID_LEN))
            object.__setattr__(self, "_u64_tests", None)

    # ------------------------------------------------------------ matching
    def allows(self, jobid: bytes) -> bool:
        """Scalar scope check for the per-record dispatch path."""
        if jobid in self.jobids:
            return True
        return any(jobid.startswith(p) for p in self.prefixes)

    @property
    def mask_width(self) -> int:
        """The narrowest ``jobid_col`` width this scope can be checked
        against: jobids are NUL-padded, so an exact entry needs its own
        bytes plus the terminating NUL, a prefix only its own bytes."""
        return self._mask_width

    @property
    def word_scoped(self) -> bool:
        """True when every scope entry fits one little-endian machine
        word, so ``scope_mask`` accepts the cheap 1-D uint64 form
        (``RecordBatch.jobid_word``) instead of a byte matrix."""
        return self._u64_tests is not None

    def scope_mask(self, jobid_col: np.ndarray) -> np.ndarray:
        """Vectorized scope check over an ``(n, w)`` uint8 jobid matrix
        (``RecordBatch.jobid_col``, any ``w >= mask_width``): one
        boolean per row, computed with whole-column compares per scope
        entry — the columnar pushdown predicate
        ``LcapProxy._dispatch_batch`` evaluates."""
        if jobid_col.ndim == 1:
            # word-at-a-time form (``RecordBatch.jobid_word``): the
            # whole scope check is one masked compare per entry
            if self._u64_tests is None:
                raise TenantError(
                    f"tenant {self.name!r}: scope does not fit the "
                    f"word form; pass the byte matrix")
            mask = np.zeros(len(jobid_col), dtype=bool)
            for m64, t64 in self._u64_tests:
                mask |= (jobid_col & m64) == t64
            return mask
        n, w = jobid_col.shape
        mask = np.zeros(n, dtype=bool)
        if not n:
            return mask
        if self._u64_tests is not None and w >= 8:
            # word-at-a-time: the whole scope check is one masked
            # uint64 compare per entry over the leading 8 jobid bytes
            lead = jobid_col if w == 8 else jobid_col[:, :8]
            if not lead.flags.c_contiguous:
                lead = np.ascontiguousarray(lead)
            v = lead.view(np.uint64).ravel()
            for m64, t64 in self._u64_tests:
                mask |= (v & m64) == t64
            return mask
        for j in self.jobids:
            # compare the entry + one NUL: padding means the first zero
            # byte ends the jobid, so a longer jobid cannot alias
            row = np.frombuffer(j[:w].ljust(min(len(j) + 1, w), b"\0"),
                                dtype=np.uint8)
            mask |= (jobid_col[:, :len(row)] == row).all(axis=1)
        for p in self.prefixes:
            pre = np.frombuffer(p, dtype=np.uint8)
            mask |= (jobid_col[:, :len(p)] == pre).all(axis=1)
        return mask

    # ---------------------------------------------------------------- wire
    def to_wire(self) -> Dict:
        return {"name": self.name,
                "jobids": sorted(self.jobids),
                "prefixes": list(self.prefixes)}

    @staticmethod
    def from_wire(msg) -> Optional["TenantPrincipal"]:
        """Decode the ``tenant`` field of a subscribe/resume verb (or
        an ``attach`` kwarg): None passes through, a dict or an
        existing principal normalizes."""
        if msg is None:
            return None
        if isinstance(msg, TenantPrincipal):
            return msg
        if not isinstance(msg, dict) or "name" not in msg:
            raise TenantError(f"malformed tenant principal: {msg!r}")
        return TenantPrincipal(
            name=str(msg["name"]),
            jobids=frozenset(_as_bytes(j) for j in msg.get("jobids") or ()),
            prefixes=tuple(_as_bytes(p)
                           for p in msg.get("prefixes") or ()))


class TokenBucket:
    """A refill-on-read token bucket.  ``level`` may go negative when a
    whole batch is charged at once (bounded burst debt); the group then
    parks until refill brings it back above zero."""

    __slots__ = ("rate", "burst", "level", "_last")

    def __init__(self, rate: float, burst: Optional[float] = None):
        self.rate = float(rate)                  # tokens per second
        self.burst = float(burst if burst is not None else rate)
        self.level = self.burst
        self._last: Optional[float] = None

    def refill(self, now: float) -> None:
        if self._last is None:
            self._last = now
            return
        dt = now - self._last
        if dt > 0:
            self.level = min(self.burst, self.level + dt * self.rate)
            self._last = now

    def charge(self, n: float) -> None:
        self.level -= n

    @property
    def exhausted(self) -> bool:
        return self.level <= 0


@dataclass
class TenantAccount:
    """Per-tenant delivery accounting inside one proxy: counters the
    ``lcap_tenant_*`` collector exports, plus the optional quota
    buckets.  Created lazily the first time a tenant attaches (or a
    quota is set) and shared by every consumer of that tenant."""

    name: str
    delivered_records: int = 0
    delivered_bytes: int = 0
    filtered_records: int = 0        # scope-denied, acked in place
    replayed_records: int = 0        # history-tier deliveries
    quota_blocked_pumps: int = 0     # dispatch rounds parked on quota
    record_bucket: Optional[TokenBucket] = None
    byte_bucket: Optional[TokenBucket] = None
    consumers: int = 0               # live consumers under this tenant

    def set_quota(self, records_per_s: Optional[float] = None,
                  bytes_per_s: Optional[float] = None,
                  burst_records: Optional[float] = None,
                  burst_bytes: Optional[float] = None) -> None:
        self.record_bucket = (TokenBucket(records_per_s, burst_records)
                              if records_per_s else None)
        self.byte_bucket = (TokenBucket(bytes_per_s, burst_bytes)
                            if bytes_per_s else None)

    def refill(self, now: float) -> None:
        if self.record_bucket is not None:
            self.record_bucket.refill(now)
        if self.byte_bucket is not None:
            self.byte_bucket.refill(now)

    @property
    def exhausted(self) -> bool:
        return ((self.record_bucket is not None
                 and self.record_bucket.exhausted)
                or (self.byte_bucket is not None
                    and self.byte_bucket.exhausted))

    def charge(self, records: int, nbytes: int) -> None:
        self.delivered_records += records
        self.delivered_bytes += nbytes
        if self.record_bucket is not None:
            self.record_bucket.charge(records)
        if self.byte_bucket is not None:
            self.byte_bucket.charge(nbytes)


__all__ = ["TenantPrincipal", "TokenBucket", "TenantAccount"]
