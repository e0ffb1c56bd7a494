"""Typed errors of the changelog client/server API.

Server replies carry ``{"err": "ExcName: msg", "err_type": "ExcName"}``;
the client side (session.py) maps them back to these classes instead of
surfacing strings.  The hierarchy deliberately doubles as the built-in
types the pre-session API raised (``KeyError`` for unknown consumers,
``ValueError`` for bad subscriptions), so code written against the old
readers keeps catching what it always caught.
"""

from __future__ import annotations

from typing import Dict, Type


class SessionError(RuntimeError):
    """Base for all client-visible changelog API errors."""


class SubscriptionError(SessionError, ValueError):
    """A subscription spec the proxy cannot honor (missing group,
    unknown mode, duplicate durable name, unsupported protocol...)."""


class UnknownConsumerError(SessionError, KeyError):
    """The consumer id / durable name is not (or no longer) registered."""

    def __str__(self) -> str:  # KeyError quotes its arg; keep the message
        return RuntimeError.__str__(self)


class UnknownProducerError(SessionError, KeyError):
    """An acknowledgement names a producer the proxy does not track."""

    def __str__(self) -> str:
        return RuntimeError.__str__(self)


class ClusterError(SessionError):
    """A sharded-cluster operation failed (no live shards, a shard verb
    rejected, or a malformed cluster topology)."""


class TenantError(SessionError, PermissionError):
    """A tenant-scope violation: a subscription tried to widen (or take
    over) a scope it does not own — resuming another tenant's durable
    cursor, broadening a parked tenant scope, or a malformed
    ``TenantPrincipal``.  Scope *enforcement* never raises: out-of-scope
    records are silently acknowledged in place by the proxy (pushdown),
    exactly like op-type filtering."""


#: reply ``err_type`` -> exception class (legacy names map onto the
#: closest typed error so old servers still produce typed failures)
WIRE_ERRORS: Dict[str, Type[SessionError]] = {
    "SessionError": SessionError,
    "SubscriptionError": SubscriptionError,
    "UnknownConsumerError": UnknownConsumerError,
    "UnknownProducerError": UnknownProducerError,
    "ClusterError": ClusterError,
    "TenantError": TenantError,
    "KeyError": UnknownConsumerError,
    "ValueError": SubscriptionError,
}


def raise_reply_error(reply: dict) -> None:
    """Raise the typed exception a ``{"err": ...}`` reply encodes; no-op
    for successful replies."""
    err = reply.get("err")
    if not err:
        return
    name = reply.get("err_type")
    if name is None and ":" in err:        # legacy "ExcName: msg" replies
        name = err.split(":", 1)[0]
    cls = WIRE_ERRORS.get(name or "", SessionError)
    raise cls(err)
