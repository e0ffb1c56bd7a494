"""repro_torch.core — the changelog pipeline of "Distributed Lustre
activity tracking" (Doreau, CS.DC 2015), ported from ``repro.core``.

Extensible changelog records (LU-1996 layout), per-producer journals
with collective acknowledgement, the LCAP proxy with consumer groups,
load balancing, at-least-once delivery, ephemeral readers and stream
modules, the compacted history tier, and the FID-hash sharded cluster
with its in-process consumer sessions.  The wire (transport, server,
daemons, wire sessions) and federation are later slices of the port.
"""

from . import records
from .ack import AckTracker
from .cluster import LcapCluster, LocalShard, fid_slot
from .errors import (ClusterError, SessionError, SubscriptionError,
                     TenantError, UnknownConsumerError, UnknownProducerError)
from .history import (Compactor, HistoryStore, JournalReplayReader,
                      StreamJanitor)
from .llog import Llog
from .modules import (CancelCompensating, CoalesceHeartbeats,
                      ReorderByTarget, TypeFilter)
from .proxy import EPHEMERAL, PERSISTENT, LcapProxy
from .records import RecordBatch
from .routing import RoutingTable
from .session import (ClusterSession, FanInStream, Session, Stream,
                      Subscription, connect)
from .tenancy import TenantAccount, TenantPrincipal, TokenBucket

__all__ = [
    "records", "RecordBatch", "AckTracker", "Llog", "LcapProxy",
    "HistoryStore", "Compactor", "JournalReplayReader", "StreamJanitor",
    "PERSISTENT", "EPHEMERAL",
    "LcapCluster", "LocalShard", "fid_slot", "RoutingTable",
    "connect", "Session", "Stream", "Subscription",
    "ClusterSession", "FanInStream",
    "TenantPrincipal", "TenantAccount", "TokenBucket",
    "SessionError", "SubscriptionError", "UnknownConsumerError",
    "UnknownProducerError", "ClusterError", "TenantError",
    "CancelCompensating", "CoalesceHeartbeats", "ReorderByTarget",
    "TypeFilter",
]
