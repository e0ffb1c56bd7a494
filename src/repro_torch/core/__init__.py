"""repro_torch.core — the changelog pipeline of "Distributed Lustre
activity tracking" (Doreau, CS.DC 2015), ported from ``repro.core``.

Extensible changelog records (LU-1996 layout), per-producer journals
with collective acknowledgement, the LCAP proxy with consumer groups,
load balancing, at-least-once delivery, ephemeral readers and stream
modules, the compacted history tier, the FID-hash sharded cluster
(routing on the card), the wire (framed TCP transport, ``LcapService``,
shard daemons, wire sessions and the deprecated reader shims) and the
federation of many planes into one stream.
"""

from . import records
from .ack import AckTracker
from .cluster import (LcapCluster, LcapClusterService, LocalShard,
                      RemoteShard, fid_slot)
from .errors import (ClusterError, SessionError, SubscriptionError,
                     TenantError, UnknownConsumerError, UnknownProducerError)
from .federation import Federation, FederatedStream, GlobalCursor
from .history import (Compactor, HistoryStore, JournalReplayReader,
                      StreamJanitor)
from .llog import Llog
from .modules import (CancelCompensating, CoalesceHeartbeats,
                      ReorderByTarget, TypeFilter)
from .proxy import EPHEMERAL, PERSISTENT, LcapProxy
from .reader import LocalReader, RemoteReader
from .records import RecordBatch
from .routing import RoutingTable
from .server import LcapService
from .session import (ClusterSession, FanInStream, Session, Stream,
                      Subscription, connect)
from .tenancy import TenantAccount, TenantPrincipal, TokenBucket

__all__ = [
    "records", "RecordBatch", "AckTracker", "Llog", "LcapProxy",
    "HistoryStore", "Compactor", "JournalReplayReader", "StreamJanitor",
    "LcapService", "PERSISTENT", "EPHEMERAL",
    "LcapCluster", "LcapClusterService", "LocalShard", "RemoteShard",
    "fid_slot", "RoutingTable",
    "connect", "Session", "Stream", "Subscription",
    "ClusterSession", "FanInStream",
    "Federation", "FederatedStream", "GlobalCursor",
    "TenantPrincipal", "TenantAccount", "TokenBucket",
    "SessionError", "SubscriptionError", "UnknownConsumerError",
    "UnknownProducerError", "ClusterError", "TenantError",
    "LocalReader", "RemoteReader",        # deprecated shims
    "CancelCompensating", "CoalesceHeartbeats", "ReorderByTarget",
    "TypeFilter",
]
