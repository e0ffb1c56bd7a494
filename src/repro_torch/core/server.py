"""LcapService — the proxy as a network daemon (paper fig. 1).

Wraps ``LcapProxy`` with a greedy polling thread (reads records from the
producers as soon as possible) and the TCP request/response service the
``Session`` client (session.py) speaks.  Messages are versioned
(``"v"``); the consumer surface is:

    subscribe   declarative spec (group/name/mode/flags/types) -> cid;
                transparently resumes a parked durable consumer
    resume      like subscribe, but demands parked durable state
    fetch       drain queued records as per-producer batch frames
    fetch_replay  stream the compacted-history bootstrap of a replay
                subscription (history first, then fetch takes over at
                the handoff watermark)
    commit      acknowledge batches of records across producers
    detach      drop the connection but keep the durable identity
    close       deregister for good
    stats       proxy counters

plus the legacy ``register``/``ack``/``ack_batch`` verbs for the
deprecated reader shims.  Errors travel as ``{"err", "err_type"}`` and
surface client-side as typed exceptions, never strings.

A consumer disconnect without ``close`` is treated as a failure: durable
consumers are parked for the proxy's resume TTL (reconnecting under the
same name resumes at the cursor), anonymous consumers' in-flight records
are redelivered to the surviving members of the group (at-least-once,
§III-A).
"""

from __future__ import annotations

import threading
import time
from typing import Dict

from .errors import SessionError
from .proxy import LcapProxy
from .records import RecordBatch, WIRE_V1, WIRE_V2
from .tenancy import TenantPrincipal
from .transport import PROTOCOL_VERSION, RpcServer


class LcapService:
    def __init__(self, proxy: LcapProxy, host: str = "127.0.0.1",
                 port: int = 0, poll_interval: float = 0.002,
                 shard_index: int = None, shard_count: int = None,
                 cluster_info=None):
        self.proxy = proxy
        self.poll_interval = poll_interval
        # cluster awareness: a shard daemon stamps its position into
        # subscribe replies so fan-in clients can sanity-check topology
        self.shard_index = shard_index
        self.shard_count = shard_count
        # topology awareness: a callable returning {"epoch", "shards",
        # "addresses"} (LcapClusterService.cluster_info).  When set,
        # the routing epoch is piggybacked on subscribe/fetch/commit
        # replies and the ``topology`` verb serves the full snapshot,
        # so a consumer connected to any one shard can detect epoch
        # bumps and re-resolve the whole fan-in.
        self.cluster_info = cluster_info
        self._stop = threading.Event()
        self.server = RpcServer(self._handle, self._disconnected, host, port)
        self.address = self.server.address
        self._poller = threading.Thread(target=self._poll_loop, daemon=True)

    def _stamp(self, reply: Dict) -> Dict:
        """Piggyback the routing epoch on a data-path reply."""
        if self.cluster_info is not None:
            reply["epoch"] = self.cluster_info()["epoch"]
        return reply

    # ------------------------------------------------------------- service
    def _handle(self, msg: Dict, session: Dict) -> Dict:
        op = msg.get("op")
        try:
            if msg.get("v", 0) > PROTOCOL_VERSION:
                raise SessionError(f"protocol version {msg['v']} not "
                                   f"supported (server speaks "
                                   f"{PROTOCOL_VERSION})")
            if op in ("subscribe", "resume"):
                info = self.proxy.attach(
                    msg.get("group"), flags=msg.get("flags"),
                    mode=msg.get("mode", "persistent"),
                    types=msg.get("types"), name=msg.get("name"),
                    resume=True if op == "resume" else msg.get("resume"),
                    replay=msg.get("replay"),
                    tenant=TenantPrincipal.from_wire(msg.get("tenant")))
                session.setdefault("cids", set()).add(info["cid"])
                # record-frame negotiation: fetch frames are emitted at
                # the highest generation both sides speak (an old client
                # never sends "wire" and keeps getting v1 frames)
                wire = min(int(msg.get("wire", WIRE_V1)), WIRE_V2)
                session["wire"] = wire
                if self.shard_index is not None:   # cluster-aware reply
                    info = {**info, "shard": self.shard_index,
                            "shards": self.shard_count}
                return self._stamp({"v": PROTOCOL_VERSION, "wire": wire,
                                    **info})
            if op == "caps":
                # feature discovery for cluster peers: record-frame
                # generation, deep-batched offer support, and (when the
                # shard is topology-aware) the routing epoch.  An old
                # daemon answers with an unknown-op error reply, which
                # callers treat as "v1, shallow".
                return self._stamp({"v": PROTOCOL_VERSION, "wire": WIRE_V2,
                                    "deep": True})
            if op == "topology":
                # the full routing snapshot: epoch, shard count, and
                # every shard's address — served by any one shard
                if self.cluster_info is None:
                    raise SessionError("not a topology-aware shard")
                return {"v": PROTOCOL_VERSION, **self.cluster_info()}
            if op == "add_source":
                self.proxy.add_source(msg["pid"], msg.get("first", 1))
                return {"ok": True}
            if op == "offer":
                admitted = self.proxy.offer(
                    msg["pid"], RecordBatch.from_wire(msg["blob"]),
                    msg.get("hi"))
                return {"admitted": admitted,
                        "watermarks": dict(self.proxy.upstream_acked)}
            if op == "offer_many":
                # deep-batched ingest: a whole routing round in one
                # call, admitted under one proxy lock; the reply
                # piggybacks the shard watermarks so the coordinator
                # skips its separate watermark round-trip
                admitted = self.proxy.offer_many(
                    [(pid, RecordBatch.from_wire(blob), hi)
                     for pid, blob, hi in msg["offers"]])
                return {"admitted": admitted,
                        "watermarks": dict(self.proxy.upstream_acked)}
            if op == "watermarks":
                self.proxy.flush_upstream()
                return {"watermarks": dict(self.proxy.upstream_acked)}
            if op == "register":      # legacy readers; same flag default
                cid = self.proxy.subscribe(msg.get("group"),
                                           msg.get("flags"),
                                           msg.get("mode", "persistent"))
                session.setdefault("cids", set()).add(cid)
                return {"cid": cid}
            if op == "fetch":
                # whole batches on the wire: one (producer, frame) pair
                # per consecutive same-producer run, framed at the
                # generation negotiated on subscribe (v2 ships the
                # header columns alongside the payload)
                wire = session.get("wire", WIRE_V1)
                batches = self.proxy.fetch_batches(msg["cid"],
                                                   msg.get("max", 256))
                return self._stamp(
                    {"batches": [(pid, batch.to_wire(wire))
                                 for pid, batch in batches]})
            if op == "fetch_replay":
                wire = session.get("wire", WIRE_V1)
                batches, done = self.proxy.fetch_replay(msg["cid"],
                                                        msg.get("max", 256))
                return self._stamp(
                    {"batches": [(pid, batch.to_wire(wire))
                                 for pid, batch in batches],
                     "done": done})
            if op == "commit":
                self.proxy.commit(msg["cid"], msg["acks"])
                return self._stamp({"ok": True})
            if op == "ack":
                self.proxy.ack(msg["cid"], msg["pid"], msg["index"])
                return {"ok": True}
            if op == "ack_batch":
                self.proxy.ack_batch(msg["cid"], msg["pid"], msg["indices"])
                return {"ok": True}
            if op == "detach":
                session.get("cids", set()).discard(msg["cid"])
                self.proxy.disconnect(msg["cid"])
                return {"ok": True}
            if op == "close":
                session.get("cids", set()).discard(msg["cid"])
                self.proxy.unsubscribe(msg["cid"])
                return {"ok": True}
            if op == "stats":
                return {"stats": dict(self.proxy.stats)}
            if op == "metrics":
                return {"metrics": self.proxy.metrics_snapshot()}
            if op == "lag":
                return {"lag": self.proxy.lag()}
            raise SessionError(f"unknown op {op!r}")
        except Exception as exc:  # noqa: BLE001 — reported to the peer
            return {"err": f"{type(exc).__name__}: {exc}",
                    "err_type": type(exc).__name__}

    def _disconnected(self, session: Dict) -> None:
        for cid in session.get("cids", ()):  # durable -> park, else fail
            self.proxy.disconnect(cid)

    # -------------------------------------------------------------- poller
    def _poll_loop(self) -> None:
        while not self._stop.is_set():
            moved = self.proxy.pump()
            self.proxy.flush_upstream()
            if not moved:
                time.sleep(self.poll_interval)

    def start(self) -> "LcapService":
        self.server.start()
        self._poller.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._poller.join(timeout=5)
        self.server.stop()
