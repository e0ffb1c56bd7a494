"""Client/server transport (paper: ZeroMQ; here: in-proc + framed TCP).

Message framing: u32 length prefix + msgpack payload.  The proxy exposes
a request/response service (register / fetch / ack / close); consumers
poll, exactly like Lustre changelog readers do.  Record payloads ride
inside the msgpack body as whole ``RecordBatch`` wire frames (see
``records.RecordBatch.to_wire``) — one message moves a batch, not a
record, so the per-message overhead (syscalls, framing, Nagle
interactions) amortizes across the batch.

Record frames come in two generations (the message envelope is the same
either way, so ``PROTOCOL_VERSION`` stays 1): v1 carries lengths +
packed payload; v2 additionally ships the batch's decoded header table
so the receiver attaches the columns without re-gathering.  The frame a
peer *emits* is negotiated — clients offer ``"wire": 2`` on subscribe
and servers echo what they will speak; cluster coordinators probe shard
daemons once with the ``caps`` verb.  Receivers sniff the frame magic
and accept both generations regardless, so negotiation only protects
old peers from frames they cannot parse.

The payload is packed and unpacked by the port's own ``msgpack_subset``:
byte for byte what ``msgpack.packb(msg, use_bin_type=True)`` writes, so
port and reference peers interoperate, without the ``msgpack`` package.
Messages carry Python scalars only.  A numpy or torch scalar is refused
with ``TypeError``, as ``msgpack`` refuses it; callers convert with
``int(...)`` or ``.tolist()``.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
from typing import Any, Callable, Dict, Optional, Tuple

from .msgpack_subset import packb, unpackb

#: wire protocol generation, stamped as "v" on every client message and
#: checked by the server — one definition for both halves
PROTOCOL_VERSION = 1

#: record-frame generations (re-exported from records for the transport
#: surface: the "wire" negotiation key takes these values)
from .records import WIRE_V1, WIRE_V2  # noqa: E402,F401

_LEN = struct.Struct("<I")

#: (sent_msgs, sent_bytes, recvd_msgs, recvd_bytes) counter instruments,
#: installed by :func:`instrument`; None keeps the framing hot path at a
#: single identity check per message (per-frame, never per-record)
_METRICS = None


def instrument(registry) -> None:
    """Publish transport frame/byte counters into a metrics registry.
    Any object with the registry's ``counter(name, help, labels=...)``
    whose result has ``labels(direction=...)`` and ``inc(n)`` will do."""
    global _METRICS
    msgs = registry.counter("lcap_transport_messages_total",
                            "wire frames by direction",
                            labels=("direction",))
    byts = registry.counter("lcap_transport_bytes_total",
                            "wire payload bytes (incl. length prefix)",
                            labels=("direction",))
    _METRICS = (msgs.labels(direction="sent"),
                byts.labels(direction="sent"),
                msgs.labels(direction="received"),
                byts.labels(direction="received"))


def send_msg(sock: socket.socket, msg: Dict[str, Any]) -> None:
    blob = packb(msg)
    sock.sendall(_LEN.pack(len(blob)) + blob)
    m = _METRICS
    if m is not None:
        m[0].inc()
        m[1].inc(4 + len(blob))


def recv_msg(sock: socket.socket) -> Optional[Dict[str, Any]]:
    hdr = _recv_exact(sock, 4)
    if hdr is None:
        return None
    (ln,) = _LEN.unpack(hdr)
    blob = _recv_exact(sock, ln)
    if blob is None:
        return None
    m = _METRICS
    if m is not None:
        m[2].inc()
        m[3].inc(4 + ln)
    return unpackb(blob)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    chunks = []
    while n:
        try:
            chunk = sock.recv(n)
        except OSError:
            return None
        if not chunk:
            return None
        if len(chunk) == n and not chunks:
            return chunk                 # whole frame in one recv
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


class RpcServer:
    """Threaded TCP server dispatching msgpack requests to a handler.

    handler(msg, session) -> reply dict.  ``session`` is a per-connection
    dict; ``on_disconnect(session)`` fires when the peer goes away (used
    by the proxy to trigger at-least-once redelivery).
    """

    def __init__(self, handler: Callable[[Dict, Dict], Dict],
                 on_disconnect: Optional[Callable[[Dict], None]] = None,
                 host: str = "127.0.0.1", port: int = 0):
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def setup(self):
                self.request.setsockopt(socket.IPPROTO_TCP,
                                        socket.TCP_NODELAY, 1)

            def handle(self):
                session: Dict[str, Any] = {}
                try:
                    while True:
                        msg = recv_msg(self.request)
                        if msg is None:
                            break
                        reply = outer.handler(msg, session)
                        send_msg(self.request, reply)
                finally:
                    if outer.on_disconnect:
                        outer.on_disconnect(session)

        class _Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self.handler = handler
        self.on_disconnect = on_disconnect
        self._server = _Server((host, port), _Handler)
        self.address: Tuple[str, int] = self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    def start(self) -> "RpcServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class RpcClient:
    def __init__(self, address: Tuple[str, int], timeout: float = 10.0):
        self._sock = socket.create_connection(address, timeout=timeout)
        # request/response over small frames: latency beats coalescing
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def call(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        send_msg(self._sock, msg)
        reply = recv_msg(self._sock)
        if reply is None:
            raise ConnectionError("proxy closed the connection")
        return reply

    def send_request(self, msg: Dict[str, Any]) -> None:
        """Fire a request without waiting; pair with ``recv_reply``.
        The server handles one connection sequentially, so replies come
        back in request order."""
        send_msg(self._sock, msg)

    def recv_reply(self) -> Dict[str, Any]:
        reply = recv_msg(self._sock)
        if reply is None:
            raise ConnectionError("proxy closed the connection")
        return reply

    def call_pipelined(self, msgs) -> list:
        """Send a burst of requests before reading any reply.  A
        cluster coordinator routes one batch per (shard, journal) per
        round — pipelining turns N round-trips into one flush and one
        drain (and lets every *shard* process its burst concurrently
        when the caller interleaves send/recv across connections)."""
        msgs = list(msgs)
        for msg in msgs:
            self.send_request(msg)
        return [self.recv_reply() for _ in msgs]

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
