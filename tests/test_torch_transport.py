"""Port parity of the wire's framing and RPC layer
(``repro_torch.core.transport``): every verb's message is framed byte
for byte as the reference frames it (a u32 length prefix and
``msgpack.packb(msg, use_bin_type=True)``), each side decodes the
other's frames to the same object, port and reference RPC clients and
servers talk to each other, and the reference's TCP reader cases run
against the port's ``LcapService`` and ``RemoteReader``.
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import msgpack                                             # noqa: E402

import repro.core.transport as ref_transport               # noqa: E402
from repro.core import records as R                       # noqa: E402
from repro.core.tenancy import TenantPrincipal            # noqa: E402
import repro_torch.core.transport as port_transport        # noqa: E402
from repro_torch.core import records as T                 # noqa: E402
from repro_torch.core.llog import Llog                    # noqa: E402
from repro_torch.core.proxy import LcapProxy              # noqa: E402
from repro_torch.core.reader import RemoteReader          # noqa: E402
from repro_torch.core.server import LcapService           # noqa: E402

DEADLINE_S = 10.0


def _batch():
    recs = [R.ChangelogRecord(type=R.CL_CREATE, index=i + 1, time=10**18 + i,
                              tfid=R.Fid(0x200000400, 7 + i, 0),
                              pfid=R.Fid(0x200000400, 1, 0),
                              name=b"f%d" % i,
                              jobid=b"dd.500", xattr={"k": [i, -i]})
            for i in range(5)]
    recs.append(R.ChangelogRecord(type=R.CL_RENAME, index=6,
                                  tfid=R.Fid(2**64 - 1, 2**32 - 1, 1),
                                  pfid=R.Fid(1, 1, 0), name=b"to",
                                  sfid=R.Fid(3, 4, 5), spfid=R.Fid(6, 7, 8),
                                  sname=b"from"))
    return R.RecordBatch.from_records(recs)


V1 = _batch().to_wire(R.WIRE_V1)
V2 = _batch().to_wire(R.WIRE_V2)
TENANT = TenantPrincipal("acme", jobids=["dd.500"],
                         prefixes=[b"acme."]).to_wire()

#: one message per verb, as clients send it, and one reply per verb, as
#: services answer it; with v1/v2 frames as bin, nested acks, tuples,
#: None, negative and 64-bit ints, floats and non-ASCII strings
CORPUS = {
    "subscribe": {"op": "subscribe", "group": "robinhood", "name": None,
                  "mode": "persistent", "flags": None, "resume": None,
                  "replay": None, "types": [1, 6, 8, 14], "tenant": TENANT,
                  "wire": 2, "v": 1},
    "resume": {"op": "resume", "group": "audit", "name": "wörker-1 ✓",
               "mode": "persistent", "flags": 0x0F, "resume": True,
               "replay": 2**40, "types": None, "tenant": None, "wire": 2,
               "v": 1},
    "subscribe_reply": {"v": 1, "wire": 2, "cid": "robinhood/3",
                        "resumed": False, "flags": 0x1F,
                        "token": {"mdt0": 17, "mdt1": 2**33},
                        "replay": False, "shard": 0, "shards": 4,
                        "epoch": 3},
    "caps": {"op": "caps"},
    "caps_reply": {"v": 1, "wire": 2, "deep": True, "epoch": 0},
    "topology": {"op": "topology", "v": 1},
    "topology_reply": {"v": 1, "epoch": 2, "shards": 3,
                       "addresses": [["127.0.0.1", 40001],
                                     ("127.0.0.1", 65535), ["::1", 1]]},
    "add_source": {"op": "add_source", "pid": "mdt0", "first": 1},
    "offer": {"op": "offer", "pid": "mdt0", "blob": V1, "hi": 6},
    "offer_many": {"op": "offer_many",
                   "offers": [("mdt0", V2, 6), ("mdt1", V1, 2**63 - 1),
                              ("mdt2", R.RecordBatch.empty().to_wire(2),
                               0)]},
    "offer_reply": {"admitted": 6, "watermarks": {"mdt0": 6, "mdt1": 0}},
    "watermarks": {"op": "watermarks"},
    "register": {"op": "register", "group": None, "flags": None,
                 "mode": "ephemeral"},
    "fetch": {"op": "fetch", "cid": "robinhood/3", "max": 65536, "v": 1},
    "fetch_reply": {"batches": [("mdt0", V2), ("mdt1", V1)], "epoch": 1},
    "fetch_replay": {"op": "fetch_replay", "cid": "boot/1", "max": 256},
    "fetch_replay_reply": {"batches": [["mdt0", V2]], "done": False},
    "commit": {"op": "commit", "cid": "robinhood/3",
               "acks": {"mdt0": list(range(1, 300)) + [65535, 65536,
                                                       2**32, 2**64 - 1],
                        "mdt1": list(range(70_000))}},
    "commit_reply": {"ok": True, "epoch": 7},
    "ack": {"op": "ack", "cid": "c", "pid": "mdt0", "index": 2**64 - 1},
    "ack_batch": {"op": "ack_batch", "cid": "c", "pid": "mdt0",
                  "indices": [1, 127, 128, 255, 256, 65535, 65536]},
    "detach": {"op": "detach", "cid": "audit/1"},
    "close": {"op": "close", "cid": "audit/1"},
    "stats": {"op": "stats"},
    "stats_reply": {"stats": {"dispatched": 262144, "ratio": 0.125,
                              "neg": -1, "small": -32, "i8": -33,
                              "i16": -129, "i32": -(2**31) - 1,
                              "i64": -(2**63), "huge": 1e300,
                              "tiny": -5e-324, "zero": 0.0}},
    "metrics": {"op": "metrics"},
    "metrics_reply": {"metrics": {}},
    "lag": {"op": "lag"},
    "lag_reply": {"lag": {"robinhood": {"mdt0": {
        "dispatch_hw": 9, "ack": 3, "lag": 6, "in_flight": 2}}}},
    "error_reply": {"err": "UnknownConsumerError: unknown or unsubscribed "
                    "consumer 'nope' — ünïcödé",
                    "err_type": "UnknownConsumerError"},
    "sizes": {"s": "x" * 31, "s8": "y" * 255, "s16": "z" * 65_536,
              "b8": b"\0" * 255, "b16": b"\1" * 256, "b32": b"\2" * 70_000,
              "map16": {f"k{i}": i for i in range(16)},
              "arr16": [None, True, False] * 6},
}


def _pair(write, read):
    """Run ``write(a)`` on a thread while ``read(b)`` reads the other end
    of a socket pair (frames larger than the socket buffer would block a
    writer that nobody reads)."""
    a, b = socket.socketpair()
    try:
        def writer():
            try:
                write(a)
            finally:
                a.shutdown(socket.SHUT_WR)
        t = threading.Thread(target=writer, daemon=True)
        t.start()
        out = read(b)
        t.join(DEADLINE_S)
        assert not t.is_alive()
        return out
    finally:
        a.close()
        b.close()


def wire_bytes(send_msg, msg) -> bytes:
    def read_all(sock):
        chunks = []
        while True:
            chunk = sock.recv(1 << 20)
            if not chunk:
                return b"".join(chunks)
            chunks.append(chunk)
    return _pair(lambda sock: send_msg(sock, msg), read_all)


def decode(recv_msg, frame: bytes):
    return _pair(lambda sock: sock.sendall(frame), recv_msg)


@pytest.mark.parametrize("verb", sorted(CORPUS))
def test_framing_is_byte_identical(verb):
    msg = CORPUS[verb]
    want = msgpack.packb(msg, use_bin_type=True)
    ref = wire_bytes(ref_transport.send_msg, msg)
    port = wire_bytes(port_transport.send_msg, msg)
    assert port == ref == struct.pack("<I", len(want)) + want


@pytest.mark.parametrize("verb", sorted(CORPUS))
def test_each_side_decodes_the_others_frames(verb):
    msg = CORPUS[verb]
    ref_frame = wire_bytes(ref_transport.send_msg, msg)
    port_frame = wire_bytes(port_transport.send_msg, msg)
    got = [decode(port_transport.recv_msg, ref_frame),
           decode(ref_transport.recv_msg, port_frame),
           decode(port_transport.recv_msg, port_frame)]
    want = decode(ref_transport.recv_msg, ref_frame)
    assert want == msgpack.unpackb(ref_frame[4:], raw=False)
    assert all(g == want for g in got)
    for g in got:
        assert repr(g) == repr(want)            # types too (bytes, lists)


def test_numpy_scalars_are_refused_as_msgpack_refuses_them():
    for bad in ({"hi": np.int64(3)}, {"acks": {"m": [np.uint64(1)]}},
                {"ok": np.bool_(True)}):
        with pytest.raises(TypeError):
            msgpack.packb(bad, use_bin_type=True)
        a, b = socket.socketpair()
        try:
            with pytest.raises(TypeError):
                port_transport.send_msg(a, bad)
        finally:
            a.close()
            b.close()


def test_truncated_frame_reads_as_closed_connection():
    frame = wire_bytes(port_transport.send_msg, CORPUS["commit"])
    assert decode(port_transport.recv_msg, frame[:-1]) is None
    assert decode(port_transport.recv_msg, frame[:3]) is None


def _echo(msg, session):
    session["n"] = session.get("n", 0) + 1
    return {"echo": msg, "n": session["n"]}


@pytest.mark.parametrize("client,server", [
    (port_transport, ref_transport), (ref_transport, port_transport),
    (port_transport, port_transport)], ids=["port-ref", "ref-port",
                                            "port-port"])
def test_rpc_client_and_server_interoperate(client, server):
    gone = []
    srv = server.RpcServer(_echo, on_disconnect=gone.append).start()
    try:
        rpc = client.RpcClient(srv.address)
        try:
            assert rpc.call(CORPUS["commit"]) == \
                {"echo": CORPUS["commit"], "n": 1}
            msgs = [CORPUS[v] for v in ("offer_many", "fetch", "subscribe",
                                        "stats_reply")]
            replies = rpc.call_pipelined(msgs)
            assert [r["n"] for r in replies] == [2, 3, 4, 5]
            assert [r["echo"] for r in replies] == \
                [msgpack.unpackb(msgpack.packb(m, use_bin_type=True))
                 for m in msgs]
            rpc.send_request({"op": "x"})
            assert rpc.recv_reply()["n"] == 6
        finally:
            rpc.close()
        deadline = time.monotonic() + DEADLINE_S
        while not gone and time.monotonic() < deadline:
            time.sleep(0.005)
        assert gone == [{"n": 6}]
    finally:
        srv.stop()


class _Counter:
    """The registry surface ``transport.instrument`` uses, and no more."""

    def __init__(self):
        self.values = {}

    def counter(self, name, help_text, labels=()):
        outer = self

        class _Family:
            def labels(self, **kw):
                key = (name, tuple(sorted(kw.items())))
                outer.values.setdefault(key, 0)

                class _Child:
                    def inc(self, n=1):
                        outer.values[key] += n
                return _Child()
        return _Family()


def test_instrument_counts_frames_and_bytes(monkeypatch):
    monkeypatch.setattr(port_transport, "_METRICS", None)
    reg = _Counter()
    port_transport.instrument(reg)
    msg = CORPUS["offer_many"]
    frame = wire_bytes(port_transport.send_msg, msg)
    decode(port_transport.recv_msg, frame)
    v = reg.values
    assert v[("lcap_transport_messages_total", (("direction", "sent"),))] \
        == 1
    assert v[("lcap_transport_bytes_total", (("direction", "sent"),))] \
        == len(frame)
    assert v[("lcap_transport_messages_total",
              (("direction", "received"),))] == 1
    assert v[("lcap_transport_bytes_total", (("direction", "received"),))] \
        == len(frame)


# --------------------- tests/test_transport.py's cases against the port
def rec(oid, name=b"f"):
    return T.ChangelogRecord(type=T.CL_CREATE, tfid=T.Fid(1, oid, 0),
                             pfid=T.Fid(1, 0, 0), name=name,
                             jobid=b"job-%d" % oid)


@pytest.fixture()
def service():
    logs = {"mdt0": Llog("mdt0"), "mdt1": Llog("mdt1")}
    proxy = LcapProxy(logs)
    svc = LcapService(proxy, poll_interval=0.001).start()
    yield svc, logs
    svc.stop()


def fetch_until(reader, want, timeout=DEADLINE_S):
    got = []
    deadline = time.monotonic() + timeout
    while len(got) < want and time.monotonic() < deadline:
        batch = reader.fetch()
        if batch:
            got.extend(batch)
        else:
            time.sleep(0.002)
    return got


def wait_for(cond, timeout=DEADLINE_S):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    return cond()


def test_remote_roundtrip_and_ack(service):
    svc, logs = service
    r = RemoteReader(svc.address, "g")
    try:
        for i in range(10):
            logs["mdt0"].log(rec(i))
            logs["mdt1"].log(rec(i))
        got = fetch_until(r, 20)
        assert len(got) == 20
        assert {pid for pid, _ in got} == {"mdt0", "mdt1"}
        for pid, record in got:
            r.ack(pid, record.index)
        assert wait_for(lambda: logs["mdt0"].first_index == 11
                        and logs["mdt1"].first_index == 11)
    finally:
        r.close()


def test_remote_group_load_balancing(service):
    svc, logs = service
    rs = [RemoteReader(svc.address, "g") for _ in range(3)]
    try:
        for i in range(60):
            logs["mdt0"].log(rec(i))
        per = [fetch_until(r, 60 // 3 - 5) for r in rs]
        total = sum(len(p) for p in per)
        deadline = time.monotonic() + DEADLINE_S
        while total < 60 and time.monotonic() < deadline:
            for r, p in zip(rs, per):
                p.extend(r.fetch())
            total = sum(len(p) for p in per)
        assert total == 60
        assert all(len(p) > 0 for p in per)
    finally:
        for r in rs:
            r.close()


def test_remote_flags_strip(service):
    svc, logs = service
    old = RemoteReader(svc.address, "old", flags=0)
    try:
        logs["mdt0"].log(rec(1))
        (pid, record), = fetch_until(old, 1)
        assert record.jobid is None           # stripped remotely
    finally:
        old.close()


def test_crash_disconnect_triggers_redelivery(service):
    svc, logs = service
    a = RemoteReader(svc.address, "g")
    b = RemoteReader(svc.address, "g")
    try:
        for i in range(30):
            logs["mdt0"].log(rec(i))
        got_a = fetch_until(a, 10)
        assert got_a
        a.close(failed=True)                  # socket drop, no deregister
        seen = {r.index for _, r in fetch_until(b, 30)}
        deadline = time.monotonic() + DEADLINE_S
        while len(seen) < 30 and time.monotonic() < deadline:
            seen |= {r.index for _, r in b.fetch()}
            time.sleep(0.005)
        assert seen == set(range(1, 31))
    finally:
        b.close()


def test_remote_error_reporting(service):
    svc, _ = service
    r = RemoteReader(svc.address, "g")
    try:
        reply = r.rpc.call({"op": "ack", "cid": "nope", "pid": "mdt0",
                            "index": 1})
        assert "err" in reply and reply["err_type"] == \
            "UnknownConsumerError"
    finally:
        r.close()
