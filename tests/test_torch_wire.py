"""Port parity over the wire: reference and port services, sessions,
remote shards and cluster services serve each other, byte for byte.

- the interop matrix: {reference, port} ``LcapService`` x {reference,
  port} ``connect(...)`` on the same seeded journals; every group gets
  the same ``(pid, index, packed bytes)`` as the reference-reference run;
- an old client (no ``"wire"`` key) gets v1 frames;
- ``RemoteShard`` across packages, against deep v2 and shallow v1 peers,
  and the v1/v2 wire equivalence of a cluster service;
- ``LcapClusterService`` across packages: fan-in, topology discovery and
  an ``add_shard`` epoch bump mid-stream;
- a shard service lost mid-stream, a crashed wire consumer, and shard
  daemons in spawned processes.

Every wait polls against a deadline of at most 10 s; every service,
client and daemon is stopped in a ``finally``.  Port clusters route on
the CPU (``device="cpu"``, the kernel's plain version).
"""

import multiprocessing as mp
import socket
import time
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core.cluster as ref_cluster                   # noqa: E402
import repro.core.llog as ref_llog                         # noqa: E402
import repro.core.proxy as ref_proxy                       # noqa: E402
import repro.core.server as ref_server                     # noqa: E402
import repro.core.session as ref_session                   # noqa: E402
import repro.core.tenancy as ref_tenancy                   # noqa: E402
import repro.core.transport as ref_transport               # noqa: E402
from repro.core import records as R                       # noqa: E402
import repro_torch.core.cluster as port_cluster            # noqa: E402
import repro_torch.core.llog as port_llog                  # noqa: E402
import repro_torch.core.proxy as port_proxy                # noqa: E402
import repro_torch.core.server as port_server              # noqa: E402
import repro_torch.core.session as port_session            # noqa: E402
import repro_torch.core.tenancy as port_tenancy            # noqa: E402
import repro_torch.core.transport as port_transport        # noqa: E402
from repro_torch.core import records as T                 # noqa: E402

REF = SimpleNamespace(name="ref", R=R, llog=ref_llog, proxy=ref_proxy,
                      server=ref_server, session=ref_session,
                      cluster=ref_cluster, tenancy=ref_tenancy,
                      transport=ref_transport, kw={})
PORT = SimpleNamespace(name="port", R=T, llog=port_llog, proxy=port_proxy,
                       server=port_server, session=port_session,
                       cluster=port_cluster, tenancy=port_tenancy,
                       transport=port_transport, kw={"device": "cpu"})
CROSS = [(PORT, REF), (REF, PORT)]
CROSS_IDS = ["port-serves-ref", "ref-serves-port"]

DEADLINE_S = 10.0
MIX = ((R.CL_CREATE, 30), (R.CL_SETATTR, 25), (R.CL_CLOSE, 15),
       (R.CL_UNLINK, 15), (R.CL_MKDIR, 5), (R.CL_RMDIR, 5), (R.CL_RENAME, 5))
AUDIT_TYPES = frozenset({R.CL_CREATE, R.CL_UNLINK, R.CL_RENAME, R.CL_RMDIR})


def packed_records(m: int, n: int, seed: int, oids: int = 700) -> list:
    """``n`` packed records of MDT ``m`` (indices 1..n): the operation
    mix, a jobid on every record, reused target oids, renames."""
    rng = np.random.default_rng([seed, m])
    types = np.repeat([t for t, _ in MIX], [w for _, w in MIX])
    out = []
    for i in range(n):
        rtype = int(types[rng.integers(0, len(types))])
        job = int(rng.integers(0, 64))
        rec = R.ChangelogRecord(
            type=rtype, index=i + 1, time=10**18 + i,
            tfid=R.Fid(0x200000400 + m, int(rng.integers(1, oids)), 0),
            pfid=R.Fid(0x200000400 + m, 1, 0), name=b"f%d" % i,
            jobid=b"%s.%d" % ((b"dd", b"acme")[job % 2], 500 + job))
        if rtype == R.CL_RENAME:
            rec.sfid, rec.spfid, rec.sname = (R.Fid(0x200000400 + m, i, 0),
                                              R.Fid(0x200000400 + m, 1, 0),
                                              b"old%d" % i)
        out.append(R.pack(rec))
    return out


def append(pkg, log, packed) -> list:
    """Journal ``packed`` records on ``log`` (indices continue, cr_prev
    chains are the journal's); returns the ``(pid, index, packed bytes)``
    the journal now holds for them."""
    idx = log.log_batch([pkg.R.unpack(b) for b in packed])
    batch = log.read(idx[0], len(idx))
    assert batch.indices() == idx
    return [(log.producer_id, i, bytes(b)) for i, b in zip(idx, batch)]


def trimmed(logs) -> bool:
    return all(log.first_index == log.last_index + 1 for log in logs.values())


def wait_for(cond, timeout=DEADLINE_S) -> bool:
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.002)
    return cond()


# ------------------------------------------------------ the interop matrix
N_MATRIX = 1200


@pytest.fixture(scope="module")
def journals():
    return {f"mdt{m}": packed_records(m, N_MATRIX, seed=14)
            for m in range(3)}


def matrix_specs(client):
    S = client.session.Subscription
    acme = client.tenancy.TenantPrincipal("acme", prefixes=(b"acme.",))
    return [("robinhood", S(group="robinhood", auto_commit=False,
                            zero_fill=False)),
            ("robinhood", S(group="robinhood", auto_commit=False,
                            zero_fill=False)),
            ("audit", S(group="audit", types=AUDIT_TYPES, flags=R.CLF_JOBID,
                        auto_commit=False, max_records=300)),
            ("acme", S(group="acme", tenant=acme, auto_commit=False,
                       zero_fill=False)),
            ("reader", S(mode=client.proxy.EPHEMERAL, auto_commit=False,
                         zero_fill=False))]


def expected_counts(journals) -> dict:
    recs = [R.unpack(b) for bufs in journals.values() for b in bufs]
    total = len(recs)
    return {"robinhood": total, "reader": total,
            "audit": sum(r.type in AUDIT_TYPES for r in recs),
            "acme": sum(r.jobid.startswith(b"acme.") for r in recs)}


def run_matrix(server, client, journals) -> dict:
    """Journals in ``server``'s package behind its ``LcapService``;
    consumers of ``client``'s package, one session each, subscribed
    before any record is journaled.  Returns group -> sorted
    ``(pid, index, packed bytes)``."""
    logs = {pid: server.llog.Llog(pid) for pid in journals}
    proxy = server.proxy.LcapProxy(logs, batch_size=256)
    svc = server.server.LcapService(proxy, poll_interval=0.001).start()
    sessions = []
    try:
        streams = []
        for group, spec in matrix_specs(client):
            sess = client.session.connect(svc.address)
            sessions.append(sess)
            streams.append((group, sess.subscribe(spec)))
            assert sess._backend.wire == R.WIRE_V2
        for pid, bufs in journals.items():
            append(server, logs[pid], bufs)
        want = expected_counts(journals)
        got = {g: [] for g in want}

        def progress():
            for group, stream in streams:
                for pid, batch in stream.fetch(4096):
                    got[group].extend(
                        (pid, i, bytes(b))
                        for i, b in zip(batch.indices(), batch))
                stream.commit()
            return (all(len(got[g]) >= want[g] for g in want)
                    and trimmed(logs))

        assert wait_for(progress), {g: len(v) for g, v in got.items()}
        for g, v in got.items():
            assert len(v) == len(set(v)) == want[g], g
        return {g: sorted(v) for g, v in got.items()}
    finally:
        for sess in sessions:
            sess.close()
        svc.stop()


@pytest.fixture(scope="module")
def ref_ref(journals):
    return run_matrix(REF, REF, journals)


@pytest.mark.parametrize("server,client", [(REF, PORT), (PORT, REF),
                                           (PORT, PORT)],
                         ids=["ref-port", "port-ref", "port-port"])
def test_interop_matrix_delivers_what_ref_ref_delivers(server, client,
                                                       journals, ref_ref):
    got = run_matrix(server, client, journals)
    assert got == ref_ref


def test_interop_matrix_ref_ref_is_complete(journals, ref_ref):
    """The baseline itself: every record, once, in its group's
    projection (audit carries only the jobid extension)."""
    want = expected_counts(journals)
    assert {g: len(v) for g, v in ref_ref.items()} == want
    for _pid, _i, blob in ref_ref["audit"]:
        assert R.unpack(blob).flags & ~R.CLF_JOBID & R.CLF_SUPPORTED == 0


@pytest.mark.parametrize("server", [PORT, REF], ids=["port", "ref"])
def test_old_client_gets_v1_frames(server):
    """A client that sends no ``"wire"`` key gets v1 frames (first u32 =
    record count); a v2 subscriber gets frames with the v2 magic; both
    decode to the same records."""
    log = server.llog.Llog("m0")
    svc = server.server.LcapService(server.proxy.LcapProxy({"m0": log}),
                                    poll_interval=0.001).start()
    try:
        old = port_transport.RpcClient(svc.address)
        new = ref_transport.RpcClient(svc.address)
        try:
            a = old.call({"op": "subscribe", "group": "old", "v": 1})
            b = new.call({"op": "subscribe", "group": "new", "v": 1,
                          "wire": 2})
            assert a["wire"] == R.WIRE_V1 and b["wire"] == R.WIRE_V2
            append(server, log, packed_records(0, 50, seed=3))
            frames = {"old": [], "new": []}

            def fetched():
                for name, rpc, cid in (("old", old, a["cid"]),
                                       ("new", new, b["cid"])):
                    reply = rpc.call({"op": "fetch", "cid": cid, "max": 64})
                    frames[name] += [blob for _pid, blob in reply["batches"]]
                return all(sum(len(R.RecordBatch.from_wire(f)) for f in fs)
                           == 50 for fs in frames.values())

            assert wait_for(fetched)
            magic = int.from_bytes(bytes(frames["new"][0][:4]), "little")
            assert magic == R.WIRE2_MAGIC
            for blob in frames["old"]:
                n = int.from_bytes(bytes(blob[:4]), "little")
                assert n == len(R.RecordBatch.from_wire(blob)) != magic
            recs = {name: [bytes(r) for f in fs
                           for r in T.RecordBatch.from_wire(f)]
                    for name, fs in frames.items()}
            assert recs["old"] == recs["new"]
        finally:
            old.close()
            new.close()
    finally:
        svc.stop()


# ----------------------------------------------------------- remote shards
def old_service(pkg):
    """A pre-v2 daemon of ``pkg``: no ``caps``/``offer_many`` verbs,
    ignores the ``wire`` key, always frames fetches as v1."""
    class OldLcapService(pkg.server.LcapService):
        def _handle(self, msg, session):
            if msg.get("op") in ("caps", "offer_many"):
                return {"err": f"unknown op {msg.get('op')!r}",
                        "err_type": "SessionError"}
            msg = {k: v for k, v in msg.items() if k != "wire"}
            reply = super()._handle(msg, session)
            reply.pop("wire", None)
            return reply
    return OldLcapService


def run_remote_shard(coord, shard_pkg, peer: str):
    """One journal on a ``coord`` coordinator, one ``shard_pkg`` shard
    service reached through ``coord``'s ``RemoteShard``, a ``coord``
    consumer over the wire."""
    log = coord.llog.Llog("m0")
    proxy = shard_pkg.proxy.LcapProxy({})
    cls = (shard_pkg.server.LcapService if peer == "deep"
           else old_service(shard_pkg))
    svc = cls(proxy, poll_interval=0.001).start()
    try:
        shard = coord.cluster.RemoteShard(svc.address)
        cluster = coord.cluster.LcapCluster({"m0": log}, shards=[shard],
                                            **coord.kw)
        caps = shard.caps()
        sess = coord.session.connect([svc.address])
        try:
            stream = sess.subscribe(coord.session.Subscription(
                group="g", auto_commit=False, zero_fill=False))
            journaled = append(coord, log,
                               packed_records(0, 60, seed=5, oids=7))
            got, columns = [], []

            def progress():
                cluster.pump()
                for pid, batch in stream.fetch(4096):
                    columns.append(batch._hdr is not None
                                   and not batch._recs)
                    got.extend((pid, i, bytes(b))
                               for i, b in zip(batch.indices(), batch))
                stream.commit()
                return len(got) >= 60 and trimmed({"m0": log})

            assert wait_for(progress)
            assert sorted(got) == journaled
            return caps, columns
        finally:
            sess.close()
            cluster.close()
    finally:
        svc.stop()


@pytest.mark.parametrize("coord,shard_pkg", CROSS,
                         ids=["port-to-ref", "ref-to-port"])
def test_remote_shard_negotiates_deep_v2_peer(coord, shard_pkg):
    caps, columns = run_remote_shard(coord, shard_pkg, "deep")
    assert caps == {"wire": R.WIRE_V2, "deep": True}
    # every delivered batch arrived with columns attached and zero
    # per-record decodes pending — the columnar delivery path
    assert columns and all(columns)


@pytest.mark.parametrize("coord,shard_pkg", CROSS,
                         ids=["port-to-ref", "ref-to-port"])
def test_remote_shard_falls_back_to_v1_peer(coord, shard_pkg):
    caps, _columns = run_remote_shard(coord, shard_pkg, "shallow")
    assert caps == {"wire": R.WIRE_V1, "deep": False}


# --------------------------------------------------------- cluster service
def fan_in(client, svc):
    """``client``'s fan-in session over ``svc``: ``connect(svc)`` within
    a package; across packages, a ``ClusterSession`` over the shard
    addresses with the service's topology callable."""
    if isinstance(svc, client.cluster.LcapClusterService):
        return client.session.connect(svc)
    S = client.session
    return S.ClusterSession(
        [(i, S.Session(S._WireBackend(tuple(a))))
         for i, a in enumerate(svc.addresses)],
        topology=svc.cluster_info)


def service_cluster(pkg, n_journals=2, n_shards=2):
    logs = {f"h{i}": pkg.llog.Llog(f"h{i}") for i in range(n_journals)}
    cluster = pkg.cluster.LcapCluster(logs, n_shards=n_shards, **pkg.kw)
    return cluster, logs, pkg.cluster.LcapClusterService(cluster)


def drain_wire(stream, logs, got, want: int) -> bool:
    def progress():
        for pid, batch in stream.fetch(4096):
            got.extend((pid, i, bytes(b))
                       for i, b in zip(batch.indices(), batch))
        stream.commit()
        return len(set(got)) >= want and trimmed(logs)
    return wait_for(progress)


def run_cluster_workload(svc_pkg, client) -> list:
    """test_wire2.py's cluster-path workload: a 2-shard cluster service,
    one consumer; returns the sorted delivered packed records."""
    cluster, logs, svc = service_cluster(svc_pkg)
    svc.start()
    try:
        sess = fan_in(client, svc)
        try:
            stream = sess.subscribe(client.session.Subscription(
                group="g", auto_commit=False, zero_fill=False))
            packed = {pid: packed_records(k, 60, seed=9, oids=11)
                      for k, pid in enumerate(sorted(logs))}
            for pid, bufs in packed.items():
                append(svc_pkg, logs[pid], bufs)
            got = []
            assert drain_wire(stream, logs, got, 120)
            assert len(got) == 120
            return sorted((pid, bytes(b)) for pid, _i, b in got)
        finally:
            sess.close()
    finally:
        svc.stop()


@pytest.mark.parametrize("svc_pkg,client", CROSS, ids=CROSS_IDS)
def test_cluster_equivalence_v1_vs_v2_wire(svc_pkg, client, monkeypatch):
    """The same workload down the v2 and v1 wire paths, served by one
    package to the other, delivers what the reference delivers to
    itself, bit for bit."""
    v2 = run_cluster_workload(svc_pkg, client)
    monkeypatch.setattr(svc_pkg.server, "WIRE_V2", R.WIRE_V1)
    v1 = run_cluster_workload(svc_pkg, client)
    monkeypatch.undo()
    assert v1 == v2 == run_cluster_workload(REF, REF)


@pytest.mark.parametrize("svc_pkg,client", CROSS, ids=CROSS_IDS)
def test_cluster_service_fan_in_and_shard_aware_subscribe(svc_pkg, client):
    cluster, logs, svc = service_cluster(svc_pkg)
    svc.start()
    try:
        assert len(svc.addresses) == 2
        sess = fan_in(client, svc)
        try:
            stream = sess.subscribe(client.session.Subscription(
                group="g", auto_commit=False, zero_fill=False))
            assert sorted(stream.shards) == [0, 1]
            journaled = [r for k, pid in enumerate(sorted(logs))
                         for r in append(svc_pkg, logs[pid],
                                         packed_records(k, 30, seed=4,
                                                        oids=5))]
            got = []
            assert drain_wire(stream, logs, got, 60)
            assert sorted(got) == sorted(journaled)
        finally:
            sess.close()
    finally:
        svc.stop()


@pytest.mark.parametrize("svc_pkg,client", CROSS, ids=CROSS_IDS)
def test_fan_in_sees_epoch_bump_and_reresolves(svc_pkg, client):
    """A live consumer of the other package observes the shard-set
    change (piggybacked epoch), opens a child on the new shard, and
    commits land on the new owner — no restart."""
    cluster, logs, svc = service_cluster(svc_pkg)
    svc.start()
    try:
        sess = fan_in(client, svc)
        try:
            stream = sess.subscribe(client.session.Subscription(
                group="g", auto_commit=False, zero_fill=False))
            e0 = stream.epoch
            packed = {pid: packed_records(k, 100, seed=6, oids=9)
                      for k, pid in enumerate(sorted(logs))}
            journaled = []
            for pid, bufs in packed.items():
                journaled += append(svc_pkg, logs[pid], bufs[:30])
            got = []
            assert drain_wire(stream, logs, got, 60)
            new = svc.add_shard()
            with cluster._lock:
                cluster.migrate_slots(cluster.routing.slots_of(0)[:20], new)
            for pid, bufs in packed.items():
                journaled += append(svc_pkg, logs[pid], bufs[30:])
            assert drain_wire(stream, logs, got, 200)
            assert set(got) == set(journaled)
            assert stream.epoch > e0
            assert new in stream.shards
            assert dict(stream._children)[new].cursors
        finally:
            sess.close()
    finally:
        svc.stop()


@pytest.mark.parametrize("svc_pkg,client", CROSS, ids=CROSS_IDS)
def test_topology_verb_served_by_every_shard(svc_pkg, client):
    cluster, logs, svc = service_cluster(svc_pkg, n_journals=1)
    svc.start()
    try:
        sess = client.session.connect(list(svc.addresses))
        try:
            stream = sess.subscribe(client.session.Subscription(
                group="g", auto_commit=False))
            topo = sess._topology_snapshot()
            assert topo["shards"] == 2 and len(topo["addresses"]) == 2
            new = svc.add_shard()
            append(svc_pkg, logs["h0"], packed_records(0, 10, seed=8))

            def discovered():
                stream.fetch(4096)
                stream.commit()
                return new in stream.shards
            assert wait_for(discovered)
        finally:
            sess.close()
    finally:
        svc.stop()


# ------------------------------------------------------- failure handling
def crashable(svc):
    """Make ``svc`` crashable like a killed daemon: its listener and
    every connection it accepted close at once."""
    socks = []
    handler = svc.server._server.RequestHandlerClass
    setup = handler.setup

    def tracking_setup(self):
        socks.append(self.request)
        setup(self)

    handler.setup = tracking_setup

    def crash():
        svc.stop()
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()
    return crash


@pytest.mark.parametrize("shard_pkg", [PORT, REF], ids=["port", "ref"])
def test_shard_loss_mid_stream(shard_pkg):
    """A port coordinator over three shard services; one dies mid-stream.
    Its slots fail over, its backlog is re-offered from the journals: no
    (pid, index) is lost and every journal trims."""
    logs = {f"m{i}": port_llog.Llog(f"m{i}") for i in range(2)}
    svcs = [shard_pkg.server.LcapService(shard_pkg.proxy.LcapProxy({}),
                                         poll_interval=0.001).start()
            for _ in range(3)]
    crash = crashable(svcs[1])
    try:
        cluster = port_cluster.LcapCluster(
            logs, shards=[port_cluster.RemoteShard(s.address, index=i)
                          for i, s in enumerate(svcs)], device="cpu")
        sess = port_session.connect([s.address for s in svcs])
        try:
            stream = sess.subscribe(port_session.Subscription(
                group="g", auto_commit=False, zero_fill=False))
            packed = {pid: packed_records(k, 300, seed=11, oids=50)
                      for k, pid in enumerate(sorted(logs))}
            for pid, bufs in packed.items():
                append(PORT, logs[pid], bufs[:150])
            got = []

            def step():
                cluster.pump(pump_shards=False)
                cluster.collect_watermarks()
                for pid, batch in stream.fetch(64):
                    got.extend((pid, i) for i in batch.indices())
                stream.commit()

            # part way: some records delivered, the rest still in flight
            assert wait_for(lambda: step() or len(got) >= 50)
            crash()
            for pid, bufs in packed.items():
                append(PORT, logs[pid], bufs[150:])
            assert wait_for(lambda: step() or (len(set(got)) >= 600
                                               and trimmed(logs)))
            assert set(got) == {(pid, i) for pid in logs
                                for i in range(1, 301)}
            assert not cluster.alive[1]
            assert stream.lost == [1]
        finally:
            sess.close()
            cluster.close()
    finally:
        for s in (svcs[0], svcs[2]):
            s.stop()


@pytest.mark.parametrize("svc_pkg,client", [(PORT, PORT), (PORT, REF),
                                            (REF, PORT)],
                         ids=["port-port", "port-ref", "ref-port"])
def test_wire_consumer_crash_redelivers_to_group(svc_pkg, client):
    log = svc_pkg.llog.Llog("m0")
    svc = svc_pkg.server.LcapService(svc_pkg.proxy.LcapProxy({"m0": log}),
                                     poll_interval=0.001).start()
    try:
        sa = client.session.connect(svc.address)
        sb = client.session.connect(svc.address)
        try:
            spec = client.session.Subscription(group="g", auto_commit=False)
            a, b = sa.subscribe(spec), sb.subscribe(spec)
            append(svc_pkg, log, packed_records(0, 40, seed=12))
            got_a = []

            def fetch_a():
                for _pid, batch in a.fetch(10):
                    got_a.extend(batch.indices())
                return bool(got_a)
            assert wait_for(fetch_a)
            a.close(failed=True)        # _WireBackend.crash: socket drops
            assert sa._backend.rpc._sock.fileno() == -1
            seen = set()

            def progress():
                for _pid, batch in b.fetch(4096):
                    seen.update(batch.indices())
                b.commit()
                return seen == set(range(1, 41)) and trimmed({"m0": log})
            assert wait_for(progress)
            assert set(got_a) <= seen    # a's backlog went to b
        finally:
            sa.close()
            sb.close()
    finally:
        svc.stop()


# ----------------------------------------------------------- shard daemons
def test_shard_daemons_with_local_groups():
    """Two ``run_shard_daemon`` processes (spawned; each imports torch
    and takes no device), each draining a co-located robinhood member;
    a port coordinator routes to them over deep v2 offers and an audit
    group consumes over the wire."""
    ctx = mp.get_context("spawn")
    procs, conns = [], []
    logs = {f"m{i}": port_llog.Llog(f"m{i}") for i in range(2)}
    try:
        for i in range(2):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=port_cluster.run_shard_daemon,
                            args=(child, i, 2),
                            kwargs={"poll_interval": 0.001,
                                    "local_groups": [("robinhood", 1)]},
                            daemon=True)
            p.start()
            procs.append(p)
            conns.append(parent)
        addrs = []
        for conn in conns:
            assert conn.poll(DEADLINE_S), "shard daemon did not report"
            addrs.append(tuple(conn.recv()))
        shards = [port_cluster.RemoteShard(a, index=i)
                  for i, a in enumerate(addrs)]
        cluster = port_cluster.LcapCluster(logs, shards=shards, n_slots=64,
                                           batch_size=128, device="cpu")
        sess = port_session.connect(addrs)
        try:
            stream = sess.subscribe(port_session.Subscription(
                group="audit", types=AUDIT_TYPES, auto_commit=False))
            packed = {pid: packed_records(k, 400, seed=13)
                      for k, pid in enumerate(sorted(logs))}
            for pid, bufs in packed.items():
                append(PORT, logs[pid], bufs)
            want = {(pid, i + 1) for pid, bufs in packed.items()
                    for i, b in enumerate(bufs)
                    if R.unpack(b).type in AUDIT_TYPES}
            got = []

            def progress():
                cluster.pump(pump_shards=False)
                cluster.collect_watermarks()
                for pid, batch in stream.fetch(4096):
                    got.extend((pid, i) for i in batch.indices())
                stream.commit()
                return len(got) >= len(want) and trimmed(logs)
            assert wait_for(progress)
            assert sorted(got) == sorted(want)
            assert all(s.caps() == {"wire": R.WIRE_V2, "deep": True}
                       for s in shards)
        finally:
            sess.close()
            cluster.close()
        drained = []
        for conn in conns:
            conn.send("stop")
            assert conn.poll(DEADLINE_S), "shard daemon did not stop"
            drained.append(conn.recv())
        assert sum(drained) == 800
        for p in procs:
            p.join(DEADLINE_S)
            assert not p.is_alive()
    finally:
        for p in procs:
            p.join(DEADLINE_S)
            if p.is_alive():
                p.kill()
                p.join(DEADLINE_S)


# ---------------------------------------------- routing faults stay faults
def failing_router(cluster):
    def batch_slots(batch):
        raise port_cluster.stream_ops.KernelCompileError("nvcc failed")
    cluster.batch_slots = batch_slots
    cluster.batch_slots_many = batch_slots


def test_kernel_fault_is_not_a_dead_remote_shard():
    """A routing kernel that does not build raises out of ``pump``; the
    remote shard it was routing for is not failed over."""
    log = port_llog.Llog("m0")
    svc = port_server.LcapService(port_proxy.LcapProxy({}),
                                  poll_interval=0.001).start()
    try:
        cluster = port_cluster.LcapCluster(
            {"m0": log}, shards=[port_cluster.RemoteShard(svc.address)],
            device="cpu")
        try:
            append(PORT, log, packed_records(0, 10, seed=1))
            failing_router(cluster)
            with pytest.raises(RuntimeError, match="nvcc failed"):
                cluster.pump(pump_shards=False)
            assert cluster.alive == [True]
            assert cluster.stats["shards_failed"] == 0
        finally:
            cluster.close()
    finally:
        svc.stop()


def test_cluster_service_keeps_the_distributor_failure():
    cluster, logs, svc = service_cluster(PORT, n_journals=1)
    failing_router(cluster)
    svc.start()
    try:
        append(PORT, logs["h0"], packed_records(0, 10, seed=1))
        assert wait_for(lambda: svc.failure is not None)
        assert isinstance(svc.failure,
                          port_cluster.stream_ops.KernelCompileError)
        assert all(cluster.alive)
    finally:
        svc.stop()
