"""Port parity of the federated multi-tenant plane: the cases of
tests/test_federation.py, each run on the reference and on the port
(``repro_torch.core.federation`` and the tenancy it rides on).  Every
case holds the reference test's own assertions on both packages, and
the delivered ``(origin, pid, batch)`` triples (batches compared as
their v2 wire frames, origin trailer included), ``GlobalCursor``
snapshots, stats and tenant accounts must equal the reference's.

Members are in process (proxies and clusters routing on the CPU), except
for the wire cases, which reach a member through its ``LcapService``.
Where the reference merges registries, ``Federation.metrics()`` must
give the reference's counters and gauge labels (token-bucket levels and
pump latencies hold wall time); the audit report comes from each
package's ``AuditTrail``.
"""

import importlib.util
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core.cluster as ref_cluster                   # noqa: E402
import repro.core.errors as ref_errors                     # noqa: E402
import repro.core.federation as ref_federation             # noqa: E402
import repro.core.llog as ref_llog                         # noqa: E402
import repro.core.proxy as ref_proxy                       # noqa: E402
import repro.core.server as ref_server                     # noqa: E402
import repro.core.session as ref_session                   # noqa: E402
import repro.core.tenancy as ref_tenancy                   # noqa: E402
import repro.obs as ref_obs                                # noqa: E402
import repro.track as ref_track                            # noqa: E402
from repro.core import records as R                       # noqa: E402
import repro_torch.core.cluster as port_cluster            # noqa: E402
import repro_torch.core.errors as port_errors              # noqa: E402
import repro_torch.core.federation as port_federation      # noqa: E402
import repro_torch.core.llog as port_llog                  # noqa: E402
import repro_torch.core.proxy as port_proxy                # noqa: E402
import repro_torch.core.server as port_server              # noqa: E402
import repro_torch.core.session as port_session            # noqa: E402
import repro_torch.core.tenancy as port_tenancy            # noqa: E402
import repro_torch.obs as port_obs                         # noqa: E402
import repro_torch.track as port_track                     # noqa: E402
from repro_torch.core import records as T                 # noqa: E402

#: ``chip_smoke.py`` as a module: its ``activity_counters`` is the one
#: normalisation of merged snapshots, shared with the card's phase 7
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

REF = SimpleNamespace(R=R, cluster=ref_cluster, errors=ref_errors,
                      federation=ref_federation, llog=ref_llog,
                      proxy=ref_proxy, server=ref_server,
                      session=ref_session, tenancy=ref_tenancy, obs=ref_obs,
                      track=ref_track, kw={})
PORT = SimpleNamespace(R=T, cluster=port_cluster, errors=port_errors,
                       federation=port_federation, llog=port_llog,
                       proxy=port_proxy, server=port_server,
                       session=port_session, tenancy=port_tenancy,
                       obs=port_obs, track=port_track, kw={"device": "cpu"})
DEADLINE_S = 10.0


def both(scenario, *args):
    """Run ``scenario`` on the reference and on the port; the port's
    observations must equal the reference's."""
    ref = scenario(REF, *args)
    port = scenario(PORT, *args)
    assert port == ref
    return ref


def rec(pkg, oid=1, ver=0, t=R.CL_CREATE, name=b"f", jobid=None, **kw):
    """The reference test's record, with a fixed timestamp (the journal
    would stamp the wall clock, which differs between the two runs)."""
    kw.setdefault("time", 10**18 + oid)
    return pkg.R.ChangelogRecord(type=t, tfid=pkg.R.Fid(1, oid, ver),
                                 pfid=pkg.R.Fid(1, 0, 0), name=name,
                                 jobid=jobid, **kw)


def feed(pkg, log, jobid, n, base=0, t=R.CL_CREATE):
    for i in range(n):
        log.log(rec(pkg, oid=base + i, t=t, jobid=jobid,
                    name=f"{base + i}".encode()))


def principals(pkg):
    P = pkg.tenancy.TenantPrincipal
    return P("acme", prefixes=[b"acme."]), P("evil", prefixes=[b"evil."])


def drain_scoped(pump, stream, rounds=200, trace=None):
    """Pump + fetch until quiescent; returns the set of jobids seen and
    (pid, index) delivery pairs; appends each batch's
    ``(origin, pid, v2 frame)`` to ``trace``."""
    jobids, seen = set(), set()
    idle = 0
    for _ in range(rounds):
        moved = pump() if pump else 0
        got = 0
        for item in stream.fetch(4096):
            pid, batch = item[-2], item[-1]
            if trace is not None:
                trace.append((item[0] if len(item) == 3 else None, pid,
                              batch.to_wire(R.WIRE_V2)))
            for i in range(len(batch)):
                r = batch.record(i)
                jobids.add(bytes(r.jobid or b""))
                seen.add((pid, r.index))
            got += len(batch)
        stream.commit()
        if not moved and not got and not stream.replaying:
            idle += 1
            if idle >= 3:
                break
        else:
            idle = 0
    return jobids, seen


def accounts(proxy) -> dict:
    return {name: (a.delivered_records, a.delivered_bytes,
                   a.filtered_records, a.replayed_records,
                   a.quota_blocked_pumps)
            for name, a in proxy.tenants.items()}


# ------------------------------------------------------------ principals
def _principal_validation(pkg):
    P, E = pkg.tenancy.TenantPrincipal, pkg.errors.TenantError
    for bad in (dict(name=""), dict(name="t"), dict(name="t",
                                                    prefixes=[b""]),
                dict(name="t", jobids=[b""]),
                dict(name="t", jobids=[b"x" * 33])):
        name = bad.pop("name")
        with pytest.raises(E):
            P(name, **bad)
    p = P("t", jobids=["a.1"], prefixes=["b."])
    assert p.allows(b"a.1") and p.allows(b"b.whatever")
    assert not p.allows(b"a.12") and not p.allows(b"")
    q = P.from_wire(p.to_wire())
    assert q == p
    assert P.from_wire(None) is None
    with pytest.raises(E):
        P.from_wire({"jobids": ["x"]})
    return p.to_wire()


def test_tenant_principal_validation():
    both(_principal_validation)


def _scope_mask(pkg):
    p = pkg.tenancy.TenantPrincipal("t", jobids=[b"exact"],
                                    prefixes=[b"pre."])
    jobs = [b"exact", b"exactly", b"pre.a", b"pr", b"", b"other"]
    col = np.zeros((len(jobs), 32), dtype=np.uint8)
    for i, j in enumerate(jobs):
        col[i, :len(j)] = np.frombuffer(j, dtype=np.uint8)
    mask = p.scope_mask(col).tolist()
    assert mask == [p.allows(j) for j in jobs]
    return mask


def test_scope_mask_matches_scalar():
    both(_scope_mask)


# ---------------------------------------------------------- scope pushdown
def _pushdown_single_proxy(pkg):
    acme, _evil = principals(pkg)
    log = pkg.llog.Llog("mdt0")
    proxy = pkg.proxy.LcapProxy({"mdt0": log})
    scoped = pkg.session.connect(proxy).subscribe(pkg.session.Subscription(
        group="g", tenant=acme, auto_commit=False))
    feed(pkg, log, b"acme.job", 5)
    feed(pkg, log, b"evil.job", 5, base=100)
    feed(pkg, log, None, 3, base=200)
    trace = []
    jobids, seen = drain_scoped(proxy.pump, scoped, trace=trace)
    assert jobids == {b"acme.job"} and len(seen) == 5
    assert proxy.stats["tenant_filtered"] == 8
    proxy.flush_upstream()
    assert log.first_index > 1
    assert proxy.tenants["acme"].delivered_records == 5
    assert proxy.tenants["acme"].delivered_bytes > 0
    return trace, accounts(proxy), dict(proxy.stats), log.first_index


def test_tenant_pushdown_single_proxy():
    both(_pushdown_single_proxy)


def _pushdown_columnar_partition(pkg):
    acme, evil = principals(pkg)
    S = pkg.session.Subscription
    log = pkg.llog.Llog("mdt0")
    proxy = pkg.proxy.LcapProxy({"mdt0": log}, batch_size=256)
    sess = pkg.session.connect(proxy)
    a = sess.subscribe(S(group="ga", tenant=acme, auto_commit=False))
    e = sess.subscribe(S(group="ge", tenant=evil, auto_commit=False))
    u = sess.subscribe(S(group="gu", auto_commit=False))
    for i in range(40):
        log.log(rec(pkg, oid=i, jobid=(b"acme.j", b"evil.j", None)[i % 3]))
    traces = [[], [], []]
    ja, sa = drain_scoped(proxy.pump, a, trace=traces[0])
    je, se = drain_scoped(None, e, trace=traces[1])
    ju, su = drain_scoped(None, u, trace=traces[2])
    assert ja == {b"acme.j"} and len(sa) == 14
    assert je == {b"evil.j"} and len(se) == 13
    assert len(su) == 40 and b"" in ju
    return traces, accounts(proxy)


def test_tenant_pushdown_columnar_partition():
    both(_pushdown_columnar_partition)


def _scoped_ephemeral(pkg):
    acme, _evil = principals(pkg)
    log = pkg.llog.Llog("mdt0")
    proxy = pkg.proxy.LcapProxy({"mdt0": log})
    eph = pkg.session.connect(proxy).subscribe(pkg.session.Subscription(
        mode="ephemeral", tenant=acme))
    feed(pkg, log, b"acme.x", 3)
    feed(pkg, log, b"evil.x", 3, base=50)
    trace = []
    jobids, seen = drain_scoped(proxy.pump, eph, trace=trace)
    assert jobids == {b"acme.x"} and len(seen) == 3
    return trace


def test_tenant_scoped_ephemeral_consumer():
    both(_scoped_ephemeral)


def _replay_bootstrap_scoped(pkg, root):
    root.mkdir()
    acme, _evil = principals(pkg)
    log = pkg.llog.Llog("mdt0", path=str(root / "j"), segment_records=8,
                        history=True)
    proxy = pkg.proxy.LcapProxy({"mdt0": log})
    live = pkg.session.connect(proxy).subscribe("live")
    feed(pkg, log, b"acme.old", 10)
    feed(pkg, log, b"evil.old", 10, base=100)
    proxy.pump()
    for _ in live:
        pass
    live.commit()
    proxy.flush_upstream()
    assert log.first_index > 1
    boot = pkg.session.connect(proxy).subscribe(pkg.session.Subscription(
        group="boot", tenant=acme, replay=True, auto_commit=False))
    trace = []
    jobids, seen = drain_scoped(proxy.pump, boot, trace=trace)
    assert jobids == {b"acme.old"} and len(seen) == 10
    assert boot.replayed == 10
    assert proxy.tenants["acme"].replayed_records == 10
    return trace, accounts(proxy)


def test_tenant_replay_bootstrap_is_scoped(tmp_path):
    ref = _replay_bootstrap_scoped(REF, tmp_path / "ref")
    assert _replay_bootstrap_scoped(PORT, tmp_path / "port") == ref


# ------------------------------------------------------- durable identity
def _resume_guards_tenant(pkg):
    acme, evil = principals(pkg)
    S = pkg.session.Subscription
    log = pkg.llog.Llog("mdt0")
    proxy = pkg.proxy.LcapProxy({"mdt0": log})
    sess = pkg.session.connect(proxy)
    s = sess.subscribe(S(group="g", name="aud", tenant=acme,
                         auto_commit=False))
    feed(pkg, log, b"acme.a", 4)
    feed(pkg, log, b"evil.a", 4, base=50)
    proxy.pump()
    got = s.fetch(2)
    assert got
    first = [(pid, b.to_wire(R.WIRE_V2)) for pid, b in got]
    s.commit()
    s.detach()
    with pytest.raises(pkg.errors.TenantError):
        sess.subscribe(S(group="g", name="aud", tenant=evil), resume=True)
    s2 = sess.resume("g", "aud", auto_commit=False)
    assert s2.resumed
    trace = []
    jobids, _seen = drain_scoped(proxy.pump, s2, trace=trace)
    assert jobids == {b"acme.a"}
    return first, trace, s2.resume_token


def test_resume_inherits_and_guards_tenant():
    both(_resume_guards_tenant)


def _rescoping_rejected(pkg):
    acme, _evil = principals(pkg)
    S = pkg.session.Subscription
    proxy = pkg.proxy.LcapProxy({"mdt0": pkg.llog.Llog("mdt0")})
    sess = pkg.session.connect(proxy)
    sess.subscribe(S(group="g", name="n")).detach()
    with pytest.raises(pkg.errors.TenantError):
        sess.subscribe(S(group="g", name="n", tenant=acme), resume=True)
    assert sess.resume("g", "n").resumed
    return True


def test_rescoping_unscoped_cursor_rejected():
    both(_rescoping_rejected)


def _tenant_over_the_wire(pkg, client):
    """``pkg``'s service, ``client``'s session: the server filters."""
    acme = client.tenancy.TenantPrincipal("acme", prefixes=[b"acme."])
    log = pkg.llog.Llog("mdt0")
    svc = pkg.server.LcapService(pkg.proxy.LcapProxy({"mdt0": log}),
                                 poll_interval=0.001).start()
    try:
        sess = client.session.connect(svc.address)
        try:
            s = sess.subscribe(client.session.Subscription(
                group="g", tenant=acme, auto_commit=False))
            feed(pkg, log, b"acme.w", 4)
            feed(pkg, log, b"evil.w", 4, base=50)
            jobids, seen = set(), set()
            deadline = time.monotonic() + DEADLINE_S
            while len(seen) < 4 and time.monotonic() < deadline:
                for _pid, batch in s.fetch(4096):
                    for i in range(len(batch)):
                        r = batch.record(i)
                        jobids.add(bytes(r.jobid or b""))
                        seen.add((r.index, R.pack(r)))
                s.commit()
                time.sleep(0.002)
            assert jobids == {b"acme.w"} and len(seen) == 4
            with pytest.raises(client.errors.TenantError):
                sess._backend._call({"op": "subscribe", "group": "g2",
                                     "tenant": {"jobids": ["x"]}})
            return sorted(seen)
        finally:
            sess.close()
    finally:
        svc.stop()


@pytest.mark.parametrize("server,client", [(PORT, PORT), (PORT, REF),
                                           (REF, PORT)],
                         ids=["port-port", "port-ref", "ref-port"])
def test_tenant_over_the_wire(server, client):
    assert _tenant_over_the_wire(server, client) == \
        _tenant_over_the_wire(REF, REF)


# ----------------------------------------------------------------- quotas
def _quota_parks_and_resumes(pkg):
    acme, _evil = principals(pkg)
    log = pkg.llog.Llog("mdt0")
    proxy = pkg.proxy.LcapProxy({"mdt0": log})
    clock = [0.0]
    proxy._now = lambda: clock[0]
    proxy.set_tenant_quota("acme", records_per_s=10, burst_records=10)
    s = pkg.session.connect(proxy).subscribe(pkg.session.Subscription(
        group="g", tenant=acme, auto_commit=False))
    feed(pkg, log, b"acme.q", 10)
    proxy.pump()
    trace = []
    _, seen = drain_scoped(None, s, rounds=2, trace=trace)
    assert len(seen) == 10
    acct = proxy.tenants["acme"]
    assert acct.record_bucket.exhausted
    feed(pkg, log, b"acme.q", 20, base=100)
    proxy.pump()
    proxy.pump()
    assert s.fetch(4096) == []
    assert acct.quota_blocked_pumps > 0 and acct.delivered_records == 10
    clock[0] += 10.0
    proxy.pump()
    _, seen2 = drain_scoped(proxy.pump, s, rounds=5, trace=trace)
    assert len(seen2) == 20 and not (seen & seen2)
    assert acct.delivered_records == 30
    return trace, accounts(proxy), acct.record_bucket.level


def test_quota_parks_and_resumes():
    both(_quota_parks_and_resumes)


def _token_bucket(pkg):
    b = pkg.tenancy.TokenBucket(rate=5, burst=10)
    b.refill(0.0)
    b.charge(25)
    levels = [b.level]
    assert b.exhausted and b.level == -15
    b.refill(2.0)
    assert b.exhausted
    b.refill(4.0)
    assert not b.exhausted
    levels.append(b.level)
    b.refill(100.0)
    assert b.level == 10
    return levels + [b.level]


def test_token_bucket_refill_and_debt():
    both(_token_bucket)


# ---------------------------------------------------------- origin tagging
def _origin_trailer(pkg):
    RB = pkg.R.RecordBatch
    batch = RB.from_records([rec(pkg, oid=i, jobid=b"acme.x", index=i + 1)
                             for i in range(4)])
    batch.origin = "fs0"
    frame = batch.to_wire2()
    out = RB.from_wire(frame)
    assert out.origin == "fs0" and out.indices() == [1, 2, 3, 4]
    assert RB.from_wire(batch.to_wire()).origin is None
    plain = RB.from_records([rec(pkg, index=1)])
    assert RB.from_wire(plain.to_wire2()).origin is None
    assert batch[1:3].origin == "fs0"
    assert batch.select([0, 2]).origin == "fs0"
    assert RB.concat([batch[:2], batch[2:]]).origin == "fs0"
    other = RB.from_records([rec(pkg, index=9)])
    other.origin = "fs1"
    assert RB.concat([batch, other]).origin is None
    return frame, batch.to_wire()


def test_origin_trailer_wire_roundtrip():
    both(_origin_trailer)


def _global_cursor(pkg):
    c = pkg.federation.GlobalCursor()
    c.advance("fs0", "p0", 5)
    c.advance("fs0", "p0", 3)
    c.advance("fs1", "p0", 2)
    assert c.position("fs0", "p0") == 5
    assert c.position("fs1", "p0") == 2
    assert c.position("fs9", "zz") == 0
    snap = c.snapshot()
    snap["fs0"]["p0"] = 99
    assert c.position("fs0", "p0") == 5
    d = pkg.federation.GlobalCursor(c.snapshot())
    assert d == c
    d.advance("fs0", "p0", 7)
    c.merge(d)
    assert c.position("fs0", "p0") == 7
    return c.snapshot(), repr(c).split("(", 1)[1]


def test_global_cursor():
    both(_global_cursor)


# -------------------------------------------------------------- federation
def mk_fed(pkg):
    logs_a = {p: pkg.llog.Llog(p) for p in ("fs0-p0", "fs0-p1")}
    logs_b = {p: pkg.llog.Llog(p) for p in ("fs1-p0", "fs1-p1")}
    ca = pkg.cluster.LcapCluster(logs_a, n_shards=2, **pkg.kw)
    cb = pkg.cluster.LcapCluster(logs_b, n_shards=2, **pkg.kw)
    fed = pkg.federation.Federation({"fs0": ca, "fs1": cb})
    return fed, ca, cb, logs_a, logs_b


def _fan_in_exactly_once(pkg):
    fed, ca, cb, logs_a, logs_b = mk_fed(pkg)
    stream = fed.subscribe(pkg.session.Subscription(group="g",
                                                    auto_commit=False))
    for log in logs_a.values():
        feed(pkg, log, b"acme.f", 10)
    for log in logs_b.values():
        feed(pkg, log, b"acme.f", 7, base=500)
    seen, trace = [], []
    for _ in range(100):
        fed.pump()
        got = stream.fetch(4096)
        for origin, pid, batch in got:
            assert batch.origin == origin and pid.startswith(origin)
            seen.extend((origin, pid, i) for i in batch.indices())
            trace.append((origin, pid, batch.to_wire(R.WIRE_V2)))
        stream.commit()
        if not got and len(seen) >= 34:
            break
    assert len(seen) == len(set(seen)) == 34
    snap = stream.cursor.snapshot()
    assert snap["fs0"] == {"fs0-p0": 10, "fs0-p1": 10}
    assert snap["fs1"] == {"fs1-p0": 7, "fs1-p1": 7}
    stream.close()
    fed.close()
    ca.close(), cb.close()
    return trace, snap


def test_federation_fan_in_exactly_once():
    both(_fan_in_exactly_once)


def _per_origin_replay(pkg, root):
    root.mkdir()
    L = pkg.llog.Llog
    logs_a = {"a": L("a", path=str(root / "a"), segment_records=8,
                     history=True)}
    logs_b = {"b": L("b", path=str(root / "b"), segment_records=8,
                     history=True)}
    ca = pkg.cluster.LcapCluster(logs_a, n_shards=2, **pkg.kw)
    cb = pkg.cluster.LcapCluster(logs_b, n_shards=2, **pkg.kw)
    fed = pkg.federation.Federation({"fs0": ca, "fs1": cb})
    S = pkg.session.Subscription
    burn = fed.subscribe(S(group="burn", auto_commit=False))
    feed(pkg, logs_a["a"], b"acme.h", 12)
    feed(pkg, logs_b["b"], b"acme.h", 12)
    drain_scoped(fed.pump, burn)
    assert logs_a["a"].first_index > 1 and logs_b["b"].first_index > 1
    stream = fed.subscribe(S(group="boot", auto_commit=False),
                           replay={"fs0": True})
    feed(pkg, logs_b["b"], b"acme.h", 3, base=600)
    per_origin, trace = {}, []
    for _ in range(200):
        fed.pump()
        got = 0
        for origin, pid, batch in stream.fetch(4096):
            per_origin.setdefault(origin, set()).update(batch.indices())
            trace.append((origin, pid, batch.to_wire(R.WIRE_V2)))
            got += len(batch)
        stream.commit()
        if not got and not stream.replaying \
                and len(per_origin.get("fs1", ())) >= 3:
            break
    assert len(per_origin["fs0"]) == 12 and stream.replayed == 12
    assert len(per_origin["fs1"]) == 3
    snap = stream.cursor.snapshot()
    stream.close(), fed.close(), ca.close(), cb.close()
    return trace, snap


def test_federation_per_origin_replay(tmp_path):
    ref = _per_origin_replay(REF, tmp_path / "ref")
    assert _per_origin_replay(PORT, tmp_path / "port") == ref


def _durable_resume(pkg):
    acme, evil = principals(pkg)
    S = pkg.session.Subscription
    fed, ca, cb, logs_a, logs_b = mk_fed(pkg)
    with pytest.raises(pkg.errors.UnknownConsumerError):
        fed.resume("g", "nobody")
    s = fed.subscribe(S(group="g", name="aud", tenant=acme,
                        auto_commit=False))
    feed(pkg, logs_a["fs0-p0"], b"acme.r", 6)
    fed.pump()
    trace = [(o, p, b.to_wire(R.WIRE_V2)) for o, p, b in s.fetch(4096)]
    s.commit()
    snap = s.cursor.snapshot()
    s.detach()
    with pytest.raises(pkg.errors.TenantError):
        fed.subscribe(S(group="g", name="aud", tenant=evil), resume=True)
    s2 = fed.resume("g", "aud", auto_commit=False)
    assert s2.resumed
    s2.close(), fed.close(), ca.close(), cb.close()
    return trace, snap


def test_federation_durable_resume():
    both(_durable_resume)


def _isolation_under_churn(pkg, root):
    root.mkdir()
    acme, _evil = principals(pkg)
    S = pkg.session.Subscription
    L = pkg.llog.Llog
    logs_a = {"a0": L("a0", path=str(root / "a0"), segment_records=8,
                      history=True)}
    logs_b = {"b0": L("b0", path=str(root / "b0"), segment_records=8,
                      history=True)}
    ca = pkg.cluster.LcapCluster(logs_a, n_shards=2, **pkg.kw)
    cb = pkg.cluster.LcapCluster(logs_b, n_shards=3, **pkg.kw)
    fed = pkg.federation.Federation({"fs0": ca, "fs1": cb})
    burn = fed.subscribe(S(group="burn", auto_commit=False))
    for i in range(20):
        feed(pkg, logs_a["a0"], b"acme.hist" if i % 2 else b"evil.hist", 1,
             base=i)
        feed(pkg, logs_b["b0"], b"acme.hist" if i % 3 else b"evil.hist", 1,
             base=i)
    drain_scoped(fed.pump, burn)
    assert logs_a["a0"].first_index > 1
    stream = fed.subscribe(S(group="sec", tenant=acme, auto_commit=False),
                           replay=True)
    jobids, seen, trace = set(), set(), []

    def poll(rounds=3):
        for _ in range(rounds):
            fed.pump()
            for origin, pid, batch in stream.fetch(4096):
                trace.append((origin, pid, batch.to_wire(R.WIRE_V2)))
                for i in range(len(batch)):
                    r = batch.record(i)
                    jobids.add(bytes(r.jobid or b""))
                    seen.add((origin, pid, r.index))
            stream.commit()
            burn.fetch(4096)
            burn.commit()

    poll(10)
    feed(pkg, logs_a["a0"], b"acme.live", 10, base=1000)
    feed(pkg, logs_b["b0"], b"evil.live", 10, base=1000)
    poll(2)
    ca.migrate_slots(range(0, ca.n_slots // 2), 1)
    feed(pkg, logs_a["a0"], b"acme.live", 10, base=2000)
    poll(4)
    cb.kill_shard(0)
    feed(pkg, logs_b["b0"], b"acme.live", 10, base=2000)
    poll(30)
    assert jobids and jobids <= {b"acme.hist", b"acme.live"}
    assert len({x for x in seen if x[0] == "fs0" and x[2] > 20}) == 20
    assert len({x for x in seen if x[0] == "fs1" and x[2] > 20}) == 10
    assert stream.replayed > 0
    snap = stream.cursor.snapshot()
    stream.close(), fed.close(), ca.close(), cb.close()
    return trace, snap, sorted(seen)


def test_isolation_invariant_under_topology_churn(tmp_path):
    ref = _isolation_under_churn(REF, tmp_path / "ref")
    assert _isolation_under_churn(PORT, tmp_path / "port") == ref


# ----------------------------------------------------------- observability
def _tenant_accounts_and_merge(pkg):
    acme, _evil = principals(pkg)
    S = pkg.session.Subscription
    log = pkg.llog.Llog("m")
    proxy = pkg.proxy.LcapProxy({"m": log})
    proxy.set_tenant_quota("acme", records_per_s=1000)
    pkg.session.connect(proxy).subscribe(S(group="g", tenant=acme,
                                           auto_commit=False))
    feed(pkg, log, b"acme.m", 5)
    feed(pkg, log, b"evil.m", 2, base=50)
    proxy.pump()
    assert proxy.tenants["acme"].delivered_records == 5
    assert proxy.stats["tenant_filtered"] == 2
    fed, ca, cb, logs_a, logs_b = mk_fed(pkg)
    for c in (ca, cb):
        for i, shard in enumerate(c.shards):
            shard.proxy.attach_registry(pkg.obs.MetricsRegistry(),
                                        {"shard": str(i)})
    fed.set_tenant_quota("acme", records_per_s=1e9)
    s = fed.subscribe(S(group="g", tenant=acme, auto_commit=False))
    feed(pkg, logs_a["fs0-p0"], b"acme.z", 4)
    fed.pump()
    trace = [(o, p, b.to_wire(R.WIRE_V2)) for o, p, b in s.fetch(4096)]
    s.commit()
    delivered = sum(sh.proxy.tenants["acme"].delivered_records
                    for c in (ca, cb) for sh in c.shards)
    assert delivered == 4
    merged = fed.metrics()
    gauges = merged["lcap_buffered_records"]["samples"]
    assert {lbl.get("origin") for lbl, _v in gauges} >= {"fs0", "fs1"}
    deliv = merged["lcap_tenant_delivered_records_total"]["samples"]
    assert sum(v for _lbl, v in deliv) == 4
    out = (trace, accounts(proxy), fed.stats(), s.cursor.snapshot(),
           smoke.activity_counters(merged, pkg.obs.render_prometheus))
    s.close(), fed.close(), ca.close(), cb.close()
    return out


def test_tenant_metrics_and_federation_merge():
    both(_tenant_accounts_and_merge)


def _stats_and_audit(pkg):
    acme, _evil = principals(pkg)
    fed, ca, cb, logs_a, logs_b = mk_fed(pkg)
    audit = pkg.track.AuditTrail(fed, group="audit", tenant=acme)
    # the tenant-scoped frames themselves, to a second group
    frames = fed.subscribe(pkg.session.Subscription(group="frames",
                                                    tenant=acme))
    feed(pkg, logs_a["fs0-p0"], b"acme.1000", 6)
    feed(pkg, logs_b["fs1-p0"], b"acme.1000", 2)
    feed(pkg, logs_b["fs1-p1"], b"evil.666", 5, base=300)
    by_origin, trace = {}, []
    for _ in range(30):
        fed.pump()
        audit.poll()
        for origin, pid, batch in frames.fetch(4096):
            trace.append((origin, pid, batch.to_wire(R.WIRE_V2)))
            for i in range(len(batch)):
                job = bytes(batch.record(i).jobid).decode()
                key = (job, origin)
                by_origin[key] = by_origin.get(key, 0) + 1
        frames.commit()
    assert by_origin == {("acme.1000", "fs0"): 6, ("acme.1000", "fs1"): 2}
    rep = audit.report()
    assert rep["tenant"] == "acme"
    assert set(rep["jobs"]) == {"acme.1000"}
    assert rep["jobs"]["acme.1000"]["by_origin"] == {"fs0": 6, "fs1": 2}
    assert rep["users"] == {"1000": 8}
    assert rep["unattributed"] == 0
    st = fed.stats()
    assert set(st["per_origin"]) == {"fs0", "fs1"}
    assert st["tenant_filtered"] == 2 * 5     # evil's 5, in each group
    lag = fed.lag()
    assert set(lag) == {"fs0", "fs1"}
    top = [(t.jobid, t.user, t.records) for t in audit.top()]
    frames.close(), audit.close(), fed.close(), ca.close(), cb.close()
    return trace, rep, top, st, lag


def test_federation_stats_and_audit_report():
    both(_stats_and_audit)


# --------------------------------------- the port's routing device, memoized
def test_routing_device_resolved_once_per_device():
    """The port's counterpart of the reference's memoized JAX probe: one
    ``SlotRouter`` (and its staging buffers) per device serves every
    module-level ``batch_slots`` call, and it hashes as the reference's
    numpy ``fid_slots`` does."""
    batch = T.RecordBatch.from_records([rec(PORT, oid=i, index=i + 1)
                                        for i in range(50)])
    first = port_cluster.batch_slots(batch, 64, "cpu")
    router = port_cluster._routers[port_cluster._resolve_device("cpu")]
    again = port_cluster.batch_slots(batch, 64, "cpu")
    assert port_cluster._routers[port_cluster._resolve_device("cpu")] \
        is router
    ref_batch = R.RecordBatch.from_records([rec(REF, oid=i, index=i + 1)
                                            for i in range(50)])
    want = ref_cluster.fid_slots(*ref_batch.tfid_cols(), 64)
    assert np.array_equal(first, want) and np.array_equal(again, want)


# ------------------------------------------------------------ wire members
def _wire_member(pkg, member):
    """A federation of an in-process cluster and a wire member (``pkg``'s
    ``LcapService`` over ``member``'s proxy, by address)."""
    fed_logs = {"fs0-p0": pkg.llog.Llog("fs0-p0")}
    ca = pkg.cluster.LcapCluster(fed_logs, n_shards=2, **pkg.kw)
    log_b = member.llog.Llog("fs1-p0")
    svc = member.server.LcapService(member.proxy.LcapProxy({"fs1-p0": log_b}),
                                    poll_interval=0.001).start()
    try:
        fed = pkg.federation.Federation({"fs0": ca, "fs1": svc.address})
        try:
            stream = fed.subscribe(pkg.session.Subscription(
                group="g", auto_commit=False))
            feed(pkg, fed_logs["fs0-p0"], b"acme.f", 10)
            feed(member, log_b, b"acme.f", 7, base=500)
            seen = set()
            deadline = time.monotonic() + DEADLINE_S
            while len(seen) < 17 and time.monotonic() < deadline:
                fed.pump()
                for origin, pid, batch in stream.fetch(4096):
                    assert batch.origin == origin
                    seen.update((origin, pid, i, bytes(b))
                                for i, b in zip(batch.indices(), batch))
                stream.commit()
                time.sleep(0.002)
            assert len(seen) == 17
            snap = stream.cursor.snapshot()
            assert snap == {"fs0": {"fs0-p0": 10}, "fs1": {"fs1-p0": 7}}
            stream.close()
            return sorted(seen), snap
        finally:
            fed.close()
            ca.close()
    finally:
        svc.stop()


@pytest.mark.parametrize("fed_pkg,member", [(PORT, PORT), (PORT, REF),
                                            (REF, PORT)],
                         ids=["port-port", "port-ref", "ref-port"])
def test_federation_with_a_wire_member(fed_pkg, member):
    assert _wire_member(fed_pkg, member) == _wire_member(REF, REF)
