"""Port parity, the slice as a whole: the same journals through a
reference ``LcapCluster`` and a port ``LcapCluster`` (routing on the
CPU with the kernel's plain version) deliver the same records, from
the same shards, to the same consumers, in the same order — through a
shard kill, live slot migration, a shard split and a replay bootstrap
from the history tier.  Stats, lag, routing tables and journal
watermarks must match exactly too.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core.cluster as ref_cluster                   # noqa: E402
import repro.core.llog as ref_llog                         # noqa: E402
import repro.core.proxy as ref_proxy                       # noqa: E402
import repro.core.session as ref_session                   # noqa: E402
import repro.core.tenancy as ref_tenancy                   # noqa: E402
import repro.obs as ref_obs                                # noqa: E402
from repro.core import records as R                       # noqa: E402
import repro_torch.core.cluster as port_cluster            # noqa: E402
import repro_torch.core.llog as port_llog                  # noqa: E402
import repro_torch.core.proxy as port_proxy                # noqa: E402
import repro_torch.core.session as port_session            # noqa: E402
import repro_torch.core.tenancy as port_tenancy            # noqa: E402
import repro_torch.obs as port_obs                         # noqa: E402
from repro_torch.core import records as T                 # noqa: E402

#: ``chip_smoke.py`` as a module: its ``activity_counters`` is the one
#: normalisation of merged snapshots, shared with the card's phase 7
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

REF = SimpleNamespace(R=R, cluster=ref_cluster, proxy=ref_proxy,
                      session=ref_session, tenancy=ref_tenancy, obs=ref_obs,
                      kw={})
PORT = SimpleNamespace(R=T, cluster=port_cluster, proxy=port_proxy,
                       session=port_session, tenancy=port_tenancy,
                       obs=port_obs, kw={"device": "cpu"})

MIX = ((R.CL_CREATE, 30), (R.CL_SETATTR, 25), (R.CL_CLOSE, 15),
       (R.CL_UNLINK, 15), (R.CL_MKDIR, 5), (R.CL_RMDIR, 5), (R.CL_RENAME, 5))
AUDIT_TYPES = frozenset({R.CL_CREATE, R.CL_UNLINK, R.CL_RENAME, R.CL_RMDIR})
N_EACH = 3000


def packed_journal(m: int, n: int, seed: int) -> list:
    """``n`` packed records of MDT ``m``: the operation mix, a jobid on
    every record, dense reused target oids (cr_prev chains)."""
    rng = np.random.default_rng(seed * 1000 + m)
    types = np.repeat([t for t, _ in MIX], [w for _, w in MIX])
    log = ref_llog.Llog(f"mdt{m}")
    log.register_reader("feeder")
    recs = []
    for i in range(n):
        rtype = int(types[rng.integers(0, len(types))])
        job = int(rng.integers(0, 64))
        rec = R.ChangelogRecord(
            type=rtype, time=10**18 + i,
            tfid=R.Fid(0x200000400 + m, int(rng.integers(1, 700)), 0),
            pfid=R.Fid(0x200000400 + m, 1, 0), name=b"f%d" % i,
            jobid=b"%s.%d" % ((b"dd", b"cp")[job % 2], 500 + job))
        if rtype == R.CL_RENAME:
            rec.sfid, rec.spfid, rec.sname = (R.Fid(0x200000400 + m, i, 0),
                                              R.Fid(0x200000400 + m, 1, 0),
                                              b"old%d" % i)
        recs.append(rec)
    log.log_batch(recs)
    return list(log.read(1, n))


@pytest.fixture(scope="module")
def packed():
    return {f"mdt{m}": packed_journal(m, N_EACH, seed=2) for m in range(4)}


def make_journals(pkg, packed: dict, history: bool) -> dict:
    history = True if history else None      # Llog's own convention
    logs = {}
    for pid, bufs in packed.items():
        if pkg is PORT:
            blob, off, ln = T.RecordBatch.from_packed(bufs)._compact()
            logs[pid] = port_llog.from_packed(pid, blob, off, ln,
                                              first_index=1, history=history)
        else:
            log = ref_llog.Llog(pid, history=history)
            log.register_reader("feeder")
            log.log_batch([R.unpack(b) for b in bufs])
            log.deregister_reader("feeder")
            logs[pid] = log
    return logs


def subscriptions(pkg) -> list:
    S = pkg.session.Subscription
    acme = pkg.tenancy.TenantPrincipal("acme", prefixes=(b"dd.",))
    return [("robinhood", S(group="robinhood", auto_commit=False)),
            ("robinhood", S(group="robinhood", auto_commit=False)),
            ("audit", S(group="audit", types=AUDIT_TYPES, flags=R.CLF_JOBID,
                        auto_commit=False, max_records=300)),
            ("acme", S(group="acme", tenant=acme, auto_commit=False)),
            ("reader", S(mode=pkg.proxy.EPHEMERAL, auto_commit=False))]


def shard_of_child(stream, batch) -> int:
    child = stream._sources[id(batch)]
    return next(i for i, s in stream._children if s is child)


def drain(cluster, logs, streams, trace, events=None, rounds=400):
    for rnd in range(rounds):
        if events and rnd in events:
            events[rnd](cluster)
        moved = cluster.pump()
        for k, (group, stream) in enumerate(streams):
            got = stream.fetch(900)
            for pid, batch in got:
                trace.append((group, k, shard_of_child(stream, batch), pid,
                              tuple(batch.indices()),
                              batch.to_wire(R.WIRE_V2)))
                moved += len(batch)
            stream.commit()
        if (not events or rnd > max(events)) and not moved \
                and cluster._migration is None and all(
                    log.first_index == log.last_index + 1
                    for log in logs.values()):
            return


def snapshot(cluster, logs, trace) -> dict:
    return {"trace": trace, "stats": dict(cluster.stats),
            "shard_stats": [dict(s.proxy.stats) for s in cluster.shards],
            "alive": list(cluster.alive),
            "routing": (cluster.routing.epoch, cluster.slot_owner),
            "lag": cluster.lag(),
            "journals": {pid: (log.first_index, log.last_index)
                         for pid, log in logs.items()},
            "journal_acked": dict(cluster.journal_acked),
            "shard_acked": [dict(a) for a in cluster.shard_acked]}


def run_failover(pkg, packed) -> dict:
    logs = make_journals(pkg, packed, history=False)
    cluster = pkg.cluster.LcapCluster(logs, n_shards=4, n_slots=64,
                                      batch_size=256, **pkg.kw)
    sess = pkg.session.connect(cluster)
    streams = [(g, sess.subscribe(spec)) for g, spec in subscriptions(pkg)]
    trace = []
    # the first round routes everything; shard 1 dies with its share
    # delivered but only partly acknowledged
    drain(cluster, logs, streams, trace,
          events={1: lambda c: c.kill_shard(1, reason="test")})
    return snapshot(cluster, logs, trace)


def run_elastic(pkg, packed) -> dict:
    logs = make_journals(pkg, packed, history=True)
    cluster = pkg.cluster.LcapCluster(logs, n_shards=3, n_slots=64,
                                      batch_size=256, **pkg.kw)
    sess = pkg.session.connect(cluster)
    streams = [(g, sess.subscribe(spec)) for g, spec in subscriptions(pkg)
               if g != "reader"]
    trace = []
    drain(cluster, logs, streams, trace, events={
        0: lambda c: c.migrate_slots(c.routing.slots_of(0)[:8], 1),
        3: lambda c: c.split_shard(),
    })
    # a late group bootstraps from the history tier, shard by shard
    late = sess.subscribe(pkg.session.Subscription(
        group="late", replay=True, auto_commit=False))
    drain(cluster, logs, [("late", late)], trace)
    return snapshot(cluster, logs, trace)


@pytest.fixture(scope="module")
def failover(packed):
    return run_failover(REF, packed), run_failover(PORT, packed)


@pytest.fixture(scope="module")
def elastic(packed):
    return run_elastic(REF, packed), run_elastic(PORT, packed)


KEYS = ["stats", "shard_stats", "alive", "routing", "lag", "journals",
        "journal_acked", "shard_acked"]


@pytest.mark.parametrize("scenario", ["failover", "elastic"])
def test_cluster_delivers_the_same_per_shard_sequence(scenario, request):
    ref, port = request.getfixturevalue(scenario)
    assert len(port["trace"]) == len(ref["trace"])
    for a, b in zip(port["trace"], ref["trace"]):
        assert a == b


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("scenario", ["failover", "elastic"])
def test_cluster_state_matches(scenario, key, request):
    ref, port = request.getfixturevalue(scenario)
    assert port[key] == ref[key]


def test_failover_run_is_not_degenerate(failover, packed):
    """Every group saw every (pid, index) of its types at least once
    (at-least-once through the kill), the kill redelivered, and every
    journal trimmed."""
    _ref, port = failover
    by_group = {}
    for group, _k, _shard, pid, indices, _w in port["trace"]:
        by_group.setdefault(group, set()).update((pid, i) for i in indices)
    every = {(pid, i) for pid in packed for i in range(1, N_EACH + 1)}
    assert by_group["robinhood"] == every
    assert by_group["reader"] == every
    audit = {(pid, i + 1) for pid, bufs in packed.items()
             for i, b in enumerate(bufs) if R.packed_type(b) in AUDIT_TYPES}
    assert by_group["audit"] == audit
    assert 0 < len(by_group["acme"]) < len(every)
    assert port["stats"]["shards_failed"] == 1
    assert port["stats"]["failover_redelivered"] > 0
    assert port["alive"] == [True, False, True, True]
    assert all(first == last + 1
               for first, last in port["journals"].values())


def test_elastic_run_is_not_degenerate(elastic, packed):
    _ref, port = elastic
    assert port["stats"]["migrations_completed"] == 2
    assert port["stats"]["shards_added"] == 1
    late = {(pid, i) for g, _k, _s, pid, ix, _w in port["trace"]
            if g == "late" for i in ix}
    assert late                              # the bootstrap replayed


def test_port_routes_every_record_to_the_slot_owner(packed):
    """Without topology changes, every record a shard delivers hashes
    (plain version, on the CPU) to a slot that shard owns, and each
    non-empty journal read was one routing call."""
    logs = make_journals(PORT, {k: v[:1000] for k, v in packed.items()},
                         history=False)
    cluster = port_cluster.LcapCluster(logs, n_shards=4, n_slots=64,
                                       batch_size=256, device="cpu")
    stream = port_session.connect(cluster).subscribe("g", auto_commit=False)
    trace = []
    drain(cluster, logs, [("g", stream)], trace)
    owner = cluster.routing.owner_array()
    for _g, _k, shard, _pid, _ix, wire in trace:
        batch = T.RecordBatch.from_wire(wire)
        assert (owner[port_cluster.batch_slots(batch, 64, "cpu")]
                == shard).all()
    assert sum(len(t[4]) for t in trace) == 4000
    assert cluster.routing_reads == 4 * -(-1000 // 256)


def test_routing_launches_count_the_chunks_of_a_round(packed, monkeypatch):
    """Without a migration a routing round hashes all its reads together
    in chunks of ``CHUNK_ROWS`` rows (patched down to 300, so chunks
    split batches): ceil(rows / cap) launches a round.  While a migration
    is in flight each read is hashed as it is read: one launch a read."""
    cap = 300
    monkeypatch.setattr(port_cluster, "CHUNK_ROWS", cap)
    logs = make_journals(PORT, {k: v[:1000] for k, v in packed.items()},
                         history=False)
    cluster = port_cluster.LcapCluster({}, n_shards=3, n_slots=64,
                                       batch_size=256, device="cpu")
    port_session.connect(cluster).subscribe("g", auto_commit=False)

    def round_counts() -> tuple:
        before = (cluster.routing_launches, cluster.routing_reads,
                  cluster.stats["routed"])
        cluster.pump()
        return tuple(a - b for a, b in zip(
            (cluster.routing_launches, cluster.routing_reads,
             cluster.stats["routed"]), before))

    pids = list(logs)
    cluster.add_producer(pids[0], logs[pids[0]])
    assert round_counts() == (-(-1000 // cap), -(-1000 // 256), 1000)
    for pid in pids[1:]:
        cluster.add_producer(pid, logs[pid])
    assert round_counts() == (-(-3000 // cap), 3 * -(-1000 // 256), 3000)
    assert round_counts() == (0, 0, 0)
    # the shards hold unconsumed records, so the migration stays in flight
    cluster.migrate_slots(cluster.routing.slots_of(0)[:8], 1)
    assert cluster._migration is not None
    for pid, log in logs.items():
        log.log_batch([T.unpack(b) for b in packed[pid][1000:1600]])
    launches, reads, routed = round_counts()
    assert routed == 2400 and launches == reads == 4 * -(-600 // 256)
    assert cluster.stats["parked_records"] > 0


def run_cancel(pkg, packed) -> dict:
    """The migration's target dies while the migration parks records:
    the cancel hands the parked records back to their owners
    (``_reoffer_parked_locked``, which hashes them in one round)."""
    logs = make_journals(pkg, {k: v[:1000] for k, v in packed.items()},
                         history=False)
    cluster = pkg.cluster.LcapCluster(logs, n_shards=3, n_slots=64,
                                      batch_size=256, **pkg.kw)
    sess = pkg.session.connect(cluster)
    streams = [(g, sess.subscribe(spec)) for g, spec in subscriptions(pkg)
               if g != "reader"]
    cluster.pump()                       # routed, nothing consumed yet
    # two sources, so that the parked rows go back to two owners
    cluster.migrate_slots(cluster.routing.slots_of(0)[:8]
                          + cluster.routing.slots_of(2)[:8], 1)
    for pid, log in logs.items():
        log.log_batch([pkg.R.unpack(b) for b in packed[pid][1000:2000]])
    cluster._route()                     # parks the draining slots' rows
    parked = len(cluster._parked)
    cluster.kill_shard(1)                # the migration's target dies
    trace = []
    drain(cluster, logs, streams, trace)
    return dict(snapshot(cluster, logs, trace), parked=parked)


def test_cancelled_migration_hands_back_the_parked_records(packed):
    ref, port = run_cancel(REF, packed), run_cancel(PORT, packed)
    assert port["parked"] > 0
    assert port["stats"]["migrations_cancelled"] == 1
    assert port == ref
    every = {(pid, i) for pid in packed for i in range(1, 2001)}
    assert {(pid, i) for g, _k, _s, pid, ix, _w in port["trace"]
            if g == "robinhood" for i in ix} == every


def merged_metrics(pkg, packed) -> tuple:
    """One run with a registry attached: the cluster's merged snapshot
    and the cluster session's merge over the shards, each as
    ``chip_smoke.activity_counters`` gives it (counters as the
    package's Prometheus text; help, labels and bucket bounds of the
    rest, whose values can hold wall time)."""
    logs = make_journals(pkg, {k: v[:600] for k, v in packed.items()},
                         history=False)
    cluster = pkg.cluster.LcapCluster(logs, n_shards=3, n_slots=64,
                                      batch_size=128, **pkg.kw)
    empty = (cluster.metrics(), pkg.session.connect(cluster).metrics())
    cluster.attach_registry(pkg.obs.MetricsRegistry())
    session = pkg.session.connect(cluster)
    streams = [(g, session.subscribe(spec)) for g, spec in
               subscriptions(pkg)]
    drain(cluster, logs, streams, [], events={3: lambda c: c.kill_shard(1)})
    out = [empty] + [smoke.activity_counters(snap, pkg.obs.render_prometheus)
                     for snap in (cluster.metrics(), session.metrics())]
    session.close()
    return out


def test_port_refuses_what_this_slice_leaves_out(packed):
    """The merged metrics, once left out of the port, now equal the
    reference's on the same run: empty before a registry is attached,
    then counters and gauge labels through a shard kill."""
    ref = merged_metrics(REF, packed)
    assert merged_metrics(PORT, packed) == ref
    assert ref[0] == ({}, {})
    assert "lcap_cluster_routed_total" in ref[1][0]
    assert ("shard", "2") in ref[1][1]["lcap_shard_alive"][2][2]
    # wire targets where nothing listens fail as the reference's do
    for target in (("127.0.0.1", 1), "127.0.0.1:1", [("127.0.0.1", 1)]):
        with pytest.raises(OSError) as ref_exc:
            ref_session.connect(target)
        with pytest.raises(OSError) as port_exc:
            port_session.connect(target)
        assert type(port_exc.value) is type(ref_exc.value)


def test_buffered_records_hold_a_shard_watermark():
    """A push-fed shard must not report records it has buffered but not
    dispatched as acknowledged.  One routing round offers shard 1 a
    batch (buffered) and then a batch with none of its records (a bare
    watermark advance); the watermark read before any dispatch must stay
    below the buffered records, so when shard 1 dies its backlog is
    re-offered and nothing is lost."""
    n_slots, per = 64, 32
    owner = [s % 2 for s in range(n_slots)]       # LcapCluster's initial map
    to_shard0 = [oid for oid in range(1, 10_000)
                 if owner[port_cluster.fid_slot((0x200000400, oid, 0),
                                                n_slots)] == 0][:per]
    recs = [R.ChangelogRecord(type=R.CL_CREATE, time=10**18 + i,
                              tfid=R.Fid(0x200000400, oid, 0),
                              pfid=R.Fid(0x200000400, 1, 0), name=b"f%d" % i)
            for i, oid in enumerate(list(range(1, per + 1)) + to_shard0)]
    feeder = ref_llog.Llog("m0")
    feeder.register_reader("feeder")
    feeder.log_batch(recs)
    logs = make_journals(PORT, {"m0": list(feeder.read(1, 2 * per))},
                         history=False)
    cluster = port_cluster.LcapCluster(logs, n_shards=2, n_slots=n_slots,
                                       batch_size=per, device="cpu")
    assert cluster.slot_owner == owner
    stream = port_session.connect(cluster).subscribe(
        port_session.Subscription(group="g", auto_commit=False))
    cluster.pump(pump_shards=False)               # route and offer only
    shard1 = cluster.shards[1].proxy
    buffered = [int(i) for pid, b in shard1._buffer for i in b.indices()]
    assert buffered and max(buffered) <= per
    assert cluster.shards[1].watermarks().get("m0", 0) < min(buffered)
    cluster.kill_shard(1)
    got = []
    for _ in range(50):
        cluster.pump()
        for pid, batch in stream.fetch(1000):
            got.extend((pid, int(i)) for i in batch.indices())
        stream.commit()
        if logs["m0"].first_index == logs["m0"].last_index + 1:
            break
    assert sorted(set(got)) == [("m0", i) for i in range(1, 2 * per + 1)]
