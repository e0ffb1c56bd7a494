"""Phase 7a of ``chip_smoke.py`` on the CPU, at a small size: the paper's
elastic operations through the port and through the reference.

The elastic scenario (part (c): slot migrations under backpressure, a
shard split, a migration cancelled by its source's death, a replay
bootstrap from the history tier) and the two-filesystem federation
(part (d): a detach and resume, a graceful migration in one member, a
kill in the other) are run by the phase's own builders on both
packages, routing on the CPU with the kernel's plain version; every
delivery, byte for byte, and the clusters' state must be equal.  The
phase's delivery checks must accept those runs and reject one with a
record dropped, or duplicated where the path is graceful.  The repairs
the phase called for are held here too: a routing round reads the
backlog present when it starts (a producer appending meanwhile cannot
stretch it), a topology change asked for from another thread gets the
coordinator lock between two rounds of a busy routing loop, the router
counts the reads it hashes under its lock, and part (a)'s churn storm
parks records for its first migration whatever the threads' timing.
"""

import importlib.util
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core.cluster as ref_cluster                   # noqa: E402
import repro.core.federation as ref_federation             # noqa: E402
import repro.core.llog as ref_llog                         # noqa: E402
import repro.core.session as ref_session                   # noqa: E402
from repro.core import records as R                       # noqa: E402
import repro_torch.core.cluster as port_cluster            # noqa: E402
from repro_torch.core import records as T                 # noqa: E402
from repro_torch.core.llog import Llog                    # noqa: E402
from repro_torch.core.session import Subscription, connect  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

REF = SimpleNamespace(R=R, cluster=ref_cluster, llog=ref_llog,
                      session=ref_session, federation=ref_federation, kw={})
PORT = smoke.port_modules()
PORT.kw = {"device": "cpu"}

#: records per MDT journal, and (c)'s parking bound and batch size: a
#: quarter of a journal, as the phase's 16,384 of 65,536
N = 2048
PARK_CAP = 512
BATCH = 256


@pytest.fixture(scope="module")
def journals():
    return {f"mdt{m}": smoke.make_journal_arrays(m, N, 3) for m in range(4)}


def records(pkg, journals):
    return {pid: smoke.journal_records(pkg.R, j, 0, N)
            for pid, j in journals.items()}


@pytest.fixture(scope="module")
def elastic(journals):
    return tuple(smoke.run_elastic(pkg, records(pkg, journals), PARK_CAP,
                                   BATCH) for pkg in (REF, PORT))


@pytest.fixture(scope="module")
def federation(journals):
    return tuple(smoke.run_federation(pkg, records(pkg, journals))
                 for pkg in (REF, PORT))


@pytest.mark.parametrize("key", ["trace", "stats", "routing",
                                 "journal_acked", "alive", "facts"])
def test_elastic_scenario_matches_the_reference(elastic, key):
    """Every shard's delivered sequence (wire-v2 bytes), the stats, the
    epoch and slot owners, the journal acks, the live shards and the
    scenario's own facts (parking, the kill, the replay) are equal."""
    ref, port = elastic
    assert port[key] == ref[key]


def test_elastic_scenario_reaches_every_call_site(elastic, journals):
    """The port's run passes the phase's checks: backpressure engaged,
    a migration cancelled with records parked, every record delivered,
    and each elastic routing call site hashed at least one chunk."""
    _ref, port = elastic
    facts = smoke.verify_elastic(port, journals, PARK_CAP)
    chunks = port["sites"]["chunks"]
    assert all(chunks[site] > 0 for site in ("migration", "redeliver",
                                              "reoffer", "replay"))
    assert port["routing_launches"] == sum(chunks.values())
    assert facts["late_records"] > 0
    assert port["stats"]["parked_records"] > PARK_CAP


def deliveries_as_lists(run):
    return [(key, idx.tolist()) for key, idx in run["deliveries"]]


@pytest.mark.parametrize("key", ["deliveries", "cursor", "last", "stats",
                                 "routing", "lost", "victim"])
def test_federation_matches_the_reference(federation, key):
    ref, port = federation
    if key == "deliveries":
        assert deliveries_as_lists(port) == deliveries_as_lists(ref)
    else:
        assert port[key] == ref[key]


def test_delivery_checks_accept_clean_runs(elastic, federation, journals):
    smoke.verify_elastic(elastic[1], journals, PARK_CAP)
    out = smoke.verify_federation(federation[1])
    assert out["duplicates"]["fs0"] == 0
    assert out["records"] == 4 * N


def drop_one(run: dict, origin: str) -> dict:
    """``run`` with one delivery of a record of ``origin`` that was
    delivered once taken out."""
    counts = smoke.delivery_counts(run["deliveries"], {
        (o, pid): last for o, per in run["last"].items()
        for pid, last in per.items()})
    out = []
    dropped = False
    for key, idx in run["deliveries"]:
        once = counts[key][idx] == 1
        if not dropped and key[0] == origin and once.any():
            idx = np.delete(idx, np.flatnonzero(once)[0])
            dropped = True
        out.append((key, idx))
    assert dropped
    return dict(run, deliveries=out)


def duplicate_one(run: dict, origin: str) -> dict:
    key, idx = next((k, i) for k, i in run["deliveries"] if k[0] == origin)
    return dict(run, deliveries=run["deliveries"] + [(key, idx[:1])])


@pytest.mark.parametrize("origin", ["fs0", "fs1"])
def test_delivery_check_rejects_a_dropped_record(federation, origin):
    with pytest.raises(smoke.SmokeError, match="never delivered"):
        smoke.verify_federation(drop_one(federation[1], origin))


def test_elastic_check_rejects_a_dropped_record(elastic, journals):
    run = elastic[1]
    trace, dropped = [], False
    seen = {}
    for g, _k, _s, pid, wire in run["trace"]:
        for i in T.RecordBatch.from_wire(wire).indices():
            seen[(g, pid, i)] = seen.get((g, pid, i), 0) + 1
    for g, k, shard, pid, wire in run["trace"]:
        batch = T.RecordBatch.from_wire(wire)
        once = [j for j, i in enumerate(batch.indices())
                if seen[(g, pid, i)] == 1]
        if not dropped and g == "robinhood" and once:
            keep = np.delete(np.arange(len(batch)), once[0])
            wire = batch.select(keep).to_wire(T.WIRE_V2)
            dropped = True
        trace.append((g, k, shard, pid, wire))
    assert dropped
    with pytest.raises(smoke.SmokeError, match="never delivered"):
        smoke.verify_elastic(dict(run, trace=trace), journals, PARK_CAP)


def test_delivery_check_rejects_a_duplicate_on_a_graceful_path(federation):
    """A record twice is a fault on fs0 (a graceful migration) and the
    contract on fs1 (a kill: at-least-once)."""
    with pytest.raises(smoke.SmokeError, match="more than once"):
        smoke.verify_federation(duplicate_one(federation[1], "fs0"))
    out = smoke.verify_federation(duplicate_one(federation[1], "fs1"))
    assert out["duplicates"]["fs1"] >= 1
    counts = {"m": np.array([0, 1, 2, 1])}
    with pytest.raises(smoke.SmokeError, match="more than once"):
        smoke.check_delivered("graceful", counts, exactly_once=True)
    assert smoke.check_delivered("forced", counts, exactly_once=False) == 1


# ------------------------------------------------------------- repairs
class GrowingLog:
    """A journal a producer keeps appending to while the coordinator
    reads it: each read appends ``per_read`` more records (the next of
    ``pending``) before it answers."""

    def __init__(self, log, pending, per_read):
        self._log, self._pending, self._per_read = log, pending, per_read

    def read(self, start, max_records=1024):
        if self._pending:
            self._log.log_batch(self._pending[:self._per_read])
            del self._pending[:self._per_read]
        return self._log.read(start, max_records)

    def __getattr__(self, name):
        return getattr(self._log, name)


@pytest.mark.parametrize("migrating", [False, True])
def test_a_round_routes_the_backlog_present_when_it_starts(journals,
                                                           migrating):
    """A producer that appends while a round reads cannot stretch the
    round: it routes the records present when it reached the journal,
    the rest wait for the next round.  (The reference's round reads
    until a short batch, so a producer that keeps up holds its offers
    back for as long as it keeps writing.)"""
    recs = smoke.journal_records(T, journals["mdt0"], 0, N)
    log = Llog("mdt0")
    cluster = port_cluster.LcapCluster({}, n_shards=2, n_slots=64,
                                       batch_size=BATCH, device="cpu")
    stream = connect(cluster).subscribe(Subscription(group="g",
                                                     auto_commit=False))
    cluster.add_producer("mdt0", log)
    log.log_batch(recs[:BATCH])
    if migrating:
        cluster.pump()                      # routed, not consumed
        cluster.migrate_slots(cluster.routing.slots_of(0)[:8], 1)
        assert cluster._migration is not None
        log.log_batch(recs[BATCH:2 * BATCH])
    start = log.last_index
    cluster.journals["mdt0"] = GrowingLog(log, recs[log.last_index:],
                                          BATCH)
    before = cluster.stats["routed"]
    cluster.pump()
    assert cluster.stats["routed"] - before == start - (BATCH if migrating
                                                        else 0)
    assert cluster.cursors["mdt0"] == start + 1
    assert log.last_index > start           # the producer went on
    cluster.journals["mdt0"] = log
    log.log_batch(recs[log.last_index:])
    seen = set()
    for _ in range(200):
        moved = cluster.pump()
        for _pid, batch in stream.fetch(4096):
            seen.update(batch.indices())
            moved += len(batch)
        stream.commit()
        if not moved and smoke.idle(cluster):
            break
    assert seen == set(range(1, N + 1))


def test_a_topology_change_is_not_starved_by_a_busy_routing_loop(journals):
    """A migration asked for from another thread while the service's
    routing loop is busy with a stream starts before the stream ends
    (it parks records of the stream), and the stream is delivered
    exactly once.  Without ``LcapCluster._change`` the loop took the
    coordinator lock back after every round and the migration waited
    until the producers stopped."""
    n = 16_384
    arrays = {f"mdt{m}": smoke.make_journal_arrays(m, n, 5)
              for m in range(4)}
    recs = {pid: smoke.journal_records(T, a, 0, n)
            for pid, a in arrays.items()}
    logs = {pid: Llog(pid) for pid in recs}
    cluster = port_cluster.LcapCluster(logs, n_shards=4, n_slots=64,
                                       batch_size=1024, device="cpu")
    svc = port_cluster.LcapClusterService(cluster).start()
    session = connect(list(svc.addresses))
    try:
        stream = session.subscribe(Subscription(group="g", name="m",
                                                auto_commit=False))
        consumer = smoke.WireConsumer(stream, {pid: n for pid in logs})
        consumer.start()
        feeder = smoke.Feeder(logs, recs, 0, n)
        feeder.start()
        smoke.wait_for("feed", lambda: feeder.fed >= n // 16, [feeder])
        cluster.migrate_slots(cluster.routing.slots_of(0)[:8], 1)
        fed_at_start = feeder.fed
        feeder.join()
        smoke.wait_for("drain", lambda: consumer.unique == 4 * n and
                       cluster._migration is None, [consumer], svc)
        consumer.stop()
    finally:
        session.close()
        svc.stop()
    assert fed_at_start < n
    assert cluster.stats["parked_records"] > 0
    assert smoke.check_delivered("stream", consumer.counts,
                                 exactly_once=True) == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_churn_storm_parks_records_for_its_first_migration(seed):
    """Phase 7a (a) on the CPU at 4 x 4096 records a window: the storm's
    first migration is in flight while the feeder still streams, so the
    routing loop parks records whatever the threads' timing (before, a
    feeder that ran ahead of the storm left nothing to park), and the
    phase's checks hold: both windows exactly once, three migrations,
    two shards added, an epoch bump seen for each."""
    n = 4096
    arrays = {f"mdt{m}": smoke.make_journal_arrays(m, 2 * n, seed)
              for m in range(smoke.N_MDTS)}
    records = {pid: smoke.journal_records(T, a, 0, 2 * n)
               for pid, a in arrays.items()}
    run = smoke.run_churn(records, "cpu", seed)
    assert run["stats"]["parked_records"] > 0
    assert run["hold_s"] is not None
    assert smoke.verify_churn(run)["duplicates"] == 0


def test_router_counts_reads_under_its_lock():
    """Replay reads hash from a shard service's thread while the routing
    loop hashes from its own: both counts of the router (chunks, reads)
    stay exact when threads share it."""
    rows = []
    for i in range(4):
        rec = T.ChangelogRecord(type=T.CL_CREATE, time=1 + i,
                                tfid=T.Fid(0x200000400, 1 + i, 0),
                                name=b"f", index=1 + i)
        rows.append(T.pack(rec))
    batch = T.RecordBatch.from_packed(rows)
    cluster = port_cluster.LcapCluster({}, n_shards=2, device="cpu")
    calls = 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            cluster.batch_slots(batch) for _ in range(calls)]),
            threading.Thread(target=lambda: [
                cluster.batch_slots_many([batch, batch])
                for _ in range(calls)])]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        sys.setswitchinterval(interval)
    assert time.perf_counter() - t0 < 120
    assert cluster.routing_reads == 3 * calls
    assert cluster.routing_launches == 2 * calls
