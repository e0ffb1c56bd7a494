"""Port parity of the framework's LCAP consumers: the cases of
tests/test_track.py, each run on the reference and on the port
(``repro_torch.track`` over the port's proxy and sessions).  Every case
holds the reference test's own assertions on both packages, and what it
observes must be equal: SQLite rows, checkpoint manifests (the final
shard and manifest files; temporary names carry the process and thread
ids), straggler flags and EWMAs, elastic plans, delivered records and
resume cursors.  The journals' wall clock is replaced by a counter that
restarts for each package's run.

``test_cache_invalidation_ephemeral`` is not repeated here:
tests/test_torch_serve.py holds the port's ephemeral invalidation
against the reference's launcher (one page evicted per replica).  The
invalidator's requeue-on-failure case is.
"""

import json
import os
import threading
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import repro.core.llog as ref_llog                         # noqa: E402
import repro.core.proxy as ref_proxy                       # noqa: E402
import repro.core.reader as ref_reader                     # noqa: E402
import repro.track as ref_track                            # noqa: E402
from repro.core import records as R                       # noqa: E402
import repro_torch.core.llog as port_llog                  # noqa: E402
import repro_torch.core.proxy as port_proxy                # noqa: E402
import repro_torch.core.reader as port_reader              # noqa: E402
import repro_torch.track as port_track                     # noqa: E402
from repro_torch.core import records as T                 # noqa: E402

REF = SimpleNamespace(name="ref", R=R, llog=ref_llog, proxy=ref_proxy,
                      reader=ref_reader, track=ref_track)
PORT = SimpleNamespace(name="port", R=T, llog=port_llog, proxy=port_proxy,
                       reader=port_reader, track=port_track)

T0 = 1_700_000_000_000_000_000
#: the journals' wall clock in these tests (``records.now_ns``)
CLOCK = {"t": 0}


@pytest.fixture(autouse=True)
def stream_clock(monkeypatch):
    """Replace ``records.now_ns`` in both packages by a counter, which
    ``both`` restarts for each package's run, so stamped times match."""
    def now_ns():
        CLOCK["t"] += 1000
        return T0 + CLOCK["t"]

    for mod in (R, T):
        monkeypatch.setattr(mod, "now_ns", now_ns)


def both(scenario, tmp_path=None):
    """Run ``scenario`` on the reference and on the port (each in its own
    directory when given one); the port's observations must equal the
    reference's."""
    out = []
    for pkg in (REF, PORT):
        CLOCK["t"] = 0
        if tmp_path is None:
            out.append(scenario(pkg))
        else:
            d = tmp_path / pkg.name
            d.mkdir()
            out.append(scenario(pkg, d))
    assert out[1] == out[0]
    return out[0]


def mk_world(pkg, n_hosts=4):
    trackers = [pkg.track.ActivityTracker(run_id=1, host_id=h,
                                          jobid="run-1",
                                          shard=(0, h, h // 2, h % 2))
                for h in range(n_hosts)]
    proxy = pkg.proxy.LcapProxy({t.llog.producer_id: t.llog
                                 for t in trackers})
    return trackers, proxy


def pump_all(proxy, workers, rounds=10):
    for _ in range(rounds):
        proxy.pump()
        moved = sum(w.poll() for w in workers)
        proxy.flush_upstream()
        if not moved:
            break


def manifests(directory) -> dict:
    """The final files of a manifest directory: name -> JSON content."""
    out = {}
    for f in sorted(os.listdir(directory)):
        if ".tmp." not in f:
            with open(os.path.join(directory, f)) as fh:
                out[f] = json.load(fh)
    return out


def _metrics_db_group(pkg, tmp_path):
    P = pkg.R
    trackers, proxy = mk_world(pkg, 4)
    db = str(tmp_path / "metrics.sqlite")
    workers = [pkg.track.MetricsDB(proxy, db) for _ in range(3)]
    for step in range(5):
        for t in trackers:
            t.step_commit(step, loss=1.0 / (step + 1), step_time_s=0.1,
                          tokens=1024)
    pump_all(proxy, workers)
    rows = workers[0].query("SELECT COUNT(*) FROM events WHERE type=?",
                            (P.CL_STEP_COMMIT,))
    assert rows[0][0] == 20
    per = [w.query("SELECT COUNT(*) FROM events")[0][0] for w in workers]
    assert per[0] == 20
    assert all(t.llog.first_index == t.llog.last_index + 1
               for t in trackers)
    table = workers[0].query("SELECT * FROM events ORDER BY producer, idx")
    handled = [proxy.consumers[w.stream.cid].delivered for w in workers]
    for w in workers:
        w.close()
    return table, handled


def test_metrics_db_shared_across_group(tmp_path):
    both(_metrics_db_group, tmp_path)


def _checkpoint_protocol(pkg, tmp_path):
    trackers, proxy = mk_world(pkg, 4)
    committers = [pkg.track.CheckpointCommitter(
        proxy, str(tmp_path / "manifests")) for _ in range(2)]
    step = 7
    for shard, t in enumerate(trackers[:-1]):
        t.ckpt_write(step, shard_id=shard, nbytes=1 << 20,
                     path=f"/ckpt/s{shard}", total_shards=4)
    pump_all(proxy, committers)
    assert committers[0].latest_committed() is None
    pending = manifests(tmp_path / "manifests")
    trackers[-1].ckpt_write(step, shard_id=3, nbytes=1 << 20,
                            path="/ckpt/s3", total_shards=4)
    pump_all(proxy, committers)
    assert committers[0].latest_committed() == step
    assert os.path.exists(committers[0].manifest_path(step))
    return (pending, manifests(tmp_path / "manifests"),
            [sorted(c.committed) for c in committers])


def test_checkpoint_commit_protocol(tmp_path):
    both(_checkpoint_protocol, tmp_path)


def _concurrent_committers(pkg, tmp_path):
    P = pkg.R
    _trackers, proxy = mk_world(pkg, 2)
    c1 = pkg.track.CheckpointCommitter(proxy, str(tmp_path / "manifests"))
    c2 = pkg.track.CheckpointCommitter(proxy, str(tmp_path / "manifests"))
    steps = list(range(25))

    def rec_for(step, shard):
        return P.ChangelogRecord(
            type=P.CL_CKPT_WRITE, tfid=P.Fid(1, shard, step),
            name=f"/ckpt/s{shard}".encode(), metrics=(1024.0,),
            xattr={"total_shards": 2})

    barrier = threading.Barrier(2)
    errors = []

    def member(committer, shard):
        try:
            for step in steps:
                barrier.wait()
                committer.handle("host0", rec_for(step, shard))
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=member, args=(c1, 0)),
               threading.Thread(target=member, args=(c2, 1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for step in steps:
        path = c1.manifest_path(step)
        assert os.path.exists(path), f"step {step} never committed"
        with open(path) as fh:
            assert set(json.load(fh)["shards"]) == {"0", "1"}, step
    assert [f for f in os.listdir(c1.dir) if ".shard-" in f] == []
    c1.handle("host0", rec_for(steps[0], 0))
    assert not [f for f in os.listdir(c1.dir) if ".shard-" in f]
    out = manifests(c1.dir), c1.latest_committed()
    c1.close()
    c2.close()
    return out


def test_checkpoint_committer_concurrent_members_no_lost_update(tmp_path):
    both(_concurrent_committers, tmp_path)


def _straggler(pkg):
    trackers, proxy = mk_world(pkg, 4)
    det = pkg.track.StragglerDetector(proxy)
    for step in range(10):
        for h, t in enumerate(trackers):
            t.heartbeat(step, step_time_s=0.1 if h != 2 else 0.5)
    pump_all(proxy, [det])
    assert det.flagged == {2}
    return det.flagged, det.ewma, det.last_seen


def test_straggler_detection():
    both(_straggler)


def _straggler_leave(pkg):
    trackers, proxy = mk_world(pkg, 4)
    det = pkg.track.StragglerDetector(proxy)
    for step in range(10):
        for h, t in enumerate(trackers):
            t.heartbeat(step, step_time_s=0.1 if h != 2 else 0.5)
    pump_all(proxy, [det])
    assert det.flagged == {2}
    views = [(set(det.flagged), dict(det.ewma))]
    trackers[2].elastic(joined=False, n_hosts=3, step=10)
    pump_all(proxy, [det])
    assert 2 not in det.ewma
    assert det.flagged == set()
    views.append((set(det.flagged), dict(det.ewma)))
    for step in range(10, 15):
        for h, t in enumerate(trackers):
            if h != 2:
                t.heartbeat(step, step_time_s=0.1)
    pump_all(proxy, [det])
    assert det.flagged == set()
    views.append((set(det.flagged), dict(det.ewma)))
    return views


def test_straggler_evicted_on_leave():
    both(_straggler_leave)


def _straggler_stale(pkg):
    P = pkg.R
    trackers, proxy = mk_world(pkg, 3)
    det = pkg.track.StragglerDetector(proxy, stale_after_s=30.0)
    t0 = P.now_ns()

    def hb(host, step, dt, at_s):
        trackers[host].llog.log(P.ChangelogRecord(
            type=P.CL_HEARTBEAT, tfid=P.Fid(1, host, step),
            time=t0 + int(at_s * 1e9), metrics=(dt,)))

    for step in range(5):
        for h in range(3):
            hb(h, step, 0.1 if h != 2 else 0.5, at_s=step)
    pump_all(proxy, [det])
    assert det.flagged == {2}
    before = (set(det.flagged), dict(det.ewma))
    for step in range(5, 8):
        for h in range(2):
            hb(h, step, 0.1, at_s=40 + step)
    pump_all(proxy, [det])
    assert 2 not in det.ewma
    assert det.flagged == set()
    return before, det.flagged, det.ewma, det.last_seen


def test_straggler_stale_host_aged_out():
    both(_straggler_stale)


def _elastic(pkg):
    trackers, proxy = mk_world(pkg, 4)
    ctl = pkg.track.ElasticController(proxy, chips_per_host=4)
    for t in trackers:
        t.elastic(joined=True, n_hosts=4, step=0)
    pump_all(proxy, [ctl])
    assert ctl.members == {0, 1, 2, 3}
    first = ctl.plan()
    assert first["usable"] == 16
    trackers[1].elastic(joined=False, n_hosts=3, step=5)
    pump_all(proxy, [ctl])
    assert ctl.members == {0, 2, 3}
    assert ctl.plan()["usable"] == 8
    return first, ctl.plan(), ctl.members


def test_elastic_membership_plan():
    both(_elastic)


def _index_bootstrap(pkg, tmp_path):
    index = [(i, 1, f"obj{i}", 4096 * i) for i in range(100)]
    log = pkg.track.synthesize_index_stream(index)
    proxy = pkg.proxy.LcapProxy({"index0": log})
    db = str(tmp_path / "boot.sqlite")
    workers = [pkg.track.MetricsDB(proxy, db) for _ in range(4)]
    pump_all(proxy, workers)
    assert workers[0].query("SELECT COUNT(*) FROM events")[0][0] == 100
    handled = [proxy.consumers[w.stream.cid].delivered for w in workers]
    assert all(h > 0 for h in handled) and sum(handled) == 100
    table = workers[0].query("SELECT * FROM events ORDER BY idx")
    for w in workers:
        w.close()
    return handled, table, [bytes(b) for b in log.read(1, 100)]


def test_bootstrap_index_traversal(tmp_path):
    both(_index_bootstrap, tmp_path)


def _data_consume(pkg):
    trackers, proxy = mk_world(pkg, 2)
    r = pkg.reader.LocalReader(proxy, "replay")
    trackers[0].data_consume(step=3, shard_id=11, lo=0, hi=512)
    trackers[1].data_consume(step=3, shard_id=12, lo=512, hi=1024)
    proxy.pump()
    got = r.fetch()
    ranges = sorted((rec.xattr["lo"], rec.xattr["hi"]) for _, rec in got)
    assert ranges == [(0, 512), (512, 1024)]
    return [(pid, pkg.R.pack(rec)) for pid, rec in got]


def test_data_consume_records_support_replay():
    both(_data_consume)


def _invalidator_requeue(pkg):
    trackers, proxy = mk_world(pkg, 2)
    cache = {(oid, 1): f"page-{oid}" for oid in range(8)}
    inv = pkg.track.CacheInvalidator(proxy, cache, mode="persistent")
    for oid in range(8):
        trackers[oid % 2].evict(oid, 1)
    proxy.pump()
    real = inv.handle_batch
    calls = {"n": 0}

    def flaky(pid, batch):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient handler failure")
        real(pid, batch)

    inv.handle_batch = flaky
    with pytest.raises(RuntimeError, match="transient"):
        inv.poll()
    polled = []
    for _ in range(10):
        polled.append(inv.poll())
        proxy.pump()
    assert not cache
    assert inv.invalidated == 8
    inv.close()
    return polled, calls["n"], dict(proxy.stats)


def test_cache_invalidator_requeues_on_handler_failure():
    both(_invalidator_requeue)


def _failed_close_resumes(pkg, tmp_path):
    trackers, proxy = mk_world(pkg, 1)
    db = str(tmp_path / "metrics.sqlite")
    w1 = pkg.track.MetricsDB(proxy, db, name="m0")
    for step in range(10):
        trackers[0].step_commit(step, loss=1.0, step_time_s=0.1, tokens=1)
    proxy.pump()
    w1.poll()
    cursor = dict(w1.stream.resume_token)
    for step in range(10, 20):
        trackers[0].step_commit(step, loss=1.0, step_time_s=0.1, tokens=1)
    proxy.pump()
    w1.close(failed=True)
    w2 = pkg.track.MetricsDB(proxy, db, name="m0")
    assert proxy.stats["resumed"] == 1
    assert w2.stream.resumed
    assert w2.stream.resume_token == cursor
    n = 0
    for _ in range(10):
        n += w2.poll()
        proxy.pump()
    assert n == 10
    assert w2.query("SELECT COUNT(*) FROM events")[0][0] == 20
    table = w2.query("SELECT * FROM events ORDER BY idx")
    w2.close()
    return cursor, n, table


def test_metrics_db_failed_close_parks_and_resumes(tmp_path):
    both(_failed_close_resumes, tmp_path)
