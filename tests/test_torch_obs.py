"""Port parity of the observability plane: the 21 cases of
tests/test_obs.py, each run on the reference and on the port
(``repro_torch.obs`` over the port's proxy, cluster and sessions, the
cluster routing on the CPU).  Every case holds the reference test's own
assertions on both packages, and what it observes must be equal:
registry snapshots, Prometheus text for counters and gauges (histograms
of pump latency hold wall time, so only their families, labels and
bucket bounds are compared), merged cluster snapshots, window counters,
``top`` rows, lag views, SQLite rows, Ganglia metrics and the ``top``
frame.  Records carry fixed timestamps, and the journals' wall clock is
replaced by a counter that restarts for each package's run.
"""

import re
import urllib.error
import urllib.request
from collections import Counter
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import repro.core.cluster as ref_cluster                   # noqa: E402
import repro.core.history as ref_history                   # noqa: E402
import repro.core.llog as ref_llog                         # noqa: E402
import repro.core.proxy as ref_proxy                       # noqa: E402
import repro.core.server as ref_server                     # noqa: E402
import repro.core.session as ref_session                   # noqa: E402
import repro.core.transport as ref_transport               # noqa: E402
import repro.obs as ref_obs                                # noqa: E402
import repro.track.consumers as ref_consumers              # noqa: E402
from repro.core import records as R                       # noqa: E402
import repro_torch.core.cluster as port_cluster            # noqa: E402
import repro_torch.core.history as port_history            # noqa: E402
import repro_torch.core.llog as port_llog                  # noqa: E402
import repro_torch.core.proxy as port_proxy                # noqa: E402
import repro_torch.core.server as port_server              # noqa: E402
import repro_torch.core.session as port_session            # noqa: E402
import repro_torch.core.transport as port_transport        # noqa: E402
import repro_torch.obs as port_obs                         # noqa: E402
import repro_torch.track.consumers as port_consumers       # noqa: E402
from repro_torch.core import records as T                 # noqa: E402

REF = SimpleNamespace(R=R, cluster=ref_cluster, history=ref_history,
                      llog=ref_llog, proxy=ref_proxy, server=ref_server,
                      session=ref_session, transport=ref_transport,
                      obs=ref_obs, consumers=ref_consumers, kw={})
PORT = SimpleNamespace(R=T, cluster=port_cluster, history=port_history,
                       llog=port_llog, proxy=port_proxy, server=port_server,
                       session=port_session, transport=port_transport,
                       obs=port_obs, consumers=port_consumers,
                       kw={"device": "cpu"})

T0 = 1_700_000_000_000_000_000        # stream epoch (ns)
WIN = 1_000_000_000                   # 1 s panes


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


def both(scenario, *args):
    """Run ``scenario`` on the reference and on the port; the port's
    observations must equal the reference's."""
    CLOCK["t"] = 0
    ref = scenario(REF, *args)
    CLOCK["t"] = 0
    port = scenario(PORT, *args)
    assert port == ref
    return ref


def mk_logs(pkg, n=2):
    return {f"mdt{i}": pkg.llog.Llog(f"mdt{i}") for i in range(n)}


def cluster(pkg, logs, **kw):
    return pkg.cluster.LcapCluster(logs, **kw, **pkg.kw)


def feed_varied(pkg, logs, n_each=60, jobs=4, with_rename=True):
    """tests/test_obs.py's messy workload: mixed op types, records with
    and without jobid/shard/metrics, and CLF_RENAME records."""
    P = pkg.R
    types = [P.CL_CREATE, P.CL_CLOSE, P.CL_HEARTBEAT, P.CL_STEP_COMMIT]
    fed = []
    for p, (pid, log) in enumerate(sorted(logs.items())):
        for i in range(n_each):
            kw = {}
            if i % 5 != 4:
                kw["jobid"] = f"job-{i % jobs}".encode()
            if i % 7 != 6:
                kw["shard"] = (p, i % 3, 0, 0)
            if i % 3 == 0:
                kw["metrics"] = (float(i), 0.5)
            if with_rename and i % 11 == 0:
                kw["sfid"] = P.Fid(9, i, 0)
                kw["spfid"] = P.Fid(9, 0, 0)
                kw["sname"] = b"old"
            rec = P.ChangelogRecord(
                type=types[i % len(types)], tfid=P.Fid(1, i % 17, 0),
                pfid=P.Fid(1, 0, 0), name=f"{pid}-{i}".encode(),
                time=T0 + (i % 10) * WIN + (i % 10) * 1000, **kw)
            if log.log(rec) is not None:
                fed.append((pid, rec))
    return fed


def expected_fold(fed, window_ns=WIN):
    """Offline scalar reference of the aggregator's fold."""
    counts, vsums = Counter(), Counter()
    for pid, rec in fed:
        key = (rec.time // window_ns,
               (rec.type, (rec.jobid or b"").decode(), pid,
                rec.shard[1] if rec.shard else 0))
        counts[key] += 1
        vsums[key] += rec.metrics[0] if rec.metrics else 0.0
    return counts, vsums


def drain(proxy, agg, rounds=50):
    for _ in range(rounds):
        moved = proxy.pump()
        got = agg.run_once()
        proxy.flush_upstream()
        if not moved and not got:
            break


def windows(agg) -> dict:
    return {(w, key): cell for w in agg.window_ids()
            for key, cell in agg.counters(w).items()}


def split(pkg, snap) -> tuple:
    """A snapshot as (Prometheus text of its counters and gauges,
    {histogram family: sorted [(labels, bucket bounds)]})."""
    plain = {n: e for n, e in snap.items() if e["type"] != "histogram"}
    hists = {n: sorted((sorted(lb.items()), [le for le, _c in v["buckets"]])
                       for lb, v in e["samples"])
             for n, e in snap.items() if e["type"] == "histogram"}
    return pkg.obs.render_prometheus(plain), hists


# ===================================================================== registry
def _registry_basics(pkg):
    reg = pkg.obs.MetricsRegistry()
    c = reg.counter("c_total", "a counter")
    c.inc()
    c.inc(4)
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("g", "a gauge")
    g.set(10)
    g.dec(3)
    h = reg.histogram("h_seconds", "a histogram", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(99.0)                      # above every bucket: +Inf only
    snap = reg.snapshot()
    assert snap["c_total"]["samples"] == [[{}, 5.0]]
    assert snap["g"]["samples"] == [[{}, 7.0]]
    hs = snap["h_seconds"]["samples"][0][1]
    assert hs["buckets"] == [[0.1, 1], [1.0, 2]]     # cumulative
    assert hs["count"] == 3 and hs["sum"] == pytest.approx(99.55)
    return snap, pkg.obs.render_prometheus(snap)


def test_counter_gauge_histogram_basics():
    both(_registry_basics)


def _labeled_families(pkg):
    reg = pkg.obs.MetricsRegistry()
    fam = reg.counter("ops_total", labels=("op",))
    fam.labels(op="create").inc(2)
    fam.labels(op="close").inc()
    assert fam.labels(op="create") is fam.labels(op="create")
    with pytest.raises(ValueError):
        fam.labels(nope="x")
    assert reg.counter("ops_total", labels=("op",)) is fam   # idempotent
    with pytest.raises(ValueError):
        reg.gauge("ops_total")                               # kind conflict
    samples = {tuple(sorted(lb.items())): v
               for lb, v in reg.snapshot()["ops_total"]["samples"]}
    assert samples == {(("op", "create"),): 2.0, (("op", "close"),): 1.0}
    return reg.snapshot()


def test_labeled_families_cache_children_and_reject_conflicts():
    both(_labeled_families)


def _collectors(pkg):
    reg = pkg.obs.MetricsRegistry()
    reg.register_collector(
        lambda: [("live_depth", "gauge", "depth", {"q": "a"}, 7)])
    snap = reg.snapshot()
    assert snap["live_depth"]["samples"] == [[{"q": "a"}, 7]]
    return snap


def test_snapshot_folds_in_collectors():
    both(_collectors)


def _merge(pkg):
    a = {"n_total": {"type": "counter", "help": "", "samples": [[{}, 3]]},
         "depth": {"type": "gauge", "help": "", "samples": [[{}, 5]]},
         "h": {"type": "histogram", "help": "",
               "samples": [[{}, {"buckets": [[0.1, 1], [1.0, 2]],
                                 "sum": 0.5, "count": 2}]]}}
    b = {"n_total": {"type": "counter", "help": "", "samples": [[{}, 4]]},
         "depth": {"type": "gauge", "help": "", "samples": [[{}, 9]]},
         "h": {"type": "histogram", "help": "",
               "samples": [[{}, {"buckets": [[0.1, 0], [1.0, 3]],
                                 "sum": 2.0, "count": 3}]]}}
    merged = pkg.obs.merge_snapshots({"0": a, "1": b})
    assert merged["n_total"]["samples"] == [[{}, 7]]
    by_shard = {lb["shard"]: v for lb, v in merged["depth"]["samples"]}
    assert by_shard == {"0": 5, "1": 9}
    return merged, pkg.obs.merge_snapshots({"x": a, "y": b}, "origin")


def test_merge_snapshots_sums_counters_and_labels_gauges():
    both(_merge)


# ============================================================ payload columns
def _payload_columns(pkg):
    logs = mk_logs(pkg, 1)
    pkg.proxy.LcapProxy(logs)                     # registers the reader
    fed = feed_varied(pkg, logs, n_each=80)
    batch = logs["mdt0"].read(1, 4096)
    recs = [pkg.R.unpack(bytes(batch.packed(i))) for i in range(len(batch))]
    assert len(recs) == len(fed)
    jm = batch.jobid_col()
    pod, host = batch.shard_cols()
    m0 = batch.metric0_col()
    for i, rec in enumerate(recs):
        assert bytes(jm[i]).rstrip(b"\0") == (rec.jobid or b"")
        assert (int(pod[i]), int(host[i])) == \
            ((rec.shard[0], rec.shard[1]) if rec.shard else (0, 0))
        assert m0[i] == (rec.metrics[0] if rec.metrics else 0.0)
    return jm.tobytes(), pod.tolist(), host.tolist(), m0.tolist()


def test_payload_columns_match_scalar_unpack():
    both(_payload_columns)


# ================================================================= aggregator
def _aggregator_vs_scalar(pkg):
    logs = mk_logs(pkg, 2)
    proxy = pkg.proxy.LcapProxy(logs)
    agg = pkg.obs.ActivityAggregator(proxy, window_ns=WIN, retention=64)
    fed = feed_varied(pkg, logs, n_each=60)
    drain(proxy, agg)
    counts, vsums = expected_fold(fed)
    got = windows(agg)
    assert {k: c for k, (c, _v) in got.items()} == dict(counts)
    for key in vsums:
        assert got[key][1] == pytest.approx(vsums[key])
    assert agg.stats["records"] == len(fed)
    assert all(log.first_index == log.last_index + 1
               for log in logs.values())
    return got, agg.stats, agg.totals()


def test_aggregator_matches_scalar_reference():
    both(_aggregator_vs_scalar)


def _sliding_and_top(pkg):
    P = pkg.R
    logs = mk_logs(pkg, 1)
    proxy = pkg.proxy.LcapProxy(logs)
    agg = pkg.obs.ActivityAggregator(proxy, window_ns=WIN)
    log = logs["mdt0"]
    for win, job, n in ((0, b"a", 2), (1, b"a", 5), (1, b"b", 1)):
        for i in range(n):
            log.log(P.ChangelogRecord(type=P.CL_CREATE,
                                      tfid=P.Fid(1, i, win), name=b"f",
                                      jobid=job, time=T0 + win * WIN + i))
    drain(proxy, agg)
    w0 = T0 // WIN
    pair = agg.sliding(2, end=w0 + 1)
    assert pair[(P.CL_CREATE, "a", "mdt0", 0)][0] == 7
    assert pair[(P.CL_CREATE, "b", "mdt0", 0)][0] == 1
    top = agg.top("jobid", k=2, window=w0 + 1)
    assert top[0]["label"] == "a" and top[0]["count"] == 5
    assert top[0]["delta"] == 3
    assert top[0]["rate"] == pytest.approx(5.0)
    assert top[1] == {"label": "b", "count": 1, "value_sum": 0.0,
                      "rate": 1.0, "delta": 1}
    assert agg.rate(w0 + 1) == pytest.approx(6.0)
    return (pair, top, agg.top("op", window=w0 + 1),
            agg.top("producer", sliding=2), agg.rate(w0 + 1))


def test_sliding_windows_and_top_trends():
    both(_sliding_and_top)


def _retention(pkg):
    P = pkg.R
    logs = mk_logs(pkg, 1)
    proxy = pkg.proxy.LcapProxy(logs)
    agg = pkg.obs.ActivityAggregator(proxy, window_ns=WIN, retention=3)
    log = logs["mdt0"]
    for win in range(6):
        log.log(P.ChangelogRecord(type=P.CL_CREATE, tfid=P.Fid(1, win, 0),
                                  name=b"f", time=T0 + win * WIN))
    drain(proxy, agg)
    assert len(agg.window_ids()) == 3
    assert agg.stats["windows_evicted"] == 3
    log.log(P.ChangelogRecord(type=P.CL_CREATE, tfid=P.Fid(1, 99, 0),
                              name=b"late", time=T0))
    drain(proxy, agg)
    assert agg.stats["late_dropped"] == 1
    assert len(agg.window_ids()) == 3
    return agg.window_ids(), agg.stats, windows(agg)


def test_ring_retention_evicts_and_counts_late_records():
    both(_retention)


def _replay_warm_start(pkg):
    logs = {"mdt0": pkg.llog.Llog(
        "mdt0", history=pkg.history.HistoryStore(compactor=None))}
    proxy = pkg.proxy.LcapProxy(logs)
    first = pkg.obs.ActivityAggregator(proxy, group="first", window_ns=WIN)
    fed = feed_varied(pkg, logs, n_each=40, with_rename=False)
    drain(proxy, first)
    late = pkg.obs.ActivityAggregator(proxy, group="late", window_ns=WIN,
                                      replay=True)
    more = feed_varied(pkg, logs, n_each=10, with_rename=False)
    drain(proxy, late)
    counts, _ = expected_fold(fed + more)
    got = windows(late)
    assert {k: c for k, (c, _v) in got.items()} == dict(counts)
    return got, late.stream.replayed


def test_replay_bootstrap_warm_starts_the_aggregator():
    both(_replay_warm_start)


# ======================================================== stats parity (sat 1)
def run_dispatch_workload(pkg, force_scalar):
    P = pkg.R
    S = pkg.session.Subscription
    logs = mk_logs(pkg, 2)
    proxy = pkg.proxy.LcapProxy(logs, batch_size=64)
    if force_scalar:
        proxy._fast_eligible = lambda *a, **kw: False
    sess = pkg.session.connect(proxy)
    streams = {
        "all": sess.subscribe(S(group="all", auto_commit=False)),
        "mixed": sess.subscribe(S(group="mixed",
                                  types={P.CL_CREATE, P.CL_CLOSE},
                                  auto_commit=False)),
        "rare": sess.subscribe(S(group="rare", types={P.CL_MKDIR},
                                 auto_commit=False)),
        "eph": sess.subscribe(S(mode="ephemeral", types={P.CL_HEARTBEAT},
                                auto_commit=False)),
    }
    feed_varied(pkg, logs, n_each=50)
    delivered = {name: Counter() for name in streams}
    for _ in range(60):
        moved = proxy.pump()
        pulled = 0
        for name, stream in streams.items():
            for pid, batch in stream.fetch(4096):
                delivered[name].update(
                    (pid, int(i)) for i in batch.indices())
                pulled += len(batch)
            stream.commit()
        proxy.flush_upstream()
        if not moved and not pulled:
            break
    stats = dict(proxy.stats)
    sess.close()
    return stats, delivered


def _dispatch_paths(pkg):
    col_stats, col_seen = run_dispatch_workload(pkg, force_scalar=False)
    sc_stats, sc_seen = run_dispatch_workload(pkg, force_scalar=True)
    assert col_seen == sc_seen
    for key in ("ingested", "dispatched", "filtered_out", "ephemeral_drops",
                "dropped_by_modules", "redelivered"):
        assert col_stats[key] == sc_stats[key], key
    total_seen = sum(sum(c.values())
                     for name, c in col_seen.items() if name != "eph")
    assert col_stats["dispatched"] == total_seen
    return col_stats, sc_stats, col_seen


def test_scalar_and_columnar_dispatch_stats_agree():
    both(_dispatch_paths)


def _zero_fill(pkg):
    P = pkg.R
    S = pkg.session.Subscription
    mask = P.CLF_JOBID | P.CLF_SHARD | P.CLF_METRICS
    logs = mk_logs(pkg, 1)
    proxy = pkg.proxy.LcapProxy(logs)
    sess = pkg.session.connect(proxy)
    filled = sess.subscribe(S(group="filled", flags=mask, auto_commit=False))
    raw = sess.subscribe(S(group="raw", flags=mask, auto_commit=False,
                           zero_fill=False))
    feed_varied(pkg, logs, n_each=20, with_rename=False)
    proxy.pump()
    filled_flags, raw_flags = [], []
    for _pid, batch in filled.fetch(4096):
        filled_flags.extend(batch.flags_np().tolist())
    for _pid, batch in raw.fetch(4096):
        raw_flags.extend(batch.flags_np().tolist())
        assert not any(f & ~mask for f in batch.flags_np().tolist())
    assert len(filled_flags) == len(raw_flags) == 20
    assert all(f == mask for f in filled_flags)
    assert any(f != mask for f in raw_flags)
    assert {f & mask for f in raw_flags} == set(raw_flags)
    sess.close()
    return filled_flags, raw_flags


def test_zero_fill_opt_out_skips_the_scalar_remap():
    both(_zero_fill)


# ============================================================== metrics / lag
def _proxy_lag(pkg):
    P = pkg.R
    logs = mk_logs(pkg, 1)
    proxy = pkg.proxy.LcapProxy(logs)
    sess = pkg.session.connect(proxy)
    stream = sess.subscribe(pkg.session.Subscription(group="g",
                                                     auto_commit=False))
    for i in range(20):
        logs["mdt0"].log(P.ChangelogRecord(type=P.CL_CREATE,
                                           tfid=P.Fid(1, i, 0), name=b"f",
                                           time=T0))
    proxy.pump()
    lag0 = proxy.lag()["g"]["mdt0"]
    assert lag0["dispatch_hw"] == 20 and lag0["lag"] == 20
    fetched = stream.fetch(4096)
    lag1 = proxy.lag()["g"]["mdt0"]
    assert lag1["lag"] == 20 and lag1["in_flight"] == 20
    stream.requeue(fetched)
    for _pid, _b in stream.fetch(4096):
        pass
    stream.commit()
    lag2 = proxy.lag()["g"]["mdt0"]
    assert lag2 == {"dispatch_hw": 20, "ack": 20, "lag": 0, "in_flight": 0}
    sess.close()
    return lag0, lag1, lag2


def test_proxy_lag_tracks_outstanding_and_converges():
    both(_proxy_lag)


def _verbs_over_the_wire(pkg):
    """The service's poller pumps on its own thread, so counters that
    count rounds differ between runs: families, their types and label
    names, and the record counts are compared."""
    P = pkg.R
    logs = mk_logs(pkg, 1)
    proxy = pkg.proxy.LcapProxy(logs)
    proxy.attach_registry(pkg.obs.MetricsRegistry())
    service = pkg.server.LcapService(proxy).start()
    try:
        sess = pkg.session.connect(service.address)
        stream = sess.subscribe(pkg.session.Subscription(group="g",
                                                         auto_commit=True))
        for i in range(10):
            logs["mdt0"].log(P.ChangelogRecord(
                type=P.CL_CREATE, tfid=P.Fid(1, i, 0), name=b"f", time=T0))
        seen = 0
        for _ in range(100):
            seen += sum(len(b) for _p, b in stream.fetch(64))
            if seen >= 10:
                break
        assert seen == 10
        remote = sess.metrics()
        assert remote["lcap_proxy_ingested_total"]["samples"][0][1] >= 10
        assert "lcap_pump_latency_seconds" in remote
        lag = sess.lag()
        assert lag["g"]["mdt0"]["lag"] >= 0
        assert sess.stats()["ingested"] >= 10
        sess.close()
    finally:
        service.stop()
    shape = {n: (e["type"], sorted({tuple(sorted(lb)) for lb, _v
                                    in e["samples"]}))
             for n, e in remote.items()}
    return (seen, shape, remote["lcap_proxy_ingested_total"]["samples"],
            split(pkg, remote)[1])


def test_metrics_and_lag_verbs_over_the_wire():
    both(_verbs_over_the_wire)


def _transport_counters(pkg):
    reg = pkg.obs.MetricsRegistry()
    pkg.transport.instrument(reg)
    try:
        logs = mk_logs(pkg, 1)
        proxy = pkg.proxy.LcapProxy(logs)
        service = pkg.server.LcapService(proxy).start()
        try:
            sess = pkg.session.connect(service.address)
            sess.stats()
            sess.close()
        finally:
            service.stop()
        snap = reg.snapshot()
        by_dir = {lb["direction"]: v for lb, v in
                  snap["lcap_transport_messages_total"]["samples"]}
        assert by_dir["sent"] >= 2 and by_dir["received"] >= 2
        assert all(v > 0 for _l, v in
                   snap["lcap_transport_bytes_total"]["samples"])
    finally:
        pkg.transport._METRICS = None      # don't leak into other tests
    return {n: (e["type"], e["help"], sorted(lb["direction"]
                                             for lb, _v in e["samples"]))
            for n, e in snap.items()}


def test_transport_counters_when_instrumented():
    both(_transport_counters)


def _cluster_session_metrics(pkg):
    logs = mk_logs(pkg, 2)
    c = cluster(pkg, logs, n_shards=2)
    c.attach_registry(pkg.obs.MetricsRegistry())
    sess = pkg.session.connect(c)
    stream = sess.subscribe(pkg.session.Subscription(group="g",
                                                     auto_commit=False))
    feed_varied(pkg, logs, n_each=30, with_rename=False)
    for _ in range(50):
        c.pump()
        moved = sum(len(b) for _p, b in stream.fetch(4096))
        stream.commit()
        if not moved:
            break
    lag = sess.lag()
    assert set(lag["per_shard"]) == {0, 1}
    assert lag["g"]["mdt0"]["lag"] == 0
    merged = c.metrics()
    assert merged["lcap_cluster_routed_total"]["samples"][0][1] == 60
    shards = {lb.get("shard") for lb, _v in
              merged["lcap_shard_alive"]["samples"]}
    assert shards == {"0", "1"}
    # the session's merge over the shards' own registries too
    per_shard = sess.metrics()
    sess.close()
    return lag, split(pkg, merged), split(pkg, per_shard)


def test_cluster_session_aggregates_metrics_and_lag():
    both(_cluster_session_metrics)


# ===================================================== lag across kill (sat 3)
def _lag_across_kill(pkg):
    logs = mk_logs(pkg, 2)
    c = cluster(pkg, logs, n_shards=3)
    sess = pkg.session.connect(c)
    stream = sess.subscribe(pkg.session.Subscription(group="g",
                                                     auto_commit=False))
    feed_varied(pkg, logs, n_each=40, with_rename=False)
    c.pump()
    fetched = stream.fetch(1 << 30)
    assert fetched
    views = [sess.lag()]
    for pids in (v for k, v in views[0].items() if k != "per_shard"):
        for ent in pids.values():
            assert ent["lag"] >= 0
    c.kill_shard(0)
    after = sess.lag()
    views.append(after)
    assert set(after["per_shard"]) == {1, 2}
    for pids in (v for k, v in after.items() if k != "per_shard"):
        for ent in pids.values():
            assert ent["lag"] >= 0
    assert any(ent["lag"] > 0 for ent in after["g"].values())
    stream.requeue(fetched)
    for _ in range(80):
        c.pump()
        moved = sum(len(b) for _p, b in stream.fetch(1 << 30))
        stream.commit()
        final = sess.lag()
        views.append(final)
        lags = [ent["lag"] for k, pids in final.items() if k != "per_shard"
                for ent in pids.values()]
        assert all(lag >= 0 for lag in lags)
        if not moved and all(lag == 0 for lag in lags):
            break
    else:
        pytest.fail(f"lag never converged to zero: {final}")
    sess.close()
    return views


def test_lag_across_shard_kill_never_negative_and_converges():
    both(_lag_across_kill)


# =================================== 4-shard equivalence vs MetricsDB (accept)
def _aggregator_vs_sql(pkg, tmp_path):
    logs = mk_logs(pkg, 3)
    c = cluster(pkg, logs, n_shards=4)
    db = str(tmp_path / f"metrics-{id(pkg)}.sqlite")
    mdb = pkg.consumers.MetricsDB(c, db)
    agg = pkg.obs.ActivityAggregator(c, window_ns=WIN, retention=256)
    fed = feed_varied(pkg, logs, n_each=50)
    for _ in range(80):
        moved = c.pump()
        moved += mdb.poll(1 << 20)
        moved += agg.run_once()
        if not moved and all(log.first_index == log.last_index + 1
                             for log in logs.values()):
            break
    assert agg.stats["records"] == len(fed)
    sql = {}
    for (t, j, p, h, w, n, vs) in mdb.query(
            "SELECT type, jobid, producer, host, time / ? AS win, "
            "COUNT(*), COALESCE(SUM(m0), 0) FROM events "
            "GROUP BY type, jobid, producer, host, win", (WIN,)):
        sql[(w, (t, j, p, h))] = (n, vs)
    got = windows(agg)
    assert set(got) == set(sql)
    for key in sql:
        assert got[key][0] == sql[key][0], key
        assert got[key][1] == pytest.approx(sql[key][1]), key
    rows = mdb.query("SELECT * FROM events ORDER BY producer, idx")
    mdb.close()
    return got, sql, rows


def test_cluster_aggregator_matches_metricsdb_sql(tmp_path):
    both(_aggregator_vs_sql, tmp_path)


# ==================================================================== export
_PROM_LINE = re.compile(
    r"^(# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .*"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="
    r"\"(?:[^\"\\]|\\.)*\"(,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\")*\})?"
    r" -?[0-9.eE+\-]+(inf|nan)?)$")

WEIRD = {"m": {"type": "gauge", "help": "quote \" test",
               "samples": [[{"l": 'a"b\\c\nd'}, 1], [{"l": "x"}, 0.25],
                           [{"l": "y"}, 1e16], [{"l": "z"}, -3.0]]}}


def _assert_valid_exposition(text):
    assert text.endswith("\n")
    for line in text.rstrip("\n").split("\n"):
        assert _PROM_LINE.match(line), f"invalid exposition line: {line!r}"


def mk_observed_world(pkg):
    logs = mk_logs(pkg, 2)
    proxy = pkg.proxy.LcapProxy(logs)
    reg = pkg.obs.MetricsRegistry()
    proxy.attach_registry(reg)
    agg = pkg.obs.ActivityAggregator(proxy, window_ns=WIN)
    reg.register_collector(agg.collector())
    feed_varied(pkg, logs, n_each=40)
    drain(proxy, agg)
    return logs, proxy, reg, agg


def _render(pkg):
    _logs, _proxy, reg, _agg = mk_observed_world(pkg)
    snap = reg.snapshot()
    text = pkg.obs.render_prometheus(snap)
    _assert_valid_exposition(text)
    assert "# TYPE lcap_proxy_dispatched_total counter" in text
    assert "# TYPE lcap_pump_latency_seconds histogram" in text
    assert 'le="+Inf"' in text
    assert re.search(r'lcap_window_records\{[^}]*jobid="job-0"', text)
    weird = pkg.obs.render_prometheus(WEIRD)
    _assert_valid_exposition(weird)
    return split(pkg, snap), weird


def test_prometheus_render_is_valid_exposition_format():
    _text, weird = both(_render)
    # the two renderers are byte-identical on one snapshot too
    assert port_obs.render_prometheus(WEIRD) == weird


def scrape(url: str) -> tuple:
    with urllib.request.urlopen(url, timeout=5) as resp:
        assert resp.status == 200
        return resp.headers["Content-Type"], resp.read().decode()


def _http_scrape(pkg):
    _logs, _proxy, reg, _agg = mk_observed_world(pkg)
    exporter = pkg.obs.PrometheusExporter(registry=reg).start()
    try:
        ctype, body = scrape(exporter.url)
        assert ctype.startswith("text/plain")
        _assert_valid_exposition(body)
        assert "lcap_proxy_ingested_total" in body
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                exporter.url.replace("/metrics", "/nope"), timeout=5)
    finally:
        exporter.stop()
    hist = {n for n, e in reg.snapshot().items() if e["type"] == "histogram"}
    lines = [ln for ln in body.splitlines()
             if not any(ln.split("{")[0].split(" ")[0].startswith(h)
                        or ln.startswith(f"# HELP {h} ")
                        or ln.startswith(f"# TYPE {h} ") for h in hist)]
    return ctype, lines


def test_prometheus_http_endpoint_serves_scrapes():
    both(_http_scrape)


def _ganglia(pkg):
    _logs, _proxy, reg, _agg = mk_observed_world(pkg)
    pusher = pkg.obs.GangliaPusher(registry=reg)
    n = pusher.push()
    assert n == len(pusher.sent) > 0
    names = {m["name"] for m in pusher.sent}
    assert any(name.startswith("lcap.dispatched") for name in names)
    assert any(".count" in name for name in names)
    for m in pusher.sent:
        assert set(m) == {"name", "value", "type", "units", "group"}
        assert m["type"] in ("counter", "gauge")
        assert re.match(r"^[A-Za-z0-9_.\-]+$", m["name"]), m["name"]
    # pump-latency sums hold wall time
    return [dict(m, value=None) if m["name"].endswith(".sum")
            and "pump_latency" in m["name"] else m for m in pusher.sent]


def test_ganglia_pusher_maps_names_like_gmond():
    both(_ganglia)


# ================================================================== dashboard
def _dashboard(pkg):
    logs = mk_logs(pkg, 2)
    c = cluster(pkg, logs, n_shards=2)
    sess = pkg.session.connect(c)
    agg = pkg.obs.ActivityAggregator(c, window_ns=WIN)
    feed_varied(pkg, logs, n_each=30, with_rename=False)
    for _ in range(40):
        moved = c.pump()
        moved += agg.run_once()
        if not moved:
            break
    top = pkg.obs.ActivityTop(agg, session=sess, cluster=c, k=3, sliding=10)
    frame = top.render()
    assert "lcap top" in frame
    assert "BUSIEST JOBS" in frame and "job-0" in frame
    assert "BUSIEST OPS" in frame
    assert "CONSUMER LAG" in frame and "obs" in frame
    assert "shard0[UP" in frame and "shard1[UP" in frame
    snap = top.snapshot()
    assert snap["lag"]["obs"]["mdt0"]["lag"] == 0
    c.kill_shard(1)
    after = top.render()
    assert "shard1[DOWN" in after
    sess.close()
    return frame, after, snap


def test_dashboard_renders_all_sections():
    both(_dashboard)
