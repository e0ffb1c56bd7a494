"""Port parity of the policy subsystem: the 13 cases of
tests/test_policy.py, each run on the reference and on the port
(``repro_torch.policy`` over the port's proxy, cluster, sessions and
history, the cluster routing on the CPU).  Every case holds the
reference test's own assertions on both packages, and what it observes
must be equal: mirror snapshots, emitted actions, the engine's live
action table and stats, action chains read back from the journal,
delivered action indices, per-shard placement and reconcile reports.
Records carry fixed stream times, and the journals' wall clock is
replaced by a counter that restarts for each package's run.

The concurrent-ingest case runs a producer thread against a live
service: its producer logs a fixed number of records (so the end state
is comparable) while the bootstrap runs, and keeps the reference test's
deadlines.
"""

import threading
import time
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import repro.core.cluster as ref_cluster                   # noqa: E402
import repro.core.history as ref_history                   # noqa: E402
import repro.core.llog as ref_llog                         # noqa: E402
import repro.core.proxy as ref_proxy                       # noqa: E402
import repro.core.server as ref_server                     # noqa: E402
import repro.core.session as ref_session                   # noqa: E402
import repro.policy as ref_policy                          # noqa: E402
import repro.policy.engine as ref_engine                   # noqa: E402
from repro.core import records as R                       # noqa: E402
import repro_torch.core.cluster as port_cluster            # noqa: E402
import repro_torch.core.history as port_history            # noqa: E402
import repro_torch.core.llog as port_llog                  # noqa: E402
import repro_torch.core.proxy as port_proxy                # noqa: E402
import repro_torch.core.server as port_server              # noqa: E402
import repro_torch.core.session as port_session            # noqa: E402
import repro_torch.policy as port_policy                   # noqa: E402
import repro_torch.policy.engine as port_engine            # noqa: E402
from repro_torch.core import records as T                 # noqa: E402

REF = SimpleNamespace(name="ref", R=R, cluster=ref_cluster,
                      history=ref_history, llog=ref_llog, proxy=ref_proxy,
                      server=ref_server, session=ref_session,
                      policy=ref_policy, engine=ref_engine, kw={})
PORT = SimpleNamespace(name="port", R=T, cluster=port_cluster,
                       history=port_history, llog=port_llog,
                       proxy=port_proxy, server=port_server,
                       session=port_session, policy=port_policy,
                       engine=port_engine, kw={"device": "cpu"})

T0 = 1_000_000_000_000_000
#: the journals' wall clock in these tests (``records.now_ns``)
CLOCK = {"t": 0}


@pytest.fixture(autouse=True)
def stream_clock(monkeypatch):
    """Replace ``records.now_ns`` in both packages by a counter, which
    ``both`` restarts for each package's run, so stamped times match."""
    def now_ns():
        CLOCK["t"] += 1000
        return 2 * T0 + CLOCK["t"]

    for mod in (R, T):
        monkeypatch.setattr(mod, "now_ns", now_ns)


def both(scenario, tmp_path):
    """Run ``scenario`` on the reference and on the port, each in its own
    directory; the port's observations must equal the reference's."""
    out = []
    for pkg in (REF, PORT):
        CLOCK["t"] = 0
        d = tmp_path / pkg.name
        d.mkdir()
        out.append(scenario(pkg, d))
    assert out[1] == out[0]
    return out[0]


def rec(pkg, t, oid, at_s=0.0, name=b"f", ver=0, **kw):
    return pkg.R.ChangelogRecord(type=t, tfid=pkg.R.Fid(1, oid, ver),
                                 pfid=pkg.R.Fid(1, 0, 0), name=name,
                                 time=T0 + int(at_s * 1e9), **kw)


def mk_proxy(pkg, tmp_path, sub="j"):
    log = pkg.llog.Llog("mdt0", path=str(tmp_path / sub),
                        segment_records=16, history=True)
    return pkg.proxy.LcapProxy({"mdt0": log}), log


def mk_cluster(pkg, logs, n_shards):
    return pkg.cluster.LcapCluster(logs, n_shards=n_shards, **pkg.kw)


def drive(proxy, mirror, engine=None, rounds=50):
    """pump -> mirror poll -> evaluate until quiescent."""
    for _ in range(rounds):
        moved = proxy.pump()
        moved += mirror.poll(4096)
        if engine is not None:
            engine.evaluate()
            moved += proxy.pump()
        if not moved and not mirror.bootstrapping:
            return
    raise AssertionError("did not quiesce")


def report(r) -> tuple:
    """A ``ReconcileReport`` as plain values (the two packages' report
    classes never compare equal)."""
    return (r.ok, r.missing, r.extra, r.mismatched, r.truth_live,
            r.stream_live, str(r))


def action_chain(pkg, engine) -> list:
    """Every record of the action journal, live and archived, as
    (index, type, key, xattr, time)."""
    reader = pkg.history.JournalReplayReader(engine.log)
    chain, pos = [], 1
    while pos <= engine.log.last_index:
        batch, pos = reader.read(pos, 100)
        chain.extend((r.index, r.type, r.key(), r.xattr, r.time)
                     for r in batch.to_records())
    return chain


# ------------------------------------------------------------------ mirror
def _compactor_semantics(pkg, tmp_path):
    P = pkg.R
    proxy, log = mk_proxy(pkg, tmp_path)
    live = pkg.policy.NamespaceMirror(proxy, group="live", replay=None)
    log.log(rec(pkg, P.CL_CREATE, 1, 0, name=b"a"))
    log.log(rec(pkg, P.CL_RENAME, 1, 1, name=b"b", sname=b"a",
                sfid=P.Fid(1, 1, 0)))
    log.log(rec(pkg, P.CL_RENAME, 1, 2, name=b"c", sname=b"b",
                sfid=P.Fid(1, 1, 0)))
    log.log(rec(pkg, P.CL_CREATE, 2, 0, name=b"h"))
    log.log(rec(pkg, P.CL_HARDLINK, 2, 1, name=b"h2"))
    log.log(rec(pkg, P.CL_UNLINK, 2, 2, name=b"h"))
    log.log(rec(pkg, P.CL_CREATE, 3, 0, name=b"tmp"))
    log.log(rec(pkg, P.CL_SETATTR, 3, 1))
    log.log(rec(pkg, P.CL_UNLINK, 3, 2, name=b"tmp"))
    log.log(rec(pkg, P.CL_CREATE, 4, 0, name=b"w"))
    log.log(rec(pkg, P.CL_SETATTR, 4, 1, shard=(0, 7, 0, 0), metrics=(1.0,)))
    log.log(rec(pkg, P.CL_SETATTR, 4, 2, shard=(0, 9, 0, 0), metrics=(2.5,)))
    drive(proxy, live)
    proxy.flush_upstream()
    assert log.first_index > 1
    boot = pkg.policy.NamespaceMirror(proxy, group="boot", replay=True)
    boot.bootstrap()
    assert boot.stream.replayed > 0
    assert boot.snapshot() == live.snapshot()
    assert live.entries[(1, 1, 0)].name == b"c"
    assert live.entries[(1, 2, 0)].nlink == 1
    assert (1, 3, 0) not in live.entries
    w = live.entries[(1, 4, 0)]
    assert w.attr_shard == (0, 9, 0, 0) and w.attr_metrics == (2.5,)
    return (live.snapshot(), boot.snapshot(), boot.stream.replayed,
            live.stats, boot.stats, live.clock, log.first_index)


def test_mirror_matches_compactor_semantics(tmp_path):
    both(_compactor_semantics, tmp_path)


N_HANDOFF = 600


def _handoff_under_ingest(pkg, tmp_path):
    P = pkg.R
    proxy, log = mk_proxy(pkg, tmp_path)
    svc = pkg.server.LcapService(proxy, poll_interval=0.001).start()
    try:
        live = pkg.policy.NamespaceMirror(svc.address, group="live",
                                          replay=None)
        for i in range(100):
            log.log(rec(pkg, P.CL_CREATE, i, i * 0.01, name=b"f%d" % i))
        deadline = time.time() + 5
        while len(live.entries) < 100 and time.time() < deadline:
            live.poll(4096)
        assert len(live.entries) == 100

        def produce():
            for i in range(100, N_HANDOFF):
                log.log(rec(pkg, P.CL_CREATE, i, i * 0.01,
                            name=b"f%d" % i))
                if i % 3 == 0:
                    log.log(rec(pkg, P.CL_UNLINK, i - 50, i * 0.01))
                time.sleep(0.0003)

        t = threading.Thread(target=produce)
        t.start()
        time.sleep(0.02)
        boot = pkg.policy.NamespaceMirror(svc.address, group="boot",
                                          replay=True)
        boot.bootstrap()                       # mid-ingest bootstrap
        t.join()
        deadline = time.time() + 5
        while time.time() < deadline:
            moved = live.poll(4096) + boot.poll(4096)
            if not moved and live.snapshot() == boot.snapshot() and \
                    live.stats["applied"] == log.last_index:
                break
        assert boot.snapshot() == live.snapshot()
        assert boot.stream.replayed > 0
        assert boot.stats["deduped"] == 0
    finally:
        svc.stop()
    return live.snapshot(), live.stats, boot.stats["deduped"], live.clock


def test_mirror_handoff_no_gap_no_dup_under_concurrent_ingest(tmp_path):
    snap, stats, _deduped, _clock = both(_handoff_under_ingest, tmp_path)
    # every record logged reached the live mirror
    assert stats["applied"] == 100 + (N_HANDOFF - 100) + sum(
        1 for i in range(100, N_HANDOFF) if i % 3 == 0)
    assert len(snap) == N_HANDOFF - sum(1 for i in range(100, N_HANDOFF)
                                        if i % 3 == 0)


# ------------------------------------------------------------------ engine
def _rule_lifecycle(pkg, tmp_path):
    P, pol = pkg.R, pkg.policy
    proxy, log = mk_proxy(pkg, tmp_path)
    mirror = pol.NamespaceMirror(proxy)
    old = pol.PolicyRule("age-out", action="purge", min_age_s=60.0)
    hot = pol.PolicyRule("hot-writer", action="archive",
                         types={P.CL_SETATTR}, metrics_min=2.0,
                         flags_all=P.CLF_SHARD)
    engine = pol.PolicyEngine(mirror, [old, hot], target=proxy,
                              path=str(tmp_path / "act"))
    log.log(rec(pkg, P.CL_CREATE, 1, 0, name=b"cold"))
    log.log(rec(pkg, P.CL_CREATE, 2, 50, name=b"warm"))
    log.log(rec(pkg, P.CL_CREATE, 3, 55, name=b"writer"))
    log.log(rec(pkg, P.CL_SETATTR, 3, 58, shard=(0, 1, 0, 0),
                metrics=(3.0,)))
    log.log(rec(pkg, P.CL_SETATTR, 2, 61, metrics=(9.9,)))
    drive(proxy, mirror)
    acts = engine.evaluate()
    by_rule = {(a.rule, a.key[1]) for a in acts}
    assert by_rule == {("age-out", 1), ("hot-writer", 3)}
    assert all(a.status == pol.WAITING for a in acts)
    log.log(rec(pkg, P.CL_SETATTR, 3, 62, shard=(0, 1, 0, 0),
                metrics=(4.0,)))
    drive(proxy, mirror)
    assert engine.evaluate() == []
    cookie = next(a.cookie for a in acts if a.rule == "hot-writer")
    engine.start(cookie)
    assert engine.actions[cookie].status == pol.STARTED
    engine.complete(cookie)
    assert engine.actions[cookie].status == pol.SUCCEED
    assert engine.janitor_sweep() == 1
    assert cookie not in engine.actions
    proxy.pump()
    chain = action_chain(pkg, engine)
    types = [t for _i, t, _k, x, _tm in chain
             if x and x.get("cookie") == cookie]
    assert types == [P.CL_ACTION_NEW, P.CL_ACTION_UPDATE,
                     P.CL_ACTION_COMPLETED, P.CL_ACTION_PURGED]
    return (sorted(by_rule), [(a.cookie, a.key, a.rule, a.kind)
                              for a in acts], chain, engine.live_state(),
            engine.stats)


def test_rule_matching_and_lifecycle(tmp_path):
    both(_rule_lifecycle, tmp_path)


def _age_rule(pkg, tmp_path):
    P, pol = pkg.R, pkg.policy
    proxy, log = mk_proxy(pkg, tmp_path)
    mirror = pol.NamespaceMirror(proxy)
    engine = pol.PolicyEngine(
        mirror, [pol.PolicyRule("age-out", min_age_s=3600.0)], target=proxy)
    log.log(rec(pkg, P.CL_CREATE, 1, 0, name=b"old"))
    drive(proxy, mirror)
    assert engine.evaluate() == []
    log.log(rec(pkg, P.CL_CREATE, 99, 7200, name=b"unrelated"))
    drive(proxy, mirror)
    matched = engine.evaluate()
    assert {a.key[1] for a in matched} == {1}
    third = engine.evaluate()
    assert all(a.key[1] != 1 for a in third)
    proxy.pump()
    r = pol.reconcile(engine, proxy)
    assert r.ok
    return ([a.key for a in matched], [a.key for a in third],
            engine.live_state(), report(r), action_chain(pkg, engine))


def test_age_rule_fires_on_quiescent_entry(tmp_path):
    both(_age_rule, tmp_path)


def _engine_recovery(pkg, tmp_path):
    P, pol = pkg.R, pkg.policy
    proxy, log = mk_proxy(pkg, tmp_path)
    mirror = pol.NamespaceMirror(proxy)
    rules = [pol.PolicyRule("r", min_age_s=0)]
    e1 = pol.PolicyEngine(mirror, rules, target=proxy,
                          path=str(tmp_path / "act"))
    for i in range(6):
        log.log(rec(pkg, P.CL_CREATE, i, i))
    drive(proxy, mirror)
    e1.evaluate()
    done = sorted(e1.actions)[:2]
    for c in done:
        e1.start(c)
        e1.complete(c)
    purged_key = e1.actions[done[0]].key
    e1.purge(done[0])
    proxy.pump()
    truth_before = e1.live_state()

    proxy2 = pkg.proxy.LcapProxy({"mdt0": log})
    mirror2 = pol.NamespaceMirror(proxy2, replay=True)
    e2 = pol.PolicyEngine(mirror2, rules, target=proxy2,
                          path=str(tmp_path / "act"))
    assert e2.stats["recovered"] == len(truth_before)
    assert e2.live_state() == truth_before
    drive(proxy2, mirror2)
    refired = e2.evaluate()
    assert {a.key for a in refired} == {purged_key}
    log.log(rec(pkg, P.CL_CREATE, 50, 50))
    drive(proxy2, mirror2)
    (new,) = e2.evaluate()
    assert new.cookie > max(truth_before)
    proxy2.pump()
    r = pol.reconcile(e2, proxy2)
    assert r.ok
    return (truth_before, e2.stats, [(a.cookie, a.key) for a in refired],
            new.cookie, report(r), e2.live_state())


def test_engine_recovers_from_journal_on_restart(tmp_path):
    both(_engine_recovery, tmp_path)


def _compact_applied(pkg, tmp_path):
    P = pkg.R
    proxy, log = mk_proxy(pkg, tmp_path)
    mirror = pkg.policy.NamespaceMirror(proxy)
    for i in range(30):
        log.log(rec(pkg, P.CL_CREATE, i, i))
        log.log(rec(pkg, P.CL_UNLINK, i, i + 0.5))
    drive(proxy, mirror)
    proxy.flush_upstream()
    assert log.first_index == log.last_index + 1
    assert len(mirror._applied) == 30
    snap = mirror.snapshot()
    applied = dict(mirror._applied)
    dropped = mirror.compact_applied({"mdt0": log.first_index})
    assert dropped == 30 and not mirror._applied
    log.log(rec(pkg, P.CL_CREATE, 100, 100))
    drive(proxy, mirror)
    assert (1, 100, 0) in mirror.entries
    assert snap == {}
    return applied, dropped, mirror.snapshot(), mirror._applied


def test_mirror_compact_applied_bounds_dedup_map(tmp_path):
    both(_compact_applied, tmp_path)


def _deferred_attach(pkg, tmp_path):
    P, pol = pkg.R, pkg.policy
    proxy, log = mk_proxy(pkg, tmp_path)
    mirror = pol.NamespaceMirror(proxy)
    engine = pol.PolicyEngine(mirror, [pol.PolicyRule("r", min_age_s=0)],
                              target=None)
    log.log(rec(pkg, P.CL_CREATE, 1, 0))
    drive(proxy, mirror)
    (act,) = engine.evaluate()
    assert engine.log.last_index == 1
    engine.attach(proxy)
    agent = pkg.session.connect(proxy).subscribe(pkg.session.Subscription(
        group="agent", types=P.CL_ACTION_TYPES, auto_commit=False))
    proxy.pump()
    got = [idx for _pid, b in agent.fetch(100) for idx in b.indices()]
    agent.commit()
    assert got == [1]
    r = pol.reconcile(engine, proxy)
    assert r.ok
    return act.cookie, act.key, got, report(r)


def test_deferred_attach_loses_no_actions(tmp_path):
    both(_deferred_attach, tmp_path)


def _zombies(pkg, tmp_path):
    P, pol = pkg.R, pkg.policy
    proxy, log = mk_proxy(pkg, tmp_path)
    mirror = pol.NamespaceMirror(proxy)
    engine = pol.PolicyEngine(mirror, [pol.PolicyRule("r", min_age_s=0)],
                              target=proxy)
    log.log(rec(pkg, P.CL_CREATE, 1, 0))
    drive(proxy, mirror)
    (act,) = engine.evaluate()
    log.log(rec(pkg, P.CL_UNLINK, 1, 1))
    drive(proxy, mirror)
    engine.evaluate()
    assert engine.stats["zombies_reaped"] == 1
    assert act.cookie not in engine.actions
    proxy.pump()
    r = pol.reconcile(engine, proxy)
    assert r.ok
    return engine.stats, report(r), action_chain(pkg, engine)


def test_zombie_actions_reaped_when_target_vanishes(tmp_path):
    both(_zombies, tmp_path)


def _mass_reap(pkg, tmp_path):
    """Many vanished targets against many live actions and waiters, the
    engine's reap indexed by target: the same purges, in the same order,
    and the same tables afterwards."""
    P, pol = pkg.R, pkg.policy
    proxy, log = mk_proxy(pkg, tmp_path)
    mirror = pol.NamespaceMirror(proxy)
    engine = pol.PolicyEngine(mirror, [
        pol.PolicyRule("now", min_age_s=0),
        pol.PolicyRule("set", action="purge",
                       types=frozenset({P.CL_SETATTR})),
        pol.PolicyRule("later", min_age_s=3600)], target=proxy)
    for oid in range(1, 301):
        log.log(rec(pkg, P.CL_CREATE, oid, 0, name=b"f%d" % oid))
        if oid % 3 == 0:
            log.log(rec(pkg, P.CL_SETATTR, oid, 0.5))
    drive(proxy, mirror, engine)
    live = len(engine.actions)
    assert live == 400 and len(engine._waiting) == 300
    # unlink every other target, in an order unlike their creation's,
    # and 50 targets the mirror never held
    gone = list(range(300, 0, -2)) + list(range(1001, 1051))
    for i, oid in enumerate(gone):
        log.log(rec(pkg, P.CL_UNLINK, oid, 1 + i * 1e-3))
    drive(proxy, mirror, engine)
    assert engine.stats["zombies_reaped"] == 200
    assert len(engine._waiting) == 150
    proxy.pump()
    r = pol.reconcile(engine, proxy)
    assert r.ok
    return (engine.stats, engine.live_state(),
            list(engine._live_by_target.items()),
            list(engine._waiting.items()), report(r),
            action_chain(pkg, engine))


def test_mass_zombie_reap_matches_reference(tmp_path):
    both(_mass_reap, tmp_path)


# -------------------------------------------------------------- reconciler
def _injected_discrepancies(pkg, tmp_path):
    P, pol = pkg.R, pkg.policy
    proxy, log = mk_proxy(pkg, tmp_path)
    mirror = pol.NamespaceMirror(proxy)
    engine = pol.PolicyEngine(mirror, [pol.PolicyRule("r", min_age_s=0)],
                              target=proxy)
    for i in range(5):
        log.log(rec(pkg, P.CL_CREATE, i, i))
    drive(proxy, mirror)
    engine.evaluate()
    proxy.pump()
    clean = pol.reconcile(engine, proxy)
    assert clean.ok
    Action = pkg.engine.Action
    engine.actions[999] = Action(999, (1, 77, 0), "r", "archive")
    ghost = Action(998, (1, 88, 0), "r", "archive")
    engine._emit(P.CL_ACTION_NEW, ghost, pol.WAITING)
    victim = next(iter(engine.live_state()))
    engine.actions[victim].status = pol.STARTED
    proxy.pump()
    r = pol.reconcile(engine, proxy)
    assert not r.ok
    assert r.missing == [999]
    assert r.extra == [998]
    assert (victim, pol.STARTED, pol.WAITING) in r.mismatched
    assert "missing" in str(r)
    return report(clean), report(r), pol.replay_action_state(proxy)


def test_reconciler_detects_injected_discrepancies(tmp_path):
    both(_injected_discrepancies, tmp_path)


# ------------------------------------------------------- restart / cluster
def _restart_exactly_once(pkg, tmp_path):
    P, pol, S = pkg.R, pkg.policy, pkg.session.Subscription
    proxy, log = mk_proxy(pkg, tmp_path)
    mirror = pol.NamespaceMirror(proxy)
    engine = pol.PolicyEngine(mirror, [pol.PolicyRule("r", min_age_s=0)],
                              target=proxy, path=str(tmp_path / "act"))
    agent = pkg.session.connect(proxy).subscribe(S(
        group="agent", types=P.CL_ACTION_TYPES, auto_commit=False))
    seen = []

    def drain_agent(stream):
        for _pid, b in stream.fetch(4096):
            seen.extend(b.indices())
        stream.commit()

    for i in range(10):
        log.log(rec(pkg, P.CL_CREATE, i, i))
    drive(proxy, mirror)
    engine.evaluate()
    engine.run_pending()
    proxy.pump()
    drain_agent(agent)
    proxy.flush_upstream()
    assert len(seen) == 30

    proxy2 = pkg.proxy.LcapProxy({"mdt0": log})
    mirror2 = pol.NamespaceMirror(proxy2, replay=True)
    engine.attach(proxy2)
    engine.mirror = mirror2
    agent2 = pkg.session.connect(proxy2).subscribe(S(
        group="agent", types=P.CL_ACTION_TYPES, auto_commit=False))
    drive(proxy2, mirror2)
    assert mirror2.snapshot() == mirror.snapshot()
    engine.evaluate()
    assert engine.janitor_sweep() == 10
    proxy2.pump()
    drain_agent(agent2)
    proxy2.flush_upstream()
    assert len(seen) == len(set(seen)), "duplicate action delivery"
    assert sorted(seen) == list(range(1, engine.log.last_index + 1))
    r = pol.reconcile(engine, proxy2)
    assert r.ok
    return seen, mirror2.snapshot(), engine.stats, report(r)


def test_action_lifecycle_exactly_once_through_proxy_restart(tmp_path):
    both(_restart_exactly_once, tmp_path)


def _chains_never_split(pkg, tmp_path):
    P, pol = pkg.R, pkg.policy
    logs = {f"mdt{m}": pkg.llog.Llog(f"mdt{m}", path=str(tmp_path / f"j{m}"),
                                     segment_records=16, history=True)
            for m in range(2)}
    cluster = mk_cluster(pkg, logs, 2)
    mirror = pol.NamespaceMirror(cluster)
    engine = pol.PolicyEngine(mirror, [pol.PolicyRule("r", min_age_s=0)],
                              target=cluster)
    for i in range(40):
        logs[f"mdt{i % 2}"].log(rec(pkg, P.CL_CREATE, i, i,
                                    name=b"f%d" % i))
    for _ in range(30):
        moved = cluster.pump() + mirror.poll(4096)
        engine.evaluate()
        moved += cluster.pump()
        if not moved and not mirror.bootstrapping:
            break
    engine.run_pending()
    cluster.pump()
    assert len(engine.actions) == 40
    r = pol.reconcile(engine, cluster)
    assert r.ok
    placement = {}
    for i, shard in enumerate(cluster.shards):
        state = pol.replay_action_state(shard.proxy)
        for cookie in state:
            assert cookie not in placement, "chain split across shards"
            placement[cookie] = i
    assert set(placement) == set(engine.actions)
    assert set(placement.values()) == {0, 1}
    return placement, engine.live_state(), report(r), cluster.stats


def test_two_shard_cluster_chains_never_split(tmp_path):
    both(_chains_never_split, tmp_path)


def churn_step(pkg, logs, i, keys):
    P = pkg.R
    log = logs[f"mdt{i % len(logs)}"]
    log.log(rec(pkg, P.CL_CREATE, i, i * 0.001, name=b"f%d" % i))
    keys.add(i)
    if i % 3 == 0:
        log.log(rec(pkg, P.CL_SETATTR, i, i * 0.001 + 0.0001,
                    shard=(0, i % 8, 0, 0), metrics=(float(i % 5),)))
    if i % 4 == 0 and i > 20:
        victim = i - 20
        log.log(rec(pkg, P.CL_UNLINK, victim, i * 0.001 + 0.0002))
        keys.discard(victim)


def _churn_single_proxy(pkg, tmp_path):
    P, pol = pkg.R, pkg.policy
    proxy, log = mk_proxy(pkg, tmp_path)
    logs = {"mdt0": log}
    mirror = pol.NamespaceMirror(proxy)
    engine = pol.PolicyEngine(
        mirror, [pol.PolicyRule("attr", types={P.CL_SETATTR}, min_age_s=0)],
        target=proxy, path=str(tmp_path / "act"))
    keys = set()
    n, half = 2000, 1000
    for i in range(half):
        churn_step(pkg, logs, i, keys)
        if i % 100 == 0:
            drive(proxy, mirror, engine)
            engine.run_pending()
            if i % 200 == 0:
                engine.janitor_sweep()
    drive(proxy, mirror, engine)
    proxy2 = pkg.proxy.LcapProxy({"mdt0": log})
    mirror2 = pol.NamespaceMirror(proxy2, replay=True)
    engine.attach(proxy2)
    engine.mirror = mirror2
    drive(proxy2, mirror2, engine)
    for i in range(half, n):
        churn_step(pkg, logs, i, keys)
        if i % 100 == 0:
            drive(proxy2, mirror2, engine)
            engine.run_pending()
    drive(proxy2, mirror2, engine)
    engine.run_pending()
    proxy2.pump()
    assert set(k[1] for k in mirror2.entries) == keys
    r = pol.reconcile(engine, proxy2)
    assert r.ok, str(r)
    return (mirror2.snapshot(), engine.live_state(), engine.stats,
            report(r))


def test_churn_with_restart_reconciles_single_proxy(tmp_path):
    both(_churn_single_proxy, tmp_path)


def _churn_shard_kill(pkg, tmp_path):
    P, pol = pkg.R, pkg.policy
    logs = {f"mdt{m}": pkg.llog.Llog(f"mdt{m}", path=str(tmp_path / f"j{m}"),
                                     segment_records=64, history=True)
            for m in range(2)}
    cluster = mk_cluster(pkg, logs, 4)
    mirror = pol.NamespaceMirror(cluster)
    engine = pol.PolicyEngine(
        mirror, [pol.PolicyRule("attr", types={P.CL_SETATTR}, min_age_s=0)],
        target=cluster)

    def settle():
        for _ in range(60):
            moved = cluster.pump() + mirror.poll(4096)
            engine.evaluate()
            moved += cluster.pump()
            if not moved and not mirror.bootstrapping:
                return
        raise AssertionError("cluster did not quiesce")

    keys = set()
    n, half = 2000, 1000
    for i in range(half):
        churn_step(pkg, logs, i, keys)
        if i % 100 == 0:
            settle()
            engine.run_pending()
            if i % 200 == 0:
                engine.janitor_sweep()
    settle()
    cluster.kill_shard(1)
    for i in range(half, n):
        churn_step(pkg, logs, i, keys)
        if i % 100 == 0:
            settle()
            engine.run_pending()
    settle()
    engine.run_pending()
    cluster.pump()
    assert cluster.stats["shards_failed"] == 1
    assert set(k[1] for k in mirror.entries) == keys
    r = pol.reconcile(engine, cluster)
    assert r.ok, str(r)
    return (mirror.snapshot(), mirror.stats, engine.live_state(),
            engine.stats, report(r), cluster.stats)


def test_churn_with_shard_kill_reconciles_4shard_cluster(tmp_path):
    both(_churn_shard_kill, tmp_path)
