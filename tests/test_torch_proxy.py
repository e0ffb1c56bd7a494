"""Port parity, proxy layer: the same journals through a reference
``LcapProxy`` and a port ``LcapProxy`` deliver the same records to the
same consumers in the same order, with the same stats, lag and journal
watermarks.

The workload: four MDT journals of a few thousand seeded records (the
changelog operation mix, every record with a jobid), a stream module,
two persistent groups (one with type pushdown and a field projection),
a tenant-scoped group and an ephemeral reader.  Half of each journal is
handed over before the consumers subscribe (``llog.from_packed``), half
is logged after, so the ephemeral reader sees the second half only.
Exact equality: the changelog layers have no tolerance.
"""

from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core.llog as ref_llog                         # noqa: E402
import repro.core.modules as ref_modules                   # noqa: E402
import repro.core.proxy as ref_proxy                       # noqa: E402
import repro.core.session as ref_session                   # noqa: E402
import repro.core.tenancy as ref_tenancy                   # noqa: E402
from repro.core import records as R                       # noqa: E402
import repro_torch.core.llog as port_llog                  # noqa: E402
import repro_torch.core.modules as port_modules            # noqa: E402
import repro_torch.core.proxy as port_proxy                # noqa: E402
import repro_torch.core.session as port_session            # noqa: E402
import repro_torch.core.tenancy as port_tenancy            # noqa: E402
from repro_torch.core import records as T                 # noqa: E402

REF = SimpleNamespace(R=R, llog=ref_llog, modules=ref_modules,
                      proxy=ref_proxy, session=ref_session,
                      tenancy=ref_tenancy)
PORT = SimpleNamespace(R=T, llog=port_llog, modules=port_modules,
                       proxy=port_proxy, session=port_session,
                       tenancy=port_tenancy)

#: the main path's operation mix (chip_smoke.py uses the same one)
MIX = ((R.CL_CREATE, 30), (R.CL_SETATTR, 25), (R.CL_CLOSE, 15),
       (R.CL_UNLINK, 15), (R.CL_MKDIR, 5), (R.CL_RMDIR, 5), (R.CL_RENAME, 5))
AUDIT_TYPES = frozenset({R.CL_CREATE, R.CL_UNLINK, R.CL_RENAME, R.CL_RMDIR})


def packed_journal(m: int, n: int, seed: int) -> list:
    """``n`` packed records of MDT ``m`` (indices 1..n, cr_prev chained
    on reused target FIDs), logged through a reference journal."""
    rng = np.random.default_rng(seed * 1000 + m)
    types = np.repeat([t for t, _ in MIX], [w for _, w in MIX])
    log = ref_llog.Llog(f"mdt{m}")
    log.register_reader("feeder")
    recs = []
    for i in range(n):
        rtype = int(types[rng.integers(0, len(types))])
        job = int(rng.integers(0, 64))
        proc = ("dd", "cp", "rsync", "tar")[job % 4]
        rec = R.ChangelogRecord(
            type=rtype, time=10**18 + i,
            tfid=R.Fid(0x200000400 + m, int(rng.integers(1, 512)), 0),
            pfid=R.Fid(0x200000400 + m, 1, 0), name=b"f%d" % i,
            jobid=b"%s.%d" % (proc.encode(), 500 + job))
        if rtype == R.CL_RENAME:
            rec.sfid, rec.spfid, rec.sname = (R.Fid(0x200000400 + m, i, 0),
                                              R.Fid(0x200000400 + m, 1, 0),
                                              b"old%d" % i)
        recs.append(rec)
    log.log_batch(recs)
    return list(log.read(1, n))


def make_journals(pkg, packed: dict, upto: int) -> dict:
    """Journals of package ``pkg`` holding ``packed[pid][:upto]``: the
    port takes the packed records as they are (``from_packed``); the
    reference, which has no such entry, logs them through a temporary
    reader (logging needs one) that leaves before anyone attaches."""
    logs = {}
    for pid, bufs in packed.items():
        if pkg is PORT:
            blob, off, ln = T.RecordBatch.from_packed(bufs[:upto])._compact()
            logs[pid] = port_llog.from_packed(pid, blob, off, ln,
                                              first_index=1)
        else:
            log = ref_llog.Llog(pid)
            log.register_reader("feeder")
            log.log_batch([R.unpack(b) for b in bufs[:upto]])
            log.deregister_reader("feeder")
            logs[pid] = log
    return logs


def log_rest(pkg, logs: dict, packed: dict, upto: int) -> None:
    for pid, bufs in packed.items():
        logs[pid].log_batch([pkg.R.unpack(b) for b in bufs[upto:]])


def subscriptions(pkg) -> list:
    S = pkg.session.Subscription
    acme = pkg.tenancy.TenantPrincipal("acme", prefixes=(b"dd.",))
    return [("robinhood", S(group="robinhood", auto_commit=False)),
            ("robinhood", S(group="robinhood", auto_commit=False)),
            ("audit", S(group="audit", types=AUDIT_TYPES, flags=R.CLF_JOBID,
                        auto_commit=False, max_records=300)),
            ("acme", S(group="acme", tenant=acme, auto_commit=False)),
            ("reader", S(mode=pkg.proxy.EPHEMERAL, auto_commit=False))]


def run_proxy(pkg, packed: dict, upto: int) -> dict:
    logs = make_journals(pkg, packed, upto)
    proxy = pkg.proxy.LcapProxy(
        logs, modules=[pkg.modules.CancelCompensating()], batch_size=256)
    sess = pkg.session.connect(proxy)
    streams = [(g, sess.subscribe(spec)) for g, spec in subscriptions(pkg)]
    trace = []
    for rnd in range(400):
        if rnd == 2:
            log_rest(pkg, logs, packed, upto)
        moved = proxy.pump()
        for k, (group, stream) in enumerate(streams):
            for pid, batch in stream.fetch(700):
                trace.append((group, k, pid, tuple(batch.indices()),
                              batch.to_wire(R.WIRE_V2)))
                moved += len(batch)
            stream.commit()
        if rnd > 2 and not moved and all(
                log.first_index == log.last_index + 1
                for log in logs.values()):
            break
    return {"trace": trace, "stats": dict(proxy.stats), "lag": proxy.lag(),
            "journals": {pid: (log.first_index, log.last_index)
                         for pid, log in logs.items()},
            "cursors": dict(proxy.cursors),
            "upstream": dict(proxy.upstream_acked)}


@pytest.fixture(scope="module")
def packed():
    return {f"mdt{m}": packed_journal(m, 2500, seed=1) for m in range(4)}


@pytest.fixture(scope="module")
def runs(packed):
    return run_proxy(REF, packed, 1500), run_proxy(PORT, packed, 1500)


def test_proxy_delivers_the_same_sequence(runs):
    ref, port = runs
    assert len(port["trace"]) == len(ref["trace"])
    for a, b in zip(port["trace"], ref["trace"]):
        assert a == b


@pytest.mark.parametrize("key", ["stats", "lag", "journals", "cursors",
                                 "upstream"])
def test_proxy_state_matches(runs, key):
    ref, port = runs
    assert port[key] == ref[key]


def test_proxy_run_covers_the_workload(runs, packed):
    """Guards the comparison against a degenerate run: every group saw
    its share, scoping and pushdown filtered, and the journals drained."""
    _ref, port = runs
    by_group = {}
    for group, _k, pid, indices, _w in port["trace"]:
        by_group.setdefault(group, set()).update((pid, i) for i in indices)
    total = sum(len(v) for v in packed.values())
    assert len(by_group["robinhood"]) == total - port["stats"][
        "dropped_by_modules"]
    assert 0 < len(by_group["audit"]) < len(by_group["robinhood"])
    assert 0 < len(by_group["acme"]) < len(by_group["robinhood"])
    assert 0 < len(by_group["reader"]) <= 4 * 1000
    assert port["stats"]["tenant_filtered"] > 0
    assert port["stats"]["filtered_out"] > 0
    assert all(first == last + 1
               for first, last in port["journals"].values())
